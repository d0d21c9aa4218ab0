# The paper's primary contribution — online cluster resource management by
# simulated annealing — ported to PyTorch.  This slice carries the
# container-sizing control loop end to end; ROADMAP.md lists what waits.
from .annealing import (
    DRAW_KEYS,
    Annealer,
    ChainSnapshot,
    Step,
    acceptance_probability,
    anneal_fleet,
    chain_accept_stats,
    random_valid_states,
)
from .change_detect import BatchedPageHinkley, PageHinkley, WindowedZScore
from .costmodel import (
    Evaluator,
    MeasuredEvaluator,
    RooflineEvaluator,
    SimulatedEvaluator,
    StepCosts,
    objective_of,
)
from .landscape import (
    BLEND_AFTER,
    BLEND_BEFORE,
    HIBENCH_JOBS,
    JobModel,
    bimodal_landscape,
    blended_surface,
    changed_landscape,
    dnn_epoch_landscape,
    tabulate,
    tabulate_dynamic,
)
from .neighborhood import (
    BlockNeighborhood,
    Neighborhood,
    StepNeighborhood,
    check_connected,
    flat_index,
    propose_nd,
)
from .objective import (
    BlendedObjective,
    Measurement,
    Objective,
    PenalizedObjective,
    blend_from_weights,
)
from .pricing import (
    EC2_CATALOG,
    EC2_CATALOG_ADJUSTED,
    TPU_CATALOG,
    CapacityError,
    InstanceFamily,
    ServiceCatalog,
    interpolated_family,
)
from .procurement import ControllerMixin, Decision
from .schedules import (
    AdaptiveReheat,
    FixedTemperature,
    GeometricCooling,
    LogCooling,
    Schedule,
    schedule_to_array,
)
from .sizing import (
    MicroserviceEvaluator,
    SizingController,
    SizingDecision,
    SizingSpace,
    evaluate_sizing_batch,
    full_grid,
    microservice_config_fn,
    sizing_select,
    sizing_table_device,
)
from .state import (
    ClusterConfig,
    ConfigSpace,
    Dimension,
    EncodedSpace,
    cluster_config_from,
)
from .surrogate import (
    ExhaustiveSource,
    MeasurementStore,
    ObjectiveSource,
    SpaceEncoding,
    SurrogateModel,
    SurrogateSource,
    host_interp,
)
from .tabu import TabuMemory

__all__ = [
    "DRAW_KEYS", "Annealer", "ChainSnapshot", "Step",
    "acceptance_probability", "anneal_fleet", "chain_accept_stats",
    "random_valid_states",
    "BatchedPageHinkley", "PageHinkley", "WindowedZScore",
    "Evaluator", "MeasuredEvaluator", "RooflineEvaluator",
    "SimulatedEvaluator", "StepCosts", "objective_of",
    "BLEND_AFTER", "BLEND_BEFORE", "HIBENCH_JOBS", "JobModel",
    "bimodal_landscape", "blended_surface", "changed_landscape",
    "dnn_epoch_landscape", "tabulate", "tabulate_dynamic",
    "BlockNeighborhood", "Neighborhood", "StepNeighborhood",
    "check_connected", "flat_index", "propose_nd",
    "BlendedObjective", "Measurement", "Objective", "PenalizedObjective",
    "blend_from_weights",
    "EC2_CATALOG", "EC2_CATALOG_ADJUSTED", "TPU_CATALOG", "CapacityError",
    "InstanceFamily", "ServiceCatalog", "interpolated_family",
    "ControllerMixin", "Decision",
    "AdaptiveReheat", "FixedTemperature", "GeometricCooling", "LogCooling",
    "Schedule", "schedule_to_array",
    "MicroserviceEvaluator", "SizingController", "SizingDecision",
    "SizingSpace", "evaluate_sizing_batch", "full_grid",
    "microservice_config_fn", "sizing_select", "sizing_table_device",
    "ClusterConfig", "ConfigSpace", "Dimension", "EncodedSpace",
    "cluster_config_from",
    "ExhaustiveSource", "MeasurementStore", "ObjectiveSource",
    "SpaceEncoding", "SurrogateModel", "SurrogateSource", "host_interp",
    "TabuMemory",
]


def _arm_telemetry() -> None:
    # REPRO_TELEMETRY=1 arms the passive observability layer
    # (repro_torch.telemetry): metric/span sinks attach so the
    # always-present guarded call sites start recording.
    import os

    if os.environ.get("REPRO_TELEMETRY") == "1":
        from .. import telemetry

        telemetry.maybe_enable()


_arm_telemetry()
