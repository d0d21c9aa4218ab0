# The paper's primary contribution — online cluster resource management by
# simulated annealing — ported to PyTorch.  This slice carries the
# container-sizing loop, the single-tenant procurement loop and the
# multi-tenant fleet (FleetController, TraceReplayController) end to end;
# ROADMAP.md lists what waits.
from .annealing import (
    DRAW_KEYS,
    Annealer,
    ChainSnapshot,
    Step,
    acceptance_probability,
    anneal_chain,
    anneal_chain_dynamic,
    anneal_chain_nd,
    anneal_fleet,
    chain_accept_stats,
    chain_bucket,
    first_hit_time,
    fleet_chains,
    jobs_to_min_vs_tau,
    jobs_to_min_vs_tau_fleet,
    random_valid_states,
    tenant_draws,
)
from .change_detect import BatchedPageHinkley, PageHinkley, WindowedZScore
from .evalpipe import (
    EvalDispatcher,
    EvalRequest,
    EvalResult,
    PipelineStats,
    ResolvedStep,
    SpeculativePipeline,
    StorePredictor,
    map_pool,
    measure_requests,
)
from .costmodel import (
    Evaluator,
    MeasuredEvaluator,
    RooflineEvaluator,
    SimulatedEvaluator,
    StepCosts,
    objective_of,
)
from .fleet import FleetController, FleetDecision, TenantSpec
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
from .procurement import (
    ControllerMixin,
    Decision,
    ProcurementController,
    default_adaptive_schedule,
    make_ec2_space,
    make_tpu_space,
    offline_plan,
)
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
    DeviceMeasurementStore,
    ExhaustiveSource,
    MeasurementStore,
    ObjectiveSource,
    SpaceEncoding,
    SurrogateAnnealer,
    SurrogateModel,
    SurrogateRound,
    SurrogateSource,
    expected_improvement,
    host_interp,
    window_space,
)
from .tabu import TabuMemory
from .trace_replay import TraceReplayController

__all__ = [
    "DRAW_KEYS", "Annealer", "ChainSnapshot", "Step",
    "acceptance_probability", "anneal_chain", "anneal_chain_dynamic",
    "anneal_chain_nd", "anneal_fleet", "chain_accept_stats", "chain_bucket",
    "first_hit_time", "fleet_chains", "jobs_to_min_vs_tau",
    "jobs_to_min_vs_tau_fleet", "random_valid_states", "tenant_draws",
    "BatchedPageHinkley", "PageHinkley", "WindowedZScore",
    "EvalDispatcher", "EvalRequest", "EvalResult", "PipelineStats",
    "ResolvedStep", "SpeculativePipeline", "StorePredictor",
    "map_pool", "measure_requests",
    "Evaluator", "MeasuredEvaluator", "RooflineEvaluator",
    "SimulatedEvaluator", "StepCosts", "objective_of",
    "FleetController", "FleetDecision", "TenantSpec",
    "BLEND_AFTER", "BLEND_BEFORE", "HIBENCH_JOBS", "JobModel",
    "bimodal_landscape", "blended_surface", "changed_landscape",
    "dnn_epoch_landscape", "tabulate", "tabulate_dynamic",
    "BlockNeighborhood", "Neighborhood", "StepNeighborhood",
    "check_connected", "flat_index", "propose_nd",
    "BlendedObjective", "Measurement", "Objective", "PenalizedObjective",
    "blend_from_weights",
    "EC2_CATALOG", "EC2_CATALOG_ADJUSTED", "TPU_CATALOG", "CapacityError",
    "InstanceFamily", "ServiceCatalog", "interpolated_family",
    "ControllerMixin", "Decision", "ProcurementController",
    "default_adaptive_schedule", "make_ec2_space", "make_tpu_space",
    "offline_plan",
    "AdaptiveReheat", "FixedTemperature", "GeometricCooling", "LogCooling",
    "Schedule", "schedule_to_array",
    "MicroserviceEvaluator", "SizingController", "SizingDecision",
    "SizingSpace", "evaluate_sizing_batch", "full_grid",
    "microservice_config_fn", "sizing_select", "sizing_table_device",
    "ClusterConfig", "ConfigSpace", "Dimension", "EncodedSpace",
    "cluster_config_from",
    "DeviceMeasurementStore", "ExhaustiveSource", "MeasurementStore",
    "ObjectiveSource", "SpaceEncoding", "SurrogateAnnealer",
    "SurrogateModel", "SurrogateRound", "SurrogateSource",
    "expected_improvement", "host_interp", "window_space",
    "TabuMemory", "TraceReplayController",
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
