from .microservice import (
    DEFAULT_SIZES,
    ContainerSize,
    DriftingMix,
    MicroserviceDAG,
    RequestClass,
    ServiceTier,
    as_mix_schedule,
    mmc_sojourn,
)
from .simulator import (
    Arrival,
    JobStream,
    MultiTenantStream,
    PoissonArrivals,
    QueueSimulator,
    TenantWorkload,
    blended_stream,
)
from .trace import (
    SyntheticTrace,
    TraceEvent,
    replay_ticks,
    synthetic_trace,
    trace_fingerprint,
)

__all__ = ["Arrival", "JobStream", "MultiTenantStream", "PoissonArrivals",
           "QueueSimulator", "TenantWorkload", "blended_stream",
           "DEFAULT_SIZES", "ContainerSize", "DriftingMix",
           "MicroserviceDAG", "RequestClass", "ServiceTier",
           "as_mix_schedule", "mmc_sojourn",
           "SyntheticTrace", "TraceEvent", "replay_ticks", "synthetic_trace",
           "trace_fingerprint"]
