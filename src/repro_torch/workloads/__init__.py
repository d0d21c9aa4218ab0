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

__all__ = ["Arrival", "JobStream", "MultiTenantStream", "PoissonArrivals",
           "QueueSimulator", "TenantWorkload", "blended_stream",
           "DEFAULT_SIZES", "ContainerSize", "DriftingMix",
           "MicroserviceDAG", "RequestClass", "ServiceTier",
           "as_mix_schedule", "mmc_sojourn"]
