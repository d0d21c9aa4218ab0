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

__all__ = ["DEFAULT_SIZES", "ContainerSize", "DriftingMix",
           "MicroserviceDAG", "RequestClass", "ServiceTier",
           "as_mix_schedule", "mmc_sojourn"]
