"""Service catalogs and pricing models.

The paper (sec. 4.2) references AWS EC2 per-core on-demand pricing for four
instance families (general purpose, compute optimized, storage optimized,
memory optimized), each with a fixed memory-per-core ratio, and additionally
considers *hypothetical instances "between" those offered by AWS with
corresponding price adjustments* (sec. 4.2.1).  It also replaces the
storage-optimized family's pricing with a hypothetical family for better
comparison (Fig. 8).

We reproduce that catalog, and add a TPU-slice catalog for the
hardware-adapted procurement problem (v5e slices, on-demand and spot, with
spin-up latency used by the migration-cost term of the objective).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Mapping

from ..telemetry import registry as metrics


class CapacityError(RuntimeError):
    """A reservation would exceed a family's capacity (or release more than
    is reserved)."""


@dataclasses.dataclass(frozen=True)
class InstanceFamily:
    """A family of service offerings priced per core (or per chip)."""

    name: str
    price_per_core_hr: float     # $ / core-hour (or $ / chip-hour)
    mem_per_core_gb: float       # GB per core (HBM per chip for TPU)
    spin_up_s: float             # provisioning latency, seconds
    revocable: bool = False      # spot-style: cheaper but can be revoked
    revocation_rate_hr: float = 0.0   # expected revocations per hour
    description: str = ""

    def price_for(self, n_cores: int, seconds: float) -> float:
        return self.price_per_core_hr * n_cores * (seconds / 3600.0)


class ServiceCatalog:
    """An ordered set of instance families.

    Ordering matters: the paper observes (sec. 4.2.1) that a poor ordering of
    the categorical instance-type axis can introduce artificial local minima.
    The default ordering below sorts families by price per core, which makes
    the price monotone along the categorical axis.

    ``capacities`` (optional) caps the cores (chips) available per family —
    the shared-cloud finiteness the multi-tenant FleetController arbitrates
    over.  Families without an entry are unbounded (the single-tenant
    paper setting).  :meth:`reserve` / :meth:`release` keep a running
    allocation ledger; :meth:`remaining` is what a new tenant can still get.
    """

    def __init__(
        self,
        families: Mapping[str, InstanceFamily],
        capacities: Mapping[str, float] | None = None,
    ):
        self._families = dict(families)
        self._capacity = dict(capacities or {})
        unknown = set(self._capacity) - set(self._families)
        if unknown:
            raise ValueError(f"capacities for unknown families: {unknown}")
        if any(c < 0 for c in self._capacity.values()):
            raise ValueError("capacities must be >= 0")
        self._reserved: dict[str, float] = {}

    def __getitem__(self, name: str) -> InstanceFamily:
        return self._families[name]

    def __contains__(self, name: str) -> bool:
        return name in self._families

    def names(self) -> tuple[str, ...]:
        return tuple(self._families)

    def ordered_by_price(self) -> tuple[str, ...]:
        return tuple(
            sorted(self._families, key=lambda n: self._families[n].price_per_core_hr)
        )

    def cost(self, instance_type: str, n_cores: int, seconds: float) -> float:
        return self[instance_type].price_for(n_cores, seconds)

    def with_family(self, fam: InstanceFamily) -> "ServiceCatalog":
        """A copy with ``fam`` added/replaced.  Capacities carry over;
        like :meth:`with_capacities`, the copy starts with a fresh, empty
        reservation ledger (reservations describe live allocations against
        ONE catalog instance and do not transfer)."""
        out = dict(self._families)
        out[fam.name] = fam
        return ServiceCatalog(out, self._capacity)

    # -- capacity / reservation accounting (multi-tenant arbitration) --
    def capacity(self, name: str) -> float:
        """Cores available in family ``name``; +inf when uncapped."""
        self[name]  # KeyError on unknown families
        return self._capacity.get(name, math.inf)

    def reserved(self, name: str) -> float:
        self[name]
        return self._reserved.get(name, 0.0)

    def remaining(self, name: str) -> float:
        """Unreserved capacity of family ``name`` (+inf when uncapped).
        Negative after a :meth:`set_capacity` shrink below the reserved
        amount — live allocations exceed what the provider now offers,
        and controllers must repair (preempt) to restore feasibility."""
        return self.capacity(name) - self.reserved(name)

    def set_capacity(self, name: str, n_cores: float) -> None:
        """Live capacity update — a spot revocation (shrink) or restock
        (grow) taking effect mid-run.  Unlike :meth:`with_capacities`
        this mutates THIS catalog, preserving the reservation ledger:
        reservations may transiently exceed the new capacity, which
        surfaces as negative :meth:`remaining` until the controllers
        sharing the catalog preempt their way back under it."""
        self[name]  # KeyError on unknown families
        if n_cores < 0:
            raise ValueError("n_cores must be >= 0")
        self._capacity[name] = float(n_cores)
        self._note_ledger(name)

    def _note_ledger(self, name: str) -> None:
        """Telemetry gauges for one family's ledger state — reserved
        cores and (for capped families) utilization.  One truth test
        when no sink is attached."""
        if metrics.get() is None:
            return
        reserved = self.reserved(name)
        metrics.set_gauge(f"ledger/{name}/reserved", reserved)
        cap = self.capacity(name)
        if cap != math.inf and cap > 0:
            metrics.set_gauge(f"ledger/{name}/utilization", reserved / cap)

    def reserve(self, name: str, n_cores: float) -> None:
        """Claim ``n_cores`` from family ``name``; CapacityError if it
        would exceed the family's capacity."""
        if n_cores < 0:
            raise ValueError("n_cores must be >= 0")
        if n_cores > self.remaining(name) + 1e-9:
            raise CapacityError(
                f"reserve({name!r}, {n_cores}) exceeds remaining capacity "
                f"{self.remaining(name)} (capacity {self.capacity(name)}, "
                f"reserved {self.reserved(name)})")
        self._reserved[name] = self.reserved(name) + n_cores
        self._note_ledger(name)

    def release(self, name: str, n_cores: float) -> None:
        if n_cores < 0:
            raise ValueError("n_cores must be >= 0")
        if n_cores > self.reserved(name) + 1e-9:
            raise CapacityError(
                f"release({name!r}, {n_cores}) exceeds reservation "
                f"{self.reserved(name)}")
        self._reserved[name] = max(0.0, self.reserved(name) - n_cores)
        self._note_ledger(name)

    def adjust(self, name: str, delta_cores: float) -> None:
        """Incremental ledger update: ``delta_cores`` > 0 reserves, < 0
        releases, in one call.  This is the per-round API of the fleet's
        incremental reservation mirror — a round that moves one tenant
        touches only the families whose aggregate actually changed,
        instead of releasing and re-reserving every family from scratch.
        Same invariants as :meth:`reserve`/:meth:`release` (and the same
        exceptions), so the incremental path cannot drift anywhere a
        from-scratch rebuild could not."""
        if delta_cores >= 0:
            self.reserve(name, delta_cores)
        else:
            self.release(name, -delta_cores)

    def reserved_snapshot(self) -> dict[str, float]:
        """The full reservation ledger (family -> cores), for periodic
        from-scratch cross-checks against incrementally-maintained
        mirrors (zero entries elided, matching never-reserved state)."""
        return {f: c for f, c in self._reserved.items() if c > 0.0}

    def release_all(self) -> None:
        self._reserved.clear()

    def with_capacities(
        self, capacities: Mapping[str, float]
    ) -> "ServiceCatalog":
        """A copy with (re)set per-family capacity limits and a fresh,
        empty reservation ledger."""
        merged = {**self._capacity, **dict(capacities)}
        return ServiceCatalog(self._families, merged)


# ---------------------------------------------------------------------------
# EC2-like catalog (paper sec. 4.2) — approximate 2022 us-east-1 on-demand.
# ---------------------------------------------------------------------------

EC2_CATALOG = ServiceCatalog(
    {
        # general purpose, ~4 GB/core (paper's example: m6g.medium, 4 GB/core)
        "general": InstanceFamily(
            "general", price_per_core_hr=0.048, mem_per_core_gb=4.0,
            spin_up_s=90.0, description="m6-like general purpose"),
        # compute optimized, ~2 GB/core
        "compute": InstanceFamily(
            "compute", price_per_core_hr=0.0425, mem_per_core_gb=2.0,
            spin_up_s=90.0, description="c6-like compute optimized"),
        # memory optimized, ~8 GB/core
        "memory": InstanceFamily(
            "memory", price_per_core_hr=0.063, mem_per_core_gb=8.0,
            spin_up_s=90.0, description="r6-like memory optimized"),
        # storage optimized, ~7.6 GB/core, NVMe — the paper notes its pricing
        # produces objective "peaks" (Fig. 7) and substitutes a hypothetical
        # family (Fig. 8); both variants are provided.
        "storage": InstanceFamily(
            "storage", price_per_core_hr=0.078, mem_per_core_gb=7.6,
            spin_up_s=90.0, description="i3-like storage optimized"),
    }
)

# The Fig. 8 adjustment: storage-optimized re-priced to a hypothetical family
# comparable with the others (similar local-storage performance assumed).
EC2_CATALOG_ADJUSTED = EC2_CATALOG.with_family(
    InstanceFamily(
        "storage", price_per_core_hr=0.055, mem_per_core_gb=7.6,
        spin_up_s=90.0,
        description="hypothetical storage family (paper Fig. 8 adjustment)")
)


def interpolated_family(
    catalog: ServiceCatalog, a: str, b: str, t: float, name: str | None = None
) -> InstanceFamily:
    """A hypothetical instance family "between" two offered ones.

    Paper sec. 4.2: "We also consider hypothetical instances 'between' those
    offered by AWS with corresponding price adjustments."  Linear
    interpolation of price and memory ratio.
    """
    if not 0.0 <= t <= 1.0:
        raise ValueError(f"t must be in [0,1], got {t}")
    fa, fb = catalog[a], catalog[b]
    return InstanceFamily(
        name=name or f"{a}-{b}-{t:.2f}",
        price_per_core_hr=(1 - t) * fa.price_per_core_hr + t * fb.price_per_core_hr,
        mem_per_core_gb=(1 - t) * fa.mem_per_core_gb + t * fb.mem_per_core_gb,
        spin_up_s=max(fa.spin_up_s, fb.spin_up_s),
        description=f"hypothetical interpolation {a}<->{b} at t={t:.2f}",
    )


# ---------------------------------------------------------------------------
# TPU slice catalog (hardware adaptation).  v5e on-demand ~$1.20/chip-hr;
# spot ~55% off with a revocation hazard.  Spin-up covers slice scheduling +
# runtime restart + checkpoint restore overhead baseline.
# ---------------------------------------------------------------------------

TPU_CATALOG = ServiceCatalog(
    {
        "v5e": InstanceFamily(
            "v5e", price_per_core_hr=1.20, mem_per_core_gb=16.0,
            spin_up_s=300.0, description="TPU v5e on-demand, per chip"),
        "v5e-spot": InstanceFamily(
            "v5e-spot", price_per_core_hr=0.54, mem_per_core_gb=16.0,
            spin_up_s=300.0, revocable=True, revocation_rate_hr=0.05,
            description="TPU v5e spot, per chip"),
        "v5p": InstanceFamily(
            "v5p", price_per_core_hr=4.20, mem_per_core_gb=95.0,
            spin_up_s=420.0, description="TPU v5p on-demand, per chip"),
    }
)

# Hardware constants used by the roofline evaluator (TPU v5e).
V5E_PEAK_FLOPS_BF16 = 197e12       # per chip
V5E_HBM_BW = 819e9                 # bytes/s per chip
V5E_ICI_BW = 50e9                  # bytes/s per link
V5E_HBM_GB = 16.0
