"""Microservice-DAG workload model — the paper's third case study.

The paper's abstract names "container sizing for microservice benchmarks"
beside service selection; this module is the workload side of that
scenario.  A deployment is a DAG of service *tiers* (gateway, auth,
catalog, ...).  Each tier runs some number of identical replicas of a
container whose vertical size (a cpu/mem bundle) sets the per-replica
service rate through a *concave* scaling curve — doubling the bundle
buys less than double the throughput (AutoTune's observation that
per-tier scaling saturates), optionally capped by the bundle's memory.
Request *classes* (browse, search, checkout, ...) enter at a tier and
route along DAG paths with per-tier visit ratios.

Performance model (Jackson-style approximation):

* each tier is an independent M/M/c queue — arrival rate
  ``lam[k] = sum_c rate_c * visits[c, k]``, service rate ``mu`` from the
  tier's size, ``c`` replicas; sojourn = Erlang-C wait + service time;
* a class's end-to-end latency is the *visit-weighted critical path* of
  the DAG from its entry tier: sequential calls compose by sum along a
  path, parallel fan-out by max over children —
  ``L[v] = visits[v] * T[v] + max(0, max_{(v,u)} L[u])``;
* cost = sum over tiers of ``replicas x price(size)``, with bundle price
  = cpu cores x a per-core-hour rate (so a fleet's capacity ledger can
  account container footprints in cores, same as VM tenants).

The same math runs three ways: here in numpy (the "measured" ground
truth, one sizing at a time), as a jnp reference, and as a Pallas kernel
(:mod:`repro_torch.kernels.sizing_latency`) batched over thousands of
candidate sizings — see :mod:`repro_torch.core.sizing`.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Mapping

import numpy as np


@dataclasses.dataclass(frozen=True)
class ContainerSize:
    """A vertical cpu/mem bundle (one menu entry).

    ``cpu`` is integral so that ``replicas x cpu`` core footprints flow
    through the fleet's per-family capacity ledger without rounding.
    """

    name: str
    cpu: int
    mem_gb: float

    def __post_init__(self) -> None:
        if self.cpu < 1:
            raise ValueError(f"size {self.name!r}: cpu must be >= 1")
        if self.mem_gb <= 0:
            raise ValueError(f"size {self.name!r}: mem_gb must be > 0")


#: A typical 2x-geometric container menu (cpu cores, 2 GB per core).
DEFAULT_SIZES: tuple[ContainerSize, ...] = (
    ContainerSize("small", 1, 2.0),
    ContainerSize("medium", 2, 4.0),
    ContainerSize("large", 4, 8.0),
    ContainerSize("xlarge", 8, 16.0),
)


@dataclasses.dataclass(frozen=True)
class ServiceTier:
    """One microservice tier and its vertical-scaling curve.

    ``base_rate`` is the request rate (req/s) one replica sustains at
    ``cpu_ref`` cores; a bundle of ``cpu`` cores serves at
    ``base_rate * (cpu / cpu_ref) ** gamma`` with ``gamma < 1`` (concave:
    intra-container contention eats part of every added core), capped at
    ``mem_gb / mem_per_rps_gb`` when the tier is memory-bound.
    """

    name: str
    base_rate: float
    cpu_ref: float = 1.0
    gamma: float = 0.75
    mem_per_rps_gb: float = 0.0

    def __post_init__(self) -> None:
        if self.base_rate <= 0:
            raise ValueError(f"tier {self.name!r}: base_rate must be > 0")
        if not 0.0 < self.gamma <= 1.0:
            raise ValueError(f"tier {self.name!r}: gamma must be in (0, 1]")

    def service_rate(self, size: ContainerSize) -> float:
        """Per-replica service rate (req/s) at the given bundle."""
        mu = self.base_rate * (size.cpu / self.cpu_ref) ** self.gamma
        if self.mem_per_rps_gb > 0:
            mu = min(mu, size.mem_gb / self.mem_per_rps_gb)
        return mu


@dataclasses.dataclass(frozen=True)
class RequestClass:
    """A request type: entry tier, per-tier visit ratios, SLO deadline.

    ``visits`` maps tier name -> mean visits per request (the entry tier
    must appear); tiers not named are not visited.  Stored as a sorted
    tuple of pairs so the class (and any DAG built from it) is hashable.
    """

    name: str
    entry: str
    visits: Any                     # Mapping[str, float] at construction
    slo_s: float

    def __post_init__(self) -> None:
        pairs = tuple(sorted((str(k), float(v))
                             for k, v in dict(self.visits).items()))
        object.__setattr__(self, "visits", pairs)
        if self.slo_s <= 0:
            raise ValueError(f"class {self.name!r}: slo_s must be > 0")
        vm = dict(pairs)
        if self.entry not in vm:
            raise ValueError(
                f"class {self.name!r}: entry {self.entry!r} not in visits")
        if any(v < 0 for v in vm.values()):
            raise ValueError(f"class {self.name!r}: visits must be >= 0")

    @property
    def visit_map(self) -> dict[str, float]:
        return dict(self.visits)


@dataclasses.dataclass(frozen=True)
class MicroserviceDAG:
    """Tiers (topologically ordered), call edges, request classes."""

    tiers: tuple[ServiceTier, ...]
    edges: tuple[tuple[str, str], ...]
    classes: tuple[RequestClass, ...]

    def __post_init__(self) -> None:
        names = [t.name for t in self.tiers]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate tier names: {names}")
        cnames = [c.name for c in self.classes]
        if len(set(cnames)) != len(cnames):
            raise ValueError(f"duplicate class names: {cnames}")
        if not self.classes:
            raise ValueError("at least one request class required")
        idx = {n: i for i, n in enumerate(names)}
        for u, v in self.edges:
            if u not in idx or v not in idx:
                raise ValueError(f"edge ({u!r}, {v!r}) names unknown tiers")
            if idx[u] >= idx[v]:
                raise ValueError(
                    f"edge ({u!r}, {v!r}) violates the topological tier "
                    f"order (caller must precede callee)")
        for c in self.classes:
            for t in c.visit_map:
                if t not in idx:
                    raise ValueError(
                        f"class {c.name!r} visits unknown tier {t!r}")

    # ------------------------------------------------------------------
    # static structure
    # ------------------------------------------------------------------

    @property
    def n_tiers(self) -> int:
        return len(self.tiers)

    @property
    def tier_names(self) -> tuple[str, ...]:
        return tuple(t.name for t in self.tiers)

    @property
    def class_names(self) -> tuple[str, ...]:
        return tuple(c.name for c in self.classes)

    def index(self, tier: str) -> int:
        return self.tier_names.index(tier)

    def adjacency(self) -> np.ndarray:
        """(K, K) bool; ``adj[v, u]`` True when tier v calls tier u."""
        K = self.n_tiers
        adj = np.zeros((K, K), bool)
        idx = {n: i for i, n in enumerate(self.tier_names)}
        for u, v in self.edges:
            adj[idx[u], idx[v]] = True
        return adj

    def visit_matrix(self) -> np.ndarray:
        """(C, K) float64 visit ratios, classes x tiers."""
        W = np.zeros((len(self.classes), self.n_tiers))
        idx = {n: i for i, n in enumerate(self.tier_names)}
        for ci, c in enumerate(self.classes):
            for t, v in c.visit_map.items():
                W[ci, idx[t]] = v
        return W

    def entry_indices(self) -> np.ndarray:
        return np.asarray([self.index(c.entry) for c in self.classes],
                          np.int64)

    # ------------------------------------------------------------------
    # the queueing model (numpy ground truth, one sizing at a time)
    # ------------------------------------------------------------------

    def rates_array(self, mix: Mapping[str, float]) -> np.ndarray:
        """Class-ordered (C,) request rates; absent classes rate 0."""
        return np.asarray([float(mix.get(c.name, 0.0))
                           for c in self.classes], np.float64)

    def arrival_rates(self, mix: Mapping[str, float]) -> np.ndarray:
        """(K,) per-tier arrival rates under the request mix (req/s)."""
        return self.rates_array(mix) @ self.visit_matrix()

    def tier_sojourns(
        self,
        sizing: Mapping[str, tuple[ContainerSize, int]],
        mix: Mapping[str, float],
        sat_s: float = 1e4,
    ) -> np.ndarray:
        """(K,) M/M/c sojourn (wait + service) per tier; ``sat_s`` for
        tiers whose offered load exceeds their service capacity."""
        lam = self.arrival_rates(mix)
        out = np.empty(self.n_tiers)
        for k, tier in enumerate(self.tiers):
            size, repl = sizing[tier.name]
            out[k] = mmc_sojourn(lam[k], tier.service_rate(size),
                                 int(repl), sat_s=sat_s)
        return out

    def class_latencies(
        self,
        sizing: Mapping[str, tuple[ContainerSize, int]],
        mix: Mapping[str, float],
        sat_s: float = 1e4,
    ) -> np.ndarray:
        """(C,) end-to-end latency per class: the visit-weighted critical
        path of the DAG from the class entry (exact — tiers are
        topologically ordered, so one reverse pass suffices)."""
        soj = self.tier_sojourns(sizing, mix, sat_s=sat_s)
        adj = self.adjacency()
        W = self.visit_matrix()
        K = self.n_tiers
        out = np.empty(len(self.classes))
        for ci in range(len(self.classes)):
            node = W[ci] * soj
            L = np.zeros(K)
            for v in range(K - 1, -1, -1):
                child = L[adj[v]].max() if adj[v].any() else 0.0
                L[v] = node[v] + max(child, 0.0)
            out[ci] = L[self.entry_indices()[ci]]
        return out

    def cost_rate(
        self,
        sizing: Mapping[str, tuple[ContainerSize, int]],
        price_per_core_hr: float,
    ) -> float:
        """$/hr of the deployment: sum of replicas x cpu x core rate."""
        return float(sum(
            int(repl) * size.cpu * price_per_core_hr
            for size, repl in (sizing[t.name] for t in self.tiers)))

    def total_cores(
        self, sizing: Mapping[str, tuple[ContainerSize, int]]
    ) -> int:
        return int(sum(int(repl) * size.cpu
                       for size, repl in (sizing[t.name]
                                          for t in self.tiers)))


def mmc_sojourn(lam: float, mu: float, c: int, sat_s: float = 1e4) -> float:
    """M/M/c mean sojourn time via the stable Erlang-B recurrence.

    ``B_k = a B_{k-1} / (k + a B_{k-1})`` stays in [0, 1] (no a^c / c!
    overflow); Erlang C = B_c / (1 - rho (1 - B_c)); sojourn = wait +
    1/mu.  Unstable queues (lam >= c mu) return ``sat_s``.
    """
    if mu <= 0:
        raise ValueError("mu must be > 0")
    if c < 1:
        raise ValueError("c must be >= 1")
    a = lam / mu
    slack = c * mu - lam
    if slack <= 1e-9:
        return float(sat_s)
    b = 1.0
    for k in range(1, c + 1):
        b = a * b / (k + a * b)
    rho = a / c
    p_wait = b / max(1.0 - rho * (1.0 - b), 1e-12)
    return p_wait / slack + 1.0 / mu


# ---------------------------------------------------------------------------
# Drifting request mixes (paper sec. 4.3, per request class).
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class DriftingMix:
    """Per-class request rates drifting from ``before`` to ``after``.

    The change starts at control round ``change_at``; with ``ramp > 0``
    the rates interpolate linearly over that many rounds (a diurnal
    shift), otherwise they step (the paper's abrupt sec. 4.3 change).
    """

    before: Mapping[str, float]
    after: Mapping[str, float]
    change_at: int
    ramp: int = 0

    def __post_init__(self) -> None:
        if self.change_at < 0 or self.ramp < 0:
            raise ValueError("change_at and ramp must be >= 0")

    def at(self, n: int) -> dict[str, float]:
        """The mix in effect at control round ``n``."""
        if n < self.change_at:
            return dict(self.before)
        if self.ramp <= 0 or n >= self.change_at + self.ramp:
            return dict(self.after)
        t = (n - self.change_at + 1) / (self.ramp + 1)
        names = set(self.before) | set(self.after)
        return {k: (1 - t) * float(self.before.get(k, 0.0))
                + t * float(self.after.get(k, 0.0)) for k in names}

    def peak(self) -> dict[str, float]:
        """Elementwise max of the endpoints — what a static deployment
        must provision for."""
        names = set(self.before) | set(self.after)
        return {k: max(float(self.before.get(k, 0.0)),
                       float(self.after.get(k, 0.0))) for k in names}


def as_mix_schedule(
    mix: Mapping[str, float] | DriftingMix | Any,
):
    """Normalize a static mapping / DriftingMix / callable to
    ``round -> dict`` form."""
    if isinstance(mix, DriftingMix):
        return mix.at
    if callable(mix):
        return mix
    fixed = dict(mix)
    return lambda n: dict(fixed)
