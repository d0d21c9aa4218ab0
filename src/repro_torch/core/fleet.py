"""Multi-tenant fleet control: shared-capacity arbitration over one
batched annealing call.

The paper's controller (:mod:`repro_torch.core.procurement`) anneals ONE
tenant's
configuration against an unbounded catalog; its conclusion argues the
platform should extend to many concurrent workloads negotiating a shared
cloud.  Per-service tuning without a cluster-wide budget oscillates and
overspends (AutoTune, arXiv:2106.10334; Rodriguez & Buyya,
arXiv:1812.00300), so the coupling here lives *inside* the annealing
objective rather than as an after-the-fact clamp.

:class:`FleetController` owns T tenants over a shared :class:`ConfigSpace`,
a capacity-capped :class:`ServiceCatalog` and a global dollar-rate budget.
Each control round it

1. draws one job per tenant from a :class:`MultiTenantStream` (per-tenant
   blends, staggered change points) and rebuilds any tenant's blended
   objective table whose blend changed (tables are cached per blend);
2. recomputes each tenant's *coupling penalty row* from the previous
   round's incumbents: for every candidate state, the aggregate
   capacity/budget overshoot the tenant would cause given the OTHER
   tenants' current allocations, scaled by
   :meth:`PenalizedObjective.penalize`;
3. walks the tenants' chains in ONE :func:`fleet_chains` call (one
   ``anneal_walk`` launch on the card), per-tenant tables with the penalty
   rows threaded through the acceptance rule as extra costs, each chain's
   draws from its tenant's own stream (:func:`tenant_draws`);
4. arbitrates the tenants' proposals — **admit** / **hold** / **defer** /
   **preempt** by priority-weighted objective deltas — so no round ends
   with the aggregate over capacity while a feasible repair exists;
5. logs one :class:`FleetDecision` per tenant (field-compatible with the
   single-tenant :class:`Decision` audit format) and mirrors the final
   allocation into the catalog's reservation ledger
   (:meth:`ServiceCatalog.reserve`).

The port of the reference package's ``core/fleet.py``: the controller's
tables, penalties and arbitration stay float64 numpy on the host, as
there; only the walk's inputs go to ``device`` (float32), in one upload,
and its outputs come back in one read-back a round.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Mapping, Sequence

import numpy as np
import torch

from ..device import resolve_device
from .annealing import chain_accept_stats, fleet_chains, tenant_draws
from .change_detect import BatchedPageHinkley
from .instrumentation import note_round
from ..telemetry import provenance
from ..telemetry import registry as metrics
from ..telemetry import span
from .costmodel import Evaluator
from .objective import Objective, PenalizedObjective
from .pricing import ServiceCatalog
from .procurement import ControllerMixin, Decision, _same_device
from .schedules import AdaptiveReheat, Schedule
from .state import ClusterConfig, ConfigSpace, cluster_config_from
from .surrogate import ExhaustiveSource, ObjectiveSource, SurrogateSource
from ..workloads.simulator import MultiTenantStream, TenantWorkload


@dataclasses.dataclass(frozen=True)
class TenantSpec:
    """One tenant of the shared fleet.

    ``priority`` weighs the tenant's objective deltas during arbitration
    (higher = admitted first) and shields it from preemption (lowest
    priority is preempted first).  ``blend_after``/``change_at`` declare a
    staggered workload change at the given control ROUND (paper sec. 4.3,
    per tenant).  ``init`` overrides the default start (the cheapest valid
    state, which keeps round 0 trivially feasible when capacity admits
    every tenant at minimum scale).
    """

    name: str
    blend: Mapping[str, float]
    priority: float = 1.0
    blend_after: Mapping[str, float] | None = None
    change_at: int | None = None
    init: tuple[int, ...] | None = None

    def __post_init__(self) -> None:
        if self.priority <= 0:
            raise ValueError(f"tenant {self.name!r}: priority must be > 0")


@dataclasses.dataclass(frozen=True)
class FleetDecision(Decision):
    """A per-tenant, per-round fleet decision.

    Extends the single-tenant audit record with the tenant identity, the
    control round, the arbitration ``action`` ("admit" — proposal applied;
    "hold" — no improving proposal; "defer" — improving proposal rejected
    for aggregate capacity/budget; "preempt" — forcibly moved to restore
    feasibility) and ``violation`` — the tenant's marginal contribution
    (unweighted: cores over capacity plus $/hr over budget) to the FINAL
    assignment's aggregate overshoot, 0.0 in any feasible round.
    ``n`` carries the round index, so single-tenant audit tooling keyed on
    ``n`` still orders records correctly.  ``explored`` keeps the
    single-tenant meaning — the tenant's chain accepted an uphill move
    during the round — not a property of the arbitrated proposal (which,
    as an argmin over visited states, is never uphill).  The inherited
    ``true_measures`` / ``surrogate_queries`` counters are fleet-wide
    cumulative totals (table-building measurements included), so benches
    can difference them to report measurement savings per round.
    """

    tenant: str
    round: int
    action: str
    violation: float


#: FleetDecision's fields, in order (its generated ``__init__``'s).
_DECISION_FIELDS = tuple(f.name for f in dataclasses.fields(FleetDecision))
if hasattr(FleetDecision, "__post_init__") \
        or hasattr(FleetDecision, "__slots__"):
    raise TypeError("fleet._decision fills FleetDecision's __dict__: it "
                    "would skip a __post_init__ and cannot fill __slots__")


def _decision(*values: Any) -> FleetDecision:
    """``FleetDecision`` of every field's value, in field order, without
    the frozen ``__init__``'s ``object.__setattr__`` a field: the fleet
    builds a record a tenant a round, and at 1,024 tenants that call
    costs several times the fill (``fleet_host_costs.py``)."""
    d = object.__new__(FleetDecision)
    d.__dict__.update(zip(_DECISION_FIELDS, values))
    return d


class FleetController(ControllerMixin):
    """Online multi-tenant procurement over a shared, finite catalog.

    All tenants share one ``space`` (the catalog's configuration axes);
    their individual workloads live in per-tenant objective *tables*, which
    is exactly the per-chain form of :func:`fleet_chains`.

    ``budget_usd_hr`` caps the fleet's aggregate spend *rate* (sum over
    tenants of their configuration's on-demand $/hr); per-family core
    capacities come from the catalog (:meth:`ServiceCatalog.capacity`).

    ``config_fn`` maps a decoded state to the :class:`ClusterConfig` the
    capacity ledger accounts (default :func:`cluster_config_from`) —
    microservice container tenants pass
    :func:`repro_torch.core.sizing.microservice_config_fn` so their per-tier
    sizings settle into a total-core footprint on the hosting family,
    and their measurements route through
    :meth:`Evaluator.measure_decoded`.

    ``device`` (default ``"cuda"``, which raises where there is no card)
    is where the chains walk; a :class:`SurrogateSource` built for another
    device is refused.  ``mesh`` must be None: sharding the chains over
    several cards waits for the multi-card slice (ROADMAP A8.3).
    """

    def __init__(
        self,
        space: ConfigSpace,
        catalog: ServiceCatalog,
        evaluator: Evaluator,
        tenants: Sequence[TenantSpec],
        objective: Objective | PenalizedObjective | None = None,
        budget_usd_hr: float = math.inf,
        steps_per_round: int = 32,
        tau: float = 1.0,
        tau_hot: float | None = None,
        detectors: bool = True,
        seed: int = 0,
        objective_source: ObjectiveSource | None = None,
        config_fn: "Callable[[Mapping[str, Any]], ClusterConfig] | None" = None,
        eval_workers: int | None = None,
        incremental: bool = False,
        settle_rounds: int = 3,
        mesh: Any = None,
        chain_bucketing: bool = True,
        ledger_check_every: int = 64,
        keep_decision_log: bool = True,
        device: "str | torch.device" = "cuda",
    ):
        if mesh is not None:
            raise ValueError(
                "mesh: sharding the fleet's chains over several cards "
                "waits for the multi-card slice (ROADMAP A8.3); pass "
                "mesh=None")
        self.device = resolve_device(device)
        if not tenants:
            raise ValueError("at least one tenant required")
        names = [t.name for t in tenants]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate tenant names: {names}")
        if steps_per_round < 1:
            raise ValueError("steps_per_round must be >= 1")
        if objective is None:
            objective = PenalizedObjective()
        elif isinstance(objective, Objective):
            objective = PenalizedObjective(base=objective)
        self.space = space
        self.catalog = catalog
        self.evaluator = evaluator
        self.tenants = tuple(tenants)
        self.objective = objective
        self.budget_usd_hr = float(budget_usd_hr)
        self.steps_per_round = int(steps_per_round)
        # measurement-phase concurrency (None: pool for wall-clock
        # evaluators, one batched measure_many call otherwise — see
        # repro_torch.core.evalpipe.measure_requests)
        self.eval_workers = eval_workers
        # -- scaling knobs (trace-driven fleets at 1k+ tenants) --
        # incremental rounds: re-anneal only tenants whose detectors
        # fired / whose workload changed / who just arrived; the rest
        # carry their incumbent (settle_rounds extra rounds after any of
        # those events let a freshly perturbed chain converge)
        if settle_rounds < 1:
            raise ValueError("settle_rounds must be >= 1")
        self.incremental = bool(incremental)
        self.settle_rounds = int(settle_rounds)
        # chain_bucketing pads the chain axis to pow-2 buckets, so churning
        # tenant counts walk a handful of chain-axis sizes
        self.chain_bucketing = bool(chain_bucketing)
        # every N rounds, cross-check the incrementally maintained
        # reservation mirror against a from-scratch recompute (0 = never)
        self.ledger_check_every = int(ledger_check_every)
        # huge replays (1k tenants x hundreds of rounds) opt out of
        # retaining every FleetDecision; round() still returns them
        self.keep_decision_log = bool(keep_decision_log)
        if isinstance(objective_source, SurrogateSource) and not \
                _same_device(torch.device(objective_source.device),
                             self.device):
            raise ValueError(
                f"objective_source interpolates on "
                f"{objective_source.device} but the fleet walks on "
                f"{self.device}; build the SurrogateSource with "
                f"device={str(self.device)!r}")
        self.objective_source = (ExhaustiveSource()
                                 if objective_source is None
                                 else objective_source)
        # config_fn maps a decoded state to the ClusterConfig the capacity
        # ledger accounts — the seam that lets non-VM tenants (microservice
        # container deployments, repro_torch.core.sizing) report their core
        # footprint without forcing their axes into ClusterConfig fields
        self._config_of = (cluster_config_from if config_fn is None
                           else config_fn)
        self._init_decision_log()   # before any counted table building
        self._seed = int(seed)
        self._enc = space.encoded()
        self._shape = self._enc.shape

        self._stream = MultiTenantStream(
            [TenantWorkload(t.name, t.blend, t.blend_after, t.change_at)
             for t in tenants],
            seed=seed,
        )

        # -- static usage model over the flattened space --
        S = self._enc.size()
        fam_names = catalog.names()
        self._families = fam_names
        fam_idx = {f: i for i, f in enumerate(fam_names)}
        self._cores_by_family = np.zeros((len(fam_names), S), np.float64)
        self._spend_rate = np.zeros(S, np.float64)
        self._valid_flat = (np.ones(S, bool) if self._enc.valid_mask is None
                            else self._enc.valid_mask.reshape(-1))
        # the walk's valid mask, on the device once
        self._valid_dev = (None if self._enc.valid_mask is None
                           else torch.from_numpy(self._valid_flat.copy())
                           .to(self.device))
        for s in range(S):
            idx = np.unravel_index(s, self._shape)
            cfg = self._config_of(space.decode([int(i) for i in idx]))
            cores = float(cfg.total_cores)
            self._cores_by_family[fam_idx[cfg.instance_type], s] = cores
            self._spend_rate[s] = (
                catalog[cfg.instance_type].price_per_core_hr * cores)
        self._mirrored: dict[str, float] = {}
        self._capacity = np.zeros(len(fam_names), np.float64)
        self._refresh_capacity()   # respects pre-existing foreign holds
        feasible_spend = np.where(self._valid_flat, self._spend_rate, np.inf)
        feasible_cores = np.where(
            self._valid_flat, self._cores_by_family.sum(0), np.inf)
        self._fallback = int(np.lexsort((feasible_cores, feasible_spend))[0])
        if not self._valid_flat[self._fallback]:
            raise ValueError("space has no valid states")

        # -- per-tenant mutable controller state --
        self._tables: dict[tuple, np.ndarray] = {}       # blend -> flat table
        self._incumbents = np.empty(len(tenants), np.int64)
        for i, t in enumerate(tenants):
            if t.init is not None:
                if not space.contains(t.init):
                    raise ValueError(
                        f"tenant {t.name!r}: init {t.init} not valid")
                self._incumbents[i] = int(
                    np.ravel_multi_index(t.init, self._shape))
            else:
                self._incumbents[i] = self._fallback
        self._tenant_tables = [
            self._table_for(self._stream.blend_of(t.name))
            for t in tenants
        ]
        # the stream's blend dict each table was last checked against
        # (see MultiTenantStream.current_blends: a changed blend is a new
        # dict, so a round re-checks only the replaced ones)
        self._tenant_blends: list[Any] = [None] * len(tenants)
        self._tau = float(tau)
        self._tau_hot = (8.0 * tau if tau_hot is None else float(tau_hot))
        self._schedules: list[Schedule] = [
            self._make_schedule() for _ in tenants
        ]
        self._detector = (BatchedPageHinkley(len(tenants)) if detectors
                          else None)
        self._reheat_pending = [False] * len(tenants)
        self._prev_cfgs = [None] * len(tenants)
        # per-tenant PERSISTENT chain-RNG stream ids: never reused, so a
        # same-round remove+add swap cannot hand the newcomer the
        # departed tenant's RNG stream (keys were positional before), and
        # a tenant's walk is invariant to who else is in the fleet — the
        # property that makes incremental rounds decision-identical to
        # full rounds on the re-annealed tenants
        self._stream_ids = np.arange(len(tenants), dtype=np.int64)
        self._next_stream_id = len(tenants)
        # rounds of forced re-annealing left per tenant (arrival / drift /
        # table change reset it to settle_rounds); incremental rounds
        # anneal only tenants with _settle > 0 or a pending reheat
        self._settle = np.full(len(tenants), self.settle_rounds, np.int64)
        self._decode_cache: dict[int, tuple[dict[str, Any],
                                            ClusterConfig]] = {}
        self._round = 0
        self.last_annealed = 0
        self.violation_history: list[float] = []
        self._mirror_reservations()

    # ------------------------------------------------------------------
    # tables and coupling penalties
    # ------------------------------------------------------------------

    def _table_for(self, blend: Mapping[str, float]) -> np.ndarray:
        """Flat (size,) blended base-objective table; cached per blend.

        The table comes from the injected :class:`ObjectiveSource`: the
        default :class:`ExhaustiveSource` evaluates every valid state
        (the historical behavior — fine for simulators), while a
        :class:`repro_torch.core.surrogate.SurrogateSource` probes a sparse
        sample and interpolates — the mode that lets the fleet drive
        :class:`MeasuredEvaluator` workloads, where each probe is real
        cluster time."""
        names, weights = self.normalize_blend(blend)
        key = tuple(sorted(zip(names, weights)))
        if key not in self._tables:
            base = self.objective.base

            def fn(decoded: dict[str, Any]) -> float:
                cfg = self._config_of(decoded)
                self._count_measures(len(names))
                return float(sum(
                    w * base(self.evaluator.measure_decoded(
                        decoded, name, 0, cfg))
                    for name, w in zip(names, weights)))

            table = np.asarray(self.objective_source.table(
                self.space, fn, valid_mask=self._enc.valid_mask),
                np.float64)
            self._tables[key] = table.reshape(-1)
        return self._tables[key]

    def _overshoot_row(
        self, others_cores: np.ndarray, others_spend: float
    ) -> np.ndarray:
        """(size,) aggregate overshoot a tenant would cause at each
        candidate state, given the other tenants' usage: capacity overshoot
        in cores (summed across families) plus $/hr beyond the budget.
        The single source of truth for both the annealing coupling penalty
        and arbitration's feasibility headroom."""
        over_c = np.clip(
            self._cores_by_family
            + (others_cores - self._capacity)[:, None],
            0.0, None).sum(0)
        over_b = np.clip(
            self._spend_rate + (others_spend - self.budget_usd_hr),
            0.0, None)
        return over_c + over_b

    def coupling_rows(
        self, incumbents: Sequence[int] | np.ndarray | None = None
    ) -> np.ndarray:
        """(T, size) penalty rows: for tenant i at candidate state s, the
        weighted aggregate capacity + budget overshoot given the OTHER
        tenants' incumbent allocations.  Fully vectorized over tenants
        (the per-tenant Python loop it replaces was an O(T) interpreter
        cost per round that dominated at 1k+ tenants)."""
        inc = np.asarray(
            self._incumbents if incumbents is None else incumbents,
            np.int64)
        T = len(self.tenants)
        if inc.shape != (T,):
            raise ValueError(f"incumbents shape {inc.shape} != ({T},)")
        agg_cores = self._cores_by_family[:, inc].sum(1)       # (F,)
        agg_spend = float(self._spend_rate[inc].sum())
        others_c = agg_cores[:, None] - self._cores_by_family[:, inc]  # (F,T)
        others_s = agg_spend - self._spend_rate[inc]                   # (T,)
        # summed over families one (T, size) slab at a time, in family
        # order: the reduction's own order, without its (F, T, size) array
        head = others_c - self._capacity[:, None]
        over_c = np.clip(self._cores_by_family[0][None, :]
                         + head[0][:, None], 0.0, None)        # (T, size)
        for f in range(1, len(self._families)):
            over_c += np.clip(self._cores_by_family[f][None, :]
                              + head[f][:, None], 0.0, None)
        over_b = np.clip(
            self._spend_rate[None, :]
            + (others_s - self.budget_usd_hr)[:, None],
            0.0, None)                                         # (T, size)
        return self.objective.penalize(0.0, over_c + over_b)

    def coupling_penalty(self, enc, n_chains: int) -> np.ndarray:
        """The current incumbent-derived rows, reshaped to ``(T,) +
        space.shape`` (the form of the reference's ``anneal_fleet``
        ``coupling_penalty`` hook; the port's engine takes the rows as
        ``extra_costs``)."""
        if n_chains != len(self.tenants):
            raise ValueError(
                f"n_chains {n_chains} != {len(self.tenants)} tenants")
        return self.coupling_rows().reshape((n_chains,) + self._shape)

    # ------------------------------------------------------------------
    # feasibility
    # ------------------------------------------------------------------

    def _aggregate(self, states: np.ndarray) -> tuple[np.ndarray, float]:
        return (self._cores_by_family[:, states].sum(1),
                float(self._spend_rate[states].sum()))

    def _refresh_capacity(self) -> None:
        """Effective per-family capacity = what the catalog can still give
        us plus what we already hold: ``remaining() + own mirror``.  Read
        each round, so reservations placed by OTHERS (operator headroom
        holds, a second controller on the same catalog) shrink our
        feasible region live instead of being silently allocated over."""
        self._capacity = np.asarray([
            self.catalog.remaining(f) + self._mirrored.get(f, 0.0)
            for f in self._families], np.float64)

    def _overshoot(self, cores: np.ndarray, spend: float) -> float:
        """Scalar overshoot of an aggregate usage: cores beyond each
        family's capacity (summed) plus $/hr beyond the budget.  The one
        source of truth for feasibility — `_violation`, `_best_feasible`
        and the preemption pass all measure against this."""
        return float(np.clip(cores - self._capacity, 0.0, None).sum()
                     + max(0.0, spend - self.budget_usd_hr))

    def _violation(self, states: np.ndarray) -> float:
        """Aggregate overshoot (cores across families + $/hr) of an
        assignment; 0.0 iff feasible."""
        return self._overshoot(*self._aggregate(states))

    def _feasible(self, states: np.ndarray) -> bool:
        return self._violation(states) <= 1e-9

    def _others_usage(
        self, i: int, states: np.ndarray
    ) -> tuple[np.ndarray, float]:
        """Aggregate (cores-by-family, $/hr) of everyone EXCEPT tenant i."""
        cores, spend = self._aggregate(states)
        return (cores - self._cores_by_family[:, states[i]],
                spend - self._spend_rate[states[i]])

    def _best_feasible_from(
        self, i: int, cores_wo: np.ndarray, spend_wo: float
    ) -> int:
        """Tenant i's best valid state that adds no MARGINAL overshoot
        beyond what the other tenants already cause; the global cheapest
        valid state if every state would deepen the breach.  Marginal —
        not total — headroom matters here: while others violate, the
        others' overshoot is a constant across ALL of tenant i's candidate
        states, and testing against total overshoot would declare nothing
        fitting and churn tenants that use none of the breached resource."""
        row = self._overshoot_row(cores_wo, spend_wo)
        others_v = self._overshoot(cores_wo, spend_wo)
        fits = self._valid_flat & (row - others_v <= 1e-9)
        if not fits.any():
            return self._fallback
        y = self._tenant_tables[i]
        return int(np.where(fits, y, np.inf).argmin())

    def _best_feasible(self, i: int, states: np.ndarray) -> int:
        return self._best_feasible_from(*(
            (i,) + self._others_usage(i, states)))

    def _arbitrate(
        self, proposals: np.ndarray, pen_tables: np.ndarray
    ) -> tuple[np.ndarray, list[str]]:
        """Greedy admission by priority-weighted improvement, then a
        preemption repair pass (lowest priority first) if the assignment is
        still infeasible.  ``pen_tables`` is (T, size): base + coupling.

        Feasibility is tracked by INCREMENTAL delta updates to one running
        (cores-by-family, $/hr) aggregate — O(F) per admission trial
        instead of the O(T) from-scratch re-aggregation per trial this
        replaces (which made the admission pass O(T^2) at 1k tenants).
        The per-round :meth:`_ledger_crosscheck` guards the running
        aggregate's integrity against a from-scratch recompute."""
        T = len(self.tenants)
        cur = self._incumbents.copy()
        cores, spend = self._aggregate(cur)
        rng_t = np.arange(T)
        deltas = pen_tables[rng_t, cur] - pen_tables[rng_t, proposals]
        weights = np.asarray([t.priority for t in self.tenants])
        order = np.argsort(-(weights * deltas), kind="stable")
        actions = ["hold"] * T
        # provenance-armed only: which tenant's marginal breach share
        # caused each defer/preempt (dark rounds pay one dict literal)
        attrib: dict[int, str] = {}
        armed = provenance.get() is not None
        # the tenants with an improving move (a tenant's own entries are
        # the only ones the pass changes before it reaches that tenant)
        moving = (proposals != cur) & (deltas > 0)
        for i in order[moving[order]]:
            dc = (self._cores_by_family[:, proposals[i]]
                  - self._cores_by_family[:, cur[i]])
            ds = self._spend_rate[proposals[i]] - self._spend_rate[cur[i]]
            if self._overshoot(cores + dc, spend + ds) <= 1e-9:
                cores, spend = cores + dc, spend + ds
                cur[i] = proposals[i]
                actions[i] = "admit"
            else:
                actions[i] = "defer"
                if armed:
                    trial = cur.copy()
                    trial[i] = proposals[i]
                    attrib[i] = self._attribute_breach(
                        cores + dc, spend + ds, trial, exclude=i)
        if self._overshoot(cores, spend) > 1e-9:
            # incumbents themselves violate (shrunk capacity, hot start):
            # preempt lowest-priority tenants onto their best fitting
            # state — but only tenants actually CONTRIBUTING to the breach
            # (moving a tenant whose marginal overshoot is zero costs a
            # migration and reduces the violation by nothing)
            for i in sorted(range(T), key=lambda i: weights[i]):
                v = self._overshoot(cores, spend)
                if v <= 1e-9:
                    break
                cores_wo = cores - self._cores_by_family[:, cur[i]]
                spend_wo = spend - self._spend_rate[cur[i]]
                if v - self._overshoot(cores_wo, spend_wo) <= 1e-9:
                    continue
                best = self._best_feasible_from(i, cores_wo, spend_wo)
                if best != cur[i]:
                    if armed:
                        attrib[i] = self._attribute_breach(
                            cores, spend, cur, exclude=i)
                    cores = cores_wo + self._cores_by_family[:, best]
                    spend = spend_wo + float(self._spend_rate[best])
                    cur[i] = best
                    actions[i] = "preempt"
        self._last_attribution = attrib
        return cur, actions

    def _attribute_breach(self, cores: np.ndarray, spend: float,
                          states: np.ndarray, exclude: int) -> str:
        """Name of the tenant (other than ``exclude``) whose marginal
        contribution to the aggregate overshoot at ``(cores, spend)`` —
        given assignment ``states`` — is largest; "" when no other
        tenant contributes.  Provenance-armed arbitration only."""
        v = self._overshoot(cores, spend)
        best_j, best_m = -1, 1e-9
        for j in range(len(self.tenants)):
            if j == exclude:
                continue
            m = v - self._overshoot(
                cores - self._cores_by_family[:, states[j]],
                spend - self._spend_rate[states[j]])
            if m > best_m:
                best_j, best_m = j, m
        return self.tenants[best_j].name if best_j >= 0 else ""

    # ------------------------------------------------------------------
    # the control round
    # ------------------------------------------------------------------

    def _chain_draws(self, r: int, ids) -> dict[str, Any]:
        """Per-tenant chain draws for round ``r`` from the PERSISTENT
        stream ids: :func:`tenant_draws` of ``(seed, r, id)``, the
        counterpart of the reference's ``fold_in(fold_in(key, r), id)``.
        Positional draws would tie a tenant's chain to its INDEX in the
        fleet — a same-round departure+arrival would hand the newcomer
        the departed tenant's exact stream, and any churn would shift
        every later tenant's walk.  Id-derived draws make a tenant's chain
        invariant to fleet composition, which is also what makes
        incremental rounds decision-identical to full rounds on the
        tenants they do re-anneal.  ``ids`` as :func:`tenant_draws` takes
        them; the module-level ``tenant_draws`` is the one seam the draws
        pass (tests replace it to replay another engine's draws)."""
        return tenant_draws(self._seed, r, ids, self._enc,
                            self.steps_per_round, device=self.device)

    def _walk(self, r: int, active: np.ndarray, tables: np.ndarray,
              rows: np.ndarray, taus: np.ndarray, inits: np.ndarray
              ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """The active chains' walk on ``device``: one upload of its inputs
        (stream ids, then the float32 tables, coupling rows and
        temperatures, then the int32 starts, packed into one int32
        buffer), one :func:`fleet_chains` call, and one read-back of its
        states, objectives and accept flags packed into one int32 tensor
        (the reference's single ``device_get`` a round)."""
        A, S = taus.shape
        ndim = inits.shape[1]
        f32 = np.concatenate([tables.astype(np.float32).ravel(),
                              rows.astype(np.float32).ravel(),
                              taus.astype(np.float32).ravel()])
        buf = np.concatenate([
            self._stream_ids[active].astype(np.int64).view(np.int32),
            f32.view(np.int32), inits.astype(np.int32).ravel()])
        # pageable memory: the copy is staged before .to returns, and
        # non_blocking keeps the host from waiting on the card
        dbuf = torch.from_numpy(buf).to(self.device, non_blocking=True)
        size = tables.shape[1]
        ids = dbuf[:2 * A].view(torch.int64)
        fl = dbuf[2 * A:2 * A + f32.size].view(torch.float32)
        tab_d = fl[:A * size].view(A, size)
        rows_d = fl[A * size:2 * A * size].view(A, size)
        taus_d = fl[2 * A * size:].view(A, S)
        inits_d = dbuf[2 * A + f32.size:].view(A, ndim)
        st, ys_d, acc_d = fleet_chains(
            None, tab_d, self._valid_dev, taus_d, inits_d, rows_d,
            shape=self._shape, categorical=self._enc.categorical,
            bucket=self.chain_bucketing, draws=self._chain_draws(r, ids),
            device=self.device)
        packed = torch.cat([st.reshape(A, S * ndim), ys_d.view(torch.int32),
                            acc_d.to(torch.int32)], 1).cpu().numpy()
        return (packed[:, :S * ndim].reshape(A, S, ndim),
                packed[:, S * ndim:S * ndim + S].view(np.float32),
                packed[:, S * ndim + S:].astype(bool))

    def _refit(self) -> None:
        """Point each tenant at its current blend's table (cached per
        blend), re-arming the settle countdown of a tenant whose table
        changed.  Only blend dicts the stream replaced since the last
        round are looked up."""
        blends = self._stream.current_blends()
        for i, t in enumerate(self.tenants):
            blend = blends[t.name]
            if blend is self._tenant_blends[i]:
                continue
            self._tenant_blends[i] = blend
            table = self._table_for(blend)
            if table is not self._tenant_tables[i]:
                self._tenant_tables[i] = table
                self._settle[i] = self.settle_rounds  # workload changed

    def _violation_shares(self, final: np.ndarray,
                          final_v: float) -> list[float]:
        """Each tenant's marginal contribution (unweighted cores + $/hr)
        to the aggregate overshoot ``final_v`` of assignment ``final``:
        all 0.0 in a feasible round, else taken from one aggregate."""
        if final_v == 0.0:
            return [0.0] * len(final)
        cores, spend = self._aggregate(final)
        return [max(0.0, final_v - self._overshoot(
                    cores - self._cores_by_family[:, s],
                    spend - self._spend_rate[s]))
                for s in final.tolist()]

    def _active_indices(self) -> np.ndarray:
        """Tenants to re-anneal this round: everyone in full mode; in
        incremental mode only tenants still settling (arrival, workload
        change, preemption and detector fire each reset the countdown) or
        carrying a pending reheat."""
        if not self.incremental:
            return np.arange(len(self.tenants))
        mask = (self._settle > 0) | np.asarray(self._reheat_pending, bool)
        return np.flatnonzero(mask)

    def _decode_config(
        self, s: int
    ) -> tuple[dict[str, Any], ClusterConfig]:
        """Decoded state + ClusterConfig for flat state ``s``, cached —
        at 1k tenants the per-round space.decode/config_fn loop was pure
        repeated work (tenants overwhelmingly sit on a few states)."""
        hit = self._decode_cache.get(s)
        if hit is None:
            idx = tuple(int(v) for v in np.unravel_index(s, self._shape))
            decoded = self.space.decode(idx)
            hit = (decoded, self._config_of(decoded))
            self._decode_cache[s] = hit
        return hit

    def round(self) -> list[FleetDecision]:
        """One fleet control round: draw jobs, anneal the active tenants
        in one walk, arbitrate, log, and account."""
        with span("fleet.round", cat="fleet"):
            return self._round_impl()

    def _round_impl(self) -> list[FleetDecision]:
        r = self._round
        T = len(self.tenants)
        steps = self.steps_per_round

        # blend change points fire through the stream; rebuild stale tables
        # BEFORE drawing (the blends reflect round r exactly — drawing
        # first would advance the stream and switch tables one round early)
        with span("fleet.refit", cat="fleet"):
            self._refit()
        jobs = next(self._stream)
        self._refresh_capacity()   # pick up foreign reservation changes

        rows = self.coupling_rows()                          # (T, size)
        tables_mat = np.stack(self._tenant_tables)           # (T, size)
        pen_tables = tables_mat + rows                       # (T, size)
        active = self._active_indices()
        A = len(active)
        self.last_annealed = A    # replay/bench visibility: chains run
        n0 = r * steps
        proposals = self._incumbents.copy()
        ys = np.full((T, steps), np.nan)
        explored_chain = np.zeros(T, bool)
        reheats_fired = [False] * T
        taus_last = np.full(T, self._tau)
        if A:
            taus = np.empty((A, steps), np.float64)
            for k, i in enumerate(active):
                sched = self._schedules[i]
                if self._reheat_pending[i]:
                    sched.reheat(n0)
                    self._reheat_pending[i] = False
                    reheats_fired[i] = True
                    provenance.note_event(
                        "reheat", r, self.tenants[i].name,
                        detail=f"tau_hot={self._tau_hot:g}")
                taus[k] = sched.tau_array(n0, steps)
            taus_last[active] = taus[:, -1]
            inits = np.stack(
                np.unravel_index(self._incumbents[active], self._shape),
                axis=-1).astype(np.int32)
            # active chains run through fleet_chains, bucket-padded to a
            # handful of chain-axis sizes; states, objectives and accept
            # flags come back in one read-back (1 transfer a round)
            with span("fleet.anneal", cat="fleet",
                      metric="fleet/anneal_s"):
                st_h, ys_h, accepts = self._walk(
                    r, active, tables_mat[active], rows[active], taus,
                    inits)

            # proposals: best visited state (step-0 incumbent included)
            # under the penalized objective
            visited = np.concatenate(
                [inits[:, None, :], st_h], axis=1)
            flat = np.ravel_multi_index(
                tuple(visited.transpose(2, 0, 1)),
                self._shape)                              # (A, steps+1)
            pen_a = pen_tables[active]
            best = np.take_along_axis(pen_a, flat, axis=1).argmin(1)
            proposals[active] = flat[np.arange(A), best]
            ys[active] = ys_h

            # exploration: did the chain ACCEPT an uphill move this round?
            # (the single-tenant Step.explored semantics — the arbitrated
            # proposal itself is an argmin over visited states, so it can
            # never be uphill of the incumbent.)
            # (accepts: (A, steps), from the consolidated pull above)
            y0 = pen_a[np.arange(A), flat[:, 0]]
            explored_chain[active] = self.explored_flags(
                ys[active], accepts, y0)
            # one settle round consumed (detector fires below re-arm it)
            self._settle[active] = np.maximum(self._settle[active] - 1, 0)

        # drift detection.  Full mode keeps the historical semantics: the
        # chains' measured (penalized) objective stream, all tenants per
        # step in one batched update (proposals into masked-out states
        # measure +inf; the batched detector skips non-finite entries).
        # Incremental mode instead watches each tenant's INCUMBENT
        # penalized value — one observation per round, active or not: a
        # workload (table) or coupling shift moves that value and pulls
        # the tenant back into the active set, while chain exploration
        # noise — which is not drift — cannot re-arm the settle counter
        # and quietly turn incremental rounds back into full ones.
        if self._detector is not None:
            with span("fleet.detect", cat="fleet"):
                if self.incremental:
                    obs = pen_tables[np.arange(T), self._incumbents]
                    for i in np.flatnonzero(self._detector.update(obs)):
                        self._reheat_pending[i] = True
                        self._settle[i] = self.settle_rounds
                        provenance.note_event(
                            "drift", r, self.tenants[i].name,
                            detail="incumbent objective shifted")
                else:
                    for k in range(steps):
                        for i in np.flatnonzero(
                                self._detector.update(ys[:, k])):
                            self._reheat_pending[i] = True
                            self._settle[i] = self.settle_rounds
                            provenance.note_event(
                                "drift", r, self.tenants[i].name,
                                detail=f"chain objective shifted (step {k})")

        prev = self._incumbents.copy()
        with span("fleet.arbitrate", cat="fleet"):
            final, actions = self._arbitrate(proposals, pen_tables)
        self._incumbents = final
        final_v = self._violation(final)
        self.violation_history.append(final_v)
        for i, a in enumerate(actions):
            if a == "preempt":     # forcibly moved: let its chain resettle
                self._settle[i] = self.settle_rounds
        with span("fleet.ledger", cat="fleet"):
            self._mirror_reservations()
            if (self.ledger_check_every
                    and (r + 1) % self.ledger_check_every == 0):
                self._ledger_crosscheck()

        # the round's measurement phase goes through the evaluation
        # runtime's shared dispatch seam: ONE vectorized measure_many call
        # for simulated/tabulated evaluators, a bounded worker pool for
        # wall-clock ones — instead of a serial per-tenant loop
        final_l = final.tolist()
        names = [t.name for t in self.tenants]
        jobs_l = [jobs[name] for name in names]
        with span("fleet.measure", cat="fleet", metric="fleet/measure_s"):
            placed = [self._decode_config(s) for s in final_l]
            migration = self.evaluator.migration
            migs = [migration(old, cfg, self.catalog)
                    for old, (_, cfg) in zip(self._prev_cfgs, placed)]
            measured = self._measure_batch(
                [(decoded, job, r, cfg)
                 for (decoded, cfg), job in zip(placed, jobs_l)],
                eval_workers=self.eval_workers)
        self._prev_cfgs = [cfg for _, cfg in placed]

        decisions = []
        counts = self.evaluation_counts()
        # per-tenant values as Python scalars, read once for the fleet
        pen_y = pen_tables[np.arange(T), final].tolist()
        moved = (final != prev).tolist()
        explored_l = explored_chain.tolist()
        taus_l = taus_last.tolist()
        shares = self._violation_shares(final, final_v)
        for i, ((_, cfg), (mig_s, mig_usd), m) in enumerate(
                zip(placed, migs, measured)):
            # a frozen value: a new one only where the migration differs
            # from what the measurement already says
            if (mig_s, mig_usd) != (m.migration_s, m.migration_usd):
                m = dataclasses.replace(m, migration_s=mig_s,
                                        migration_usd=mig_usd)
            decisions.append(_decision(
                r, jobs_l[i], cfg, m, pen_y[i], moved[i], explored_l[i],
                taus_l[i], reheats_fired[i], counts["true_measures"],
                counts["surrogate_queries"], names[i], r, actions[i],
                shares[i]))
        if self.keep_decision_log:
            self.decisions.extend(decisions)
        if metrics.get() is not None:
            self._record_round_metrics(r, final, final_v, pen_tables,
                                       actions, reheats_fired, measured)
        if provenance.get() is not None:
            chain = None
            if A:
                chain = {"flat": flat, "pen_a": pen_a, "best": best,
                         "ys": ys[active], "accepts": accepts,
                         "y0": y0, "taus": taus}
            self._record_round_provenance(
                r, decisions, final, pen_tables, tables_mat, rows,
                active, chain)
        self._round += 1
        note_round("FleetController", self)
        return decisions

    def _record_round_provenance(self, r, decisions, final, pen_tables,
                                 tables_mat, rows, active, chain) -> None:
        """One DecisionRecord per tenant per committed round.  Called
        only with a provenance sink attached; every breakdown input is
        a table the round already computed (no extra walk outputs).

        Exactness: ``exact_split`` = (base table value, coupling row) —
        the committed ``y = pen_tables[i, s]`` came from the elementwise
        float64 add ``tables_mat + rows``, and the scalar ladder replays
        that identical IEEE op, so the split sums bit-for-bit.  The named
        ``terms`` ladder decomposes this round's measurement through
        :func:`provenance.objective_terms` (bit-equal to
        ``objective.base(m)``) and carries the table-vs-measurement gap
        explicitly as ``table_gap``, so the full ladder reproduces the
        committed value to float64 round-off — far inside the float32
        bar ``DecisionRecord.check`` enforces."""
        if chain is not None:
            tau_at, p_at = chain_accept_stats(
                chain["ys"], chain["accepts"], chain["y0"], chain["taus"])
        arr = {int(i): k for k, i in enumerate(active)}
        attrib = getattr(self, "_last_attribution", {})
        base_obj = self.objective.base
        for i, d in enumerate(decisions):
            s = int(final[i])
            base_val = float(tables_mat[i, s])
            coup = float(rows[i, s])
            ot = provenance.objective_terms(base_obj, d.measurement)
            y_meas = provenance.ladder_sum(ot)
            terms = ot + (("table_gap", base_val - y_meas),
                          ("coupling", coup))
            tau_i, p_i = float(d.tau), float("nan")
            rejected, rejected_y = None, float("nan")
            k = arr.get(i)
            if k is not None:
                tau_i, p_i = float(tau_at[k]), float(p_at[k])
                row = chain["flat"][k]                # visited, (steps+1,)
                pv = chain["pen_a"][k][row]
                prop = int(row[chain["best"][k]])
                if d.action in ("defer", "preempt") or prop != s:
                    # the chain's own proposal was turned down (or the
                    # arbiter moved the tenant elsewhere)
                    rejected, rejected_y = prop, float(pen_tables[i, prop])
                else:
                    # proposal committed: runner-up distinct visited state
                    mask = row != s
                    if mask.any():
                        j = int(np.where(mask, pv, np.inf).argmin())
                        rejected, rejected_y = int(row[j]), float(pv[j])
            provenance.record(provenance.DecisionRecord(
                controller="fleet", round=r, tenant=d.tenant,
                action=d.action, state=s, y=d.y, terms=terms,
                exact_split=(("base", base_val), ("coupling", coup)),
                tau=tau_i, accept_prob=p_i,
                rejected=rejected, rejected_y=rejected_y,
                counterfactual=(rejected_y - d.y if rejected is not None
                                else float("nan")),
                attribution=attrib.get(i, ""),
                violation=d.violation, reheated=d.reheated))

    def _record_round_metrics(self, r, final, final_v, pen_tables,
                              actions, reheats_fired, measured) -> None:
        """Per-round dashboard series.  Called only with a metrics sink
        attached — the dark round path pays one ``get()`` for all of it."""
        T = len(self.tenants)
        t_r = float(r)
        metrics.record("fleet/objective",
                       float(pen_tables[np.arange(T), final].mean()), t_r)
        metrics.record("fleet/spend_usd_hr",
                       float(self._spend_rate[final].sum()), t_r)
        metrics.record("fleet/violation", final_v, t_r)
        metrics.record("fleet/tenants", float(T), t_r)
        if math.isfinite(self.budget_usd_hr):
            # the alert engine's budget_burn rules read this gauge
            metrics.set_gauge("fleet/budget_usd_hr", self.budget_usd_hr)
        metrics.record("fleet/annealed", float(self.last_annealed), t_r)
        if measured:
            ok = sum(1 for m in measured if not m.slo_violated)
            metrics.record("fleet/slo_attainment", ok / len(measured), t_r)
        for a in actions:
            metrics.inc("fleet/actions/" + a)
        n_reheat = sum(reheats_fired)
        if n_reheat:
            metrics.inc("fleet/reheats", n_reheat)

    def run(self, n_rounds: int) -> list[FleetDecision]:
        out = []
        for _ in range(n_rounds):
            out.extend(self.round())
        return out

    # ------------------------------------------------------------------
    # tenant churn (arrival / departure between rounds)
    # ------------------------------------------------------------------

    def _make_schedule(self) -> Schedule:
        return AdaptiveReheat(
            tau_base=self._tau, tau_hot=self._tau_hot, relax=0.9)

    def add_tenant(self, spec: TenantSpec) -> None:
        """Admit a new tenant between rounds.

        The tenant starts at its ``init`` (or the global cheapest valid
        state), gets a fresh schedule/detector stream, and its blended
        objective table is built (cached per blend, so a returning blend
        costs a dict lookup).  ``spec.change_at`` counts *global* control
        rounds, same as founding tenants.  The reservation mirror is
        refreshed immediately, so the newcomer's footprint is visible to
        ``catalog.remaining`` before the next round."""
        if any(t.name == spec.name for t in self.tenants):
            raise ValueError(f"duplicate tenant name: {spec.name!r}")
        if spec.init is not None and not self.space.contains(spec.init):
            raise ValueError(
                f"tenant {spec.name!r}: init {spec.init} not valid")
        self._stream.add_tenant(TenantWorkload(
            spec.name, spec.blend, spec.blend_after, spec.change_at))
        self.tenants = self.tenants + (spec,)
        start = (self._fallback if spec.init is None
                 else int(np.ravel_multi_index(spec.init, self._shape)))
        self._incumbents = np.append(self._incumbents, start)
        self._tenant_tables.append(
            self._table_for(self._stream.blend_of(spec.name)))
        self._tenant_blends.append(None)
        self._schedules.append(self._make_schedule())
        if self._detector is not None:
            self._detector.add_streams(1)
        self._reheat_pending.append(False)
        self._prev_cfgs.append(None)
        # a NEVER-reused chain-RNG stream id: even if this arrival lands
        # in the same round as a departure, the newcomer cannot inherit
        # the departed tenant's RNG stream (or anyone's — ids are fresh)
        self._stream_ids = np.append(
            self._stream_ids, self._next_stream_id)
        self._next_stream_id += 1
        self._settle = np.append(self._settle, self.settle_rounds)
        self._mirror_reservations()
        metrics.inc("fleet/churn/arrive")
        provenance.note_event("arrive", self._round, spec.name)

    def remove_tenant(self, name: str) -> None:
        """Retire tenant ``name`` between rounds, releasing its share of
        the reservation ledger — the departing tenant's capacity is
        claimable by the remaining (or newly added) tenants from the very
        next round."""
        idx = [i for i, t in enumerate(self.tenants) if t.name == name]
        if not idx:
            raise KeyError(f"unknown tenant {name!r}")
        if len(self.tenants) == 1:
            raise ValueError("cannot remove the last tenant")
        i = idx[0]
        self._stream.remove_tenant(name)
        self.tenants = self.tenants[:i] + self.tenants[i + 1:]
        self._incumbents = np.delete(self._incumbents, i)
        del self._tenant_tables[i]
        del self._tenant_blends[i]
        del self._schedules[i]
        if self._detector is not None:
            self._detector.remove_stream(i)
        del self._reheat_pending[i]
        del self._prev_cfgs[i]
        # the id retires WITH the tenant (never reused — see add_tenant)
        self._stream_ids = np.delete(self._stream_ids, i)
        self._settle = np.delete(self._settle, i)
        self._mirror_reservations()
        metrics.inc("fleet/churn/depart")
        provenance.note_event("depart", self._round, name)

    def retune_tenant(
        self, name: str, blend: Mapping[str, float],
        priority: float | None = None,
    ) -> None:
        """Switch a live tenant's workload blend NOW — a trace
        *phase-change* event.  The tenant's job stream keeps its RNG
        position (only the draw distribution changes), any still-pending
        declared ``change_at`` is superseded, and the tenant re-enters
        the incremental active set for ``settle_rounds`` rounds; its
        blended objective table is rebuilt lazily at the next round
        (cached per blend, so a returning blend costs a dict lookup)."""
        idx = [i for i, t in enumerate(self.tenants) if t.name == name]
        if not idx:
            raise KeyError(f"unknown tenant {name!r}")
        i = idx[0]
        self._stream.set_blend(name, blend)
        spec = dataclasses.replace(
            self.tenants[i], blend=dict(blend), blend_after=None,
            change_at=None,
            **({} if priority is None else {"priority": priority}))
        self.tenants = self.tenants[:i] + (spec,) + self.tenants[i + 1:]
        self._settle[i] = self.settle_rounds
        metrics.inc("fleet/churn/phase")
        provenance.note_event("phase", self._round, name)

    # ------------------------------------------------------------------
    # accounting / diagnostics
    # ------------------------------------------------------------------

    def _mirror_reservations(self) -> None:
        """Reflect the current allocation in the catalog's ledger so
        ``catalog.remaining(family)`` answers 'what could one more tenant
        get'.  Only this controller's OWN previously-mirrored amounts are
        released — reservations placed by anyone else (an operator holding
        headroom, a second controller sharing the catalog) are preserved;
        if foreign holds leave less room than our aggregate, the mirror is
        clamped to what remains.  While the assignment is infeasible
        (transient: a repair pass could not fully restore feasibility) our
        entries are cleared rather than left mirroring a stale round — an
        empty mirror is visibly wrong, a previous round's is silently
        wrong.

        The update is INCREMENTAL: each family moves by the delta between
        its previous mirrored amount and the new target
        (:meth:`ServiceCatalog.adjust`), so a round that changes nothing
        touches the catalog zero times and a round that moves one tenant
        touches only the families whose aggregate actually changed —
        instead of the full release-everything/re-reserve-everything sweep
        this replaces.  :meth:`_ledger_crosscheck` periodically replays
        the from-scratch rebuild and fails loudly on any drift."""
        if not self._feasible(self._incumbents):
            for f, c in self._mirrored.items():
                self.catalog.release(f, c)
            self._mirrored = {}
            return
        cores, _ = self._aggregate(self._incumbents)
        target = dict(zip(self._families, cores))
        for f in set(target) | set(self._mirrored):
            have = self._mirrored.get(f, 0.0)
            # clamp to what the catalog can still give us ON TOP OF our
            # own existing hold — foreign holds are squeezed around, never
            # released (remaining()+have is exactly the old post-release
            # headroom, so the incremental clamp equals the rebuilt one)
            amt = min(float(target.get(f, 0.0)),
                      self.catalog.remaining(f) + have)
            if amt != have:
                self.catalog.adjust(f, amt - have)
            if amt > 0:
                self._mirrored[f] = amt
            else:
                self._mirrored.pop(f, None)

    def _ledger_crosscheck(self) -> None:
        """Replay the from-scratch mirror rebuild and compare it against
        the incrementally maintained one (every ``ledger_check_every``
        rounds).  Raises on ANY drift — mirrored amounts, or perturbation
        of foreign reservations — so the incremental ledger path stays
        exactly as trustworthy as the full rebuild it replaced."""
        inc = dict(self._mirrored)
        foreign = {f: self.catalog.reserved(f) - inc.get(f, 0.0)
                   for f in self._families}
        for f, c in inc.items():
            self.catalog.release(f, c)
        self._mirrored = {}
        self._mirror_reservations()
        ok = set(self._mirrored) == set(inc) and all(
            math.isclose(self._mirrored[f], inc[f],
                         rel_tol=1e-9, abs_tol=1e-6) for f in inc)
        ok = ok and all(
            math.isclose(
                self.catalog.reserved(f) - self._mirrored.get(f, 0.0),
                foreign[f], rel_tol=1e-9, abs_tol=1e-6)
            for f in self._families)
        if not ok:
            raise RuntimeError(
                f"reservation-mirror drift at round {self._round}: "
                f"incremental {inc} != recomputed {dict(self._mirrored)}")

    def allocations(self) -> dict[str, dict[str, Any]]:
        """Per-tenant current configuration and spend rate."""
        out = {}
        for i, t in enumerate(self.tenants):
            s = int(self._incumbents[i])
            idx = tuple(int(v) for v in np.unravel_index(s, self._shape))
            out[t.name] = {
                "config": self._config_of(self.space.decode(idx)),
                "usd_per_hr": float(self._spend_rate[s]),
                "y": float(self._tenant_tables[i][s]),
            }
        return out

    def aggregate_usage(self) -> dict[str, Any]:
        cores, spend = self._aggregate(self._incumbents)
        return {
            "cores": {f: float(c) for f, c in zip(self._families, cores)},
            "usd_per_hr": spend,
            "violation": self._violation(self._incumbents),
        }

    _telemetry_prefix = "fleet"

    def _stats_rounds(self) -> int:
        return self._round

    def _stats_extra(self) -> dict[str, Any]:
        return {
            "tenants": len(self.tenants),
            "last_annealed": int(self.last_annealed),
            "aggregate": self.aggregate_usage(),
        }
