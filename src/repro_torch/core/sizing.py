"""Container sizing: anneal microservice DAG sizings online.

The paper's third case study — "container sizing for microservice
benchmarks".  The annealing state is one (vertical size, replica count)
pair per tier of a :class:`repro_torch.workloads.microservice.
MicroserviceDAG`; the objective is the mix-share-weighted end-to-end
latency (visit-weighted DAG critical path over per-tier M/M/c sojourns)
with per-class SLO hinge penalties, plus ``lambda_cost`` times the
deployment's $/hr.

Pieces:

* :class:`SizingSpace` — builds the ConfigSpace: per-tier ``(size,
  replicas)`` ordinal axes over a container menu, plus the evaluation
  tables (service-rate curves, visit matrix, adjacency) shared by every
  evaluation path, and :meth:`SizingSpace.evaluate`, the batched scoring
  body: menu lookups -> per-tier service rates -> the Erlang-C +
  critical-path kernel (:func:`repro_torch.kernels.ops.sizing_latency`;
  the hand CUDA kernel on the card, its plain version on the CPU) ->
  per-class latencies, SLO attainment, cost and the scalar objective.

* :func:`evaluate_sizing_batch` scores caller-supplied candidates;
  :func:`sizing_table_device` enumerates the whole grid on the device and
  scores it in one pass, which is how small spaces are tabulated.

* :class:`SizingController` — the online loop on
  :class:`repro_torch.core.procurement.ControllerMixin`: each control
  round reads the (drifting) request mix, refreshes the objective table
  (cached per mix), anneals a chain fleet from the incumbent, re-measures
  the chosen sizing on the numpy ground-truth model, and feeds drift
  detection -> reheats.  With ``device_loop`` (the default) the table,
  the walk and the top-K selection stay on the device and the round reads
  back one small decision packet.  Spaces beyond the 200k tabulation cap
  inject a :class:`repro_torch.core.surrogate.SurrogateSource`.

* :class:`MicroserviceEvaluator` + :func:`microservice_config_fn` — the
  seams by which microservice tenants join a multi-tenant fleet.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, Mapping, Sequence

import numpy as np
import torch

from ..device import generator, resolve_device
from ..kernels import ops as kernel_ops
from .costmodel import Evaluator
from .instrumentation import note_round
from .change_detect import PageHinkley
from .neighborhood import row_major_strides
from .objective import Measurement
from .procurement import ControllerMixin, Decision
from .schedules import AdaptiveReheat
from .state import ClusterConfig, ConfigSpace, Dimension
from .surrogate import ObjectiveSource
from ..telemetry import provenance
from ..telemetry import registry as metrics
from ..telemetry import span
from ..workloads.microservice import (
    DEFAULT_SIZES,
    ContainerSize,
    MicroserviceDAG,
    as_mix_schedule,
)

#: Tabulation ceiling shared with :func:`repro_torch.core.landscape.
#: tabulate` — beyond it, tables must come from a sparse-measurement source.
TABULATE_CAP = 200_000


@dataclasses.dataclass(frozen=True)
class SizingSpace:
    """The ConfigSpace + evaluation tables of one sizing problem.

    Dimensions are interleaved per tier — ``"<tier>.size"`` (menu entry
    names, ordered by cpu) then ``"<tier>.repl"`` — so the compiled
    chain's +-1 moves are single-knob resizes, the paper's incremental
    exploration requirement on this scenario.
    """

    dag: MicroserviceDAG
    sizes: tuple[ContainerSize, ...] = DEFAULT_SIZES
    replica_counts: tuple[int, ...] = (1, 2, 3, 4, 6, 8)
    price_per_core_hr: float = 0.048
    lambda_cost: float = 1.0
    slo_penalty: float = 10.0
    sat_s: float = 1e4

    def __post_init__(self) -> None:
        if not self.sizes:
            raise ValueError("at least one container size required")
        if sorted(s.cpu for s in self.sizes) != [s.cpu for s in self.sizes]:
            raise ValueError("sizes must be ordered by ascending cpu")
        if (not self.replica_counts
                or any(r < 1 for r in self.replica_counts)
                or sorted(self.replica_counts) != list(self.replica_counts)):
            raise ValueError("replica_counts must be ascending and >= 1")
        if self.lambda_cost < 0 or self.slo_penalty < 0:
            raise ValueError("lambda_cost / slo_penalty must be >= 0")

    # ------------------------------------------------------------------
    # the ConfigSpace
    # ------------------------------------------------------------------

    @functools.cached_property
    def space(self) -> ConfigSpace:
        dims = []
        for tier in self.dag.tiers:
            dims.append(Dimension(f"{tier.name}.size",
                                  tuple(s.name for s in self.sizes)))
            dims.append(Dimension(f"{tier.name}.repl",
                                  tuple(self.replica_counts)))
        return ConfigSpace(tuple(dims))

    @property
    def c_max(self) -> int:
        return int(max(self.replica_counts))

    def sizing_of(
        self, decoded: Mapping[str, Any]
    ) -> dict[str, tuple[ContainerSize, int]]:
        """Decoded ConfigSpace mapping -> tier -> (size, replicas)."""
        by_name = {s.name: s for s in self.sizes}
        return {t.name: (by_name[decoded[f"{t.name}.size"]],
                         int(decoded[f"{t.name}.repl"]))
                for t in self.dag.tiers}

    def total_cores(self, decoded: Mapping[str, Any]) -> int:
        return self.dag.total_cores(self.sizing_of(decoded))

    # ------------------------------------------------------------------
    # ground truth (numpy, one sizing at a time — the "real system")
    # ------------------------------------------------------------------

    def host_objective(
        self, decoded: Mapping[str, Any], mix: Mapping[str, float]
    ) -> dict[str, Any]:
        """The objective and its components for one decoded sizing."""
        sizing = self.sizing_of(decoded)
        lat = self.dag.class_latencies(sizing, mix, sat_s=self.sat_s)
        cost = self.dag.cost_rate(sizing, self.price_per_core_hr)
        rates = self.dag.rates_array(mix)
        total = rates.sum()
        shares = rates / total if total > 0 else np.zeros_like(rates)
        slos = np.asarray([c.slo_s for c in self.dag.classes])
        viol = np.maximum(lat - slos, 0.0)
        pen_lat = float((shares * (lat + self.slo_penalty * viol)).sum())
        return {
            "y": pen_lat + self.lambda_cost * cost,
            "latency": lat,
            "penalized_latency": pen_lat,
            "cost": cost,
            "slo_attainment": (float((shares * (lat <= slos)).sum())
                               if total > 0 else 1.0),
        }

    # ------------------------------------------------------------------
    # batched evaluation (device constants, built once per device)
    # ------------------------------------------------------------------

    @functools.cached_property
    def _consts_by_device(self) -> dict[str, dict[str, torch.Tensor]]:
        return {}

    def _consts(self, dev: torch.device) -> dict[str, torch.Tensor]:
        cache = self._consts_by_device
        key = str(dev)
        if key not in cache:
            dag = self.dag
            f32 = torch.float32

            def t(values, dtype=f32):
                return torch.as_tensor(np.asarray(values), dtype=dtype,
                                       device=dev)

            cache[key] = {
                "cpu": t([s.cpu for s in self.sizes]),
                "mem": t([s.mem_gb for s in self.sizes]),
                "repl": t(self.replica_counts),
                "base": t([x.base_rate for x in dag.tiers]),
                "cpu_ref": t([x.cpu_ref for x in dag.tiers]),
                "gamma": t([x.gamma for x in dag.tiers]),
                "mem_rps": t([x.mem_per_rps_gb for x in dag.tiers]),
                "visits": t(dag.visit_matrix()),                 # (C, K)
                "adj": t(dag.adjacency(), torch.bool),
                "entries": t(dag.entry_indices(), torch.int64),
                "slos": t([c.slo_s for c in dag.classes]),
            }
        return cache[key]

    def _tier_rates(self, cand: torch.Tensor):
        """(B, 2K) candidates -> per-tier (cpu, mu, repl), each (B, K)."""
        k = self._consts(cand.device)
        size_idx = cand[:, 0::2].to(torch.int64)
        repl_idx = cand[:, 1::2].to(torch.int64)
        cpu = k["cpu"][size_idx]
        mem = k["mem"][size_idx]
        mu = k["base"][None, :] * (cpu / k["cpu_ref"][None, :]) \
            ** k["gamma"][None, :]
        mem_rps = k["mem_rps"][None, :]
        cap = torch.where(mem_rps > 0,
                          mem / torch.clamp(mem_rps, min=1e-12),
                          torch.full((), float("inf"), device=cand.device))
        return cpu, torch.minimum(mu, cap), k["repl"][repl_idx]

    def _fold_classes(self, mu, repl, rates):
        """Kernel rows with the classes folded in (row b*C + c), so one
        kernel pass yields every class's critical path: (lam, mu, repl,
        visit_w) each (B*C, K), and the (K, K) adjacency."""
        k = self._consts(mu.device)
        B, K = mu.shape
        C = len(self.dag.classes)
        visits = k["visits"]
        lam = rates @ visits                                       # (K,)
        return (lam.expand(B * C, K).contiguous(),
                mu.repeat_interleave(C, dim=0),
                repl.repeat_interleave(C, dim=0),
                visits.repeat(B, 1), k["adj"])

    def kernel_inputs(self, cand: torch.Tensor,
                      rates: torch.Tensor) -> tuple[torch.Tensor, ...]:
        """The Erlang-C kernel's inputs (lam, mu, repl, visit_w, adj) for
        candidates ``cand`` under ``rates``, as :meth:`evaluate` builds
        them (for checking the kernel at the shapes the loop gives it)."""
        _, mu, repl = self._tier_rates(cand)
        return self._fold_classes(mu, repl, rates)

    def evaluate(self, cand: torch.Tensor, rates: torch.Tensor):
        """Score B candidate sizings on their device.

        ``cand`` is (B, 2K) integer index vectors in :attr:`space`
        dimension order, ``rates`` the (C,) float32 class-ordered request
        rates, both on one device.  The Erlang-C + critical-path step goes
        through :func:`repro_torch.kernels.ops.sizing_latency`: the hand
        kernel on a CUDA device, its plain version on the CPU.  Returns float32
        tensors ``(y (B,), latency (B, C), cost (B,), attainment (B,))``.
        """
        k = self._consts(cand.device)
        K, C = self.dag.n_tiers, len(self.dag.classes)
        B = cand.shape[0]
        cpu, mu, repl = self._tier_rates(cand)
        _, path = kernel_ops.sizing_latency(
            *self._fold_classes(mu, repl, rates),
            c_max=self.c_max, sat_s=float(self.sat_s))
        lat = path.reshape(B, C, K)[:, torch.arange(C, device=cand.device),
                                    k["entries"]]                  # (B, C)
        cost = (repl * cpu).sum(dim=1) * float(self.price_per_core_hr)
        total = rates.sum()
        shares = torch.where(total > 0,
                             rates / torch.clamp(total, min=1e-12),
                             torch.zeros_like(rates))
        slos = k["slos"][None, :]
        viol = torch.clamp(lat - slos, min=0.0)
        y = ((shares[None, :] * (lat + float(self.slo_penalty) * viol))
             .sum(dim=1) + float(self.lambda_cost) * cost)
        attain = torch.where(
            total > 0, (shares[None, :] * (lat <= slos)).sum(dim=1),
            torch.ones_like(y))
        return y, lat, cost, attain

    def grid_candidates(self, device: torch.device, lo: int = 0,
                        hi: int | None = None) -> torch.Tensor:
        """Row-major candidates ``lo..hi`` of the whole product as (n, 2K)
        int64 index vectors, enumerated on ``device`` (arange -> unravel)."""
        shape = self.space.shape
        hi = int(np.prod(shape)) if hi is None else hi
        flat = torch.arange(lo, hi, device=device)
        return torch.stack([(flat // st) % n for st, n in
                            zip(row_major_strides(shape), shape)], dim=1)

    def grid_table(self, rates: torch.Tensor,
                   chunk: int = 1 << 20) -> torch.Tensor:
        """Flat (size,) float32 objective table over the whole product for
        one (C,) rates vector, on ``rates``' device: on-device candidate
        enumeration feeds :meth:`evaluate` directly — no host-materialized
        grid and no read-back.  Large grids go in chunks of ``chunk``
        candidates."""
        size = self.space.size()
        parts = [self.evaluate(self.grid_candidates(rates.device, lo,
                                                    min(lo + chunk, size)),
                               rates)[0]
                 for lo in range(0, size, chunk)]
        return parts[0] if len(parts) == 1 else torch.cat(parts)


def _rates(spec: SizingSpace, mix) -> np.ndarray:
    rates = (spec.dag.rates_array(mix) if isinstance(mix, Mapping)
             else np.asarray(mix, np.float64))
    if rates.shape != (len(spec.dag.classes),):
        raise ValueError(
            f"rates shape {rates.shape} != ({len(spec.dag.classes)},)")
    return rates


def sizing_table_device(
    spec: SizingSpace,
    mix: Mapping[str, float] | np.ndarray,
    device: str | torch.device = "cuda",
) -> torch.Tensor:
    """Flat (size,) float32 objective table for one request mix, built and
    kept on ``device``: the whole grid enumerated and scored through the
    Erlang-C kernel (:meth:`SizingSpace.grid_table`).
    :class:`SizingController`'s device loop reshapes it straight into
    :func:`repro_torch.core.annealing.anneal_fleet`."""
    rates = torch.as_tensor(_rates(spec, mix), dtype=torch.float32,
                            device=resolve_device(device))
    return spec.grid_table(rates)


def evaluate_sizing_batch(
    spec: SizingSpace,
    candidates: np.ndarray | Sequence[Sequence[int]],
    mix: Mapping[str, float] | np.ndarray,
    device: str | torch.device = "cuda",
) -> dict[str, np.ndarray]:
    """Score B candidate sizings in one batched pass on ``device``.

    ``candidates`` is (B, 2K) index vectors in ``spec.space`` dimension
    order; ``mix`` a class->req/s mapping (or a class-ordered rate
    array).

    Returns ``{"y": (B,), "latency": (B, C), "cost": (B,),
    "slo_attainment": (B,)}`` as float64 numpy arrays.
    """
    dev = resolve_device(device)
    cand = np.asarray(candidates, np.int32)
    if cand.ndim != 2 or cand.shape[1] != 2 * spec.dag.n_tiers:
        raise ValueError(
            f"candidates shape {cand.shape} != (B, {2 * spec.dag.n_tiers})")
    rates = _rates(spec, mix)
    y, lat, cost, attain = spec.evaluate(
        torch.as_tensor(cand, device=dev),
        torch.as_tensor(rates, dtype=torch.float32, device=dev))
    out = torch.cat([y[:, None], lat, cost[:, None], attain[:, None]],
                    dim=1).cpu().numpy().astype(np.float64)
    C = lat.shape[1]
    return {"y": out[:, 0], "latency": out[:, 1:1 + C],
            "cost": out[:, 1 + C], "slo_attainment": out[:, 2 + C]}


def full_grid(space: ConfigSpace) -> np.ndarray:
    """(size, ndim) index vectors over the whole product (small spaces)."""
    return np.indices(space.shape).reshape(len(space.shape), -1).T


def sizing_select(
    shape: tuple[int, ...],
    topk: int,
    inits: torch.Tensor,
    states: torch.Tensor,
    table: torch.Tensor,
    ys: torch.Tensor,
    accepts: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-K candidate selection + exploration flag, on the device.

    Replicates the host path exactly: stable argsort of the visited
    states' table estimates (ties break by visit position, chain-major),
    the first ``topk`` distinct states in that order, plus the per-chain
    accepted-uphill reduction of :meth:`repro_torch.core.procurement.
    ControllerMixin.explored_flags`.  ``inits`` (C, ndim), ``states``
    (C, steps, ndim), ``table`` the flat (size,) table, ``ys`` /
    ``accepts`` (C, steps).  Returns ((topk, ndim) int32 states with -1
    sentinel rows, 0-dim bool explored flag); fixed shapes, no read-back.
    """
    dev = table.device
    nd = inits.shape[1]
    strides = torch.tensor(row_major_strides(shape), dtype=torch.int64,
                           device=dev)
    visited = torch.cat([inits[:, None, :], states], dim=1) \
        .reshape(-1, nd).to(torch.int64)
    vflat = (visited * strides).sum(dim=1)
    iflat = (inits.to(torch.int64) * strides).sum(dim=1)
    order = torch.argsort(table[vflat], stable=True)
    fo = vflat[order]                       # visited states, best first
    N = fo.shape[0]
    pos = torch.arange(N, device=dev)
    # first occurrence of each state in that order: group equal states by
    # a stable sort, whose group heads are the earliest positions
    srt, perm = torch.sort(fo, stable=True)
    head = torch.ones(N, dtype=torch.bool, device=dev)
    head[1:] = srt[1:] != srt[:-1]
    first = torch.zeros(N, dtype=torch.bool, device=dev) \
        .scatter(0, perm, head)
    k = min(int(topk), N)
    picked = torch.sort(torch.where(first, pos, pos + N)).values[:k]
    chosen = torch.where(picked < N, fo[picked % N],
                         torch.full_like(picked, -1))
    if k < topk:
        chosen = torch.cat([chosen, torch.full((topk - k,), -1,
                                               dtype=chosen.dtype,
                                               device=dev)])
    cols, rem = [], chosen.clamp(min=0)
    for d in range(nd):
        cols.append(rem // strides[d])
        rem = rem % strides[d]
    sel = torch.where(chosen[:, None] >= 0, torch.stack(cols, dim=1),
                      torch.full((topk, nd), -1, dtype=torch.int64,
                                 device=dev)).to(torch.int32)

    # per-chain accepted-uphill flags (ControllerMixin.explored_flags)
    C, steps = ys.shape
    kk = torch.arange(steps, device=dev)[None, :]
    last = torch.cummax(torch.where(accepts, kk, torch.full_like(kk, -1)),
                        dim=1).values
    prev = torch.cat([torch.full((C, 1), -1, dtype=last.dtype, device=dev),
                      last[:, :-1]], dim=1)
    inc_before = torch.where(
        prev >= 0, torch.gather(ys, 1, prev.clamp(min=0)),
        table[iflat][:, None])
    explored = (accepts & (ys > inc_before)).any()
    return sel, explored


# ---------------------------------------------------------------------------
# The online controller.
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class SizingDecision(Decision):
    """Per-round sizing audit record.

    ``measurement.exec_time_s`` is the deadline-penalized mix-weighted
    end-to-end latency, ``measurement.cost_usd`` the deployment $/hr;
    ``y`` is the ground-truth objective re-measured AFTER the round's
    move (the drift-detector input), not the table estimate.  ``config``
    summarizes the deployment footprint (total cores) so fleet-style
    audit tooling keyed on ``config.total_cores`` works unchanged.
    """

    sizing: Mapping[str, Any]
    mix: Mapping[str, float]
    usd_per_hr: float
    slo_attainment: float


class SizingController(ControllerMixin):
    """Online annealing over container sizings under a drifting mix.

    Each :meth:`round`: read the request mix from the schedule, refresh
    the objective table if the mix changed (cached per mix), anneal
    ``n_chains`` chains for ``steps_per_round`` transitions in one
    :func:`repro_torch.core.annealing.anneal_fleet` call (chain 0 at the
    incumbent), move to the best visited sizing, re-measure it on the
    numpy ground truth and feed the drift detector (reheat next round on
    a signal — covers *unannounced* drift, e.g. a schedule the
    controller cannot see).

    ``objective_source=None`` tabulates via ONE whole-grid batched pass
    (counted into ``true_measures`` — the batched analog of
    ``ExhaustiveSource``) and refuses spaces beyond the 200k cap; inject a
    :class:`repro_torch.core.surrogate.SurrogateSource` to probe-and-
    interpolate large DAGs, or an ``ExhaustiveSource`` to force the
    scalar one-state-at-a-time path.

    ``device`` (default ``"cuda"``) is where tables, chains and the top-K
    selection run; round ``r`` draws its randomness from a
    :class:`torch.Generator` seeded from ``(seed, r)``.
    """

    def __init__(
        self,
        spec: SizingSpace,
        mix: Mapping[str, float] | Any,
        objective_source: ObjectiveSource | None = None,
        steps_per_round: int = 48,
        n_chains: int = 8,
        tau: float = 1.0,
        tau_hot: float | None = None,
        detector: bool = True,
        seed: int = 0,
        init: Sequence[int] | None = None,
        family: str = "container",
        measure_topk: int = 1,
        eval_workers: int | None = None,
        recycle_store: "Any | None" = None,
        device_loop: bool = True,
        device: str | torch.device = "cuda",
    ):
        if steps_per_round < 1 or n_chains < 1:
            raise ValueError("steps_per_round and n_chains must be >= 1")
        if measure_topk < 1:
            raise ValueError("measure_topk must be >= 1")
        self.device = resolve_device(device)
        self.spec = spec
        self.space = spec.space
        self.family = family
        self._mix_at = as_mix_schedule(mix)
        self.objective_source = objective_source
        if (objective_source is None
                and self.space.size() > TABULATE_CAP):
            raise ValueError(
                f"space has {self.space.size()} states — beyond the "
                f"{TABULATE_CAP} tabulation cap; inject a SurrogateSource "
                f"(probe and interpolate) to size this DAG")
        self.measure_topk = int(measure_topk)
        self.eval_workers = eval_workers
        self.recycle_store = recycle_store
        self._init_decision_log()
        self._enc = self.space.encoded(max_size=max(
            self.space.size(), TABULATE_CAP))
        self._shape = self._enc.shape
        self.seed = int(seed)
        self.steps_per_round = int(steps_per_round)
        self.n_chains = int(n_chains)
        self._schedule = AdaptiveReheat(
            tau_base=tau, tau_hot=8.0 * tau if tau_hot is None else tau_hot,
            relax=0.9)
        self._detector = PageHinkley() if detector else None
        self._reheat_pending = False
        self._tables: dict[tuple, np.ndarray] = {}
        # device-resident control loop: table enumeration + scoring,
        # anneal and top-K selection on the device, only the (topk, ndim)
        # decision packet read back
        self.device_loop = bool(device_loop)
        self._dtables: dict[tuple, torch.Tensor] = {}
        self._round = 0
        if init is None:
            # cheapest deployment: smallest size, fewest replicas per tier
            init = (0,) * len(self._shape)
        if not self.space.contains(init):
            raise ValueError(f"init {tuple(init)} not in the space")
        self.incumbent: tuple[int, ...] = tuple(int(i) for i in init)

    # ------------------------------------------------------------------
    # tables
    # ------------------------------------------------------------------

    def _mix_key(self, rates: Mapping[str, float]) -> tuple:
        return tuple((c, round(float(rates.get(c, 0.0)), 9))
                     for c in self.spec.dag.class_names)

    #: Tables kept for the most recent distinct mixes.  A ramped/continuous
    #: mix schedule yields a fresh key every round; without eviction each
    #: one pins a full-space table forever, and old mixes never recur
    #: exactly.
    TABLE_CACHE = 8

    def _table_for(self, rates: Mapping[str, float]) -> np.ndarray:
        """Flat (size,) float64 host objective table for one request mix;
        cached for the last :attr:`TABLE_CACHE` distinct mixes (stalest
        evicted)."""
        key = self._mix_key(rates)
        if key in self._tables:
            self._tables[key] = self._tables.pop(key)   # refresh LRU order
        else:
            if self.objective_source is None:
                res = evaluate_sizing_batch(
                    self.spec, full_grid(self.space), rates,
                    device=self.device)
                self._count_measures(self.space.size())
                self._tables[key] = res["y"]
            else:
                def fn(decoded: dict[str, Any]) -> float:
                    self._count_measures(1)
                    return float(
                        self.spec.host_objective(decoded, rates)["y"])

                table = np.asarray(self.objective_source.table(
                    self.space, fn, valid_mask=self._enc.valid_mask),
                    np.float64)
                self._tables[key] = table.reshape(-1)
            while len(self._tables) > self.TABLE_CACHE:
                self._tables.pop(next(iter(self._tables)))
        return self._tables[key]

    def _dtable_for(self, rates: Mapping[str, float]) -> torch.Tensor:
        """Device flat (size,) float32 objective table for one mix — the
        on-device enumeration + scoring when tables come from the batched
        evaluator, a one-way host->device upload when an injected
        ``objective_source`` builds them; same LRU policy as
        :meth:`_table_for`."""
        key = self._mix_key(rates)
        if key in self._dtables:
            self._dtables[key] = self._dtables.pop(key)
        else:
            if self.objective_source is None:
                self._dtables[key] = sizing_table_device(
                    self.spec, rates, device=self.device)
                self._count_measures(self.space.size())
            else:
                self._dtables[key] = torch.as_tensor(
                    self._table_for(rates), dtype=torch.float32,
                    device=self.device)
            while len(self._dtables) > self.TABLE_CACHE:
                self._dtables.pop(next(iter(self._dtables)))
        return self._dtables[key]

    # ------------------------------------------------------------------
    # the control round
    # ------------------------------------------------------------------

    _telemetry_prefix = "sizing"

    def _stats_rounds(self) -> int:
        return self._round

    def round(self) -> SizingDecision:
        with span("sizing.round", cat="sizing"):
            d = self._round_impl()
        if metrics.get() is not None:
            t_r = float(d.n)
            metrics.record("sizing/y", d.y, t_r)
            metrics.record("sizing/cost_usd_hr", d.usd_per_hr, t_r)
            metrics.record("sizing/slo_attainment", d.slo_attainment, t_r)
            if d.reheated:
                metrics.inc("sizing/reheats")
        return d

    def _round_impl(self) -> SizingDecision:
        from .annealing import anneal_fleet, random_valid_states

        r = self._round
        rates = self._mix_at(r)
        dev = self.device

        n0 = r * self.steps_per_round
        reheated = False
        if self._reheat_pending:
            self._schedule.reheat(n0)
            self._reheat_pending = False
            reheated = True
        taus = self._schedule.tau_array(n0, self.steps_per_round)
        taus_d = torch.as_tensor(taus, dtype=torch.float32, device=dev) \
            .expand(self.n_chains, self.steps_per_round)
        gen = generator(self.seed, r, device=dev)
        nd = self._enc.ndim

        if self.device_loop:
            # device-resident phase: table -> anneal -> top-K without a
            # bulk host round-trip; only the (topk, ndim) decision packet
            # and the explored flag are read back, in one transfer
            with span("sizing.refit", cat="sizing"):
                table_d = self._dtable_for(rates)
            inits_d = random_valid_states(gen, self._enc, self.n_chains,
                                          device=dev)
            inits_d[0] = torch.as_tensor(self.incumbent, dtype=torch.int32,
                                         device=dev)
            with span("sizing.anneal", cat="sizing",
                      metric="sizing/anneal_s"):
                out = anneal_fleet(
                    gen, self._enc, table_d.reshape(self._shape),
                    self.steps_per_round, taus_d, inits=inits_d,
                    n_chains=self.n_chains, device=dev)
            sel, explored_d = sizing_select(
                self._shape, self.measure_topk, inits_d, out["states"],
                table_d, out["ys"], out["accepts"])
            packet = torch.cat([sel.reshape(-1),
                                explored_d.reshape(1).to(torch.int32)])
            packet = packet.tolist()
            explored = bool(packet[-1])
            cand_idx = [tuple(packet[i:i + nd])
                        for i in range(0, len(packet) - 1, nd)
                        if packet[i] >= 0]
            if provenance.get() is not None:
                # armed-only audit pulls (not on the steady-state path)
                inits = inits_d.cpu().numpy()
                table = table_d.cpu().numpy().astype(np.float64)
                ys = out["ys"].cpu().numpy()
                accepts = out["accepts"].cpu().numpy()
                y0 = table[np.ravel_multi_index(tuple(inits.T),
                                                self._shape)]
                flat = np.ravel_multi_index(
                    tuple(np.concatenate(
                        [inits[:, None, :], out["states"].cpu().numpy()],
                        axis=1).reshape(-1, nd).T),
                    self._shape)
        else:
            with span("sizing.refit", cat="sizing"):
                table = self._table_for(rates)
            inits = random_valid_states(gen, self._enc, self.n_chains,
                                        device=dev).cpu().numpy()
            inits[0] = np.asarray(self.incumbent, np.int32)
            with span("sizing.anneal", cat="sizing",
                      metric="sizing/anneal_s"):
                out = anneal_fleet(
                    gen, self._enc,
                    table.reshape(self._shape).astype(np.float32),
                    self.steps_per_round, taus_d, inits=inits,
                    n_chains=self.n_chains, device=dev)

            visited = np.concatenate(
                [inits[:, None, :], out["states"].cpu().numpy()],
                axis=1).reshape(-1, nd)
            flat = np.ravel_multi_index(tuple(visited.T), self._shape)

            # exploration: any chain accepted an uphill move this round
            ys = out["ys"].cpu().numpy()                 # (n_chains, steps)
            accepts = out["accepts"].cpu().numpy()
            y0 = table[np.ravel_multi_index(tuple(inits.T), self._shape)]
            explored = bool(self.explored_flags(ys, accepts, y0).any())

            # the fleet's visited states are the engine-enumerated
            # lookahead — measure the ``measure_topk`` most promising (by
            # table estimate) on the numpy host model and commit to the
            # *measured* argmin.  topk=1 re-measures the single best
            # visited sizing.
            order = np.argsort(table[flat], kind="stable")
            cand: list[int] = []
            seen: set[int] = set()
            for j in order:
                f = int(flat[j])
                if f not in seen:
                    seen.add(f)
                    cand.append(f)
                if len(cand) == self.measure_topk:
                    break
            cand_idx = [tuple(int(v)
                              for v in np.unravel_index(f, self._shape))
                        for f in cand]
        with span("sizing.measure", cat="sizing"):
            results = self._measure_candidates(cand_idx, rates)
        self._count_measures(len(results))
        if self.recycle_store is not None:
            for st, rr in zip(cand_idx, results):
                self.recycle_store.add(st, float(rr["y"]), float(r))
        k_best = int(np.argmin([rr["y"] for rr in results]))
        prev = self.incumbent
        self.incumbent = cand_idx[k_best]
        decoded = self.space.decode(self.incumbent)
        res = results[k_best]
        y = float(res["y"])
        if self._detector is not None and self._detector.update(y):
            self._reheat_pending = True

        m = Measurement(
            exec_time_s=float(res["penalized_latency"]),
            cost_usd=float(res["cost"]),
            slo_violated=bool(res["slo_attainment"] < 1.0))
        counts = self.evaluation_counts()
        d = SizingDecision(
            n=r, job="mix", config=ClusterConfig(
                self.family, n_workers=self.spec.total_cores(decoded)),
            measurement=m, y=y, accepted=bool(self.incumbent != prev),
            explored=explored, tau=float(taus[-1]), reheated=reheated,
            sizing=decoded, mix=dict(rates),
            usd_per_hr=float(res["cost"]),
            slo_attainment=float(res["slo_attainment"]),
            true_measures=counts["true_measures"],
            surrogate_queries=counts["surrogate_queries"],
        )
        self.decisions.append(d)
        if provenance.get() is not None:
            self._record_round_provenance(
                r, d, res, results, cand_idx, k_best, prev, rates,
                ys, accepts, y0, taus, flat)
        self._round += 1
        note_round("SizingController", self)
        return d

    def _record_round_provenance(self, r, d, res, results, cand_idx,
                                 k_best, prev, rates, ys, accepts, y0,
                                 taus, flat) -> None:
        """One DecisionRecord per sizing round.  Armed-only; every input
        is something the round already computed.

        Exactness: the committed ``y`` came from ``host_objective`` as
        ``pen_lat + lambda_cost * cost``; ``exact_split`` replays those
        two IEEE ops on the same raw values, so it sums bit-for-bit.
        The named ladder splits ``pen_lat`` into its latency and SLO
        hinge shares (float64 round-off, inside the float32 bar)."""
        from .annealing import chain_accept_stats

        spec = self.spec
        pen_lat = res["penalized_latency"]
        cost_term = spec.lambda_cost * res["cost"]
        rates_arr = spec.dag.rates_array(rates)
        total = rates_arr.sum()
        shares = (rates_arr / total if total > 0
                  else np.zeros_like(rates_arr))
        lat_term = float((shares * np.asarray(res["latency"])).sum())
        terms = (("latency", lat_term),
                 ("slo_hinge", float(pen_lat) - lat_term),
                 ("cost", float(cost_term)))
        rejected, rejected_y = None, float("nan")
        others = [(j, float(results[j]["y"]))
                  for j in range(len(results)) if j != k_best]
        if others:
            j = min(others, key=lambda jv: jv[1])[0]
            rejected, rejected_y = cand_idx[j], float(results[j]["y"])
        # the chain that visited the committed state (chain 0 — the
        # incumbent chain — when the winner came from the measured topk
        # of another chain's trajectory)
        flat2 = flat.reshape(self.n_chains, -1)
        f0 = int(np.ravel_multi_index(tuple(np.asarray(self.incumbent)),
                                      self._shape))
        hasf = (flat2 == f0).any(axis=1)
        c = int(np.argmax(hasf)) if hasf.any() else 0
        tau_at, p_at = chain_accept_stats(
            ys, accepts, y0,
            np.broadcast_to(np.asarray(taus, np.float64),
                            (self.n_chains, self.steps_per_round)))
        provenance.record(provenance.DecisionRecord(
            controller="sizing", round=r, tenant="",
            action="accept" if d.accepted else "hold",
            state=tuple(self.incumbent), y=d.y, terms=terms,
            exact_split=(("penalized_latency", float(pen_lat)),
                         ("cost", float(cost_term))),
            tau=float(tau_at[c]), accept_prob=float(p_at[c]),
            rejected=rejected, rejected_y=rejected_y,
            counterfactual=(rejected_y - d.y if rejected is not None
                            else float("nan")),
            reheated=d.reheated))

    def run(self, n_rounds: int) -> list[SizingDecision]:
        return [self.round() for _ in range(n_rounds)]

    def run(self, n_rounds: int) -> list[SizingDecision]:
        return [self.round() for _ in range(n_rounds)]

    def load_state(self, state: Mapping[str, Any]) -> None:
        """Continue from another controller's state (this package's or
        the reference's): see :func:`repro_torch.interop.load_sizing_state`
        for the keys."""
        from ..interop import load_sizing_state

        load_sizing_state(self, state)

    def _measure_candidates(
        self, states: Sequence[tuple[int, ...]],
        rates: Mapping[str, float],
    ) -> "list[dict[str, Any]]":
        """Ground-truth host-model measurement of K candidate sizings, in
        candidate order.  With ``eval_workers`` > 1 the measurements run on
        the evaluation runtime's bounded pool (the host model is pure
        numpy and thread-safe); otherwise a plain ordered loop — the two
        paths return identical results."""
        if self.eval_workers and self.eval_workers > 1 and len(states) > 1:
            from .evalpipe import EvalRequest, EvalResult, map_pool

            def measure(req: EvalRequest) -> EvalResult:
                res = self.spec.host_objective(req.decoded, rates)
                return EvalResult(y=float(res["y"]), extra=res)

            results = map_pool(
                measure,
                [EvalRequest(state=tuple(s), decoded=self.space.decode(s),
                             job="mix", n=self._round, kind="round")
                 for s in states],
                max_workers=self.eval_workers)
            return [dict(r.extra) for r in results]
        return [self.spec.host_objective(self.space.decode(s), rates)
                for s in states]

    def force_reheat(self) -> None:
        self._reheat_pending = True

    def best_sizing(self) -> tuple[dict[str, Any], float]:
        """Current incumbent (decoded) and its ground-truth objective at
        the mix of the last COMPLETED round — the mix the incumbent was
        actually annealed for (``_round`` already points at the next
        round, whose mix the controller has not seen yet)."""
        decoded = self.space.decode(self.incumbent)
        res = self.spec.host_objective(
            decoded, self._mix_at(max(self._round - 1, 0)))
        return decoded, float(res["y"])


# ---------------------------------------------------------------------------
# Fleet integration: microservice tenants on a shared catalog.
# ---------------------------------------------------------------------------


class MicroserviceEvaluator(Evaluator):
    """Fleet-facing evaluator: tenant "job types" are named request-mix
    regimes over one :class:`SizingSpace`.

    ``measure_decoded`` scores the tenant's decoded per-tier sizing on
    the DAG ground truth — ``exec_time_s`` is the deadline-penalized
    mix-weighted latency, ``cost_usd`` the deployment $/hr — so the
    fleet's base objective ``t + lambda c`` reproduces the sizing
    objective exactly.  The plain :meth:`measure` contract cannot work
    here (a ClusterConfig's total cores do not determine per-tier
    sizings), so it refuses loudly.
    """

    def __init__(self, spec: SizingSpace,
                 mixes: Mapping[str, Mapping[str, float]]):
        if not mixes:
            raise ValueError("at least one named request mix required")
        self.spec = spec
        self.mixes = {k: dict(v) for k, v in mixes.items()}

    def measure(self, config: ClusterConfig, job: str, n: int) -> Measurement:
        raise TypeError(
            "MicroserviceEvaluator needs the decoded per-tier sizing; "
            "route through measure_decoded (FleetController does)")

    def measure_decoded(
        self, decoded: Mapping[str, Any], job: str, n: int,
        config: ClusterConfig | None = None,
    ) -> Measurement:
        res = self.spec.host_objective(decoded, self.mixes[job])
        return Measurement(
            exec_time_s=float(res["penalized_latency"]),
            cost_usd=float(res["cost"]),
            slo_violated=bool(res["slo_attainment"] < 1.0))


def microservice_config_fn(
    spec: SizingSpace, family: str
) -> Callable[[Mapping[str, Any]], ClusterConfig]:
    """The ``FleetController(config_fn=...)`` hook for microservice
    tenants: a decoded sizing becomes a ClusterConfig whose
    ``total_cores`` is the deployment's core footprint on ``family`` —
    which is all the fleet's capacity ledger and coupling-penalty rows
    need to arbitrate containers against VM tenants."""

    def to_config(decoded: Mapping[str, Any]) -> ClusterConfig:
        return ClusterConfig(
            instance_type=family,
            n_workers=spec.total_cores(decoded),
            cores_per_worker=1)

    return to_config
