"""The online procurement controller — the paper's system, end to end.

Consumes a job stream; for each arriving job (or batch of jobs of the
blended workload) it asks the annealing chain for the configuration to run
under, executes/evaluates, and feeds the observed objective back.  On
detected workload change it re-heats the temperature (paper secs. 1, 4.3).

This is the component a cluster operator would deploy: it owns the catalog,
the objective (with SLO and migration accounting), the chain, the drift
detector, and the tabu memory, and exposes a decision log for audit.  The
online loop is numpy (a copy of the reference's); the offline planner
(:func:`offline_plan`) walks its batched chains on ``device`` through
:func:`repro_torch.core.annealing.anneal_fleet`.
"""

from __future__ import annotations

import dataclasses
import threading
import warnings
from typing import Any, Callable, Mapping, Sequence

import numpy as np
import torch

from ..device import generator, resolve_device
from .annealing import Annealer, Step, anneal_fleet
from .change_detect import PageHinkley
from .costmodel import Evaluator
from .evalpipe import (
    EvalDispatcher,
    EvalRequest,
    EvalResult,
    SpeculativePipeline,
    measure_requests,
)
from .instrumentation import note_round, race_access
from .landscape import tabulate
from .neighborhood import Neighborhood, StepNeighborhood
from .objective import Measurement, Objective
from .pricing import ServiceCatalog
from .schedules import AdaptiveReheat, Schedule
from .state import ClusterConfig, ConfigSpace, cluster_config_from
from .surrogate import MeasurementStore, ObjectiveSource, SurrogateSource
from .tabu import TabuMemory
from ..telemetry import provenance
from ..telemetry import registry as metrics
from ..telemetry import span


@dataclasses.dataclass(frozen=True)
class Decision:
    """One controller decision: which config ran job n, and why.

    ``true_measures`` / ``surrogate_queries`` are the controller's
    *cumulative* evaluation counts at log time (real evaluator runs —
    table building included — vs surrogate-model queries), so any log
    slice reports its measurement savings by differencing the endpoints.
    They are keyword-only so subclasses can keep required positional
    fields.
    """

    n: int
    job: str
    config: ClusterConfig
    measurement: Measurement
    y: float
    accepted: bool
    explored: bool
    tau: float
    reheated: bool
    true_measures: int = dataclasses.field(default=0, kw_only=True)
    surrogate_queries: int = dataclasses.field(default=0, kw_only=True)


class ControllerMixin:
    """Decision-log, measurement-dispatch and detector/reheat plumbing
    shared by every controller policy (single-tenant
    :class:`ProcurementController` here, multi-tenant fleet, container
    :class:`repro_torch.core.sizing.SizingController`).

    All controllers log :class:`Decision`-compatible records into
    ``self.decisions``, so audit tooling (``spend()``, CSV export of
    decision fields) works unchanged across them — and all route their
    real measurements through the evaluation runtime
    (:mod:`repro_torch.core.evalpipe`), so counting is exactly-once even
    when measurements run concurrently on worker threads.
    """

    decisions: list[Decision]

    def _init_decision_log(self) -> None:
        self.decisions = []
        self._n_direct_measures = 0
        self._count_lock = threading.Lock()

    def _count_measures(self, k: int = 1) -> None:
        """Count ``k`` real evaluator runs, thread-safely: the evaluation
        runtime may land measurements from a worker pool, and a lost
        update here would silently inflate the claimed savings."""
        with self._count_lock:
            race_access("measure_count", self)
            self._n_direct_measures += k

    def _measure_batch(
        self,
        items: Sequence[tuple],
        eval_workers: int | None = None,
    ) -> list[Measurement]:
        """The shared measurement phase: measure ``(decoded, job, n[,
        config])`` items through
        :func:`repro_torch.core.evalpipe.measure_requests` — a bounded
        worker pool for wall-clock evaluators, ONE vectorized
        ``measure_many`` call otherwise — and count each exactly once."""
        out = measure_requests(self.evaluator, items, eval_workers)
        self._count_measures(len(out))
        return out

    def evaluation_counts(self) -> dict[str, int]:
        """Cumulative (true measures, surrogate queries).  Prefer
        :meth:`stats`, which embeds these in the unified contract.

        ``true_measures`` counts ``evaluator.measure`` runs — per-job
        measurements AND the ones made while building objective tables
        (the table-building closures count themselves, so a blend of k
        job types tallies k per tabulated state).  ``surrogate_queries``
        counts the objective source's model evaluations."""
        src = getattr(self, "objective_source", None)
        # read under the same lock the workers write under: the counter is
        # landed from worker threads and a torn read here would leak into
        # the decision log
        with self._count_lock:
            race_access("measure_count", self, write=False)
            n = self._n_direct_measures
        return {
            "true_measures": n,
            "surrogate_queries":
                src.surrogate_queries if src is not None else 0,
        }

    @staticmethod
    def normalize_blend(
        blend: Mapping[str, float],
    ) -> tuple[list[str], np.ndarray]:
        """Blend mapping -> (names, weights summing to one)."""
        names = list(blend)
        if not names:
            raise ValueError("blend must name at least one job type")
        weights = np.asarray([blend[k] for k in names], np.float64)
        if weights.sum() <= 0 or (weights < 0).any():
            raise ValueError(f"blend weights must be >= 0, sum > 0: {blend}")
        return names, weights / weights.sum()

    @staticmethod
    def explored_flags(
        ys: np.ndarray, accepts: np.ndarray, y0: np.ndarray
    ) -> np.ndarray:
        """Per-chain "accepted an uphill move" flags from one compiled
        round's traces — the single-tenant ``Step.explored`` semantics
        reconstructed from :func:`repro_torch.core.annealing.anneal_fleet`
        outputs.

        ``ys``/``accepts`` are (C, steps) measured objectives and
        acceptance flags; ``y0`` (C,) is each chain's step-0 incumbent
        objective.  The incumbent's objective before step k is the last
        accepted measurement before k (y0 if none): forward-fill the
        accepted indices and gather; a step both accepted and above that
        incumbent explored.
        """
        C, steps = ys.shape
        kk = np.arange(steps)[None, :]
        last_acc = np.maximum.accumulate(np.where(accepts, kk, -1), axis=1)
        prev_acc = np.concatenate(
            [np.full((C, 1), -1), last_acc[:, :-1]], axis=1)
        inc_before = np.where(
            prev_acc >= 0,
            np.take_along_axis(ys, np.maximum(prev_acc, 0), axis=1),
            np.asarray(y0, np.float64).reshape(-1, 1))
        return (accepts & (ys > inc_before)).any(axis=1)

    @staticmethod
    def _detect_reheat(
        detector: PageHinkley | None,
        y: float,
        reheat: Callable[[], None],
    ) -> bool:
        """Feed one objective observation to the drift detector; fire the
        reheat callback on a signal.  Returns True iff a reheat fired."""
        if detector is None or not detector.update(float(y)):
            return False
        reheat()
        return True

    def spend(self) -> float:
        """Total dollars across logged decisions (jobs + migrations)."""
        return sum(
            d.measurement.cost_usd + d.measurement.migration_usd
            for d in self.decisions)

    # -- the unified stats contract ------------------------------------

    _telemetry_prefix: "str | None" = None

    def _stats_rounds(self) -> int:
        """Control rounds completed; defaults to the decision count
        (one decision per round for the single-tenant controller)."""
        return len(self.decisions)

    def _stats_extra(self) -> dict[str, Any]:
        """Controller-specific additions merged into :meth:`stats`."""
        return {}

    def _pipeline_stats(self) -> "dict[str, Any] | None":
        """Speculation telemetry (resolved / mispredictions / flushes /
        recycled / hit rate); None when running inline or when the
        controller has no speculative pipeline at all.  The
        :meth:`stats` contract embeds this under ``"pipeline"``."""
        pipe = getattr(self, "_pipeline", None)
        if pipe is None:
            return None
        s = pipe.stats
        return {**dataclasses.asdict(s), "hit_rate": s.hit_rate()}

    def pipeline_stats(self) -> "dict[str, Any] | None":
        """Deprecated: read ``stats()["pipeline"]`` instead.  Routed
        through :meth:`stats` so the unified contract is the single
        source of truth; emits one :class:`DeprecationWarning`."""
        warnings.warn(
            "pipeline_stats() is deprecated; read stats()['pipeline']",
            DeprecationWarning, stacklevel=2)
        return self.stats()["pipeline"]

    def stats(self) -> dict[str, Any]:
        """One stats dict every controller answers — the contract that
        supersedes the ad-hoc ``pipeline_stats()`` /
        ``evaluation_counts()`` / ``summary()`` trio (each still works,
        and each is embedded here).

        Keys: ``controller`` (class name), ``rounds``, the
        :meth:`evaluation_counts` counters, ``pipeline``
        (:meth:`pipeline_stats`), any controller-specific extras, and —
        when a telemetry sink is attached — ``metrics``, the registry
        snapshot filtered to this controller's namespace."""
        out: dict[str, Any] = {
            "controller": type(self).__name__,
            "rounds": self._stats_rounds(),
        }
        out.update(self.evaluation_counts())
        out["pipeline"] = self._pipeline_stats()
        out.update(self._stats_extra())
        reg = metrics.get()
        if reg is not None and self._telemetry_prefix:
            out["metrics"] = reg.snapshot(prefix=self._telemetry_prefix)
        return out


def _same_device(a: torch.device, b: torch.device) -> bool:
    """True when ``a`` and ``b`` name one device (no index: the current
    one of its type)."""
    return a.type == b.type and (a.index is None or b.index is None
                                 or a.index == b.index)


@dataclasses.dataclass
class ProcurementController(ControllerMixin):
    """Online annealing-based IaaS/TPU procurement.

    ``blend`` gives the workload composition: each arriving "job" is a draw
    from the blend (or, in `evaluate_blend=True` mode, every job type is
    evaluated and combined with the alpha weights as in paper sec. 3).

    ``lookahead`` > 1 (or ``use_pipeline=True``) routes submits through the
    speculative evaluation pipeline
    (:class:`repro_torch.core.evalpipe.SpeculativePipeline`): the chain
    speculates ``lookahead`` transitions ahead, their measurements run
    concurrently (``eval_workers`` threads for wall-clock evaluators), and
    mis-speculated measurements are recycled into ``recycle_store``.  The
    realized decision trace is identical to the inline loop under the same
    seed (see the pipeline docs; tabu memories only guarantee this at
    ``lookahead=1``).  Call :meth:`close` when done to land in-flight
    speculation.

    ``device`` (default ``"cuda"``, which raises where there is no card)
    is where :meth:`plan` walks its chains, and where a
    :class:`repro_torch.core.surrogate.SurrogateSource` given as
    ``objective_source`` must interpolate (a source built for another
    device is refused).  The online loop itself runs on the host.
    """

    space: ConfigSpace
    catalog: ServiceCatalog
    evaluator: Evaluator
    objective: Objective = dataclasses.field(default_factory=Objective)
    blend: Mapping[str, float] = dataclasses.field(
        default_factory=lambda: {"job": 1.0})
    schedule: Schedule | float = 1.0
    neighborhood: Neighborhood | None = None
    tabu: TabuMemory | None = None
    detector: PageHinkley | None = None
    evaluate_blend: bool = False
    seed: int = 0
    init: tuple[int, ...] | None = None
    objective_source: "ObjectiveSource | None" = None
    lookahead: int = 1
    eval_workers: int | None = None
    use_pipeline: bool | None = None
    recycle_store: "MeasurementStore | None" = None
    #: hedged speculation: when a predicted accept/reject is within this
    #: margin of the drawn uniform, the pipeline also dispatches the
    #: other branch's next measurement (see SpeculativePipeline docs).
    #: 0.0 disables hedging (the historical behavior).
    hedge_margin: float = 0.0
    #: idle-worker probe prefetch budget (0 disables)
    prefetch_probes: int = 0
    device: "str | torch.device" = "cuda"

    def __post_init__(self) -> None:
        self.device = resolve_device(self.device)
        src = self.objective_source
        if isinstance(src, SurrogateSource) and not _same_device(
                torch.device(src.device), self.device):
            raise ValueError(
                f"objective_source interpolates on {src.device} but the "
                f"controller plans on {self.device}; build the "
                f"SurrogateSource with device={str(self.device)!r}")
        self._rng = np.random.default_rng(self.seed)
        nbhd = self.neighborhood or StepNeighborhood(self.space)
        self._prev_cfg: ClusterConfig | None = None
        self._last_measures: list[Measurement] = []
        self._init_decision_log()
        self.annealer = Annealer(
            self.space, nbhd, self._evaluate, schedule=self.schedule,
            seed=self._rng, tabu=self.tabu, init=self.init,
        )
        pipelined = (self.use_pipeline if self.use_pipeline is not None
                     else self.lookahead > 1 or (self.eval_workers or 0) > 1)
        self._pipeline: SpeculativePipeline | None = None
        if pipelined:
            wall = getattr(self.evaluator, "wall_clock", False)
            workers = self.eval_workers
            if workers is None:
                # headroom beyond the lookahead: after a misprediction
                # flush, already-running stale measurements keep their
                # workers until they land — the re-speculated head must
                # still find a free slot or every flush costs two job
                # latencies instead of one
                workers = 2 * self.lookahead if wall else 1
            dispatcher = EvalDispatcher(
                self._measure_request,
                mode="pool" if (wall or workers > 1) else "batched",
                max_workers=max(int(workers), 1))
            # migration billing is path-dependent (_build_request advances
            # _prev_cfg along the speculative path); on_resolve/on_flush
            # keep it in lockstep with the *resolved* walk, so a flush
            # rewinds it exactly as it rewinds the RNG
            self._committed_prev_cfg: ClusterConfig | None = None
            self._pipeline = SpeculativePipeline(
                self.annealer, self._measure_request, self._build_request,
                lookahead=self.lookahead, dispatcher=dispatcher,
                store=self.recycle_store,
                on_resolve=self._commit_prev_cfg,
                on_flush=self._rewind_prev_cfg,
                hedge_margin=self.hedge_margin,
                prefetch_probes=self.prefetch_probes,
                build_hedge_request=self._build_hedge_request)
            # expose the pipeline's store (created internally when the
            # caller did not pass one): recycled speculative measurements
            # are a real, reusable measurement corpus
            self.recycle_store = self._pipeline.store

    def _blend_weights(self) -> tuple[list[str], np.ndarray]:
        return self.normalize_blend(self.blend)

    # -- objective evaluation: run job(s) under a decoded configuration --
    def _evaluate(self, decoded: dict[str, Any], n: int) -> float:
        cfg = cluster_config_from(decoded)
        mig_s, mig_usd = self.evaluator.migration(
            self._prev_cfg, cfg, self.catalog)
        names, weights = self._blend_weights()
        measures: list[Measurement] = []
        if self.evaluate_blend:
            # migration is folded into EVERY type's measurement: the
            # weights sum to one, so Y still bills it exactly once — and
            # the Objective's SLO hinge tests each type's
            # migration-inclusive time, same as the non-blended path
            y = 0.0
            for w, name in zip(weights, names):
                m = dataclasses.replace(
                    self.evaluator.measure(cfg, name, n),
                    migration_s=mig_s, migration_usd=mig_usd)
                self._count_measures(1)
                measures.append(m)
                y += w * self.objective(m)
        else:
            job = names[int(self._rng.choice(len(names), p=weights))]
            self._count_measures(1)
            m = Measurement(
                **{**dataclasses.asdict(self.evaluator.measure(cfg, job, n)),
                   "migration_s": mig_s, "migration_usd": mig_usd})
            measures.append(m)
            self._last_job = job
            y = self.objective(m)
        self._prev_cfg = cfg
        self._last_measures = measures
        return y

    # -- the pipeline seam: build at speculation time, measure anywhere --
    def _build_request(
        self, state: tuple[int, ...], n: int, kind: str
    ) -> EvalRequest:
        """Speculation-time request construction (main thread, chain RNG
        order): the blend draw and migration billing — the two
        path-dependent pieces of :meth:`_evaluate` — are resolved here, so
        :meth:`_measure_request` can run on any worker thread."""
        decoded = self.space.decode(state)
        cfg = cluster_config_from(decoded)
        mig_s, mig_usd = self.evaluator.migration(
            self._prev_cfg, cfg, self.catalog)
        names, weights = self._blend_weights()
        if self.evaluate_blend:
            job = next(iter(self.blend))
        else:
            job = names[int(self._rng.choice(len(names), p=weights))]
        self._prev_cfg = cfg
        return EvalRequest(
            state=tuple(int(i) for i in state), decoded=decoded, job=job,
            n=n, kind=kind,
            meta={"config": cfg, "mig_s": mig_s, "mig_usd": mig_usd,
                  "names": tuple(names), "weights": tuple(weights)})

    def _build_hedge_request(
        self, state: tuple[int, ...], n: int, kind: str,
        rng: np.random.Generator,
    ) -> EvalRequest:
        """Side-effect-free twin of :meth:`_build_request` for hedge and
        probe speculation: the blend-job draw comes from the pipeline's
        cloned ``rng`` (replicating the post-flush redraw bit for bit,
        since the clone sits at exactly the shared stream's position) and
        ``_prev_cfg`` is read, not advanced — the hedged branch may never
        be taken."""
        decoded = self.space.decode(state)
        cfg = cluster_config_from(decoded)
        mig_s, mig_usd = self.evaluator.migration(
            self._prev_cfg, cfg, self.catalog)
        names, weights = self._blend_weights()
        if self.evaluate_blend:
            job = next(iter(self.blend))
        else:
            job = names[int(rng.choice(len(names), p=weights))]
        return EvalRequest(
            state=tuple(int(i) for i in state), decoded=decoded, job=job,
            n=n, kind=kind,
            meta={"config": cfg, "mig_s": mig_s, "mig_usd": mig_usd,
                  "names": tuple(names), "weights": tuple(weights)})

    def _measure_request(self, req: EvalRequest) -> EvalResult:
        """Measure one speculated request (worker-thread safe: reads only
        the request; the measurement counter takes the mixin lock)."""
        cfg = req.meta["config"]
        mig_s, mig_usd = req.meta["mig_s"], req.meta["mig_usd"]
        measures: list[Measurement] = []
        if self.evaluate_blend:
            y = 0.0
            for w, name in zip(req.meta["weights"], req.meta["names"]):
                m = dataclasses.replace(
                    self.evaluator.measure(cfg, name, req.n),
                    migration_s=mig_s, migration_usd=mig_usd)
                measures.append(m)
                y += w * self.objective(m)
            self._count_measures(len(measures))
        else:
            m = Measurement(
                **{**dataclasses.asdict(
                    self.evaluator.measure(cfg, req.job, req.n)),
                   "migration_s": mig_s, "migration_usd": mig_usd})
            measures.append(m)
            self._count_measures(1)
            y = self.objective(m)
        return EvalResult(y=float(y), measurement=measures[0],
                          measurements=tuple(measures))

    def _commit_prev_cfg(self, req: EvalRequest) -> None:
        self._committed_prev_cfg = req.meta["config"]

    def _rewind_prev_cfg(self) -> None:
        self._prev_cfg = self._committed_prev_cfg

    def _reheat(self) -> None:
        self.annealer.reheat()
        if self._pipeline is not None:
            self._pipeline.flush()

    # -- public API --
    _telemetry_prefix = "procurement"

    def submit(self, job: str | None = None) -> Decision:
        """Process one arriving job; returns the decision record."""
        with span("procurement.submit", cat="procurement"):
            d = self._submit_impl(job)
        if metrics.get() is not None:
            metrics.record("procurement/y", d.y, float(d.n))
            metrics.record("procurement/cost_usd",
                           d.measurement.cost_usd, float(d.n))
            if d.reheated:
                metrics.inc("procurement/reheats")
        return d

    def _submit_impl(self, job: str | None) -> Decision:
        self._last_job = job or next(iter(self.blend))
        if self._pipeline is not None:
            resolved = self._pipeline.step()
            step = resolved.step
            if not self.evaluate_blend:
                self._last_job = resolved.request.job
            self._last_measures = list(resolved.result.measurements)
        else:
            step = self.annealer.step()
        reheated = self._detect_reheat(
            self.detector, step.y_proposed, self._reheat)
        m = self._last_measures[0] if self._last_measures else Measurement(0, 0)
        counts = self.evaluation_counts()
        d = Decision(
            n=step.n, job=self._last_job,
            config=cluster_config_from(self.space.decode(step.state)),
            measurement=m, y=step.y_current, accepted=step.accepted,
            explored=step.explored, tau=step.tau, reheated=reheated,
            true_measures=counts["true_measures"],
            surrogate_queries=counts["surrogate_queries"],
        )
        if provenance.get() is not None:
            self._record_decision_provenance(d, step, m)
        self.decisions.append(d)
        note_round("ProcurementController", self)
        return d

    def _record_decision_provenance(self, d: Decision, step: Step,
                                    m: Measurement) -> None:
        """One DecisionRecord per arriving job.  Armed-only; the dark
        submit path pays one module-global load.

        Exactness: an accepted step committed ``y_current == y_proposed``,
        which was computed either as ``objective(m)`` (mirrored op for op
        by :func:`provenance.objective_terms`) or, under
        ``evaluate_blend``, as ``0.0 + w_0*objective(m_0) + ...`` in
        blend order — the same left-to-right ladder
        :func:`provenance.ladder_sum` replays, so both tiers sum
        bit-for-bit.  A rejected step keeps the incumbent (trivial
        one-term split) and files the proposal as the rejected
        candidate with its counterfactual delta."""
        prev_y = getattr(self, "_prov_prev_y", None)
        y = float(step.y_current)
        if step.accepted:
            action = "accept"
            if self.evaluate_blend and self._last_measures:
                names, weights = self._blend_weights()
                terms = tuple(
                    ("blend/" + name, float(w) * self.objective(meas))
                    for name, w, meas in zip(names, weights,
                                             self._last_measures))
            else:
                terms = provenance.objective_terms(self.objective, m)
            rejected, rejected_y = None, float("nan")
        else:
            action = "reject"
            terms = (("incumbent_y", y),)
            rejected, rejected_y = step.proposed, float(step.y_proposed)
        dy = (float(step.y_proposed) - prev_y if prev_y is not None
              else float("nan"))
        p = (provenance.acceptance_probability(dy, float(step.tau))
             if prev_y is not None else float("nan"))
        provenance.record(provenance.DecisionRecord(
            controller="procurement", round=int(step.n), tenant="",
            action=action, state=step.state, y=y, terms=terms,
            exact_split=terms, tau=float(step.tau), accept_prob=p,
            rejected=rejected, rejected_y=rejected_y,
            counterfactual=(rejected_y - y if rejected is not None
                            else float("nan")),
            reheated=d.reheated))
        self._prov_prev_y = y

    def run(self, n_jobs: int) -> list[Decision]:
        return [self.submit() for _ in range(n_jobs)]

    def reweight(self, blend: Mapping[str, float]) -> None:
        """Change the workload blend mid-stream (paper sec. 4.3); the next
        evaluations see the new composition.  Detection-driven re-heat is
        automatic if a detector is attached; callers may also force one.
        Pending speculation was drawn from the old blend, so the pipeline
        flushes (recycling its in-flight measurements)."""
        self.blend = dict(blend)
        if self._pipeline is not None:
            self._pipeline.flush()

    def force_reheat(self) -> None:
        self._reheat()

    def close(self) -> None:
        """Land every in-flight speculative measurement (recording each
        exactly once) and shut the evaluation pipeline down.  No-op for
        inline (non-pipelined) controllers."""
        if self._pipeline is not None:
            self._pipeline.close()

    # pipeline_stats() is inherited from ControllerMixin (prefer the
    # unified stats() contract, which embeds it under "pipeline")

    # -- offline planning (batched sweep -> online warm start) --
    def plan(
        self,
        n_chains: int = 256,
        n_steps: int = 200,
        tau: float = 1.0,
        seed: int | None = None,
    ) -> tuple[ClusterConfig, float]:
        """Offline pass: tabulate the blended objective on the simulator,
        anneal a batched fleet over it on ``device``, and warm-start the
        ONLINE chain at the best configuration found (paper's offline mode
        as a planner; cf. AutoTune-style joint-space sweeps).

        The warm start's objective is deliberately left unmeasured
        (``annealer.y = None``): the first live job re-measures it on the
        real workload, so a simulator/real mismatch cannot pin the chain.
        Returns (planned config, its simulated objective).
        """
        best_idx, best_y = offline_plan(
            self.space, self._plan_objective,
            n_chains=n_chains, n_steps=n_steps, tau=tau,
            seed=self.seed if seed is None else seed,
            objective_source=self.objective_source, device=self.device)
        self.annealer.state = tuple(best_idx)
        self.annealer.y = None
        if self._pipeline is not None:   # speculation predates the warm start
            self._pipeline.flush()
        return cluster_config_from(self.space.decode(best_idx)), best_y

    def _plan_objective(self, decoded: dict[str, Any]) -> float:
        """Blend-weighted objective WITHOUT migration/stream side effects —
        a pure function of the configuration, suitable for tabulation."""
        cfg = cluster_config_from(decoded)
        names, weights = self._blend_weights()
        self._count_measures(len(names))
        return float(sum(
            w * self.objective(self.evaluator.measure(cfg, name, 0))
            for w, name in zip(weights, names)))

    # -- diagnostics --
    def best_config(self) -> tuple[ClusterConfig, float]:
        idx, y = self.annealer.best()
        return cluster_config_from(self.space.decode(idx)), y

    def exploration_rate(self) -> float:
        return self.annealer.exploration_rate()


def offline_plan(
    space: ConfigSpace,
    objective_fn: Callable[[dict[str, Any]], float],
    n_chains: int = 256,
    n_steps: int = 200,
    tau: float = 1.0,
    seed: int = 0,
    objective_source: ObjectiveSource | None = None,
    device: str | torch.device = "cuda",
) -> tuple[tuple[int, ...], float]:
    """Batched offline sweep: materialize ``objective_fn`` over the space
    and run an ``anneal_fleet`` (one walk-kernel launch on the card) from
    random valid starts, its generator seeded from ``seed``.

    ``objective_source`` decides how the table is built — ``None`` keeps
    the historical exhaustive :func:`tabulate` (one real evaluation per
    valid state); a :class:`repro_torch.core.surrogate.SurrogateSource`
    probes sparsely and interpolates, which is the difference between a
    simulator sweep and real cluster time when ``objective_fn`` executes
    jobs.

    Returns (best visited index vector, its tabulated objective).  Visited
    states are always valid (invalid proposals are rejection-masked), so
    the argmin over visited table entries needs no re-filtering.
    """
    dev = resolve_device(device)
    enc = space.encoded()
    if objective_source is None:
        table = tabulate(space, objective_fn, valid_mask=enc.valid_mask)
    else:
        table = np.asarray(objective_source.table(
            space, objective_fn, valid_mask=enc.valid_mask), np.float64)
    out = anneal_fleet(generator(seed, device=dev), enc, table, n_steps,
                       float(tau), n_chains=n_chains, device=dev)
    # include step-0 states: a chain that STARTS at the best state it ever
    # sees never records it in the walk's outputs
    states = torch.cat([out["inits"][:, None, :], out["states"]], dim=1) \
        .cpu().numpy().reshape(-1, enc.ndim)
    visited_y = table[tuple(states.T)]
    k = int(np.argmin(visited_y))
    return tuple(int(v) for v in states[k]), float(visited_y[k])


def default_adaptive_schedule(tau: float = 1.0) -> AdaptiveReheat:
    return AdaptiveReheat(tau_base=tau, tau_hot=8.0 * tau, relax=0.9)


def make_ec2_space(
    catalog: ServiceCatalog,
    core_counts: Sequence[int] = tuple(range(4, 244, 8)),
) -> ConfigSpace:
    """The paper's EC2 space: (instance family ordered by price, #cores).

    cores are modeled as (n_workers x cores_per_worker) with a fixed
    40-core node size in the paper's CloudLab setup; we expose total cores
    directly and keep nodes implicit, matching Figs. 7-10's axes.
    """
    from .state import Dimension

    return ConfigSpace((
        Dimension("instance_type", tuple(catalog.ordered_by_price())),
        Dimension("n_workers", tuple(core_counts)),
    ))


def make_tpu_space(
    catalog: ServiceCatalog,
    chip_counts: Sequence[int] = (8, 16, 32, 64, 128, 256, 512),
    allow_tp: Sequence[int] = (1, 2, 4, 8, 16),
    microbatches: Sequence[int] = (1, 2, 4, 8),
    remats: Sequence[str] = ("none", "block", "full"),
    compressions: Sequence[str] = ("none", "int8"),
) -> ConfigSpace:
    """TPU procurement space (hardware adaptation; paper sec. 5 vector state).

    Validity: tp must divide the chip count; dp = chips / tp is implied.
    """
    from .state import Dimension

    def valid(cfg: Mapping[str, Any]) -> bool:
        return cfg["n_workers"] % cfg["tp_degree"] == 0

    return ConfigSpace(
        (
            Dimension("instance_type",
                      tuple(n for n in catalog.names() if n.startswith("v5"))),
            Dimension("n_workers", tuple(chip_counts)),
            Dimension("tp_degree", tuple(allow_tp)),
            Dimension("microbatches", tuple(microbatches)),
            # no meaningful order: the compiled engine resamples these
            Dimension("remat", tuple(remats), kind="categorical"),
            Dimension("compression", tuple(compressions), kind="categorical"),
        ),
        is_valid=valid,
    )
