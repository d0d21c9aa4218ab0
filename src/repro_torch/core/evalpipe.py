"""The speculative evaluation runtime: one async measure→decide→reheat
pipeline under every controller.

The paper evaluates exactly one job per annealing transition, so the online
controller is serialized on measurement latency — transition ``n+1`` cannot
be proposed until job ``n``'s measurement lands.  AutoTune (Chang et al.)
wins by *batching* candidate evaluations; "Lifting the Fog of
Uncertainties" (Zhang et al.) argues an online orchestrator must keep
deciding while measurements are still in flight.  This module is that
refactor: evaluation becomes a first-class, asynchronous, batched subsystem
instead of an inline call buried in four controllers.

Three layers share it:

* :class:`EvalDispatcher` — bounded concurrent measurement dispatch.  Two
  modes, chosen by the evaluator's
  :attr:`repro_torch.core.costmodel.Evaluator.wall_clock` flag: a
  **worker pool** for evaluators that really execute jobs
  (``MeasuredEvaluator``-style, each call costs wall-clock time), and
  **one vectorized batched call** (:meth:`Evaluator.measure_many` or a
  caller-supplied batch function) for simulated/tabulated evaluators.

* :class:`SpeculativePipeline` — the online
  :class:`repro_torch.core.annealing.Annealer` run *ahead* of its
  measurements.  It speculates the chain ``lookahead`` transitions
  forward (proposals, acceptance uniforms and predicted accept/reject
  outcomes on a surrogate estimate of the objective), dispatches every
  speculated measurement concurrently, then resolves acceptance in
  transition order against whichever measurement actually lands.  A mispredicted accept flushes the speculation and — the
  key invariant — **rewinds the chain RNG to the last resolved
  transition**, so the realized proposal/accept trace of a pipelined run is
  *identical* to the serial loop's under the same seed, at any lookahead
  (tabu memories, whose filter reads lag speculation, are the one
  exception; they match at ``lookahead=1``).  Every mis-speculated
  measurement was still a real evaluator run: it is recorded exactly once
  (``Annealer.record_evaluation``) and recycled into the surrogate
  :class:`repro_torch.core.surrogate.MeasurementStore` instead of
  discarded, so speculation *feeds* the predictor that steers it.

* :class:`StorePredictor` — the default surrogate: numpy inverse-distance
  interpolation over the recycling store (exact at measured states, an
  uncertainty channel from nearest-measurement distance).  Uncertainty
  also sets dispatch *priority*: when workers are scarcer than pending
  speculations, the most uncertain ones are measured first — they are the
  ones the predictor (and therefore the speculation hit-rate) learns the
  most from.

The table-driven controllers (fleet, sizing, surrogate annealer) already
batch their proposal lookahead through the batched engines
(``anneal_fleet`` / ``evaluate_sizing_batch``); they plug into this module
through :func:`measure_requests` — their per-round ground-truth
measurements go through the same pool/batched dispatch seam.
"""

from __future__ import annotations

import collections
import copy
import dataclasses
import threading
import time
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Any, Callable, Mapping, Sequence

import numpy as np

from .annealing import Annealer, Step, acceptance_probability
from .costmodel import Evaluator
from .instrumentation import race_access
from .objective import Measurement
from .state import ConfigSpace
from .surrogate import MeasurementStore, SpaceEncoding
from ..telemetry import registry as metrics


# ---------------------------------------------------------------------------
# Requests and results.
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class EvalRequest:
    """One measurement to take: encoded state, its decoded configuration,
    the job to run and the transition index.  ``kind`` tags why it was
    dispatched — ``"proposal"`` (a speculated transition), ``"refresh"``
    (incumbent re-measurement after a reheat), ``"probe"`` (surrogate
    acquisition) or ``"round"`` (a controller's per-round ground-truth
    measurement).  ``meta`` carries controller-private payload (migration
    terms, blend weights) from build time (main thread, RNG-ordered) to
    measure time (possibly a worker thread)."""

    state: tuple[int, ...]
    decoded: Mapping[str, Any]
    job: str
    n: int
    kind: str = "proposal"
    meta: Mapping[str, Any] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass(frozen=True)
class EvalResult:
    """A landed measurement: the scalar objective plus the evaluator's
    :class:`Measurement` record(s) for audit logs.  ``extra`` carries
    evaluator-specific payload (e.g. the sizing host model's latency /
    cost / SLO breakdown) for controllers whose ground truth is richer
    than a Measurement."""

    y: float
    measurement: Measurement | None = None
    measurements: tuple[Measurement, ...] = ()
    extra: Mapping[str, Any] = dataclasses.field(default_factory=dict)


class _Landed:
    """Future-compatible wrapper for batched-mode results (already
    resolved when handed out)."""

    __slots__ = ("_value",)

    def __init__(self, value: EvalResult):
        self._value = value

    def result(self, timeout: float | None = None) -> EvalResult:
        return self._value

    def done(self) -> bool:
        return True


# ---------------------------------------------------------------------------
# The dispatcher.
# ---------------------------------------------------------------------------


class EvalDispatcher:
    """Bounded concurrent measurement dispatch.

    ``mode="pool"``: requests run on a ``ThreadPoolExecutor`` of
    ``max_workers`` threads — the shape for wall-clock evaluators, where
    overlap buys real time and ``measure`` must tolerate concurrency.

    ``mode="batched"``: each :meth:`submit_many` is ONE synchronous
    vectorized call of ``measure_many`` (default: a loop over ``measure``
    in request order, the historical serial behavior), returning
    already-resolved futures — the shape for simulated/tabulated
    evaluators, where a Python thread pool would only add overhead.
    """

    def __init__(
        self,
        measure: Callable[[EvalRequest], EvalResult],
        *,
        mode: str = "pool",
        max_workers: int = 8,
        measure_many: Callable[[Sequence[EvalRequest]],
                               Sequence[EvalResult]] | None = None,
    ):
        if mode not in ("pool", "batched"):
            raise ValueError(f"unknown dispatcher mode {mode!r}")
        if mode == "pool" and max_workers < 1:
            raise ValueError("max_workers must be >= 1")
        self.mode = mode
        self.max_workers = int(max_workers)
        self._measure = measure
        self._measure_many = measure_many
        self._pool: ThreadPoolExecutor | None = None
        self._lock = threading.Lock()
        self.dispatched = 0
        self.landed = 0

    def _ensure_pool(self) -> ThreadPoolExecutor:
        if self._pool is None:
            self._pool = ThreadPoolExecutor(
                max_workers=self.max_workers,
                thread_name_prefix="evalpipe")
        return self._pool

    def _run_one(self, req: EvalRequest,
                 t_submit: float | None = None) -> EvalResult:
        # t_submit is only passed while a telemetry sink is attached, so
        # the dark path takes zero perf_counter() calls
        if t_submit is not None:
            t0 = time.perf_counter()
            metrics.observe("evalpipe/dispatch_wait_s", t0 - t_submit)
            res = self._measure(req)
            metrics.observe("evalpipe/measure_s", time.perf_counter() - t0)
        else:
            res = self._measure(req)
        with self._lock:
            race_access("landed", self)
            self.landed += 1
        metrics.inc("evalpipe/landed")
        return res

    def submit(self, req: EvalRequest) -> Future | _Landed:
        return self.submit_many([req])[0]

    def submit_many(
        self, reqs: Sequence[EvalRequest]
    ) -> list[Future | _Landed]:
        """Dispatch a batch; returns futures in request order."""
        if not reqs:
            return []
        # dispatch is main-thread-only by design (the pipeline speculates
        # serially); the race seam lets the lockset detector verify that
        race_access("dispatched", self)
        self.dispatched += len(reqs)
        metrics.inc("evalpipe/dispatched", len(reqs))
        telemetry_on = metrics.get() is not None
        if self.mode == "batched":
            t0 = time.perf_counter() if telemetry_on else None
            if self._measure_many is not None:
                results = list(self._measure_many(reqs))
            else:
                results = [self._measure(r) for r in reqs]
            if len(results) != len(reqs):
                raise ValueError(
                    f"measure_many returned {len(results)} results "
                    f"for {len(reqs)} requests")
            if t0 is not None:
                metrics.observe("evalpipe/measure_s",
                                time.perf_counter() - t0)
            race_access("landed", self)
            self.landed += len(results)
            metrics.inc("evalpipe/landed", len(results))
            return [_Landed(r) for r in results]
        pool = self._ensure_pool()
        t_submit = time.perf_counter() if telemetry_on else None
        return [pool.submit(self._run_one, r, t_submit) for r in reqs]

    def close(self) -> None:
        if self._pool is not None:
            self._pool.shutdown(wait=True)
            self._pool = None


def map_pool(
    measure: Callable[[EvalRequest], EvalResult],
    requests: Sequence[EvalRequest],
    max_workers: int,
) -> list[EvalResult]:
    """Run ``measure`` over ``requests`` on a bounded worker pool and
    return results in request order.  The pool lives for this call only —
    the shared shape of every controller's per-round concurrent
    measurement phase."""
    disp = EvalDispatcher(measure, mode="pool", max_workers=max_workers)
    try:
        return [f.result() for f in disp.submit_many(requests)]
    finally:
        disp.close()


def measure_requests(
    evaluator: Evaluator,
    items: Sequence[tuple],
    eval_workers: int | None = None,
) -> list[Measurement]:
    """Measure a batch of ``(decoded, job, n)`` — or ``(decoded, job, n,
    config)`` — items through the runtime's dispatch seam, preserving item
    order.

    Wall-clock evaluators fan out over a bounded worker pool
    (``eval_workers``, default 8); everything else is ONE
    :meth:`Evaluator.measure_many` call — whose default implementation is
    the historical serial loop, so non-overlapped callers see byte-
    identical behavior.  Items carrying an explicit fourth ``config``
    element (the fleet's ``config_fn`` seam) route through
    ``measure_decoded`` with that config in both modes.  This is the
    controllers' shared measurement phase: the fleet's per-tenant round
    measurements and the sizing controller's top-K ground-truth checks
    both land here."""
    if not items:
        return []
    norm = [(it + (None,))[:4] for it in items]
    workers = eval_workers
    if workers is None:
        workers = 8 if getattr(evaluator, "wall_clock", False) else 1
    if workers > 1 and len(norm) > 1:
        results = map_pool(
            lambda req: EvalResult(
                y=0.0,
                measurement=evaluator.measure_decoded(
                    req.decoded, req.job, req.n,
                    config=req.meta.get("config"))),
            [EvalRequest(state=(), decoded=d, job=job, n=n, kind="round",
                         meta={"config": cfg})
             for d, job, n, cfg in norm],
            max_workers=workers)
        return [r.measurement for r in results]
    if any(cfg is not None for _, _, _, cfg in norm):
        return [evaluator.measure_decoded(d, job, n, config=cfg)
                for d, job, n, cfg in norm]
    return list(evaluator.measure_many([(d, job, n) for d, job, n, _ in norm]))


# ---------------------------------------------------------------------------
# The default predictor: IDW over the recycling store.
# ---------------------------------------------------------------------------


class StorePredictor:
    """Objective estimates (and uncertainties) from the pipeline's
    recycling :class:`MeasurementStore`, by plain-numpy inverse-distance
    weighting over the mixed ordinal/categorical feature embedding
    (:class:`repro_torch.core.surrogate.SpaceEncoding`).

    Numpy on purpose: the store grows by one entry per landed measurement,
    and at pipeline scale (a handful of query states against a few
    thousand observations) a host pass is cheaper than a trip to the
    device :class:`repro_torch.core.surrogate.SurrogateModel`.  The
    interpolation itself is
    :func:`repro_torch.core.surrogate.host_interp` — the ONE shared
    encoding/metric path with the surrogate's fused device refit, so the
    predictor and the surrogate cannot drift apart: exact at measured
    states, recency-weighted when the store decays, uncertainty =
    distance to the nearest measurement scaled to objective units.

    Returns ``None`` while the store is empty — the pipeline then predicts
    *accept* (optimism under total ignorance, the chain's own behavior at
    high temperature)."""

    def __init__(
        self,
        space: ConfigSpace,
        store: MeasurementStore,
        idw_power: float = 2.0,
        eps: float = 1e-9,
    ):
        self.encoding = SpaceEncoding.from_space(space)
        self.store = store
        self.idw_power = float(idw_power)
        self.eps = float(eps)

    def __call__(
        self, states: Sequence[Sequence[int]], now: float | None = None
    ) -> tuple[np.ndarray, np.ndarray] | None:
        if len(self.store) == 0:
            return None
        from .surrogate import host_interp

        obs, ys, ts = self.store.arrays()
        rec = self.store.weights(float(ts.max()) if now is None else now)
        xm = self.encoding.features(obs)
        xq = self.encoding.features(np.asarray(states, np.int64))
        mean, dmin = host_interp(xq, xm, ys, rec, kind="idw",
                                 idw_power=self.idw_power, eps=self.eps)
        spread = float(ys.max() - ys.min())
        y_scale = spread if spread > 0 else max(1.0, abs(float(ys.mean())))
        return (mean.astype(np.float64),
                (y_scale * dmin).astype(np.float64))


# ---------------------------------------------------------------------------
# The speculative pipeline.
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class _Speculation:
    """One speculated transition: drawn, predicted and dispatched — not
    yet resolved."""

    n: int
    tau: float
    proposal: tuple[int, ...]
    u: float
    predicted_accept: bool
    request: EvalRequest
    rng_after: dict[str, Any]
    unc: float = 0.0
    refresh_request: EvalRequest | None = None
    future: Any = None
    refresh_future: Any = None


@dataclasses.dataclass(frozen=True)
class ResolvedStep:
    """One resolved pipeline transition: the chain's :class:`Step` plus
    the landed evaluation payloads the controller logs from."""

    step: Step
    result: EvalResult
    request: EvalRequest
    refresh_result: EvalResult | None = None
    refresh_request: EvalRequest | None = None


@dataclasses.dataclass
class PipelineStats:
    resolved: int = 0
    mispredictions: int = 0
    flushes: int = 0
    recycled: int = 0           # flushed measurements handed to recycling
    recycled_landed: int = 0    # of those: landed + recorded exactly once
    cancelled: int = 0          # of those: never started, cancelled instead
    hedged: int = 0             # both-branch speculations dispatched
    hedged_covered: int = 0     # mispredictions whose alternative-branch
    #                             measurement was already in flight (adopted)
    prefetched: int = 0         # idle-worker probe measurements dispatched

    def hit_rate(self) -> float:
        """Fraction of resolved transitions whose measurement was in
        flight when needed: correct predictions plus mispredictions the
        hedge covered (the alternative branch's next measurement was
        already dispatched, so the flush cost no stall)."""
        if self.resolved == 0:
            return 1.0
        return 1.0 - (self.mispredictions - self.hedged_covered) \
            / self.resolved


class SpeculativePipeline:
    """Run an online :class:`Annealer` ``lookahead`` transitions ahead of
    its measurements.

    ``build_request(state, n, kind) -> EvalRequest`` is called at
    *speculation* time, on the main thread, in the chain's serial RNG
    order (via ``Annealer.draw_transition``'s hook slot) — controllers
    that draw from the shared RNG while evaluating (blend draws) or read
    path-dependent state (migration billing) resolve those here.
    ``measure`` runs later, possibly on a worker thread, and must only
    read its request.

    Per :meth:`step`: top the speculation queue up to ``lookahead``
    (drawing proposals and acceptance uniforms from the chain's own RNG,
    predicting accept/reject on the ``predictor``'s estimates), dispatch
    new speculations (most uncertain first), then resolve the head —
    block on its measurement, commit the transition through
    ``Annealer.apply_transition``, and on a mispredicted acceptance flush
    the queue, rewinding the chain RNG to the resolved transition so the
    realized trace stays serial-identical.  Flushed measurements are
    recycled into ``store`` (and ``Annealer.record_evaluation``) when
    they land, each exactly once.

    ``on_resolve(request)`` / ``on_flush()`` let the controller keep
    path-dependent state it advanced inside ``build_request`` (e.g.
    migration billing's previous-config) in lockstep: ``on_resolve``
    fires right after a transition commits (before any flush),
    ``on_flush`` whenever pending speculation is discarded — the
    controller rewinds such state to its last resolved value there.

    **Hedged speculation** (``hedge_margin > 0``): when a transition's
    predicted acceptance is marginal — the surrogate acceptance
    probability lands within ``hedge_margin`` of the drawn uniform, so
    the predictor is effectively guessing — the pipeline also draws the
    *other* branch's next transition on a cloned RNG and dispatches its
    measurement.  If the prediction then misses, the post-flush
    re-speculation redraws the identical ``(n, proposal, u)`` (same RNG
    state, same frontier) and adopts the in-flight hedge future instead
    of re-dispatching, so the misprediction costs no measurement stall
    (``stats.hedged_covered``).  Decision parity is preserved by
    construction: hedges never touch the chain RNG, and adoption
    requires an exact ``(n, proposal, u)`` match — anything else is
    recycled like any mis-speculated measurement.  Hedge requests are
    built for a branch that may never be taken, so they must not leak
    side effects: either ``build_request`` is pure (no shared-RNG draws,
    no path-dependent state) or the controller supplies
    ``build_hedge_request(state, n, kind, rng)`` — a side-effect-free
    twin whose RNG consumption comes only from the passed clone,
    replicating the post-flush redraw bit for bit (the procurement
    controller's blend-job draw is the canonical case).

    **Probe prefetch** (``prefetch_probes > 0``): when the dispatcher's
    pool has idle workers, up to ``prefetch_probes`` surrogate probes of
    unmeasured states (drawn from a dedicated, chain-independent RNG)
    are kept in flight; landings feed the recycling store, warming the
    predictor that steers speculation.  Probe requests are built through
    the same side-effect-free seam as hedges.
    """

    def __init__(
        self,
        chain: Annealer,
        measure: Callable[[EvalRequest], EvalResult],
        build_request: Callable[[tuple[int, ...], int, str],
                                EvalRequest] | None = None,
        *,
        lookahead: int = 8,
        dispatcher: EvalDispatcher | None = None,
        max_workers: int | None = None,
        store: MeasurementStore | None = None,
        predictor: Callable[..., tuple[np.ndarray, np.ndarray] | None]
            | None = None,
        on_resolve: Callable[[EvalRequest], None] | None = None,
        on_flush: Callable[[], None] | None = None,
        hedge_margin: float = 0.0,
        prefetch_probes: int = 0,
        prefetch_seed: int = 0,
        build_hedge_request: Callable[..., EvalRequest] | None = None,
    ):
        if lookahead < 1:
            raise ValueError("lookahead must be >= 1")
        if hedge_margin < 0.0:
            raise ValueError("hedge_margin must be >= 0")
        if prefetch_probes < 0:
            raise ValueError("prefetch_probes must be >= 0")
        self.chain = chain
        self.lookahead = int(lookahead)
        self.hedge_margin = float(hedge_margin)
        self.prefetch_probes = int(prefetch_probes)
        # side-effect-free request builder for hedges and probes; pure
        # build_request callables can simply ignore the rng argument
        self.build_hedge_request = build_hedge_request or (
            lambda state, n, kind, rng: self.build_request(state, n, kind))
        self.build_request = build_request or self._default_request
        self.store = store if store is not None else MeasurementStore(
            len(chain.space.dimensions))
        self.predictor = (StorePredictor(chain.space, self.store)
                          if predictor is None else predictor)
        self._predictor_takes_now = self._accepts_now(self.predictor)
        self.on_resolve = on_resolve
        self.on_flush = on_flush
        if dispatcher is None:
            workers = max_workers if max_workers is not None else lookahead
            dispatcher = EvalDispatcher(
                measure, mode="pool", max_workers=max(workers, 1))
        self.dispatcher = dispatcher
        self.stats = PipelineStats()
        self._queue: collections.deque[_Speculation] = collections.deque()
        self._recycled: list[tuple[EvalRequest, Any]] = []
        # in-flight hedge measurements, keyed by the exact (n, proposal,
        # u) the post-flush re-speculation would redraw; values are
        # (request, future)
        self._hedges: dict[tuple, tuple[EvalRequest, Any]] = {}
        self._pending_hedges: list[tuple[tuple, EvalRequest]] = []
        # depth whose adoption would cover the last misprediction (set on
        # a mispredicted resolution, consumed by the very next refill)
        self._covered_n: int | None = None
        # in-flight idle-worker probes; dedicated RNG keeps the chain's
        # stream (and therefore decision parity) untouched
        self._probes: list[tuple[EvalRequest, Any]] = []
        self._prefetch_rng = np.random.default_rng(prefetch_seed)
        self._committed_rng = copy.deepcopy(
            chain.rng.bit_generator.state)
        self._sync_frontier()
        self._closed = False

    # -- frontier bookkeeping --

    def _sync_frontier(self) -> None:
        self._frontier_state = tuple(self.chain.state)
        self._frontier_y: float | None = self.chain.y
        self._frontier_needs_refresh = self.chain.y is None
        self._frontier_n = self.chain.n

    def _default_request(
        self, state: tuple[int, ...], n: int, kind: str
    ) -> EvalRequest:
        return EvalRequest(state=tuple(state),
                           decoded=self.chain.space.decode(state),
                           job="job", n=n, kind=kind)

    # -- speculation --

    @staticmethod
    def _accepts_now(predictor) -> bool:
        """Signature-inspect once at construction (a try/except around the
        call would misread a TypeError raised *inside* the predictor)."""
        import inspect

        try:
            params = inspect.signature(predictor).parameters.values()
        except (TypeError, ValueError):
            return False
        return any(p.name == "now" or p.kind is inspect.Parameter.VAR_KEYWORD
                   for p in params)

    def _predict(
        self, states: list[tuple[int, ...]], n: int
    ) -> tuple[np.ndarray, np.ndarray] | None:
        if self._predictor_takes_now:
            return self.predictor(states, now=float(n))
        return self.predictor(states)

    def _speculate_one(self) -> _Speculation:
        ch = self.chain
        n, tau = self._frontier_n, float(ch.schedule(self._frontier_n))
        needs_refresh = self._frontier_needs_refresh
        refresh_req = None
        if needs_refresh:
            # mirrors the serial step: the incumbent's objective is
            # re-measured (same RNG slot, before the proposal draw)
            refresh_req = self.build_request(
                self._frontier_state, n, "refresh")
        proposal, u, req = ch.draw_transition(
            lambda z: self.build_request(tuple(z), n, "proposal"),
            state=self._frontier_state)
        rng_after = copy.deepcopy(ch.rng.bit_generator.state)

        # predict the acceptance outcome on the surrogate estimates
        query = [proposal]
        if needs_refresh:
            query.append(self._frontier_state)
        pred = self._predict(query, n)
        if pred is None:
            y_hat_z, unc = None, 0.0
            y_hat_x = None if needs_refresh else self._frontier_y
        else:
            mean, uncs = pred
            y_hat_z, unc = float(mean[0]), float(uncs[0])
            y_hat_x = (float(mean[1]) if needs_refresh
                       else self._frontier_y)
        p_hat = None
        if y_hat_z is None or y_hat_x is None:
            predicted_accept = True      # optimism under total ignorance
        else:
            p_hat = acceptance_probability(y_hat_z - y_hat_x, tau)
            predicted_accept = u < p_hat

        spec = _Speculation(
            n=n, tau=tau, proposal=tuple(proposal), u=u,
            predicted_accept=predicted_accept, request=req,
            rng_after=rng_after, unc=unc, refresh_request=refresh_req)

        # marginal prediction: also draw the OTHER branch's next
        # transition (cloned RNG — the chain's stream stays untouched)
        # so a misprediction here finds its measurement already in flight
        if (self.hedge_margin > 0.0 and p_hat is not None
                and abs(p_hat - u) <= self.hedge_margin):
            alt_state = (self._frontier_state if predicted_accept
                         else tuple(proposal))
            self._plan_hedge(spec, alt_state)

        # advance the frontier along the predicted path
        if predicted_accept:
            self._frontier_state = tuple(proposal)
            self._frontier_y = y_hat_z
        elif needs_refresh:
            self._frontier_y = y_hat_x
        self._frontier_needs_refresh = False
        self._frontier_n = n + 1
        return spec

    def _plan_hedge(self, spec: _Speculation,
                    alt_state: tuple[int, ...]) -> None:
        """Draw the alternative branch's transition ``n+1`` exactly as a
        post-flush re-speculation would — same RNG state
        (``spec.rng_after``), same tabu filter, same request builder —
        but on a *clone*, and queue its measurement for dispatch.  The
        resulting ``(n+1, proposal, u)`` key is what :meth:`_fill`
        matches against after a flush."""
        ch = self.chain
        rng = copy.deepcopy(ch.rng)
        rng.bit_generator.state = copy.deepcopy(spec.rng_after)
        x = tuple(alt_state)
        proposal = ch.nbhd.propose(x, rng)
        if ch.tabu is not None:
            proposal = ch.tabu.filter(
                x, proposal, lambda: ch.nbhd.propose(x, rng))
        # same slot order as draw_transition: request construction (and
        # any RNG it consumes — from the clone) sits between the
        # proposal draw and the uniform draw
        req = self.build_hedge_request(
            tuple(proposal), spec.n + 1, "proposal", rng)
        u = float(rng.random())
        self._pending_hedges.append(
            ((spec.n + 1, tuple(proposal), u), req))

    def _fill(self) -> None:
        fresh: list[_Speculation] = []
        while len(self._queue) + len(fresh) < self.lookahead:
            fresh.append(self._speculate_one())
        if fresh:
            # adopt in-flight hedge measurements whose (n, proposal, u)
            # matches this redraw exactly; only the adoption at the
            # mispredicted transition's own depth counts as a *covered*
            # misprediction (deeper matches still reuse the measurement,
            # but the stall they save was never on the resolution path),
            # so hedged_covered <= mispredictions by construction
            for s in fresh:
                hit = self._hedges.pop((s.n, s.proposal, s.u), None)
                if hit is not None:
                    s.future = hit[1]
                    metrics.inc("evalpipe/hedge_hits")
                    if self._covered_n == s.n:
                        self.stats.hedged_covered += 1
            self._covered_n = None    # only the immediate refill covers
            # head-of-queue first (it gates resolution latency), then
            # most uncertain first — the measurements the predictor
            # learns most from
            order = ([fresh[0]] + sorted(fresh[1:], key=lambda s: -s.unc)
                     if not self._queue else
                     sorted(fresh, key=lambda s: -s.unc))
            reqs: list[EvalRequest] = []
            slots: list[tuple[_Speculation, str]] = []
            for s in order:
                if s.refresh_request is not None:
                    reqs.append(s.refresh_request)
                    slots.append((s, "refresh_future"))
                if s.future is None:        # not covered by a hedge
                    reqs.append(s.request)
                    slots.append((s, "future"))
            futs = self.dispatcher.submit_many(reqs)
            for (spec, attr), fut in zip(slots, futs):
                setattr(spec, attr, fut)
            # pipeline state (queue, recycled list, chain RNG) is
            # unlocked by contract: only the controller thread touches it
            # — workers hand results back through futures.  These seams
            # let the lockset detector verify the contract instead of
            # trusting the comment.
            race_access("pipeline", self)
            self._queue.extend(fresh)
        # hedge measurements dispatch after the real queue — they gate
        # nothing until a flush adopts them
        if self._pending_hedges:
            pend, self._pending_hedges = self._pending_hedges, []
            # a post-flush re-speculation of the same marginal transition
            # re-plans an identical key: dispatching it again would
            # overwrite (and so orphan) the in-flight twin's measurement
            fresh_keys: set[tuple] = set()
            pend = [(k, r) for k, r in pend
                    if k not in self._hedges
                    and not (k in fresh_keys or fresh_keys.add(k))]
            futs = self.dispatcher.submit_many([r for _, r in pend])
            for (key, req), fut in zip(pend, futs):
                self._hedges[key] = (req, fut)
                self.stats.hedged += 1
                metrics.inc("evalpipe/hedged")
        self._prefetch()

    def _prefetch(self) -> None:
        """Keep up to ``prefetch_probes`` surrogate probes of unmeasured
        states in flight while pool workers would otherwise idle; landed
        probes feed the recycling store (and the evaluation log) exactly
        once."""
        if self.prefetch_probes <= 0 or self.dispatcher.mode != "pool":
            return
        live: list[tuple[EvalRequest, Any]] = []
        for req, fut in self._probes:
            if fut.done():
                self._land(req, fut.result())
            else:
                live.append((req, fut))
        self._probes = live
        idle = self.dispatcher.max_workers - (
            self.dispatcher.dispatched - self.dispatcher.landed)
        room = min(self.prefetch_probes - len(self._probes), idle)
        if room <= 0:
            return
        reqs: list[EvalRequest] = []
        dims = self.chain.space.dimensions
        for _ in range(room):
            for _ in range(8):     # rejection-sample unmeasured states
                state = tuple(
                    int(self._prefetch_rng.integers(len(d.values)))
                    for d in dims)
                if state not in self.store:
                    break
            else:
                continue
            reqs.append(self.build_hedge_request(
                state, self._frontier_n, "probe", self._prefetch_rng))
        if reqs:
            futs = self.dispatcher.submit_many(reqs)
            self._probes.extend(zip(reqs, futs))
            self.stats.prefetched += len(reqs)
            metrics.inc("evalpipe/prefetched", len(reqs))

    # -- resolution --

    def _land(self, req: EvalRequest, res: EvalResult) -> None:
        """Record one landed measurement exactly once: into the chain's
        evaluation log (true_measures accounting, best() candidates) and
        the recycling store (predictor food)."""
        self.chain.record_evaluation(req.state, res.y)
        self.store.add(req.state, float(res.y), float(req.n))

    def _drain_recycled(self, wait: bool) -> None:
        race_access("pipeline", self)
        keep: list[tuple[EvalRequest, Any]] = []
        for req, fut in self._recycled:
            if wait or fut.done():
                self._land(req, fut.result())
                self.stats.recycled_landed += 1
            else:
                keep.append((req, fut))
        self._recycled = keep

    def _retire_future(self, req: EvalRequest, fut: Any) -> None:
        self.stats.recycled += 1
        metrics.inc("evalpipe/recycled")
        # a dispatch that never started running measured nothing —
        # cancel it (freeing its worker slot for the re-speculation)
        # rather than letting stale work starve the fresh head
        if getattr(fut, "cancel", None) is not None and fut.cancel():
            self.stats.cancelled += 1
            metrics.inc("evalpipe/cancelled")
            return
        self._recycled.append((req, fut))

    def _recycle(self, spec: _Speculation) -> None:
        for req, fut in ((spec.refresh_request, spec.refresh_future),
                         (spec.request, spec.future)):
            if fut is not None:
                self._retire_future(req, fut)

    def _retire_stale_hedges(self, n: int) -> None:
        """Hedges keyed at or below transition ``n`` can never be
        adopted once ``n`` has resolved — recycle their measurements."""
        for key in [k for k in self._hedges if k[0] <= n]:
            req, fut = self._hedges.pop(key)
            self._retire_future(req, fut)

    def flush(self) -> None:
        """Discard pending speculation (recycling its measurements) and
        rewind the chain RNG to the last resolved transition.  Called on
        a mispredicted acceptance, and by controllers whenever the world
        changed under the speculation — a reheat, a blend reweight."""
        race_access("pipeline", self)
        if self._queue:
            self.stats.flushes += 1
            metrics.inc("evalpipe/rewinds")
            while self._queue:
                self._recycle(self._queue.popleft())
        self.chain.rng.bit_generator.state = copy.deepcopy(
            self._committed_rng)
        self._sync_frontier()
        if self.on_flush is not None:
            self.on_flush()

    def step(self) -> ResolvedStep:
        """Resolve one real transition (the pipelined ``Annealer.step``)."""
        if self._closed:
            raise RuntimeError("pipeline is closed")
        self._drain_recycled(wait=False)
        self._fill()
        race_access("pipeline", self)
        spec = self._queue.popleft()
        ch = self.chain

        refresh_result = None
        if spec.refresh_future is not None:
            refresh_result = spec.refresh_future.result()
            ch.y = float(refresh_result.y)
            self._land(spec.refresh_request, refresh_result)
        result = spec.future.result()
        self._land(spec.request, result)

        step = ch.apply_transition(
            spec.proposal, spec.u, float(result.y), n=spec.n, tau=spec.tau)
        self.stats.resolved += 1
        metrics.inc("evalpipe/resolved")
        self._committed_rng = spec.rng_after
        self._retire_stale_hedges(spec.n)
        if self.on_resolve is not None:
            self.on_resolve(spec.request)
        if step.accepted != spec.predicted_accept:
            self.stats.mispredictions += 1
            metrics.inc("evalpipe/mispredictions")
            # the next _fill's redraw of n+1 may adopt this transition's
            # hedge — that (and only that) adoption covers this miss
            self._covered_n = spec.n + 1
            self.flush()
        return ResolvedStep(
            step=step, result=result, request=spec.request,
            refresh_result=refresh_result,
            refresh_request=spec.refresh_request)

    def close(self) -> None:
        """Recycle pending speculation, wait for every in-flight
        measurement to land (and be recorded), rewind the RNG to the last
        resolved transition, and shut the worker pool down.  The chain is
        left exactly where a serial run of the resolved prefix would be,
        so it can continue inline."""
        if self._closed:
            return
        self.flush()
        for key in list(self._hedges):
            req, fut = self._hedges.pop(key)
            self._retire_future(req, fut)
        for req, fut in self._probes:
            if getattr(fut, "cancel", None) is not None and fut.cancel():
                continue           # never ran: measured nothing
            self._land(req, fut.result())
        self._probes = []
        self._drain_recycled(wait=True)
        self.dispatcher.close()
        self._closed = True

    def __enter__(self) -> "SpeculativePipeline":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
