"""Decision records and the plumbing every controller shares.

The slice of the reference's procurement module that the sizing
controller needs: :class:`Decision` and :class:`ControllerMixin`.  The
procurement controller itself, and the mixin's batched measurement phase
(``_measure_batch``), wait for the port of the evaluation runtime.
"""

from __future__ import annotations

import dataclasses
import threading
import warnings
from typing import Any, Callable, Mapping

import numpy as np

from .change_detect import PageHinkley
from .instrumentation import race_access
from .objective import Measurement
from .state import ClusterConfig
from ..telemetry import registry as metrics


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
    procurement, multi-tenant fleet, container
    :class:`repro_torch.core.sizing.SizingController`).

    All controllers log :class:`Decision`-compatible records into
    ``self.decisions``, so audit tooling (``spend()``, CSV export of
    decision fields) works unchanged across them — and real measurements
    are counted exactly once, under a lock, even when they land from
    worker threads.
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
