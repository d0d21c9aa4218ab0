"""Trace-driven fleet replay: an event-time control loop over
:class:`FleetController`.

The fleet's historical benchmarks ran a FIXED tenant cohort on a fixed
round grid.  :class:`TraceReplayController` instead drives the fleet from
a :class:`repro_torch.workloads.trace.SyntheticTrace` — tenants arrive,
change workload phase and depart mid-run (heavy churn, Alibaba-style),
and the round clock advances in EVENT TIME: dense stretches tick at the control
cadence with all intervening events batched into the round, quiet gaps
jump straight to the next event instead of spinning idle rounds.

Each tick:

1. applies the tick's trace events to the live fleet —
   :meth:`FleetController.remove_tenant` (departures release their
   catalog share through the reservation mirror, claimable the same
   tick), :meth:`add_tenant` (arrivals get a fresh, never-reused RNG
   stream id), :meth:`retune_tenant` (phase changes swap the blend in
   place, superseding any declared change point);
2. runs ONE fleet control round (incremental by default: only arrivals,
   phase-changed and drift-fired tenants re-anneal; the rest carry
   their incumbents);
3. records per-round replay stats — live tenants, chains annealed,
   arbitration actions, aggregate violation, SLO attainment of the
   round's measurements, and wall-clock spent in the controller.

The replay is deterministic: a (trace seed, controller seed) pair pins
the full :class:`FleetDecision` log, on the CPU and on the card alike
(the chains' draws are bit-identical on both).  The port of the reference
package's ``core/trace_replay.py``.
"""

from __future__ import annotations

import math
import time
import warnings
from typing import Any, Callable, Mapping

import torch

from .costmodel import Evaluator
from .fleet import FleetController, FleetDecision, TenantSpec
from .instrumentation import note_round
from .objective import Objective, PenalizedObjective
from .pricing import ServiceCatalog
from .state import ClusterConfig, ConfigSpace
from .surrogate import ObjectiveSource
from ..telemetry import provenance
from ..telemetry import registry as metrics
from ..telemetry import span
from ..workloads.trace import SyntheticTrace, TraceEvent, replay_ticks


class TraceReplayController:
    """Replays a synthetic churn trace against one FleetController.

    ``slo_s`` (optional) is the per-job sojourn/exec-time SLO: each
    round's attainment is the fraction of tenant measurements with
    ``exec_time_s <= slo_s``.  ``incremental=True`` (the default — this
    is the 1k-tenant configuration) re-anneals only tenants the trace or
    the drift detectors perturbed; ``device`` is where the fleet's chains
    walk (``mesh`` must be None, as for :class:`FleetController`).

    Guards (counted in the summary, never fatal): a departure that would
    empty the fleet is skipped (``FleetController`` requires >= 1
    tenant); events for unknown tenants — a phase change racing its own
    departure inside one tick — are dropped.
    """

    def __init__(
        self,
        trace: SyntheticTrace,
        space: ConfigSpace,
        catalog: ServiceCatalog,
        evaluator: Evaluator,
        *,
        objective: Objective | PenalizedObjective | None = None,
        budget_usd_hr: float = math.inf,
        steps_per_round: int = 32,
        control_period_s: float = 30.0,
        slo_s: float | None = None,
        seed: int = 0,
        incremental: bool = True,
        settle_rounds: int = 3,
        mesh: Any = None,
        chain_bucketing: bool = True,
        detectors: bool = True,
        keep_decision_log: bool = False,
        ledger_check_every: int = 64,
        objective_source: ObjectiveSource | None = None,
        config_fn: "Callable[[Mapping[str, Any]], ClusterConfig] | None"
        = None,
        device: "str | torch.device" = "cuda",
    ):
        founding = trace.founding()
        if not founding:
            raise ValueError("trace has no founding cohort (t=0 arrivals)")
        self.trace = trace
        self.control_period_s = float(control_period_s)
        self.slo_s = None if slo_s is None else float(slo_s)
        self.fleet = FleetController(
            space, catalog, evaluator,
            [self._spec(e) for e in founding],
            objective=objective, budget_usd_hr=budget_usd_hr,
            steps_per_round=steps_per_round, detectors=detectors,
            seed=seed, objective_source=objective_source,
            config_fn=config_fn, incremental=incremental,
            settle_rounds=settle_rounds, mesh=mesh,
            chain_bucketing=chain_bucketing,
            ledger_check_every=ledger_check_every,
            keep_decision_log=keep_decision_log, device=device,
        )
        self._founding_names = {e.tenant for e in founding}
        self.rounds: list[dict[str, Any]] = []
        self.skipped: dict[str, int] = {
            "depart_last_tenant": 0, "unknown_tenant": 0}

    def _spec(self, e: TraceEvent) -> TenantSpec:
        return TenantSpec(
            name=e.tenant, blend=dict(self.trace.profiles[e.profile]),
            priority=e.priority)

    # ------------------------------------------------------------------

    def _apply_events(self, events: list[TraceEvent]) -> dict[str, int]:
        """Apply one tick's events to the live fleet, in trace order
        (departures sort first at equal timestamps, so a same-tick
        arrival can claim the departed tenant's capacity)."""
        applied = {"arrive": 0, "depart": 0, "phase": 0}
        live = {t.name for t in self.fleet.tenants}
        for e in events:
            if e.kind == "arrive":
                if e.tenant in live:       # the founding cohort's t=0
                    continue               # arrivals are pre-admitted
                self.fleet.add_tenant(self._spec(e))
                live.add(e.tenant)
            elif e.kind == "depart":
                if e.tenant not in live:
                    self.skipped["unknown_tenant"] += 1
                    continue
                if len(live) == 1:
                    self.skipped["depart_last_tenant"] += 1
                    continue
                self.fleet.remove_tenant(e.tenant)
                live.discard(e.tenant)
            else:                          # phase
                if e.tenant not in live:
                    self.skipped["unknown_tenant"] += 1
                    continue
                self.fleet.retune_tenant(
                    e.tenant, dict(self.trace.profiles[e.profile]))
            applied[e.kind] += 1
        return applied

    def _slo_attainment(self, decisions: list[FleetDecision]) -> float:
        if self.slo_s is None or not decisions:
            return float("nan")
        ok = sum(d.measurement.exec_time_s <= self.slo_s
                 for d in decisions)
        return ok / len(decisions)

    def replay(self, max_rounds: int | None = None) -> dict[str, Any]:
        """Run the trace to its horizon (or ``max_rounds`` ticks).
        Returns the replay summary; per-round records accumulate in
        ``self.rounds``."""
        for t, events in replay_ticks(self.trace, self.control_period_s):
            if max_rounds is not None and len(self.rounds) >= max_rounds:
                break
            with span("trace.tick", cat="trace"):
                applied = self._apply_events(events)
                t0 = time.perf_counter()
                decisions = self.fleet.round()
                wall = time.perf_counter() - t0
            actions = {"admit": 0, "hold": 0, "defer": 0, "preempt": 0}
            for d in decisions:
                actions[d.action] += 1
            rec = {
                "t": float(t),
                "n_tenants": len(self.fleet.tenants),
                "n_annealed": int(self.fleet.last_annealed),
                "events": applied,
                "actions": actions,
                "violation": float(self.fleet.violation_history[-1]),
                "slo_attainment": self._slo_attainment(decisions),
                "wall_s": wall,
            }
            self.rounds.append(rec)
            if metrics.get() is not None:
                self._record_tick_metrics(rec)
            if (provenance.get() is not None
                    and rec["violation"] > 1e-9):
                # round index = the wrapped fleet's just-finished round,
                # so the event lines up with fleet DecisionRecords
                provenance.note_event(
                    "violation", self.fleet._round - 1, t=float(t),
                    detail=f"aggregate overshoot "
                           f"{rec['violation']:.4g}")
            # the replay's own round boundary: exactly one per tick, on
            # top of the wrapped FleetController's (attributed
            # separately, so the sanitizer and telemetry each count both
            # seams without double-counting either)
            note_round("TraceReplayController", self)
        return self._summary()

    def _record_tick_metrics(self, rec: dict[str, Any]) -> None:
        """Per-tick dashboard series, keyed by event time (seconds)."""
        t = rec["t"]
        metrics.record("trace/tenants", float(rec["n_tenants"]), t)
        metrics.record("trace/annealed", float(rec["n_annealed"]), t)
        metrics.record("trace/violation", rec["violation"], t)
        if not math.isnan(rec["slo_attainment"]):
            metrics.record("trace/slo_attainment", rec["slo_attainment"], t)
        metrics.record("trace/round_wall_s", rec["wall_s"], t)
        for kind, k in rec["events"].items():
            if k:
                metrics.inc("trace/events/" + kind, k)

    def stats(self) -> dict[str, Any]:
        """The unified controller stats contract
        (:meth:`repro_torch.core.procurement.ControllerMixin.stats`) for the
        replay loop: the replay summary plus the wrapped fleet's own
        stats under ``"fleet"``.  Supersedes calling :meth:`summary`
        directly."""
        out: dict[str, Any] = {
            "controller": type(self).__name__,
            "rounds": len(self.rounds),
            **self.fleet.evaluation_counts(),
            "pipeline": None,
            "summary": self._summary(),
            "fleet": self.fleet.stats(),
        }
        reg = metrics.get()
        if reg is not None:
            out["metrics"] = reg.snapshot(prefix="trace")
        return out

    def summary(self) -> dict[str, Any]:
        """Deprecated: read ``stats()["summary"]`` instead.  Routed
        through :meth:`stats` so the unified contract is the single
        source of truth; emits one :class:`DeprecationWarning`."""
        warnings.warn(
            "summary() is deprecated; read stats()['summary']",
            DeprecationWarning, stacklevel=2)
        return self.stats()["summary"]

    def _summary(self) -> dict[str, Any]:
        """Whole-replay aggregates — the ``stats()["summary"]`` payload
        (and what :meth:`replay` returns)."""
        rs = self.rounds
        n_tenant_rounds = sum(r["n_tenants"] for r in rs)
        slo = [r["slo_attainment"] for r in rs
               if not math.isnan(r["slo_attainment"])]
        slo_w = [r["n_tenants"] for r in rs
                 if not math.isnan(r["slo_attainment"])]
        return {
            "rounds": len(rs),
            "horizon_s": self.trace.horizon_s,
            "tenant_rounds": n_tenant_rounds,
            "annealed_rounds": sum(r["n_annealed"] for r in rs),
            "annealed_fraction": (
                sum(r["n_annealed"] for r in rs) / n_tenant_rounds
                if n_tenant_rounds else 0.0),
            "peak_tenants": max((r["n_tenants"] for r in rs), default=0),
            "final_tenants": rs[-1]["n_tenants"] if rs else 0,
            "events_applied": {
                k: sum(r["events"][k] for r in rs)
                for k in ("arrive", "depart", "phase")},
            "skipped": dict(self.skipped),
            "violation_rounds": sum(r["violation"] > 1e-9 for r in rs),
            "slo_attainment": (
                float(sum(a * w for a, w in zip(slo, slo_w))
                      / sum(slo_w)) if slo_w else float("nan")),
            "wall_s": sum(r["wall_s"] for r in rs),
        }


__all__ = ["TraceReplayController"]
