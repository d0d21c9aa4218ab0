"""Decision provenance: the *why* behind every committed control decision.

The metrics and spans record *what* the controllers decided (metrics + spans);
this module records *why*: a fixed-capacity flight recorder of per-round,
per-tenant :class:`DecisionRecord`\\ s carrying

* an **exact objective-term decomposition** — execution time, $/hr cost,
  migration charge, SLO hinge, coupling/contention penalty — whose sum
  provably reproduces the committed objective value (see the two-tier
  exactness contract below);
* the **temperature and acceptance probability** at the last accepted
  transition of the compiled chain block that produced the proposal;
* the best **rejected candidate** and its counterfactual delta — what the
  round would have cost had the runner-up been committed instead;
* **arbitration attribution**: for every defer/preempt, the name of the
  tenant whose marginal contribution to the aggregate breach was largest
  at the moment the arbiter acted.

Exactness contract (two tiers, both asserted in tests):

1. ``exact_split`` is bit-for-bit: its left-to-right float sum replays the
   *identical* IEEE-754 operations the controller used to produce the
   committed value (e.g. the fleet's ``pen_tables = tables + coupling_rows``
   elementwise add is the same double add as the scalar
   ``base + coupling``), so ``ladder_sum(exact_split) == y`` under ``==``.
2. ``terms`` is the fully named ladder (time / migration / cost /
   slo_hinge / table_gap / coupling ...); :func:`objective_terms` mirrors
   ``repro_torch.core.objective.Objective.__call__`` op for op, so the ladder
   sums to the committed value to float64 round-off — far inside the
   float32-exactness bar :meth:`DecisionRecord.check` enforces.

Like the rest of :mod:`repro_torch.telemetry`, this module is stdlib-only and
follows the dark-when-unarmed guard discipline: controllers call
:func:`record` / :func:`note_event` through a module sink that costs one
global load plus a truth test until :func:`enable` attaches a
:class:`FlightRecorder`.  All breakdown inputs are recovered from tables
the controllers already computed — arming provenance adds no jit outputs
and never perturbs decisions (parity is pinned in tests and the trace
bench).
"""

from __future__ import annotations

import dataclasses
import math
import threading
from typing import Any, Callable, Iterable

__all__ = [
    "F32_EPS", "DecisionRecord", "ProvenanceEvent", "FlightRecorder",
    "objective_terms", "ladder_sum", "acceptance_probability",
    "enable", "disable", "get", "record", "note_event",
]

#: Machine epsilon of IEEE-754 binary32 — the satellite test bar: the
#: named term ladder must reproduce the committed objective to float32
#: exactness even though both sides are computed in float64.
F32_EPS = 2.0 ** -23


def ladder_sum(terms: Iterable[tuple[str, float]]) -> float:
    """Left-to-right float sum of ``(name, value)`` terms — the exact
    op order the exactness contract is stated in."""
    s = 0.0
    for _, v in terms:
        s += v
    return s


def acceptance_probability(dy: float, tau: float) -> float:
    """Heat-bath rule, mirroring ``repro_torch.core.annealing`` without the
    jax import: ``exp(-max(dy, 0)/tau)``; at ``tau <= 0`` the chain is
    greedy (1 for downhill, 0 for uphill)."""
    if tau <= 0.0:
        return 1.0 if dy <= 0.0 else 0.0
    return math.exp(-max(dy, 0.0) / tau)


def objective_terms(objective: Any, m: Any) -> tuple[tuple[str, float], ...]:
    """Named decomposition of ``objective(m)`` for a plain (unpenalized)
    ``repro_torch.core.objective.Objective`` and a ``Measurement``.

    Mirrors ``Objective.__call__`` op for op so the ladder sum is
    bit-equal to the scalar the controller committed::

        t = exec; c = cost
        if include_migration: t += mig_s; c += mig_usd
        y = t + lambda_cost * c
        if slo_s and t > slo_s: y += slo_penalty * (t - slo_s)

    becomes ``time + migration + cost + slo_hinge`` summed left to right
    (``0.0 + t == t``, then the same ``+ mig``, ``+ lambda*c`` and
    ``+ hinge`` adds in the same order).  Duck-typed: anything with
    ``lambda_cost`` / ``include_migration`` / ``slo_s`` / ``slo_penalty``
    works, so no jax import is needed here.
    """
    t = float(m.exec_time_s)
    c = float(m.cost_usd)
    mig_t = 0.0
    if getattr(objective, "include_migration", False):
        mig_t = float(m.migration_s)
        c = c + float(m.migration_usd)
    t_eff = t + mig_t
    cost = float(objective.lambda_cost) * c
    hinge = 0.0
    slo_s = getattr(objective, "slo_s", None)
    if slo_s is not None and t_eff > slo_s:
        hinge = float(objective.slo_penalty) * (t_eff - slo_s)
    return (("time", t), ("migration", mig_t), ("cost", cost),
            ("slo_hinge", hinge))


def _jsonable_state(x: Any) -> Any:
    """Duck-typed JSON coercion of a committed state: numpy arrays and
    scalars (``tolist`` / ``item``) without importing numpy — this
    module stays stdlib-only."""
    if hasattr(x, "tolist"):
        x = x.tolist()
    if isinstance(x, (list, tuple)):
        return [_jsonable_state(v) for v in x]
    if hasattr(x, "item"):
        x = x.item()
    return x


@dataclasses.dataclass(frozen=True)
class DecisionRecord:
    """One committed decision and everything needed to explain it."""

    controller: str                 # "fleet" / "sizing" / ...
    round: int                      # control round index
    tenant: str                     # "" for single-tenant controllers
    action: str                     # admit / hold / defer / preempt / ...
    state: Any                      # committed state (flat index or tuple)
    y: float                        # committed objective value
    #: Named ladder; sums to ``y`` to float32 exactness (tier 2).
    terms: tuple[tuple[str, float], ...]
    #: Coarse split; sums to ``y`` bit-for-bit (tier 1).
    exact_split: tuple[tuple[str, float], ...]
    tau: float = float("nan")       # temperature at the last accept
    accept_prob: float = float("nan")  # heat-bath p at that transition
    rejected: Any = None            # best rejected candidate state
    rejected_y: float = float("nan")
    counterfactual: float = float("nan")  # rejected_y - y
    attribution: str = ""           # tenant blamed for a defer/preempt
    violation: float = 0.0          # this tenant's marginal breach share
    reheated: bool = False
    t: float | None = None          # event time (s) when the loop has one

    def term(self, name: str) -> float:
        for k, v in self.terms:
            if k == name:
                return v
        raise KeyError(name)

    def residual(self) -> float:
        """``ladder_sum(terms) - y`` (float64)."""
        return ladder_sum(self.terms) - self.y

    def split_residual(self) -> float:
        return ladder_sum(self.exact_split) - self.y

    def check(self, rel: float = 4.0 * F32_EPS) -> bool:
        """Does the named ladder reproduce the committed value to
        float32 exactness?  (The coarse split must match under ``==``;
        tests assert both.)"""
        scale = max(1.0, abs(self.y))
        return abs(self.residual()) <= rel * scale

    def why(self) -> str:
        """One-line operator-facing rendering of the record."""
        parts = " + ".join(f"{k}={v:.4g}" for k, v in self.terms
                           if v != 0.0 or k in ("time", "cost"))
        who = f" {self.tenant}" if self.tenant else ""
        line = (f"[{self.controller} r{self.round}]{who} {self.action} "
                f"state={self.state} y={self.y:.6g} ({parts})")
        if math.isfinite(self.tau):
            line += f" | tau={self.tau:.3g}"
            if math.isfinite(self.accept_prob):
                line += f" p_accept={self.accept_prob:.2g}"
        if self.rejected is not None and math.isfinite(self.counterfactual):
            line += (f" | best rejected state={self.rejected} "
                     f"would cost {self.counterfactual:+.4g}")
        if self.attribution:
            line += f" | blocked by {self.attribution}"
        if self.reheated:
            line += " | reheated"
        return line

    def to_dict(self) -> dict[str, Any]:
        d = dataclasses.asdict(self)
        d["terms"] = [[k, float(v)] for k, v in self.terms]
        d["exact_split"] = [[k, float(v)] for k, v in self.exact_split]
        d["state"] = _jsonable_state(d["state"])
        d["rejected"] = _jsonable_state(d["rejected"])
        for k in ("tau", "accept_prob", "rejected_y", "counterfactual"):
            if not math.isfinite(d[k]):
                d[k] = None
        d["residual"] = self.residual()
        d["why"] = self.why()
        return d


@dataclasses.dataclass(frozen=True)
class ProvenanceEvent:
    """A timeline marker the postmortem report interleaves with decision
    records: drift detections, reheats, churn (arrive/depart/phase),
    aggregate violations."""

    kind: str
    round: int
    tenant: str = ""
    t: float | None = None          # event time (s) when the loop has one
    detail: str = ""

    def to_dict(self) -> dict[str, Any]:
        return dataclasses.asdict(self)


class FlightRecorder:
    """Fixed-capacity rings of decision records and timeline events.

    Same memory contract as the registry's :class:`~.registry.Series`:
    appends past capacity overwrite the oldest entry and ``dropped``
    counts them, so a million-round replay holds memory constant.
    """

    def __init__(self, capacity: int = 8192, event_capacity: int = 4096,
                 lock_factory: Callable[[], Any] = threading.Lock):
        if capacity < 1 or event_capacity < 1:
            raise ValueError("capacities must be >= 1")
        self.capacity = int(capacity)
        self.event_capacity = int(event_capacity)
        self._lock = lock_factory()
        self._records: list[DecisionRecord | None] = [None] * self.capacity
        self._events: list[ProvenanceEvent | None] = [None] * self.event_capacity
        self._ridx = 0
        self._rtotal = 0
        self._eidx = 0
        self._etotal = 0

    # -- writes -------------------------------------------------------------

    def record(self, rec: DecisionRecord) -> None:
        with self._lock:
            self._records[self._ridx] = rec
            self._ridx = (self._ridx + 1) % self.capacity
            self._rtotal += 1

    def note_event(self, kind: str, round: int, tenant: str = "",
                   t: float | None = None, detail: str = "") -> None:
        ev = ProvenanceEvent(kind=kind, round=int(round), tenant=tenant,
                             t=t, detail=detail)
        with self._lock:
            self._events[self._eidx] = ev
            self._eidx = (self._eidx + 1) % self.event_capacity
            self._etotal += 1

    # -- reads --------------------------------------------------------------

    def __len__(self) -> int:
        with self._lock:
            return min(self._rtotal, self.capacity)

    @property
    def dropped(self) -> int:
        with self._lock:
            return max(0, self._rtotal - self.capacity)

    @property
    def events_dropped(self) -> int:
        with self._lock:
            return max(0, self._etotal - self.event_capacity)

    def records(self) -> list[DecisionRecord]:
        """Retained records, oldest first."""
        with self._lock:
            if self._rtotal <= self.capacity:
                out = self._records[:self._rtotal]
            else:
                i = self._ridx
                out = self._records[i:] + self._records[:i]
        return [r for r in out if r is not None]

    def events(self) -> list[ProvenanceEvent]:
        """Retained events, oldest first."""
        with self._lock:
            if self._etotal <= self.event_capacity:
                out = self._events[:self._etotal]
            else:
                i = self._eidx
                out = self._events[i:] + self._events[:i]
        return [e for e in out if e is not None]

    def for_round(self, r: int) -> list[DecisionRecord]:
        return [rec for rec in self.records() if rec.round == r]

    def window(self, r0: int, r1: int,
               ) -> tuple[list[DecisionRecord], list[ProvenanceEvent]]:
        """Records and events with ``r0 <= round <= r1``, oldest first."""
        recs = [r for r in self.records() if r0 <= r.round <= r1]
        evs = [e for e in self.events() if r0 <= e.round <= r1]
        return recs, evs

    def summary(self) -> dict[str, Any]:
        """Per-controller aggregate view: action counts plus last/mean of
        each named term — the report CLI's ``--section terms`` feed."""
        out: dict[str, Any] = {}
        for rec in self.records():
            c = out.setdefault(rec.controller, {
                "records": 0, "actions": {}, "terms": {}, "last_why": ""})
            c["records"] += 1
            c["actions"][rec.action] = c["actions"].get(rec.action, 0) + 1
            for k, v in rec.terms:
                tk = c["terms"].setdefault(k, {"last": 0.0, "sum": 0.0,
                                               "n": 0})
                tk["last"] = v
                tk["sum"] += v
                tk["n"] += 1
            c["last_why"] = rec.why()
        for c in out.values():
            for tk in c["terms"].values():
                tk["mean"] = tk["sum"] / max(1, tk.pop("n"))
                del tk["sum"]
        return out

    def snapshot(self, max_records: int = 1024,
                 max_events: int = 2048) -> dict[str, Any]:
        """Plain-JSON dump (most recent ``max_records`` / ``max_events``
        retained entries; the in-memory rings keep the full capacity)."""
        recs = self.records()
        evs = self.events()
        return {
            "capacity": self.capacity,
            "dropped": self.dropped,
            "events_dropped": self.events_dropped,
            "truncated": max(0, len(recs) - max_records),
            "records": [r.to_dict() for r in recs[-max_records:]],
            "events": [e.to_dict() for e in evs[-max_events:]],
            "summary": self.summary(),
        }


# ---------------------------------------------------------------------------
# The module sink + guarded write-through functions (the hot-path seam).
# ---------------------------------------------------------------------------

_SINK: FlightRecorder | None = None


def enable(recorder: FlightRecorder | None = None) -> FlightRecorder:
    """Attach ``recorder`` (or a fresh one) as the process sink and
    return it.  Prefer ``repro_torch.telemetry.enable()``, which arms metrics,
    spans and provenance together."""
    global _SINK
    _SINK = recorder if recorder is not None else FlightRecorder()
    return _SINK


def disable() -> FlightRecorder | None:
    global _SINK
    prev, _SINK = _SINK, None
    return prev


def get() -> FlightRecorder | None:
    return _SINK


def record(rec: DecisionRecord) -> None:
    sink = _SINK
    if sink is not None:
        sink.record(rec)


def note_event(kind: str, round: int, tenant: str = "",
               t: float | None = None, detail: str = "") -> None:
    sink = _SINK
    if sink is not None:
        sink.note_event(kind, round, tenant=tenant, t=t, detail=detail)
