"""Declarative rule-of-thumb alerting over the metrics registry.

The paper layers "user-specified rules of thumb" on top of the annealing
platform; this module is that seam for the reproduction.  A
:class:`Rule` is a declarative condition over registry series / gauges /
counters; the :class:`AlertEngine` evaluates every rule **once per
control round** via the existing ``note_round`` hook
(``repro_torch.telemetry._round_hook``), and a firing rule

* increments ``alerts/fired/<rule>`` and updates the ``alerts/active``
  gauge in the same registry (so alerts ride the dashboards for free),
* appends a structured :class:`Alert` to :attr:`AlertEngine.fired`
  (serialized into ``ALERTS_*.json`` by
  ``Telemetry.write_artifacts``), and
* renders in ``python -m repro_torch.telemetry.report --section alerts``
  (``--fail-on-alerts`` turns it into a CI gate).

Three rule kinds:

* ``threshold`` — compare the metric's current value against ``value``
  (``op`` is ``gt``/``lt``/``ge``/``le``);
* ``trend`` — compare the change over the last ``window`` rounds
  against ``value`` (e.g. "more than 3 reheats within 8 rounds");
* ``budget_burn`` — ratio of the metric to a budget read from
  ``budget_metric`` (a gauge), compared against ``value`` (default 1.0
  = burning faster than budget).

Firing is **edge-triggered**: a rule fires once when its condition first
becomes true and re-arms only after the condition clears, so a sustained
breach produces one alert, not one per round.  The engine reads metrics
through the registry's non-creating :meth:`~.registry.MetricsRegistry.peek`
— evaluation never conjures metrics into being.

Multiple controllers may call ``note_round`` inside one wall-clock round
(a trace replay notes both the fleet's and its own); the engine pins its
round axis to the *first* controller name it observes and ignores the
rest, so trend windows count real control rounds.

Stdlib-only, like the rest of :mod:`repro_torch.telemetry`.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
from collections import deque
from typing import Any, Deque

from .registry import MetricsRegistry

__all__ = ["Rule", "Alert", "AlertEngine", "default_rules"]

_KINDS = ("threshold", "trend", "budget_burn")
_OPS = {
    "gt": lambda a, b: a > b,
    "ge": lambda a, b: a >= b,
    "lt": lambda a, b: a < b,
    "le": lambda a, b: a <= b,
}


@dataclasses.dataclass(frozen=True)
class Rule:
    """One declarative condition over a registry metric."""

    name: str
    kind: str                       # threshold | trend | budget_burn
    metric: str                     # series (last value), gauge or counter
    op: str = "gt"
    value: float = 0.0              # threshold / trend delta / burn ratio
    window: int = 1                 # trend + budget_burn lookback, rounds
    budget_metric: str = ""         # budget_burn: gauge holding the budget
    severity: str = "warn"          # warn | page
    min_rounds: int = 0             # suppress until this many rounds seen
    message: str = ""               # format with {value} / {threshold}

    def __post_init__(self) -> None:
        if self.kind not in _KINDS:
            raise ValueError(f"unknown rule kind {self.kind!r}")
        if self.op not in _OPS:
            raise ValueError(f"unknown op {self.op!r}")
        if self.kind == "budget_burn" and not self.budget_metric:
            raise ValueError("budget_burn rules need budget_metric")
        if self.window < 1:
            raise ValueError("window must be >= 1")

    def to_dict(self) -> dict[str, Any]:
        return dataclasses.asdict(self)


@dataclasses.dataclass(frozen=True)
class Alert:
    """One edge-triggered firing of a rule."""

    rule: str
    severity: str
    round: int                      # engine round index at firing
    value: float                    # observed value / delta / burn ratio
    threshold: float
    message: str

    def to_dict(self) -> dict[str, Any]:
        return dataclasses.asdict(self)


def default_rules() -> tuple[Rule, ...]:
    """The shipped rules of thumb.

    Thresholds are deliberately conservative: the trace bench's nightly
    leg runs with ``--fail-on-alerts``, so a default rule firing there
    means the fleet genuinely misbehaved, not that a healthy run grazed
    a tight bound.
    """
    return (
        # Per-round fleet SLO attainment sagging well below the bench's
        # own >= 0.8 average gate.
        Rule("slo_attainment_dip", "threshold", "fleet/slo_attainment",
             op="lt", value=0.7, min_rounds=2, severity="page",
             message="fleet SLO attainment {value:.3f} below {threshold}"),
        # Committed spend burning past the fleet budget (the controller
        # exports its budget as the fleet/budget_usd_hr gauge).
        Rule("spend_over_budget", "budget_burn", "fleet/spend_usd_hr",
             budget_metric="fleet/budget_usd_hr", value=1.0,
             severity="page",
             message="fleet spend burning {value:.2f}x the $/hr budget"),
        # Drift detector thrashing: many reheats in a short window means
        # surrogates are chronically stale, not occasionally drifting.
        Rule("reheat_storm", "trend", "fleet/reheats", op="gt",
             value=8.0, window=8, severity="warn",
             message="{value:.0f} reheats fired within the last 8 rounds"),
        # Surrogate incumbent repeatedly falling out of the trusted
        # window — the model is chasing, not converging.
        Rule("stale_surrogate_incumbent", "trend",
             "surrogate/stale_refreshes", op="gt", value=2.0, window=8,
             severity="warn",
             message="surrogate incumbent re-measured stale "
                     "{value:.0f}x within the last 8 rounds"),
    )


class AlertEngine:
    """Evaluates rules once per control round; edge-triggered firing."""

    def __init__(self, rules: tuple[Rule, ...] | None = None):
        self.rules: tuple[Rule, ...] = (default_rules() if rules is None
                                        else tuple(rules))
        self.fired: list[Alert] = []
        self._active: set[str] = set()
        self._history: dict[str, Deque[float]] = {}
        self._round_owner: str | None = None
        self._round = 0

    # -- evaluation ---------------------------------------------------------

    def evaluate(self, reg: MetricsRegistry,
                 name: str | None = None) -> list[Alert]:
        """Evaluate all rules against ``reg``; returns newly fired
        alerts.  ``name`` is the ``note_round`` controller name used to
        pin the round axis (see module docstring); pass ``None`` to
        force evaluation (tests, manual sweeps)."""
        if name is not None:
            if self._round_owner is None:
                self._round_owner = name
            elif name != self._round_owner:
                return []
        self._round += 1
        newly: list[Alert] = []
        for rule in self.rules:
            val = self._metric_value(reg, rule.metric)
            if val is None:
                self._active.discard(rule.name)
                continue
            hist = self._history.setdefault(
                rule.name, deque(maxlen=rule.window + 1))
            hist.append(val)
            if self._round < rule.min_rounds:
                continue
            cond, cur, thr = self._condition(rule, reg, hist, val)
            if cond and rule.name not in self._active:
                self._active.add(rule.name)
                alert = Alert(
                    rule=rule.name, severity=rule.severity,
                    round=self._round, value=cur, threshold=thr,
                    message=(rule.message or "{value:.4g} vs {threshold:.4g}"
                             ).format(value=cur, threshold=thr))
                self.fired.append(alert)
                newly.append(alert)
                reg.counter("alerts/fired/" + rule.name).inc()
                reg.counter("alerts/fired").inc()
            elif not cond:
                self._active.discard(rule.name)
        reg.gauge("alerts/active").set(float(len(self._active)))
        return newly

    @staticmethod
    def _metric_value(reg: MetricsRegistry, name: str) -> float | None:
        """Current value of ``name``: series last point, else gauge, else
        counter — without creating anything."""
        m = reg.peek("series", name)
        if m is not None:
            vals = m.values()
            return vals[-1] if vals else None
        m = reg.peek("gauge", name)
        if m is not None:
            return m.value
        m = reg.peek("counter", name)
        if m is not None:
            return m.value
        return None

    def _condition(self, rule: Rule, reg: MetricsRegistry,
                   hist: Deque[float], val: float,
                   ) -> tuple[bool, float, float]:
        op = _OPS[rule.op]
        if rule.kind == "threshold":
            return op(val, rule.value), val, rule.value
        if rule.kind == "trend":
            if len(hist) <= rule.window:
                return False, 0.0, rule.value
            delta = val - hist[0]
            return op(delta, rule.value), delta, rule.value
        # budget_burn
        budget = self._metric_value(reg, rule.budget_metric)
        if budget is None or not math.isfinite(budget) or budget <= 0.0:
            return False, 0.0, rule.value
        recent = list(hist)[-rule.window:]
        burn = (sum(recent) / len(recent)) / budget
        return op(burn, rule.value), burn, rule.value

    # -- reporting ----------------------------------------------------------

    @property
    def active(self) -> tuple[str, ...]:
        return tuple(sorted(self._active))

    def page_count(self) -> int:
        return sum(1 for a in self.fired if a.severity == "page")

    def snapshot(self) -> dict[str, Any]:
        return {
            "rounds": self._round,
            "round_owner": self._round_owner,
            "rules": [r.to_dict() for r in self.rules],
            "fired": [a.to_dict() for a in self.fired],
            "active": list(self.active),
        }

    def write(self, path: str) -> str:
        """Write the structured ``ALERTS_*.json`` artifact."""
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        with open(path, "w") as f:
            json.dump(self.snapshot(), f, indent=2)
        return path
