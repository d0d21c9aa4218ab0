"""Runtime observability for the annealing control plane.

Three pieces, one switch:

* :mod:`repro_torch.telemetry.registry` — counters / gauges / ring-buffer
  series / histograms behind guarded module functions (``inc`` /
  ``record`` / ``observe`` / ``set_gauge``);
* :mod:`repro_torch.telemetry.spans` — nested wall-clock phase spans with
  Chrome/Perfetto ``trace_event`` export;
* :mod:`repro_torch.telemetry.report` — JSON snapshots plus the
  ``python -m repro_torch.telemetry.report`` terminal dashboard;
* :mod:`repro_torch.telemetry.provenance` — flight recorder of per-round,
  per-tenant decision records with exact objective-term decompositions
  (the *why* behind each decision);
* :mod:`repro_torch.telemetry.alerts` — declarative rules of thumb
  (threshold / trend / budget-burn) evaluated once per control round
  via the ``note_round`` seam;
* :mod:`repro_torch.telemetry.postmortem` — violation-window timelines over
  the snapshot (report CLI ``--section postmortem``).

Everything in :mod:`repro_torch.core` is instrumented through those guards, so
the layer is *on by default* in the sense that the call sites are always
live — but until :func:`enable` attaches sinks, each one is a global
load and a truth test (the :mod:`repro_torch.core.instrumentation` contract).
This is deliberately unlike the :mod:`repro.analysis` gates, which
monkey-patch the code under test and may abort the run: telemetry is
passive, allocation-free when dark, and safe to leave enabled in
production runs (``REPRO_TELEMETRY=1`` arms it at ``repro_torch.core``
import, mirroring ``REPRO_SANITIZE`` / ``REPRO_RACECHECK``).

Typical use::

    import repro_torch.telemetry as telemetry

    with telemetry.session(meta={"suite": "trace_fleet"}) as tel:
        controller.replay()
        tel.write_artifacts("TELEMETRY_trace", out_dir=".")
        print(tel.dashboard())

Telemetry shares the round seam with the sanitizer: one
``instrumentation.ROUND_HOOKS`` entry per concern, so both observe every
``note_round`` without double-counting either's numbers.
"""

from __future__ import annotations

import dataclasses
import json
import os
from contextlib import contextmanager
from typing import Any, Iterator

from . import provenance as _provenance_mod
from . import registry as _registry_mod
from . import spans as _spans_mod
from .alerts import Alert, AlertEngine, Rule, default_rules
from .provenance import DecisionRecord, FlightRecorder
from .registry import MetricsRegistry
from .report import build_snapshot, render, sparkline
from .spans import SpanRecorder, span, traced

__all__ = [
    "MetricsRegistry", "SpanRecorder", "Telemetry",
    "FlightRecorder", "DecisionRecord",
    "AlertEngine", "Alert", "Rule", "default_rules",
    "span", "traced", "sparkline",
    "enable", "disable", "get", "session",
]

ENV_FLAG = "REPRO_TELEMETRY"


def enabled_by_env() -> bool:
    return os.environ.get(ENV_FLAG) == "1"


@dataclasses.dataclass
class Telemetry:
    """Handle pairing the sinks of one observation window: metrics,
    spans, the decision-provenance flight recorder, and the alert
    engine."""

    metrics: MetricsRegistry
    spans: SpanRecorder
    meta: dict[str, Any] = dataclasses.field(default_factory=dict)
    provenance: FlightRecorder | None = None
    alerts: AlertEngine | None = None

    def snapshot(self) -> dict[str, Any]:
        return build_snapshot(self.metrics, self.spans, self.meta,
                              provenance=self.provenance,
                              alerts=self.alerts)

    def dashboard(self, width: int = 48) -> str:
        return render(self.snapshot(), width=width)

    def write_artifacts(self, stem: str, out_dir: str = ".",
                        ) -> dict[str, str]:
        """Write ``<stem>.json`` (metrics snapshot),
        ``<stem>.perfetto.json`` (Chrome trace_event JSON) and — when an
        alert engine is attached — the structured ``ALERTS_*.json``
        artifact (``TELEMETRY_x`` maps to ``ALERTS_x``, any other stem
        gets ``ALERTS_`` prefixed) under ``out_dir``; returns the
        paths."""
        os.makedirs(out_dir, exist_ok=True)
        snap_path = os.path.join(out_dir, stem + ".json")
        trace_path = os.path.join(out_dir, stem + ".perfetto.json")
        with open(snap_path, "w") as f:
            json.dump(self.snapshot(), f, indent=2)
        self.spans.write(trace_path)
        paths = {"snapshot": snap_path, "perfetto": trace_path}
        if self.alerts is not None:
            alert_stem = (stem.replace("TELEMETRY_", "ALERTS_", 1)
                          if stem.startswith("TELEMETRY_")
                          else "ALERTS_" + stem)
            paths["alerts"] = self.alerts.write(
                os.path.join(out_dir, alert_stem + ".json"))
        return paths


_ACTIVE: Telemetry | None = None
_ROUND_HOOK_INSTALLED = False


def _round_hook(name: str, owner: Any) -> None:
    # Shares instrumentation.ROUND_HOOKS with the sanitizer; each
    # appends its own callable, so neither perturbs the other's counts.
    _registry_mod.inc("rounds/" + name)
    handle = _ACTIVE
    if handle is not None and handle.alerts is not None:
        reg = _registry_mod.get()
        if reg is not None:
            # The engine pins its round axis to the first controller
            # name it sees, so nested note_rounds (trace replay + its
            # wrapped fleet) evaluate once per real round.
            handle.alerts.evaluate(reg, name)


def _sync_round_hook() -> None:
    """Keep exactly one telemetry entry in ROUND_HOOKS iff a metrics
    sink is attached (lazy core import: telemetry itself must stay
    importable without jax)."""
    global _ROUND_HOOK_INSTALLED
    want = _registry_mod.get() is not None
    if want == _ROUND_HOOK_INSTALLED:
        return
    from repro_torch.core import instrumentation
    if want:
        instrumentation.ROUND_HOOKS.append(_round_hook)
    else:
        instrumentation.ROUND_HOOKS.remove(_round_hook)
    _ROUND_HOOK_INSTALLED = want


def enable(metrics: MetricsRegistry | None = None,
           spans: SpanRecorder | None = None,
           meta: dict[str, Any] | None = None,
           series_capacity: int = 4096,
           span_capacity: int = 65536,
           provenance: FlightRecorder | None = None,
           alerts: AlertEngine | None = None,
           provenance_capacity: int = 8192) -> Telemetry:
    """Attach all sinks (metrics, spans, provenance flight recorder,
    alert engine with the default rules) and return the
    :class:`Telemetry` handle."""
    global _ACTIVE
    handle = Telemetry(
        metrics=metrics or MetricsRegistry(series_capacity=series_capacity),
        spans=spans or SpanRecorder(capacity=span_capacity),
        meta=dict(meta or {}),
        provenance=provenance or FlightRecorder(
            capacity=provenance_capacity),
        alerts=alerts or AlertEngine())
    _registry_mod.enable(handle.metrics)
    _spans_mod.enable(handle.spans)
    _provenance_mod.enable(handle.provenance)
    _ACTIVE = handle
    _sync_round_hook()
    return handle


def disable() -> Telemetry | None:
    """Detach all sinks; guarded call sites go dark again."""
    global _ACTIVE
    prev, _ACTIVE = _ACTIVE, None
    _registry_mod.disable()
    _spans_mod.disable()
    _provenance_mod.disable()
    _sync_round_hook()
    return prev


def get() -> Telemetry | None:
    return _ACTIVE


@contextmanager
def session(meta: dict[str, Any] | None = None,
            series_capacity: int = 4096,
            span_capacity: int = 65536,
            provenance_capacity: int = 8192) -> Iterator[Telemetry]:
    """Scoped telemetry window; restores whatever was armed before (so
    sessions nest — ``benchmarks/run.py`` wraps suites that may open
    their own)."""
    global _ACTIVE
    prev_active = _ACTIVE
    prev_metrics = _registry_mod.get()
    prev_spans = _spans_mod.get()
    prev_provenance = _provenance_mod.get()
    handle = enable(meta=meta, series_capacity=series_capacity,
                    span_capacity=span_capacity,
                    provenance_capacity=provenance_capacity)
    try:
        yield handle
    finally:
        if prev_metrics is not None:
            _registry_mod.enable(prev_metrics)
        else:
            _registry_mod.disable()
        if prev_spans is not None:
            _spans_mod.enable(prev_spans)
        else:
            _spans_mod.disable()
        if prev_provenance is not None:
            _provenance_mod.enable(prev_provenance)
        else:
            _provenance_mod.disable()
        _ACTIVE = prev_active
        _sync_round_hook()


def maybe_enable() -> Telemetry | None:
    """Enable iff ``REPRO_TELEMETRY=1`` (the ``repro_torch.core`` import-time
    seam, mirroring ``sanitize.maybe_install``)."""
    if enabled_by_env() and _ACTIVE is None:
        return enable(meta={"armed_by": ENV_FLAG})
    return _ACTIVE
