"""Nested wall-clock span tracing with Chrome/Perfetto export.

The timing half of the telemetry layer: ``with span("fleet.round"):``
around a control-loop phase records one complete ("ph": "X") trace
event — start, duration, thread, nesting depth — into a fixed-capacity
ring.  :meth:`SpanRecorder.write` emits the standard Chrome
``trace_event`` JSON object format, loadable in Perfetto
(https://ui.perfetto.dev) or ``chrome://tracing``, so "where did round
87's wall-clock go" is a zoom, not a print-statement archaeology dig.

Hot-path contract: with no recorder attached (and no ``metric=``
requested), :func:`span` returns the shared :data:`_NULL_SPAN` singleton
— one global load, one truth test, zero allocation.  Tests assert that
identity, not a timing, so the overhead guard cannot flake.

Spans nest lexically per thread: the recorder keeps a thread-local depth
stack, so the exported events reconstruct the measure / refit / anneal /
arbitrate / ledger phase tree of every controller round.  ``metric=``
additionally funnels each span's duration (seconds) into a
:mod:`repro_torch.telemetry.registry` histogram of that name — one code site
feeds both the trace and the dashboard.
"""

from __future__ import annotations

import functools
import json
import threading
import time
from typing import Any, Callable

from . import registry as _registry

__all__ = [
    "SpanRecorder", "span", "traced", "enable", "disable", "get",
]

# One process-wide monotonic epoch so events from every thread share a
# timeline; Perfetto wants microseconds from an arbitrary origin.
_T0 = time.perf_counter()


class SpanRecorder:
    """Fixed-capacity ring of completed spans.

    Each record is ``(name, cat, ts_us, dur_us, tid, depth, args)``.
    When the ring is full the oldest span is overwritten (``dropped``
    counts casualties) — a long replay keeps its most recent window,
    which is the one you want to look at anyway.
    """

    def __init__(self, capacity: int = 65536):
        if capacity < 1:
            raise ValueError("capacity must be >= 1")
        self.capacity = int(capacity)
        self._lock = threading.Lock()
        self._ring: list[tuple] = [()] * self.capacity
        self._idx = 0
        self._total = 0
        self._local = threading.local()
        self._tids: dict[int, int] = {}     # thread ident -> small int

    # -- recording (called from _Span.__exit__) ------------------------

    def _depth_stack(self) -> list:
        st = getattr(self._local, "stack", None)
        if st is None:
            st = self._local.stack = []
        return st

    def _tid(self) -> int:
        ident = threading.get_ident()
        tid = self._tids.get(ident)
        if tid is None:
            with self._lock:
                tid = self._tids.setdefault(ident, len(self._tids))
        return tid

    def _record(self, name: str, cat: str, t_start: float, t_end: float,
                depth: int, args: dict | None) -> None:
        rec = (name, cat, (t_start - _T0) * 1e6,
               (t_end - t_start) * 1e6, self._tid(), depth, args)
        with self._lock:
            self._ring[self._idx] = rec
            self._idx = (self._idx + 1) % self.capacity
            self._total += 1

    # -- introspection / export ----------------------------------------

    @property
    def dropped(self) -> int:
        return max(0, self._total - self.capacity)

    def spans(self) -> list[tuple]:
        """Completed spans, oldest first."""
        with self._lock:
            n = min(self._total, self.capacity)
            if self._total <= self.capacity:
                return list(self._ring[:n])
            i = self._idx
            return self._ring[i:] + self._ring[:i]

    def to_trace_events(self, pid: int = 1) -> list[dict[str, Any]]:
        """Chrome ``trace_event`` dicts: one ``"M"`` thread-name metadata
        event per thread, then a complete ``"X"`` event per span."""
        with self._lock:
            tids = dict(self._tids)
        events: list[dict[str, Any]] = [
            {"name": "thread_name", "ph": "M", "pid": pid, "tid": tid,
             "args": {"name": "main" if tid == 0 else f"worker-{tid}"}}
            for tid in sorted(tids.values())]
        for name, cat, ts, dur, tid, depth, args in self.spans():
            ev: dict[str, Any] = {
                "name": name, "cat": cat or "repro", "ph": "X",
                "ts": ts, "dur": dur, "pid": pid, "tid": tid,
            }
            if args:
                ev["args"] = dict(args)
            events.append(ev)
        return events

    def write(self, path: str, pid: int = 1) -> None:
        """Write the Perfetto-loadable JSON object format."""
        payload = {"traceEvents": self.to_trace_events(pid=pid),
                   "displayTimeUnit": "ms"}
        with open(path, "w") as f:
            json.dump(payload, f)

    def summary(self) -> dict[str, dict[str, float]]:
        """Per-span-name count / total / mean milliseconds (over the
        retained window)."""
        out: dict[str, dict[str, float]] = {}
        for name, _cat, _ts, dur, _tid, _depth, _args in self.spans():
            st = out.setdefault(name, {"count": 0, "total_ms": 0.0})
            st["count"] += 1
            st["total_ms"] += dur / 1e3
        for st in out.values():
            st["mean_ms"] = st["total_ms"] / st["count"]
        return out

    def reset(self) -> None:
        with self._lock:
            self._idx = 0
            self._total = 0


# ---------------------------------------------------------------------------
# The guarded entry points.
# ---------------------------------------------------------------------------


class _NullSpan:
    """Disabled-path span: a shared, reusable, do-nothing context
    manager.  :func:`span` returns this exact singleton whenever nothing
    is recording — the overhead-guard test asserts the identity."""

    __slots__ = ()

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc) -> None:
        return None


_NULL_SPAN = _NullSpan()


class _Span:
    """Live span handle; records into the recorder (and optionally a
    duration histogram) on exit."""

    __slots__ = ("_name", "_cat", "_metric", "_args", "_rec", "_t0",
                 "_depth")

    def __init__(self, name: str, cat: str, metric: str | None,
                 args: dict | None, rec: "SpanRecorder | None"):
        self._name = name
        self._cat = cat
        self._metric = metric
        self._args = args
        self._rec = rec

    def __enter__(self) -> "_Span":
        rec = self._rec
        if rec is not None:
            stack = rec._depth_stack()
            self._depth = len(stack)
            stack.append(self._name)
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        t1 = time.perf_counter()
        rec = self._rec
        if rec is not None:
            rec._depth_stack().pop()
            rec._record(self._name, self._cat, self._t0, t1,
                        self._depth, self._args)
        if self._metric is not None:
            _registry.observe(self._metric, t1 - self._t0)
        return None


_RECORDER: SpanRecorder | None = None


def enable(recorder: SpanRecorder | None = None) -> SpanRecorder:
    """Attach ``recorder`` (or a fresh one) as the process span sink.
    Prefer ``repro_torch.telemetry.enable()``, which arms metrics too."""
    global _RECORDER
    _RECORDER = recorder if recorder is not None else SpanRecorder()
    return _RECORDER


def disable() -> SpanRecorder | None:
    global _RECORDER
    prev, _RECORDER = _RECORDER, None
    return prev


def get() -> SpanRecorder | None:
    return _RECORDER


def span(name: str, cat: str = "", metric: str | None = None,
         args: dict | None = None):
    """Context manager timing a phase.

    Records a trace event when a recorder is attached; when ``metric``
    is given, also observes the duration (seconds) into that metrics
    histogram whenever a metrics sink is attached.  With neither sink
    relevant, returns the no-op singleton.
    """
    rec = _RECORDER
    if rec is None and (metric is None or _registry._SINK is None):
        return _NULL_SPAN
    return _Span(name, cat, metric, args, rec)


def traced(name: str | None = None, cat: str = "",
           metric: str | None = None) -> Callable:
    """Decorator form of :func:`span`; defaults to the function's
    qualified name."""

    def deco(fn: Callable) -> Callable:
        label = name or fn.__qualname__

        @functools.wraps(fn)
        def wrapper(*a, **kw):
            with span(label, cat=cat, metric=metric):
                return fn(*a, **kw)

        return wrapper

    return deco
