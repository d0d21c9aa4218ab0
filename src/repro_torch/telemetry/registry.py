"""Process-local metrics registry: counters, gauges, ring-buffer series.

The runtime observability layer's storage half (spans live in
:mod:`repro_torch.telemetry.spans`).  Unlike the opt-in correctness gates in
:mod:`repro.analysis` — which *patch* the code they watch and may abort a
run — this layer is plain passive recording, cheap enough to leave on:
everything instrumented in :mod:`repro_torch.core` writes through the guarded
module functions below (:func:`inc` / :func:`set_gauge` / :func:`record`
/ :func:`observe`), which compile to one global load plus a truth test
when no sink is attached — the same hot-path contract as
``repro_torch.core.instrumentation``'s hook lists.  Attach a sink with
:func:`enable` (or ``repro_torch.telemetry.enable()``, which arms spans too)
and the same calls start recording.

Four metric kinds, each in its own namespace:

* :class:`Counter` — monotone accumulator (thread-safe: the evaluation
  runtime lands measurements from worker pools);
* :class:`Gauge` — last-written value (ledger utilization, store size);
* :class:`Series` — FIXED-SIZE ring buffer of ``(t, value)`` points, the
  per-round dashboards' feed (objective / cost / SLO per control round);
  old points fall off the far end, so a million-round replay holds
  memory constant;
* :class:`Histogram` — running count/sum/min/max plus a fixed-size
  reservoir ring of raw observations for percentile estimates (dispatch
  latency, refit time).

``lock_factory`` exists so tests can substitute the race detector's
``TrackedLock`` (:mod:`repro.analysis.racecheck`) and verify the
counters' thread-safety claim instead of trusting it.
"""

from __future__ import annotations

import threading
from typing import Any, Callable, Mapping

__all__ = [
    "Counter", "Gauge", "Series", "Histogram", "MetricsRegistry",
    "enable", "disable", "get", "inc", "set_gauge", "record", "observe",
]


class Counter:
    """Monotone accumulator; ``inc`` is thread-safe."""

    __slots__ = ("name", "_lock", "_value")

    def __init__(self, name: str,
                 lock_factory: Callable[[], Any] = threading.Lock):
        self.name = name
        self._lock = lock_factory()
        self._value = 0.0

    def inc(self, k: float = 1.0) -> None:
        with self._lock:
            self._value += k

    @property
    def value(self) -> float:
        with self._lock:
            return self._value


class Gauge:
    """Last-written value."""

    __slots__ = ("name", "_lock", "_value")

    def __init__(self, name: str,
                 lock_factory: Callable[[], Any] = threading.Lock):
        self.name = name
        self._lock = lock_factory()
        self._value = 0.0

    def set(self, value: float) -> None:
        with self._lock:
            self._value = float(value)

    @property
    def value(self) -> float:
        with self._lock:
            return self._value


class Series:
    """Fixed-capacity ring of ``(t, value)`` points; appends past the
    capacity overwrite the oldest point (``dropped`` counts them).  ``t``
    defaults to the running append index, which for per-round series is
    the control round."""

    __slots__ = ("name", "capacity", "_lock", "_t", "_v", "_idx", "_total")

    def __init__(self, name: str, capacity: int = 4096,
                 lock_factory: Callable[[], Any] = threading.Lock):
        if capacity < 1:
            raise ValueError("capacity must be >= 1")
        self.name = name
        self.capacity = int(capacity)
        self._lock = lock_factory()
        self._t: list[float] = [0.0] * self.capacity
        self._v: list[float] = [0.0] * self.capacity
        self._idx = 0           # next write slot
        self._total = 0         # lifetime appends

    def append(self, value: float, t: float | None = None) -> None:
        with self._lock:
            self._t[self._idx] = (float(self._total) if t is None
                                  else float(t))
            self._v[self._idx] = float(value)
            self._idx = (self._idx + 1) % self.capacity
            self._total += 1

    def __len__(self) -> int:
        with self._lock:
            return min(self._total, self.capacity)

    @property
    def dropped(self) -> int:
        with self._lock:
            return max(0, self._total - self.capacity)

    def points(self) -> tuple[list[float], list[float]]:
        """(times, values), oldest first."""
        with self._lock:
            n = min(self._total, self.capacity)
            if self._total <= self.capacity:
                return list(self._t[:n]), list(self._v[:n])
            i = self._idx
            return (self._t[i:] + self._t[:i], self._v[i:] + self._v[:i])

    def values(self) -> list[float]:
        return self.points()[1]


class Histogram:
    """Running count/sum/min/max plus a reservoir ring of the most recent
    raw observations for percentile estimates."""

    __slots__ = ("name", "capacity", "_lock", "_ring", "_idx",
                 "count", "total", "_min", "_max")

    def __init__(self, name: str, capacity: int = 1024,
                 lock_factory: Callable[[], Any] = threading.Lock):
        if capacity < 1:
            raise ValueError("capacity must be >= 1")
        self.name = name
        self.capacity = int(capacity)
        self._lock = lock_factory()
        self._ring: list[float] = [0.0] * self.capacity
        self._idx = 0
        self.count = 0
        self.total = 0.0
        self._min = float("inf")
        self._max = float("-inf")

    def observe(self, value: float) -> None:
        v = float(value)
        with self._lock:
            self._ring[self._idx] = v
            self._idx = (self._idx + 1) % self.capacity
            self.count += 1
            self.total += v
            self._min = min(self._min, v)
            self._max = max(self._max, v)

    def summary(self) -> dict[str, float]:
        with self._lock:
            if self.count == 0:
                return {"count": 0, "total": 0.0, "mean": 0.0,
                        "min": 0.0, "max": 0.0, "p50": 0.0, "p90": 0.0,
                        "p99": 0.0}
            n = min(self.count, self.capacity)
            sample = sorted(self._ring[:n] if self.count <= self.capacity
                            else self._ring)

            def pct(q: float) -> float:
                return sample[min(int(q * (len(sample) - 1) + 0.5),
                                  len(sample) - 1)]

            return {
                "count": self.count, "total": self.total,
                "mean": self.total / self.count,
                "min": self._min, "max": self._max,
                "p50": pct(0.50), "p90": pct(0.90), "p99": pct(0.99),
            }


class MetricsRegistry:
    """Process-local named metrics, get-or-create per kind.

    Each kind lives in its own namespace (a counter and a series may
    share a name).  :meth:`snapshot` returns a plain-JSON dict — the
    ``TELEMETRY_*.json`` payload and the input of
    ``python -m repro_torch.telemetry.report``.
    """

    def __init__(self, series_capacity: int = 4096,
                 histogram_capacity: int = 1024,
                 lock_factory: Callable[[], Any] = threading.Lock):
        self.series_capacity = int(series_capacity)
        self.histogram_capacity = int(histogram_capacity)
        self._lock_factory = lock_factory
        self._lock = lock_factory()
        self._counters: dict[str, Counter] = {}
        self._gauges: dict[str, Gauge] = {}
        self._series: dict[str, Series] = {}
        self._histograms: dict[str, Histogram] = {}

    def _get(self, table: dict, name: str, factory: Callable[[], Any]):
        obj = table.get(name)
        if obj is None:
            with self._lock:
                obj = table.get(name)
                if obj is None:
                    obj = table[name] = factory()
        return obj

    def counter(self, name: str) -> Counter:
        return self._get(self._counters, name,
                         lambda: Counter(name, self._lock_factory))

    def gauge(self, name: str) -> Gauge:
        return self._get(self._gauges, name,
                         lambda: Gauge(name, self._lock_factory))

    def series(self, name: str, capacity: int | None = None) -> Series:
        return self._get(
            self._series, name,
            lambda: Series(name, capacity or self.series_capacity,
                           self._lock_factory))

    def histogram(self, name: str, capacity: int | None = None) -> Histogram:
        return self._get(
            self._histograms, name,
            lambda: Histogram(name, capacity or self.histogram_capacity,
                              self._lock_factory))

    def peek(self, kind: str, name: str):
        """Read-only lookup: the named metric of ``kind`` (``counter`` /
        ``gauge`` / ``series`` / ``histogram``) or ``None`` — unlike the
        get-or-create accessors, never conjures a metric into being.
        The alert engine's read path."""
        table = {"counter": self._counters, "gauge": self._gauges,
                 "series": self._series, "histogram": self._histograms}[kind]
        return table.get(name)

    def snapshot(self, prefix: str | None = None) -> dict[str, Any]:
        """JSON-serializable dump of everything recorded.  ``prefix``
        keeps only metrics whose name is ``prefix`` or starts with
        ``prefix + "/"`` — the per-controller view ``stats()`` embeds."""

        def keep(name: str) -> bool:
            return (prefix is None or name == prefix
                    or name.startswith(prefix + "/"))

        with self._lock:
            counters = dict(self._counters)
            gauges = dict(self._gauges)
            series = dict(self._series)
            histograms = dict(self._histograms)
        out: dict[str, Any] = {
            "counters": {n: c.value for n, c in counters.items()
                         if keep(n)},
            "gauges": {n: g.value for n, g in gauges.items() if keep(n)},
            "series": {},
            "histograms": {n: h.summary() for n, h in histograms.items()
                           if keep(n)},
        }
        for n, s in series.items():
            if keep(n):
                t, v = s.points()
                out["series"][n] = {"t": t, "v": v, "dropped": s.dropped}
        return out

    def reset(self) -> None:
        with self._lock:
            self._counters.clear()
            self._gauges.clear()
            self._series.clear()
            self._histograms.clear()


# ---------------------------------------------------------------------------
# The module sink + guarded write-through functions (the hot-path seam).
# ---------------------------------------------------------------------------

_SINK: MetricsRegistry | None = None


def enable(registry: MetricsRegistry | None = None) -> MetricsRegistry:
    """Attach ``registry`` (or a fresh one) as the process sink and
    return it.  Prefer ``repro_torch.telemetry.enable()``, which arms spans
    and the round-counting hook too."""
    global _SINK
    _SINK = registry if registry is not None else MetricsRegistry()
    return _SINK


def disable() -> MetricsRegistry | None:
    """Detach (and return) the current sink; guarded writes become
    no-ops again."""
    global _SINK
    prev, _SINK = _SINK, None
    return prev


def get() -> MetricsRegistry | None:
    return _SINK


def inc(name: str, k: float = 1.0) -> None:
    reg = _SINK
    if reg is not None:
        reg.counter(name).inc(k)


def set_gauge(name: str, value: float) -> None:
    reg = _SINK
    if reg is not None:
        reg.gauge(name).set(value)


def record(name: str, value: float, t: float | None = None) -> None:
    reg = _SINK
    if reg is not None:
        reg.series(name).append(value, t)


def observe(name: str, value: float) -> None:
    reg = _SINK
    if reg is not None:
        reg.histogram(name).observe(value)
