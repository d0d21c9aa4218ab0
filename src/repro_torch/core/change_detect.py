"""Workload-change detection driving temperature re-heats.

Paper sec. 1: "To respond to changes in availability of services and/or the
existing workload, the temperature can be dynamically increased resulting in
more exploration."  Sec. 4.3 demonstrates adaptation after an abrupt change
in the blend.  The paper does not commit to a detector; we provide a
*standardized* Page-Hinkley test (drift measured in running standard
deviations, so thresholds are scale-free — objective values span orders of
magnitude across configurations) plus a windowed z-score detector.  Either
drives :class:`repro_torch.core.schedules.AdaptiveReheat`; the controller also
invalidates the annealer's stale incumbent objective on re-heat (see
Annealer.reheat), which is what lets the chain move off an optimum whose
measured value predates the change.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np


@dataclasses.dataclass
class PageHinkley:
    """Two-sided standardized Page-Hinkley drift test.

    Tracks the stream's running mean/variance (Welford); accumulates the
    standardized deviation minus a ``delta`` margin, separately for upward
    and downward drifts; signals when either cumulative sum exceeds
    ``threshold`` (in sigma units), then resets.
    """

    delta: float = 0.2          # insensitivity margin, in sigmas
    threshold: float = 6.0      # cumulative sigma units to signal
    min_obs: int = 25           # observations before testing (stable std)
    z_clip: float = 6.0         # robustness: cap one observation's pull

    def __post_init__(self) -> None:
        self.reset()

    def reset(self) -> None:
        self._n = 0
        self._mean = 0.0
        self._m2 = 0.0
        self._up = 0.0
        self._down = 0.0

    def update(self, y: float) -> bool:
        """Feed one observation; True iff drift is signalled (then resets)."""
        self._n += 1
        d = y - self._mean
        self._mean += d / self._n
        self._m2 += d * (y - self._mean)
        if self._n < self.min_obs:
            return False
        std = math.sqrt(self._m2 / (self._n - 1)) + 1e-12
        z = max(-self.z_clip, min(self.z_clip, (y - self._mean) / std))
        self._up = max(0.0, self._up + z - self.delta)
        self._down = max(0.0, self._down - z - self.delta)
        if self._up > self.threshold or self._down > self.threshold:
            self.reset()
            return True
        return False


@dataclasses.dataclass
class BatchedPageHinkley:
    """:class:`PageHinkley` over B parallel streams, vectorized.

    Per-stream semantics are identical to the scalar detector (same Welford
    statistics, margins, clipping, per-stream reset on signal); the batch
    axis amortizes what would otherwise be B x steps Python-level
    ``update`` calls per fleet control round into a handful of numpy ops.
    Non-finite observations are skipped per stream (the fleet feeds
    chain-measured objectives, where proposals into masked-out states
    measure +inf).
    """

    n_streams: int
    delta: float = 0.2
    threshold: float = 6.0
    min_obs: int = 25
    z_clip: float = 6.0

    def __post_init__(self) -> None:
        if self.n_streams < 1:
            raise ValueError("n_streams must be >= 1")
        self.reset()

    def reset(self, mask: np.ndarray | None = None) -> None:
        """Reset all streams (mask=None) or the masked subset."""
        if mask is None:
            z = np.zeros(self.n_streams)
            self._n = np.zeros(self.n_streams, np.int64)
            self._mean, self._m2 = z.copy(), z.copy()
            self._up, self._down = z.copy(), z.copy()
            return
        self._n[mask] = 0
        for arr in (self._mean, self._m2, self._up, self._down):
            arr[mask] = 0.0

    def add_streams(self, k: int = 1) -> None:
        """Grow by ``k`` fresh streams (tenant arrivals): new streams start
        with empty statistics, existing streams keep theirs."""
        if k < 1:
            raise ValueError("k must be >= 1")
        self.n_streams += k
        self._n = np.concatenate([self._n, np.zeros(k, np.int64)])
        for name in ("_mean", "_m2", "_up", "_down"):
            setattr(self, name,
                    np.concatenate([getattr(self, name), np.zeros(k)]))

    def remove_stream(self, i: int) -> None:
        """Drop stream ``i`` (tenant departure); the others keep their
        statistics and indices shift down past ``i``."""
        if not (0 <= i < self.n_streams):
            raise IndexError(f"stream {i} out of range [0, {self.n_streams})")
        if self.n_streams == 1:
            raise ValueError("cannot remove the last stream")
        self.n_streams -= 1
        self._n = np.delete(self._n, i)
        for name in ("_mean", "_m2", "_up", "_down"):
            setattr(self, name, np.delete(getattr(self, name), i))

    def update(self, ys: np.ndarray) -> np.ndarray:
        """Feed one observation per stream; returns (B,) bool fired flags
        (fired streams reset, exactly like the scalar detector)."""
        y = np.asarray(ys, np.float64)
        if y.shape != (self.n_streams,):
            raise ValueError(f"expected ({self.n_streams},), got {y.shape}")
        ok = np.isfinite(y)
        y0 = np.where(ok, y, 0.0)
        self._n = self._n + ok
        d = np.where(ok, y0 - self._mean, 0.0)
        self._mean = self._mean + d / np.maximum(self._n, 1)
        self._m2 = self._m2 + d * np.where(ok, y0 - self._mean, 0.0)
        active = ok & (self._n >= self.min_obs)
        std = np.sqrt(self._m2 / np.maximum(self._n - 1, 1)) + 1e-12
        z = np.clip((y0 - self._mean) / std, -self.z_clip, self.z_clip)
        self._up = np.where(
            active, np.maximum(0.0, self._up + z - self.delta), self._up)
        self._down = np.where(
            active, np.maximum(0.0, self._down - z - self.delta), self._down)
        fired = active & ((self._up > self.threshold)
                          | (self._down > self.threshold))
        if fired.any():
            self.reset(fired)
        return fired


@dataclasses.dataclass
class WindowedZScore:
    """Signals when the recent-window mean departs from the long-run mean by
    more than ``z`` long-run standard deviations."""

    window: int = 16
    z: float = 4.0
    min_history: int = 32

    def __post_init__(self) -> None:
        self._values: list[float] = []

    def update(self, y: float) -> bool:
        self._values.append(float(y))
        v = self._values
        if len(v) < max(self.min_history, 2 * self.window):
            return False
        hist = v[: -self.window]
        recent = v[-self.window :]
        mu = sum(hist) / len(hist)
        var = sum((x - mu) ** 2 for x in hist) / max(len(hist) - 1, 1)
        sd = math.sqrt(var) + 1e-12
        zscore = abs(sum(recent) / len(recent) - mu) / (sd / math.sqrt(self.window))
        if zscore > self.z:
            self._values = v[-self.window :]
            return True
        return False
