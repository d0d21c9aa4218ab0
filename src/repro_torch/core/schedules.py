"""Temperature schedules.

The paper emphasizes (sec. 2.2, citing Hajek & Sasaki) that for finite
horizons and time-varying workloads it is often better *not* to cool: run at
a fixed positive temperature (Gibbs stationary distribution prop. to
exp(-Y/tau)), and *raise* the temperature when the workload or the service
offerings change (sec. 1, sec. 4.3).  All schedules expose

    tau = schedule(n)          # temperature for job n
    schedule.reheat(n)         # notify: change detected at job n
"""

from __future__ import annotations

import copy
import dataclasses
import math
from typing import Iterable

import numpy as np


class Schedule:
    def __call__(self, n: int) -> float:
        raise NotImplementedError

    def reheat(self, n: int) -> None:  # default: no-op
        return None

    def tau_array(self, n0: int, n_steps: int) -> np.ndarray:
        """``[tau(n0), ..., tau(n0 + n_steps - 1)]`` without firing any
        reheats (cf. :func:`schedule_to_array`, which replays them).
        Subclasses with a closed form override this — the fleet controller
        materializes T schedules per control round."""
        return np.asarray([self(n) for n in range(n0, n0 + n_steps)],
                          np.float64)


@dataclasses.dataclass
class FixedTemperature(Schedule):
    """The paper's primary online mode: constant tau > 0."""

    tau: float

    def __post_init__(self) -> None:
        if self.tau <= 0:
            raise ValueError("tau must be > 0")

    def __call__(self, n: int) -> float:
        return self.tau


@dataclasses.dataclass
class LogCooling(Schedule):
    """Classical tau_n = c / log(n + n0): converges in probability to the
    global minimum (Aarts & Korst), cited by the paper as 'not very useful
    in practice' — provided for the offline mode and for comparison runs."""

    c: float
    n0: int = 2

    def __call__(self, n: int) -> float:
        return self.c / math.log(n + self.n0)


@dataclasses.dataclass
class GeometricCooling(Schedule):
    """tau_n = tau0 * gamma^n, floored at tau_min."""

    tau0: float
    gamma: float = 0.995
    tau_min: float = 1e-6

    def __call__(self, n: int) -> float:
        return max(self.tau0 * (self.gamma ** n), self.tau_min)


@dataclasses.dataclass
class AdaptiveReheat(Schedule):
    """Fixed base temperature with exponentially-decaying reheats.

    On a detected workload/offering change at job n0, temperature jumps to
    ``tau_hot`` and relaxes geometrically back to ``tau_base`` — the paper's
    'temperature can be dynamically increased resulting in more exploration'
    made concrete.
    """

    tau_base: float
    tau_hot: float
    relax: float = 0.9      # per-job decay factor of the excess temperature

    def __post_init__(self) -> None:
        if self.tau_hot < self.tau_base:
            raise ValueError("tau_hot must be >= tau_base")
        self._reheat_at: int | None = None

    def __call__(self, n: int) -> float:
        if self._reheat_at is None or n < self._reheat_at:
            return self.tau_base
        k = n - self._reheat_at
        return self.tau_base + (self.tau_hot - self.tau_base) * (self.relax ** k)

    def reheat(self, n: int) -> None:
        self._reheat_at = n

    def tau_array(self, n0: int, n_steps: int) -> np.ndarray:
        ns = np.arange(n0, n0 + n_steps, dtype=np.float64)
        if self._reheat_at is None:
            return np.full(n_steps, self.tau_base)
        k = np.maximum(ns - self._reheat_at, 0.0)
        out = self.tau_base + (self.tau_hot - self.tau_base) * self.relax ** k
        return np.where(ns < self._reheat_at, self.tau_base, out)


def schedule_to_array(
    schedule: Schedule | float,
    n_steps: int,
    reheats: Iterable[int] = (),
) -> np.ndarray:
    """Materialize ``tau_n`` for ``n = 0..n_steps-1`` as an array.

    The compiled chain (:func:`repro_torch.core.annealing.anneal_chain_nd`)
    consumes temperatures as data, so stateful schedules — including
    reheat events at known job indices — are exported up front.
    ``reheats`` lists the indices where ``schedule.reheat(n)`` fires before
    ``tau(n)`` is read.  The schedule is deep-copied: exporting never
    mutates the caller's (possibly live, online) schedule object.
    """
    if isinstance(schedule, (int, float)):
        return np.full(n_steps, float(schedule))
    s = copy.deepcopy(schedule)
    fire = frozenset(int(r) for r in reheats)
    out = np.empty(n_steps, np.float64)
    for n in range(n_steps):
        if n in fire:
            s.reheat(n)
        out[n] = s(n)
    return out
