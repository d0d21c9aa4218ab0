"""Fault tolerance: failure injection, supervised step execution, restart.

A copy of the reference package's ``runtime/fault_tolerance.py`` (stdlib
and numpy), pinned to it by ``tests/test_torch_numpy_copies.py``.

At thousand-node scale the controller must assume steps *will* fail
(preemption, link flap, kernel panic).  The pattern implemented here is
the standard one:

    supervisor loop:
        run step -> on failure: restore last committed checkpoint,
        rebuild the jitted step (possibly on a smaller/different mesh —
        elastic re-shard), replay the data pipeline to the restored step,
        continue.

``FailureInjector`` drives deterministic chaos in tests and examples
(probability per step, or scripted step indices).  ``Supervisor`` owns
the retry/restore policy around an opaque step callable; it is used by
launch/train.py and exercised with real checkpoints in the tests
(kill at step k -> bitwise-identical continuation vs an uninterrupted
run, including the data order).
"""

from __future__ import annotations

import dataclasses
import logging
import time
from typing import Any, Callable

log = logging.getLogger("repro_torch.fault")


class StepFailure(RuntimeError):
    """Injected (or wrapped real) step failure."""


@dataclasses.dataclass
class FailureInjector:
    """Deterministic failure schedule: explicit steps and/or a rate."""

    fail_steps: tuple[int, ...] = ()
    rate: float = 0.0
    seed: int = 0

    def __post_init__(self) -> None:
        import numpy as np
        self._rng = np.random.default_rng(self.seed)
        self._already: set[int] = set()

    def check(self, step: int) -> None:
        if step in self.fail_steps and step not in self._already:
            self._already.add(step)
            raise StepFailure(f"injected failure at step {step}")
        if self.rate > 0 and self._rng.random() < self.rate:
            raise StepFailure(f"injected random failure at step {step}")


@dataclasses.dataclass
class Supervisor:
    """Run-with-restart wrapper.

    ``restore(step|None) -> (state, step)`` rebuilds state from the last
    committed checkpoint (None = latest).  ``on_restart`` lets the caller
    rebuild jitted functions / pipelines.  ``max_restarts`` bounds flaky
    loops; restart counting resets after ``reset_after`` clean steps.
    """

    restore: Callable[[], tuple[Any, int]]
    on_restart: Callable[[int], None] | None = None
    max_restarts: int = 8
    reset_after: int = 100

    def __post_init__(self) -> None:
        self.restarts = 0
        self._clean = 0
        self.events: list[dict] = []

    def run(self, state: Any, start_step: int, n_steps: int,
            step_fn: Callable[[Any, int], Any]) -> tuple[Any, int]:
        """Advance n_steps; step_fn(state, step) -> state (may raise)."""
        step = start_step
        target = start_step + n_steps
        while step < target:
            try:
                state = step_fn(state, step)
                step += 1
                self._clean += 1
                if self._clean >= self.reset_after:
                    self.restarts, self._clean = 0, 0
            except StepFailure as e:
                self.restarts += 1
                self._clean = 0
                self.events.append({"step": step, "error": str(e),
                                    "t": time.time()})
                log.warning("step %d failed (%s); restart %d/%d",
                            step, e, self.restarts, self.max_restarts)
                if self.restarts > self.max_restarts:
                    raise RuntimeError("restart budget exhausted") from e
                state, step = self.restore()
                if self.on_restart is not None:
                    self.on_restart(step)
        return state, step
