"""Tabu memory for the annealing chain.

Paper sec. 2.2: "annealing can be combined with other optimization methods,
e.g., where a memory of previously visited states and their performance is
maintained like in Tabu search."  Also sec. 5 suggests forcing moves toward
configurations "not tried in the recent past" as straggler mitigation.

This memory (a) discourages immediate revisits of recently-seen states and
(b) remembers the best objective seen per state, exposing cheap lookups for
the controller's diagnostics.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Callable


class TabuMemory:
    def __init__(self, horizon: int = 8, max_retries: int = 4):
        """``horizon``: how many most-recent states are tabu.
        ``max_retries``: proposal re-draws before giving up (annealing must
        remain irreducible, so the tabu filter is advisory, never absolute).
        """
        self.horizon = int(horizon)
        self.max_retries = int(max_retries)
        self._recent: OrderedDict[tuple[int, ...], int] = OrderedDict()
        self.best_seen: dict[tuple[int, ...], float] = {}
        self._clock = 0

    def visit(self, state: tuple[int, ...], y: float) -> None:
        self._clock += 1
        self._recent[state] = self._clock
        self._recent.move_to_end(state)
        while len(self._recent) > self.horizon:
            self._recent.popitem(last=False)
        prev = self.best_seen.get(state)
        if prev is None or y < prev:
            self.best_seen[state] = float(y)

    def is_tabu(self, state: tuple[int, ...]) -> bool:
        return state in self._recent

    def filter(
        self,
        current: tuple[int, ...],
        proposal: tuple[int, ...],
        redraw: Callable[[], tuple[int, ...]],
    ) -> tuple[int, ...]:
        """Re-draw tabu proposals up to max_retries times (advisory)."""
        p = proposal
        for _ in range(self.max_retries):
            if not self.is_tabu(p):
                return p
            p = redraw()
        return p

    def least_recently_tried(
        self, candidates: list[tuple[int, ...]]
    ) -> tuple[int, ...]:
        """Pick the candidate least recently visited (sec. 5 straggler rule:
        prefer configurations not tried in the recent past)."""
        def key(c: tuple[int, ...]) -> int:
            return self._recent.get(c, -1)
        return min(candidates, key=key)
