"""Neighborhood functions for the annealing chain.

Paper sec. 2.2: a local neighborhood function ``nu(x)`` with ``x not in
nu(x)`` whose induced transition graph must be *connected* (the base chain
irreducible) and, for the Gibbs stationary-distribution property at fixed
temperature, the base chain should be time-reversible — satisfied by the
symmetric +-1 coordinate moves used here (|nu(x)| varies at the boundary;
the Metropolis correction for unequal neighborhood sizes is handled in
:mod:`repro_torch.core.annealing`).

Moves are incremental: ``z = x +- e_v`` on a single dimension v (paper
sec. 3), which keeps reconfiguration cheap — important when each transition
re-provisions a live cluster.
"""

from __future__ import annotations

from collections import deque
from typing import Protocol, Sequence

import numpy as np
import torch

from .state import ConfigSpace


class Neighborhood(Protocol):
    def neighbors(self, idx: tuple[int, ...]) -> list[tuple[int, ...]]:
        """All valid neighbors of idx (excluding idx)."""
        ...

    def propose(
        self, idx: tuple[int, ...], rng: np.random.Generator
    ) -> tuple[int, ...]:
        """Sample one neighbor uniformly."""
        ...


class StepNeighborhood:
    """+-1 moves on a single dimension, restricted to the valid region.

    ``wrap_dims`` lists dimensions treated as cyclic (useful for categorical
    axes where wrapping removes the boundary — at the cost of adjacency
    between the extreme values, cf. the paper's ordering remark).
    """

    def __init__(self, space: ConfigSpace, wrap_dims: Sequence[str] = ()):
        self.space = space
        self._wrap = {space.names.index(n) for n in wrap_dims}

    def _moves(self, idx: tuple[int, ...]) -> list[tuple[int, ...]]:
        out = []
        for d in range(len(idx)):
            n = self.space.shape[d]
            for delta in (-1, +1):
                j = idx[d] + delta
                if d in self._wrap:
                    j %= n
                if 0 <= j < n and j != idx[d]:
                    cand = idx[:d] + (j,) + idx[d + 1 :]
                    out.append(cand)
        return out

    def neighbors(self, idx: tuple[int, ...]) -> list[tuple[int, ...]]:
        return [c for c in self._moves(idx) if self.space.contains(c)]

    def propose(
        self, idx: tuple[int, ...], rng: np.random.Generator
    ) -> tuple[int, ...]:
        nbrs = self.neighbors(idx)
        if not nbrs:
            raise RuntimeError(f"state {idx} has no valid neighbors")
        return nbrs[rng.integers(len(nbrs))]


class BlockNeighborhood(StepNeighborhood):
    """Step moves plus occasional larger jumps on one dimension.

    The paper notes incremental one-step changes are "typical but not a
    requirement".  With probability ``p_jump`` the proposal moves up to
    ``max_step`` on the chosen dimension — useful for very wide dimensions
    (e.g. chip counts) while remaining symmetric (reversible).
    """

    def __init__(
        self,
        space: ConfigSpace,
        p_jump: float = 0.1,
        max_step: int = 4,
        wrap_dims: Sequence[str] = (),
    ):
        super().__init__(space, wrap_dims)
        self.p_jump = float(p_jump)
        self.max_step = int(max_step)

    def neighbors(self, idx: tuple[int, ...]) -> list[tuple[int, ...]]:
        out = []
        seen = set()
        for d in range(len(idx)):
            n = self.space.shape[d]
            for step in range(1, self.max_step + 1):
                for delta in (-step, +step):
                    j = idx[d] + delta
                    if d in self._wrap:
                        j %= n
                    if 0 <= j < n and j != idx[d]:
                        cand = idx[:d] + (j,) + idx[d + 1 :]
                        if cand not in seen and self.space.contains(cand):
                            seen.add(cand)
                            out.append(cand)
        return out

    def propose(
        self, idx: tuple[int, ...], rng: np.random.Generator
    ) -> tuple[int, ...]:
        if rng.random() >= self.p_jump:
            return StepNeighborhood.propose(self, idx, rng)
        nbrs = self.neighbors(idx)
        if not nbrs:
            raise RuntimeError(f"state {idx} has no valid neighbors")
        return nbrs[rng.integers(len(nbrs))]


# ---------------------------------------------------------------------------
# Batched proposal step (consumed by repro_torch.core.annealing.anneal_fleet).
# ---------------------------------------------------------------------------


def propose_nd(
    x: torch.Tensor,
    axis: torch.Tensor,
    up: torch.Tensor,
    pick: torch.Tensor,
    sizes: torch.Tensor,
    categorical: torch.Tensor,
) -> torch.Tensor:
    """One proposal per chain: the batched counterpart of
    :meth:`StepNeighborhood.propose`.

    ``x`` is (C, ndim) int64 index vectors; ``axis`` (C,) the drawn axis,
    ``up`` (C,) bool the drawn direction (True is +1), ``pick`` (C,) the
    categorical draw in ``[0, max(n - 1, 1))`` for the drawn axis's size
    ``n``; ``sizes`` (ndim,) int64 and ``categorical`` (ndim,) bool
    describe the space.  Ordinal axes move +-1 with boundary reflection
    (clamped, so size-1 axes stay put); categorical axes resample
    uniformly among the *other* values.  Both moves are symmetric, so the
    base chain stays reversible.

    Validity is NOT checked here — the chain rejects invalid proposals via
    the :class:`repro_torch.core.state.EncodedSpace` mask, which preserves
    detailed balance (a masked move is a zero-acceptance Metropolis step).
    """
    n = sizes[axis]
    cur = x.gather(1, axis[:, None])[:, 0]
    delta = torch.where(up, 1, -1).to(x.dtype)
    hi = n - 1
    z = torch.minimum(torch.clamp(cur + delta, min=0), hi)
    z = torch.where(z == cur, cur - delta, z)      # reflect at the boundary
    z_ord = torch.minimum(torch.clamp(z, min=0), hi)   # size-1 axis: stays
    # uniform over the n-1 other values: ``pick`` in [0, n-1), skip `cur`
    z_cat = torch.where(pick >= cur, pick + 1, pick)
    z_cat = torch.where(n > 1, z_cat, cur)
    new = torch.where(categorical[axis], z_cat, z_ord)
    return x.scatter(1, axis[:, None], new[:, None])


def row_major_strides(shape: Sequence[int]) -> list[int]:
    """Row-major strides of ``shape`` (pure Python)."""
    strides = [1] * len(shape)
    for d in range(len(shape) - 2, -1, -1):
        strides[d] = strides[d + 1] * shape[d + 1]
    return strides


def flat_index(x: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """Row-major flat index of (..., ndim) index vectors ``x``."""
    strides = torch.tensor(row_major_strides(shape), dtype=torch.int64,
                           device=x.device)
    return (x.to(torch.int64) * strides).sum(-1)


def check_connected(space: ConfigSpace, nbhd: Neighborhood) -> bool:
    """BFS over the valid region; True iff the move graph is connected.

    The paper calls this a *key requirement* of nu.  Intended for the small
    spaces used in tests and the paper-reproduction benchmarks.
    """
    states = space.valid_states()
    if not states:
        return False
    index = {s: i for i, s in enumerate(states)}
    seen = {states[0]}
    q = deque([states[0]])
    while q:
        s = q.popleft()
        for t in nbhd.neighbors(s):
            if t in index and t not in seen:
                seen.add(t)
                q.append(t)
    return len(seen) == len(states)
