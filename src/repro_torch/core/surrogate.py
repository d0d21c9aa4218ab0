"""Surrogate objective: tables for spaces too large to tabulate.

The chain engine (:func:`repro_torch.core.annealing.anneal_fleet`)
consumes *tables*, and :func:`repro_torch.core.landscape.tabulate`
hard-caps the product at 200k states.  The paper's online algorithm never
needed the full table: it only ever measures the configurations it
visits.  This module learns a cheap predictive model from sparse
measurements and interpolates the rest.

Pieces (the slice of the reference module the sizing controller runs):

* :class:`MeasurementStore` — (state, objective, timestamp) observations
  with recency decay and latest-wins-per-state semantics.  numpy, a copy
  of the reference's.

* :class:`SpaceEncoding` + :class:`SurrogateModel` — batched
  inverse-distance / RBF interpolation over the mixed ordinal-categorical
  encoding: ordinal axes become [0, 1]-scaled coordinates, categorical
  axes one-hot / sqrt(2), so ONE Euclidean distance carries both metrics.
  :meth:`SurrogateModel.predict` runs on ``device`` through the fused
  interpolation kernel (:func:`repro_torch.kernels.ops.fused_interp`; the
  hand CUDA kernel on the card, its plain version on the CPU) and returns
  estimates AND an uncertainty channel (distance to the nearest
  measurement, scaled to objective units).

* :class:`ObjectiveSource` — the injectable "where do objective tables
  come from" seam for the controllers: :class:`ExhaustiveSource` wraps
  :func:`tabulate` (one real evaluation per valid state),
  :class:`SurrogateSource` probes a sparse sample and interpolates the
  rest.  Probes are drawn with numpy from the source's seed, so the port
  and the reference probe the same states.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Sequence

import numpy as np
import torch

from ..device import resolve_device
from ..kernels import ops as kernel_ops
from .instrumentation import race_access
from .landscape import tabulate
from .state import ConfigSpace, Dimension, EncodedSpace, random_valid_state


# ---------------------------------------------------------------------------
# Feature embedding of the mixed ordinal-categorical index space.
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class SpaceEncoding:
    """Index vectors -> real features whose squared Euclidean distance is
    the mixed metric: ordinal axes contribute ((i - j) / (n - 1))^2,
    categorical axes contribute 1 on mismatch (one-hot / sqrt(2)).

    Built from space *metadata* only — no validity enumeration — so it
    works on spaces far beyond the 200k-state tabulation cap.
    """

    shape: tuple[int, ...]
    categorical: tuple[bool, ...]

    @classmethod
    def from_space(cls, space: ConfigSpace | EncodedSpace) -> "SpaceEncoding":
        if isinstance(space, ConfigSpace):
            return cls(space.shape,
                       tuple(d.kind == "categorical" for d in space.dimensions))
        return cls(space.shape, space.categorical)

    @property
    def ndim(self) -> int:
        return len(self.shape)

    @property
    def feature_dim(self) -> int:
        return sum(n if c else 1
                   for n, c in zip(self.shape, self.categorical))

    def features(self, states: np.ndarray | Sequence[Sequence[int]]
                 ) -> np.ndarray:
        """(N, ndim) index vectors -> (N, feature_dim) fp32 features."""
        states = np.asarray(states, np.int64).reshape(-1, self.ndim)
        cols = []
        for d, (n, cat) in enumerate(zip(self.shape, self.categorical)):
            idx = states[:, d]
            if cat:
                oh = np.zeros((len(states), n), np.float32)
                oh[np.arange(len(states)), idx] = 1.0 / np.sqrt(2.0)
                cols.append(oh)
            else:
                cols.append((idx / max(n - 1, 1)).astype(np.float32)[:, None])
        return np.concatenate(cols, axis=1)


# ---------------------------------------------------------------------------
# Sparse online observations.
# ---------------------------------------------------------------------------


class MeasurementStore:
    """(encoded state, objective, timestamp) observations.

    Latest-wins per state: re-measuring a configuration replaces its entry
    (the landscape may have drifted).  ``half_life`` sets the recency
    decay used by :meth:`weights` — ``None`` means no decay (static
    landscapes).  ``capacity`` bounds memory; the stalest entries are
    evicted first (entries are kept in refresh order, so eviction is
    deterministic).
    """

    def __init__(self, ndim: int, half_life: float | None = None,
                 capacity: int = 8192):
        if capacity < 1:
            raise ValueError("capacity must be >= 1")
        if half_life is not None and half_life <= 0:
            raise ValueError("half_life must be > 0 (or None)")
        self.ndim = int(ndim)
        self.half_life = half_life
        self.capacity = int(capacity)
        self._data: dict[tuple[int, ...], tuple[float, float]] = {}
        # monotone add counter: lets a device-resident twin detect
        # out-of-band adds (a shared recycle store fed by a pipeline)
        # and resync instead of silently diverging
        self._version = 0

    def __len__(self) -> int:
        return len(self._data)

    def add(self, state: Sequence[int], y: float, t: float) -> None:
        key = tuple(int(i) for i in state)
        if len(key) != self.ndim:
            raise ValueError(f"state rank {len(key)} != ndim {self.ndim}")
        # the store is unlocked by contract: all adds/reads happen on the
        # controller thread (workers hand results back through futures);
        # the race seam lets the lockset detector verify that contract
        race_access("store", self)
        # delete-then-insert keeps dict order == refresh order, which makes
        # capacity eviction (pop the front) evict the stalest entry
        self._data.pop(key, None)
        self._data[key] = (float(y), float(t))
        while len(self._data) > self.capacity:
            self._data.pop(next(iter(self._data)))
        self._version += 1

    def arrays(self) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(states (M, ndim) int32, ys (M,) f64, ts (M,) f64), refresh order."""
        race_access("store", self, write=False)
        if not self._data:
            z = np.zeros(0)
            return np.zeros((0, self.ndim), np.int32), z, z.copy()
        states = np.asarray(list(self._data), np.int32)
        vals = np.asarray(list(self._data.values()), np.float64)
        return states, vals[:, 0].copy(), vals[:, 1].copy()

    def weights(self, now: float) -> np.ndarray:
        """(M,) recency weights: 2^(-(now - t) / half_life), 1 if no decay."""
        _, _, ts = self.arrays()
        if self.half_life is None:
            return np.ones(len(ts))
        return np.exp2(-np.maximum(now - ts, 0.0) / self.half_life)

    def __contains__(self, state: Sequence[int]) -> bool:
        return tuple(int(i) for i in state) in self._data

    def timestamp(self, state: Sequence[int]) -> float:
        """When the state was last measured (KeyError if never)."""
        return self._data[tuple(int(i) for i in state)][1]

    def best(
        self, now: float | None = None, max_age: float | None = None
    ) -> tuple[tuple[int, ...], float]:
        """The state with the lowest (latest) measured objective.

        With ``max_age`` set, only measurements taken within the last
        ``max_age`` time units of ``now`` compete — on a drifting
        landscape an old low reading is a claim about a surface that no
        longer exists.  Falls back to the unrestricted argmin when every
        entry is stale (better a suspect answer than none)."""
        if not self._data:
            raise ValueError("empty MeasurementStore")
        items = list(self._data.items())
        if max_age is not None:
            if now is None:
                raise ValueError("max_age requires now")
            fresh = [kv for kv in items if now - kv[1][1] <= max_age]
            items = fresh or items
        key, (y, _) = min(items, key=lambda kv: kv[1][0])
        return key, y


# ---------------------------------------------------------------------------
# The interpolator.
# ---------------------------------------------------------------------------


#: Feature-space coordinate of measurement-padding rows: far beyond any
#: real feature (which live in [0, 1] per axis), so padded entries can
#: never be the nearest measurement and their kernel weight underflows
#: to zero even before the zero recency weight kills them exactly.
_PAD_FAR = 1.0e3

#: Smallest padded axis length — below this, bucketing buys nothing.
_PAD_MIN = 64


def _bucket(n: int) -> int:
    """Next power of two >= n (floored at ``_PAD_MIN``): the padded
    (Q, M) shapes the reference uses so a growing store does not present
    a new shape every round; the port keeps them so both packages hand
    their kernels the same rows."""
    return max(_PAD_MIN, 1 << max(0, int(n) - 1).bit_length())


def host_interp(
    xq: np.ndarray, xm: np.ndarray, ys: np.ndarray, rec: np.ndarray,
    *, kind: str = "idw", length_scale: float = 0.25,
    idw_power: float = 2.0, eps: float = 1e-9,
) -> tuple[np.ndarray, np.ndarray]:
    """Plain-numpy mirror of the fused device refit — ONE shared
    encoding/metric path for every host-side interpolation, so a host
    predictor and the surrogate cannot drift apart.

    xq (Q, F), xm (M, F), ys (M,), rec (M,) -> (mean (Q,), dmin (Q,))
    float64; ``dmin`` is the nearest-measurement distance before
    objective-unit scaling."""
    xq = np.asarray(xq, np.float64)
    xm = np.asarray(xm, np.float64)
    d2 = ((xq[:, None, :] - xm[None, :, :]) ** 2).sum(-1)    # (Q, M)
    if kind == "rbf":
        k = np.exp(-d2 / (2.0 * length_scale**2))
    else:                                                    # "idw"
        k = 1.0 / (d2 ** (idw_power / 2.0) + eps)
    k = k * rec[None, :]
    wsum = k.sum(axis=1)
    # recency-weighted global mean as the far-field fallback
    fallback = (ys * rec).sum() / max(float(rec.sum()), 1e-12)
    mean = np.where(wsum > 1e-12, k @ ys / np.maximum(wsum, 1e-12),
                    fallback)
    dmin = np.sqrt(d2.min(axis=1))
    return mean, dmin


@dataclasses.dataclass
class SurrogateModel:
    """Batched interpolator with an uncertainty channel.

    ``kind="idw"`` (default) is Shepard inverse-distance weighting —
    parameter-free across spaces and exact at measured states; ``"rbf"``
    is a Gaussian kernel of width ``length_scale`` (normalized feature
    units, where a full ordinal axis spans 1.0).  Predictions are
    recency-weighted by the store, so stale measurements of a drifted
    landscape fade rather than anchor the estimate.

    The uncertainty channel is the distance to the nearest measurement,
    scaled by the observed objective spread: zero exactly at measured
    states, growing toward unexplored regions, in objective units.

    ``device`` is where :meth:`predict` runs the fused interpolation
    (``"cuda"``: the hand kernel; ``"cpu"``: its plain version).
    """

    encoding: SpaceEncoding
    kind: str = "idw"
    length_scale: float = 0.25
    idw_power: float = 2.0
    eps: float = 1e-9
    chunk: int = 8192
    device: str = "cuda"

    def __post_init__(self) -> None:
        if self.kind not in ("idw", "rbf"):
            raise ValueError(f"unknown surrogate kind {self.kind!r}")

    def predict(
        self,
        states: np.ndarray | Sequence[Sequence[int]],
        store: MeasurementStore,
        now: float | None = None,
    ) -> tuple[np.ndarray, np.ndarray]:
        """(Q, ndim) query index vectors -> (estimates (Q,), uncertainty
        (Q,)), both float64 numpy.  Requires at least one measurement.

        Queries go to the kernel in chunks of ``chunk`` rows; the results
        stay on the device until one read at the end."""
        if len(store) == 0:
            raise ValueError("cannot predict from an empty MeasurementStore")
        dev = resolve_device(self.device)
        obs, ys, ts = store.arrays()
        rec = store.weights(float(ts.max()) if now is None else float(now))
        spread = float(ys.max() - ys.min())
        y_scale = spread if spread > 0 else max(1.0, abs(float(ys.mean())))

        # the measurement and query axes pad to power-of-two buckets, as in
        # the reference: padded rows sit at _PAD_FAR (never nearest) with
        # zero recency weight (exactly zero kernel contribution)
        feats_m = self.encoding.features(obs)
        m_cap = _bucket(len(obs))
        if m_cap != len(obs):
            pad = m_cap - len(obs)
            feats_m = np.concatenate(
                [feats_m,
                 np.full((pad, feats_m.shape[1]), _PAD_FAR, np.float32)])
            ys = np.concatenate([ys, np.zeros(pad)])
            rec = np.concatenate([rec, np.zeros(pad)])
        xm = torch.as_tensor(feats_m, device=dev)
        y_d = torch.as_tensor(ys, dtype=torch.float32, device=dev)
        rec_d = torch.as_tensor(rec, dtype=torch.float32, device=dev)

        states = np.asarray(states, np.int64).reshape(-1, self.encoding.ndim)
        means, dmins = [], []
        for lo in range(0, len(states), self.chunk):
            feats_q = self.encoding.features(states[lo:lo + self.chunk])
            n_q = len(feats_q)
            q_cap = min(_bucket(n_q), self.chunk)
            if q_cap != n_q:
                feats_q = np.concatenate(
                    [feats_q,
                     np.zeros((q_cap - n_q, feats_q.shape[1]), np.float32)])
            m, d = kernel_ops.fused_interp(
                torch.as_tensor(feats_q, device=dev), xm, y_d, rec_d,
                kind=self.kind, length_scale=self.length_scale,
                idw_power=self.idw_power, eps=self.eps)
            means.append(m[:n_q])
            dmins.append(d[:n_q])
        if not means:
            return np.zeros(0), np.zeros(0)
        both = torch.stack([torch.cat(means), torch.cat(dmins)]).cpu()
        mean = both[0].numpy().astype(np.float64)
        unc = y_scale * both[1].numpy().astype(np.float64)
        return mean, unc


# ---------------------------------------------------------------------------
# ObjectiveSource: the injectable table provider for the controllers.
# ---------------------------------------------------------------------------


class ObjectiveSource:
    """Where controller objective tables come from.

    ``table(space, fn, valid_mask)`` returns an array of shape
    ``space.shape``; implementations track ``true_measures`` (calls of the
    real ``fn``) and ``surrogate_queries`` (model evaluations) for
    standalone use.  The controllers count evaluator runs themselves
    (their ``fn`` closures may take several measurements per call), so
    their decision logs read ``surrogate_queries`` from here but keep
    their own ``true_measures``.
    """

    def __init__(self) -> None:
        self.true_measures = 0
        self.surrogate_queries = 0

    def counts(self) -> dict[str, int]:
        return {"true_measures": self.true_measures,
                "surrogate_queries": self.surrogate_queries}

    def table(
        self,
        space: ConfigSpace,
        fn: Callable[[dict[str, Any]], float],
        valid_mask: np.ndarray | None = None,
    ) -> np.ndarray:
        raise NotImplementedError


class ExhaustiveSource(ObjectiveSource):
    """The historical behavior: one real evaluation per valid state."""

    def __init__(self, max_size: int = 200_000):
        super().__init__()
        self.max_size = int(max_size)

    def table(self, space, fn, valid_mask=None):
        Y = tabulate(space, fn, max_size=self.max_size,
                     valid_mask=valid_mask)
        if valid_mask is not None:
            self.true_measures += int(np.asarray(valid_mask).sum())
        elif space.is_valid is None:
            self.true_measures += space.size()
        else:
            self.true_measures += int(np.isfinite(Y).sum())
        return Y


class SurrogateSource(ObjectiveSource):
    """Probe ``n_probe`` valid states, interpolate the rest.

    The table is still materialized over the full product (the compiled
    fleet needs a (T, size) array), but the *real* evaluation count drops
    from one-per-valid-state to ``n_probe`` — the difference between a
    simulator sweep and a day of cluster time under a
    :class:`repro_torch.core.costmodel.MeasuredEvaluator`.

    With ``recycle_store`` set (a store other measurements were recycled
    into), every in-bounds entry warm-starts the table build at its
    original timestamp: those states are neither re-probed nor re-counted
    — each real measurement is paid for exactly once, where it was taken.

    ``device`` is where the default model (``model=None``) interpolates.
    """

    def __init__(
        self,
        n_probe: int = 256,
        model: SurrogateModel | None = None,
        half_life: float | None = None,
        max_size: int = 2_000_000,
        seed: int = 0,
        recycle_store: MeasurementStore | None = None,
        device: str = "cuda",
    ):
        super().__init__()
        if n_probe < 1:
            raise ValueError("n_probe must be >= 1")
        self.n_probe = int(n_probe)
        self.model = model
        self.half_life = half_life
        self.max_size = int(max_size)
        self.recycle_store = recycle_store
        self.recycled_used = 0
        self.device = device
        self._rng = np.random.default_rng(seed)

    def _probe_states(self, space: ConfigSpace,
                      valid_mask: np.ndarray | None) -> np.ndarray:
        if valid_mask is not None:
            flat = np.flatnonzero(np.asarray(valid_mask).reshape(-1))
            if flat.size == 0:
                raise ValueError("space has no valid states")
            picks = self._rng.choice(
                flat, size=min(self.n_probe, flat.size), replace=False)
            return np.stack(
                np.unravel_index(np.sort(picks), space.shape), axis=-1)
        # dict keys preserve insertion order; repeated draws may collide,
        # so very constrained spaces can yield fewer than n_probe probes
        out: dict[tuple[int, ...], None] = {}
        for _ in range(20 * self.n_probe):
            out.setdefault(random_valid_state(space, self._rng), None)
            if len(out) == self.n_probe:
                break
        return np.asarray(list(out), np.int64)

    def _recycled_entries(
        self, space: ConfigSpace, valid_mask: np.ndarray | None
    ) -> list[tuple[tuple[int, ...], float, float]]:
        """In-bounds, valid entries of the shared recycle store — real
        measurements already paid for elsewhere (a pipeline's
        mis-speculations), free to warm-start this table build."""
        if self.recycle_store is None or len(self.recycle_store) == 0:
            return []
        obs, ys, ts = self.recycle_store.arrays()
        if obs.shape[1] != len(space.shape):
            return []
        mask = (np.asarray(valid_mask, bool)
                if valid_mask is not None else None)
        out = []
        for s, y, t in zip(obs, ys, ts):
            key = tuple(int(i) for i in s)
            if any(i < 0 or i >= n for i, n in zip(key, space.shape)):
                continue
            if mask is not None:
                if not mask[key]:
                    continue
            elif not space.contains(key):
                continue
            out.append((key, float(y), float(t)))
        return out

    def table(self, space, fn, valid_mask=None):
        if space.size() > self.max_size:
            raise ValueError(
                f"space too large to materialize: {space.size()}")
        recycled = self._recycled_entries(space, valid_mask)
        probes = self._probe_states(space, valid_mask)
        store = MeasurementStore(
            len(space.shape), half_life=self.half_life,
            capacity=max(len(probes) + len(recycled), 1))
        for key, y, t in recycled:
            store.add(key, y, t)             # counted where it was taken
        self.recycled_used += len(recycled)
        for s in probes:
            if s in store:
                continue                     # recycled measurement wins
            store.add(s, float(fn(space.decode([int(i) for i in s]))), 0.0)
            self.true_measures += 1
        model = self.model or SurrogateModel(
            SpaceEncoding.from_space(space), device=self.device)
        grid = np.indices(space.shape).reshape(len(space.shape), -1).T
        mean, _ = model.predict(grid, store)
        self.surrogate_queries += len(grid)
        Y = mean.reshape(space.shape)
        if valid_mask is not None:
            Y = np.where(np.asarray(valid_mask), Y, np.inf)
        return Y


# ---------------------------------------------------------------------------
# Windowed sub-spaces: nothing materialized scales with the full product.
# ---------------------------------------------------------------------------


def window_space(
    space: ConfigSpace,
    center: Sequence[int],
    half_width: int = 6,
) -> tuple[ConfigSpace, np.ndarray]:
    """A sub-ConfigSpace around ``center``: ordinal axes keep a contiguous
    ``2 * half_width + 1`` slice (clipped at the boundary without
    shrinking, so window shapes — and the tables built on them — are
    stable as the window moves), categorical axes keep every value.  The
    validity
    predicate carries over unchanged (it sees decoded values, which are
    the same values).  Returns (sub_space, per-axis index offsets)."""
    if half_width < 1:
        raise ValueError("half_width must be >= 1")
    dims, offs = [], []
    for dim, c in zip(space.dimensions, center):
        n = len(dim)
        w = 2 * half_width + 1
        if dim.kind == "categorical" or n <= w:
            lo = 0
            vals = dim.values
        else:
            lo = int(np.clip(int(c) - half_width, 0, n - w))
            vals = dim.values[lo:lo + w]
        offs.append(lo)
        dims.append(Dimension(dim.name, tuple(vals), dim.kind))
    return (ConfigSpace(tuple(dims), space.is_valid),
            np.asarray(offs, np.int64))


# ---------------------------------------------------------------------------
# Acquisition scores: how the real-measurement budget is ranked.
# ---------------------------------------------------------------------------


def expected_improvement(
    mean: np.ndarray, unc: np.ndarray, y_best: float
) -> np.ndarray:
    """EI under a Gaussian belief (minimization): ``s (z Phi(z) + phi(z))``
    with ``z = (y_best - mean) / s`` and ``s`` the uncertainty channel
    read as a standard deviation.  Exactly-measured states (``s = 0``)
    get their deterministic improvement ``max(y_best - mean, 0)`` — no
    exploration credit for what is already known."""
    mean = np.asarray(mean, np.float64)
    s = np.maximum(np.asarray(unc, np.float64), 1e-12)
    z = (y_best - mean) / s
    cdf = 0.5 * (1.0 + np.asarray([math.erf(v / math.sqrt(2.0))
                                   for v in np.ravel(z)]).reshape(z.shape))
    pdf = np.exp(-0.5 * z * z) / math.sqrt(2.0 * math.pi)
    return s * (z * cdf + pdf)
