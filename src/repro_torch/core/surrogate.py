"""Surrogate objective: tables for spaces too large to tabulate.

The chain engine (:func:`repro_torch.core.annealing.anneal_fleet`)
consumes *tables*, and :func:`repro_torch.core.landscape.tabulate`
hard-caps the product at 200k states.  The paper's online algorithm never
needed the full table: it only ever measures the configurations it
visits.  This module learns a cheap predictive model from sparse
measurements and interpolates the rest.

Pieces:

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

* :class:`DeviceMeasurementStore` — the numpy store's twin on the device,
  row for row the reference's layout, written once a round.

* :class:`SurrogateAnnealer` — the measure-refit-anneal loop on a window
  around the incumbent.  Its device loop keeps the refit (one
  ``fused_interp``), the chains (one ``anneal_walk``) and the selection
  (:func:`_select`) on the device, with one upload and one read-back a
  round; its host loop refits through :meth:`SurrogateModel.predict` and
  selects with numpy.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Sequence

import numpy as np
import torch

from ..device import generator, resolve_device
from ..kernels import ops as kernel_ops
from ..telemetry import provenance
from ..telemetry import registry as metrics
from ..telemetry import span
from .annealing import (
    _upload,
    anneal_fleet,
    chain_accept_stats,
    random_valid_states,
)
from .instrumentation import note_round, race_access
from .landscape import tabulate
from .neighborhood import row_major_strides
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


# ---------------------------------------------------------------------------
# Device-resident measurement store: the numpy store's twin on device.
# ---------------------------------------------------------------------------


class DeviceMeasurementStore:
    """Device-resident twin of :class:`MeasurementStore`.

    Fixed-capacity, pow-2-bucketed rows on ``device`` — states (cap, ndim)
    int32, features (cap, F) float32 (padding rows at ``_PAD_FAR``),
    objectives and timestamps (cap,) float32, a refresh-order sequence
    number (cap,) int32 (-1 = empty) and a validity weight mask (cap,)
    float32 — with latest-wins dedup and stalest-first eviction, so the
    numpy store's ``best()`` / snapshot semantics hold (pinned by the
    parity tests) while the refit inputs never leave the device.

    Valid rows always form a compact prefix (inserts take the lowest free
    row; eviction reuses the evicted row), so :meth:`refit_view`'s
    pow-2-bucket slices carry every live entry plus exactly-zero-
    contribution padding — the same padding contract as
    :meth:`SurrogateModel.predict`.  The row an add writes is the
    reference's, found on the host from a key-to-row map kept in refresh
    order (its front is the stalest entry, the one eviction takes), so the
    rows equal the reference's row for row.

    :meth:`add` stages its row on the host; :meth:`flush` (which every
    reader calls first) writes the staged rows with one upload and one
    scatter, the last add of a row winning, as adds one at a time would.
    A flush scatters into a copy of the arrays, never into them, so a view
    a caller holds (:meth:`refit_view`, :meth:`weights_device`, ...) is
    not changed by later adds.  ``load`` rebuilds from a numpy store
    (host->device only) when a twin detects out-of-band adds.
    """

    def __init__(self, encoding: SpaceEncoding,
                 half_life: float | None = None, capacity: int = 8192,
                 device: str | torch.device = "cuda"):
        if capacity < 1:
            raise ValueError("capacity must be >= 1")
        if half_life is not None and half_life <= 0:
            raise ValueError("half_life must be > 0 (or None)")
        self.encoding = encoding
        self.ndim = encoding.ndim
        self.half_life = half_life
        self.capacity = int(capacity)
        self.cap = _bucket(self.capacity)
        self.device = resolve_device(device)
        cap = self.cap
        # one int32 buffer holds the six arrays, each a view into it
        self._offsets = tuple(int(v) for v in np.cumsum(
            [0, cap * self.ndim, cap * encoding.feature_dim, cap, cap, cap,
             cap]))
        self._keys: dict[tuple[int, ...], int] = {}     # refresh order
        self._staged: dict[int, tuple] = {}             # row -> its add
        self._next_seq = 0
        self._set_buffer(_upload(self._rows([], (), ()), self.device))

    def __len__(self) -> int:
        return len(self._keys)

    def __contains__(self, state: Sequence[int]) -> bool:
        return tuple(int(i) for i in state) in self._keys

    def _rows(self, keys: Sequence[tuple[int, ...]], ys, ts) -> np.ndarray:
        """The whole buffer on the host, ``keys`` in rows 0.. in seq
        order."""
        cap, n, o = self.cap, len(keys), self._offsets
        buf = np.zeros(o[-1], np.int32)
        feats = np.full((cap, self.encoding.feature_dim), _PAD_FAR,
                        np.float32)
        seq = np.full(cap, -1, np.int32)
        wmask = np.zeros(cap, np.float32)
        if n:
            buf[:n * self.ndim] = np.asarray(keys, np.int32).ravel()
            feats[:n] = self.encoding.features(keys)
            buf[o[2]:o[2] + n] = np.asarray(ys, np.float32).view(np.int32)
            buf[o[3]:o[3] + n] = np.asarray(ts, np.float32).view(np.int32)
            seq[:n] = np.arange(n, dtype=np.int32)
            wmask[:n] = 1.0
        buf[o[1]:o[2]] = feats.view(np.int32).ravel()
        buf[o[4]:o[5]] = seq
        buf[o[5]:o[6]] = wmask.view(np.int32)
        return buf

    def _set_buffer(self, buf: torch.Tensor) -> None:
        o, cap, f32 = self._offsets, self.cap, torch.float32
        self._buf = buf
        self._states = buf[o[0]:o[1]].view(cap, self.ndim)
        self._feats = buf[o[1]:o[2]].view(f32).view(cap, -1)
        self._ys = buf[o[2]:o[3]].view(f32)
        self._ts = buf[o[3]:o[4]].view(f32)
        self._seq = buf[o[4]:o[5]]
        self._wmask = buf[o[5]:o[6]].view(f32)

    def add(self, state: Sequence[int], y: float, t: float) -> None:
        key = tuple(int(i) for i in state)
        if len(key) != self.ndim:
            raise ValueError(f"state rank {len(key)} != ndim {self.ndim}")
        # the reference's row: the key's own, else the lowest free one
        # (the live count: rows are never freed), else the stalest
        # entry's; delete-then-insert keeps the map in refresh order
        row = self._keys.pop(key, None)
        if row is None:
            row = (len(self._keys) if len(self._keys) < self.capacity
                   else self._keys.pop(next(iter(self._keys))))
        self._keys[key] = row
        self._staged[row] = (key, float(y), float(t), self._next_seq)
        self._next_seq += 1

    def flush(self, carry: np.ndarray | None = None) -> torch.Tensor | None:
        """Write the staged rows: one upload of their flat indices and
        values (with ``carry``, an int32 array the caller wants on the
        device, in the same copy) and one scatter into a copy of the
        buffer.  Returns ``carry``'s device view (None without it)."""
        if not self._staged and carry is None:
            return None
        nd, F, o = self.ndim, self.encoding.feature_dim, self._offsets
        rows = np.fromiter(self._staged, np.int64, len(self._staged))
        adds = list(self._staged.values())
        keys = np.asarray([a[0] for a in adds], np.int32).reshape(-1, nd)
        idx = np.concatenate([
            (rows[:, None] * nd + np.arange(nd)).ravel(),
            o[1] + (rows[:, None] * F + np.arange(F)).ravel(),
            o[2] + rows, o[3] + rows, o[4] + rows, o[5] + rows])
        vals = np.concatenate([
            keys.ravel(),
            self.encoding.features(keys).view(np.int32).ravel(),
            np.asarray([a[1] for a in adds], np.float32).view(np.int32),
            np.asarray([a[2] for a in adds], np.float32).view(np.int32),
            np.asarray([a[3] for a in adds], np.int32),
            np.ones(len(adds), np.float32).view(np.int32)])
        tail = (np.zeros(0, np.int32) if carry is None
                else np.asarray(carry, np.int32).ravel())
        d = _upload(np.concatenate([idx.view(np.int32), vals, tail]),
                    self.device)
        k = len(idx)
        if k:
            self._set_buffer(self._buf.index_put(
                (d[:2 * k].view(torch.int64),), d[2 * k:3 * k]))
        self._staged.clear()
        return None if carry is None else d[3 * k:]

    def load(self, store: MeasurementStore) -> None:
        """Bulk-rebuild from a numpy store (host->device only): refresh
        order becomes seq order, so twin semantics pick up exactly where
        the numpy store stands."""
        obs, ys, ts = store.arrays()
        keys = [tuple(int(i) for i in s) for s in obs]
        self._set_buffer(_upload(self._rows(keys, ys, ts), self.device))
        self._staged.clear()
        self._next_seq = len(keys)
        self._keys = {k: i for i, k in enumerate(keys)}

    def weights_device(self, now: float) -> torch.Tensor:
        """(cap,) device recency weights — zero on empty/padding rows,
        ``2^(-(now - t)/half_life)`` (1 with no decay) on live rows."""
        self.flush()
        if self.half_life is None:
            return self._wmask
        return self._wmask * torch.exp2(
            -torch.clamp(float(now) - self._ts, min=0.0) / self.half_life)

    def refit_view(self, now: float, m_bucket: int | None = None
                   ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Device (feats, ys, recency) slices for the fused refit:
        ``m_bucket`` rows (default: the pow-2 bucket of the live count)
        — every live entry plus padding rows whose far features and zero
        weights contribute exactly nothing."""
        if m_bucket is None:
            m_bucket = _bucket(len(self._keys))
        m_bucket = min(m_bucket, self.cap)
        rec = self.weights_device(now)
        return (self._feats[:m_bucket], self._ys[:m_bucket],
                rec[:m_bucket])

    def y_scale_device(self) -> torch.Tensor:
        """Device objective scale: spread of live objectives, or
        ``max(1, |mean|)`` when flat — the numpy predict's formula."""
        self.flush()
        valid = self._seq >= 0
        inf = float("inf")
        spread = (torch.where(valid, self._ys, -inf).max()
                  - torch.where(valid, self._ys, inf).min())
        cnt = torch.clamp(valid.sum(), min=1)
        mean = torch.where(valid, self._ys, 0.0).sum() / cnt
        return torch.where(spread > 0, spread,
                           torch.clamp(mean.abs(), min=1.0))

    def best_device(self, now: float, max_age: float | None = None
                    ) -> tuple[torch.Tensor, torch.Tensor]:
        """Device (row index, objective) of the best credible entry — the
        numpy store's ``best`` semantics (fresh-filter with all-stale
        fallback, first-minimal-in-refresh-order tie-break)."""
        self.flush()
        age = float("inf") if max_age is None else float(max_age)
        valid = self._seq >= 0
        fresh = valid & ((float(now) - self._ts) <= age)
        use = torch.where(fresh.any(), fresh, valid)     # all-stale fallback
        ym = torch.where(use, self._ys, float("inf"))
        m = ym.min()
        # first-minimal in refresh order == lowest seq among the minima
        imax = torch.iinfo(torch.int32).max
        idx = torch.argmin(torch.where(use & (ym == m), self._seq, imax))
        return idx, m

    def best(self, now: float | None = None,
             max_age: float | None = None) -> tuple[tuple[int, ...], float]:
        """Host-facing ``best`` (pulls one row — parity tests/debug)."""
        if not self._keys:
            raise ValueError("empty DeviceMeasurementStore")
        if max_age is not None and now is None:
            raise ValueError("max_age requires now")
        idx, y = self.best_device(0.0 if now is None else now, max_age)
        i = int(idx)
        return tuple(int(v) for v in self._states[i].tolist()), float(y)

    def snapshot(self) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(states, ys, ts) numpy in refresh order — the numpy store's
        ``arrays()`` contract.  Host pull; tests/debug only."""
        self.flush()
        if not self._keys:
            z = np.zeros(0)
            return np.zeros((0, self.ndim), np.int32), z, z.copy()
        imax = torch.iinfo(torch.int32).max
        order = torch.argsort(torch.where(self._seq >= 0, self._seq, imax),
                              stable=True)[:len(self._keys)]
        return (self._states[order].cpu().numpy(),
                self._ys[order].cpu().numpy().astype(np.float64),
                self._ts[order].cpu().numpy().astype(np.float64))


def _select(inits: torch.Tensor, states: torch.Tensor,
            mean_w: torch.Tensor, unc_w: torch.Tensor, *,
            shape: tuple[int, ...], acquisition: str, m: int, n_exp: int,
            kappa: float, y_best: float) -> torch.Tensor:
    """On-device measurement selection: dedup the visited states (the
    chains' starts ``inits`` (C, ndim) and ``states`` (C, S, ndim) on the
    window ``shape``), score them under the acquisition from ``mean_w``
    and ``unc_w`` (W,) float32, and pick the ``m`` winners — ``m - n_exp``
    by acquisition rank, the rest by uncertainty — with the host path's
    stable-argsort semantics (np.unique's ascending-flat order is
    reproduced by first-occurrence masking over a stable sort, so ties
    break identically).  ``kappa`` and ``y_best`` enter as float32.
    Returns (m, ndim) int32 window-local states with -1 sentinel rows when
    fewer than ``m`` distinct states were visited.

    The reference walks its candidates one by one; here the winners are
    the first ``m`` distinct unique-state positions in candidate order,
    found by a first-occurrence minimum, a running count and one scatter,
    so nothing is read back."""
    strides = row_major_strides(shape)
    nd = inits.shape[1]
    dev = mean_w.device
    visited = torch.cat([inits[:, None, :], states], 1).reshape(-1, nd) \
        .long()
    vflat = visited[:, 0] * strides[0]
    for d in range(1, nd):
        vflat = vflat + visited[:, d] * strides[d]
    s = vflat[torch.argsort(vflat, stable=True)]
    first = torch.cat([torch.ones(1, dtype=torch.bool, device=dev),
                       s[1:] != s[:-1]])                # unique, ascending
    meanv = mean_w[s]
    uncv = unc_w[s]
    if acquisition == "ei":
        sd = torch.clamp(uncv, min=1e-12)
        z = (float(y_best) - meanv) / sd
        cdf = 0.5 * (1.0 + torch.erf(z * (1.0 / math.sqrt(2.0))))
        pdf = torch.exp(-0.5 * z * z) * (1.0 / math.sqrt(2.0 * math.pi))
        acq = -(sd * (z * cdf + pdf))           # lower score = earlier
    else:
        acq = meanv - float(kappa) * uncv
    inf = float("inf")
    ord_acq = torch.argsort(torch.where(first, acq, inf), stable=True)
    ord_unc = torch.argsort(torch.where(first, -uncv, inf), stable=True)
    cand = torch.cat([ord_acq[:m - n_exp], ord_unc])    # positions in s
    # a candidate counts at its position's first place in cand, where the
    # position holds a unique state; the first m that count are chosen
    j = torch.arange(cand.numel(), device=dev)
    first_j = torch.full((s.numel(),), cand.numel(), dtype=torch.int64,
                         device=dev)
    first_j.scatter_reduce_(0, cand, j, reduce="amin")
    new = first[cand] & (first_j[cand] == j)
    rank = torch.cumsum(new.long(), 0) - 1
    chosen = torch.full((m + 1,), -1, dtype=torch.int64, device=dev)
    chosen.scatter_(0, torch.where(new & (rank < m), rank, m), s[cand])
    chosen = chosen[:m]
    cols, rem = [], chosen
    for stride in strides:
        cols.append(torch.div(rem, stride, rounding_mode="floor"))
        rem = rem % stride
    return torch.where(chosen[:, None] >= 0, torch.stack(cols, 1),
                       -1).to(torch.int32)


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


# ---------------------------------------------------------------------------
# The measure-refit-anneal loop.
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class SurrogateRound:
    """Audit record of one measure-refit-anneal round."""

    n: int
    incumbent: tuple[int, ...]
    best_y: float                # best (latest) measured objective so far
    window_size: int             # states interpolated this round
    true_measures: int           # cumulative real evaluations
    surrogate_queries: int       # cumulative model evaluations
    measured: tuple[tuple[tuple[int, ...], float], ...]  # this round's


@dataclasses.dataclass
class _Window:
    """What a window position needs, built once per position: the
    encoded sub-space, its valid states' flat indices and its query
    features (padded to the pow-2 query bucket) on the device."""

    enc: EncodedSpace
    valid_flat: torch.Tensor | None = None
    feats: torch.Tensor | None = None


class SurrogateAnnealer:
    """Online annealing on spaces too large to tabulate.

    Each :meth:`round`:

    1. slice a window sub-space around the incumbent
       (:func:`window_space`) and interpolate the surrogate objective and
       its uncertainty over every window state;
    2. run ``n_chains`` chains for ``steps_per_round`` transitions on the
       surrogate table in ONE :func:`repro_torch.core.annealing.
       anneal_fleet` call (one ``anneal_walk`` launch on the card), with
       ``-kappa * uncertainty`` threaded through ``extra_costs`` so the
       acceptance rule itself prefers unexplored states (optimism in the
       face of uncertainty);
    3. spend ``measures_per_round`` real evaluations on the visited
       states ranked by the chosen ``acquisition`` — ``"lcb"`` (default:
       surrogate lower confidence bound, ``mean - kappa * uncertainty``)
       or ``"ei"`` (expected improvement over the best measurement,
       :func:`expected_improvement`) — reserving an ``explore_frac`` share
       for the most *uncertain* visited states;
    4. feed the measurements back and move the incumbent to the best
       measured state.

    The first round starts with a *global* bootstrap design:
    ``n_bootstrap`` uniform valid states measured across the full space
    (drawn with numpy from ``seed``, as the reference draws them), so the
    incumbent jumps straight to the best sampled basin.

    With ``device_loop`` (default) the refit, the anneal and the
    selection stay on ``device``: a :class:`DeviceMeasurementStore`
    mirrors the numpy store, the refit is one ``fused_interp`` launch,
    :func:`_select` picks on the device, and one (m, ndim) decision
    packet is read back a round; the round's uploads (the store's new
    rows, chain 0's start) go in one non-blocking copy.  Without it the
    refit is :meth:`SurrogateModel.predict` and the selection runs on the
    host.  Everything materialized scales with the window, never the full
    product.  Round ``r``'s chain starts and draws come from
    ``generator(seed, r)`` through :meth:`_chains`, the one seam the
    round's randomness passes.  Deterministic under a fixed ``seed``.
    """

    def __init__(
        self,
        space: ConfigSpace,
        evaluate: Callable[[dict[str, Any]], float],
        model: SurrogateModel | None = None,
        store: MeasurementStore | None = None,
        half_width: int = 6,
        n_chains: int = 16,
        steps_per_round: int = 64,
        tau: float = 1.0,
        kappa: float = 1.0,
        measures_per_round: int = 8,
        explore_frac: float = 0.25,
        n_bootstrap: int | None = None,
        init: Sequence[int] | None = None,
        seed: int = 0,
        acquisition: str = "lcb",
        eval_workers: int | None = None,
        device_loop: bool = True,
        device: str | torch.device = "cuda",
    ):
        if measures_per_round < 1:
            raise ValueError("measures_per_round must be >= 1")
        if acquisition not in ("lcb", "ei"):
            raise ValueError(f"unknown acquisition {acquisition!r} "
                             f"(expected 'lcb' or 'ei')")
        self.device = resolve_device(device)
        self.acquisition = acquisition
        self.space = space
        self.evaluate = evaluate
        self.model = (SurrogateModel(SpaceEncoding.from_space(space),
                                     device=str(self.device))
                      if model is None else model)
        # `store or default` would discard a caller's EMPTY store (len 0
        # is falsy) — and with it the half_life drift configuration
        self.store = (MeasurementStore(len(space.dimensions))
                      if store is None else store)
        self.half_width = int(half_width)
        self.n_chains = int(n_chains)
        self.steps_per_round = int(steps_per_round)
        self.tau = float(tau)
        self.kappa = float(kappa)
        self.measures_per_round = int(measures_per_round)
        self.explore_frac = float(explore_frac)
        self.n_bootstrap = (max(self.measures_per_round, 8)
                            if n_bootstrap is None else int(n_bootstrap))
        if self.n_bootstrap < 1:
            raise ValueError("n_bootstrap must be >= 1")
        # > 1: the round's real measurements (bootstrap design and ranked
        # acquisition picks) run on the evaluation runtime's bounded
        # worker pool (repro_torch.core.evalpipe) — for wall-clock
        # `evaluate` callables, which must then be thread-safe.  The store
        # is fed in rank order either way, so the outcome matches the
        # serial loop.
        self.eval_workers = eval_workers
        self.seed = int(seed)
        self._rng = np.random.default_rng(seed)
        self.true_measures = 0
        self.surrogate_queries = 0
        self.stale_refreshes = 0     # drift mode: stale incumbents re-measured
        self.rounds: list[SurrogateRound] = []
        self._n = 0
        self._windows: dict[tuple[int, ...], _Window] = {}
        self._taus: torch.Tensor | None = None
        self.device_loop = bool(device_loop)
        self._dstore: DeviceMeasurementStore | None = None
        self._dstore_version = -1
        if init is None:
            init = self._random_valid_state()
        if not space.contains(init):
            raise ValueError(f"initial state {tuple(init)} not valid")
        self.incumbent: tuple[int, ...] = tuple(int(i) for i in init)

    def _random_valid_state(self, tries: int = 10_000) -> tuple[int, ...]:
        return random_valid_state(self.space, self._rng, tries)

    def _commit(self, key: tuple[int, ...], y: float, t: float) -> None:
        """Feed one measurement to the numpy store and, in lockstep, its
        device twin (staged there until the next round's one upload) —
        keeping the twin's version current so the round sync reloads
        nothing unless someone added to the store out of band."""
        self.store.add(key, y, t)
        self.true_measures += 1
        if self._dstore is not None:
            self._dstore.add(key, y, t)
            self._dstore_version = self.store._version

    def _measure(self, state: Sequence[int], t: float
                 ) -> tuple[tuple[int, ...], float]:
        key = tuple(int(i) for i in state)
        y = float(self.evaluate(self.space.decode(key)))
        self._commit(key, y, t)
        return key, y

    def _measure_states(
        self, states: Sequence[Sequence[int]], t: float
    ) -> list[tuple[tuple[int, ...], float]]:
        """Measure a ranked batch of states.  With ``eval_workers`` > 1
        they dispatch concurrently on the evaluation runtime's pool
        (submission follows the caller's rank order); the store is always
        fed in rank order on the calling thread, counting each probe
        once, so pooled and serial runs produce identical stores."""
        if not states:
            return []
        if self.eval_workers and self.eval_workers > 1 and len(states) > 1:
            from .evalpipe import EvalRequest, EvalResult, map_pool

            keys = [tuple(int(i) for i in s) for s in states]
            results = map_pool(
                lambda req: EvalResult(
                    y=float(self.evaluate(dict(req.decoded)))),
                [EvalRequest(state=k, decoded=self.space.decode(k),
                             job="probe", n=self._n, kind="probe")
                 for k in keys],
                max_workers=self.eval_workers)
            out = []
            for k, r in zip(keys, results):
                self._commit(k, float(r.y), t)
                out.append((k, float(r.y)))
            return out
        return [self._measure(s, t) for s in states]

    def _sync_device_store(self, carry: np.ndarray) -> torch.Tensor:
        """Bring the device twin up to date and upload ``carry`` with its
        new rows, in one copy; returns ``carry`` on the device.  A version
        mismatch means the numpy store was fed out of band (a shared
        recycle store) and triggers one bulk reload."""
        if self._dstore is None:
            self._dstore = DeviceMeasurementStore(
                self.model.encoding, half_life=self.store.half_life,
                capacity=self.store.capacity, device=self.device)
        if self._dstore_version != self.store._version:
            self._dstore.load(self.store)
            self._dstore_version = self.store._version
        return self._dstore.flush(carry)

    def _window(self, sub: ConfigSpace, offs: np.ndarray) -> _Window:
        """The window at ``offs``, encoded once per position the
        incumbent ever centers.  Window sizes are capped by half_width,
        far below the tabulation ceiling; it is raised so huge-but-
        windowed spaces with wide categorical axes still encode."""
        key = tuple(int(o) for o in offs)
        win = self._windows.get(key)
        if win is None:
            enc = sub.encoded(max_size=10_000_000)
            win = _Window(enc)
            if enc.valid_mask is not None:
                win.valid_flat = _upload(
                    np.flatnonzero(enc.valid_mask.reshape(-1)), self.device)
            self._windows[key] = win
        return win

    def _window_feats(self, win: _Window, sub: ConfigSpace,
                      offs: np.ndarray) -> torch.Tensor:
        """Device query features of every window state, padded to the
        pow-2 query bucket; made once per window position."""
        if win.feats is None:
            grid = np.indices(sub.shape).reshape(len(sub.shape), -1).T
            fq = self.model.encoding.features(grid + offs)
            q_cap = _bucket(len(fq))
            if q_cap != len(fq):
                fq = np.concatenate(
                    [fq, np.zeros((q_cap - len(fq), fq.shape[1]),
                                  np.float32)])
            win.feats = _upload(fq, self.device)
        return win.feats

    def _chains(self, r: int, win: _Window
                ) -> tuple[torch.Tensor, torch.Generator | None,
                           dict[str, Any] | None]:
        """Round ``r``'s randomness: the chains' starts, (C, ndim) int32 on
        the device (uniform over the window's valid region; the round
        overwrites row 0 with the incumbent), and the generator or the
        draws (:data:`repro_torch.core.annealing.DRAW_KEYS`) its
        :func:`anneal_fleet` call takes.  Both from ``generator(seed, r)``,
        the counterpart of the reference's ``fold_in(key(seed), r)``; the
        one seam the round's random numbers pass (tests replace it to
        replay the reference's)."""
        gen = generator(self.seed, r, device=self.device)
        inits = random_valid_states(gen, win.enc, self.n_chains,
                                    device=self.device,
                                    valid_flat=win.valid_flat)
        return inits, gen, None

    def round(self) -> SurrogateRound:
        """One measure-refit-anneal round; returns its audit record."""
        with span("surrogate.round", cat="surrogate"):
            rec = self._round_impl()
        if metrics.get() is not None:
            t_r = float(rec.n)
            metrics.record("surrogate/best_y", rec.best_y, t_r)
            metrics.record("surrogate/window", float(rec.window_size), t_r)
            metrics.set_gauge("surrogate/store_size", float(len(self.store)))
            metrics.set_gauge("surrogate/stale_refreshes",
                              float(self.stale_refreshes))
        return rec

    def _round_impl(self) -> SurrogateRound:
        t = float(self._n)
        dev = self.device
        prev_inc = self.incumbent
        measured: list[tuple[tuple[int, ...], float]] = []
        if len(self.store) == 0:
            # global bootstrap design: incumbent + uniform valid states
            # over the FULL space, then recenter on the best sample
            # (dispatched as one concurrent batch when eval_workers > 1)
            measured.extend(self._measure_states(
                [self.incumbent] + [self._random_valid_state()
                                    for _ in range(self.n_bootstrap - 1)],
                t))
            self.incumbent = self.store.best()[0]
        elif (self.store.half_life is not None and self.incumbent in self.store
              and t - self.store.timestamp(self.incumbent)
              >= self.store.half_life):
            # drift mode: the incumbent's reading is stale — refresh it
            # before trusting it as the window center (re-measuring the
            # incumbent is what lets the loop adapt after a change)
            self.stale_refreshes += 1
            measured.append(self._measure(self.incumbent, t))
            self.incumbent = self._best(t)[0]

        sub, offs = window_space(self.space, self.incumbent, self.half_width)
        win = self._window(sub, offs)
        enc = win.enc
        W = sub.size()
        C = self.n_chains
        n_exp = min(int(round(self.explore_frac * self.measures_per_round)),
                    self.measures_per_round - 1)
        if self._taus is None:
            self._taus = torch.full((C, self.steps_per_round), self.tau,
                                    dtype=torch.float32, device=dev)
        start = (np.asarray(self.incumbent, np.int64) - offs).astype(np.int32)

        if self.device_loop:
            # device-resident phase: refit -> anneal -> select with one
            # upload (the store's new rows and chain 0's start) and one
            # read-back (the (m, ndim) decision packet)
            start_d = self._sync_device_store(start)
            xq = self._window_feats(win, sub, offs)
            mb = min(_bucket(len(self.store)), self._dstore.cap)
            xm, ys_d, rec_d = self._dstore.refit_view(t, mb)
            with span("surrogate.refit", cat="surrogate",
                      metric="surrogate/refit_s"):
                mean_q, dmin_q = kernel_ops.fused_interp(
                    xq, xm, ys_d, rec_d, kind=self.model.kind,
                    length_scale=self.model.length_scale,
                    idw_power=self.model.idw_power, eps=self.model.eps)
            unc_q = self._dstore.y_scale_device() * dmin_q
            mean_w, unc_w = mean_q[:W], unc_q[:W]
            self.surrogate_queries += W

            # chain 0 starts at the incumbent (always inside its own
            # window); the rest uniform over the window's valid region
            inits, gen, draws = self._chains(self._n, win)
            inits[0] = start_d
            bonus = (-self.kappa * unc_w)[None, :].expand(C, W)
            with span("surrogate.anneal", cat="surrogate",
                      metric="surrogate/anneal_s"):
                out = anneal_fleet(
                    gen, enc, mean_w.reshape(sub.shape),
                    self.steps_per_round, self._taus, inits=inits,
                    n_chains=C, extra_costs=bonus, draws=draws, device=dev)
            sel = _select(inits, out["states"], mean_w, unc_w,
                          shape=sub.shape, acquisition=self.acquisition,
                          m=self.measures_per_round, n_exp=n_exp,
                          kappa=self.kappa, y_best=self._best(t)[1])
            # the round's one read-back: m * ndim ints
            rows = sel.tolist()
            with span("surrogate.measure", cat="surrogate"):
                measured.extend(self._measure_states(
                    [tuple(int(v) + int(o) for v, o in zip(r, offs))
                     for r in rows if r[0] >= 0], t))
        else:
            grid = np.indices(sub.shape).reshape(len(sub.shape), -1).T
            with span("surrogate.refit", cat="surrogate",
                      metric="surrogate/refit_s"):
                mean, unc = self.model.predict(grid + offs, self.store,
                                               now=t)
            self.surrogate_queries += W

            # chain 0 starts at the incumbent; the rest uniform over the
            # window's valid region
            inits_d, gen, draws = self._chains(self._n, win)
            inits = inits_d.cpu().numpy().astype(np.int32)
            inits[0] = start
            bonus = np.broadcast_to((-self.kappa * unc).astype(np.float32),
                                    (C, W))
            with span("surrogate.anneal", cat="surrogate",
                      metric="surrogate/anneal_s"):
                out = anneal_fleet(
                    gen, enc, mean.reshape(sub.shape).astype(np.float32),
                    self.steps_per_round, self._taus, inits=inits,
                    n_chains=C, extra_costs=bonus, draws=draws, device=dev)

            # candidate pool: every state any chain visited (step-0
            # included)
            visited = np.concatenate(
                [inits[:, None, :], out["states"].cpu().numpy()],
                axis=1).reshape(-1, enc.ndim)
            visited = np.unique(visited, axis=0)
            vflat = np.ravel_multi_index(tuple(visited.T), sub.shape)
            if self.acquisition == "ei":
                # lower score = measured earlier, so negate the
                # improvement
                acq = -expected_improvement(
                    mean[vflat], unc[vflat], self._best(t)[1])
            else:
                acq = mean[vflat] - self.kappa * unc[vflat]

            by_acq = np.argsort(acq, kind="stable")
            by_unc = np.argsort(-unc[vflat], kind="stable")
            chosen: list[int] = []
            for pos in (list(by_acq[:self.measures_per_round - n_exp])
                        + list(by_unc)):
                if pos not in chosen:
                    chosen.append(int(pos))
                if len(chosen) == self.measures_per_round:
                    break
            with span("surrogate.measure", cat="surrogate"):
                measured.extend(self._measure_states(
                    [visited[pos] + offs for pos in chosen], t))

        self.incumbent, best_y = self._best(t)
        rec = SurrogateRound(
            n=self._n, incumbent=self.incumbent, best_y=best_y,
            window_size=W, true_measures=self.true_measures,
            surrogate_queries=self.surrogate_queries,
            measured=tuple(measured))
        self.rounds.append(rec)
        if provenance.get() is not None:
            # armed-only audit pulls (not on the steady-state path)
            if self.device_loop:
                inits = inits.cpu().numpy()
                mean = mean_w.cpu().numpy().astype(np.float64)
                unc = unc_w.cpu().numpy().astype(np.float64)
            self._record_round_provenance(rec, prev_inc, measured, out,
                                          inits, mean, unc, sub)
        self._n += 1
        note_round("SurrogateAnnealer", self)
        return rec

    def _record_round_provenance(self, rec, prev_inc, measured, out,
                                 inits, mean, unc, sub) -> None:
        """One DecisionRecord per surrogate round.  Armed-only.

        The committed value IS a single real measurement (the store's
        best credible reading), so both decomposition tiers are the
        trivial one-term ladder.  The rest is the provenance: the
        runner-up *measured* candidate this round (counterfactual), and
        the temperature / acceptance probability at the incumbent chain's
        last accepted move on the acquisition surface (mean - kappa*unc),
        recovered from the round's walk outputs."""
        ys = out["ys"].cpu().numpy()
        accepts = out["accepts"].cpu().numpy()
        flat0 = np.ravel_multi_index(tuple(np.asarray(inits).T), sub.shape)
        y0 = mean[flat0] - self.kappa * unc[flat0]
        tau_at, p_at = chain_accept_stats(
            ys, accepts, y0,
            np.full((self.n_chains, self.steps_per_round), self.tau))
        rejected, rejected_y = None, float("nan")
        others = [(st, y) for st, y in measured
                  if tuple(st) != tuple(rec.incumbent)]
        if others:
            st, y = min(others, key=lambda sy: sy[1])
            rejected, rejected_y = tuple(st), float(y)
        terms = (("measured_y", rec.best_y),)
        provenance.record(provenance.DecisionRecord(
            controller="surrogate", round=int(rec.n), tenant="",
            action=("accept" if tuple(rec.incumbent) != tuple(prev_inc)
                    else "hold"),
            state=tuple(rec.incumbent), y=float(rec.best_y), terms=terms,
            exact_split=terms, tau=float(tau_at[0]),
            accept_prob=float(p_at[0]),
            rejected=rejected, rejected_y=rejected_y,
            counterfactual=(rejected_y - float(rec.best_y)
                            if rejected is not None else float("nan"))))

    def run(self, n_rounds: int) -> list[SurrogateRound]:
        return [self.round() for _ in range(n_rounds)]

    def _best(self, now: float) -> tuple[tuple[int, ...], float]:
        """Best measured state; on drifting landscapes (store.half_life
        set) only readings younger than 4 half-lives compete — beyond
        that a measurement has decayed to < 7% credibility."""
        hl = self.store.half_life
        return self.store.best(now=now,
                               max_age=None if hl is None else 4.0 * hl)

    def best(self) -> tuple[tuple[int, ...], float]:
        """Best measured (state, objective) — measurements, not estimates."""
        return self._best(float(self._n))

    def counts(self) -> dict[str, int]:
        """Cumulative evaluation counters.  Prefer :meth:`stats`, which
        embeds these in the unified controller contract."""
        return {"true_measures": self.true_measures,
                "surrogate_queries": self.surrogate_queries}

    def stats(self) -> dict[str, Any]:
        """The unified per-controller stats contract
        (:meth:`repro_torch.core.procurement.ControllerMixin.stats`) for
        the surrogate loop, which is not a ``ControllerMixin``: same keys,
        ``pipeline`` is always None (probes go through ``map_pool``, not a
        speculative pipeline), plus the store/refresh extras."""
        out: dict[str, Any] = {
            "controller": type(self).__name__,
            "rounds": self._n,
            **self.counts(),
            "pipeline": None,
            "store_size": len(self.store),
            "stale_refreshes": self.stale_refreshes,
        }
        reg = metrics.get()
        if reg is not None:
            out["metrics"] = reg.snapshot(prefix="surrogate")
        return out
