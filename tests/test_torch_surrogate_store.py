"""The port's ``DeviceMeasurementStore`` and on-device selection against
the reference's: the store held to both the JAX twin and the numpy store
(each case of ``tests/test_device_store.py``, the row layout, the batched
flush, held views), and ``_select`` to ``_select_jit`` on the same
float32 inputs.  Everything here runs on the CPU (the store's arrays on
``device="cpu"``)."""

import jax.numpy as jnp
import numpy as np
from jax.lax import erf as jax_erf
import pytest
import torch

from repro.core import surrogate as jsur
from repro.core.state import ConfigSpace as JConfigSpace
from repro.core.state import Dimension as JDimension
from repro_torch.core import surrogate as psur
from repro_torch.core.state import ConfigSpace, Dimension


def _enc():
    space = ConfigSpace((
        Dimension("ord", tuple(range(6))),
        Dimension("cat", ("x", "y", "z"), kind="categorical"),
    ))
    return psur.SpaceEncoding.from_space(space)


def _jenc():
    space = JConfigSpace((
        JDimension("ord", tuple(range(6))),
        JDimension("cat", ("x", "y", "z"), kind="categorical"),
    ))
    return jsur.SpaceEncoding.from_space(space)


def _trio(half_life=None, capacity=8192):
    """(numpy store, JAX device store, the port's device store)."""
    return (psur.MeasurementStore(2, half_life=half_life, capacity=capacity),
            jsur.DeviceMeasurementStore(_jenc(), half_life=half_life,
                                        capacity=capacity),
            psur.DeviceMeasurementStore(_enc(), half_life=half_life,
                                        capacity=capacity, device="cpu"))


def _add(stores, s, y, t):
    for st in stores:
        st.add(s, y, t)


def _assert_snapshot_parity(host, jdev, dev):
    hs, hy, ht = host.arrays()
    for got in (dev.snapshot(), jdev.snapshot()):
        np.testing.assert_array_equal(got[0], hs)
        # float32 on the device; the adds use exactly representable values
        np.testing.assert_array_equal(got[1], hy.astype(np.float32))
        np.testing.assert_array_equal(got[2], ht.astype(np.float32))
    assert len(dev) == len(host) == len(jdev)
    for s in hs:
        assert tuple(int(v) for v in s) in dev


def _assert_rows_equal(jdev, dev):
    """Row for row: the port's arrays equal the JAX store's."""
    dev.flush()
    for name in ("_states", "_feats", "_ys", "_ts", "_seq", "_wmask"):
        np.testing.assert_array_equal(getattr(dev, name).numpy(),
                                      np.asarray(getattr(jdev, name)),
                                      err_msg=name)


def _random_adds(rng, n, t_max=50):
    return [((int(rng.integers(6)), int(rng.integers(3))),
             float(np.float32(rng.normal() * 10.0)),
             float(rng.integers(0, t_max))) for _ in range(n)]


def test_insert_and_snapshot_parity_randomized():
    host, jdev, dev = _trio()
    for s, y, t in _random_adds(np.random.default_rng(11), 120):
        _add((host, jdev, dev), s, y, t)
    _assert_snapshot_parity(host, jdev, dev)
    assert dev.best() == jdev.best() == (host.best()[0],
                                         np.float32(host.best()[1]))


def test_latest_wins_dedup_and_refresh_order():
    host, jdev, dev = _trio()
    for s, y, t in [((0, 1), 5.0, 0.0), ((3, 2), 7.0, 1.0),
                    ((0, 1), 4.0, 4.0)]:      # re-measure: replace, re-stamp
        _add((host, jdev, dev), s, y, t)
    _assert_snapshot_parity(host, jdev, dev)
    ds, dy, _ = dev.snapshot()
    assert ds.tolist() == [[3, 2], [0, 1]]     # refresh order
    assert dy.tolist() == [7.0, 4.0]
    assert dev.best() == ((0, 1), 4.0)


def test_capacity_evicts_stalest_parity():
    host, jdev, dev = _trio(capacity=2)
    for s, y, t in [((0, 0), 1.0, 0.0), ((1, 0), 2.0, 1.0),
                    ((0, 0), 1.5, 2.0),       # refresh keeps (0,0) newest
                    ((2, 0), 3.0, 3.0),       # evicts (1,0), the stalest
                    ((3, 1), 0.5, 4.0)]:      # evicts (0,0)
        _add((host, jdev, dev), s, y, t)
    _assert_snapshot_parity(host, jdev, dev)
    assert dev.snapshot()[0].tolist() == [[2, 0], [3, 1]]
    assert (1, 0) not in dev and (0, 0) not in dev
    _assert_rows_equal(jdev, dev)


def test_recency_decay_weights_parity():
    host, jdev, dev = _trio(half_life=2.0)
    for s, y, t in [((0, 1), 5.0, 0.0), ((3, 2), 7.0, 1.0),
                    ((5, 0), 6.0, 4.0)]:
        _add((host, jdev, dev), s, y, t)
    hw = host.weights(now=4.0)                 # refresh order
    dw = dev.weights_device(4.0).numpy()
    assert (dw[len(dev):] == 0.0).all()
    # no eviction here, so row order == insert order == refresh order.
    # The port's float32 exp2 is correctly rounded; XLA's on the CPU is
    # off by up to ~9e-7 relative, so both are held to the reference
    # test's own 1e-6
    np.testing.assert_allclose(dw[:len(dev)], hw, rtol=1e-6)
    np.testing.assert_allclose(dw, np.asarray(jdev.weights_device(4.0)),
                               rtol=1e-6)


@pytest.mark.parametrize("now,max_age", [
    (10.0, 100.0),     # everything fresh
    (10.0, 6.5),       # the early low reading ages out
    (10.0, 0.5),       # everything stale -> unrestricted fallback
])
def test_best_drift_aging_parity(now, max_age):
    host, jdev, dev = _trio(half_life=3.0)
    for s, y, t in [((0, 0), 1.0, 0.0),        # lowest, but old
                    ((1, 1), 2.0, 5.0),
                    ((2, 2), 3.0, 9.0)]:
        _add((host, jdev, dev), s, y, t)
    hk, hy = host.best(now=now, max_age=max_age)
    assert dev.best(now=now, max_age=max_age) == (hk, np.float32(hy))
    assert dev.best(now=now, max_age=max_age) == jdev.best(now=now,
                                                           max_age=max_age)


def test_best_ties_break_by_refresh_order():
    host, jdev, dev = _trio()
    for s, y, t in [((4, 0), 2.0, 0.0), ((1, 1), 2.0, 1.0),
                    ((3, 2), 5.0, 2.0), ((4, 0), 2.0, 3.0)]:  # re-stamped
        _add((host, jdev, dev), s, y, t)
    assert dev.best() == jdev.best() == ((1, 1), 2.0) \
        == (host.best()[0], host.best()[1])


def test_load_resyncs_from_numpy_store_and_stays_in_step():
    host = psur.MeasurementStore(2, half_life=2.0)
    rng = np.random.default_rng(3)
    for _ in range(30):                        # out-of-band adds
        host.add((int(rng.integers(6)), int(rng.integers(3))),
                 float(np.float32(rng.normal())), float(rng.integers(20)))
    jdev = jsur.DeviceMeasurementStore(_jenc(), half_life=2.0)
    dev = psur.DeviceMeasurementStore(_enc(), half_life=2.0, device="cpu")
    jdev.load(host)
    dev.load(host)
    _assert_snapshot_parity(host, jdev, dev)
    _assert_rows_equal(jdev, dev)
    for s, y, t in [((0, 0), -5.0, 21.0), ((5, 2), -6.0, 22.0)]:
        _add((host, jdev, dev), s, y, t)
    _assert_snapshot_parity(host, jdev, dev)
    _assert_rows_equal(jdev, dev)
    assert dev.best(now=22.0, max_age=5.0) == host.best(now=22.0,
                                                        max_age=5.0)


def test_held_views_survive_later_adds():
    """Views handed out before an add stay unchanged after it: the flush
    scatters into a copy of the arrays, as the reference's donating insert
    leaves a caller's arrays alone.  With and without decay (without it
    ``weights_device`` hands out the mask itself)."""
    for half_life in (4.0, None):
        host, jdev, dev = _trio(half_life=half_life)
        rng = np.random.default_rng(5)
        for i in range(8):
            _add((host, jdev, dev),
                 (int(rng.integers(6)), int(rng.integers(3))), float(i),
                 float(i))
        held = [*dev.refit_view(now=8.0), dev.weights_device(8.0),
                dev.y_scale_device(), *dev.best_device(8.0)]
        before = [h.clone() for h in held]
        for i in range(8, 40):
            _add((host, jdev, dev),
                 (int(rng.integers(6)), int(rng.integers(3))), float(i),
                 float(i))
            # interleaved reads through every accessor stay coherent
            assert len(dev) == len(host)
            assert dev.best()[0] == host.best()[0]
        for h, b in zip(held, before):
            assert torch.equal(h, b)
        _assert_snapshot_parity(host, jdev, dev)
        _assert_rows_equal(jdev, dev)


@pytest.mark.parametrize("capacity", [8192, 5])
def test_row_layout_equals_jax(capacity):
    """The same adds leave the same rows as JAX's store, row for row
    (``fused_interp`` sums over the rows in order), evictions included."""
    host, jdev, dev = _trio(half_life=2.0, capacity=capacity)
    for s, y, t in _random_adds(np.random.default_rng(7), 60):
        _add((host, jdev, dev), s, y, t)
    _assert_rows_equal(jdev, dev)
    for now in (0.0, 25.0, 49.0):
        (f, y, w), (jf, jy, jw) = dev.refit_view(now), jdev.refit_view(now)
        np.testing.assert_array_equal(f.numpy(), np.asarray(jf))
        np.testing.assert_array_equal(y.numpy(), np.asarray(jy))
        # exp2: see test_recency_decay_weights_parity
        np.testing.assert_allclose(w.numpy(), np.asarray(jw), rtol=1e-6)
    assert float(dev.y_scale_device()) == float(jdev.y_scale_device())


@pytest.mark.parametrize("capacity", [8192, 4])
def test_batched_flush_equals_adds_one_at_a_time(capacity):
    """Adds staged over many rounds and written in one flush leave the
    store exactly as adds flushed one by one do — a key added twice in
    one batch (the last add wins) and evictions inside a batch included."""
    one = psur.DeviceMeasurementStore(_enc(), half_life=3.0,
                                      capacity=capacity, device="cpu")
    batched = psur.DeviceMeasurementStore(_enc(), half_life=3.0,
                                          capacity=capacity, device="cpu")
    rng = np.random.default_rng(2)
    for batch in range(6):
        adds = _random_adds(rng, 9) + [((1, 1), float(batch), 0.5),
                                       ((1, 1), float(batch) + 0.5, 1.5)]
        for s, y, t in adds:
            one.add(s, y, t)
            one.flush()
            batched.add(s, y, t)
        carry = batched.flush(np.asarray([batch, -batch], np.int32))
        assert carry.tolist() == [batch, -batch]
        assert torch.equal(one._buf, batched._buf)
    assert one.snapshot()[0].tolist() == batched.snapshot()[0].tolist()
    assert batched.flush() is None             # nothing staged, no carry


def test_refit_view_padding_is_inert():
    _, _, dev = _trio()
    for i in range(5):
        dev.add((i, i % 3), float(i + 1), float(i))
    feats, ys, rec = dev.refit_view(now=5.0)
    n = len(dev)
    assert feats.shape[0] >= n and feats.shape[0] == ys.shape[0]
    assert (rec[n:] == 0.0).all()
    assert (feats[n:] >= 1e3).all()
    bigger = dev.refit_view(now=5.0, m_bucket=2 * feats.shape[0])
    assert torch.equal(bigger[0][:n], feats[:n])
    assert (bigger[2][n:] == 0.0).all()


def test_empty_and_validation_errors_match_numpy_semantics():
    host, _, dev = _trio()
    with pytest.raises(ValueError):
        dev.best()
    with pytest.raises(ValueError):
        host.best()
    with pytest.raises(ValueError):
        dev.add((1,), 0.0, 0.0)                # wrong rank
    with pytest.raises(ValueError):
        psur.DeviceMeasurementStore(_enc(), capacity=0, device="cpu")
    with pytest.raises(ValueError):
        psur.DeviceMeasurementStore(_enc(), half_life=0.0, device="cpu")
    s, y, t = dev.snapshot()
    assert s.shape == (0, 2) and len(y) == 0 and len(t) == 0


def test_y_scale_matches_numpy_predict_formula():
    _, jdev, dev = _trio()
    for st in (jdev, dev):
        st.add((0, 0), 2.0, 0.0)
        st.add((1, 1), 6.0, 1.0)
    assert float(dev.y_scale_device()) == float(jdev.y_scale_device()) \
        == 4.0                                 # spread
    flat = psur.DeviceMeasurementStore(_enc(), device="cpu")
    flat.add((0, 0), -3.0, 0.0)
    flat.add((1, 1), -3.0, 1.0)
    assert float(flat.y_scale_device()) == 3.0  # max(1, |mean|) when flat


def test_device_store_refuses_the_card_without_one():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="cuda"):
        psur.DeviceMeasurementStore(_enc())


# ---------------------------------------------------------------------------
# _select against _select_jit
# ---------------------------------------------------------------------------


def _select_inputs(seed, shape, C, S, levels=None, span=None, ei_near=None):
    """Chains' starts and states on ``shape`` (visits drawn from the
    first ``span`` flat states, so duplicates are common), and window
    means and uncertainties, float32; with ``levels`` the means take few
    values, so acquisition ties are common.  With ``ei_near`` (a y_best)
    the means lie about it and every uncertainty is at least 1, so each
    EI's erf argument stays where XLA's float32 erf does not saturate
    (see test_select_ei_differs_only_where_xla_erf_saturates)."""
    rng = np.random.default_rng(seed)
    W = int(np.prod(shape))
    span = W if span is None else span
    flat = rng.integers(0, span, (C, S + 1))
    idx = np.stack(np.unravel_index(flat, shape), -1).astype(np.int32)
    if ei_near is None:
        mean = rng.normal(5.0, 2.0, W)
        unc = np.abs(rng.normal(0.0, 1.0, W))
        unc[rng.random(W) < 0.2] = 0.0         # measured states
    else:
        mean = rng.normal(ei_near, 1.0, W)
        unc = 1.0 + np.abs(rng.normal(0.0, 1.0, W))
    if levels is not None:
        mean = np.round(mean * levels) / levels
        unc = np.round(unc * levels) / levels
    return (idx[:, 0], idx[:, 1:], mean.astype(np.float32),
            unc.astype(np.float32))


def _both(inputs, shape, acquisition, m, n_exp, kappa=1.0, y_best=4.0):
    inits, states, mean, unc = inputs
    want = np.asarray(jsur._select_jit(shape, acquisition, m, n_exp)(
        jnp.asarray(inits), jnp.asarray(states), jnp.asarray(mean),
        jnp.asarray(unc), jnp.float32(kappa), jnp.float32(y_best)))
    got = psur._select(
        torch.from_numpy(inits), torch.from_numpy(states),
        torch.from_numpy(mean), torch.from_numpy(unc), shape=shape,
        acquisition=acquisition, m=m, n_exp=n_exp, kappa=kappa,
        y_best=y_best)
    assert got.dtype == torch.int32
    return got.numpy(), want


@pytest.mark.parametrize("acquisition", ["lcb", "ei"])
@pytest.mark.parametrize("n_exp", [0, 1, 7])
def test_select_equals_select_jit(acquisition, n_exp):
    """The picks, the (m, ndim) states with their sentinels, equal JAX's
    exactly.  The scores behind them are float32 on both sides and are
    not compared: ``torch.erf`` may round an ulp from XLA's, which moves
    no pick here (ties are exact ties of equal inputs, quantized by
    ``levels``, or far apart)."""
    shape, m = (7, 3, 5), 8
    for seed in range(6):
        y_best = 3.0 + seed
        for levels, span in ((None, None), (4, None), (2, 12)):
            inputs = _select_inputs(
                seed, shape, 16, 24, levels, span,
                ei_near=y_best if acquisition == "ei" else None)
            got, want = _both(inputs, shape, acquisition, m, n_exp,
                              kappa=0.5 + seed, y_best=y_best)
            np.testing.assert_array_equal(got, want)


def test_select_ei_differs_only_where_xla_erf_saturates():
    """A difference by design, pinned.  XLA's float32 erf saturates at
    -0.9999998 for arguments below about -3.9 (``torch.erf`` gives -1), so
    a measured state (uncertainty 0) that is worse than ``y_best`` scores
    (mean - y_best) * ~1.2e-7 > 0 in JAX and exactly -0.0 in the port.
    Where the acquisition slots reach such zero-EI states, JAX takes them
    by mean and the port in flat order; the picks before them agree."""
    x = np.float32(-4.0)
    assert float(jnp.asarray(jax_erf(x))) == float(np.float32(-0.9999998))
    assert float(torch.erf(torch.tensor(x))) == -1.0
    shape = (8,)
    visited = np.arange(8, dtype=np.int32).reshape(1, 8, 1)
    mean = np.asarray([9, 8, 7, 6, 5, 1, 5, 7], np.float32)
    unc = np.asarray([0, 0, 0, 0, 0, 0, 0.5, 0], np.float32)
    got, want = _both((visited[:, 0], visited[:, 1:], mean, unc), shape,
                      "ei", 4, 0, y_best=4.0)
    # flat 5 (measured below y_best) and flat 6 (uncertain) first in both;
    # then the zero-EI measured states: JAX by mean (4: 5, then 3: 6), the
    # port in flat order (0, then 1)
    assert want[:, 0].tolist() == [5, 6, 4, 3]
    assert got[:, 0].tolist() == [5, 6, 0, 1]


@pytest.mark.parametrize("acquisition", ["lcb", "ei"])
def test_select_pads_with_sentinels_when_few_states_were_visited(
        acquisition):
    """Fewer than m distinct visited states: -1 rows after the picks."""
    shape, m = (4, 2), 6
    inits, states, mean, unc = _select_inputs(3, shape, 2, 5, span=3)
    got, want = _both((inits, states, mean, unc), shape, acquisition, m, 1)
    np.testing.assert_array_equal(got, want)
    n_distinct = len(np.unique(np.concatenate(
        [inits[:, None], states], 1).reshape(-1, 2), axis=0))
    assert n_distinct < m
    assert (got[n_distinct:] == -1).all() and (got[:n_distinct] >= 0).all()
