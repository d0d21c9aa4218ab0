"""The port's chain engine beyond ``anneal_fleet``, against the JAX engine.

Each walk is replayed step for step: the test re-creates the reference
entry point's own key schedule with ``jax.random`` and hands the draws to
the port's ``draws=``, and the walks must then agree exactly (states,
proposal objectives, accept flags and first-hit times).  The Fig. 4 curve
from the port's own generator is held to JAX's curve statistically."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import annealing as jann
from repro.core.landscape import bimodal_landscape, changed_landscape
from repro.core.state import ConfigSpace as JSpace, Dimension as JDim
from repro_torch.core import annealing as pann
from repro_torch.core.state import ConfigSpace as PSpace, Dimension as PDim
from repro_torch.kernels import build, ops, ref

from test_torch_jax_draws import (
    chain_draws,
    dynamic_chain_draws,
    nd_chain_draws,
    numpy_draws as _np,
)


def _assert_walk(got, want, noisy=False):
    st, ys, acc = (t.numpy() for t in got)
    np.testing.assert_array_equal(st, np.asarray(want[0]))
    if noisy:
        # XLA contracts ``y + noise_std * n`` into one multiply-add, torch
        # rounds the product first: the noisy objectives agree to an ulp
        np.testing.assert_allclose(ys, np.asarray(want[1]), rtol=1e-6,
                                   atol=1e-6)
    else:
        np.testing.assert_array_equal(ys, np.asarray(want[1]))
    np.testing.assert_array_equal(acc, np.asarray(want[2]))
    assert 0 < acc.mean() < 1                     # the walk did both


# ---------------------------------------------------------------------------
# The one-chain forms, replayed.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("noise_std", [0.0, 0.4])
@pytest.mark.parametrize("init", [0, 10, 47])
def test_anneal_chain_replays_jax_walk(init, noise_std):
    y = bimodal_landscape()
    key = jax.random.key(3 + init)
    S = 400
    taus = np.linspace(2.0, 0.3, S).astype(np.float32)
    want = jann.anneal_chain(key, jnp.asarray(y, jnp.float32), S, taus,
                             init=init, noise_std=noise_std)
    got = pann.anneal_chain(None, y, S, taus, init=init, noise_std=noise_std,
                            draws=_np(chain_draws(key, S)), device="cpu")
    _assert_walk(got, want, noisy=noise_std > 0)
    target = int(np.argmin(y))
    assert int(pann.first_hit_time(got[0], target)) == int(
        jann.first_hit_time(want[0], target))


def test_anneal_chain_single_state_landscape_stays_put():
    key = jax.random.key(0)
    want = jann.anneal_chain(key, jnp.ones((1,), jnp.float32), 30, 1.0)
    got = pann.anneal_chain(None, np.ones(1), 30, 1.0,
                            draws=_np(chain_draws(key, 30)), device="cpu")
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert (got[0] == 0).all()


@pytest.mark.parametrize("init", [0, 23])
def test_anneal_chain_dynamic_replays_jax_walk(init):
    y1, y2 = bimodal_landscape(), changed_landscape()
    S, change_at = 600, 200
    tables = np.stack([y1 if i < change_at else y2 for i in range(S)]) \
        .astype(np.float32)
    key = jax.random.key(7)
    want = jann.anneal_chain_dynamic(key, jnp.asarray(tables), S, 1.0,
                                     init=init)
    got = pann.anneal_chain_dynamic(
        None, tables, S, 1.0, init=init,
        draws=_np(dynamic_chain_draws(key, S)), device="cpu")
    _assert_walk(got, want)


def _space(mod_space, mod_dim, valid):
    dims = (mod_dim("a", tuple(range(6))),
            mod_dim("b", ("x", "y", "z"), kind="categorical"),
            mod_dim("c", tuple(range(4))))
    rule = (lambda cfg: cfg["a"] + cfg["c"] <= 6) if valid else None
    return mod_space(dims, rule)


@pytest.mark.parametrize("case", ["static", "masked", "dynamic", "noise"])
def test_anneal_chain_nd_replays_jax_walk(case):
    valid = case == "masked"
    enc_j = _space(JSpace, JDim, valid).encoded()
    enc_p = _space(PSpace, PDim, valid).encoded()
    S = 300
    rng = np.random.default_rng(len(case))
    time = (S,) if case == "dynamic" else ()
    table = rng.uniform(0.0, 2.0, time + enc_j.shape).astype(np.float32)
    taus = rng.uniform(0.2, 1.0, S).astype(np.float32)
    noise_std = 0.3 if case == "noise" else 0.0
    key = jax.random.key(21)
    kw = dict(noise_std=noise_std)
    if case == "static":
        kw["init"] = (5, 2, 3)
    want = jann.anneal_chain_nd(key, enc_j, table, S, taus, **kw)
    got = pann.anneal_chain_nd(
        None, enc_p, table, S, taus, **kw,
        draws=_np(nd_chain_draws(key, enc_j.shape, S)), device="cpu")
    assert got[0].shape == (S, 3)
    _assert_walk(got, want, noisy=noise_std > 0)
    if valid:
        assert enc_p.valid_mask[tuple(got[0].numpy().T)].all()


def test_first_hit_time_matches_reference():
    rng = np.random.default_rng(4)
    for _ in range(20):
        states = rng.integers(0, 6, 50)
        for target in range(7):
            assert int(pann.first_hit_time(torch.as_tensor(states),
                                           target)) == \
                int(jann.first_hit_time(jnp.asarray(states), target))
    batch = rng.integers(0, 4, (8, 30))
    got = pann.first_hit_time(torch.as_tensor(batch), 3).numpy()
    want = [int(jann.first_hit_time(jnp.asarray(r), 3)) for r in batch]
    assert list(got) == want


# ---------------------------------------------------------------------------
# The sweeps.
# ---------------------------------------------------------------------------


def test_jobs_to_min_vs_tau_replays_jax_hits():
    y = bimodal_landscape()
    taus, n_seeds, S = [0.5, 1.0, 3.0], 6, 500
    key = jax.random.key(5)
    want = jann.jobs_to_min_vs_tau(key, y, taus, n_seeds=n_seeds,
                                   n_steps=S, init=4)
    draws = []
    for i in range(len(taus)):
        keys = jax.random.split(jax.random.fold_in(key, i), n_seeds)
        draws.append(_np(jax.vmap(chain_draws, (0, None))(keys, S)))
    got = pann.jobs_to_min_vs_tau(None, y, taus, n_seeds=n_seeds, n_steps=S,
                                  init=4, draws=draws, device="cpu")
    np.testing.assert_array_equal(got["raw"], want["raw"])
    for k in ("taus", "mean_jobs", "std_jobs"):
        np.testing.assert_array_equal(got[k], want[k])
    assert (got["raw"] < S).any() and (got["raw"] == S).any()


def test_jobs_to_min_vs_tau_fleet_replays_jax_hits():
    y = bimodal_landscape()
    space_j = JSpace((JDim("cores", tuple(range(len(y)))),))
    space_p = PSpace((PDim("cores", tuple(range(len(y)))),))
    taus, n_seeds, S = [0.5, 2.0], 8, 600
    key = jax.random.key(9)
    want = jann.jobs_to_min_vs_tau_fleet(key, space_j, y, taus,
                                         n_seeds=n_seeds, n_steps=S,
                                         init=(0,))
    k, _ = jax.random.split(key)               # (key, k_init)
    keys = jax.random.split(k, len(taus) * n_seeds)
    draws = _np(jax.vmap(nd_chain_draws, (0, None, None))(keys, (len(y),),
                                                          S))
    got = pann.jobs_to_min_vs_tau_fleet(None, space_p, y, taus,
                                        n_seeds=n_seeds, n_steps=S,
                                        init=(0,), draws=draws, device="cpu")
    np.testing.assert_array_equal(got["raw"], want["raw"])
    np.testing.assert_array_equal(got["mean_jobs"], want["mean_jobs"])


def test_fig4_curve_from_the_ports_generator_agrees_with_jax():
    """Fig. 4 at its published size (64 seeds x 4,000 steps, the five
    temperatures of ``benchmarks/paper_figures.py``): each temperature's
    mean first-hit time from the port's own generator lies within 3
    standard errors of JAX's (the standard error of the difference of the
    two means, sqrt(s_jax^2 + s_port^2) / sqrt(64)); where every JAX chain
    sits at the 4,000 cap, every port chain does too."""
    y = bimodal_landscape()
    taus = [0.25, 0.5, 1.0, 2.0, 4.0]
    n, S = 64, 4000
    want = jann.jobs_to_min_vs_tau_fleet(
        jax.random.key(0), JSpace((JDim("cores", tuple(range(len(y)))),)),
        y, taus, n_seeds=n, n_steps=S, init=(0,))
    got = pann.jobs_to_min_vs_tau_fleet(
        torch.Generator().manual_seed(0),
        PSpace((PDim("cores", tuple(range(len(y)))),)), y, taus,
        n_seeds=n, n_steps=S, init=(0,), device="cpu")
    for i, tau in enumerate(taus):
        mj, mp = want["mean_jobs"][i], got["mean_jobs"][i]
        if (want["raw"][i] == S).all():
            assert mj == mp == S, (tau, mj, mp)
            continue
        se = np.sqrt((want["std_jobs"][i] ** 2 + got["std_jobs"][i] ** 2)
                     / n)
        assert abs(mp - mj) <= 3 * se, (tau, mj, mp, se)
    m = got["mean_jobs"]
    assert all(m[i] > m[i + 1] for i in range(len(m) - 1))


# ---------------------------------------------------------------------------
# fleet_chains and its bucket padding.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n,multiple", [(1, 1), (2, 1), (5, 1), (64, 1),
                                        (65, 1), (1000, 1), (3, 4),
                                        (5, 3), (9, 8)])
def test_chain_bucket_matches_reference(n, multiple):
    assert pann.chain_bucket(n, multiple) == jann.chain_bucket(n, multiple)


def test_chain_bucket_refuses_zero():
    with pytest.raises(ValueError):
        pann.chain_bucket(0)


def _fleet_inputs(C, S, valid, seed=0):
    space = _space(PSpace, PDim, valid)
    enc = space.encoded()
    rng = np.random.default_rng(seed)
    tables = rng.uniform(0.0, 2.0, (C, enc.size())).astype(np.float32)
    taus = rng.uniform(0.2, 1.0, (C, S)).astype(np.float32)
    flat_valid = np.flatnonzero(
        enc.valid_mask.reshape(-1) if valid else np.ones(enc.size()))
    inits = np.stack(np.unravel_index(rng.choice(flat_valid, C), enc.shape),
                     -1).astype(np.int32)
    extra = rng.uniform(0.0, 0.5, (C, enc.size())).astype(np.float32)
    valid_flat = None if not valid else enc.valid_mask.reshape(-1)
    return enc, tables, taus, inits, extra, valid_flat


@pytest.mark.parametrize("valid", [False, True])
@pytest.mark.parametrize("noise_std", [0.0, 0.2])
def test_fleet_chains_padding_changes_no_row(valid, noise_std):
    C, S = 5, 40
    enc, tables, taus, inits, extra, vf = _fleet_inputs(C, S, valid)
    kw = dict(shape=enc.shape, categorical=enc.categorical,
              noise_std=noise_std, device="cpu")
    padded = pann.fleet_chains(torch.Generator().manual_seed(1), tables, vf,
                               taus, inits, extra, bucket=True, **kw)
    flat = pann.fleet_chains(torch.Generator().manual_seed(1), tables, vf,
                             taus, inits, extra, bucket=False, **kw)
    fleet = pann.anneal_fleet(torch.Generator().manual_seed(1), enc,
                              tables.reshape((C,) + enc.shape), S, taus,
                              inits=inits, noise_std=noise_std,
                              per_chain_tables=True, extra_costs=extra,
                              device="cpu")
    for a, b, k in zip(padded, flat, ("states", "ys", "accepts")):
        assert a.shape[0] == C
        assert torch.equal(a, b)
        assert torch.equal(a, fleet[k])


def test_fleet_chains_pads_every_input_by_chain_zero(monkeypatch):
    C, S = 3, 12
    enc, tables, taus, inits, extra, vf = _fleet_inputs(C, S, True, seed=2)
    seen = {}

    def spy(inits_, table, taus_, axis, up, pick, uniform, **kw):
        seen.update(inits=inits_, table=table, taus=taus_, axis=axis,
                    extra=kw["extra"])
        return ref.anneal_walk_ref(inits_, table, taus_, axis, up, pick,
                                   uniform, **kw)

    monkeypatch.setattr(ops, "anneal_walk", spy)
    pann.fleet_chains(torch.Generator().manual_seed(0), tables, vf, taus,
                      inits, extra, shape=enc.shape,
                      categorical=enc.categorical, device="cpu")
    for k, v in seen.items():
        assert v.shape[0] == 4                    # chain_bucket(3)
        assert torch.equal(v[3], v[0])
    assert torch.equal(seen["table"][:C], torch.as_tensor(tables))


def test_fleet_chains_replays_jax_walk():
    C, S = 5, 50
    enc, tables, taus, inits, extra, vf = _fleet_inputs(C, S, True, seed=3)
    enc_j = _space(JSpace, JDim, True).encoded()
    keys = jax.random.split(jax.random.key(13), C)
    want = jann.fleet_chains(keys, tables, jnp.asarray(vf), taus, inits,
                             extra, shape=enc_j.shape,
                             categorical=enc_j.categorical)
    draws = _np(jax.vmap(nd_chain_draws, (0, None, None))(keys, enc.shape,
                                                          S))
    got = pann.fleet_chains(None, tables, vf, taus, inits, extra,
                            shape=enc.shape, categorical=enc.categorical,
                            draws=draws, device="cpu")
    _assert_walk(got, want)


def test_fleet_chains_refuses_mismatched_inputs():
    enc, tables, taus, inits, extra, vf = _fleet_inputs(4, 10, False)
    with pytest.raises(ValueError, match="taus"):
        pann.fleet_chains(None, tables, vf, taus[:3], inits, extra,
                          shape=enc.shape, categorical=enc.categorical,
                          device="cpu")
    with pytest.raises(ValueError, match="states"):
        pann.fleet_chains(None, tables[:, :-1], vf, taus, inits, extra,
                          shape=enc.shape, categorical=enc.categorical,
                          device="cpu")


# ---------------------------------------------------------------------------
# The walk kernel's wrapper on the CPU.
# ---------------------------------------------------------------------------


def test_build_lists_the_walk_kernel():
    assert build.SOURCES["anneal_walk"] == ("-fmad=false",)
    assert [p.name for p in build.sources("anneal_walk")] == [
        "anneal_walk.cu"]
    assert "anneal_walk" in ops.LAUNCHES


def test_anneal_walk_on_cpu_runs_the_plain_version(monkeypatch):
    calls = []
    real = ref.anneal_walk_ref

    def spy(*a, **kw):
        calls.append(1)
        return real(*a, **kw)

    monkeypatch.setattr(ref, "anneal_walk_ref", spy)
    enc, tables, taus, inits, extra, vf = _fleet_inputs(3, 9, True)
    n0 = ops.LAUNCHES["anneal_walk"]
    out = pann.anneal_fleet(torch.Generator().manual_seed(0), enc,
                            tables.reshape((3,) + enc.shape), 9, taus,
                            inits=inits, per_chain_tables=True,
                            extra_costs=extra, device="cpu")
    assert calls == [1]                           # one walk for the call
    assert ops.LAUNCHES["anneal_walk"] == n0      # no kernel on the CPU
    assert out["states"].dtype == torch.int32
    assert out["ys"].dtype == torch.float32
    assert out["accepts"].dtype == torch.bool


def test_anneal_walk_refuses_what_it_does_not_take():
    C, S = 2, 5
    z = torch.zeros((C, S), dtype=torch.int64)
    u = torch.rand((C, S))
    t = torch.ones((C, S))
    up = torch.zeros((C, S), dtype=torch.bool)
    inits = torch.zeros((C, 2), dtype=torch.int32)
    kw = dict(shape=(3, 4), categorical=(False, True))
    with pytest.raises(ValueError, match="table shape"):
        ops.anneal_walk(inits, torch.zeros(11), t, z, up, z, u, **kw)
    with pytest.raises(ValueError, match="inits shape"):
        ops.anneal_walk(inits[:, :1], torch.zeros(12), t, z, up, z, u, **kw)
    with pytest.raises(ValueError, match="noise"):
        ops.anneal_walk(inits, torch.zeros(12), t, z, up, z, u, **kw,
                        noise_std=0.5)
    with pytest.raises(ValueError, match="categorical"):
        ops.anneal_walk(inits, torch.zeros(12), t, z, up, z, u,
                        shape=(3, 4), categorical=(False,))
