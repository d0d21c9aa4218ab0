"""The port's chain engine against the JAX engine, step for step.

torch cannot reproduce JAX's threefry keys, so the test replays the JAX
engine's key schedule with ``jax.random`` and hands the resulting draws to
the port's ``anneal_fleet(draws=...)``: the walks must then agree exactly
(states, proposal objectives, accept flags)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import annealing as jann
from repro.core.state import ConfigSpace as JSpace, Dimension as JDim
from repro_torch.core import annealing as pann
from repro_torch.core.state import ConfigSpace as PSpace, Dimension as PDim


@functools.partial(jax.jit, static_argnums=(1, 2, 3))
def jax_draws(key, shape, C, S):
    """The draws ``repro.core.annealing.anneal_fleet`` makes from ``key``:
    ``split(key)`` -> ``split(key, C)``; per chain ``split`` for the
    initial measurement, then per step ``split(key, 4)`` into (next,
    proposal, measurement, acceptance) and ``split(k_prop, 3)`` into
    (axis, direction, categorical); the categorical ``randint``'s upper
    bound is ``max(n - 1, 1)`` for the drawn axis's size ``n``."""
    key, _ = jax.random.split(key)
    keys = jax.random.split(key, C)
    ndim = len(shape)
    sizes = jnp.asarray(shape, jnp.int32)

    def chain(k):
        k, k0 = jax.random.split(k)

        def body(k, _):
            k, k_prop, k_meas, k_acc = jax.random.split(k, 4)
            k_axis, k_dir, k_cat = jax.random.split(k_prop, 3)
            axis = jax.random.randint(k_axis, (), 0, ndim)
            pick = jax.random.randint(
                k_cat, (), 0, jnp.maximum(sizes[axis] - 1, 1))
            return k, (axis, jax.random.bernoulli(k_dir), pick,
                       jax.random.uniform(k_acc),
                       jax.random.normal(k_meas, ()))

        _, out = jax.lax.scan(body, k, None, length=S)
        return out + (jax.random.normal(k0, ()),)

    axis, up, pick, u, noise, noise0 = jax.vmap(chain)(keys)
    return {"axis": axis, "up": up, "pick": pick, "uniform": u,
            "noise": noise, "noise0": noise0}


def _space(space_cls, dim_cls, valid):
    dims = (dim_cls("a", tuple(range(5))),
            dim_cls("b", ("x", "y", "z", "w"), kind="categorical"),
            dim_cls("c", (0,)),
            dim_cls("d", tuple(range(3))))
    rule = (lambda cfg: cfg["a"] + cfg["d"] <= 5) if valid else None
    return space_cls(dims, rule)


CASES = {
    "static": {},
    "masked": {"valid": True},
    "extra_costs": {"extra": True},
    "per_chain": {"per_chain": True},
    "dynamic": {"dynamic": True},
    "noise": {"noise_std": 0.3},
}


@pytest.mark.parametrize("case", list(CASES))
def test_anneal_fleet_replays_jax_walk_exactly(case):
    opt = CASES[case]
    C, S = 6, 40
    valid = opt.get("valid", False)
    enc_j = _space(JSpace, JDim, valid).encoded()
    enc_p = _space(PSpace, PDim, valid).encoded()
    shape = enc_j.shape
    rng = np.random.default_rng(sum(map(ord, case)))
    lead = (C,) if opt.get("per_chain") else ()
    time = (S,) if opt.get("dynamic") else ()
    table = rng.uniform(0.0, 2.0, lead + time + shape).astype(np.float32)
    taus = rng.uniform(0.2, 1.0, (C, S)).astype(np.float32)
    flat_valid = np.flatnonzero(
        enc_j.valid_mask.reshape(-1) if valid else np.ones(enc_j.size()))
    inits = np.stack(np.unravel_index(
        rng.choice(flat_valid, C), shape), -1).astype(np.int32)
    extra = (rng.uniform(0.0, 0.5, (C, enc_j.size())).astype(np.float32)
             if opt.get("extra") else None)
    kw = dict(inits=inits, n_chains=C, noise_std=opt.get("noise_std", 0.0),
              per_chain_tables=bool(lead), extra_costs=extra)

    key = jax.random.key(11)
    want = jann.anneal_fleet(key, enc_j, table, S, taus, **kw)
    got = pann.anneal_fleet(None, enc_p, table, S, taus, **kw,
                            draws={k: np.array(v) for k, v in
                                   jax_draws(key, shape, C, S).items()},
                            device="cpu")
    np.testing.assert_array_equal(got["states"].numpy(),
                                  np.asarray(want["states"]))
    if kw["noise_std"] > 0:
        # XLA contracts ``y + noise_std * n`` into one multiply-add, torch
        # rounds the product first: the noisy objectives agree to an ulp
        np.testing.assert_allclose(got["ys"].numpy(), np.asarray(want["ys"]),
                                   rtol=1e-6, atol=1e-6)
    else:
        np.testing.assert_array_equal(got["ys"].numpy(),
                                      np.asarray(want["ys"]))
    np.testing.assert_array_equal(got["accepts"].numpy(),
                                  np.asarray(want["accepts"]))
    acc = got["accepts"].numpy()
    assert 0 < acc.mean() < 1                     # the walk did both


def test_anneal_fleet_generator_walk_is_seeded_and_valid():
    space = _space(PSpace, PDim, True)
    enc = space.encoded()
    table = np.random.default_rng(0).uniform(size=enc.shape)
    runs = [pann.anneal_fleet(torch.Generator().manual_seed(5), enc, table,
                              30, 0.5, n_chains=4, device="cpu")
            for _ in range(2)]
    for k in ("states", "ys", "accepts", "inits"):
        assert torch.equal(runs[0][k], runs[1][k])
    st = runs[0]["states"].numpy().reshape(-1, enc.ndim)
    assert enc.valid_mask[tuple(st.T)].all()      # masked moves rejected
    assert runs[0]["states"].dtype == torch.int32
    assert runs[0]["ys"].dtype == torch.float32


def test_random_valid_states_cover_only_the_valid_region():
    space = _space(PSpace, PDim, True)
    enc = space.encoded()
    st = pann.random_valid_states(torch.Generator().manual_seed(1), enc,
                                  500, device="cpu").numpy()
    assert st.dtype == np.int32 and st.shape == (500, enc.ndim)
    assert enc.valid_mask[tuple(st.T)].all()
    assert len({tuple(r) for r in st}) > 20
