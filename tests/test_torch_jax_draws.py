"""The reference's key schedules, replayed with ``jax.random``: the
draws each JAX chain entry point makes from its key, in the port's
``draws=`` form (``repro_torch.core.annealing.DRAW_KEYS``), so that the
port's walks can be compared with JAX's step for step
(``test_torch_chains.py``, ``test_torch_procurement.py``,
``test_torch_fleet.py``, ``test_torch_trace_replay.py``).  The tests
here pin the replays' layout."""

import functools

import jax
import jax.numpy as jnp
import numpy as np


@functools.partial(jax.jit, static_argnums=(1,))
def chain_draws(key, S):
    """``anneal_chain``'s draws: ``split(key)`` -> (key, k0), then per
    step ``split(key, 5)`` -> (key, direction, noise, uniform, unused)."""
    key, k0 = jax.random.split(key)

    def body(k, _):
        k, k1, k2, k3, _ = jax.random.split(k, 5)
        return k, (jax.random.bernoulli(k1), jax.random.uniform(k3),
                   jax.random.normal(k2, ()))

    _, (up, u, noise) = jax.lax.scan(body, key, None, length=S)
    zeros = jnp.zeros((S,), jnp.int32)
    return {"axis": zeros, "up": up, "pick": zeros, "uniform": u,
            "noise": noise, "noise0": jax.random.normal(k0, ())}


@functools.partial(jax.jit, static_argnums=(1,))
def dynamic_chain_draws(key, S):
    """``anneal_chain_dynamic``'s: per step ``split(key, 3)`` -> (key,
    direction, uniform); no initial split."""

    def body(k, _):
        k, k1, k3 = jax.random.split(k, 3)
        return k, (jax.random.bernoulli(k1), jax.random.uniform(k3))

    _, (up, u) = jax.lax.scan(body, key, None, length=S)
    zeros = jnp.zeros((S,), jnp.int32)
    return {"axis": zeros, "up": up, "pick": zeros, "uniform": u}


@functools.partial(jax.jit, static_argnums=(1, 2))
def nd_chain_draws(key, shape, S):
    """``_chain_nd_core``'s, on the key itself: ``split(key)`` -> (key,
    k0), per step ``split(key, 4)`` -> (key, proposal, measurement,
    acceptance) and ``split(k_prop, 3)`` -> (axis, direction, pick)."""
    ndim = len(shape)
    sizes = jnp.asarray(shape, jnp.int32)
    key, k0 = jax.random.split(key)

    def body(k, _):
        k, k_prop, k_meas, k_acc = jax.random.split(k, 4)
        k_axis, k_dir, k_cat = jax.random.split(k_prop, 3)
        axis = jax.random.randint(k_axis, (), 0, ndim)
        pick = jax.random.randint(k_cat, (), 0,
                                  jnp.maximum(sizes[axis] - 1, 1))
        return k, (axis, jax.random.bernoulli(k_dir), pick,
                   jax.random.uniform(k_acc), jax.random.normal(k_meas, ()))

    _, (axis, up, pick, u, noise) = jax.lax.scan(body, key, None, length=S)
    return {"axis": axis, "up": up, "pick": pick, "uniform": u,
            "noise": noise, "noise0": jax.random.normal(k0, ())}


def numpy_draws(draws):
    """The draws as numpy arrays, as a test hands them to the port."""
    return {k: np.array(v) for k, v in draws.items()}


def test_replayed_draws_have_the_walks_layout():
    key = jax.random.key(0)
    one = numpy_draws(chain_draws(key, 7))
    assert {k: v.shape for k, v in one.items()} == {
        "axis": (7,), "up": (7,), "pick": (7,), "uniform": (7,),
        "noise": (7,), "noise0": ()}
    assert one["up"].dtype == bool and (one["axis"] == 0).all()
    dyn = numpy_draws(dynamic_chain_draws(key, 5))
    assert set(dyn) == {"axis", "up", "pick", "uniform"}
    nd = numpy_draws(jax.vmap(nd_chain_draws, (0, None, None))(
        jax.random.split(key, 3), (4, 1, 3), 9))
    assert nd["axis"].shape == (3, 9) and nd["noise0"].shape == (3,)
    assert ((0 <= nd["axis"]) & (nd["axis"] < 3)).all()
    # the pick is drawn in [0, max(n - 1, 1)) for the drawn axis's size n
    limit = np.maximum(np.asarray((4, 1, 3))[nd["axis"]] - 1, 1)
    assert ((0 <= nd["pick"]) & (nd["pick"] < limit)).all()
    assert ((0 <= nd["uniform"]) & (nd["uniform"] < 1)).all()


@functools.lru_cache(maxsize=None)
def _tenant_chain_draws(seed, r, stream_id, shape, S):
    key = jax.random.fold_in(jax.random.fold_in(jax.random.key(seed), r),
                             np.uint32(stream_id))
    return numpy_draws(nd_chain_draws(key, shape, S))


def fleet_draws(seed, r, ids, enc, S, *, device):
    """``FleetController``'s per-tenant draws as the reference makes them:
    each chain on ``fold_in(fold_in(key(seed), r), id)``, ``_chain_nd_core``'s
    schedule; the signature of ``repro_torch.core.annealing.tenant_draws``,
    which a test replaces with this."""
    rows = [_tenant_chain_draws(int(seed), int(r), int(i), tuple(enc.shape),
                                int(S)) for i in np.asarray(ids)]
    return {k: np.stack([d[k] for d in rows])
            for k in ("axis", "up", "pick", "uniform")}
