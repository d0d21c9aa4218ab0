"""The port's kernels against the JAX package's.

On the CPU the port's wrappers run their plain PyTorch versions; these are
held against the JAX Pallas kernels (in interpret mode, as the JAX
package's own tests run them) and against the JAX ``ref`` oracles, on the
same numpy inputs, at the JAX tests' tolerances.  The hand CUDA kernels
are held against the plain versions on the card in test_torch_gpu.py.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels import ref as jref
from repro.kernels.sizing_latency import sizing_latency as jax_sizing
from repro.kernels.surrogate_distance import fused_interp as jax_interp
from repro_torch.kernels import ops
from repro_torch.kernels import ref as pref

SIZING_TOL = dict(rtol=1e-5, atol=1e-7)      # tests/test_sizing.py
INTERP_TOL = dict(atol=2e-5, rtol=1e-4)      # tests/test_kernels.py


def _sizing_inputs(B, K, c_max, seed=None, load=(0.05, 0.9)):
    rng = np.random.default_rng(B + K if seed is None else seed)
    mu = rng.uniform(5.0, 60.0, (B, K)).astype(np.float32)
    repl = rng.integers(1, c_max + 1, (B, K)).astype(np.float32)
    lam = (rng.uniform(*load, (B, K)) * mu * repl).astype(np.float32)
    w = rng.uniform(0.0, 2.0, (B, K)).astype(np.float32)
    adj = np.triu(rng.random((K, K)) < 0.4, 1)
    return lam, mu, repl, w, adj


SIZING_SHAPES = [(1, 2, 1), (33, 6, 8), (64, 10, 6)]


@pytest.mark.parametrize("B,K,c_max", SIZING_SHAPES)
def test_sizing_latency_matches_pallas_and_ref(B, K, c_max):
    args = _sizing_inputs(B, K, c_max)
    soj, path = ops.sizing_latency(*map(torch.as_tensor, args), c_max=c_max)
    j = tuple(map(jnp.asarray, args))
    for want in (jax_sizing(*j, c_max=c_max),
                 jref.sizing_latency_ref(*j, c_max=c_max)):
        np.testing.assert_allclose(soj.numpy(), np.asarray(want[0]),
                                   **SIZING_TOL)
        np.testing.assert_allclose(path.numpy(), np.asarray(want[1]),
                                   **SIZING_TOL)


def test_sizing_latency_saturation_and_replicas_above_c_max():
    B, K = 16, 5
    lam, mu, repl, w, adj = _sizing_inputs(B, K, 4, seed=3)
    lam = (mu * repl * 1.5).astype(np.float32)           # all unstable
    soj, _ = ops.sizing_latency(*map(torch.as_tensor,
                                     (lam, mu, repl, w, adj)),
                                c_max=4, sat_s=777.0)
    assert (soj.numpy() == 777.0).all()
    # repl above c_max picks no Erlang-B term: p_wait = 0, sojourn 1/mu
    lam2 = (0.5 * mu).astype(np.float32)
    repl2 = np.full((B, K), 6.0, np.float32)
    soj2, _ = ops.sizing_latency(*map(torch.as_tensor,
                                      (lam2, mu, repl2, w, adj)), c_max=4)
    want = np.asarray(jref.sizing_latency_ref(
        *map(jnp.asarray, (lam2, mu, repl2, w, adj)), c_max=4)[0])
    np.testing.assert_array_equal(soj2.numpy(), want)
    np.testing.assert_allclose(soj2.numpy(), 1.0 / mu, rtol=1e-6)


INTERP_SHAPES = [(5, 3, 7), (300, 37, 9), (130, 256, 130)]


def _interp_inputs(Q, M, F):
    rng = np.random.default_rng(Q + M + F)
    return (rng.normal(size=(Q, F)).astype(np.float32),
            rng.normal(size=(M, F)).astype(np.float32),
            rng.normal(size=(M,)).astype(np.float32),
            rng.uniform(0.1, 1.0, size=(M,)).astype(np.float32))


@pytest.mark.parametrize("kind", ["idw", "rbf"])
@pytest.mark.parametrize("Q,M,F", INTERP_SHAPES)
def test_fused_interp_matches_pallas_and_ref(kind, Q, M, F):
    args = _interp_inputs(Q, M, F)
    mean, dmin = ops.fused_interp(*map(torch.as_tensor, args), kind=kind)
    j = tuple(map(jnp.asarray, args))
    for want in (jax_interp(*j, kind=kind),
                 jref.fused_interp_ref(*j, kind=kind)):
        np.testing.assert_allclose(mean.numpy(), np.asarray(want[0]),
                                   **INTERP_TOL)
        np.testing.assert_allclose(dmin.numpy(), np.asarray(want[1]),
                                   **INTERP_TOL)


def test_fused_interp_zero_weight_rows_contribute_nothing():
    rng = np.random.default_rng(7)
    xq = rng.normal(size=(17, 5)).astype(np.float32)
    xm = rng.normal(size=(12, 5)).astype(np.float32)
    y = rng.normal(size=(12,)).astype(np.float32)
    w = rng.uniform(0.2, 1.0, size=(12,)).astype(np.float32)
    xm_pad = np.concatenate([xm, np.full((20, 5), 1e3, np.float32)])
    y_pad = np.concatenate([y, np.full((20,), 99.0, np.float32)])
    w_pad = np.concatenate([w, np.zeros((20,), np.float32)])
    base, _ = ops.fused_interp(*map(torch.as_tensor, (xq, xm, y, w)))
    pad, _ = ops.fused_interp(*map(torch.as_tensor,
                                   (xq, xm_pad, y_pad, w_pad)))
    np.testing.assert_allclose(pad.numpy(), base.numpy(), **INTERP_TOL)
    want, _ = jax_interp(*map(jnp.asarray, (xq, xm_pad, y_pad, w_pad)))
    np.testing.assert_allclose(pad.numpy(), np.asarray(want), **INTERP_TOL)
    # all-zero weights: the recency-weighted global mean (here: 0/eps)
    zero, _ = ops.fused_interp(*map(torch.as_tensor,
                                    (xq, xm, y, np.zeros(12, np.float32))))
    want0, _ = jax_interp(*map(jnp.asarray,
                               (xq, xm, y, np.zeros(12, np.float32))))
    np.testing.assert_allclose(zero.numpy(), np.asarray(want0), **INTERP_TOL)


def test_pairwise_sqdist_ref_matches_jax_ref():
    xq, xm, _, _ = _interp_inputs(40, 23, 9)
    got = pref.pairwise_sqdist_ref(torch.as_tensor(xq), torch.as_tensor(xm))
    want = jref.pairwise_sqdist_ref(jnp.asarray(xq), jnp.asarray(xm))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **INTERP_TOL)


def test_wrappers_refuse_devices_they_cannot_serve():
    """No silent fallback: a device that is neither the CPU nor CUDA, or a
    mix of devices, raises instead of running the plain version."""
    meta = [torch.empty((4, 3), device="meta") for _ in range(4)]
    with pytest.raises(ValueError, match="CPU or all on one CUDA"):
        ops.sizing_latency(*meta, torch.empty((3, 3), dtype=torch.bool,
                                              device="meta"), c_max=2)
    with pytest.raises(ValueError, match="CPU or all on one CUDA"):
        ops.fused_interp(torch.empty((4, 3), device="meta"),
                         torch.zeros((2, 3)), torch.zeros(2), torch.zeros(2))
    before = dict(ops.LAUNCHES)
    ops.fused_interp(*map(torch.as_tensor, _interp_inputs(5, 3, 7)))
    assert ops.LAUNCHES == before          # the plain version is no launch


def _tests_calling(path, name):
    """Names of the test functions in ``path`` that call ``ops.<name>``,
    with whether each is marked ``gpu``."""
    import ast

    tree = ast.parse(path.read_text())
    found = []
    for node in tree.body:
        if not (isinstance(node, ast.FunctionDef)
                and node.name.startswith("test_")):
            continue
        calls = any(isinstance(n, ast.Call)
                    and isinstance(n.func, ast.Attribute)
                    and n.func.attr == name
                    and isinstance(n.func.value, ast.Name)
                    and n.func.value.id == "ops" for n in ast.walk(node))
        gpu = any("gpu" in ast.unparse(d) for d in node.decorator_list)
        if calls:
            found.append((node.name, gpu))
    return found


@pytest.mark.parametrize("name", sorted(ops.LAUNCHES))
def test_every_kernel_has_plain_version_cpu_test_and_card_test(name):
    """Kernel pairing: each public kernel of ``repro_torch.kernels.ops``
    (each name it counts launches under) has a plain version
    ``ref.<name>_ref``, a CPU test calling its wrapper, and a card test
    (marked ``gpu``) calling it."""
    from pathlib import Path

    import repro_torch.kernels as pkg

    assert callable(getattr(ops, name)) and name in pkg.__all__
    assert callable(getattr(pref, f"{name}_ref"))
    tests = Path(__file__).resolve().parent
    cpu = [t for p in sorted(tests.glob("test_torch_*.py"))
           if p.name != "test_torch_gpu.py"
           for t in _tests_calling(p, name)]
    card = [t for t, gpu in _tests_calling(tests / "test_torch_gpu.py", name)
            if gpu]
    assert cpu, f"no CPU test calls ops.{name}"
    assert card, f"no card test calls ops.{name}"
