"""The port's attention kernels (flash attention at prefill, flash decode at
every decode step) against the JAX package's.

On the CPU the port's wrappers run their plain PyTorch versions.  These are
held, on the same numpy inputs, against the JAX Pallas kernels run in
interpret mode (as ``tests/test_kernels.py`` runs them), against the JAX
``ref`` oracles and against the model's own jnp attention, at the JAX
tests' tolerances (``tests/test_kernels.py:17-18``).  The plain versions
(and the CUDA kernels) round scores and weights to the input type as the
model's jnp path does; the Pallas kernels do not, which the bf16
tolerance covers.  The CUDA kernels are held against the plain versions
on the card in ``tests/test_torch_gpu.py``.
"""

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.decode_attention import flash_decode as jax_decode_kernel
from repro.models.attention import AttnSpec, decode_attend
from repro_torch.kernels import ops, ref


def _tol(dtype):
    return dict(atol=0.03, rtol=0.05) if dtype == "bfloat16" \
        else dict(atol=2e-5, rtol=1e-4)


def _arrays(seed, shapes, dtype, scale=1.0):
    """numpy arrays of the given shapes (ml_dtypes bf16 for "bfloat16"),
    normal draws from one seed."""
    rng = np.random.default_rng(seed)
    npt = ml_dtypes.bfloat16 if dtype == "bfloat16" else np.float32
    return [(scale * rng.standard_normal(s)).astype(np.float32).astype(npt)
            for s in shapes]


def _torch(a):
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _np(t):
    return t.float().numpy()


def _jnp(a):
    return jnp.asarray(a)


def _jax_ref_attention(q, k, v, **kw):
    """The JAX oracle takes (B, heads, S, hd); the port's model layout."""
    tr = (0, 2, 1, 3)
    return np.asarray(jref.flash_attention_ref(
        _jnp(q).transpose(tr), _jnp(k).transpose(tr), _jnp(v).transpose(tr),
        **kw).transpose(tr), np.float32)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("kind,window", [
    ("causal", 0), ("window", 48), ("chunk", 64), ("bidir", 0)])
@pytest.mark.parametrize("B,H,K,S,hd", [
    (1, 2, 2, 128, 64),     # groups of 1
    (2, 8, 2, 128, 32),     # groups of 4
    (1, 10, 1, 128, 256),   # recurrentgemma-2b's heads: MQA, hd 256
])
def test_flash_attention_matches_pallas_and_ref(dtype, kind, window, B, H, K,
                                                S, hd):
    q, k, v = _arrays(B * S + H, [(B, S, H, hd), (B, S, K, hd),
                                  (B, S, K, hd)], dtype)
    got = _np(ops.flash_attention(_torch(q), _torch(k), _torch(v),
                                  kind=kind, window=window))
    pallas = np.asarray(jops.flash_attention(_jnp(q), _jnp(k), _jnp(v),
                                             kind, window), np.float32)
    np.testing.assert_allclose(got, pallas, **_tol(dtype))
    np.testing.assert_allclose(
        got, _jax_ref_attention(q, k, v, kind=kind, window=window),
        **_tol(dtype))


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_flash_attention_softcap_matches_pallas_and_ref(dtype):
    q, k = _arrays(7, [(1, 128, 2, 64)] * 2, dtype, scale=2.0)
    v, = _arrays(8, [(1, 128, 2, 64)], dtype)
    got = _np(ops.flash_attention(_torch(q), _torch(k), _torch(v),
                                  softcap=20.0))
    pallas = np.asarray(jops.flash_attention(
        _jnp(q), _jnp(k), _jnp(v), "causal", 0, softcap=20.0), np.float32)
    np.testing.assert_allclose(got, pallas, **_tol(dtype))
    np.testing.assert_allclose(
        got, _jax_ref_attention(q, k, v, softcap=20.0), **_tol(dtype))


@pytest.mark.parametrize("kind,Sq,Sk", [
    ("causal", 100, 100), ("window", 77, 77), ("cross", 40, 72)])
def test_flash_attention_ragged_lengths(kind, Sq, Sk):
    """Lengths that are no multiple of any tile, through the wrapper (the
    Pallas kernel takes them as one block each)."""
    q, = _arrays(3, [(2, Sq, 4, 64)], "float32")
    k, v = _arrays(4, [(2, Sk, 2, 64)] * 2, "float32")
    window = 32 if kind == "window" else 0
    got = _np(ops.flash_attention(_torch(q), _torch(k), _torch(v),
                                  kind=kind, window=window))
    pallas = np.asarray(jops.flash_attention(_jnp(q), _jnp(k), _jnp(v),
                                             kind, window), np.float32)
    np.testing.assert_allclose(got, pallas, **_tol("float32"))


def test_flash_attention_long_rows_go_through_in_chunks():
    """The plain version's query chunking leaves every row as it was."""
    q, k, v = (_torch(a) for a in _arrays(
        9, [(1, 300, 4, 32), (1, 300, 1, 32), (1, 300, 1, 32)], "float32"))
    whole = ref.flash_attention_ref(q, k, v, kind="window", window=70)
    chunked = ref.flash_attention_ref(q, k, v, kind="window", window=70,
                                      q_chunk=64)
    torch.testing.assert_close(whole, chunked, atol=1e-6, rtol=1e-6)


def _decode_arrays(B, K, G, W, hd, dtype, seed):
    q, kc, vc = _arrays(seed, [(B, 1, K * G, hd), (B, W, K, hd),
                               (B, W, K, hd)], dtype)
    valid = np.random.default_rng(seed + 1).random((B, W)) < 0.7
    valid[:, 0] = True
    return q, kc, vc, valid


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("B,K,G,W,hd", [
    (2, 2, 1, 64, 64),      # groups of 1
    (2, 2, 4, 100, 32),     # groups of 4, W no multiple of a tile
    (2, 1, 10, 80, 256),    # recurrentgemma-2b's heads: G 10, hd 256
])
def test_flash_decode_matches_pallas_and_ref(dtype, B, K, G, W, hd):
    q, kc, vc, valid = _decode_arrays(B, K, G, W, hd, dtype, B * W + G)
    got = _np(ops.flash_decode(_torch(q), _torch(kc), _torch(vc),
                               torch.from_numpy(valid)))
    pallas = np.asarray(jops.flash_decode(_jnp(q), _jnp(kc), _jnp(vc),
                                          _jnp(valid)), np.float32)
    np.testing.assert_allclose(got, pallas, **_tol(dtype))
    jq = _jnp(q)[:, 0].reshape(B, K, G, hd)
    want = np.asarray(jref.flash_decode_ref(
        jq, _jnp(kc).transpose(0, 2, 1, 3), _jnp(vc).transpose(0, 2, 1, 3),
        _jnp(valid)), np.float32).reshape(B, 1, K * G, hd)
    np.testing.assert_allclose(got, want, **_tol(dtype))


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_flash_decode_softcap_matches_pallas(dtype):
    B, K, G, W, hd = 2, 2, 4, 96, 64
    q, kc, vc, valid = _decode_arrays(B, K, G, W, hd, dtype, 11)
    q = (4 * q.astype(np.float32)).astype(q.dtype)
    got = _np(ops.flash_decode(_torch(q), _torch(kc), _torch(vc),
                               torch.from_numpy(valid), softcap=5.0))
    pallas = np.asarray(jax_decode_kernel(
        _jnp(q)[:, 0].reshape(B, K, G, hd), _jnp(kc).transpose(0, 2, 1, 3),
        _jnp(vc).transpose(0, 2, 1, 3), _jnp(valid), softcap=5.0),
        np.float32).reshape(B, 1, K * G, hd)
    np.testing.assert_allclose(got, pallas, **_tol(dtype))


def test_flash_decode_plain_is_the_models_decode_attend():
    """The plain version is the model's jnp decode math, bf16 rounding of
    scores and weights included."""
    B, K, G, W, hd = 2, 2, 2, 40, 32
    q, kc, vc, valid = _decode_arrays(B, K, G, W, hd, "bfloat16", 5)
    spec = AttnSpec(d_model=K * G * hd, n_heads=K * G, n_kv_heads=K,
                    head_dim=hd, tp=1)
    want = np.asarray(decode_attend(_jnp(q), _jnp(kc), _jnp(vc), _jnp(valid),
                                    spec), np.float32)
    got = _np(ops.flash_decode(_torch(q), _torch(kc), _torch(vc),
                               torch.from_numpy(valid)))
    # one bf16 ulp of the outputs (|out| < 2): the two frameworks may sum
    # the products in another order before rounding
    np.testing.assert_allclose(got, want, atol=2 ** -7, rtol=0)


def test_attention_wrappers_refuse_bad_shapes_and_devices():
    x = torch.zeros((1, 8, 4, 32))
    with pytest.raises(ValueError, match="multiple of K"):
        ops.flash_attention(x, torch.zeros((1, 8, 3, 32)),
                            torch.zeros((1, 8, 3, 32)))
    with pytest.raises(ValueError, match="unknown attention kind"):
        ops.flash_attention(x, x, x, kind="sliding")
    with pytest.raises(ValueError, match="CPU or all on one CUDA"):
        ops.flash_attention(x.to("meta"), x, x)
    with pytest.raises(ValueError, match="bool"):
        ops.flash_decode(x[:, :1], x, x, torch.ones((1, 8)))
    with pytest.raises(ValueError, match="CPU or all on one CUDA"):
        ops.flash_decode(x[:, :1].to("meta"), x, x,
                         torch.ones((1, 8), dtype=torch.bool))
    before = dict(ops.LAUNCHES)
    ops.flash_attention(x, x, x)
    ops.flash_decode(x[:, :1], x, x, torch.ones((1, 8), dtype=torch.bool))
    assert ops.LAUNCHES == before          # the plain version is no launch


@pytest.mark.parametrize("S,hd", [(1, 64), (37, 64), (130, 128)])
def test_attention_score_sums_on_the_cpu_are_the_plain_product(S, hd):
    """On the CPU the score-sum diagnostic gives the plain float32 product
    three times (tensor-core, fixed and sequential sums are the card's);
    it launches no kernel and refuses mismatched shapes."""
    rng = np.random.default_rng(S + hd)
    q = torch.as_tensor(rng.standard_normal((S, hd)), dtype=torch.bfloat16)
    k = torch.as_tensor(rng.standard_normal((S, hd)), dtype=torch.bfloat16)
    before = dict(ops.LAUNCHES)
    sums = ops.attention_score_sums(q, k)
    want = q.float() @ k.float().T
    assert ops.LAUNCHES == before
    for got in sums:
        assert got.dtype == torch.float32 and torch.equal(got, want)
    with pytest.raises(ValueError, match="two"):
        ops.attention_score_sums(q, k[:, :32])


def _jax_attention_vjp(q, k, v, dout, kind, window, softcap=0.0):
    """(dq, dk, dv) of the reference's ``flash_attention_trainable`` (the
    Pallas forward in interpret mode, ``_fat_bwd`` backward: the vjp of
    its jnp attention), as float32 numpy."""
    import jax

    _, vjp = jax.vjp(lambda q, k, v: jops.flash_attention_trainable(
        q, k, v, kind, window, softcap), _jnp(q), _jnp(k), _jnp(v))
    return [np.asarray(g, np.float32) for g in vjp(_jnp(dout))]


def _attention_grad_cases():
    return [(kind, window, H, K)
            for kind, window in (("causal", 0), ("window", 48),
                                 ("chunk", 64), ("bidir", 0))
            for H, K in ((4, 4), (4, 1), (8, 2))]     # MHA, MQA, GQA


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("kind,window,H,K", _attention_grad_cases())
def test_flash_attention_bwd_matches_jax_grad(dtype, kind, window, H, K):
    """The plain backward (the CPU path of ``ops.flash_attention_bwd``)
    against ``jax.vjp`` of the reference's ``flash_attention_trainable``:
    float32 at atol/rtol 1e-3 (tests/test_kernels.py:77-97); bf16 no
    farther from the reference than the plain version's own bf16 gradient
    is from its float32 one on the same inputs."""
    B, S, hd = 1, 128, 32
    q, k, v, dout = _arrays(S * H + K, [(B, S, H, hd), (B, S, K, hd),
                                        (B, S, K, hd), (B, S, H, hd)], dtype)
    got = ops.flash_attention_bwd(*map(_torch, (q, k, v, dout)), kind=kind,
                                  window=window)
    assert [g.dtype for g in got] == [_torch(q).dtype] * 3
    want = _jax_attention_vjp(q, k, v, dout, kind, window)
    if dtype == "float32":
        for g, w in zip(got, want):
            np.testing.assert_allclose(_np(g), w, atol=1e-3, rtol=1e-3)
        return
    f32 = ops.flash_attention_bwd(*(_torch(a).float() for a in (q, k, v,
                                                                dout)),
                                  kind=kind, window=window)
    for g, w, g32 in zip(got, want, f32):
        gap = float(np.abs(_np(g) - _np(g32)).max())
        assert float(np.abs(_np(g) - w).max()) <= gap


def test_flash_attention_trainable_grads_match_jax():
    """Autograd through the port's training attention (the CPU path of
    ``ops.flash_attention_trainable``) gives the reference's gradients of
    the same loss, and its forward the reference's output."""
    import jax

    q, k, v = _arrays(21, [(2, 96, 4, 32), (2, 96, 2, 32), (2, 96, 2, 32)],
                      "float32")
    leaves = [_torch(a).requires_grad_(True) for a in (q, k, v)]
    out = ops.flash_attention_trainable(*leaves, "window", 40)
    (out.float() ** 2).sum().backward()

    def loss(q, k, v):
        return jnp.sum(jops.flash_attention_trainable(
            q, k, v, "window", 40, 0.0).astype(jnp.float32) ** 2)

    want = jax.grad(loss, argnums=(0, 1, 2))(_jnp(q), _jnp(k), _jnp(v))
    for t, w in zip(leaves, want):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w),
                                   atol=1e-3, rtol=1e-3)
    np.testing.assert_allclose(
        _np(out.detach()), _jax_ref_attention(q, k, v, kind="window",
                                              window=40), **_tol("float32"))


@pytest.mark.parametrize("kind,window,softcap", [
    ("causal", 0, 0.0), ("chunk", 32, 0.0), ("bidir", 0, 10.0)])
def test_flash_attention_stats_rebuild_the_forward(kind, window, softcap):
    """The row statistics the forward kernel hands to the backward
    (max score m and sum of exponentials l per row, the plain version's
    ``flash_attention_stats_ref`` on the CPU): exp(s - m) / l are the
    softmax weights, so they rebuild the attention output."""
    q, k, v = (_torch(a) for a in _arrays(
        5, [(1, 80, 4, 32), (1, 80, 2, 32), (1, 80, 2, 32)], "float32"))
    out, (m, l) = ops.flash_attention(q, k, v, kind=kind, window=window,
                                      softcap=softcap, return_stats=True)
    assert m.shape == l.shape == (1, 4, 80) and m.dtype == torch.float32
    s = torch.einsum("bqkgd,bskd->bkgqs", q.reshape(1, 80, 2, 2, 32),
                     k).reshape(1, 4, 80, 80) / 32 ** 0.5
    if softcap:
        s = softcap * torch.tanh(s / softcap)
    s = s.masked_fill(~ref.attention_mask(kind, window, 80, 80), -np.inf)
    w = torch.exp(s - m[..., None]) / l[..., None]
    rebuilt = torch.einsum("bhqs,bshd->bqhd", w,
                           v.repeat_interleave(2, dim=2))
    torch.testing.assert_close(rebuilt, out, atol=2e-5, rtol=1e-4)


def test_flash_attention_bwd_refuses_bad_shapes():
    x = torch.zeros((1, 8, 4, 32))
    kv = torch.zeros((1, 8, 2, 32))
    with pytest.raises(ValueError, match="dout"):
        ops.flash_attention_bwd(x, kv, kv, torch.zeros((1, 8, 4, 16)))
    with pytest.raises(ValueError, match="unknown attention kind"):
        ops.flash_attention_bwd(x, kv, kv, x, kind="sliding")
    with pytest.raises(ValueError, match="CPU or all on one CUDA"):
        ops.flash_attention_bwd(x, kv, kv, x.to("meta"))
    before = dict(ops.LAUNCHES)
    ops.flash_attention_bwd(x, kv, kv, x)
    assert ops.LAUNCHES == before          # the plain version is no launch
