"""The hand CUDA kernels against their plain PyTorch versions, on the card.

Every test here is marked ``gpu`` and skips where there is no CUDA device.
The file imports neither JAX nor the reference package, so on the machine
with the card it runs without them:

    PYTHONPATH=src python -m pytest --noconftest -m gpu tests/test_torch_gpu.py
"""

import pytest
import torch

from repro_torch.kernels import ops, ref

SIZING_TOL = dict(rtol=1e-5, atol=1e-7)      # tests/test_sizing.py
INTERP_TOL = dict(atol=2e-5, rtol=1e-4)      # tests/test_kernels.py


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _gen(seed, dev):
    return torch.Generator(device=dev).manual_seed(seed)


@pytest.mark.gpu
@pytest.mark.parametrize("B,K,c_max", [(1, 2, 1), (33, 6, 8), (64, 10, 6),
                                       (100, 32, 3), (196_608, 8, 2)])
def test_sizing_latency_kernel_on_card(cuda, B, K, c_max):
    g = _gen(B + K, cuda)
    mu = 5.0 + 55.0 * torch.rand((B, K), generator=g, device=cuda)
    repl = torch.randint(1, c_max + 1, (B, K), generator=g,
                         device=cuda).float()
    lam = (0.05 + 1.15 * torch.rand((B, K), generator=g, device=cuda)) \
        * mu * repl
    w = 2.0 * torch.rand((B, K), generator=g, device=cuda)
    adj = torch.triu(torch.rand((K, K), generator=g, device=cuda) < 0.4, 1)
    n0 = ops.LAUNCHES["sizing_latency"]
    got = ops.sizing_latency(lam, mu, repl, w, adj, c_max=c_max)
    want = ref.sizing_latency_ref(lam, mu, repl, w, adj, c_max=c_max)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["sizing_latency"] == n0 + 1
    torch.testing.assert_close(got[0], want[0], **SIZING_TOL)
    torch.testing.assert_close(got[1], want[1], **SIZING_TOL)


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["idw", "rbf"])
@pytest.mark.parametrize("Q,M,F", [(5, 3, 7), (300, 37, 9), (130, 256, 130),
                                   (8192, 1024, 16), (64, 3000, 16)])
def test_fused_interp_kernel_on_card(cuda, kind, Q, M, F):
    g = _gen(Q + M + F, cuda)
    xq = torch.randn((Q, F), generator=g, device=cuda)
    xm = torch.randn((M, F), generator=g, device=cuda)
    y = torch.randn((M,), generator=g, device=cuda)
    w = 0.1 + 0.9 * torch.rand((M,), generator=g, device=cuda)
    n0 = ops.LAUNCHES["fused_interp"]
    got = ops.fused_interp(xq, xm, y, w, kind=kind)
    want = ref.fused_interp_ref(xq, xm, y, w, kind=kind)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["fused_interp"] == n0 + 1
    torch.testing.assert_close(got[0], want[0], **INTERP_TOL)
    torch.testing.assert_close(got[1], want[1], **INTERP_TOL)


@pytest.mark.gpu
def test_kernels_refuse_what_they_do_not_take(cuda):
    x = torch.zeros((4, 3), device=cuda)
    with pytest.raises(TypeError, match="float32"):
        ops.fused_interp(x.double(), x.double(), x[:, 0], x[:, 0])
    with pytest.raises(ValueError, match="contiguous"):
        ops.fused_interp(x.T.contiguous().T, x, x[:, 0].contiguous(),
                         x[:, 0].contiguous())
    with pytest.raises(ValueError, match="CPU or all on one CUDA"):
        ops.fused_interp(x, x.cpu(), x[:, 0], x[:, 0])


def _attn_tol(dtype):
    # tests/test_kernels.py:17-18; kernel and plain version round at the
    # same points but sum in another order
    return dict(atol=0.03, rtol=0.05) if dtype == torch.bfloat16 \
        else dict(atol=2e-5, rtol=1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("kind,window,softcap", [
    ("causal", 0, 0.0), ("window", 48, 0.0), ("chunk", 64, 0.0),
    ("bidir", 0, 0.0), ("causal", 0, 20.0)])
@pytest.mark.parametrize("B,Sq,Sk,H,K,hd", [
    (1, 128, 128, 2, 1, 64), (2, 100, 100, 8, 2, 128),
    (1, 200, 200, 4, 4, 32), (2, 77, 77, 4, 1, 96),
    (1, 100, 100, 10, 1, 256)])
def test_flash_attention_kernel_on_card(cuda, dtype, kind, window, softcap,
                                        B, Sq, Sk, H, K, hd):
    g = _gen(B * Sq + H * hd, cuda)
    q = torch.randn((B, Sq, H, hd), generator=g, device=cuda).to(dtype)
    k = torch.randn((B, Sk, K, hd), generator=g, device=cuda).to(dtype)
    v = torch.randn((B, Sk, K, hd), generator=g, device=cuda).to(dtype)
    n0 = ops.LAUNCHES["flash_attention"]
    got = ops.flash_attention(q, k, v, kind=kind, window=window,
                              softcap=softcap)
    want = ref.flash_attention_ref(q, k, v, kind=kind, window=window,
                                   softcap=softcap)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["flash_attention"] == n0 + 1
    torch.testing.assert_close(got.float(), want.float(), **_attn_tol(dtype))


@pytest.mark.gpu
def test_flash_attention_kernel_cross_and_strided_views(cuda):
    """Sq != Sk (cross), and inputs that are views of a (B, heads, S, hd)
    buffer: the kernel reads them through their strides."""
    g = _gen(5, cuda)
    q = torch.randn((2, 4, 70, 64), generator=g, device=cuda).transpose(1, 2)
    k = torch.randn((2, 2, 150, 64), generator=g, device=cuda).transpose(1, 2)
    v = torch.randn((2, 2, 150, 64), generator=g, device=cuda).transpose(1, 2)
    assert not q.is_contiguous()
    got = ops.flash_attention(q, k, v, kind="cross")
    want = ref.flash_attention_ref(q, k, v, kind="cross")
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, **_attn_tol(torch.float32))


@pytest.mark.gpu
def test_flash_attention_kernel_serve_prefill_shape(cuda):
    """The serve path's prefill: (B 16, S 512, H 32, hd 128), K 8, bf16."""
    g = _gen(16, cuda)
    q = torch.randn((16, 512, 32, 128), generator=g, device=cuda).bfloat16()
    k = torch.randn((16, 512, 8, 128), generator=g, device=cuda).bfloat16()
    v = torch.randn((16, 512, 8, 128), generator=g, device=cuda).bfloat16()
    got = ops.flash_attention(q, k, v)
    want = ref.flash_attention_ref(q, k, v)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), want.float(),
                               **_attn_tol(torch.bfloat16))


def _decode_inputs(B, K, G, W, hd, dtype, dev, seed, p_valid=0.7):
    g = _gen(seed, dev)
    q = torch.randn((B, 1, K * G, hd), generator=g, device=dev).to(dtype)
    kc = torch.randn((B, W, K, hd), generator=g, device=dev).to(dtype)
    vc = torch.randn((B, W, K, hd), generator=g, device=dev).to(dtype)
    valid = torch.rand((B, W), generator=g, device=dev) < p_valid
    valid[:, 0] = True          # the plain version has no empty-row guard
    return q, kc, vc, valid


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("softcap", [0.0, 30.0])
@pytest.mark.parametrize("B,K,G,W,hd", [
    (1, 1, 1, 37, 32), (16, 8, 4, 529, 128), (3, 2, 8, 100, 64),
    (2, 2, 4, 1000, 64), (2, 2, 2, 50, 96), (2, 1, 8, 2048, 128),
    (16, 1, 10, 529, 256), (2, 2, 16, 300, 256), (2, 1, 13, 100, 128),
    (1, 1, 3, 64, 200)])
def test_flash_decode_kernel_on_card(cuda, dtype, softcap, B, K, G, W, hd):
    q, kc, vc, valid = _decode_inputs(B, K, G, W, hd, dtype, cuda,
                                      B * W + G)
    n0 = ops.LAUNCHES["flash_decode"]
    got = ops.flash_decode(q, kc, vc, valid, softcap=softcap)
    want = ref.flash_decode_ref(q, kc, vc, valid, softcap=softcap)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["flash_decode"] == n0 + 1
    torch.testing.assert_close(got.float(), want.float(), **_attn_tol(dtype))


@pytest.mark.gpu
def test_flash_decode_kernel_empty_row_is_zero(cuda):
    q, kc, vc, valid = _decode_inputs(2, 2, 4, 64, 128, torch.bfloat16, cuda,
                                      1)
    valid[1] = False
    got = ops.flash_decode(q, kc, vc, valid)
    torch.cuda.synchronize()
    assert torch.count_nonzero(got[1]) == 0
    want = ref.flash_decode_ref(q[:1], kc[:1], vc[:1], valid[:1])
    torch.testing.assert_close(got[:1].float(), want.float(),
                               **_attn_tol(torch.bfloat16))


@pytest.mark.gpu
def test_attention_kernels_refuse_what_they_do_not_take(cuda):
    q, kc, vc, valid = _decode_inputs(2, 2, 2, 16, 64, torch.bfloat16, cuda,
                                      2)
    with pytest.raises(TypeError, match="float32 or torch.bfloat16"):
        ops.flash_decode(q.half(), kc.half(), vc.half(), valid)
    with pytest.raises(TypeError, match="types differ"):
        ops.flash_decode(q.float(), kc, vc, valid)
    with pytest.raises(ValueError, match="contiguous"):
        ops.flash_decode(q, kc.transpose(1, 2).contiguous().transpose(1, 2),
                         vc, valid)
    with pytest.raises(ValueError, match="CPU or all on one CUDA"):
        ops.flash_decode(q, kc.cpu(), vc, valid)
    q2, kc2, vc2, valid2 = _decode_inputs(1, 1, 2, 16, 512, torch.bfloat16,
                                          cuda, 3)
    with pytest.raises(ValueError, match="hd <= 256"):
        ops.flash_decode(q2, kc2, vc2, valid2)
    x = torch.zeros((1, 8, 2, 64), device=cuda)
    every_other = torch.zeros((1, 8, 2, 128), device=cuda)[..., ::2]
    with pytest.raises(ValueError, match="unit stride"):
        ops.flash_attention(x, every_other, x)
    with pytest.raises(ValueError, match="CPU or all on one CUDA"):
        ops.flash_attention(x, x.cpu(), x)
    with pytest.raises(TypeError, match="float32 or torch.bfloat16"):
        ops.flash_attention(x.double(), x.double(), x.double())
    with pytest.raises(ValueError, match="hd <= 256"):
        y = torch.zeros((1, 8, 2, 512), device=cuda)
        ops.flash_attention(y, y, y)


@pytest.mark.gpu
@pytest.mark.parametrize("M,N", [(1, 1), (3, 5), (64, 384), (100, 3),
                                 (7, 5000), (32768, 768), (768, 32768)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_quantize_int8_kernel_on_card(cuda, M, N, dtype):
    """Bit-equal to the plain version: payload and scales."""
    g = _gen(M + N, cuda)
    x = (3.0 * torch.randn((M, N), generator=g, device=cuda)).to(dtype)
    n0 = ops.LAUNCHES["quantize_int8"]
    q, s = ops.quantize_int8(x)
    qr, sr = ref.quantize_int8_ref(x)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["quantize_int8"] == n0 + 1
    assert torch.equal(q, qr) and torch.equal(s, sr)


@pytest.mark.gpu
def test_quantize_int8_kernel_odd_views_and_leading_dims(cuda):
    """Unaligned rows (no 16-byte path), a 3-D tensor, an all-zero row."""
    g = _gen(3, cuda)
    x = torch.randn((10, 17), generator=g, device=cuda)[:, 1:].contiguous()
    y = torch.randn((2, 3, 96), generator=g, device=cuda)
    y[1, 2] = 0.0
    for t in (x, x[1:].contiguous(), y):
        q, s = ops.quantize_int8(t)
        qr, sr = ref.quantize_int8_ref(t)
        torch.cuda.synchronize()
        assert torch.equal(q, qr) and torch.equal(s, sr)
    with pytest.raises(ValueError, match="contiguous"):
        ops.quantize_int8(y.transpose(0, 1))
    with pytest.raises(TypeError, match="float32 or torch.bfloat16"):
        ops.quantize_int8(y.half())


def _within_bf16_gap(got, want, want32):
    """Each element of ``got`` within the plain bf16 result's largest gap to
    the plain float32 one, or within one bf16 step of its value: two right
    roundings of float32 sums taken in another order can land on
    neighbouring bf16 values, a step that exceeds the gap at large
    magnitudes (the same rule as chip_smoke.py's)."""
    gap = float((want.float() - want32.float()).abs().max())
    ulp = torch.exp2(torch.floor(torch.log2(
        want.float().abs().clamp(min=2.0 ** -126))) - 7)
    return bool(((got.float() - want.float()).abs()
                 <= torch.clamp(ulp, min=gap)).all())


def _bwd_inputs(B, S, H, K, hd, dev, seed):
    g = _gen(seed, dev)
    return [torch.randn(s, generator=g, device=dev)
            for s in ((B, S, H, hd), (B, S, K, hd), (B, S, K, hd),
                      (B, S, H, hd))]


@pytest.mark.gpu
@pytest.mark.parametrize("kind,window,softcap", [
    ("causal", 0, 0.0), ("window", 48, 0.0), ("chunk", 64, 0.0),
    ("bidir", 0, 0.0), ("causal", 0, 20.0)])
@pytest.mark.parametrize("B,S,H,K,hd", [
    (4, 256, 12, 12, 64), (2, 100, 8, 2, 128), (1, 130, 4, 1, 32),
    (1, 77, 4, 4, 96)])
def test_flash_attention_bwd_kernel_on_card(cuda, kind, window, softcap, B,
                                            S, H, K, hd):
    """The backward kernel against the plain version (autograd through the
    forward) on the card: float32 at atol/rtol 1e-3 (tests/test_kernels.py:
    77-97); bf16 no farther from the plain bf16 gradient than that is from
    the plain float32 one, or than one bf16 step.  The forward's
    statistics match the plain row max and sum of exponentials."""
    base = _bwd_inputs(B, S, H, K, hd, cuda, B * S + H + hd)
    kw = dict(kind=kind, window=window, softcap=softcap)
    plain = {}
    for dt in (torch.float32, torch.bfloat16):
        q, k, v, dout = (t.to(dt) for t in base)
        o, (m, l) = ops.flash_attention(q, k, v, return_stats=True, **kw)
        mr, lr = ref.flash_attention_stats_ref(q, k, **kw)
        n0 = ops.LAUNCHES["flash_attention_bwd"]
        got = ops.flash_attention_bwd(q, k, v, dout, (m, l), **kw)
        plain[dt] = ref.flash_attention_bwd_ref(q, k, v, dout, **kw)
        torch.cuda.synchronize()
        assert ops.LAUNCHES["flash_attention_bwd"] == n0 + 1
        torch.testing.assert_close(m, mr, **_attn_tol(dt))
        torch.testing.assert_close(l, lr, rtol=1e-5, atol=0)
        for gk, gp, g32 in zip(got, plain[dt], plain[torch.float32]):
            assert gk.dtype == dt
            if dt == torch.float32:
                torch.testing.assert_close(gk, gp, atol=1e-3, rtol=1e-3)
            else:
                assert _within_bf16_gap(gk, gp, g32)


@pytest.mark.gpu
def test_flash_attention_bwd_kernel_training_shapes(cuda):
    """qwen3-8b's training head layout (B 1, S 4096, H 32, K 8, hd 128,
    causal, bf16), strided (model-layout views of a fused qkv buffer), and
    the same result twice (no atomics)."""
    g = _gen(11, cuda)
    S, H, K, hd = 4096, 32, 8, 128
    qkv = torch.randn((1, S, H + 2 * K, hd), generator=g,
                      device=cuda).bfloat16()
    q, k, v = qkv[:, :, :H], qkv[:, :, H:H + K], qkv[:, :, H + K:]
    dout = torch.randn((1, S, H, hd), generator=g, device=cuda).bfloat16()
    o, stats = ops.flash_attention(q, k, v, return_stats=True)
    a = ops.flash_attention_bwd(q, k, v, dout, stats)
    b = ops.flash_attention_bwd(q, k, v, dout, stats)
    want = ref.flash_attention_bwd_ref(q, k, v, dout)
    want32 = ref.flash_attention_bwd_ref(*(t.float() for t in (q, k, v,
                                                               dout)))
    torch.cuda.synchronize()
    for x, y, w, w32 in zip(a, b, want, want32):
        assert torch.equal(x, y)
        assert _within_bf16_gap(x, w, w32)


@pytest.mark.gpu
def test_flash_attention_trainable_on_card(cuda):
    """Autograd through the kernels (forward with statistics, backward
    kernel) against autograd through the plain version, float32."""
    q, k, v, dout = _bwd_inputs(2, 200, 8, 2, 64, cuda, 4)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    n0 = dict(ops.LAUNCHES)
    out = ops.flash_attention_trainable(*leaves, "window", 50)
    out.backward(dout)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["flash_attention"] == n0["flash_attention"] + 1
    assert ops.LAUNCHES["flash_attention_bwd"] == \
        n0["flash_attention_bwd"] + 1
    want = ref.flash_attention_bwd_ref(q, k, v, dout, kind="window",
                                       window=50)
    for t, w in zip(leaves, want):
        torch.testing.assert_close(t.grad, w, atol=1e-3, rtol=1e-3)


@pytest.mark.gpu
def test_flash_attention_bwd_kernel_refuses_what_it_does_not_take(cuda):
    q, k, v, dout = _bwd_inputs(1, 16, 2, 1, 64, cuda, 5)
    o, stats = ops.flash_attention(q, k, v, return_stats=True)
    with pytest.raises(ValueError, match="statistics"):
        ops.flash_attention_bwd(q, k, v, dout)
    with pytest.raises(ValueError, match="stats m"):
        ops.flash_attention_bwd(q, k, v, dout, (stats[0][:, :1], stats[1]))
    with pytest.raises(TypeError, match="types differ"):
        ops.flash_attention_bwd(q, k, v, dout.bfloat16(), stats)
    with pytest.raises(ValueError, match="unit stride"):
        ops.flash_attention_bwd(q, k, v, torch.zeros(
            (1, 16, 2, 128), device=cuda)[..., ::2], stats)


@pytest.mark.gpu
def test_flash_attention_kernel_path_e_prefill_shape(cuda):
    """recurrentgemma-2b's prefill: (B 16, S 512, H 10, hd 256), MQA, the
    window of 2,048, bf16."""
    g = _gen(17, cuda)
    q = torch.randn((16, 512, 10, 256), generator=g, device=cuda).bfloat16()
    k = torch.randn((16, 512, 1, 256), generator=g, device=cuda).bfloat16()
    v = torch.randn((16, 512, 1, 256), generator=g, device=cuda).bfloat16()
    got = ops.flash_attention(q, k, v, kind="window", window=2048)
    want = ref.flash_attention_ref(q, k, v, kind="window", window=2048)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), want.float(),
                               **_attn_tol(torch.bfloat16))


@pytest.mark.gpu
@pytest.mark.parametrize("B,S,R", [(16, 512, 2560), (3, 37, 100),
                                   (1, 1000, 2567), (2, 1, 33)])
def test_rglru_scan_kernel_on_card(cuda, B, S, R):
    """Bit-equal to the plain version (one rounded multiply and one
    rounded add per step on both sides)."""
    g = _gen(B + S + R, cuda)
    a = torch.exp(-0.5 * torch.randn((B, S, R), generator=g,
                                     device=cuda).abs())
    b = 0.5 * torch.randn((B, S, R), generator=g, device=cuda)
    n0 = ops.LAUNCHES["rglru_scan"]
    got = ops.rglru_scan(a, b)
    want = ref.rglru_scan_ref(a, b)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["rglru_scan"] == n0 + 1
    assert torch.equal(got, want)


WKV_TOL = dict(atol=5e-4, rtol=1e-3)          # tests/test_kernels.py:185-201


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("init", [False, True])
@pytest.mark.parametrize("B,S,H,hd,chunk", [
    (16, 512, 64, 64, 32), (2, 96, 4, 32, 8), (2, 128, 2, 128, 64),
    (1, 7, 3, 64, 7)])
def test_wkv6_kernel_on_card(cuda, dtype, init, B, S, H, hd, chunk):
    """Output and final state against the model's chunked form and the
    sequential oracle."""
    g = _gen(B * S + hd, cuda)
    r, k, v = (0.5 * torch.randn((B, S, H, hd), generator=g, device=cuda))\
        .to(dtype), (0.5 * torch.randn((B, S, H, hd), generator=g,
                                       device=cuda)).to(dtype), \
        (0.5 * torch.randn((B, S, H, hd), generator=g,
                           device=cuda)).to(dtype)
    logw = -torch.exp(0.5 * torch.randn((B, S, H, hd), generator=g,
                                        device=cuda) - 2.0)
    u = 0.3 * torch.randn((H, hd), generator=g, device=cuda)
    s0 = 0.3 * torch.randn((B, H, hd, hd), generator=g, device=cuda) \
        if init else None
    n0 = ops.LAUNCHES["wkv6"]
    got = ops.wkv6(r, k, v, logw, u, chunk, initial_state=s0)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["wkv6"] == n0 + 1
    for want in (ref.wkv6_chunked_ref(r, k, v, logw, u, chunk,
                                      initial_state=s0),
                 ref.wkv6_ref(r, k, v, logw, u, initial_state=s0)):
        torch.testing.assert_close(got[0], want[0], **WKV_TOL)
        torch.testing.assert_close(got[1], want[1], **WKV_TOL)


@pytest.mark.gpu
def test_wkv6_kernel_strided_inputs(cuda):
    """r, k, v, logw as views of (B, H, S, hd) buffers: read through their
    strides."""
    g = _gen(8, cuda)
    r, k, v, w = (torch.randn((2, 4, 64, 64), generator=g, device=cuda)
                  .transpose(1, 2) for _ in range(4))
    logw = -torch.exp(0.5 * w - 2.0)
    u = 0.3 * torch.randn((4, 64), generator=g, device=cuda)
    assert not r.is_contiguous()
    got = ops.wkv6(0.5 * r, 0.5 * k, 0.5 * v, logw, u, 32)
    want = ref.wkv6_ref(0.5 * r, 0.5 * k, 0.5 * v, logw, u)
    torch.cuda.synchronize()
    torch.testing.assert_close(got[0], want[0], **WKV_TOL)
    torch.testing.assert_close(got[1], want[1], **WKV_TOL)


@pytest.mark.gpu
@pytest.mark.parametrize("Q,M,F", [(5, 3, 7), (300, 17, 130), (513, 256, 6),
                                   (8192, 1024, 16), (64, 3000, 40)])
def test_pairwise_sqdist_kernel_on_card(cuda, Q, M, F):
    g = _gen(Q + M + F, cuda)
    xq = torch.randn((Q, F), generator=g, device=cuda)
    xm = torch.randn((M, F), generator=g, device=cuda)
    n0 = ops.LAUNCHES["pairwise_sqdist"]
    got = ops.pairwise_sqdist(xq, xm)
    want = ref.pairwise_sqdist_ref(xq, xm)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["pairwise_sqdist"] == n0 + 1
    torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)


@pytest.mark.gpu
def test_recurrent_kernels_refuse_what_they_do_not_take(cuda):
    a = torch.rand((2, 8, 16), device=cuda)
    with pytest.raises(TypeError, match="float32"):
        ops.rglru_scan(a.bfloat16(), a.bfloat16())
    with pytest.raises(ValueError, match="contiguous"):
        ops.rglru_scan(a.transpose(0, 1).contiguous().transpose(0, 1), a)
    x = torch.zeros((1, 8, 2, 48), device=cuda)
    u = torch.zeros((2, 48), device=cuda)
    with pytest.raises(ValueError, match="hd 32, 64 or 128"):
        ops.wkv6(x, x, x, x, u, 8)
    x = torch.zeros((1, 8, 2, 32), device=cuda)
    with pytest.raises(TypeError, match="types differ"):
        ops.wkv6(x.bfloat16(), x, x, x, torch.zeros((2, 32), device=cuda), 8)
    with pytest.raises(TypeError, match="float32"):
        ops.pairwise_sqdist(x[0, :, 0].double(), x[0, :, 0].double())


# ---- the bf16 tensor-core instances of the attention kernels -------------
#
# mma.sync tiles are 16 query rows a warp, 64 rows a block, and 64 keys a
# tile (32 at hd 256); the lengths below sit on either side of those edges,
# and the head dims cover the three instances (64, 128, 256), a head dim
# below one mma step (8) and two that are not multiples of 16 (72, 200).

_EDGE_LENGTHS = [1, 15, 17, 63, 65, 129]


def _check_stats(stats, q, k, **kw):
    """The forward's row statistics against the plain ones: the row max
    within the bf16 tolerance and the sum of exponentials within rtol
    1e-5, which holds only if every score rounds to bf16 as the plain
    version's float32 sum does."""
    m, l = stats
    mr, lr = ref.flash_attention_stats_ref(q, k, **kw)
    torch.testing.assert_close(m, mr, **_attn_tol(torch.bfloat16))
    torch.testing.assert_close(l, lr, rtol=1e-5, atol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("hd", [8, 64, 72, 128, 200, 256])
@pytest.mark.parametrize("S", _EDGE_LENGTHS)
def test_flash_attention_bf16_tile_edges(cuda, S, hd):
    g = _gen(S * 1000 + hd, cuda)
    q = torch.randn((2, S, 4, hd), generator=g, device=cuda).bfloat16()
    k = torch.randn((2, S, 2, hd), generator=g, device=cuda).bfloat16()
    v = torch.randn((2, S, 2, hd), generator=g, device=cuda).bfloat16()
    n0 = ops.LAUNCHES["flash_attention"]
    got, stats = ops.flash_attention(q, k, v, return_stats=True)
    want = ref.flash_attention_ref(q, k, v)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["flash_attention"] == n0 + 1
    torch.testing.assert_close(got.float(), want.float(),
                               **_attn_tol(torch.bfloat16))
    _check_stats(stats, q, k)


@pytest.mark.gpu
@pytest.mark.parametrize("hd", [8, 64, 72, 128, 200, 256])
def test_flash_attention_bf16_cross(cuda, hd):
    """Sq 77 queries against Sk 300 keys: ragged on both sides."""
    g = _gen(77 + hd, cuda)
    q = torch.randn((2, 77, 4, hd), generator=g, device=cuda).bfloat16()
    k = torch.randn((2, 300, 2, hd), generator=g, device=cuda).bfloat16()
    v = torch.randn((2, 300, 2, hd), generator=g, device=cuda).bfloat16()
    got, stats = ops.flash_attention(q, k, v, kind="cross",
                                     return_stats=True)
    want = ref.flash_attention_ref(q, k, v, kind="cross")
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), want.float(),
                               **_attn_tol(torch.bfloat16))
    _check_stats(stats, q, k, kind="cross")


def _check_bwd_bf16(q32, k32, v32, dout32, **kw):
    """The bf16 backward against the plain version: every gradient element
    within the plain bf16 result's gap to the plain float32 one, or one
    bf16 step; the forward's statistics as _check_stats."""
    q, k, v, dout = (t.bfloat16() for t in (q32, k32, v32, dout32))
    _, stats = ops.flash_attention(q, k, v, return_stats=True, **kw)
    n0 = ops.LAUNCHES["flash_attention_bwd"]
    got = ops.flash_attention_bwd(q, k, v, dout, stats, **kw)
    want = ref.flash_attention_bwd_ref(q, k, v, dout, **kw)
    want32 = ref.flash_attention_bwd_ref(q32, k32, v32, dout32, **kw)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["flash_attention_bwd"] == n0 + 1
    _check_stats(stats, q, k, **kw)
    for gk, gp, g32 in zip(got, want, want32):
        assert gk.dtype == torch.bfloat16
        assert _within_bf16_gap(gk, gp, g32)


@pytest.mark.gpu
@pytest.mark.parametrize("hd", [8, 64, 72, 128])
@pytest.mark.parametrize("S", _EDGE_LENGTHS)
def test_flash_attention_bwd_bf16_tile_edges(cuda, S, hd):
    _check_bwd_bf16(*_bwd_inputs(2, S, 4, 2, hd, cuda, 7 * S + hd))


@pytest.mark.gpu
@pytest.mark.parametrize("kind,window", [
    ("window", 40), ("window", 64), ("window", 100), ("chunk", 48),
    ("chunk", 64), ("chunk", 96)])
@pytest.mark.parametrize("hd", [64, 128])
def test_flash_attention_bf16_window_and_chunk_edges(cuda, kind, window,
                                                     hd):
    """Windows and chunks whose edges cut 64-key tiles and 16-row warps:
    forward and backward."""
    q, k, v, dout = _bwd_inputs(2, 200, 4, 2, hd, cuda, window + hd)
    kw = dict(kind=kind, window=window)
    qb, kb, vb = (t.bfloat16() for t in (q, k, v))
    got = ops.flash_attention(qb, kb, vb, **kw)
    want = ref.flash_attention_ref(qb, kb, vb, **kw)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), want.float(),
                               **_attn_tol(torch.bfloat16))
    _check_bwd_bf16(q, k, v, dout, **kw)


@pytest.mark.gpu
@pytest.mark.parametrize("G", [10, 16])
@pytest.mark.parametrize("hd", [64, 128])
def test_flash_attention_bf16_many_query_heads(cuda, G, hd):
    """10 and 16 query heads per kv head: the dk/dv pass walks them all."""
    q, k, v, dout = _bwd_inputs(1, 150, 2 * G, 2, hd, cuda, G + hd)
    qb, kb, vb = (t.bfloat16() for t in (q, k, v))
    got = ops.flash_attention(qb, kb, vb)
    want = ref.flash_attention_ref(qb, kb, vb)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), want.float(),
                               **_attn_tol(torch.bfloat16))
    _check_bwd_bf16(q, k, v, dout)


@pytest.mark.gpu
@pytest.mark.parametrize("hd", [64, 128])
def test_flash_attention_bf16_unaligned_rows(cuda, hd):
    """Views whose rows do not start on a 16-byte boundary (one element
    into a buffer with rows of hd + 1): the kernels load them element by
    element, forward and backward, with the same results as contiguous
    copies."""
    g = _gen(hd, cuda)

    def view(H):
        buf = torch.randn((2, 100, H, hd + 1), generator=g, device=cuda)
        return buf.bfloat16()[..., 1:]

    q, k, v, dout = view(4), view(2), view(2), view(4)
    assert q.data_ptr() % 16 != 0 and q.stride(2) % 8 != 0
    got, stats = ops.flash_attention(q, k, v, return_stats=True)
    grads = ops.flash_attention_bwd(q, k, v, dout, stats)
    qc, kc, vc, dc = (t.contiguous() for t in (q, k, v, dout))
    got_c, stats_c = ops.flash_attention(qc, kc, vc, return_stats=True)
    grads_c = ops.flash_attention_bwd(qc, kc, vc, dc, stats_c)
    torch.cuda.synchronize()
    assert torch.equal(got, got_c)
    assert all(torch.equal(x, y) for x, y in zip(stats, stats_c))
    assert all(torch.equal(x, y) for x, y in zip(grads, grads_c))
    torch.testing.assert_close(got.float(),
                               ref.flash_attention_ref(q, k, v).float(),
                               **_attn_tol(torch.bfloat16))


@pytest.mark.gpu
@pytest.mark.parametrize("kind,window", [("causal", 0), ("window", 100),
                                         ("bidir", 0)])
@pytest.mark.parametrize("hd", [64, 128])
def test_flash_attention_bwd_bf16_weights_sum_to_one(cuda, kind, window,
                                                     hd):
    """The backward recomputes each row's weights y from the forward's m
    and l.  With every v_j equal, dw_ij = dO_i . v is the same for every
    key, so ds_ij = y_ij dw_i (1 - sum_j y_ij): dq and dk vanish exactly
    when the recomputed weights of each row sum to 1, that is when the
    backward's scores are the forward's bit for bit.  One score rounding
    to another bf16 value than in the forward moves its row's sum by
    about 1e-4, and dq with it."""
    g = _gen(3 * hd + window, cuda)
    q = torch.randn((2, 300, 4, hd), generator=g, device=cuda).bfloat16()
    k = torch.randn((2, 300, 2, hd), generator=g, device=cuda).bfloat16()
    v = torch.randn((1, 1, 1, hd), generator=g, device=cuda).bfloat16() \
        .expand(2, 300, 2, hd).contiguous()
    dout = torch.randn((2, 300, 4, hd), generator=g, device=cuda).bfloat16()
    kw = dict(kind=kind, window=window)
    _, stats = ops.flash_attention(q, k, v, return_stats=True, **kw)
    dq, dk, dv = ops.flash_attention_bwd(q, k, v, dout, stats, **kw)
    torch.cuda.synchronize()
    assert float(dv.float().abs().max()) > 0.1
    assert float(dq.float().abs().max()) < 1e-5
    assert float(dk.float().abs().max()) < 1e-5


@pytest.mark.gpu
@pytest.mark.parametrize("hd", [64, 128])
def test_attention_score_sums_round_as_the_plain_product(cuda, hd):
    """What makes the bf16 kernels' scores the plain version's: a plain
    float32 product (cuBLAS, TF32 off) sums q . k in order, one fmaf a
    step; the tensor cores' sums lie within the fallback's tolerance,
    16 x 2^-24 |q| |k|, of that sequential sum; and after the fallback
    every score rounds to bf16 as the plain product's does."""
    g = _gen(hd, cuda)
    S = 1024
    q = torch.randn((S, hd), generator=g, device=cuda).bfloat16()
    k = torch.randn((S, hd), generator=g, device=cuda).bfloat16()
    t, fixed, seq = ops.attention_score_sums(q, k)
    plain = q.float() @ k.float().T
    torch.cuda.synchronize()
    assert torch.equal(seq, plain)
    assert torch.equal(fixed.bfloat16(), plain.bfloat16())
    tol = 16.0 * 2.0 ** -24 * (q.float().norm(dim=1)[:, None]
                              * k.float().norm(dim=1)[None, :])
    assert bool(((t - seq).abs() <= tol).all())
