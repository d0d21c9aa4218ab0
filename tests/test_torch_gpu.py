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
    (1, 200, 200, 4, 4, 32), (2, 77, 77, 4, 1, 96)])
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
    (2, 2, 4, 1000, 64), (2, 2, 2, 50, 96), (2, 1, 8, 2048, 128)])
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
    for K, G, hd in ((2, 16, 64), (2, 4, 256)):      # no kernel instance
        q2, kc2, vc2, valid2 = _decode_inputs(1, K, G, 16, hd,
                                              torch.bfloat16, cuda, 3)
        with pytest.raises(ValueError, match="does not take"):
            ops.flash_decode(q2, kc2, vc2, valid2)
    x = torch.zeros((1, 8, 2, 64), device=cuda)
    every_other = torch.zeros((1, 8, 2, 128), device=cuda)[..., ::2]
    with pytest.raises(ValueError, match="unit stride"):
        ops.flash_attention(x, every_other, x)
    with pytest.raises(ValueError, match="CPU or all on one CUDA"):
        ops.flash_attention(x, x.cpu(), x)
    with pytest.raises(TypeError, match="float32 or torch.bfloat16"):
        ops.flash_attention(x.double(), x.double(), x.double())
    with pytest.raises(ValueError, match="hd <= 128"):
        y = torch.zeros((1, 8, 2, 256), device=cuda)
        ops.flash_attention(y, y, y)
