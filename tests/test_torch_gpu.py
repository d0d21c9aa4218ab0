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
    # bit-equal: -fmad=false, IEEE divisions, the plain version's order
    assert torch.equal(got[0], want[0])
    assert torch.equal(got[1], want[1])


def _adjacency(kind, K, g, dev):
    """(K, K) bool: an upper triangle (tiers in index order), the same
    triangle under a random relabelling of the tiers (acyclic, children
    not after their parents in index order), a cycle through every tier,
    a self-loop on one, or no edge."""
    tri = torch.triu(torch.rand((K, K), generator=g, device=dev) < 0.5, 1)
    if kind == "triangle":
        return tri
    if kind == "permuted":
        p = torch.randperm(K, generator=g, device=dev)
        return tri[p][:, p]
    if kind == "cycle":
        return tri | torch.roll(torch.eye(K, dtype=torch.bool, device=dev),
                                1, dims=1).T
    if kind == "self_loop":
        a = tri.clone()
        a[K // 2, K // 2] = True
        return a
    return torch.zeros((K, K), dtype=torch.bool, device=dev)


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["triangle", "permuted", "cycle",
                                  "self_loop", "none"])
@pytest.mark.parametrize("B,K,c_max", [(1000, 8, 3), (777, 13, 4),
                                       (300, 32, 2), (5000, 3, 5)])
def test_sizing_latency_kernel_adjacency_routes(cuda, kind, B, K, c_max):
    """Acyclic adjacencies take one pass in reverse topological order,
    cyclic ones K Jacobi steps; both bit-equal to the plain version."""
    g = _gen(B + 7 * K, cuda)
    mu = 5.0 + 55.0 * torch.rand((B, K), generator=g, device=cuda)
    repl = torch.randint(1, c_max + 2, (B, K), generator=g,
                         device=cuda).float()
    lam = (0.05 + 1.15 * torch.rand((B, K), generator=g, device=cuda)) \
        * mu * repl
    w = 2.0 * torch.rand((B, K), generator=g, device=cuda)
    adj = _adjacency(kind, K, g, cuda)
    got = ops.sizing_latency(lam, mu, repl, w, adj, c_max=c_max)
    want = ref.sizing_latency_ref(lam, mu, repl, w, adj, c_max=c_max)
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0])
    assert torch.equal(got[1], want[1])


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


# fused_interp's splits of the measurements (chosen at launch, from the
# card's SM count): path B's chunk and a build's last chunk (Q 256), M past
# a bucket, M not a multiple of a warp's tile (32 rows), of the 16 warps or
# of the split, one query a thread (F 64) and F past the register-resident
# instances (130)
_INTERP_SPLIT_SHAPES = [(8192, 1024, 16), (256, 1024, 16), (8192, 2048, 16),
                        (1000, 1000, 16), (200, 700, 32), (100, 500, 64),
                        (130, 600, 130), (33, 70, 5)]


def _interp_split(Q, M, F, sms=132):
    """The kernel's own cut of M measurements on a card of ``sms`` SMs
    (``fused_interp_split``): (splits, rows a split)."""
    import ctypes

    from repro_torch.kernels import build

    fn = build.library("fused_interp").fused_interp_split
    fn.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = None
    out = (ctypes.c_int * 2)()
    fn(Q, M, F, sms, out)
    return out[0], out[1]


def _interp_block(F):
    # queries a block: 4 a thread up to 16 features, 64 / FMAX up to 64
    fmax = next(f for f in (8, 16, 32, 64, 128, 256) if F <= f)
    return 32 * (min(4, 64 // fmax) if fmax <= 64 else 1)


@pytest.mark.gpu
@pytest.mark.parametrize("shape,plan", [
    ((8192, 1024, 16), (2, 512)), ((256, 1024, 16), (8, 128)),
    ((8192, 2048, 16), (2, 1024)), ((1000, 1000, 16), (8, 125)),
    ((200, 700, 32), (8, 88)), ((100, 500, 64), (8, 63)),
    ((130, 600, 130), (8, 75)), ((33, 70, 5), (2, 35)), ((5, 3, 7), (1, 3)),
    ((300, 37, 9), (1, 37)), ((130, 256, 130), (4, 64)),
    ((64, 3000, 16), (8, 375)), ((8192, 63, 16), (1, 63)),
    ((8192, 65, 16), (2, 33)), ((8448, 1024, 16), (2, 512)),
    ((8576, 1024, 16), (1, 1024))])
def test_fused_interp_split_on_the_h100(cuda, shape, plan):
    """The split at the H100's 132 SMs: two at path B's chunk (64 query
    blocks of 128, 128 blocks in one wave), eight at a build's last chunk,
    and at the edges: 64 rows a split (M 63, 65), blocks_q 66 and 67."""
    assert _interp_split(*shape) == plan


@pytest.mark.gpu
@pytest.mark.parametrize("F", [3, 16, 40, 100, 256])
def test_fused_interp_split_covers_any_measurement_count(cuda, F):
    g = torch.Generator().manual_seed(F)
    for _ in range(300):
        Q = int(torch.randint(1, 20000, (1,), generator=g))
        M = int(torch.randint(1, 50000, (1,), generator=g))
        sms = int(torch.randint(1, 300, (1,), generator=g))
        n, L = _interp_split(Q, M, F, sms)
        assert 1 <= n <= 8
        assert (n - 1) * L < M <= n * L          # non-empty, covers M
        if n > 1:
            # a split is taken only to add blocks, and keeps 64 rows
            assert -(-Q // _interp_block(F)) * n <= sms
            assert M >= 64 * (n - 1)


def _interp_inputs(Q, M, F, dev):
    g = _gen(Q * 7 + M + F, dev)
    return (torch.randn((Q, F), generator=g, device=dev),
            torch.randn((M, F), generator=g, device=dev),
            torch.randn((M,), generator=g, device=dev),
            0.1 + 0.9 * torch.rand((M,), generator=g, device=dev))


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["idw", "rbf"])
@pytest.mark.parametrize("Q,M,F", _INTERP_SPLIT_SHAPES)
def test_fused_interp_kernel_split_shapes(cuda, kind, Q, M, F):
    args = _interp_inputs(Q, M, F, cuda)
    got = ops.fused_interp(*args, kind=kind)
    want = ref.fused_interp_ref(*args, kind=kind)
    torch.cuda.synchronize()
    torch.testing.assert_close(got[0], want[0], **INTERP_TOL)
    torch.testing.assert_close(got[1], want[1], **INTERP_TOL)


@pytest.mark.gpu
@pytest.mark.parametrize("power", [1.0, 3.0])
@pytest.mark.parametrize("Q,M,F", [(8192, 1024, 16), (256, 1024, 16),
                                   (300, 37, 9)])
def test_fused_interp_kernel_idw_power(cuda, Q, M, F, power):
    """IDW with a power other than 2 (the weight through powf)."""
    args = _interp_inputs(Q, M, F, cuda)
    got = ops.fused_interp(*args, idw_power=power)
    want = ref.fused_interp_ref(*args, idw_power=power)
    torch.cuda.synchronize()
    torch.testing.assert_close(got[0], want[0], **INTERP_TOL)
    torch.testing.assert_close(got[1], want[1], **INTERP_TOL)


@pytest.mark.gpu
@pytest.mark.parametrize("Q,M,F", _INTERP_SPLIT_SHAPES)
def test_fused_interp_kernel_is_deterministic(cuda, Q, M, F):
    """Partials meet in a fixed order (warps, then splits by the last
    block), so two calls give the same bits."""
    args = _interp_inputs(Q, M, F, cuda)
    a = ops.fused_interp(*args)
    b = ops.fused_interp(*args)
    torch.cuda.synchronize()
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


@pytest.mark.gpu
@pytest.mark.parametrize("Q,M,F", [(8192, 1024, 16), (256, 1024, 16),
                                   (300, 37, 9), (130, 256, 130)])
def test_fused_interp_kernel_is_exact_at_measured_states(cuda, Q, M, F):
    """A query equal to a measurement row: d2 == 0 exactly (the same fmaf
    chain for |q|^2, |m|^2 and q.m), so dmin is 0.0 and the IDW weight
    w / eps dominates: the mean is that row's y."""
    xq, xm, y, w = _interp_inputs(Q, M, F, cuda)
    g = _gen(Q + 1, cuda)
    n = min(Q, M)
    at = torch.randperm(Q, generator=g, device=cuda)[:n]
    rows = torch.randperm(M, generator=g, device=cuda)[:n]
    xq[at] = xm[rows]
    mean, dmin = ops.fused_interp(xq, xm, y, w)
    torch.cuda.synchronize()
    assert bool((dmin[at] == 0.0).all())
    torch.testing.assert_close(mean[at], y[rows], **INTERP_TOL)


@pytest.mark.gpu
@pytest.mark.parametrize("Q,M,F", [(8192, 1024, 16), (256, 1024, 16),
                                   (300, 37, 9)])
def test_fused_interp_kernel_fallback(cuda, Q, M, F):
    """Weights that sum to at most 1e-12 give the w-weighted global mean
    of y: all-zero recency weights (the mean of nothing: 0), and RBF
    weights that underflow far from every measurement."""
    xq, xm, y, w = _interp_inputs(Q, M, F, cuda)
    zero = torch.zeros_like(w)
    mean, _ = ops.fused_interp(xq, xm, y, zero)
    want = ref.fused_interp_ref(xq, xm, y, zero)[0]
    torch.cuda.synchronize()
    assert bool((want == 0.0).all())
    torch.testing.assert_close(mean, want, **INTERP_TOL)
    far = xq + 100.0
    mean, dmin = ops.fused_interp(far, xm, y, w, kind="rbf")
    want = ref.fused_interp_ref(far, xm, y, w, kind="rbf")
    torch.cuda.synchronize()
    glob = float((y.double() * w.double()).sum() / w.double().sum())
    torch.testing.assert_close(mean, want[0], **INTERP_TOL)
    torch.testing.assert_close(mean, torch.full_like(mean, glob),
                               **INTERP_TOL)
    torch.testing.assert_close(dmin, want[1], **INTERP_TOL)


@pytest.mark.gpu
@pytest.mark.parametrize("e", [-100, -30, -20, -10, -2, -1, 0, 1, 2, 10, 15,
                               20, 30, 60, 100])
def test_reciprocal_is_correctly_rounded(cuda, e):
    """The kernels' reciprocal (ieee_div.cuh rcp_rn: the IDW weight, the
    decode weights' sums) equals IEEE 1 / x for every significand of the
    binade [2^e, 2^(e + 1)), and of its negative."""
    bits = torch.arange(1 << 23, dtype=torch.int32, device=cuda) \
        | ((127 + e) << 23)
    x = bits.view(torch.float32)
    x = torch.cat([x, -x])
    got = ops.reciprocal_rn(x)
    want = (1.0 / x.cpu()).to(cuda)
    assert torch.equal(got, want)


@pytest.mark.gpu
def test_reciprocal_range_edges(cuda):
    """At the ends of rcp_rn's range: IEEE 1 / x down to x = 2^-126, and
    past 2^126 (inf included) 0 where IEEE's quotient is subnormal."""
    tiny = torch.finfo(torch.float32).tiny
    big = torch.tensor(2.0 ** 126)
    x = torch.tensor([tiny, tiny * 1.5, 2.0 ** -120, 2.0 ** 120, 3e37],
                     dtype=torch.float32)
    x = torch.cat([x, torch.nextafter(big, torch.tensor(0.0)).reshape(1),
                   big.reshape(1), torch.nextafter(big, torch.tensor(
                       float("inf"))).reshape(1),
                   torch.tensor([1e38, 3e38, torch.finfo(torch.float32).max,
                                 float("inf")])])
    want = 1.0 / x
    want = torch.where(want.abs() < tiny, torch.zeros_like(want), want)
    got = ops.reciprocal_rn(x.to(cuda)).cpu()
    assert torch.equal(got, want), (x, got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("eps", [0.0, 1e-45, 1e-40])
def test_fused_interp_kernel_refuses_eps_zero(cuda, eps):
    """The kernel's reciprocal is correctly rounded from 2^-126 up, so IDW
    on the card needs eps at least the least normal float32, as RBF needs
    a normal 2 length_scale^2."""
    x = torch.zeros((4, 3), device=cuda)
    with pytest.raises(ValueError, match="eps >="):
        ops.fused_interp(x, x, x[:, 0].contiguous(), x[:, 0].contiguous(),
                         eps=eps)
    with pytest.raises(ValueError, match="length_scale"):
        ops.fused_interp(x, x, x[:, 0].contiguous(), x[:, 0].contiguous(),
                         kind="rbf", length_scale=eps)


@pytest.mark.gpu
@pytest.mark.parametrize("kind,power,scale", [
    ("idw", 2.0, 3e18), ("idw", 2.0, 1e20), ("idw", 8.0, 1e6),
    ("rbf", 2.0, 3e18), ("rbf", 2.0, 1e20)])
@pytest.mark.parametrize("Q,M,F", [(8192, 1024, 16), (300, 37, 9)])
def test_fused_interp_kernel_row_at_overflowing_distance(cuda, kind, power,
                                                         scale, Q, M, F):
    """One measurement row so far that its weight's divisor passes 2^126
    (3e18: d2 about 1.4e38 at F 16) or overflows (1e20: |m|^2 is inf; IDW
    power 8 at 1e6: d2^4 is inf): its weight is 0, the other rows set the
    mean, as in the plain version."""
    xq, xm, y, w = _interp_inputs(Q, M, F, cuda)
    xm[M // 2] = scale
    got = ops.fused_interp(xq, xm, y, w, kind=kind, idw_power=power)
    want = ref.fused_interp_ref(xq, xm, y, w, kind=kind, idw_power=power)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(got[0]).all())
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


def _split_edge(B, K, G, hd, itemsize):
    """The largest W up to 600 whose last split holds one slot."""
    for W in range(600, 1, -1):
        n, L = ops.decode_split(B, W, K, G, hd, itemsize)
        if n >= 2 and W == (n - 1) * L + 1:
            return W
    raise AssertionError("no W up to 600 ends a split with one slot")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("B,K,G,hd", [(16, 8, 4, 128), (16, 1, 10, 256),
                                      (2, 2, 4, 64)])
def test_flash_decode_kernel_split_edges(cuda, dtype, B, K, G, hd):
    """W one slot past a split boundary (the last split holds one slot),
    and W = 1."""
    W = _split_edge(B, K, G, hd, torch.empty((), dtype=dtype).element_size())
    for W_ in (W, 1):
        q, kc, vc, valid = _decode_inputs(B, K, G, W_, hd, dtype, cuda, W_)
        got = ops.flash_decode(q, kc, vc, valid)
        want = ref.flash_decode_ref(q, kc, vc, valid)
        torch.cuda.synchronize()
        torch.testing.assert_close(got.float(), want.float(),
                                   **_attn_tol(dtype))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_decode_kernel_empty_split_and_empty_row(cuda, dtype):
    """A whole split with no valid slot inside a row that has some (it
    adds m = -inf, l = 0 to the combine) and a row with no valid slot
    (0), among rows of many splits."""
    B, K, G, W, hd = 3, 2, 4, 1000, 128
    n_split, split_len = ops.decode_split(B, W, K, G, hd,
                                          torch.empty((), dtype=dtype)
                                          .element_size())
    assert n_split >= 3
    q, kc, vc, valid = _decode_inputs(B, K, G, W, hd, dtype, cuda, 5)
    valid[0, split_len:2 * split_len] = False
    valid[1, :split_len] = False
    valid[2] = False
    got = ops.flash_decode(q, kc, vc, valid)
    want = ref.flash_decode_ref(q[:2], kc[:2], vc[:2], valid[:2])
    torch.cuda.synchronize()
    assert torch.count_nonzero(got[2]) == 0
    assert bool(torch.isfinite(got.float()).all())
    torch.testing.assert_close(got[:2].float(), want.float(),
                               **_attn_tol(dtype))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_decode_kernel_long_cache(cuda, dtype):
    """W 32,768 with a random mask: 256 splits of 128 slots a row in bf16,
    342 of 96 in float32."""
    q, kc, vc, valid = _decode_inputs(2, 2, 4, 32768, 128, dtype, cuda, 7,
                                      p_valid=0.5)
    got = ops.flash_decode(q, kc, vc, valid)
    want = ref.flash_decode_ref(q, kc, vc, valid)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), want.float(), **_attn_tol(dtype))


@pytest.mark.gpu
@pytest.mark.parametrize("B,K,G,W,hd", [(16, 8, 4, 529, 128),
                                        (16, 1, 10, 529, 256),
                                        (2, 2, 4, 32768, 128)])
def test_flash_decode_kernel_is_deterministic(cuda, B, K, G, W, hd):
    """Every sum runs in a fixed order (the last block of a kv head adds
    the splits' partials in split order): two calls, the same bits."""
    q, kc, vc, valid = _decode_inputs(B, K, G, W, hd, torch.bfloat16, cuda,
                                      11)
    a = ops.flash_decode(q, kc, vc, valid)
    b = ops.flash_decode(q, kc, vc, valid)
    torch.cuda.synchronize()
    assert torch.equal(a.view(torch.int16), b.view(torch.int16))


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


def _wkv6_long_inputs(hd, decay, init, dev):
    """S 4,096 from seeded normals: slow decay (logw about -0.0025 a step,
    the state keeps some 400 steps) or fast (about -1)."""
    g = _gen(hd + (decay == "fast"), dev)
    B, S, H = 1, 4096, 2
    r, k, v = (0.5 * torch.randn((B, S, H, hd), generator=g, device=dev)
               for _ in range(3))
    z = torch.randn((B, S, H, hd), generator=g, device=dev)
    logw = -torch.exp(0.5 * z - (6.0 if decay == "slow" else 0.0))
    u = 0.3 * torch.randn((H, hd), generator=g, device=dev)
    s0 = 0.3 * torch.randn((B, H, hd, hd), generator=g, device=dev) \
        if init else None
    return r, k, v, logw, u, s0


@pytest.mark.gpu
@pytest.mark.parametrize("decay", ["slow", "fast"])
@pytest.mark.parametrize("hd", [32, 64, 128])
def test_wkv6_kernel_long_sequence(cuda, hd, decay):
    """S 4,096 from an initial state against both plain versions (chunk 16
    keeps the chunked form's exp(-cum) under its e^75 clip at fast
    decay)."""
    r, k, v, logw, u, s0 = _wkv6_long_inputs(hd, decay, True, cuda)
    got = ops.wkv6(r, k, v, logw, u, 16, initial_state=s0)
    torch.cuda.synchronize()
    for want in (ref.wkv6_chunked_ref(r, k, v, logw, u, 16,
                                      initial_state=s0),
                 ref.wkv6_ref(r, k, v, logw, u, initial_state=s0)):
        torch.testing.assert_close(got[0], want[0], **WKV_TOL)
        torch.testing.assert_close(got[1], want[1], **WKV_TOL)


@pytest.mark.gpu
@pytest.mark.parametrize("hd", [32, 64, 128])
def test_wkv6_kernel_is_deterministic(cuda, hd):
    r, k, v, logw, u, s0 = _wkv6_long_inputs(hd, "slow", True, cuda)
    a = ops.wkv6(r.bfloat16(), k.bfloat16(), v.bfloat16(), logw, u, 16,
                 initial_state=s0)
    b = ops.wkv6(r.bfloat16(), k.bfloat16(), v.bfloat16(), logw, u, 16,
                 initial_state=s0)
    torch.cuda.synchronize()
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


@pytest.mark.gpu
def test_wkv6_kernel_refuses_a_misaligned_state(cuda):
    """The kernel reads the state by 16-byte loads."""
    x = torch.zeros((1, 8, 2, 32), device=cuda)
    u = torch.zeros((2, 32), device=cuda)
    s0 = torch.zeros(2 * 32 * 32 + 1, device=cuda)[1:].view(1, 2, 32, 32)
    with pytest.raises(ValueError, match="16-byte aligned"):
        ops.wkv6(x, x, x, x, u, 8, initial_state=s0)


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


def _sqdist_one_launch(xq, xm):
    n0 = ops.LAUNCHES["pairwise_sqdist"]
    d2 = ops.pairwise_sqdist(xq, xm)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["pairwise_sqdist"] == n0 + 1
    return d2


@pytest.mark.gpu
@pytest.mark.parametrize("F", [1, 3, 16, 33, 130, 256])
def test_pairwise_sqdist_kernel_zero_diagonal(cuda, F):
    """A set against itself: the norms and the dot products run the same
    fmaf chain in feature order, so every diagonal entry is exactly 0."""
    x = torch.randn((517, F), generator=_gen(F, cuda), device=cuda)
    d2 = _sqdist_one_launch(x, x)
    assert torch.equal(d2.diagonal(), torch.zeros(517, device=cuda))
    assert bool((d2 >= 0).all())


@pytest.mark.gpu
@pytest.mark.parametrize("F", [7, 16])
@pytest.mark.parametrize("M", [1, 3, 1023, 1025])
@pytest.mark.parametrize("Q", [1, 63, 8193])
def test_pairwise_sqdist_kernel_ragged_shapes(cuda, Q, M, F):
    """Ragged tiles on both sides, rows not 16-byte aligned (M % 4 != 0:
    scalar stores) and unaligned feature rows (F 7: scalar loads)."""
    g = _gen(Q * M + F, cuda)
    xq = torch.randn((Q, F), generator=g, device=cuda)
    xm = torch.randn((M, F), generator=g, device=cuda)
    torch.testing.assert_close(_sqdist_one_launch(xq, xm),
                               ref.pairwise_sqdist_ref(xq, xm),
                               atol=1e-4, rtol=1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("F", [6, 16, 130])
def test_pairwise_sqdist_kernel_large_inputs(cuda, F):
    """Inputs at scale 1e3 (distances near 2e6 F): the expansion's
    rounding stays within rtol 1e-4 of the plain version's."""
    g = _gen(1000 + F, cuda)
    xq = 1e3 * torch.randn((300, F), generator=g, device=cuda)
    xm = 1e3 * torch.randn((200, F), generator=g, device=cuda)
    torch.testing.assert_close(_sqdist_one_launch(xq, xm),
                               ref.pairwise_sqdist_ref(xq, xm),
                               atol=1e-4, rtol=1e-4)


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


def _walk_inputs(dev, C, S, shape, categorical, *, dynamic=False,
                 per_chain=False, extra=False, valid=False, noise_std=0.0,
                 seed=0):
    """Random inputs of ``ops.anneal_walk`` made on the card: a table in
    [0, 3), temperatures in [0.1, 1.1), valid starting states, the draws
    as ``anneal_fleet`` makes them; the valid mask (about 4 in 5 states)
    holds every chain's start."""
    from repro_torch.core.annealing import _draw
    from repro_torch.core.state import EncodedSpace

    g = _gen(seed, dev)
    size = 1
    for n in shape:
        size *= n
    lead = (C,) if per_chain else ()
    time = (S,) if dynamic else ()
    table = 3.0 * torch.rand(lead + time + (size,), generator=g, device=dev)
    taus = 0.1 + torch.rand((C, S), generator=g, device=dev)
    inits = torch.stack([torch.randint(0, n, (C,), generator=g, device=dev)
                         for n in shape], -1).to(torch.int32)
    d = _draw(g, EncodedSpace(tuple(shape), tuple(categorical)), C, S,
              noise_std > 0, dev)
    kw = dict(shape=tuple(shape), categorical=tuple(categorical),
              dynamic=dynamic, per_chain=per_chain, noise_std=noise_std,
              noise=d.get("noise"), noise0=d.get("noise0"))
    if extra:
        kw["extra"] = torch.rand((C, size), generator=g, device=dev)
    if valid:
        mask = torch.rand(size, generator=g, device=dev) < 0.8
        strides = torch.tensor([1] * len(shape), device=dev)
        for i in range(len(shape) - 2, -1, -1):
            strides[i] = strides[i + 1] * shape[i + 1]
        mask[(inits.long() * strides).sum(-1)] = True
        kw["valid"] = mask
    return (inits, table, taus, d["axis"], d["up"], d["pick"],
            d["uniform"]), kw


def _walk_equal(args, kw):
    n0 = ops.LAUNCHES["anneal_walk"]
    got = ops.anneal_walk(*args, **kw)
    want = ref.anneal_walk_ref(*args, **kw)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["anneal_walk"] == n0 + 1
    # bit-equal: the plain version's roundings in its order, -fmad=false,
    # expf as torch.exp calls it, a strict < against the uniform; a NaN
    # objective (a NaN table entry) is NaN in both
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        same = g == w
        if g.is_floating_point():
            same |= g.isnan() & w.isnan()
        assert bool(same.all())
    return got


# (C, S, shape, categorical, options): path A's 8-tier sizing shape, Fig.
# 4's sweep, Fig. 5's time-indexed table, a noisy chain, per-chain tables
# with extra rows and a valid mask at fleet_chains' bucket
WALK_FORMS = {
    "path_a": (16, 64, (4,) * 8, (False,) * 8, {"valid": True}),
    "fig4": (320, 4000, (48,), (False,), {}),
    "fig5": (1, 6000, (48,), (False,), {"dynamic": True}),
    "noisy": (33, 500, (5, 4, 3), (False, True, False),
              {"noise_std": 0.4}),
    "fleet": (1024, 32, (4, 30), (True, False),
              {"per_chain": True, "extra": True, "valid": True}),
    "dynamic_per_chain": (3, 100, (7, 1, 3), (True, False, True),
                          {"per_chain": True, "dynamic": True,
                           "extra": True}),
    "sixteen_axes": (64, 200, (3, 2) * 8, (False, True) * 8,
                     {"valid": True}),
}


@pytest.mark.gpu
@pytest.mark.parametrize("form", list(WALK_FORMS))
def test_anneal_walk_kernel_on_card(cuda, form):
    C, S, shape, cat, opt = WALK_FORMS[form]
    args, kw = _walk_inputs(cuda, C, S, shape, cat, **opt)
    _, _, accepts = _walk_equal(args, kw)
    assert 0 < float(accepts.float().mean()) < 1


@pytest.mark.gpu
@pytest.mark.parametrize("C", [1, 31, 33, 1023])
@pytest.mark.parametrize("valid", [False, True])
def test_anneal_walk_kernel_ragged_chain_counts(cuda, C, valid):
    args, kw = _walk_inputs(cuda, C, 50, (6, 5), (False, True), valid=valid,
                            seed=C)
    _walk_equal(args, kw)


@pytest.mark.gpu
def test_anneal_walk_kernel_broadcast_temperatures(cuda):
    """Scalar, per-chain and per-step temperatures: the kernel reads a
    dense (C, S) array, so it refuses a broadcast view, and the dense copy
    (what ``anneal_fleet`` hands it) walks bit-equal."""
    args, kw = _walk_inputs(cuda, 40, 60, (5, 6), (False, False), seed=3)
    inits, table, _, *draws = args
    for taus in (torch.full((), 0.7, device=cuda).expand(40, 60),
                 torch.rand(40, 1, device=cuda).expand(40, 60),
                 torch.rand(60, device=cuda).expand(40, 60)):
        with pytest.raises(ValueError, match="taus must be contiguous"):
            ops.anneal_walk(inits, table, taus, *draws, **kw)
        _walk_equal((inits, table, taus.contiguous(), *draws), kw)


@pytest.mark.gpu
def test_anneal_walk_kernel_infinite_and_nan_objectives(cuda):
    """Infinite table entries (the surrogate source's invalid states) and
    NaN steps: the clamp keeps NaN as torch.clamp does, so the accept
    flags still match."""
    args, kw = _walk_inputs(cuda, 64, 80, (8, 4), (False, True), seed=5)
    table = args[1].clone()
    table[::7] = float("inf")
    table[3::11] = float("nan")
    _walk_equal((args[0], table) + args[2:], kw)


@pytest.mark.gpu
def test_anneal_walk_kernel_refuses_what_it_does_not_take(cuda):
    args, kw = _walk_inputs(cuda, 4, 10, (1,) * 30 + (2, 3, 2),
                            (False,) * 33)
    with pytest.raises(ValueError, match="at most 32"):
        ops.anneal_walk(*args, **kw)
    args, kw = _walk_inputs(cuda, 4, 10, (3, 4), (False, False))
    with pytest.raises(TypeError, match="int64"):
        ops.anneal_walk(args[0], args[1], args[2], args[3].to(torch.int32),
                        *args[4:], **kw)
    with pytest.raises(ValueError, match="lie on the CPU or all"):
        ops.anneal_walk(args[0].cpu(), *args[1:], **kw)


def _plan_of(args, kw):
    """The plan ``ops.anneal_walk`` makes for these inputs on this card."""
    inits, table, taus, axis = args[:4]
    C, S = axis.shape
    smem, sms = ops._card_limits(axis.device)
    return ops.walk_plan(
        C, S, inits.shape[1], table.shape[-1], per_chain=kw["per_chain"],
        dynamic=kw["dynamic"], extra=kw.get("extra") is not None,
        valid=kw.get("valid") is not None, noisy=kw["noise_std"] > 0,
        smem_limit=smem, sms=sms)


# a one-axis space of 48 states (staged) and path A's 16-axis grid
# (unstaged), both in windows of 64 steps when S > 32, else of 32
WINDOW_FORMS = {"staged": ((48,), (False,)),
                "unstaged": ((4,) * 8 + (2,) * 8, (False, True) * 8)}


@pytest.mark.gpu
@pytest.mark.parametrize("S", [1, 31, 32, 33, 63, 64, 65, 129])
@pytest.mark.parametrize("form", list(WINDOW_FORMS))
def test_anneal_walk_kernel_at_the_window_edges(cuda, form, S):
    """S at the edges of a window (W - 1, W, W + 1, 2W + 1 for W = 32 and
    64): the windows' copies, the look-ahead into the next window and the
    last window's write-out."""
    shape, cat = WINDOW_FORMS[form]
    args, kw = _walk_inputs(cuda, 40, S, shape, cat, valid=form == "staged",
                            seed=S)
    plan = _plan_of(args, kw)
    assert plan.staged == (form == "staged")
    assert plan.window == (64 if S > 32 else 32)
    _walk_equal(args, kw)


@pytest.mark.gpu
@pytest.mark.parametrize("over", [0, 1])
def test_anneal_walk_kernel_table_at_the_staging_limit(cuda, over):
    """A shared table one float under, then one over, the room a block of
    32-step windows leaves it: staged, then unstaged, bit-equal both
    ways."""
    smem, _ = ops._card_limits(cuda)
    flags = dict(per_chain=False, dynamic=False, extra=False, valid=False,
                 noisy=False)
    room = (smem - ops.walk_smem(32, False, 1, 1, **flags)) // 4
    while ops.walk_smem(32, True, 1, room, **flags) > smem:
        room -= 1
    size = room + over
    args, kw = _walk_inputs(cuda, 40, 100, (size,), (False,), seed=over)
    plan = _plan_of(args, kw)
    assert plan.staged == (not over)
    _walk_equal(args, kw)


@pytest.mark.gpu
@pytest.mark.parametrize("noise_std", [0.0, 0.3])
def test_anneal_walk_kernel_thirty_two_axes(cuda, noise_std):
    """WALK_MAX_DIM axes (fields of 2 and 1 bits of the packed state for
    the size-3 and size-2 axes, none for the size-1 ones), some
    categorical, with a valid mask."""
    shape = (3, 2) * 8 + (2, 1) * 8
    cat = (False, True, True, False) * 8
    assert len(shape) == ops.WALK_MAX_DIM
    args, kw = _walk_inputs(cuda, 45, 150, shape, cat, valid=True,
                            noise_std=noise_std, seed=32)
    _walk_equal(args, kw)


@pytest.mark.gpu
def test_anneal_walk_kernel_packed_state_past_32_bits(cuda):
    """17 axes of 3 states (2 bits each: fields up to bit 34 of the packed
    state) and 15 of one, 129,140,163 states in all."""
    shape = (3,) * 17 + (1,) * 15
    cat = (False, True) * 16
    args, kw = _walk_inputs(cuda, 40, 60, shape, cat, seed=34)
    assert not _plan_of(args, kw).staged
    _walk_equal(args, kw)



@pytest.mark.gpu
@pytest.mark.parametrize("form", list(WINDOW_FORMS))
def test_anneal_walk_kernel_infinities_nan_and_mask(cuda, form):
    """+inf, -inf and NaN table entries with a valid mask, staged and
    unstaged: the division's special cases and the masked rejections
    walk as the plain version does."""
    shape, cat = WINDOW_FORMS[form]
    args, kw = _walk_inputs(cuda, 70, 120, shape, cat, valid=True, seed=7)
    table = args[1].clone()
    table[::5] = float("inf")
    table[2::9] = float("-inf")
    table[3::11] = float("nan")
    args = (args[0], table) + args[2:]
    assert _plan_of(args, kw).staged == (form == "staged")
    _, ys, accepts = _walk_equal(args, kw)
    assert bool(ys.isinf().any()) and bool(ys.isnan().any())
    assert 0 < float(accepts.float().mean()) < 1


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(4, 3), (7, 1, 3)])
def test_anneal_walk_kernel_per_chain_time_indexed_ragged(cuda, shape):
    """Per-chain time-indexed tables with extra rows at C = 37 (not a
    multiple of a block's 32 chains): staged a window at a time (12
    states), unstaged (21)."""
    args, kw = _walk_inputs(cuda, 37, 100, shape, (True,) + (False,) * (
        len(shape) - 1), per_chain=True, dynamic=True, extra=True, seed=37)
    assert _plan_of(args, kw).staged == (len(shape) == 2)
    _walk_equal(args, kw)


@pytest.mark.gpu
@pytest.mark.parametrize("form", ["path_a", "fig4", "fig5", "noisy",
                                  "fleet", "dynamic_per_chain"])
@pytest.mark.parametrize("variant", ["unstaged", "other_window"])
def test_anneal_walk_kernel_variants_agree(cuda, monkeypatch, form,
                                           variant):
    """The plan's variants walk alike: every form run unstaged, and run in
    the window its plan did not pick (32 and 64 steps swapped), is
    bit-equal to the plain version, as the planned runs above are."""
    C, S, shape, cat, opt = WALK_FORMS[form]
    args, kw = _walk_inputs(cuda, C, S, shape, cat, **opt)
    real = ops.walk_plan
    smem, _ = ops._card_limits(cuda)

    def forced(C, S, ndim, size, **flags):
        plan = real(C, S, ndim, size, **flags)
        keep = {k: flags[k] for k in ("per_chain", "dynamic", "extra",
                                      "valid", "noisy")}
        window, staged = plan.window, plan.staged
        if variant == "unstaged":
            staged = False
        else:
            window = 96 - window
        new = ops.WalkPlan(window, staged, ops.walk_smem(
            window, staged, ndim, size, **keep))
        assert new.smem <= smem
        return new

    monkeypatch.setattr(ops, "walk_plan", forced)
    _walk_equal(args, kw)


@pytest.mark.gpu
@pytest.mark.parametrize("form", ["fig4", "fleet"])
def test_anneal_walk_kernel_past_one_block_an_sm(cuda, form):
    """More blocks (32 chains each) than the card has SMs: 32-step windows
    even where S is longer, several blocks to an SM, bit-equal."""
    _, S, shape, cat, opt = WALK_FORMS[form]
    _, sms = ops._card_limits(cuda)
    C, S = 32 * sms + 5, max(S, 100)
    args, kw = _walk_inputs(cuda, C, S, shape, cat, seed=5, **opt)
    assert _plan_of(args, kw).window == 32
    _walk_equal(args, kw)


@pytest.mark.gpu
def test_fleet_chains_padding_is_bit_identical_on_card(cuda):
    from repro_torch.core.annealing import fleet_chains

    C, S, shape = 1000, 32, (4, 30)
    g = _gen(9, cuda)
    tables = torch.rand((C, 120), generator=g, device=cuda)
    taus = 0.2 + torch.rand((C, S), generator=g, device=cuda)
    inits = torch.stack([torch.randint(0, n, (C,), generator=g, device=cuda)
                         for n in shape], -1).to(torch.int32)
    extra = torch.rand((C, 120), generator=g, device=cuda)
    kw = dict(shape=shape, categorical=(True, False), device="cuda")
    n0 = ops.LAUNCHES["anneal_walk"]
    padded = fleet_chains(_gen(1, cuda), tables, None, taus, inits, extra,
                          bucket=True, **kw)
    flat = fleet_chains(_gen(1, cuda), tables, None, taus, inits, extra,
                        bucket=False, **kw)
    assert ops.LAUNCHES["anneal_walk"] == n0 + 2
    for a, b in zip(padded, flat):
        assert a.shape[0] == C and torch.equal(a, b)


# ---------------------------------------------------------------------------
# The fleet: per-tenant draw streams and rounds, card against host.
# ---------------------------------------------------------------------------


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(4, 16), (7, 1, 3, 2), (65_536,)])
def test_tenant_draws_bit_identical_on_card_and_host(cuda, shape):
    import numpy as np

    from repro_torch.core import tenant_draws
    from repro_torch.core.state import EncodedSpace

    enc = EncodedSpace(shape, (False,) * len(shape))
    ids = np.concatenate([np.arange(1000), [2**31 - 1, 2**32 - 1]])
    for seed, r in ((0, 0), (1024, 117), (2**63 + 5, 2**32 - 1)):
        host = tenant_draws(seed, r, ids, enc, 33, device="cpu")
        card = tenant_draws(seed, r, torch.as_tensor(ids, device=cuda), enc,
                            33, device=cuda)
        for k in host:
            assert card[k].device.type == "cuda"
            assert torch.equal(card[k].cpu(), host[k]), k


@pytest.mark.gpu
@pytest.mark.parametrize("incremental", [False, True])
def test_fleet_rounds_on_card_decide_as_on_host(cuda, incremental):
    import dataclasses

    from repro_torch.core import (EC2_CATALOG_ADJUSTED, Objective,
                                  PenalizedObjective, TraceReplayController,
                                  make_ec2_space)
    from repro_torch.core.costmodel import SimulatedEvaluator
    from repro_torch.workloads.trace import synthetic_trace

    def replay(device):
        T = 24
        cat = EC2_CATALOG_ADJUSTED.with_capacities(
            {f: 12.0 * T for f in EC2_CATALOG_ADJUSTED.names()})
        ev = SimulatedEvaluator(cat)
        ctl = TraceReplayController(
            synthetic_trace(sorted(ev.jobs), n_tenants=T, horizon_s=420.0,
                            seed=5, n_profiles=12),
            make_ec2_space(cat, core_counts=tuple(range(4, 132, 8))), cat,
            ev, objective=PenalizedObjective(Objective(lambda_cost=200.0),
                                             weight=25.0),
            budget_usd_hr=1.6 * T, steps_per_round=32, slo_s=3600.0, seed=5,
            incremental=incremental, keep_decision_log=True, device=device)
        n0 = ops.LAUNCHES["anneal_walk"]
        ctl.replay()
        walks = ops.LAUNCHES["anneal_walk"] - n0
        return ([(d.round, d.tenant, d.action, dataclasses.astuple(d.config),
                  d.y, d.accepted, d.explored, d.tau, d.reheated, d.violation)
                 for d in ctl.fleet.decisions], ctl, walks)

    host, _, _ = replay("cpu")
    card, ctl, walks = replay("cuda")
    assert card == host
    assert walks == sum(r["n_annealed"] > 0 for r in ctl.rounds)
