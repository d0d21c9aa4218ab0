"""Public wrappers around the hand kernels.

Each wrapper checks its inputs, then dispatches on where they lie: tensors
on the CPU go through the plain PyTorch version in :mod:`.ref`; tensors on
a CUDA device launch the hand kernel on PyTorch's current stream, or
raise.  There is no fallback from the card to the plain version.

Every launch adds one to :data:`LAUNCHES` under the kernel's name, so a
run can show that its main path went through the kernels.
:func:`flash_attention_trainable` is the differentiable attention of the
training path: :func:`flash_attention` forward (with its row statistics)
and :func:`flash_attention_bwd` backward.
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch

from . import build, ref

#: Kernel launches since the last :func:`reset_launches`, by kernel name.
LAUNCHES: dict[str, int] = {"sizing_latency": 0, "fused_interp": 0,
                             "flash_attention": 0, "flash_decode": 0,
                             "flash_attention_bwd": 0, "quantize_int8": 0,
                             "rglru_scan": 0, "wkv6": 0,
                             "pairwise_sqdist": 0, "anneal_walk": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_L = ctypes.c_longlong
_SIGNATURES = {
    "sizing_latency": ("sizing_latency_launch",
                       [_P] * 7 + [_I, _I, _I, _F, _P]),
    "fused_interp": ("fused_interp_launch",
                     [_P] * 6 + [_I, _I, _I, _I, _F, _F, _F, _P]),
    "flash_attention": ("flash_attention_launch",
                        [_P] * 7 + [_I] * 9 + [_F, _P]),
    "flash_attention_bwd": ("flash_attention_bwd_launch",
                            [_P] * 11 + [_I] * 9 + [_F, _P]),
    "quantize_int8": ("quantize_int8_launch",
                      [_P] * 3 + [ctypes.c_longlong] + [_I] * 3 + [_P]),
    "flash_decode": ("flash_decode_launch",
                     [_P] * 9 + [_I] * 8 + [_F, _I, _P]),
    "rglru_scan": ("rglru_scan_launch", [_P] * 3 + [_I] * 3 + [_P]),
    "wkv6": ("wkv6_launch", [_P] * 9 + [_I] * 5 + [_P]),
    "pairwise_sqdist": ("pairwise_sqdist_launch",
                        [_P] * 3 + [_I] * 3 + [_P]),
    "anneal_walk": ("anneal_walk_launch",
                    [_P, _P, _L, _L] + [_P] * 6 + [_L]
                    + [_P] * 3 + [_F] + [_I] * 3 + [_P] * 7),
}
_fns: dict[str, object] = {}


def _kernel(name: str):
    fn = _fns.get(name)
    if fn is None:
        sym, argtypes = _SIGNATURES[name]
        fn = getattr(build.library(name), sym)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return fn


def _walk_set_plan():
    """This checkout's ``anneal_walk_set_plan``: the plan of the thread's
    next ``anneal_walk_launch``."""
    fn = _fns.get("anneal_walk_set_plan")
    if fn is None:
        fn = build.library("anneal_walk").anneal_walk_set_plan
        fn.argtypes = [_I] * 3
        fn.restype = ctypes.c_int
        _fns["anneal_walk_set_plan"] = fn
    return fn


def _on_card(name: str, tensors: dict[str, torch.Tensor],
             dtypes: dict[str, torch.dtype | tuple[torch.dtype, ...]],
             strided: tuple[str, ...] = ()) -> bool:
    """True when the inputs lie on one CUDA device (launch the kernel),
    False when all lie on the CPU (run the plain version); raises on a
    mix, another device type, or what the kernel does not take.  Inputs
    named in ``strided`` need only a unit stride in their last dimension;
    the others must be contiguous."""
    kinds = {t.device.type for t in tensors.values()}
    if kinds == {"cpu"}:
        return False
    if kinds != {"cuda"} or len({t.device for t in tensors.values()}) != 1:
        raise ValueError(f"{name}: inputs must all lie on the CPU or all on "
                         f"one CUDA device, got "
                         f"{[str(t.device) for t in tensors.values()]}")
    for arg, t in tensors.items():
        want = dtypes[arg] if isinstance(dtypes[arg], tuple) \
            else (dtypes[arg],)
        if t.dtype not in want:
            raise TypeError(f"{name}: {arg} must be "
                            f"{' or '.join(map(str, want))} on the card, "
                            f"got {t.dtype}")
        if arg in strided:
            if t.stride(-1) != 1:
                raise ValueError(f"{name}: {arg} must have a unit stride in "
                                 f"its last dimension on the card")
        elif not t.is_contiguous():
            raise ValueError(f"{name}: {arg} must be contiguous on the card")
    return True


# A launch reads its inputs through raw pointers after the wrapper returns;
# inputs the caller then drops stay valid, because PyTorch's caching
# allocator hands their memory only to work queued later on the same stream.


def _check(name: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError_t {err}")


def sizing_latency(lam, mu, repl, visit_w, adj, *, c_max: int,
                   sat_s: float = 1e4):
    """lam/mu/repl/visit_w (B, K) float32, adj (K, K) bool -> (sojourn
    (B, K), path (B, K)), both float32: the container-sizing M/M/c +
    critical-path evaluator.

    ``lam`` is the tier arrival rate, ``mu`` the per-replica service rate
    (> 0), ``repl`` the integer replica count as float (1 <= repl <=
    ``c_max``; a larger count selects no Erlang-B term and waits 0),
    ``visit_w`` the per-row node weights, ``adj[v, u]`` True when tier v
    calls tier u.  ``path[:, v]`` is the weighted critical path of the
    sub-DAG rooted at v.  On the card K is at most 32.
    """
    B, K = lam.shape
    for arg, x in (("mu", mu), ("repl", repl), ("visit_w", visit_w)):
        if tuple(x.shape) != (B, K):
            raise ValueError(f"{arg} shape {tuple(x.shape)} != {(B, K)}")
    if tuple(adj.shape) != (K, K):
        raise ValueError(f"adj shape {tuple(adj.shape)} != {(K, K)}")
    if c_max < 1:
        raise ValueError("c_max must be >= 1")
    f32 = torch.float32
    if not _on_card("sizing_latency",
                    {"lam": lam, "mu": mu, "repl": repl, "visit_w": visit_w,
                     "adj": adj},
                    {"lam": f32, "mu": f32, "repl": f32, "visit_w": f32,
                     "adj": torch.bool}):
        return ref.sizing_latency_ref(lam, mu, repl, visit_w, adj,
                                      c_max=c_max, sat_s=sat_s)
    if K > 32:
        raise ValueError(f"sizing_latency kernel takes K <= 32 tiers, got {K}")
    soj = torch.empty((B, K), dtype=f32, device=lam.device)
    path = torch.empty((B, K), dtype=f32, device=lam.device)
    if B == 0:
        return soj, path
    with torch.cuda.device(lam.device):
        _check("sizing_latency", _kernel("sizing_latency")(
            lam.data_ptr(), mu.data_ptr(), repl.data_ptr(),
            visit_w.data_ptr(), adj.data_ptr(), soj.data_ptr(),
            path.data_ptr(), B, K, int(c_max), float(sat_s),
            torch.cuda.current_stream().cuda_stream))
    LAUNCHES["sizing_latency"] += 1
    return soj, path


#: The least normal float32: the card's reciprocal (``ieee_div.cuh``
#: ``rcp_rn``) takes arguments at or above it.
_F32_MIN = torch.finfo(torch.float32).tiny


def fused_interp(xq, xm, y, w_rec, *, kind: str = "idw",
                 length_scale: float = 0.25, idw_power: float = 2.0,
                 eps: float = 1e-9):
    """Fused surrogate refit: xq (Q, F), xm (M, F), y (M,), w_rec (M,)
    float32 -> (mean (Q,), dmin (Q,)) float32 — the IDW/RBF estimate (the
    recency-weighted global mean as the far-field fallback) and the
    nearest-measurement distance, with no (Q, M) distance matrix in device
    memory.  Rows with zero recency weight contribute nothing to the
    estimate.  On the card F is at most 256, eps (IDW) at least the least
    normal float32, and 2 length_scale^2 (RBF) a normal float32.
    """
    Q, F = xq.shape
    M, F2 = xm.shape
    if F != F2:
        raise ValueError(f"feature dims differ: {F} vs {F2}")
    if tuple(y.shape) != (M,) or tuple(w_rec.shape) != (M,):
        raise ValueError(f"y/w_rec shapes {tuple(y.shape)}/"
                         f"{tuple(w_rec.shape)} != ({M},)")
    if kind not in ("idw", "rbf"):
        raise ValueError(f"unknown interp kind {kind!r}")
    if M < 1:
        raise ValueError("fused_interp needs at least one measurement")
    f32 = torch.float32
    if not _on_card("fused_interp",
                    {"xq": xq, "xm": xm, "y": y, "w_rec": w_rec},
                    {"xq": f32, "xm": f32, "y": f32, "w_rec": f32}):
        return ref.fused_interp_ref(xq, xm, y, w_rec, kind=kind,
                                    length_scale=length_scale,
                                    idw_power=idw_power, eps=eps)
    if F > 256:
        raise ValueError(f"fused_interp kernel takes F <= 256, got {F}")
    if kind == "idw" and not eps >= _F32_MIN:
        raise ValueError(f"fused_interp kernel takes eps >= {_F32_MIN}, got "
                         f"{eps}")
    rbf_den = 2.0 * length_scale * length_scale
    if kind == "rbf" and not _F32_MIN <= rbf_den <= torch.finfo(
            torch.float32).max:
        raise ValueError(f"fused_interp kernel takes 2 length_scale^2 in "
                         f"the normal float32 range, got {rbf_den}")
    mean = torch.empty((Q,), dtype=f32, device=xq.device)
    dmin = torch.empty((Q,), dtype=f32, device=xq.device)
    if Q == 0:
        return mean, dmin
    with torch.cuda.device(xq.device):
        _check("fused_interp", _kernel("fused_interp")(
            xq.data_ptr(), xm.data_ptr(), y.data_ptr(), w_rec.data_ptr(),
            mean.data_ptr(), dmin.data_ptr(), Q, M, F, int(kind == "rbf"),
            float(idw_power / 2.0), float(eps), float(rbf_den),
            torch.cuda.current_stream().cuda_stream))
    LAUNCHES["fused_interp"] += 1
    return mean, dmin


def reciprocal_rn(x):
    """Not on any path: 1 / x as the kernels take it (``ieee_div.cuh``
    ``rcp_rn``, the IDW weight's reciprocal), elementwise over float32 x
    of magnitude at least 2^-126 (0 past 2^126, where IEEE's quotient is
    subnormal); IEEE 1 / x on the CPU.  For the tests: on the card it must
    equal IEEE division with subnormal results flushed to zero."""
    if not _on_card("reciprocal_rn", {"x": x}, {"x": torch.float32}):
        return 1.0 / x
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    fn = _fns.get("reciprocal_rn")
    if fn is None:
        fn = build.library("fused_interp").fused_interp_reciprocal
        fn.argtypes = [_P, _P, ctypes.c_longlong, _P]
        fn.restype = ctypes.c_int
        _fns["reciprocal_rn"] = fn
    with torch.cuda.device(x.device):
        _check("reciprocal_rn", fn(x.data_ptr(), out.data_ptr(), x.numel(),
                                   torch.cuda.current_stream().cuda_stream))
    return out


#: Mask kinds of :func:`flash_attention`, as the kernel numbers them.
ATTENTION_KINDS = {"causal": 0, "window": 1, "chunk": 2, "bidir": 3,
                   "cross": 3}
_ATTN_DTYPES = (torch.float32, torch.bfloat16)


def _attention_shapes(q, k, v, kind: str) -> tuple[int, ...]:
    """(B, Sq, H, hd, Sk, K) of model-layout q, k, v; raises on shapes the
    attention kernels do not take."""
    if q.dim() != 4 or k.dim() != 4 or tuple(k.shape) != tuple(v.shape):
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)}, v "
                         f"{tuple(v.shape)}: want (B, Sq, H, hd) and two "
                         f"(B, Sk, K, hd)")
    B, Sq, H, hd = q.shape
    _, Sk, K, hd2 = k.shape
    if k.shape[0] != B or hd2 != hd or K < 1 or H % K:
        raise ValueError(f"q {tuple(q.shape)} and k/v {tuple(k.shape)} do "
                         f"not match (H must be a multiple of K)")
    if kind not in ATTENTION_KINDS:
        raise ValueError(f"unknown attention kind {kind!r}")
    return B, Sq, H, hd, Sk, K


def _strides(*tensors) -> ctypes.Array:
    """(batch, seq, head) strides of model-layout tensors, for a kernel."""
    return (ctypes.c_longlong * (3 * len(tensors)))(
        *(t.stride(i) for t in tensors for i in range(3)))


def flash_attention(q, k, v, *, kind: str = "causal", window: int = 0,
                    softcap: float = 0.0, return_stats: bool = False):
    """Masked GQA attention in the model layout: q (B, Sq, H, hd), k/v
    (B, Sk, K, hd), H % K == 0 -> (B, Sq, H, hd) in q's type (float32 or
    bfloat16; float32 math, rounded to q's type where the model rounds).
    With ``return_stats`` it returns ``(o, (m, l))``: each row's max score
    and sum of exponentials, (B, H, Sq) float32, which
    :func:`flash_attention_bwd` reads (the plain version computes them
    with :func:`ref.flash_attention_stats_ref`).
    Query head h reads kv head h // (H / K).  ``kind`` is causal, window,
    chunk (both with ``window``), bidir or cross; ``softcap`` > 0 caps
    scores with tanh.
    Any Sq and Sk; the card reads the inputs through their strides (unit
    stride in the head dim) and takes hd <= 256.  In bf16 the card's
    products run on the tensor cores, and each score's float32 sum rounds
    to bf16 as the plain version's sequential float32 sum does (sums near
    a rounding midpoint are taken again in order; see
    ``csrc/flash_attention.cu``), so the row statistics match the plain
    ones to float32 rounding.

    With a softcap the two paths treat refused keys differently.  The
    plain version (the model's math) adds the -2e30 mask before the tanh,
    so a refused key scores -softcap and keeps weight exp(-softcap - max),
    and a row with no key averages v.  The card's kernel (as the TPU
    kernel) masks after the tanh: refused keys get no weight and a row
    with no key is 0.  They agree wherever the refused keys' weight is
    below the tolerance, as in causal rows, whose diagonal is never
    refused.
    """
    B, Sq, H, hd, Sk, K = _attention_shapes(q, k, v, kind)
    if not _on_card("flash_attention", {"q": q, "k": k, "v": v},
                    {"q": _ATTN_DTYPES, "k": _ATTN_DTYPES,
                     "v": _ATTN_DTYPES}, strided=("q", "k", "v")):
        o = ref.flash_attention_ref(q, k, v, kind=kind, window=window,
                                    softcap=softcap)
        if not return_stats:
            return o
        return o, ref.flash_attention_stats_ref(q, k, kind=kind,
                                                window=window,
                                                softcap=softcap)
    if not q.dtype == k.dtype == v.dtype:
        raise TypeError(f"flash_attention: q, k, v types differ "
                        f"({q.dtype}, {k.dtype}, {v.dtype})")
    if hd > 256:
        raise ValueError(f"flash_attention kernel takes hd <= 256, got {hd}")
    o = torch.empty((B, Sq, H, hd), dtype=q.dtype, device=q.device)
    stats = tuple(torch.empty((B, H, Sq), dtype=torch.float32,
                              device=q.device)
                  for _ in range(2 if return_stats else 0))
    if B == 0 or Sq == 0:
        return (o, stats) if return_stats else o
    if Sk == 0:
        raise ValueError("flash_attention needs at least one key")
    strides = _strides(q, k, v, o)
    m_ptr, l_ptr = (t.data_ptr() for t in stats) if return_stats else (0, 0)
    with torch.cuda.device(q.device):
        _check("flash_attention", _kernel("flash_attention")(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), m_ptr,
            l_ptr, ctypes.addressof(strides), B, H, K, Sq, Sk, hd,
            int(q.dtype == torch.bfloat16), ATTENTION_KINDS[kind],
            int(window), float(softcap),
            torch.cuda.current_stream().cuda_stream))
    LAUNCHES["flash_attention"] += 1
    return (o, stats) if return_stats else o


def flash_attention_bwd(q, k, v, dout, stats=None, *, kind: str = "causal",
                        window: int = 0, softcap: float = 0.0):
    """The gradient of :func:`flash_attention`: q (B, Sq, H, hd), k/v
    (B, Sk, K, hd) and the output gradient ``dout`` (B, Sq, H, hd), all
    of one type -> (dq, dk, dv) in that type, with the model's rounding
    points (see ``csrc/flash_attention_bwd.cu``).  ``stats`` is the
    ``(m, l)`` that :func:`flash_attention` returned with
    ``return_stats``; the card needs it, the plain version
    (:func:`ref.flash_attention_bwd_ref`, autograd through the forward)
    ignores it.  The card reads q, k, v and dout through their strides
    (unit stride in the head dim) and takes hd <= 128; dk and dv are
    summed over the query heads of each kv head without atomics, so the
    result does not change from run to run.  In bf16 it recomputes the
    forward's scores bit for bit (the same tensor-core sums, rounded as
    the forward rounds them), so its weights sum to 1 per row.  With a softcap the kernel,
    as its forward, gives refused keys no weight (see
    :func:`flash_attention`).
    """
    B, Sq, H, hd, Sk, K = _attention_shapes(q, k, v, kind)
    if tuple(dout.shape) != (B, Sq, H, hd):
        raise ValueError(f"dout {tuple(dout.shape)} != {(B, Sq, H, hd)}")
    if not _on_card("flash_attention_bwd",
                    {"q": q, "k": k, "v": v, "dout": dout},
                    {"q": _ATTN_DTYPES, "k": _ATTN_DTYPES,
                     "v": _ATTN_DTYPES, "dout": _ATTN_DTYPES},
                    strided=("q", "k", "v", "dout")):
        return ref.flash_attention_bwd_ref(q, k, v, dout, kind=kind,
                                           window=window, softcap=softcap)
    if not q.dtype == k.dtype == v.dtype == dout.dtype:
        raise TypeError(f"flash_attention_bwd: q, k, v, dout types differ "
                        f"({q.dtype}, {k.dtype}, {v.dtype}, {dout.dtype})")
    if hd > 128:
        raise ValueError(f"flash_attention_bwd kernel takes hd <= 128, "
                         f"got {hd}")
    if stats is None:
        raise ValueError("flash_attention_bwd needs the forward's row "
                         "statistics on the card (flash_attention(..., "
                         "return_stats=True))")
    m, l = stats
    for name, t in (("m", m), ("l", l)):
        if (tuple(t.shape) != (B, H, Sq) or t.dtype != torch.float32
                or not t.is_contiguous() or t.device != q.device):
            raise ValueError(f"flash_attention_bwd: stats {name} must be "
                             f"({B}, {H}, {Sq}) contiguous float32 on "
                             f"{q.device}")
    dq = torch.empty((B, Sq, H, hd), dtype=q.dtype, device=q.device)
    dk = torch.empty((B, Sk, K, hd), dtype=q.dtype, device=q.device)
    dv = torch.empty((B, Sk, K, hd), dtype=q.dtype, device=q.device)
    if B == 0 or Sq == 0 or Sk == 0:
        return dq, dk.zero_(), dv.zero_()
    D = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    strides = _strides(q, k, v, dout, dq, dk, dv)
    with torch.cuda.device(q.device):
        _check("flash_attention_bwd", _kernel("flash_attention_bwd")(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
            m.data_ptr(), l.data_ptr(), D.data_ptr(), dq.data_ptr(),
            dk.data_ptr(), dv.data_ptr(), ctypes.addressof(strides), B, H,
            K, Sq, Sk, hd, int(q.dtype == torch.bfloat16),
            ATTENTION_KINDS[kind], int(window), float(softcap),
            torch.cuda.current_stream().cuda_stream))
    LAUNCHES["flash_attention_bwd"] += 1
    return dq, dk, dv


class _FlashAttention(torch.autograd.Function):
    """:func:`flash_attention` forward, :func:`flash_attention_bwd`
    backward.  Saves q, k, v and the row statistics (B, H, Sq) x 2 float32;
    no score tensor, as the reference's ``_fat_bwd`` recomputes."""

    @staticmethod
    def forward(ctx, q, k, v, kind, window, softcap):
        # the plain backward recomputes the forward and needs no statistics
        o, stats = flash_attention(q, k, v, kind=kind, window=window,
                                   softcap=softcap, return_stats=True) \
            if q.is_cuda else (flash_attention(
                q, k, v, kind=kind, window=window, softcap=softcap), ())
        ctx.save_for_backward(q, k, v, *stats)
        ctx.opts = dict(kind=kind, window=window, softcap=softcap)
        return o

    @staticmethod
    def backward(ctx, dout):
        q, k, v, *stats = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, dout, stats or None,
                                         **ctx.opts)
        return dq, dk, dv, None, None, None


def flash_attention_trainable(q, k, v, kind: str = "causal", window: int = 0,
                              softcap: float = 0.0):
    """Differentiable :func:`flash_attention` (the reference package's
    ``kernels/ops.py`` ``flash_attention_trainable``): the forward kernel,
    and the backward kernel for the gradient; on the CPU both run their
    plain versions."""
    return _FlashAttention.apply(q, k, v, kind, int(window), float(softcap))


def attention_score_sums(q, k):
    """Not on any path: how the bf16 attention kernels sum q . k.  q, k
    (S, hd) bf16, hd 64 or 128 -> (t, fixed, seq), each (S, S) float32:
    the tensor-core sums, the same after the exact-sum fallback (the
    flagged ones replaced by the bf16 rounding of their sequential sums;
    what the kernels round to bf16), and every sum taken in order (fmaf
    from d = 0), as a plain float32 product takes it.  On the CPU all
    three are the plain float32 product.  For tests and
    ``chip_smoke.py``."""
    if q.dim() != 2 or tuple(q.shape) != tuple(k.shape):
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)}: want "
                         f"two (S, hd)")
    S, hd = q.shape
    if not _on_card("attention_score_sums", {"q": q, "k": k},
                    {"q": torch.bfloat16, "k": torch.bfloat16}):
        prod = q.float() @ k.float().T
        return prod, prod.clone(), prod.clone()
    if hd not in (64, 128):
        raise ValueError(f"attention_score_sums takes hd 64 or 128, got {hd}")
    fn = _fns.get("attention_score_sums")
    if fn is None:
        fn = build.library("flash_attention").flash_attention_score_sums
        fn.argtypes = [_P] * 5 + [_I, _I, _P]
        fn.restype = ctypes.c_int
        _fns["attention_score_sums"] = fn
    out = tuple(torch.empty((S, S), dtype=torch.float32, device=q.device)
                for _ in range(3))
    with torch.cuda.device(q.device):
        _check("attention_score_sums", fn(
            q.data_ptr(), k.data_ptr(), *(t.data_ptr() for t in out), S, hd,
            torch.cuda.current_stream().cuda_stream))
    return out


def quantize_int8(x):
    """Row-wise int8 quantization (gradient compression): x (..., N)
    float32 or bfloat16 -> (q int8 (..., N), scale float32 (..., 1)); rows
    are the leading dims.  ``scale = max(absmax, 1e-12) / 127`` and
    ``q = clip(round_half_even(x / scale), -127, 127)`` with IEEE
    divisions, bit-equal to the plain version and to the reference.  The
    card takes a contiguous x, any number of rows of any length.
    """
    if x.dim() < 1 or x.shape[-1] < 1:
        raise ValueError(f"quantize_int8 needs rows of at least one "
                         f"element, got shape {tuple(x.shape)}")
    if not _on_card("quantize_int8", {"x": x},
                    {"x": (torch.float32, torch.bfloat16)}):
        return ref.quantize_int8_ref(x)
    N = x.shape[-1]
    M = x.numel() // N
    q = torch.empty(x.shape, dtype=torch.int8, device=x.device)
    scale = torch.empty(x.shape[:-1] + (1,), dtype=torch.float32,
                        device=x.device)
    if M == 0:
        return q, scale
    vec4 = (x.dtype == torch.float32 and N % 4 == 0
            and x.data_ptr() % 16 == 0 and q.data_ptr() % 4 == 0)
    with torch.cuda.device(x.device):
        _check("quantize_int8", _kernel("quantize_int8")(
            x.data_ptr(), q.data_ptr(), scale.data_ptr(), M, N,
            int(x.dtype == torch.bfloat16), int(vec4),
            torch.cuda.current_stream().cuda_stream))
    LAUNCHES["quantize_int8"] += 1
    return q, scale


#: Blocks of flash_decode's kernel that fill the H100's 132 SMs about
#: twice, and the most dynamic shared memory one block takes (so three fit
#: on an SM).
DECODE_MIN_BLOCKS = 264
_DECODE_SMEM = 74 * 1024


def decode_split(B: int, W: int, K: int, G: int, hd: int,
                 itemsize: int) -> tuple[int, int]:
    """How :func:`flash_decode`'s kernel cuts a cache of W slots:
    ``(n_split, split_len)``, n_split contiguous splits of split_len slots
    (a multiple of 32, at most 128; the last split shorter but not empty).
    B * K * n_split reaches :data:`DECODE_MIN_BLOCKS` where W holds 32
    slots for each split that takes, and each split's rows fit the block's
    shared memory beside its weights and sums (G query heads a kv head,
    head dim hd padded to 64, 128 or 256, ``itemsize`` bytes an
    element)."""
    HD = 64 if hd <= 64 else 128 if hd <= 128 else 256
    gc = 1                  # heads a lane holds; the kernel's own rule
    while gc < G and gc < 1024 // HD:
        gc *= 2
    gp = -(-G // gc) * gc
    fixed = 4 * (4 * gc * HD + 3 * gp)
    cap = min(128, (_DECODE_SMEM - fixed) // (HD * itemsize + 4 * gp)
              // 32 * 32)
    if cap < 32:
        raise ValueError(f"flash_decode kernel: G {G} at hd {hd} leaves no "
                         f"room for a split in shared memory")
    need = -(-DECODE_MIN_BLOCKS // (B * K))
    rows = max(32, min(cap, W // need // 32 * 32))
    return -(-W // rows), rows


def flash_decode(q, k_cache, v_cache, valid_mask, *, softcap: float = 0.0):
    """One query token per sequence against a masked KV cache, in the
    model layout: q (B, 1, H, hd), caches (B, W, K, hd), valid (B, W) bool
    -> (B, 1, H, hd) in q's type (float32 or bfloat16; float32 math,
    rounded to q's type where the model rounds).  A sequence with no
    valid slot gets 0 on the card.  The card reads the caches in place; it
    takes hd <= 256 and any number of query heads per kv head.  Its kernel
    cuts the cache into :func:`decode_split` splits and runs two launches
    on the current stream, with scratch allocated here.
    """
    if q.dim() != 4 or q.shape[1] != 1:
        raise ValueError(f"q {tuple(q.shape)}: want (B, 1, H, hd)")
    B, _, H, hd = q.shape
    if k_cache.dim() != 4 or tuple(v_cache.shape) != tuple(k_cache.shape):
        raise ValueError(f"caches {tuple(k_cache.shape)}/"
                         f"{tuple(v_cache.shape)}: want two (B, W, K, hd)")
    _, W, K, hd2 = k_cache.shape
    if k_cache.shape[0] != B or hd2 != hd or K < 1 or H % K:
        raise ValueError(f"q {tuple(q.shape)} and caches "
                         f"{tuple(k_cache.shape)} do not match")
    if tuple(valid_mask.shape) != (B, W) or valid_mask.dtype != torch.bool:
        raise ValueError(f"valid_mask must be ({B}, {W}) bool, got "
                         f"{tuple(valid_mask.shape)} {valid_mask.dtype}")
    if not _on_card("flash_decode",
                    {"q": q, "k_cache": k_cache, "v_cache": v_cache,
                     "valid_mask": valid_mask},
                    {"q": _ATTN_DTYPES, "k_cache": _ATTN_DTYPES,
                     "v_cache": _ATTN_DTYPES, "valid_mask": torch.bool}):
        return ref.flash_decode_ref(q, k_cache, v_cache, valid_mask,
                                    softcap=softcap)
    if not q.dtype == k_cache.dtype == v_cache.dtype:
        raise TypeError(f"flash_decode: q and cache types differ "
                        f"({q.dtype}, {k_cache.dtype}, {v_cache.dtype})")
    if hd > 256:
        raise ValueError(f"flash_decode kernel takes hd <= 256, got {hd}")
    o = torch.empty_like(q)
    if B == 0:
        return o
    if W == 0:
        raise ValueError("flash_decode needs a cache of at least one slot")
    n_split, split_len = decode_split(B, W, K, H // K, hd, q.element_size())
    # scratch: scores (B, H, W) and partial sums (B, H, n_split, hd)
    # float32, (max, sum) pairs (B, H, n_split), tickets (B, K) int32
    offsets, total = [], 0
    for nbytes in (4 * B * H * W, 4 * B * H * n_split * hd,
                   8 * B * H * n_split, 4 * B * K):
        offsets.append(total)
        total += -(-nbytes // 256) * 256
    ws = torch.empty(total, dtype=torch.uint8, device=q.device)
    scores, partial, stats, tickets = (ws.data_ptr() + off
                                       for off in offsets)
    vec_ok = all(t.data_ptr() % 16 == 0 for t in (q, k_cache, v_cache, o))
    with torch.cuda.device(q.device):
        _check("flash_decode", _kernel("flash_decode")(
            q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
            valid_mask.data_ptr(), o.data_ptr(), scores, stats, partial,
            tickets, B, W, K, H, hd, int(q.dtype == torch.bfloat16),
            n_split, split_len, float(softcap), int(vec_ok),
            torch.cuda.current_stream().cuda_stream))
    LAUNCHES["flash_decode"] += 1
    return o


def rglru_scan(a, b):
    """The RG-LRU linear recurrence ``h_t = a_t * h_{t-1} + b_t`` from
    ``h_{-1} = 0``: a, b (B, S, R) -> h (B, S, R) in a's type, the
    reference kernel's type rule (float32 math).  Each step is one multiply
    and one add, each rounded, so the card's kernel is bit-equal to the
    plain version.  The card takes contiguous float32 a and b, any B, S
    and R.
    """
    if a.dim() != 3 or tuple(b.shape) != tuple(a.shape):
        raise ValueError(f"a {tuple(a.shape)}, b {tuple(b.shape)}: want two "
                         f"(B, S, R)")
    f32 = torch.float32
    if not _on_card("rglru_scan", {"a": a, "b": b}, {"a": f32, "b": f32}):
        return ref.rglru_scan_ref(a, b)
    B, S, R = a.shape
    h = torch.empty_like(a)
    if h.numel() == 0:
        return h
    with torch.cuda.device(a.device):
        _check("rglru_scan", _kernel("rglru_scan")(
            a.data_ptr(), b.data_ptr(), h.data_ptr(), B, S, R,
            torch.cuda.current_stream().cuda_stream))
    LAUNCHES["rglru_scan"] += 1
    return h


def wkv6(r, k, v, logw, u, chunk: int = 64, initial_state=None):
    """The RWKV-6 wkv recurrence in the model layout: r, k, v (B, S, H, hd)
    of one type (float32 or bfloat16), logw (B, S, H, hd) float32 (the
    per-step log decays), u (H, hd) float32 and the state (B, H, hd, hd)
    float32 it starts from (0 if None) -> ``(o, state)``: o (B, S, H, hd)
    float32 and the final state, the latter kept in scratch by the
    reference's kernel and needed by the serve path's prefill.  S must be
    a multiple of ``chunk`` (``min(chunk, S)``), as in the reference.

    The plain version is the model's chunked form
    (:func:`ref.wkv6_chunked_ref`); the card's kernel runs the sequential
    recurrence (:func:`ref.wkv6_ref`), the same sums in another order.  The
    card reads r, k, v and logw through their strides (unit stride in the
    head dim) and takes hd 32, 64 or 128.
    """
    if r.dim() != 4 or not (tuple(r.shape) == tuple(k.shape)
                            == tuple(v.shape) == tuple(logw.shape)):
        raise ValueError(f"r {tuple(r.shape)}, k {tuple(k.shape)}, v "
                         f"{tuple(v.shape)}, logw {tuple(logw.shape)}: want "
                         f"four (B, S, H, hd)")
    B, S, H, hd = r.shape
    if tuple(u.shape) != (H, hd):
        raise ValueError(f"u {tuple(u.shape)} != {(H, hd)}")
    if initial_state is not None and \
            tuple(initial_state.shape) != (B, H, hd, hd):
        raise ValueError(f"initial_state {tuple(initial_state.shape)} != "
                         f"{(B, H, hd, hd)}")
    chunk = min(chunk, S)
    if chunk < 1 or S % chunk:
        raise ValueError(f"wkv6: S {S} is not a multiple of chunk {chunk}")
    f32 = torch.float32
    args = {"r": r, "k": k, "v": v, "logw": logw, "u": u}
    types = {"r": _ATTN_DTYPES, "k": _ATTN_DTYPES, "v": _ATTN_DTYPES,
             "logw": f32, "u": f32}
    if initial_state is not None:
        args["initial_state"], types["initial_state"] = initial_state, f32
    if not _on_card("wkv6", args, types, strided=("r", "k", "v", "logw")):
        return ref.wkv6_chunked_ref(r, k, v, logw, u, chunk,
                                    initial_state=initial_state)
    if not r.dtype == k.dtype == v.dtype:
        raise TypeError(f"wkv6: r, k, v types differ ({r.dtype}, {k.dtype}, "
                        f"{v.dtype})")
    if hd not in (32, 64, 128):
        raise ValueError(f"wkv6 kernel takes hd 32, 64 or 128, got {hd}")
    if initial_state is not None and initial_state.data_ptr() % 16:
        raise ValueError("wkv6: initial_state must be 16-byte aligned on "
                         "the card")
    o = torch.empty((B, S, H, hd), dtype=f32, device=r.device)
    state = torch.empty((B, H, hd, hd), dtype=f32, device=r.device)
    strides = _strides(r, k, v, logw)
    s0 = 0 if initial_state is None else initial_state.data_ptr()
    with torch.cuda.device(r.device):
        _check("wkv6", _kernel("wkv6")(
            r.data_ptr(), k.data_ptr(), v.data_ptr(), logw.data_ptr(),
            u.data_ptr(), s0, o.data_ptr(), state.data_ptr(),
            ctypes.addressof(strides), B, S, H, hd,
            int(r.dtype == torch.bfloat16),
            torch.cuda.current_stream().cuda_stream))
    LAUNCHES["wkv6"] += 1
    return o, state


def pairwise_sqdist(xq, xm):
    """Squared Euclidean distances by the expansion ``||q||^2 + ||m||^2 -
    2 q.m``, clamped at 0: xq (Q, F), xm (M, F) float32 -> (Q, M)
    float32.  The card takes contiguous inputs of any Q, M and F >= 1; the
    reference's padding of Q, M and F to its tiles has no counterpart (the
    kernel masks its ragged tiles).
    """
    if xq.dim() != 2 or xm.dim() != 2 or xq.shape[1] != xm.shape[1]:
        raise ValueError(f"xq {tuple(xq.shape)}, xm {tuple(xm.shape)}: want "
                         f"(Q, F) and (M, F)")
    f32 = torch.float32
    if not _on_card("pairwise_sqdist", {"xq": xq, "xm": xm},
                    {"xq": f32, "xm": f32}):
        return ref.pairwise_sqdist_ref(xq, xm)
    (Q, F), M = xq.shape, xm.shape[0]
    d2 = torch.empty((Q, M), dtype=f32, device=xq.device)
    if d2.numel() == 0 or F == 0:
        return d2.zero_()
    with torch.cuda.device(xq.device):
        _check("pairwise_sqdist", _kernel("pairwise_sqdist")(
            xq.data_ptr(), xm.data_ptr(), d2.data_ptr(), Q, M, F,
            torch.cuda.current_stream().cuda_stream))
    LAUNCHES["pairwise_sqdist"] += 1
    return d2


#: The most axes :func:`anneal_walk`'s kernel takes (a sizing space has
#: two a tier).
WALK_MAX_DIM = 32
#: The H100's opt-in shared memory a block (227 KB), and its SMs.
H100_SMEM, H100_SMS = 232_448, 132
#: A time-indexed table is staged a window at a time only while a lane's
#: share of one step's rows is at most this many floats (a chain looks up
#: two entries a step; a window copies whole rows): a per-chain row of 16,
#: a shared row of 512.
WALK_STAGE_ROW_MAX = 16


@dataclasses.dataclass(frozen=True)
class WalkPlan:
    """How :func:`anneal_walk`'s kernel runs a call, a block of one warp
    (32 chains) at a time: windows of ``window`` steps, lookups ``staged``
    in shared memory or not, and ``smem`` bytes of dynamic shared memory
    a block."""
    window: int
    staged: bool
    smem: int


def _a16(n: int) -> int:
    return (n + 15) // 16 * 16


def walk_smem(window: int, staged: bool, ndim: int, size: int, *,
              per_chain: bool, dynamic: bool, extra: bool, valid: bool,
              noisy: bool) -> int:
    """Dynamic shared memory of one block of :func:`anneal_walk`'s kernel
    (its ``layout`` in ``anneal_walk.cu``): the space (size, stride and
    packed field of each axis, 512 B), a staged static shared table and
    valid mask (or a one-byte dummy); then two windows of draws
    (a row of W elements and 16 bytes a chain in each of 5 arrays, 6 when
    noisy: axis and pick int64, up bool, uniform, tau and noise float32),
    two windows of a staged time-indexed table, staged per-chain rows,
    staged extra rows (or a -0 dummy), and the output tiles (a state, an
    objective and a flag a step and lane: the state a flat int32 index on
    one axis, else packed coordinates in 8 bytes)."""
    W = window
    n = 512
    if staged and not per_chain and not dynamic:
        n += _a16(4 * size)
    if staged:                  # the mask, or a one-byte dummy
        n += _a16(size + 8) if valid else 16
    n += 2 * 32 * sum(W * esz + 16 for esz in
                      (8, 1, 8, 4, 4, 4)[:6 if noisy else 5])
    if staged and dynamic:
        n += 2 * _a16(4 * (32 if per_chain else 1) * W * size)
    if staged and per_chain and not dynamic:
        n += _a16(4 * 32 * size)
    if staged:                  # the extra rows, or a -0 dummy
        n += _a16(4 * 32 * size) if extra else 16
    n += (8 if ndim > 1 else 4) * W * 33 + 4 * W * 33 + 36 * W
    return _a16(n)


def walk_plan(C: int, S: int, ndim: int, size: int, *, per_chain: bool,
              dynamic: bool, extra: bool, valid: bool, noisy: bool,
              smem_limit: int = H100_SMEM, sms: int = H100_SMS) -> WalkPlan:
    """The launch plan of one :func:`anneal_walk` call on the card.

    Lookups are staged in shared memory when the table (with its extra
    rows and mask) fits beside the rest, a time-indexed one only while
    its rows are small (:data:`WALK_STAGE_ROW_MAX`); otherwise they read
    device memory.  The window is 64 steps where S and the shared memory
    allow and the blocks (32 chains each) fit on the ``sms`` SMs one each;
    past that 32, whose smaller blocks sit several to an SM.  Raises when
    even the smallest block exceeds ``smem_limit``."""
    if C < 1 or S < 1 or ndim < 1 or size < 1:
        raise ValueError(f"walk_plan: C {C}, S {S}, ndim {ndim}, size "
                         f"{size}: each must be >= 1")
    kw = dict(per_chain=per_chain, dynamic=dynamic, extra=extra,
              valid=valid, noisy=noisy)
    stageable = not dynamic or size <= (
        WALK_STAGE_ROW_MAX if per_chain else 32 * WALK_STAGE_ROW_MAX)
    long_window = S > 32 and -(-C // 32) <= sms
    for staged in ((True, False) if stageable else (False,)):
        for window in ((64, 32) if long_window else (32,)):
            smem = walk_smem(window, staged, ndim, size, **kw)
            if smem <= smem_limit:
                return WalkPlan(window, staged, smem)
    raise ValueError(f"anneal_walk kernel: {ndim} axes need "
                     f"{walk_smem(32, False, ndim, size, **kw)} bytes of "
                     f"shared memory a block, more than {smem_limit}")


def _card_limits(dev: torch.device) -> tuple[int, int]:
    """(opt-in shared memory a block, SMs) of one card."""
    props = torch.cuda.get_device_properties(dev)
    return (getattr(props, "shared_memory_per_block_optin", H100_SMEM),
            props.multi_processor_count)


def anneal_walk(inits, table, taus, axis, up, pick, uniform, *, shape,
                categorical, dynamic: bool = False, per_chain: bool = False,
                extra=None, valid=None, noise=None, noise0=None,
                noise_std: float = 0.0):
    """C annealing chains walked S steps over a tabulated objective, in
    one launch: ``(states (C, S, ndim) int32, ys (C, S) float32, accepts
    (C, S) bool)``.  The arguments are :func:`.ref.anneal_walk_ref`'s:
    ``inits`` (C, ndim) int32; ``table`` float32 ``(C,)? + (S,)? +
    (size,)`` with ``per_chain`` and ``dynamic``; ``taus`` (C, S) float32;
    the draws ``axis``, ``pick``
    (C, S) int64, ``up`` (C, S) bool, ``uniform`` (C, S) float32; ``extra``
    (C, size) float32 or None; ``valid`` (size,) bool or None; ``noise``
    (C, S) and ``noise0`` (C,) float32 when ``noise_std > 0``.  On the card
    the space has at most :data:`WALK_MAX_DIM` axes; the result is bit-equal
    to the plain version's.
    """
    C, S = axis.shape
    ndim = len(shape)
    size = 1
    for n in shape:
        size *= int(n)
    if len(categorical) != ndim:
        raise ValueError(f"categorical has {len(categorical)} axes, shape "
                         f"{ndim}")
    want = ((C,) if per_chain else ()) + ((S,) if dynamic else ()) + (size,)
    if tuple(table.shape) != want:
        raise ValueError(f"table shape {tuple(table.shape)} != {want}")
    if tuple(inits.shape) != (C, ndim):
        raise ValueError(f"inits shape {tuple(inits.shape)} != {(C, ndim)}")
    for arg, x in (("taus", taus), ("up", up), ("pick", pick),
                   ("uniform", uniform)):
        if tuple(x.shape) != (C, S):
            raise ValueError(f"{arg} shape {tuple(x.shape)} != {(C, S)}")
    if extra is not None and tuple(extra.shape) != (C, size):
        raise ValueError(f"extra shape {tuple(extra.shape)} != {(C, size)}")
    if valid is not None and tuple(valid.shape) != (size,):
        raise ValueError(f"valid shape {tuple(valid.shape)} != {(size,)}")
    noisy = noise_std > 0.0
    if noisy and (noise is None or noise0 is None
                  or tuple(noise.shape) != (C, S)
                  or tuple(noise0.shape) != (C,)):
        raise ValueError("noise_std > 0 needs noise (C, S) and noise0 (C,)")
    args = {"inits": inits, "table": table, "taus": taus, "axis": axis,
            "up": up, "pick": pick, "uniform": uniform}
    types = {"inits": torch.int32, "table": torch.float32,
             "taus": torch.float32,
             "axis": torch.int64, "up": torch.bool, "pick": torch.int64,
             "uniform": torch.float32, "extra": torch.float32,
             "valid": torch.bool, "noise": torch.float32,
             "noise0": torch.float32}
    for arg, x in (("extra", extra), ("valid", valid)) + (
            (("noise", noise), ("noise0", noise0)) if noisy else ()):
        if x is not None:
            args[arg] = x
    on_card = _on_card("anneal_walk", args, types)
    if not on_card:
        return ref.anneal_walk_ref(
            inits, table, taus, axis, up, pick, uniform, shape=shape,
            categorical=categorical, dynamic=dynamic, per_chain=per_chain,
            extra=extra, valid=valid, noise=noise, noise0=noise0,
            noise_std=noise_std)
    if ndim > WALK_MAX_DIM:
        raise ValueError(f"anneal_walk kernel takes at most {WALK_MAX_DIM} "
                         f"axes, got {ndim}")
    if size >= 2 ** 31:
        raise ValueError(f"anneal_walk kernel takes fewer than 2^31 states, "
                         f"got {size}")
    dev = axis.device
    states = torch.empty((C, S, ndim), dtype=torch.int32, device=dev)
    ys = torch.empty((C, S), dtype=torch.float32, device=dev)
    accepts = torch.empty((C, S), dtype=torch.bool, device=dev)
    if C == 0 or S == 0:
        return states, ys, accepts
    strides = [1] * ndim
    for d in range(ndim - 2, -1, -1):
        strides[d] = strides[d + 1] * int(shape[d + 1])
    tab_time = size if dynamic else 0
    tab_chain = (S * size if dynamic else size) if per_chain else 0

    def ptr(x):
        return None if x is None else x.data_ptr()

    smem_limit, sms = _card_limits(dev)
    plan = walk_plan(C, S, ndim, size, per_chain=per_chain, dynamic=dynamic,
                     extra=extra is not None, valid=valid is not None,
                     noisy=noisy, smem_limit=smem_limit, sms=sms)
    with torch.cuda.device(dev):
        _check("anneal_walk", _walk_set_plan()(
            plan.window, int(plan.staged), plan.smem))
        _check("anneal_walk", _kernel("anneal_walk")(
            inits.data_ptr(), table.data_ptr(), tab_chain, tab_time,
            taus.data_ptr(), axis.data_ptr(), up.data_ptr(), pick.data_ptr(),
            uniform.data_ptr(), ptr(extra), size, ptr(valid),
            ptr(noise) if noisy else None, ptr(noise0) if noisy else None,
            float(noise_std), C, S, ndim,
            (ctypes.c_int * ndim)(*map(int, shape)),
            (ctypes.c_longlong * ndim)(*strides),
            (ctypes.c_uint8 * ndim)(*map(bool, categorical)),
            states.data_ptr(), ys.data_ptr(), accepts.data_ptr(),
            torch.cuda.current_stream().cuda_stream))
    LAUNCHES["anneal_walk"] += 1
    return states, ys, accepts

