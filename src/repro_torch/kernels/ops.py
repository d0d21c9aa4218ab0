"""Public wrappers around the hand kernels.

Each wrapper checks its inputs, then dispatches on where they lie: tensors
on the CPU go through the plain PyTorch version in :mod:`.ref`; tensors on
a CUDA device launch the hand kernel on PyTorch's current stream, or
raise.  There is no fallback from the card to the plain version.

Every launch adds one to :data:`LAUNCHES` under the kernel's name, so a
run can show that its main path went through the kernels.
"""

from __future__ import annotations

import ctypes

import torch

from . import build, ref

#: Kernel launches since the last :func:`reset_launches`, by kernel name.
LAUNCHES: dict[str, int] = {"sizing_latency": 0, "fused_interp": 0,
                             "flash_attention": 0, "flash_decode": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_SIGNATURES = {
    "sizing_latency": ("sizing_latency_launch",
                       [_P] * 7 + [_I, _I, _I, _F, _P]),
    "fused_interp": ("fused_interp_launch",
                     [_P] * 6 + [_I, _I, _I, _I, _F, _F, _F, _P]),
    "flash_attention": ("flash_attention_launch",
                        [_P] * 5 + [_I] * 9 + [_F, _P]),
    "flash_decode": ("flash_decode_launch",
                     [_P] * 5 + [_I] * 6 + [_F, _I, _P]),
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


def fused_interp(xq, xm, y, w_rec, *, kind: str = "idw",
                 length_scale: float = 0.25, idw_power: float = 2.0,
                 eps: float = 1e-9):
    """Fused surrogate refit: xq (Q, F), xm (M, F), y (M,), w_rec (M,)
    float32 -> (mean (Q,), dmin (Q,)) float32 — the IDW/RBF estimate (the
    recency-weighted global mean as the far-field fallback) and the
    nearest-measurement distance, with no (Q, M) distance matrix in device
    memory.  Rows with zero recency weight contribute nothing to the
    estimate.  On the card F is at most 256.
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
    mean = torch.empty((Q,), dtype=f32, device=xq.device)
    dmin = torch.empty((Q,), dtype=f32, device=xq.device)
    if Q == 0:
        return mean, dmin
    with torch.cuda.device(xq.device):
        _check("fused_interp", _kernel("fused_interp")(
            xq.data_ptr(), xm.data_ptr(), y.data_ptr(), w_rec.data_ptr(),
            mean.data_ptr(), dmin.data_ptr(), Q, M, F, int(kind == "rbf"),
            float(idw_power / 2.0), float(eps),
            float(2.0 * length_scale * length_scale),
            torch.cuda.current_stream().cuda_stream))
    LAUNCHES["fused_interp"] += 1
    return mean, dmin


#: Mask kinds of :func:`flash_attention`, as the kernel numbers them.
ATTENTION_KINDS = {"causal": 0, "window": 1, "chunk": 2, "bidir": 3,
                   "cross": 3}
_ATTN_DTYPES = (torch.float32, torch.bfloat16)


def flash_attention(q, k, v, *, kind: str = "causal", window: int = 0,
                    softcap: float = 0.0):
    """Masked GQA attention in the model layout: q (B, Sq, H, hd), k/v
    (B, Sk, K, hd), H % K == 0 -> (B, Sq, H, hd) in q's type (float32 or
    bfloat16; float32 math, rounded to q's type where the model rounds).
    Query head h reads kv head h // (H / K).  ``kind`` is causal, window,
    chunk (both with ``window``), bidir or cross; ``softcap`` > 0 caps
    scores with tanh.
    Any Sq and Sk; the card reads the inputs through their strides (unit
    stride in the head dim) and takes hd <= 128.

    With a softcap the two paths treat refused keys differently.  The
    plain version (the model's math) adds the -2e30 mask before the tanh,
    so a refused key scores -softcap and keeps weight exp(-softcap - max),
    and a row with no key averages v.  The card's kernel (as the TPU
    kernel) masks after the tanh: refused keys get no weight and a row
    with no key is 0.  They agree wherever the refused keys' weight is
    below the tolerance, as in causal rows, whose diagonal is never
    refused.
    """
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
    if not _on_card("flash_attention", {"q": q, "k": k, "v": v},
                    {"q": _ATTN_DTYPES, "k": _ATTN_DTYPES,
                     "v": _ATTN_DTYPES}, strided=("q", "k", "v")):
        return ref.flash_attention_ref(q, k, v, kind=kind, window=window,
                                       softcap=softcap)
    if not q.dtype == k.dtype == v.dtype:
        raise TypeError(f"flash_attention: q, k, v types differ "
                        f"({q.dtype}, {k.dtype}, {v.dtype})")
    if hd > 128:
        raise ValueError(f"flash_attention kernel takes hd <= 128, got {hd}")
    o = torch.empty((B, Sq, H, hd), dtype=q.dtype, device=q.device)
    if B == 0 or Sq == 0:
        return o
    if Sk == 0:
        raise ValueError("flash_attention needs at least one key")
    strides = (ctypes.c_longlong * 12)(
        *(t.stride(i) for t in (q, k, v, o) for i in range(3)))
    with torch.cuda.device(q.device):
        _check("flash_attention", _kernel("flash_attention")(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            ctypes.addressof(strides), B, H, K, Sq, Sk, hd,
            int(q.dtype == torch.bfloat16), ATTENTION_KINDS[kind],
            int(window), float(softcap),
            torch.cuda.current_stream().cuda_stream))
    LAUNCHES["flash_attention"] += 1
    return o


def flash_decode(q, k_cache, v_cache, valid_mask, *, softcap: float = 0.0):
    """One query token per sequence against a masked KV cache, in the
    model layout: q (B, 1, H, hd), caches (B, W, K, hd), valid (B, W) bool
    -> (B, 1, H, hd) in q's type (float32 or bfloat16; float32 math,
    rounded to q's type where the model rounds).  A sequence with no
    valid slot gets 0 on the card.  The card reads the caches in place; it
    takes hd <= 128 and H / K <= 8.
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
    G = H // K
    if hd > 128 or G > 8:
        raise ValueError(f"flash_decode kernel does not take hd {hd} with "
                         f"{G} query heads per kv head")
    o = torch.empty_like(q)
    if B == 0:
        return o
    if W == 0:
        raise ValueError("flash_decode needs a cache of at least one slot")
    vec_ok = all(t.data_ptr() % 16 == 0 for t in (q, k_cache, v_cache, o))
    with torch.cuda.device(q.device):
        _check("flash_decode", _kernel("flash_decode")(
            q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
            valid_mask.data_ptr(), o.data_ptr(), B, W, K, H, hd,
            int(q.dtype == torch.bfloat16), float(softcap), int(vec_ok),
            torch.cuda.current_stream().cuda_stream))
    LAUNCHES["flash_decode"] += 1
    return o
