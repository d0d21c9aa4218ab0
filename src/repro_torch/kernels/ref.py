"""Plain PyTorch versions of the hand kernels (the allclose ground truth).

Each function repeats its kernel's arithmetic in float32 with ordinary
tensor ops.  :mod:`repro_torch.kernels.ops` runs these for tensors on the
CPU; on the card it launches the kernels, and the tests and
``chip_smoke.py`` hold each kernel against the function here.
"""

from __future__ import annotations

import torch

#: The model's mask value for refused scores (models/attention.py).
NEG_INF = -2.0e30

#: Masked-out adjacency entries take this value inside the max-relaxation;
#: any real path latency dominates it, and rows with no children fall back
#: to 0 through the outer maximum.
NEG = -1e30


def pairwise_sqdist_ref(xq: torch.Tensor, xm: torch.Tensor) -> torch.Tensor:
    """xq (Q, F), xm (M, F) -> (Q, M) squared Euclidean distances by the
    expansion ``||q||^2 + ||m||^2 - 2 q.m``, clamped at 0."""
    xq = xq.to(torch.float32)
    xm = xm.to(torch.float32)
    qq = (xq * xq).sum(dim=1, keepdim=True)
    mm = (xm * xm).sum(dim=1, keepdim=True)
    return torch.clamp(qq + mm.T - 2.0 * (xq @ xm.T), min=0.0)


def fused_interp_ref(xq, xm, y, w_rec, *, kind: str = "idw",
                     length_scale: float = 0.25, idw_power: float = 2.0,
                     eps: float = 1e-9):
    """Surrogate refit: distance + recency-weighted IDW/RBF reduction.

    xq (Q, F), xm (M, F), y (M,), w_rec (M,) -> (mean (Q,), dmin (Q,)),
    float32.  ``mean`` is the kernel-weighted estimate with the
    recency-weighted global mean as the far-field fallback (taken when the
    weight sum is <= 1e-12); ``dmin`` the distance to the nearest
    measurement.
    """
    d2 = pairwise_sqdist_ref(xq, xm)                        # (Q, M)
    if kind == "rbf":
        k = torch.exp(-d2 / (2.0 * length_scale ** 2))
    else:                                                   # "idw" (Shepard)
        half = idw_power / 2.0
        k = 1.0 / ((d2 if half == 1.0 else d2 ** half) + eps)
    y32 = y.to(torch.float32)
    w32 = w_rec.to(torch.float32)
    k = k * w32[None, :]
    wsum = k.sum(dim=1)
    fallback = (y32 * w32).sum() / torch.clamp(w32.sum(), min=1e-12)
    mean = torch.where(wsum > 1e-12,
                       (k @ y32) / torch.clamp(wsum, min=1e-12), fallback)
    dmin = torch.sqrt(d2.min(dim=1).values)
    return mean, dmin


def sizing_latency_ref(lam, mu, repl, visit_w, adj, *, c_max: int,
                       sat_s: float = 1e4):
    """M/M/c sojourns + DAG critical path.

    lam/mu/repl/visit_w (B, K) -> (sojourn (B, K), path (B, K)), float32.
    Erlang C through the in-[0, 1] Erlang-B recurrence run to ``c_max``,
    picking ``B_c`` where ``repl == k`` exactly; unstable cells
    (``repl * mu - lam <= 1e-9``) saturate to ``sat_s``; ``path[:, v]`` is
    the heaviest visit-weighted path of the sub-DAG rooted at v, from K
    Jacobi steps of ``L[v] = w[v] T[v] + max(0, max_{adj[v, u]} L[u])``.
    """
    lam = lam.to(torch.float32)
    mu = mu.to(torch.float32)
    c = repl.to(torch.float32)
    w = visit_w.to(torch.float32)
    a = lam / mu
    b = torch.ones_like(a)
    b_c = torch.zeros_like(a)
    for k in range(1, int(c_max) + 1):
        ab = a * b
        b = ab / (k + ab)
        b_c = torch.where(c == k, b, b_c)
    rho = a / torch.clamp(c, min=1.0)
    p_wait = b_c / torch.clamp(1.0 - rho * (1.0 - b_c), min=1e-12)
    slack = c * mu - lam
    soj = torch.where(slack > 1e-9,
                      p_wait / torch.clamp(slack, min=1e-12) + 1.0 / mu,
                      torch.full_like(a, float(sat_s)))
    node = w * soj
    edges = adj.to(torch.bool)
    latency = node
    for _ in range(lam.shape[1]):
        masked = torch.where(edges[None, :, :], latency[:, None, :],
                             torch.full((), NEG, dtype=torch.float32,
                                        device=lam.device))
        latency = node + torch.clamp(masked.max(dim=2).values, min=0.0)
    return soj, latency


def attention_mask(kind: str, window: int, s_q: int, s_k: int,
                   q_offset: int = 0, device=None) -> torch.Tensor:
    """(s_q, s_k) bool, True where query ``q_offset + i`` may see key j:
    causal ``j <= i``; window also ``j > i - window``; chunk also the same
    ``window``-sized chunk; bidir and cross everything."""
    qi = torch.arange(s_q, device=device)[:, None] + q_offset
    kj = torch.arange(s_k, device=device)[None, :]
    if kind in ("bidir", "cross"):
        return torch.ones((s_q, s_k), dtype=torch.bool, device=device)
    m = kj <= qi
    if kind == "window" and window > 0:
        m = m & (kj > qi - window)
    elif kind == "chunk" and window > 0:
        m = m & ((qi // window) == (kj // window))
    return m


def _product(eq: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``einsum(eq, a, b)`` summed in float32 and rounded once to ``a``'s
    type, as the model's jnp products are."""
    return torch.einsum(eq, a.float(), b.float()).to(a.dtype)


def _score_divisor(hd: int, device) -> torch.Tensor:
    return torch.sqrt(torch.tensor(float(hd), dtype=torch.float32,
                                   device=device))


def flash_attention_ref(q, k, v, *, kind: str = "causal", window: int = 0,
                        softcap: float = 0.0, q_chunk: int = 1024):
    """Masked GQA attention in the model layout: q (B, Sq, H, hd), k/v
    (B, Sk, K, hd) with H % K == 0 -> (B, Sq, H, hd); query head h reads kv
    head h // (H / K).

    The arithmetic of the model's full-score path (``_attend_dense`` of
    the reference package's models/attention.py, which its ``ref.py``
    oracle also runs): scores are products in the input type, then float32, over
    sqrt(hd), plus -2e30 where the mask refuses; the softcap (if any) is
    applied after the mask, then a float32 softmax whose weights are cast
    back to the input type for the product with v.  Products are summed
    in float32 and rounded once to the input type.  For float32 inputs no
    rounding happens.  Query rows go through in chunks of ``q_chunk``
    (each row's result is independent of the chunking), so the score
    buffer stays (B, H, q_chunk, Sk).
    """
    B, Sq, H, hd = q.shape
    K, Sk = k.shape[2], k.shape[1]
    G = H // K
    qg = q.reshape(B, Sq, K, G, hd)
    div = _score_divisor(hd, q.device)
    outs = []
    for i0 in range(0, Sq, q_chunk):
        qc = qg[:, i0:i0 + q_chunk]
        n = qc.shape[1]
        scores = _product("bqkgd,bskd->bkgqs", qc, k).float() / div
        bias = torch.where(
            attention_mask(kind, window, n, Sk, i0, q.device),
            torch.zeros((), device=q.device), torch.full(
                (), NEG_INF, device=q.device)).float()
        scores = scores + bias
        if softcap > 0.0:
            scores = softcap * torch.tanh(scores / softcap)
        w = torch.softmax(scores, dim=-1).to(q.dtype)
        outs.append(_product("bkgqs,bskd->bqkgd", w, v)
                    .reshape(B, n, H, hd))
    return torch.cat(outs, dim=1) if len(outs) > 1 else outs[0]


def flash_attention_stats_ref(q, k, *, kind: str = "causal", window: int = 0,
                              softcap: float = 0.0):
    """The row statistics the flash-attention kernel writes for the
    backward: q (B, Sq, H, hd), k (B, Sk, K, hd) -> (m, l), each
    (B, H, Sq) float32, with m_i the largest admitted score of row i and
    l_i = sum_j exp(s_ij - m_i) over the admitted keys.  Scores as in
    :func:`flash_attention_ref` (products rounded to the input type, over
    sqrt(hd)); with a softcap the tanh comes before the mask, as in the
    kernel.  A row with no admitted key has m = -inf and l = 0 here (the
    kernel writes a large negative m there)."""
    B, Sq, H, hd = q.shape
    K, Sk = k.shape[2], k.shape[1]
    qg = q.reshape(B, Sq, K, H // K, hd)
    scores = _product("bqkgd,bskd->bkgqs", qg, k).float() \
        / _score_divisor(hd, q.device)
    if softcap > 0.0:
        scores = softcap * torch.tanh(scores / softcap)
    scores = scores.masked_fill(
        ~attention_mask(kind, window, Sq, Sk, 0, q.device), float("-inf"))
    m = scores.amax(dim=-1)
    l = torch.exp(scores - m[..., None]).nan_to_num(0.0).sum(dim=-1)
    return m.reshape(B, H, Sq), l.reshape(B, H, Sq)


def flash_attention_bwd_ref(q, k, v, dout, *, kind: str = "causal",
                            window: int = 0, softcap: float = 0.0):
    """The gradient of :func:`flash_attention_ref`: (dq, dk, dv) for the
    output gradient ``dout`` (B, Sq, H, hd), in the inputs' types, by
    autograd through the forward (the reference's ``_fat_bwd``, the vjp of
    the model's attention, at its rounding points: the float32 softmax
    backward of the bf16 weights' gradient, the score gradient rounded to
    the input type before its two products, each product summed in float32
    and rounded once)."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
        out = flash_attention_ref(*leaves, kind=kind, window=window,
                                  softcap=softcap)
        return torch.autograd.grad(out, leaves, dout)


def quantize_int8_ref(x: torch.Tensor):
    """x (..., N) -> (q int8 (..., N), scale float32 (..., 1)): the row-wise
    absmax scale ``max(amax, 1e-12) / 127`` and ``clip(round(x / scale),
    -127, 127)``, rounding half to even (the reference's jnp
    ``optim/compression.py`` ``quantize_int8``).  Both divisions are
    tensor by tensor, so they are IEEE divisions on the card too (PyTorch
    multiplies by the reciprocal of a Python scalar divisor there)."""
    xf = x.float()
    amax = xf.abs().amax(dim=-1, keepdim=True)
    scale = torch.clamp(amax, min=1e-12) / torch.full(
        (), 127.0, dtype=torch.float32, device=x.device)
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


def flash_decode_ref(q, k_cache, v_cache, valid_mask, *,
                     softcap: float = 0.0):
    """One query token per sequence against a masked cache, in the model
    layout: q (B, 1, H, hd), caches (B, W, K, hd), valid (B, W) bool ->
    (B, 1, H, hd).

    The arithmetic of the model's ``decode_attend`` (models/attention.py):
    scores are products in the input type, then float32, over sqrt(hd),
    softcapped, set to -2e30 at invalid slots, a float32 softmax, weights
    cast back to the input type for the product with v.  For float32
    inputs this is the reference package's ``flash_decode_ref``.
    """
    B, _, H, hd = q.shape
    K = k_cache.shape[2]
    G = H // K
    qg = q.reshape(B, K, G, hd)
    scores = _product("bkgd,bskd->bkgs", qg, k_cache).float() \
        / _score_divisor(hd, q.device)
    if softcap > 0.0:
        scores = softcap * torch.tanh(scores / softcap)
    scores = torch.where(valid_mask[:, None, None, :], scores,
                         torch.full((), NEG_INF, device=q.device))
    w = torch.softmax(scores, dim=-1).to(q.dtype)
    out = _product("bkgs,bskd->bkgd", w, v_cache)
    return out.reshape(B, 1, H, hd)
