"""Plain PyTorch versions of the hand kernels (the allclose ground truth).

Each function repeats its kernel's arithmetic in float32 with ordinary
tensor ops.  :mod:`repro_torch.kernels.ops` runs these for tensors on the
CPU; on the card it launches the kernels, and the tests and
``chip_smoke.py`` hold each kernel against the function here.
"""

from __future__ import annotations

import torch

from ..core.neighborhood import propose_nd

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


def rglru_scan_ref(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """h_t = a_t * h_{t-1} + b_t from h_{-1} = 0: a, b (B, S, R) -> h
    (B, S, R) in a's type.  A sequential float32 loop, one multiply and one
    add per step, each rounded: the recurrence the reference's Pallas
    kernel runs (``rglru_scan.py`` ``_rglru_kernel``).  (The reference's
    own oracle, ``ref.rglru_scan_ref``, and its model take an associative
    scan, which sums in another order.)"""
    af, bf = a.float(), b.float()
    out = torch.empty_like(af)
    h = torch.zeros_like(af[:, 0])
    for t in range(af.shape[1]):
        h = af[:, t] * h + bf[:, t]
        out[:, t] = h
    return out.to(a.dtype)


def wkv6_chunked_ref(r, k, v, logw, u, chunk: int,
                     initial_state: torch.Tensor | None = None):
    """The RWKV-6 wkv recurrence in the model's chunked form (the
    reference's ``models/rwkv6.py`` ``wkv6_chunked`` with
    ``return_state=True``): r, k, v (B, S, H, hd), logw (B, S, H, hd)
    float32, u (H, hd), the state (B, H, hd, hd) float32 it starts from
    (0 if None) -> (o (B, S, H, hd) float32, final state).  S must be a
    multiple of ``chunk``.

    Within a chunk of L steps, with A_t = exp(cum_{s<=t} logw_s) on the key
    dimension, the intra-chunk part is two dense products in log-decay
    space (``exp(-cum)`` clipped at e^75, where the matching
    ``exp(cum_{t-1})`` underflows to 0) plus the bonus diagonal; the state
    is carried from chunk to chunk."""
    B, S, H, hd = r.shape
    L = chunk
    n = S // L
    rf, kf, vf = (t.float().reshape(B, n, L, H, hd) for t in (r, k, v))
    lw = logw.float().reshape(B, n, L, H, hd)
    uf = u.float()
    cum = torch.cumsum(lw, dim=2)                 # A_t = exp(cum_t)
    total = cum[:, :, -1:]                        # (B, n, 1, H, hd)
    a_prev = torch.exp(cum - lw)                  # A_{t-1}
    k_scaled = kf * torch.exp(total - cum)        # A_L / A_t applied
    k_rel = kf * torch.exp(torch.clamp(-cum, max=75.0))
    q_dec = rf * a_prev
    att = torch.einsum("bnthk,bnshk->bnhts", q_dec, k_rel)
    idx = torch.arange(L, device=r.device)
    att = torch.where((idx[None, :] < idx[:, None]), att,
                      torch.zeros((), device=r.device))
    diag = torch.einsum("bnthk,hk,bnthk->bnth", rf, uf, kf)
    o = torch.einsum("bnhts,bnshk->bnthk", att, vf) + diag[..., None] * vf
    state = (torch.zeros((B, H, hd, hd), dtype=torch.float32,
                         device=r.device)
             if initial_state is None else initial_state.float())
    inter = []
    for c in range(n):
        inter.append(torch.einsum("bthk,bhkv->bthv", q_dec[:, c], state))
        decay = torch.exp(total[:, c])[:, 0]      # (B, H, hd)
        state = decay[..., None] * state + torch.einsum(
            "bshk,bshv->bhkv", k_scaled[:, c], vf[:, c])
    o = o + torch.stack(inter, dim=1)
    return o.reshape(B, S, H, hd), state


def wkv6_ref(r, k, v, logw, u, initial_state: torch.Tensor | None = None):
    """The RWKV-6 wkv recurrence step by step (the reference's sequential
    oracle ``ref.wkv6_ref``, in the model's (B, S, H, hd) layout, with an
    initial state and the final state returned): per step
    ``o_t = r_t (S + u k_t v_t^T)`` and ``S = diag(exp(logw_t)) S +
    k_t v_t^T``, in float32.  Returns (o (B, S, H, hd), final state
    (B, H, hd, hd))."""
    B, S, H, hd = r.shape
    rf, kf, vf, lwf = (t.float() for t in (r, k, v, logw))
    uf = u.float()
    state = (torch.zeros((B, H, hd, hd), dtype=torch.float32,
                         device=r.device)
             if initial_state is None else initial_state.float())
    outs = []
    for t in range(S):
        kv = torch.einsum("bhk,bhv->bhkv", kf[:, t], vf[:, t])
        outs.append(torch.einsum("bhk,bhkv->bhv", rf[:, t],
                                 state + uf[None, :, :, None] * kv))
        state = torch.exp(lwf[:, t])[..., None] * state + kv
    return torch.stack(outs, dim=1), state


def anneal_walk_ref(inits, table, taus, axis, up, pick, uniform, *,
                    shape, categorical, dynamic: bool = False,
                    per_chain: bool = False, extra=None, valid=None,
                    noise=None, noise0=None, noise_std: float = 0.0):
    """C annealing chains walked S steps over a tabulated objective, one
    vectorised step at a time.

    ``inits`` (C, ndim) int; ``table`` float32 of shape ``(C,)? + (S,)? +
    (size,)`` (a leading chain axis with ``per_chain``, a time axis with
    ``dynamic``) over the row-major flattening of ``shape``; ``taus`` (C,
    S) float32; ``axis``, ``up``, ``pick``, ``uniform`` (C, S) the drawn
    axis, direction, categorical pick and acceptance uniform;
    ``categorical`` (ndim,) bools; ``extra`` (C, size) additive cost rows
    or None; ``valid`` (size,) bool or None; ``noise`` (C, S) and
    ``noise0`` (C,) standard normals, read when ``noise_std > 0``.

    A step proposes (:func:`repro_torch.core.neighborhood.propose_nd`),
    looks the proposal up (plus its extra cost and ``noise_std`` times its
    normal), and accepts when the uniform is below ``exp(-max(dy, 0) /
    tau)`` and the proposal is valid.
    Returns ``(states (C, S, ndim) int32, ys (C, S) float32, accepts (C,
    S) bool)``: the state after each step, the proposal's objective and
    the accept flag.
    """
    C, S = axis.shape
    dev = axis.device
    ndim = len(shape)
    noisy = noise_std > 0.0
    strides = [1] * ndim
    for d in range(ndim - 2, -1, -1):
        strides[d] = strides[d + 1] * int(shape[d + 1])
    strides = torch.tensor(strides, dtype=torch.int64, device=dev)
    sizes = torch.tensor(shape, dtype=torch.int64, device=dev)
    cat = torch.tensor(categorical, dtype=torch.bool, device=dev)
    rows = torch.arange(C, device=dev)

    def lookup(t, zi):
        y_now = table[:, t] if (dynamic and per_chain) else (
            table[t] if dynamic else table)
        v = y_now[rows, zi] if per_chain else y_now[zi]
        if extra is not None:
            v = v + extra[rows, zi]
        return v

    x = inits.to(torch.int64)
    y_x = lookup(0, (x * strides).sum(-1))
    if noisy:
        y_x = y_x + noise_std * noise0
    states = torch.empty((C, S, ndim), dtype=torch.int32, device=dev)
    ys = torch.empty((C, S), dtype=torch.float32, device=dev)
    accepts = torch.empty((C, S), dtype=torch.bool, device=dev)
    for t in range(S):
        z = propose_nd(x, axis[:, t], up[:, t], pick[:, t], sizes, cat)
        zi = (z * strides).sum(-1)
        y_z = lookup(t, zi)
        if noisy:
            y_z = y_z + noise_std * noise[:, t]
        dy = y_z - y_x
        p = torch.exp(-torch.clamp(dy, min=0.0) / taus[:, t])
        acc = uniform[:, t] < p
        if valid is not None:
            acc = acc & valid[zi]
        x = torch.where(acc[:, None], z, x)
        y_x = torch.where(acc, y_z, y_x)
        states[:, t] = x
        ys[:, t] = y_z
        accepts[:, t] = acc
    return states, ys, accepts
