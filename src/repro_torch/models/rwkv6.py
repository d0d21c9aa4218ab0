"""RWKV-6 "Finch" (arXiv:2404.05892): data-dependent-decay linear attention.

The counterpart of the reference package's ``models/rwkv6.py``.  Time-mix
recurrence per head (state S in R^{hd x hd}):

    S_t = diag(w_t) S_{t-1} + k_t v_t^T
    o_t = r_t^T (diag(u) k_t v_t^T + S_{t-1})

with per-channel decays w_t = exp(-exp(wlog_t)) made data-dependent by a
LoRA, bonus u and receptance r; token shift mixes x_t with x_{t-1} through
learned static weights mu (the reference's simplification).  Channel mix
is the squared-relu FFN with token shift.

The prefill runs the recurrence through
:func:`repro_torch.kernels.ops.wkv6` (the hand kernel on the card, the
model's chunked form on the CPU) and keeps its final state for the decode
steps; the one-step decode update is plain torch, as in the reference.
Operations round to the activations' type (bf16) where the reference's
jnp operations do, and run in float32 where it casts.
"""

from __future__ import annotations

import dataclasses

import torch

from ..kernels import ops
from .common import (
    NamedWeights,
    fanin_init,
    matmul,
    normal_init,
    ones_init,
    sigmoid,
    silu,
)


@dataclasses.dataclass(frozen=True)
class RWKV6Spec:
    d_model: int
    head_dim: int = 64
    d_ff: int = 14336
    decay_lora: int = 64
    chunk: int = 32

    @property
    def n_heads(self) -> int:
        return self.d_model // self.head_dim


class RWKVTime(NamedWeights):
    """Time mix in the reference's layout: mu_r/k/v/w (D,) bf16; w_r,
    w_k, w_v, w_g (D, H, hd); w_o (H, hd, D); the decay LoRA w_dec1 (D, L)
    and w_dec2 (L, H, hd); dec_bias, u and ln_out (H, hd) float32."""

    NAMES = ("mu_r", "mu_k", "mu_v", "mu_w", "w_r", "w_k", "w_v", "w_g",
             "w_o", "w_dec1", "w_dec2", "dec_bias", "u", "ln_out")


class RWKVChannel(NamedWeights):
    """Channel mix: mu_k, mu_r (D,) bf16; w_k (D, F), w_v (F, D), w_r
    (D, D)."""

    NAMES = ("mu_k", "mu_r", "w_k", "w_v", "w_r")


def init_rwkv_time(gen: torch.Generator, spec: RWKV6Spec) -> RWKVTime:
    D, H, hd, L = spec.d_model, spec.n_heads, spec.head_dim, spec.decay_lora
    dev = gen.device
    mu = {f"mu_{s}": ones_init((D,), dev, torch.bfloat16) for s in "rkvw"}
    proj = {f"w_{s}": fanin_init(gen, (D, H, hd), fan_in=D) for s in "rkvg"}
    return RWKVTime(
        **mu, **proj,
        w_o=fanin_init(gen, (H, hd, D), fan_in=H * hd),
        w_dec1=fanin_init(gen, (D, L), fan_in=D),
        w_dec2=fanin_init(gen, (L, H, hd), fan_in=L),
        dec_bias=torch.full((H, hd), -4.0, dtype=torch.float32, device=dev),
        u=normal_init(gen, (H, hd), stddev=0.3, dtype=torch.float32),
        ln_out=ones_init((H, hd), dev))


def init_rwkv_channel(gen: torch.Generator, spec: RWKV6Spec) -> RWKVChannel:
    D, F = spec.d_model, spec.d_ff
    dev = gen.device
    return RWKVChannel(
        mu_k=ones_init((D,), dev, torch.bfloat16),
        mu_r=ones_init((D,), dev, torch.bfloat16),
        w_k=fanin_init(gen, (D, F), fan_in=D),
        w_v=fanin_init(gen, (F, D), fan_in=F),
        w_r=fanin_init(gen, (D, D), fan_in=D))


def _token_shift(x):
    """x (B, S, D) -> the previous token's features (zeros at t = 0)."""
    return torch.nn.functional.pad(x, (0, 0, 1, 0))[:, :-1]


def _mix(x, prev, mu):
    """``x * mu + prev * (1 - mu)``, each step in x's type."""
    return x * mu + prev * (1.0 - mu.to(x.dtype))


def _heads(x, w):
    """x (B, S, D) @ w (D, H, hd) -> (B, S, H, hd)."""
    D, H, hd = w.shape
    return matmul(x, w.reshape(D, H * hd)).reshape(*x.shape[:-1], H, hd)


def _time_projections(params: RWKVTime, x, prev):
    """Shared by prefill and decode: r, k, v, g (B, S, H, hd) in x's type
    and logw (B, S, H, hd) float32, the per-step log decay -exp(wlog)."""
    r = _heads(_mix(x, prev, params.mu_r), params.w_r)
    k = _heads(_mix(x, prev, params.mu_k), params.w_k)
    v = _heads(_mix(x, prev, params.mu_v), params.w_v)
    xw = _mix(x, prev, params.mu_w)
    g = _heads(xw, params.w_g)
    lora = torch.tanh(xw.float() @ params.w_dec1.float())
    L, H, hd = params.w_dec2.shape
    wlog = (lora @ params.w_dec2.float().reshape(L, H * hd)) \
        .reshape(*lora.shape[:-1], H, hd) + params.dec_bias
    return r, k, v, g, -torch.exp(wlog)


def _group_norm_heads(x, scale):
    """Per-head RMS normalization of the wkv output, float32."""
    xf = x.float()
    ms = xf.square().mean(dim=-1, keepdim=True)
    return xf * torch.rsqrt(ms + 1e-5) * scale


def _time_out(params: RWKVTime, o, g, dtype):
    """wkv output o (B, S, H, hd) float32 and gate g -> (B, S, D)."""
    o = _group_norm_heads(o, params.ln_out) * silu(g.float())
    H, hd, D = params.w_o.shape
    return matmul(o.to(dtype).reshape(*o.shape[:-2], H * hd),
                  params.w_o.reshape(H * hd, D))


def rwkv_time_prefill(params: RWKVTime, x, spec: RWKV6Spec):
    """Time-mix forward over a prompt that also returns the decode state.
    x (B, S, D), the block's normed input, S a multiple of the chunk ->
    ((B, S, D), {"S": (B, H, hd, hd) float32, "shift": (B, D) bf16}), the
    shift state being x's last token."""
    S = x.shape[1]
    if S % spec.chunk:
        raise ValueError(f"rwkv prefill needs a prompt of a multiple of "
                         f"{spec.chunk} tokens, got {S}")
    r, k, v, g, logw = _time_projections(params, x, _token_shift(x))
    o, s_final = ops.wkv6(r, k, v, logw, params.u, spec.chunk)
    out = _time_out(params, o, g, x.dtype)
    return out, {"S": s_final, "shift": x[:, -1].to(torch.bfloat16)}


def _channel(params: RWKVChannel, x, prev):
    xk = _mix(x, prev, params.mu_k)
    xr = _mix(x, prev, params.mu_r)
    kk = torch.relu(matmul(xk, params.w_k)).square()
    rr = sigmoid(matmul(xr, params.w_r))
    return (rr * matmul(kk, params.w_v)).to(x.dtype)


def rwkv_channel_prefill(params: RWKVChannel, x):
    """Channel-mix forward over a prompt, and its decode state
    ({"shift": (B, D) bf16})."""
    out = _channel(params, x, _token_shift(x))
    return out, {"shift": x[:, -1].to(torch.bfloat16)}


def rwkv_time_step(params: RWKVTime, x_t, state: dict, spec: RWKV6Spec):
    """One decode step.  x_t (B, D); state {"S": (B, H, hd, hd) float32,
    "shift": (B, D)} -> (out (B, D), new state)."""
    x = x_t[:, None, :]
    prev = state["shift"][:, None, :].to(x.dtype)
    r, k, v, g, logw = _time_projections(params, x, prev)
    r, k, v, logw = r[:, 0], k[:, 0], v[:, 0], logw[:, 0]
    S = state["S"]
    kv = k.float()[..., :, None] * v.float()[..., None, :]
    o = torch.einsum("bhk,bhkv->bhv", r.float(),
                     S + params.u[..., None] * kv)
    S = torch.exp(logw)[..., None] * S + kv
    out = _time_out(params, o[:, None], g, x_t.dtype)[:, 0]
    return out, {"S": S, "shift": x_t}


def rwkv_channel_step(params: RWKVChannel, x_t, state: dict):
    """One decode step of the channel mix; state {"shift": (B, D)}."""
    out = _channel(params, x_t, state["shift"].to(x_t.dtype))
    return out, {"shift": x_t}
