"""Griffin/RecurrentGemma recurrent block: temporal conv1d + RG-LRU.

The counterpart of the reference package's ``models/rglru.py``.  The
RG-LRU recurrence (Griffin, arXiv:2402.19427):

    r_t = sigmoid(W_a x_t + b_a)          (recurrence gate)
    i_t = sigmoid(W_x x_t + b_x)          (input gate)
    a_t = exp(c * softplus(Lambda) * (-r_t))   in (0, 1), c = 8
    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)

and the block around it: ``y = W_out(GeLU(W_gate x) * RG-LRU(conv1d(W_rec
x)))``.  The prefill runs the recurrence through
:func:`repro_torch.kernels.ops.rglru_scan` (the hand kernel on the card,
its plain sequential loop on the CPU); the reference's model takes an
associative scan there, the same sums in another order.  Decode is the
one-step update in plain torch, as in the reference.

The gates are float32 products (TF32 off on the card); the rest rounds to
the activations' type (bf16) where the reference's jnp operations do.
"""

from __future__ import annotations

import dataclasses

import torch

from ..kernels import ops
from .common import (
    NamedWeights,
    fanin_init,
    gelu,
    matmul,
    normal_init,
    sigmoid,
    softplus,
    zeros_init,
)

RG_LRU_C = 8.0


@dataclasses.dataclass(frozen=True)
class RGLRUSpec:
    d_model: int
    d_rnn: int            # recurrent width (== d_model for RG-2B)
    conv_width: int = 4


class RGLRU(NamedWeights):
    """The recurrent block's weights in the reference's layout: w_gate,
    w_rec (D, R) and w_out (R, D); the depthwise conv conv_w (W, R) and
    conv_b (R,); the gates wa, wx (R, R) with ba, bx (R,); lam (R,)."""

    NAMES = ("w_gate", "w_rec", "w_out", "conv_w", "conv_b", "wa", "ba",
             "wx", "bx", "lam")


def init_rglru(gen: torch.Generator, spec: RGLRUSpec) -> RGLRU:
    D, R, W = spec.d_model, spec.d_rnn, spec.conv_width
    dev = gen.device
    return RGLRU(
        w_gate=fanin_init(gen, (D, R), fan_in=D),
        w_rec=fanin_init(gen, (D, R), fan_in=D),
        w_out=fanin_init(gen, (R, D), fan_in=R),
        conv_w=normal_init(gen, (W, R), stddev=0.1),
        conv_b=zeros_init((R,), dev),
        wa=fanin_init(gen, (R, R), fan_in=R),
        ba=zeros_init((R,), dev),
        wx=fanin_init(gen, (R, R), fan_in=R),
        bx=zeros_init((R,), dev),
        # Lambda so that a^c is about uniform in (0.9, 0.999) at r = 1
        lam=torch.linspace(2.0, 6.0, R, dtype=torch.float32, device=dev))


def _gates(params: RGLRU, x):
    """x (B, S, R) -> log_a (B, S, R) float32, gated input (B, S, R)
    float32."""
    xf = x.float()
    r = sigmoid(xf @ params.wa.float() + params.ba)
    i = sigmoid(xf @ params.wx.float() + params.bx)
    log_a = -RG_LRU_C * softplus(params.lam) * r              # <= 0
    return log_a, i * xf


def _decay_and_input(params: RGLRU, x):
    """(a, b) of the recurrence h_t = a_t h_{t-1} + b_t, float32: a =
    exp(log_a) and b = sqrt(1 - a^2) * gated input, the square root taken
    stably as exp(0.5 * log1p(-exp(2 log_a) + 1e-12))."""
    log_a, gated = _gates(params, x)
    a = torch.exp(log_a)
    beta = torch.exp(0.5 * torch.log1p(-torch.exp(2.0 * log_a) + 1e-12))
    return a, beta * gated


def rg_lru_scan_with_state(params: RGLRU, x):
    """The recurrence over the sequence through the ``rglru_scan`` kernel.
    x (B, S, R) -> ((B, S, R) outputs in x's type, (B, R) float32 final
    state)."""
    h = ops.rglru_scan(*_decay_and_input(params, x))
    return h.to(x.dtype), h[:, -1]


def rg_lru_step(params: RGLRU, x_t, h_prev):
    """One decode step.  x_t (B, R), h_prev (B, R) float32 -> (out in
    x_t's type, h float32)."""
    a, b = _decay_and_input(params, x_t[:, None, :])
    h = a[:, 0] * h_prev + b[:, 0]
    return h.to(x_t.dtype), h


def _causal_conv(params: RGLRU, x):
    """Depthwise causal conv1d of width W over x (B, S, R): the W shifted
    products summed in x's type one by one, as the reference's Python
    ``sum``, then the float32 bias, rounded to x's type."""
    W = params.conv_w.shape[0]
    S = x.shape[1]
    pads = torch.nn.functional.pad(x, (0, 0, W - 1, 0))
    out = 0
    for i in range(W):
        out = out + pads[:, i:i + S, :] * params.conv_w[i]
    return (out + params.conv_b).to(x.dtype)


def _causal_conv_step(params: RGLRU, x_t, conv_state):
    """x_t (B, R), conv_state (B, W-1, R) -> (out (B, R), new state): the
    window's products summed in float32 and rounded once (the reference's
    einsum), plus the bias."""
    hist = torch.cat([conv_state, x_t[:, None, :]], dim=1)    # (B, W, R)
    out = (hist.float() * params.conv_w.float()).sum(dim=1) \
        .to(x_t.dtype)
    return (out + params.conv_b).to(x_t.dtype), hist[:, 1:, :]


def rglru_block_fwd(params: RGLRU, x, spec: RGLRUSpec):
    """The whole Griffin recurrent block.  x (B, S, D) -> (B, S, D)."""
    return rglru_block_prefill(params, x, spec)[0]


def rglru_block_prefill(params: RGLRU, x, spec: RGLRUSpec):
    """Prefill: the block over the prompt, and its decode state.
    x (B, S, D) -> ((B, S, D), {"h": (B, R) float32, "conv": (B, W-1, R)
    bf16}); the conv state is the last W-1 pre-conv inputs, zero-padded in
    front when the prompt is shorter."""
    gate = gelu(matmul(x, params.w_gate))
    rec_in = matmul(x, params.w_rec)
    rec, h_final = rg_lru_scan_with_state(params, _causal_conv(params,
                                                               rec_in))
    out = matmul(gate * rec, params.w_out).to(x.dtype)
    need = spec.conv_width - 1
    pre = rec_in.to(torch.bfloat16)
    if pre.shape[1] < need:
        pre = torch.nn.functional.pad(pre, (0, 0, need - pre.shape[1], 0))
    return out, {"h": h_final, "conv": pre[:, pre.shape[1] - need:, :]}


def rglru_block_step(params: RGLRU, x_t, state: dict):
    """Decode step.  x_t (B, D); state {"h": (B, R) float32, "conv":
    (B, W-1, R)} -> (out (B, D), new state)."""
    gate = gelu(matmul(x_t, params.w_gate))
    rec = matmul(x_t, params.w_rec)
    rec, conv_state = _causal_conv_step(params, rec, state["conv"])
    rec, h = rg_lru_step(params, rec, state["h"])
    out = matmul(gate * rec, params.w_out).to(x_t.dtype)
    return out, {"h": h, "conv": conv_state}
