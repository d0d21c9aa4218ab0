"""Dense feed-forward blocks: gated (SwiGLU/GeGLU) and plain.

The counterpart of the reference package's ``models/mlp.py``; weights in
its layout, w_in/w_gate (D, F) and w_out (F, D).
"""

from __future__ import annotations

import torch

from .common import ACTIVATIONS, _param, fanin_init, matmul


class MLP(torch.nn.Module):
    def __init__(self, w_in: torch.Tensor, w_out: torch.Tensor,
                 w_gate: torch.Tensor | None = None):
        super().__init__()
        self.w_in, self.w_out = _param(w_in), _param(w_out)
        self.w_gate = None if w_gate is None else _param(w_gate)


def init_mlp(gen: torch.Generator, d_model: int, d_ff: int,
             gated: bool = True) -> MLP:
    w_in = fanin_init(gen, (d_model, d_ff), fan_in=d_model)
    w_out = fanin_init(gen, (d_ff, d_model), fan_in=d_ff)
    w_gate = fanin_init(gen, (d_model, d_ff), fan_in=d_model) \
        if gated else None
    return MLP(w_in, w_out, w_gate)


def mlp_fwd(params: MLP, x: torch.Tensor,
            activation: str = "silu") -> torch.Tensor:
    act = ACTIVATIONS[activation]
    h = matmul(x, params.w_in)
    if params.w_gate is not None:
        h = act(matmul(x, params.w_gate)) * h
    else:
        h = act(h)
    return matmul(h, params.w_out).to(x.dtype)
