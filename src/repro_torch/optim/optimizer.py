"""AdamW with configurable state dtype.

The counterpart of the reference package's ``optim/optimizer.py``, as
plain functions on dicts of tensors: a parameter "tree" here is a
``{name: tensor}`` dict such as ``dict(model.named_parameters())``, and
the moments are dicts with the same keys.  The math is the reference's,
operation for operation, in float32 on upcast values; moments can be kept
in bfloat16.

Weight decay, as in the reference, applies to leaves of rank >= 2.  The
reference stacks the parameters of its scanned layers on a leading axis,
so a layer's (D,) norm scale is a rank-2 leaf there and is decayed; the
port holds one tensor per layer.  :func:`adamw_update` therefore takes
``ranks``, the rank of each parameter's leaf in the reference's layout
(:func:`repro_torch.runtime.train.reference_ranks` gives it for a model),
and decays by that rank; without it a tensor's own rank decides.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Mapping

import torch


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    state_dtype: str = "float32"      # "float32" | "bfloat16"
    grad_clip: float = 1.0            # global-norm clip; 0 disables


@dataclasses.dataclass
class OptState:
    """m/v moment dicts + scalar int32 step count (a 0-dim tensor)."""

    m: dict[str, torch.Tensor]
    v: dict[str, torch.Tensor]
    count: torch.Tensor


def _state_dtype(cfg: AdamWConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.state_dtype == "bfloat16" else torch.float32


def tree_map(fn: Callable, tree: Mapping, *rest: Mapping) -> dict:
    """``fn`` over the values of a dict and of same-keyed others."""
    return {k: fn(v, *(r[k] for r in rest)) for k, v in tree.items()}


def adamw_init(params: Mapping, cfg: AdamWConfig) -> OptState:
    dt = _state_dtype(cfg)
    dev = next(iter(params.values())).device

    def zeros(p):
        return torch.zeros(p.shape, dtype=dt, device=p.device)

    return OptState(m=tree_map(zeros, params), v=tree_map(zeros, params),
                    count=torch.zeros((), dtype=torch.int32, device=dev))


def global_norm(tree: Mapping) -> torch.Tensor:
    """sqrt of the sum of every leaf's float32 sum of squares (the sum is
    taken on the device; nothing is read back)."""
    return torch.sqrt(sum(torch.square(g.float()).sum()
                          for g in tree.values()))


def clip_by_global_norm(grads: Mapping, max_norm: float):
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    return tree_map(lambda g: (g.float() * scale).to(g.dtype), grads), norm


def adamw_update(grads: Mapping, state: OptState, params: Mapping,
                 cfg: AdamWConfig, lr: torch.Tensor | float | None = None,
                 ranks: Mapping[str, int] | None = None):
    """Returns (new_params, new_state), fresh tensors (the inputs are not
    changed).  Grads may be any float dtype.  ``ranks`` maps a key of
    ``params`` to the rank of its leaf in the reference's layout, which
    decides weight decay (rank >= 2); keys it lacks use their own rank."""
    if cfg.grad_clip > 0:
        grads, _ = clip_by_global_norm(grads, cfg.grad_clip)
    count = state.count + 1
    cf = count.float()
    bc1 = 1.0 - torch.pow(cfg.b1, cf)
    bc2 = 1.0 - torch.pow(cfg.b2, cf)
    step_lr = cfg.lr if lr is None else lr
    dt = _state_dtype(cfg)

    def upd(key, p, g, m, v):
        gf = g.float()
        mf = cfg.b1 * m.float() + (1 - cfg.b1) * gf
        vf = cfg.b2 * v.float() + (1 - cfg.b2) * torch.square(gf)
        mhat = mf / bc1
        vhat = vf / bc2
        delta = mhat / (torch.sqrt(vhat) + cfg.eps)
        pf = p.float()
        rank = p.dim() if ranks is None else ranks.get(key, p.dim())
        if cfg.weight_decay > 0 and rank >= 2:     # decay matrices only
            delta = delta + cfg.weight_decay * pf
        new_p = (pf - step_lr * delta).to(p.dtype)
        return new_p, mf.to(dt), vf.to(dt)

    out = {k: upd(k, p, grads[k], state.m[k], state.v[k])
           for k, p in params.items()}
    return ({k: o[0] for k, o in out.items()},
            OptState(m={k: o[1] for k, o in out.items()},
                     v={k: o[2] for k, o in out.items()}, count=count))


def cosine_schedule(base_lr: float, warmup: int, total: int,
                    floor: float = 0.1) -> Callable[[torch.Tensor],
                                                    torch.Tensor]:
    """Linear warmup then cosine decay to floor*base_lr."""

    def lr(step: torch.Tensor) -> torch.Tensor:
        s = step.float()
        warm = base_lr * (s + 1.0) / max(warmup, 1)   # step 0 trains too
        t = torch.clamp((s - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = floor * base_lr + (1 - floor) * base_lr * 0.5 * (
            1.0 + torch.cos(math.pi * t))
        return torch.where(s < warmup, warm, cos)

    return lr
