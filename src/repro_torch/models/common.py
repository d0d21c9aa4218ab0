"""Shared model building blocks: initialisers, norms, activations, RoPE,
head padding and attention masks.

The counterpart of the reference package's ``models/common.py``.  There
parameters are pytrees of ``Box`` leaves carrying logical axis names for
sharding; on one device those have no use, so here a parameter is a plain
tensor held by an ``nn.Module`` (see :mod:`.transformer`), in the
reference's layout.  Initialisers take an explicit ``torch.Generator``
and make their values on that generator's device.

Norm and RoPE math runs in float32 and is cast back to the input type, at
the same points as the reference.
"""

from __future__ import annotations

import math
from typing import Callable, Sequence

import torch
import torch.nn.functional as F


def _param(t: torch.Tensor) -> torch.nn.Parameter:
    return torch.nn.Parameter(t, requires_grad=False)


class NamedWeights(torch.nn.Module):
    """A module holding exactly the weights its class lists in ``NAMES``,
    each a parameter under the reference's name."""

    NAMES: tuple[str, ...] = ()

    def __init__(self, **weights: torch.Tensor):
        super().__init__()
        if set(weights) != set(self.NAMES):
            raise ValueError(f"{type(self).__name__} weights "
                             f"{sorted(weights)} != {sorted(self.NAMES)}")
        for name in self.NAMES:
            setattr(self, name, _param(weights[name]))


# ---------------------------------------------------------------------------
# Initializers.  All take an explicit generator; values land on its device.
# ---------------------------------------------------------------------------


def normal_init(gen: torch.Generator, shape: Sequence[int],
                stddev: float = 0.02,
                dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    v = torch.randn(tuple(shape), generator=gen, dtype=torch.float32,
                    device=gen.device)
    return (stddev * v).to(dtype)


def fanin_init(gen: torch.Generator, shape: Sequence[int],
               fan_in: int | None = None,
               dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    fi = fan_in if fan_in is not None else math.prod(shape[:-1])
    return normal_init(gen, shape, stddev=1.0 / math.sqrt(max(fi, 1)),
                       dtype=dtype)


def ones_init(shape: Sequence[int], device: torch.device,
              dtype: torch.dtype = torch.float32) -> torch.Tensor:
    return torch.ones(tuple(shape), dtype=dtype, device=device)


def zeros_init(shape: Sequence[int], device: torch.device,
               dtype: torch.dtype = torch.float32) -> torch.Tensor:
    return torch.zeros(tuple(shape), dtype=dtype, device=device)


def matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` in ``a``'s type, summed in float32 and rounded once: how
    the reference's XLA computes a bf16 product, and how cuBLAS does on
    the card.  PyTorch's bf16 product on the CPU rounds some partial sums,
    so there the product is taken in float32 explicitly."""
    if a.device.type == "cpu" and a.dtype == torch.bfloat16:
        return (a.float() @ b.float()).to(a.dtype)
    return a @ b


# ---------------------------------------------------------------------------
# Normalization / activations.  Norm math in fp32, output cast to input dtype.
# ---------------------------------------------------------------------------


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    ms = xf.square().mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(ms + eps) * scale.float()
    return y.to(x.dtype)


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = (xf - mu).square().mean(dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    y = y * scale.float() + bias.float()
    return y.to(x.dtype)


def silu(x: torch.Tensor) -> torch.Tensor:
    """``x * logistic(x)`` with ``logistic(x) = 1 / (1 + exp(-x))``, each
    step rounded to the input type: the reference's ``jax.nn.silu`` and
    its logistic lowering, operation for operation (a fused silu rounds
    once and gives other bf16 values)."""
    return x * torch.reciprocal(1 + torch.exp(-x))


def sigmoid(x: torch.Tensor) -> torch.Tensor:
    """``1 / (1 + exp(-x))``, each step rounded to the input type: the
    reference's ``jax.nn.sigmoid`` (``lax.logistic``) bit for bit on bf16
    inputs, as :func:`silu` (``torch.sigmoid`` rounds once)."""
    return torch.reciprocal(1 + torch.exp(-x))


def _const(v: float, x: torch.Tensor) -> torch.Tensor:
    """``v`` rounded to ``x``'s type, as JAX rounds a weakly typed Python
    scalar before it meets an array (PyTorch keeps the scalar in float32)."""
    return torch.tensor(v, dtype=x.dtype, device=x.device)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """The tanh approximation of GELU, ``x * 0.5 * (1 + tanh(sqrt(2 / pi) *
    (x + 0.044715 x^3)))``, with every constant and every step rounded to
    the input type: ``jax.nn.gelu``'s default, operation for operation (a
    fused gelu rounds once and gives other bf16 values)."""
    inner = x + _const(0.044715, x) * (x * x * x)
    t = torch.tanh(_const(math.sqrt(2.0 / math.pi), x) * inner)
    return x * (_const(0.5, x) * (_const(1.0, x) + t))


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``log(1 + exp(x))`` as JAX computes it (``jnp.logaddexp(x, 0)``):
    ``max(x, 0) + log1p(exp(-|x|))``.  (``F.softplus`` returns x itself
    above its threshold of 20, another function.)"""
    return torch.clamp(x, min=0) + torch.log1p(torch.exp(-x.abs()))


ACTIVATIONS: dict[str, Callable[[torch.Tensor], torch.Tensor]] = {
    "gelu": gelu,
    "silu": silu,
    "relu": F.relu,
    "relu2": lambda x: F.relu(x).square(),
}


# ---------------------------------------------------------------------------
# Rotary position embeddings.
# ---------------------------------------------------------------------------


def rope_frequencies(head_dim: int, theta: float = 10000.0,
                     device: torch.device | None = None) -> torch.Tensor:
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32,
                            device=device) / head_dim
    return 1.0 / (theta ** exponent)  # (head_dim/2,)


def apply_rope(x: torch.Tensor,           # (..., S, H, head_dim)
               positions: torch.Tensor,   # (..., S) int
               theta: float = 10000.0) -> torch.Tensor:
    hd = x.shape[-1]
    freqs = rope_frequencies(hd, theta, x.device)              # (hd/2,)
    angles = positions[..., None].float() * freqs              # (..., S, hd/2)
    cos = torch.cos(angles)[..., None, :]                      # (..., S, 1, hd/2)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Utility: pad head counts up so they shard over the tensor axis.
# ---------------------------------------------------------------------------


def padded_heads(n_heads: int, multiple: int) -> int:
    """Smallest multiple of `multiple` >= n_heads (TP divisibility)."""
    return ((n_heads + multiple - 1) // multiple) * multiple


def causal_mask(s_q: int, s_k: int, q_offset: int = 0,
                device: torch.device | None = None) -> torch.Tensor:
    """(s_q, s_k) boolean mask; True = attend.  q position i attends to
    k positions <= i + q_offset."""
    qi = torch.arange(s_q, device=device)[:, None] + q_offset
    kj = torch.arange(s_k, device=device)[None, :]
    return kj <= qi


def window_mask(s_q: int, s_k: int, window: int, q_offset: int = 0,
                device: torch.device | None = None) -> torch.Tensor:
    """Causal sliding-window: attend to the last `window` positions."""
    qi = torch.arange(s_q, device=device)[:, None] + q_offset
    kj = torch.arange(s_k, device=device)[None, :]
    return (kj <= qi) & (kj > qi - window)


def chunk_mask(s_q: int, s_k: int, chunk: int, q_offset: int = 0,
               device: torch.device | None = None) -> torch.Tensor:
    """Causal attention restricted to non-overlapping chunks (llama4-style
    chunked local attention): attend only within the same chunk."""
    qi = torch.arange(s_q, device=device)[:, None] + q_offset
    kj = torch.arange(s_k, device=device)[None, :]
    return (kj <= qi) & (qi // chunk == kj // chunk)
