"""Gradient compression: int8 row-wise quantization with error feedback.

The counterpart of the reference package's ``optim/compression.py``, over
``{name: tensor}`` dicts.  The gradient is quantized (4x fewer bytes
than float32 on a wire), de-quantized, and the quantization error is added
back into the next step's gradient so the bias does not accumulate
(1-bit-Adam-style residual carrying).  The row-wise scale (max |g| per
trailing-dim row) bounds the dynamic-range loss per row.

The reference's jnp ``quantize_int8`` is the plain user of its Pallas
kernel; here :func:`quantize_int8` is :func:`repro_torch.kernels.ops.
quantize_int8`, so a gradient on the card goes through the hand kernel.
Rows lie along the trailing dim, so a layer's tensor quantizes to the same
rows whether it stands alone (as here) or is stacked with the other
layers' (as in the reference's scanned stack).
"""

from __future__ import annotations

import torch

from ..kernels import ops
from .optimizer import tree_map

#: x (..., N) -> (q int8 (..., N), scale float32 (..., 1)).
quantize_int8 = ops.quantize_int8


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor,
                    dtype: torch.dtype = torch.float32) -> torch.Tensor:
    return (q.float() * scale).to(dtype)


def compress_tree(grads):
    """Quantize every leaf; returns (tree of (q, scale), error tree)."""

    def one(g):
        q, s = quantize_int8(g)
        return (q, s), g.float() - dequantize_int8(q, s)

    pairs = tree_map(one, grads)
    return (tree_map(lambda p: p[0], pairs), tree_map(lambda p: p[1], pairs))


def apply_error_feedback(grads, residual):
    """g <- g + residual (from the previous step's quantization error)."""
    if residual is None:
        return grads
    return tree_map(lambda g, r: (g.float() + r).to(g.dtype), grads,
                    residual)


def compressed_roundtrip(grads, residual=None):
    """One error-feedback compression cycle: returns (decompressed grads in
    their own types, new residual)."""
    fed = apply_error_feedback(grads, residual)
    qtree, etree = compress_tree(fed)
    deq = tree_map(lambda qs, g: dequantize_int8(qs[0], qs[1], g.dtype),
                   qtree, grads)
    return deq, etree
