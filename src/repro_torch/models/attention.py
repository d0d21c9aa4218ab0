"""Attention: GQA with causal / sliding-window / chunked / bidirectional /
cross variants, qk-norm and RoPE.

The counterpart of the reference package's ``models/attention.py``.  The
reference computes attention with pure-jnp paths and keeps its Pallas
kernels as drop-in replacements for them on the TPU; here ``attend`` and
``decode_attend`` call :func:`repro_torch.kernels.ops.flash_attention`
and :func:`~repro_torch.kernels.ops.flash_decode`, which launch the hand
CUDA kernels for tensors on the card and run the plain version (the
reference's jnp math, with its bf16 rounding of scores and weights) for
tensors on the CPU.
The training forward ``attention_fwd`` goes through
:func:`~repro_torch.kernels.ops.flash_attention_trainable`, whose backward
is the hand backward kernel (the reference differentiates its jnp path).

Score math is fp32; activations bf16.
"""

from __future__ import annotations

import dataclasses

import torch

from ..kernels import ops
from .common import (
    _param,
    apply_rope,
    fanin_init,
    matmul,
    ones_init,
    rms_norm,
)


@dataclasses.dataclass(frozen=True)
class AttnSpec:
    """Static attention hyperparameters for one layer."""

    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    kind: str = "causal"        # causal | window | chunk | bidir | cross
    window: int = 0             # for kind == "window" / "chunk"
    rope_theta: float = 10000.0
    use_rope: bool = True
    qk_norm: bool = False
    logit_softcap: float = 0.0

    @property
    def groups(self) -> int:
        # query heads per kv head
        if self.n_heads % self.n_kv_heads:
            raise ValueError(f"{self.n_heads} heads over {self.n_kv_heads} "
                             f"kv heads")
        return self.n_heads // self.n_kv_heads


class Attention(torch.nn.Module):
    """QKV/O projections in the reference's layout: wq (D, H, hd), wk/wv
    (D, K, hd), wo (H, hd, D); q_norm/k_norm (hd,) with qk-norm."""

    def __init__(self, wq: torch.Tensor, wk: torch.Tensor, wv: torch.Tensor,
                 wo: torch.Tensor, q_norm: torch.Tensor | None = None,
                 k_norm: torch.Tensor | None = None):
        super().__init__()
        self.wq, self.wk, self.wv, self.wo = map(_param, (wq, wk, wv, wo))
        self.q_norm = None if q_norm is None else _param(q_norm)
        self.k_norm = None if k_norm is None else _param(k_norm)


def init_attention(gen: torch.Generator, spec: AttnSpec) -> Attention:
    """QKV/O projections.  (The reference pads the heads to its
    tensor-parallel degree; one device has no padding.)"""
    D, H, K, hd = spec.d_model, spec.n_heads, spec.n_kv_heads, spec.head_dim
    dev = gen.device
    return Attention(
        wq=fanin_init(gen, (D, H, hd), fan_in=D),
        wk=fanin_init(gen, (D, K, hd), fan_in=D),
        wv=fanin_init(gen, (D, K, hd), fan_in=D),
        wo=fanin_init(gen, (H, hd, D), fan_in=H * hd),
        q_norm=ones_init((hd,), dev) if spec.qk_norm else None,
        k_norm=ones_init((hd,), dev) if spec.qk_norm else None)


def _heads(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (B, S, D) @ w (D, N, hd) -> (B, S, N, hd)."""
    D, N, hd = w.shape
    return matmul(x, w.reshape(D, N * hd)).reshape(*x.shape[:-1], N, hd)


def _out(o: torch.Tensor, wo: torch.Tensor) -> torch.Tensor:
    """o (B, S, H, hd) @ wo (H, hd, D) -> (B, S, D)."""
    H, hd, D = wo.shape
    return matmul(o.reshape(*o.shape[:-2], H * hd), wo.reshape(H * hd, D))


def _project_qkv(params: Attention, x, spec: AttnSpec, positions):
    """x (B,S,D) -> q (B,S,H,hd), k/v (B,S,K,hd) with qk-norm + rope."""
    q = _heads(x, params.wq)
    k = _heads(x, params.wk)
    v = _heads(x, params.wv)
    if spec.qk_norm:
        q = rms_norm(q, params.q_norm)
        k = rms_norm(k, params.k_norm)
    if spec.use_rope:
        q = apply_rope(q, positions, spec.rope_theta)
        k = apply_rope(k, positions, spec.rope_theta)
    return q, k, v


def attend(q, k, v, spec: AttnSpec):
    """Prefill attention through the flash-attention kernel (the plain
    version on the CPU).  The reference picks among its dense, q-chunked,
    banded and chunk-local jnp paths, which all compute this masked
    attention; the kernel covers every mask kind at any length."""
    return ops.flash_attention(q, k, v, kind=spec.kind, window=spec.window,
                               softcap=spec.logit_softcap)


def attention_fwd(params: Attention, x, spec: AttnSpec, positions=None):
    """Differentiable self-attention for training: x (B,S,D) -> (B,S,D),
    through the flash-attention kernels forward and backward (the plain
    versions on the CPU)."""
    B, S, _ = x.shape
    if positions is None:
        positions = torch.arange(S, dtype=torch.int32, device=x.device)[None]
    q, k, v = _project_qkv(params, x, spec, positions)
    out = ops.flash_attention_trainable(q, k, v, spec.kind, spec.window,
                                        spec.logit_softcap)
    return _out(out, params.wo)


def attention_prefill(params: Attention, x, spec: AttnSpec, positions=None):
    """Self-attention over a prompt that also returns the (rope'd) k/v for
    the cache.  (The reference's cross-attention branch, ``kv_override``,
    serves the encoder-decoder family, which is not ported.)

    Returns (out (B,S,D), (k, v) each (B,S,K,hd)).
    """
    B, S, _ = x.shape
    if positions is None:
        positions = torch.arange(S, dtype=torch.int32, device=x.device)[None]
    q, k, v = _project_qkv(params, x, spec, positions)
    out = attend(q, k, v, spec)
    return _out(out, params.wo), (k, v)


# ---------------------------------------------------------------------------
# Decode path: one new token against a cache.
# ---------------------------------------------------------------------------


def decode_project(params: Attention, x, spec: AttnSpec, pos: int):
    """x (B,1,D), pos int -> q (B,1,H,hd), k/v (B,1,K,hd)."""
    positions = torch.full((x.shape[0], 1), int(pos), dtype=torch.int32,
                           device=x.device)
    return _project_qkv(params, x, spec, positions)


def decode_attend(q, k_cache, v_cache, valid_mask, spec: AttnSpec):
    """q (B,1,H,hd) vs cache (B,W,K,hd); valid_mask (B,W) bool, through
    the flash-decode kernel (the plain version on the CPU: the reference's
    jnp math).  The cache is read in place."""
    return ops.flash_decode(q, k_cache, v_cache, valid_mask,
                            softcap=spec.logit_softcap)


def decode_attention(params: Attention, x, spec: AttnSpec, pos: int,
                     k_cache, v_cache, valid_mask):
    q, k_new, v_new = decode_project(params, x, spec, pos)
    out = decode_attend(q, k_cache, v_cache, valid_mask, spec)
    return _out(out, params.wo), k_new, v_new
