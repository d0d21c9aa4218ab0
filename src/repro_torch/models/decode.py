"""Serving traversals: prefill (prompt -> cache) and decode (one token).

The counterpart of the reference package's ``models/decode.py``, for the
dense, rglru and rwkv block kinds.  The cache is a list with one dict per
layer, in layer order:

  k/v            (B, W, K, hd), bf16 (the activations' type)  [dense]
  h              (B, R) float32                               [rglru]
  conv           (B, W-1, R) bf16, the last W-1 conv inputs
  S              (B, H, hd, hd) float32, the wkv state        [rwkv]
  shift_t/_c     (B, D) bf16, the time/channel mix's last input

Ring-buffer semantics: position ``p`` writes slot ``p % W``; W = max_len
for causal layers, the window for local/chunked layers.

Two differences from the reference, both about memory:

* the decode step writes the new token's k/v into the layer's cache
  buffers **in place** (an index write at slot ``pos % W``; the reference
  returns updated buffers from ``dynamic_update_slice``), puts a
  recurrent layer's new state into the same dict (every element of it
  changes each step), and returns the same list it was given;
* the prefill builds the per-layer list directly (the reference scans
  the stacked layers and unstacks their caches afterwards).
"""

from __future__ import annotations

import torch

from ..configs.base import LayerKind, ModelConfig
from ..device import resolve_device
from . import attention as attn_mod
from . import mlp as mlp_mod
from . import rglru as rglru_mod
from . import rwkv6 as rwkv_mod
from .common import matmul
from .transformer import (
    Block,
    Model,
    _embed_tokens,
    apply_norm,
    attn_spec_for,
    check_ported,
    rglru_spec_for,
    rwkv_spec_for,
    stack_plan,
)


def cache_window(lk: LayerKind, max_len: int) -> int:
    if lk.attn in ("window", "chunk") and lk.window > 0:
        return min(lk.window, max_len)
    return max_len


def init_block_cache(config: ModelConfig, lk: LayerKind, batch: int,
                     max_len: int,
                     device: torch.device) -> dict[str, torch.Tensor]:
    def zeros(*shape, dtype=torch.bfloat16):
        return torch.zeros(shape, dtype=dtype, device=device)

    if lk.kind == "rglru":
        spec = rglru_spec_for(config)
        return {"h": zeros(batch, spec.d_rnn, dtype=torch.float32),
                "conv": zeros(batch, spec.conv_width - 1, spec.d_rnn)}
    if lk.kind == "rwkv":
        spec = rwkv_spec_for(config)
        H, hd = spec.n_heads, spec.head_dim
        return {"S": zeros(batch, H, hd, hd, dtype=torch.float32),
                "shift_t": zeros(batch, config.d_model),
                "shift_c": zeros(batch, config.d_model)}
    W = cache_window(lk, max_len)
    shape = (batch, W, config.n_kv_heads, config.head_dim)
    return {"k": zeros(*shape), "v": zeros(*shape)}


def init_cache(config: ModelConfig, batch: int, max_len: int,
               device: torch.device | str = "cuda"
               ) -> list[dict[str, torch.Tensor]]:
    """Whole-model cache: one dict per layer (``{"k", "v"}``, ``{"h",
    "conv"}`` or ``{"S", "shift_t", "shift_c"}`` by its kind), zeros on
    ``device`` (the card unless the caller names another)."""
    check_ported(config)
    dev = resolve_device(device)
    return [init_block_cache(config, lk, batch, max_len, dev)
            for lk in stack_plan(config).layers]


# ---------------------------------------------------------------------------
# Ring-buffer helpers.
# ---------------------------------------------------------------------------


def _fill_ring(buf_shape, k_full: torch.Tensor, W: int) -> torch.Tensor:
    """Place prompt k/v (B,S,K,hd) into a W-slot ring at slots p % W.  The
    ring holds k/v in their own type: bf16 for every model the reference
    defines (its caches are bf16); a model cast to float32 keeps a float32
    cache."""
    S = k_full.shape[1]
    buf = torch.zeros(buf_shape, dtype=k_full.dtype, device=k_full.device)
    if S >= W:
        slots = torch.arange(S - W, S, device=k_full.device) % W
        buf[:, slots] = k_full[:, S - W:]
        return buf
    buf[:, :S] = k_full
    return buf


def _ring_mask(pos: int, W: int, attn_kind: str,
               device: torch.device | None = None) -> torch.Tensor:
    """(W,) bool validity of ring slots after writing position ``pos``."""
    s = torch.arange(W, device=device)
    if attn_kind == "chunk":
        return s <= (pos % W)
    return s <= pos           # causal (W = max_len) and window (wraps full)


# ---------------------------------------------------------------------------
# Block-level prefill / decode.
# ---------------------------------------------------------------------------


def block_prefill(params: Block, x, config: ModelConfig, lk: LayerKind,
                  positions, max_len: int):
    """One block forward that also fills its cache.

    Returns (x, cache) with cache as :func:`init_block_cache` lays it out.
    """
    if lk.kind == "rglru":
        h = apply_norm(params.ln1, x, config)
        out, cache = rglru_mod.rglru_block_prefill(params.rec, h,
                                                   rglru_spec_for(config))
        x = x + out
        h = apply_norm(params.ln2, x, config)
        return x + mlp_mod.mlp_fwd(params.ffn, h, config.activation), cache
    if lk.kind == "rwkv":
        h = apply_norm(params.ln1, x, config)
        out, tstate = rwkv_mod.rwkv_time_prefill(params.time, h,
                                                 rwkv_spec_for(config))
        x = x + out
        h = apply_norm(params.ln2, x, config)
        out, cstate = rwkv_mod.rwkv_channel_prefill(params.chan, h)
        return x + out, {"S": tstate["S"], "shift_t": tstate["shift"],
                         "shift_c": cstate["shift"]}
    spec = attn_spec_for(config, lk)
    W = cache_window(lk, max_len)
    B = x.shape[0]
    K, hd = spec.n_kv_heads, spec.head_dim
    h = apply_norm(params.ln1, x, config)
    out, (k, v) = attn_mod.attention_prefill(params.attn, h, spec, positions)
    x = x + out
    cache = {"k": _fill_ring((B, W, K, hd), k, W),
             "v": _fill_ring((B, W, K, hd), v, W)}
    h = apply_norm(params.ln2, x, config)
    x = x + mlp_mod.mlp_fwd(params.ffn, h, config.activation)
    return x, cache


def block_decode(params: Block, x, config: ModelConfig, lk: LayerKind,
                 cache: dict[str, torch.Tensor], pos: int):
    """One block decode step.  x (B,1,D), pos int.  Writes the new token's
    k/v into ``cache`` in place, or puts the new recurrent state into it;
    returns x."""
    if lk.kind == "rglru":
        h = apply_norm(params.ln1, x, config)
        out, state = rglru_mod.rglru_block_step(params.rec, h[:, 0], cache)
        cache.update(state)
        x = x + out[:, None, :]
        h = apply_norm(params.ln2, x, config)
        return x + mlp_mod.mlp_fwd(params.ffn, h, config.activation)
    if lk.kind == "rwkv":
        h = apply_norm(params.ln1, x, config)
        out, tstate = rwkv_mod.rwkv_time_step(
            params.time, h[:, 0], {"S": cache["S"],
                                   "shift": cache["shift_t"]},
            rwkv_spec_for(config))
        x = x + out[:, None, :]
        h = apply_norm(params.ln2, x, config)
        out, cstate = rwkv_mod.rwkv_channel_step(
            params.chan, h[:, 0], {"shift": cache["shift_c"]})
        cache.update(S=tstate["S"],
                     shift_t=tstate["shift"].to(torch.bfloat16),
                     shift_c=cstate["shift"].to(torch.bfloat16))
        return x + out[:, None, :]
    spec = attn_spec_for(config, lk)
    B = x.shape[0]
    W = cache["k"].shape[1]
    h = apply_norm(params.ln1, x, config)
    q, k_new, v_new = attn_mod.decode_project(params.attn, h, spec, pos)
    slot = pos % W
    cache["k"][:, slot] = k_new[:, 0].to(cache["k"].dtype)
    cache["v"][:, slot] = v_new[:, 0].to(cache["v"].dtype)
    valid = _ring_mask(pos, W, lk.attn, x.device)[None].expand(B, W)
    out = attn_mod.decode_attend(q, cache["k"], cache["v"],
                                 valid.contiguous(), spec)
    x = x + attn_mod._out(out, params.attn.wo)
    h = apply_norm(params.ln2, x, config)
    return x + mlp_mod.mlp_fwd(params.ffn, h, config.activation)


# ---------------------------------------------------------------------------
# Stack-level traversals.
# ---------------------------------------------------------------------------


def stack_prefill(layers, x, config: ModelConfig, positions, max_len: int):
    cache = []
    for block in layers:
        x, c = block_prefill(block, x, config, block.kind, positions,
                             max_len)
        cache.append(c)
    return x, cache


def stack_decode(layers, cache, x, config: ModelConfig, pos: int):
    for block, c in zip(layers, cache):
        x = block_decode(block, x, config, block.kind, c, pos)
    return x, cache


# ---------------------------------------------------------------------------
# Whole-model prefill / decode.
# ---------------------------------------------------------------------------


def model_prefill(params: Model, batch: dict, config: ModelConfig,
                  max_len: int):
    """Prompt (B,S) -> (last-token logits (B,V), cache, aux).

    ``max_len`` sizes the causal-layer cache (the serving budget); ``aux``
    (the MoE load-balance loss in the reference) is 0 for these blocks.
    """
    check_ported(config)
    tokens = batch["tokens"]
    B, S = tokens.shape
    x = _embed_tokens(params, tokens, config)
    pos = torch.arange(S, dtype=torch.int32, device=x.device)[None] \
        .expand(B, S)
    x, cache = stack_prefill(params.layers, x, config, pos, max_len)
    x = apply_norm(params.final_norm, x, config)
    logits = matmul(x[:, -1], params.lm_head)
    return logits, cache, torch.zeros((), dtype=torch.float32,
                                      device=x.device)


def model_decode(params: Model, cache, tokens, pos: int,
                 config: ModelConfig):
    """One decode step.  tokens (B,1), pos int (position being written).
    Returns (logits (B,V), cache), the cache updated in place."""
    x = _embed_tokens(params, tokens, config)
    x, cache = stack_decode(params.layers, cache, x, config, int(pos))
    x = apply_norm(params.final_norm, x, config)
    logits = matmul(x[:, -1], params.lm_head)
    return logits, cache
