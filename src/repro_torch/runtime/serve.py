"""Serve-step builders: prefill and decode cells for the engine, on one
device.

The counterpart of the reference package's ``runtime/serve.py``.  The
reference builds jitted steps with parameter, cache and input shardings
over a mesh (rules in its ``runtime/partitioning.py``); one card has no
mesh, so these builders return plain callables with the reference steps'
signatures that run the model eagerly on ``device`` without autograd.
The multi-card layout waits for its slice (ROADMAP queue A, item 8).
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from ..configs.base import ModelConfig, ShapeConfig
from ..device import resolve_device
from ..models import decode as decode_mod
from ..models.transformer import Model, check_ported


def _tokens(t, device: torch.device) -> torch.Tensor:
    """Token ids (numpy or tensor, any int type) as int64 on ``device``."""
    if isinstance(t, np.ndarray):
        t = torch.from_numpy(np.array(t, dtype=np.int64))
    return t.to(device=device, dtype=torch.int64, non_blocking=True)


def _check_params(params: Model, device: torch.device) -> None:
    on = params.embed.device
    if on.type != device.type or (device.index is not None
                                  and on.index != device.index):
        raise ValueError(f"parameters lie on {on}, the "
                         f"step runs on {device}")


def build_prefill_step(config: ModelConfig, shape: ShapeConfig,
                       device: str | torch.device = "cuda") -> Callable:
    """``prefill(params, batch) -> (last-token logits (B, V), cache)`` for
    prompts ``batch["tokens"]`` (B, S); the cache holds ``shape.seq_len``
    positions per causal layer."""
    check_ported(config)
    dev = resolve_device(device)

    @torch.inference_mode()
    def prefill_step(params: Model, batch: dict):
        _check_params(params, dev)
        logits, cache, _ = decode_mod.model_prefill(
            params, {"tokens": _tokens(batch["tokens"], dev)}, config,
            shape.seq_len)
        return logits, cache

    return prefill_step


def build_decode_step(config: ModelConfig, shape: ShapeConfig,
                      device: str | torch.device = "cuda") -> Callable:
    """``decode(params, cache, tokens, pos) -> (logits (B, V), cache)``: one
    new token per sequence (tokens (B, 1)) written at position ``pos``.
    The cache is updated in place (the reference donates it instead)."""
    check_ported(config)
    dev = resolve_device(device)

    @torch.inference_mode()
    def decode_step(params: Model, cache, tokens, pos: int):
        _check_params(params, dev)
        return decode_mod.model_decode(params, cache, _tokens(tokens, dev),
                                       int(pos), config)

    return decode_step
