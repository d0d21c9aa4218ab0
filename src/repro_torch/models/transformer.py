"""Model assembler for the dense family.

The counterpart of the reference package's ``models/transformer.py``.  The
reference compresses the layer stack into a ``lax.scan`` over stacked
super-blocks; here the layers are an ``nn.ModuleList`` in layer order, each
an ``nn.Module`` holding its weights in the reference's layout.  Only the
``dense`` block kind (attention + MLP, pre-norm residual) is ported; the
other kinds (``moe``, ``rglru``, ``rwkv``, ``enc``, ``encdec``) and the
``encdec`` and ``vlm`` families raise ``NotImplementedError`` (ROADMAP
queue A, item 8); the training forward ``model_fwd`` waits for the
training slice.
"""

from __future__ import annotations

import dataclasses

import torch

from ..configs.base import LayerKind, ModelConfig
from . import attention as attn_mod
from . import mlp as mlp_mod
from .common import (
    _param,
    fanin_init,
    layer_norm,
    normal_init,
    ones_init,
    rms_norm,
    zeros_init,
)

_PORTED_KINDS = ("dense",)


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to repro_torch yet (ROADMAP.md, queue A "
        f"item 8); the port runs the dense family")


def check_ported(config: ModelConfig) -> None:
    """Raise NotImplementedError unless every layer of ``config`` is a
    block kind of a family this port runs."""
    if config.family in ("encdec", "vlm"):
        raise _not_ported(f"the {config.family!r} family ({config.name})")
    for lk in config.layers:
        if lk.kind not in _PORTED_KINDS:
            raise _not_ported(f"block kind {lk.kind!r} ({config.name})")
    if config.positional != "rope":
        raise _not_ported(f"{config.positional!r} positions ({config.name})")


# ---------------------------------------------------------------------------
# Per-layer specs derived from the config.
# ---------------------------------------------------------------------------


def attn_spec_for(config: ModelConfig, lk: LayerKind) -> attn_mod.AttnSpec:
    is_global = lk.attn == "causal"
    theta = config.rope_theta_global if is_global else config.rope_theta
    return attn_mod.AttnSpec(
        d_model=config.d_model,
        n_heads=config.n_heads,
        n_kv_heads=config.n_kv_heads,
        head_dim=config.head_dim,
        kind=lk.attn,
        window=lk.window,
        rope_theta=theta,
        use_rope=(config.positional == "rope") and lk.use_rope,
        qk_norm=config.qk_norm,
        logit_softcap=config.logit_softcap,
    )


# ---------------------------------------------------------------------------
# Norm helpers (rms vs ln).
# ---------------------------------------------------------------------------


class Norm(torch.nn.Module):
    """RMSNorm (``scale``) or LayerNorm (``scale`` and ``bias``)."""

    def __init__(self, scale: torch.Tensor, bias: torch.Tensor | None = None):
        super().__init__()
        self.scale = _param(scale)
        self.bias = None if bias is None else _param(bias)


def init_norm(config: ModelConfig, device: torch.device) -> Norm:
    if config.norm == "ln":
        return Norm(ones_init((config.d_model,), device),
                    zeros_init((config.d_model,), device))
    return Norm(ones_init((config.d_model,), device))


def apply_norm(p: Norm, x, config: ModelConfig):
    if config.norm == "ln":
        return layer_norm(x, p.scale, p.bias)
    return rms_norm(x, p.scale)


# ---------------------------------------------------------------------------
# Blocks.
# ---------------------------------------------------------------------------


class Block(torch.nn.Module):
    """One pre-norm residual block of a dense model: ln1, attn, ln2, ffn."""

    def __init__(self, kind: LayerKind, ln1: Norm, ln2: Norm,
                 attn: attn_mod.Attention, ffn: mlp_mod.MLP):
        super().__init__()
        if kind.kind not in _PORTED_KINDS:
            raise _not_ported(f"block kind {kind.kind!r}")
        self.kind = kind
        self.ln1, self.ln2, self.attn, self.ffn = ln1, ln2, attn, ffn


def init_block(gen: torch.Generator, config: ModelConfig,
               lk: LayerKind) -> Block:
    dev = gen.device
    return Block(
        lk, init_norm(config, dev), init_norm(config, dev),
        attn_mod.init_attention(gen, attn_spec_for(config, lk)),
        mlp_mod.init_mlp(gen, config.d_model, config.d_ff,
                         gated=config.gated_mlp))


# ---------------------------------------------------------------------------
# Stage plan: the pattern tiled over the layers.
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class StackPlan:
    pattern: tuple[LayerKind, ...]
    reps: int                       # repetitions of the pattern
    tail: tuple[LayerKind, ...]     # remainder layers

    @property
    def layers(self) -> tuple[LayerKind, ...]:
        """Every layer's kind, in layer order (the ``ModuleList`` order)."""
        return self.pattern * self.reps + self.tail


def stack_plan(config: ModelConfig, n_layers: int | None = None) -> StackPlan:
    p = config.pattern
    n = config.n_layers if n_layers is None else n_layers
    reps, rem = divmod(n, len(p))
    if reps == 0:
        return StackPlan(pattern=(), reps=0, tail=p[:rem])
    return StackPlan(pattern=p, reps=reps, tail=p[:rem])


# ---------------------------------------------------------------------------
# Whole model.
# ---------------------------------------------------------------------------


class Model(torch.nn.Module):
    """A dense decoder-only model: embed (V, D), layers, final_norm,
    lm_head (D, V) (untied, as the reference builds every arch)."""

    def __init__(self, config: ModelConfig, embed: torch.Tensor,
                 lm_head: torch.Tensor, final_norm: Norm,
                 layers: list[Block]):
        super().__init__()
        check_ported(config)
        kinds = stack_plan(config).layers
        if tuple(b.kind for b in layers) != kinds:
            raise ValueError(f"{len(layers)} blocks do not match the "
                             f"{len(kinds)} layers of {config.name}")
        self.config = config
        self.embed, self.lm_head = _param(embed), _param(lm_head)
        self.final_norm = final_norm
        self.layers = torch.nn.ModuleList(layers)


def init_model(gen: torch.Generator, config: ModelConfig) -> Model:
    """Random weights for ``config``, made on ``gen``'s device from it
    (bf16 matrices, float32 norm scales, as the reference's init)."""
    check_ported(config)
    D, V = config.d_model, config.vocab
    embed = normal_init(gen, (V, D))
    lm_head = fanin_init(gen, (D, V), fan_in=D)
    final_norm = init_norm(config, gen.device)
    layers = [init_block(gen, config, lk)
              for lk in stack_plan(config).layers]
    return Model(config, embed, lm_head, final_norm, layers)


def _embed_tokens(params: Model, tokens, config: ModelConfig):
    x = params.embed[tokens]
    if config.scale_embed:
        x = (x.float() * torch.sqrt(torch.tensor(
            float(config.d_model), device=x.device))).to(x.dtype)
    return x
