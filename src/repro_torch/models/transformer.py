"""Model assembler for the dense, hybrid (RG-LRU) and RWKV families.

The counterpart of the reference package's ``models/transformer.py``.  The
reference compresses the layer stack into a ``lax.scan`` over stacked
super-blocks; here the layers are an ``nn.ModuleList`` in layer order, each
an ``nn.Module`` holding its weights in the reference's layout.  The
``dense`` (attention + MLP), ``rglru`` (Griffin recurrent block + MLP) and
``rwkv`` (time mix + channel mix) block kinds are ported, all pre-norm
residual blocks; the port serves all three and trains the dense one (the
recurrent kernels have no backward yet).  The other kinds (``moe``,
``enc``, ``encdec``), the ``encdec`` and ``vlm`` families, and training a
recurrent block raise ``NotImplementedError`` (ROADMAP queue A, item 8).

``model_fwd`` is the training forward (the serve traversals are in
:mod:`.decode`).  The reference scans its stacked layers with
``jax.checkpoint`` around each super-block (one repetition of the layer
pattern) under ``remat="block"``, and a two-level sqrt schedule under
``"full"``; here the layers run in a Python loop and the same regions are
wrapped in ``torch.utils.checkpoint`` (non-reentrant), which saves only
each region's input and recomputes the rest in the backward.
"""

from __future__ import annotations

import dataclasses
import functools
import math

import torch
from torch.utils.checkpoint import checkpoint

from ..configs.base import LayerKind, ModelConfig
from . import attention as attn_mod
from . import mlp as mlp_mod
from . import rglru as rglru_mod
from . import rwkv6 as rwkv_mod
from .common import (
    _param,
    fanin_init,
    layer_norm,
    matmul,
    normal_init,
    ones_init,
    rms_norm,
    zeros_init,
)

#: The parts of each ported block kind besides its two norms, by the
#: reference's parameter names.
BLOCK_PARTS = {"dense": ("attn", "ffn"), "rglru": ("rec", "ffn"),
               "rwkv": ("time", "chan")}
#: The kinds the training path runs (the others' kernels have no backward).
_TRAINED_KINDS = ("dense",)


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to repro_torch yet (ROADMAP.md, queue A "
        f"item 8); the port serves the dense, rglru and rwkv block kinds "
        f"and trains the dense one")


def check_ported(config: ModelConfig, training: bool = False) -> None:
    """Raise NotImplementedError unless every layer of ``config`` is a
    block kind this port serves (with ``training``: trains)."""
    if config.family in ("encdec", "vlm"):
        raise _not_ported(f"the {config.family!r} family ({config.name})")
    for lk in config.layers:
        if lk.kind not in BLOCK_PARTS:
            raise _not_ported(f"block kind {lk.kind!r} ({config.name})")
        if training and lk.kind not in _TRAINED_KINDS:
            raise _not_ported(f"training block kind {lk.kind!r} "
                              f"({config.name})")
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


def rglru_spec_for(config: ModelConfig) -> rglru_mod.RGLRUSpec:
    return rglru_mod.RGLRUSpec(d_model=config.d_model,
                               d_rnn=config.rnn_width,
                               conv_width=config.conv_width)


def rwkv_spec_for(config: ModelConfig) -> rwkv_mod.RWKV6Spec:
    return rwkv_mod.RWKV6Spec(d_model=config.d_model,
                              head_dim=config.rwkv_head_dim,
                              d_ff=config.d_ff, chunk=config.rwkv_chunk)


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
    """One pre-norm residual block: ln1, ln2 and the parts of its kind
    (:data:`BLOCK_PARTS`): attn and ffn (dense), rec and ffn (rglru), time
    and chan (rwkv)."""

    def __init__(self, kind: LayerKind, ln1: Norm, ln2: Norm,
                 **parts: torch.nn.Module):
        super().__init__()
        if kind.kind not in BLOCK_PARTS:
            raise _not_ported(f"block kind {kind.kind!r}")
        if set(parts) != set(BLOCK_PARTS[kind.kind]):
            raise ValueError(f"a {kind.kind!r} block has parts "
                             f"{BLOCK_PARTS[kind.kind]}, got {sorted(parts)}")
        self.kind = kind
        self.ln1, self.ln2 = ln1, ln2
        for name in BLOCK_PARTS[kind.kind]:
            setattr(self, name, parts[name])


def init_block(gen: torch.Generator, config: ModelConfig,
               lk: LayerKind) -> Block:
    dev = gen.device
    norms = (lk, init_norm(config, dev), init_norm(config, dev))
    if lk.kind == "rwkv":
        spec = rwkv_spec_for(config)
        return Block(*norms, time=rwkv_mod.init_rwkv_time(gen, spec),
                     chan=rwkv_mod.init_rwkv_channel(gen, spec))
    mixer = ({"rec": rglru_mod.init_rglru(gen, rglru_spec_for(config))}
             if lk.kind == "rglru" else
             {"attn": attn_mod.init_attention(gen, attn_spec_for(config,
                                                                  lk))})
    return Block(*norms, **mixer, ffn=mlp_mod.init_mlp(
        gen, config.d_model, config.d_ff, gated=config.gated_mlp))


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
    """A decoder-only model: embed (V, D), layers, final_norm,
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


# ---------------------------------------------------------------------------
# Training forward.
# ---------------------------------------------------------------------------


def block_fwd(params: Block, x, config: ModelConfig, lk: LayerKind,
              positions):
    """One residual block.  Returns (x, aux); aux (the MoE load-balance
    loss in the reference) is 0 for dense blocks."""
    spec = attn_spec_for(config, lk)
    h = apply_norm(params.ln1, x, config)
    x = x + attn_mod.attention_fwd(params.attn, h, spec, positions)
    h = apply_norm(params.ln2, x, config)
    x = x + mlp_mod.mlp_fwd(params.ffn, h, config.activation)
    return x, torch.zeros((), dtype=torch.float32, device=x.device)


def _run_blocks(blocks, config: ModelConfig, positions, x, aux):
    for block in blocks:
        x, a = block_fwd(block, x, config, block.kind, positions)
        aux = aux + a
    return x, aux


def _remat(fn, config: ModelConfig):
    """``fn(x, aux)`` as is under ``remat="none"``, else checkpointed: its
    backward recomputes it from its inputs, saving nothing inside."""
    if config.remat == "none":
        return fn
    return functools.partial(checkpoint, fn, use_reentrant=False)


def _sqrt_groups(n: int) -> tuple[int, int]:
    """Factor n = groups * per_group with groups ~ sqrt(n)."""
    g = max(1, int(math.isqrt(n)))
    while n % g:
        g -= 1
    return g, n // g


def stack_fwd(layers, x, config: ModelConfig, positions):
    """Apply the layer stack.  Returns (x, aux).

    The reference's scanned part (``reps`` repetitions of the pattern) runs
    one super-block at a time; ``remat`` "block" checkpoints each
    super-block, "full" checkpoints groups of about sqrt(reps) of them with
    each super-block inside checkpointed again (the backward keeps only
    the group boundaries and recomputes within a group).  The unscanned
    tail runs without remat, as in the reference.
    """
    plan = stack_plan(config)
    P = len(plan.pattern)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    supers = [functools.partial(_run_blocks, layers[r * P:(r + 1) * P],
                                config, positions)
              for r in range(plan.reps)]
    groups, per_group = (_sqrt_groups(plan.reps) if config.remat == "full"
                         else (plan.reps, 1))
    if groups > 1 and per_group > 1:
        inner = [_remat(f, config) for f in supers]

        def group(fns, x, aux):
            for f in fns:
                x, aux = f(x, aux)
            return x, aux

        for g in range(groups):
            x, aux = _remat(functools.partial(
                group, inner[g * per_group:(g + 1) * per_group]),
                config)(x, aux)
    else:
        for f in supers:
            x, aux = _remat(f, config)(x, aux)
    return _run_blocks(layers[plan.reps * P:], config, positions, x, aux)


def model_fwd(params: Model, batch: dict, config: ModelConfig):
    """Training/scoring forward.  batch: {"tokens": (B, S) int64}.  Returns
    (hidden (B, S, D) after the final norm, aux loss scalar).  Dense
    blocks only: the recurrent kinds are served, not trained."""
    check_ported(config, training=True)
    tokens = batch["tokens"]
    B, S = tokens.shape
    x = _embed_tokens(params, tokens, config)
    pos = torch.arange(S, dtype=torch.int32, device=x.device)[None] \
        .expand(B, S)
    x, aux = stack_fwd(params.layers, x, config, pos)
    return apply_norm(params.final_norm, x, config), aux


def logits_fn(params: Model, hidden):
    """(B, S, D) -> (B, S, V) logits in the hidden states' type."""
    return matmul(hidden, params.lm_head)
