"""Model / shape / mesh configuration schema.

One ``<arch>.py`` per assigned architecture instantiates :class:`ModelConfig`
with the exact published hyperparameters (see the per-file source notes).
``reduced()`` derives the family-preserving small config used by the CPU
smoke tests; full configs are only ever touched abstractly (eval_shape /
dry-run).
"""

from __future__ import annotations

import dataclasses
from typing import Literal, Sequence

Family = Literal["dense", "moe", "hybrid", "ssm", "encdec", "vlm"]


@dataclasses.dataclass(frozen=True)
class LayerKind:
    """Per-layer structural descriptor inside the repeating pattern."""

    kind: str                 # dense | moe | rglru | rwkv | enc | encdec
    attn: str = "causal"      # causal | window | chunk | bidir
    window: int = 0           # window/chunk size when attn in {window,chunk}
    use_rope: bool = True     # False: NoPE layer (llama4 iRoPE global layers)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: Family
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0                  # 0 -> d_model // n_heads
    pattern: tuple[LayerKind, ...] = (LayerKind("dense"),)
    norm: str = "rms"                  # rms | ln
    activation: str = "silu"
    gated_mlp: bool = True
    qk_norm: bool = False
    rope_theta: float = 10000.0
    rope_theta_global: float = 0.0     # local:global archs: global-layer theta
    positional: str = "rope"           # rope | learned (whisper)
    max_position: int = 0              # learned-positional table size
    logit_softcap: float = 0.0
    scale_embed: bool = False          # gemma-style sqrt(d_model) embed scale
    tie_embeddings: bool = False
    # --- MoE ---
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    moe_group_size: int = 256
    # --- ssm / hybrid ---
    rnn_width: int = 0                 # rg-lru recurrent width
    conv_width: int = 4
    rwkv_head_dim: int = 64
    rwkv_chunk: int = 32
    # --- encoder-decoder ---
    n_enc_layers: int = 0
    enc_seq: int = 0                   # fixed encoder length (whisper: 1500)
    # --- vlm ---
    n_img_tokens: int = 0
    # --- training-time defaults (annealable knobs) ---
    remat: str = "block"               # none | block | full
    layout: str = "megatron"           # megatron | fsdp (runtime/partitioning)
    microbatches: dict[str, int] = dataclasses.field(default_factory=dict)
    opt_state_dtype: str = "float32"   # float32 | bfloat16 (llama4: bf16)
    grad_accum_dtype: str = "float32"  # microbatch accumulator dtype
    z_loss: float = 0.0
    # --- serving ---
    supports_long_context: bool = False  # runs the long_500k shape
    notes: str = ""

    def __post_init__(self) -> None:
        if self.head_dim == 0 and self.n_heads > 0:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)
        if self.rnn_width == 0 and any(k.kind == "rglru" for k in self.pattern):
            object.__setattr__(self, "rnn_width", self.d_model)
        if self.rope_theta_global == 0.0:
            object.__setattr__(self, "rope_theta_global", self.rope_theta)
        if self.n_layers % len(self.pattern) not in (0,) and self.family != "encdec":
            # remainder layers are allowed; they become the unscanned tail
            pass

    # -- derived --
    @property
    def layers(self) -> tuple[LayerKind, ...]:
        """The full per-layer kind list (pattern tiled over n_layers)."""
        p = self.pattern
        reps = self.n_layers // len(p)
        rem = self.n_layers % len(p)
        return p * reps + p[:rem]

    def param_count(self) -> int:
        """Exact logical (unpadded) parameter count — MODEL_FLOPS basis."""
        D, F, V = self.d_model, self.d_ff, self.vocab
        hd = self.head_dim
        total = V * D * (1 if self.tie_embeddings else 2)   # embed + lm_head
        for lk in self.layers:
            if lk.kind in ("dense", "moe", "enc", "encdec"):
                attn = D * hd * (self.n_heads * 2 + self.n_kv_heads * 2)
                if lk.kind == "encdec":
                    attn *= 2  # self + cross
                total += attn
                if lk.kind == "moe":
                    per = D * F * (3 if self.gated_mlp else 2)
                    total += self.n_experts * per + D * self.n_experts
                else:
                    total += D * F * (3 if self.gated_mlp else 2)
            elif lk.kind == "rglru":
                R = self.rnn_width
                total += D * R * 3 + 2 * R * R + self.conv_width * R
                total += D * F * (3 if self.gated_mlp else 2)
            elif lk.kind == "rwkv":
                total += 5 * D * D            # r/k/v/gate projections + out
                total += 2 * D * 64           # data-dependent decay LoRA
                total += D * F + F * D + D * D  # channel mix
            total += 2 * D  # norms
        # encoder stack + learned positional tables (whisper)
        if self.family == "encdec" and self.n_enc_layers:
            enc_attn = D * hd * (self.n_heads * 2 + self.n_kv_heads * 2)
            enc_mlp = D * F * (3 if self.gated_mlp else 2)
            total += self.n_enc_layers * (enc_attn + enc_mlp + 2 * D)
        if self.positional == "learned":
            total += self.max_position * D + self.enc_seq * D
        return total

    def active_param_count(self) -> int:
        """Active params per token (MoE: top_k of n_experts)."""
        if self.n_experts == 0:
            return self.param_count()
        D, F = self.d_model, self.d_ff
        per_expert = D * F * (3 if self.gated_mlp else 2)
        n_moe_layers = sum(1 for lk in self.layers if lk.kind == "moe")
        inactive = n_moe_layers * (self.n_experts - self.top_k) * per_expert
        return self.param_count() - inactive

    def reduced(self) -> "ModelConfig":
        """Family-preserving small config for CPU smoke tests."""
        pat = self.pattern
        return dataclasses.replace(
            self,
            name=self.name + "-reduced",
            n_layers=max(len(pat), 2 if len(pat) == 1 else len(pat)),
            d_model=128,
            n_heads=4,
            n_kv_heads=min(self.n_kv_heads, 2) if self.n_kv_heads else 0,
            head_dim=32,
            d_ff=256,
            vocab=512,
            rnn_width=128 if self.rnn_width else 0,
            n_experts=min(self.n_experts, 8) if self.n_experts else 0,
            top_k=min(self.top_k, 2) if self.top_k else 0,
            moe_group_size=64,
            n_enc_layers=min(self.n_enc_layers, 2),
            enc_seq=min(self.enc_seq, 32) if self.enc_seq else 0,
            n_img_tokens=min(self.n_img_tokens, 16) if self.n_img_tokens else 0,
            rwkv_head_dim=32,
            rwkv_chunk=8,
            microbatches={},
        )


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One assigned input-shape cell."""

    name: str
    seq_len: int
    global_batch: int
    kind: Literal["train", "prefill", "decode"]


TRAIN_4K = ShapeConfig("train_4k", 4096, 256, "train")
PREFILL_32K = ShapeConfig("prefill_32k", 32768, 32, "prefill")
DECODE_32K = ShapeConfig("decode_32k", 32768, 128, "decode")
LONG_500K = ShapeConfig("long_500k", 524288, 1, "decode")

SHAPES: dict[str, ShapeConfig] = {
    s.name: s for s in (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)
}


def shapes_for(config: ModelConfig) -> list[ShapeConfig]:
    """The shape cells this arch runs (assignment skip rules; DESIGN.md §4)."""
    out = [TRAIN_4K, PREFILL_32K, DECODE_32K]
    if config.supports_long_context:
        out.append(LONG_500K)
    return out
