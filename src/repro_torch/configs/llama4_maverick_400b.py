"""llama4-maverick-400b-a17b — MoE 128 experts top-1 on alternating layers,
chunked local attention with periodic global (iRoPE-style) layers.

Source: Llama 4 [hf meta-llama/Llama-4-Maverick family; assignment config].
48 layers, d_model 5120, 40 heads (GQA kv=8, head_dim 128), expert d_ff
8192 (SwiGLU), vocab 202048, MoE every other layer (24 MoE layers ~= 396B
total / ~17B active), attention chunked at 8192 with every 4th layer
global.  Optimizer state is kept in bf16 so the 400B model fits 16 GB/chip
HBM on the 256-chip pod (DESIGN.md sharding design).
"""

from .base import LayerKind, ModelConfig

CONFIG = ModelConfig(
    name="llama4-maverick-400b-a17b",
    family="moe",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab=202_048,
    pattern=(
        LayerKind("dense", attn="chunk", window=8192),
        LayerKind("moe", attn="chunk", window=8192),
        LayerKind("dense", attn="chunk", window=8192),
        LayerKind("moe", attn="causal", use_rope=False),  # global iRoPE layer
    ),
    activation="silu",
    gated_mlp=True,
    rope_theta=500_000.0,
    n_experts=128,
    top_k=1,
    capacity_factor=1.25,
    moe_group_size=1024,   # slot overprovision E*C/(s*k) = 1.25 (sec. Perf)
    remat="full",
    microbatches={"train_4k": 16},
    opt_state_dtype="bfloat16",
    grad_accum_dtype="bfloat16",   # fp32 expert accumulators don't fit HBM
    supports_long_context=True,    # chunked local attention bounds most layers
    notes="heads 40 -> padded 48 under TP16; MoE interleave 1:1",
)
