"""gemma3-27b — dense GQA with 5:1 local:global attention, 128k context.

Source: Gemma 3 [hf google/gemma-3-27b-pt family; assignment config].
62 layers, d_model 5376, 32 heads (GQA kv=16, head_dim 128 per the public
config), d_ff 21504 (GeGLU), vocab 262144, local window 1024 on 5 of every
6 layers, global layers use rope theta 1M; qk-norm.
"""

from .base import LayerKind, ModelConfig

CONFIG = ModelConfig(
    name="gemma3-27b",
    family="dense",
    n_layers=62,
    d_model=5376,
    n_heads=32,
    n_kv_heads=16,
    head_dim=128,
    d_ff=21504,
    vocab=262_144,
    pattern=(
        LayerKind("dense", attn="window", window=1024),
        LayerKind("dense", attn="window", window=1024),
        LayerKind("dense", attn="window", window=1024),
        LayerKind("dense", attn="window", window=1024),
        LayerKind("dense", attn="window", window=1024),
        LayerKind("dense", attn="causal"),
    ),
    activation="gelu",
    gated_mlp=True,
    qk_norm=True,
    scale_embed=True,
    tie_embeddings=True,
    rope_theta=10_000.0,
    rope_theta_global=1_000_000.0,
    remat="block",
    microbatches={"train_4k": 8},
    supports_long_context=True,   # 5:1 local; global KV seq-sharded at 500k
    notes="62 = 10x(5L+G) + (L,L) remainder tail",
)
