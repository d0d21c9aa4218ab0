"""h2o-danube-3-4b — dense llama/mistral-mix with sliding-window attention.

Source: H2O-Danube [arXiv:2401.16818 lineage; assignment config].
24 layers, d_model 3840, 32 heads (GQA kv=8, head_dim 120), d_ff 10240
(SwiGLU), vocab 32000, SWA window 4096.
"""

from .base import LayerKind, ModelConfig

CONFIG = ModelConfig(
    name="h2o-danube-3-4b",
    family="dense",
    n_layers=24,
    d_model=3840,
    n_heads=32,
    n_kv_heads=8,
    head_dim=120,
    d_ff=10240,
    vocab=32_000,
    pattern=(LayerKind("dense", attn="window", window=4096),),
    activation="silu",
    gated_mlp=True,
    rope_theta=10_000.0,
    remat="block",
    microbatches={"train_4k": 2},
    supports_long_context=True,   # SWA bounds the KV cache to 4096
    notes="window == train seq (4096) -> full causal at train_4k, banded at 32k+",
)
