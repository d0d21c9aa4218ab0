"""phi3-medium-14b — dense GQA transformer.

Source: Phi-3 technical report [arXiv:2404.14219].
40 layers, d_model 5120, 40 heads (GQA kv=10, head_dim 128), d_ff 17920
(SwiGLU), vocab 100352, RoPE.
"""

from .base import LayerKind, ModelConfig

CONFIG = ModelConfig(
    name="phi3-medium-14b",
    family="dense",
    n_layers=40,
    d_model=5120,
    n_heads=40,
    n_kv_heads=10,
    head_dim=128,
    d_ff=17920,
    vocab=100_352,
    pattern=(LayerKind("dense"),),
    activation="silu",
    gated_mlp=True,
    rope_theta=10_000.0,
    remat="block",
    microbatches={"train_4k": 4},
    supports_long_context=False,   # pure full attention -> skip long_500k
    notes="heads 40 -> padded 48 under TP16 (see DESIGN.md sharding)",
)
