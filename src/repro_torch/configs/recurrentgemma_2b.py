"""recurrentgemma-2b — RG-LRU + local attention hybrid, 1 attn : 2 recurrent.

Source: Griffin / RecurrentGemma [arXiv:2402.19427; hf google/recurrentgemma-2b].
26 layers, d_model 2560, 10 heads (MQA kv=1, head_dim 256), d_ff 7680
(GeGLU), vocab 256000, local-attention window 2048, pattern (R, R, A).
"""

from .base import LayerKind, ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-2b",
    family="hybrid",
    n_layers=26,
    d_model=2560,
    n_heads=10,
    n_kv_heads=1,
    head_dim=256,
    d_ff=7680,
    vocab=256_000,
    pattern=(
        LayerKind("rglru"),
        LayerKind("rglru"),
        LayerKind("dense", attn="window", window=2048),
    ),
    activation="gelu",
    gated_mlp=True,
    scale_embed=True,
    tie_embeddings=True,
    rope_theta=10_000.0,
    rnn_width=2560,
    conv_width=4,
    remat="block",
    microbatches={"train_4k": 2},
    supports_long_context=True,   # bounded state: RG-LRU + 2k window
    notes="hybrid RG-LRU; 26 = 8x(R,R,A) + (R,R) remainder tail",
)
