"""phi-3-vision-4.2b — phi3-mini backbone + CLIP frontend (STUBBED: the
assignment specifies the transformer backbone only; input_specs provides
576 precomputed patch embeddings prepended to the token stream).

Source: hf microsoft/Phi-3-vision-128k-instruct.
32 layers, d_model 3072, 32 heads (kv=32, head_dim 96), d_ff 8192 (SwiGLU),
vocab 32064.
"""

from .base import LayerKind, ModelConfig

CONFIG = ModelConfig(
    name="phi-3-vision-4.2b",
    family="vlm",
    n_layers=32,
    d_model=3072,
    n_heads=32,
    n_kv_heads=32,
    head_dim=96,
    d_ff=8192,
    vocab=32_064,
    pattern=(LayerKind("dense"),),
    activation="silu",
    gated_mlp=True,
    rope_theta=10_000.0,
    n_img_tokens=576,
    remat="block",
    microbatches={"train_4k": 2},
    supports_long_context=False,   # pure full attention -> skip long_500k
    notes="image frontend stubbed as precomputed (B,576,3072) embeddings",
)
