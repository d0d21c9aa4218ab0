"""repro-100m — the in-house ~100M-parameter LM for the end-to-end
training example (deliverable (b): train a ~100M model for a few hundred
steps on the synthetic pipeline).

12L d_model=768 12H (MHA) d_ff=3072 vocab=32768 — GPT-2-small-class
with the modern defaults of this framework (RMSNorm, SwiGLU, RoPE).
~104M params (85M non-embedding).
"""

from .base import LayerKind, ModelConfig

CONFIG = ModelConfig(
    name="repro-100m",
    family="dense",
    n_layers=12,
    d_model=768,
    n_heads=12,
    n_kv_heads=12,
    head_dim=64,
    d_ff=3072,
    vocab=32_768,
    pattern=(LayerKind("dense"),),
    activation="silu",
    gated_mlp=True,
    rope_theta=10_000.0,
    remat="none",
    supports_long_context=False,
)
