"""olmoe-1b-7b — MoE, 64 experts top-8, every layer MoE.

Source: OLMoE [arXiv:2409.02060; hf allenai/OLMoE-1B-7B-0924].
16 layers, d_model 2048, 16 heads (kv=16, head_dim 128), expert d_ff 1024
(SwiGLU), vocab 50304, qk-norm.
"""

from .base import LayerKind, ModelConfig

CONFIG = ModelConfig(
    name="olmoe-1b-7b",
    family="moe",
    n_layers=16,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    head_dim=128,
    d_ff=1024,
    vocab=50_304,
    pattern=(LayerKind("moe"),),
    activation="silu",
    gated_mlp=True,
    qk_norm=True,
    rope_theta=10_000.0,
    n_experts=64,
    top_k=8,
    capacity_factor=1.25,
    moe_group_size=256,
    remat="block",
    microbatches={"train_4k": 2},
    supports_long_context=False,   # pure full attention -> skip long_500k
)
