"""qwen3-8b — dense GQA transformer with qk-norm.

Source: hf Qwen/Qwen3-8B.
36 layers, d_model 4096, 32 heads (GQA kv=8, head_dim 128), d_ff 12288
(SwiGLU), vocab 151936, RoPE theta 1e6, qk-norm.
"""

from .base import LayerKind, ModelConfig

CONFIG = ModelConfig(
    name="qwen3-8b",
    family="dense",
    n_layers=36,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=12288,
    vocab=151_936,
    pattern=(LayerKind("dense"),),
    activation="silu",
    gated_mlp=True,
    qk_norm=True,
    rope_theta=1_000_000.0,
    remat="block",
    layout="fsdp",                # sec. Perf hillclimb: 13.0s -> 2.5s step
    microbatches={"train_4k": 1}, # fsdp: batch 256 = one row per chip
    grad_accum_dtype="bfloat16",
    supports_long_context=False,   # pure full attention -> skip long_500k
)
