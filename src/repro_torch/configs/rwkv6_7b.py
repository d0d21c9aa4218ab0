"""rwkv6-7b ("Finch") — attention-free, data-dependent-decay linear RNN.

Source: RWKV-6 [arXiv:2404.05892; hf RWKV/rwkv-6-world-7b].
32 layers, d_model 4096, head_dim 64 (64 wkv heads), d_ff 14336, vocab
65536, LayerNorm.
"""

from .base import LayerKind, ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-7b",
    family="ssm",
    n_layers=32,
    d_model=4096,
    n_heads=0,                    # attention-free
    n_kv_heads=0,
    head_dim=64,
    d_ff=14336,
    vocab=65_536,
    pattern=(LayerKind("rwkv"),),
    norm="ln",
    activation="relu2",
    gated_mlp=False,
    rwkv_head_dim=64,
    rwkv_chunk=32,
    remat="block",
    microbatches={"train_4k": 2},
    supports_long_context=True,   # O(1) recurrent state
)
