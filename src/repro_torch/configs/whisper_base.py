"""whisper-base — encoder-decoder; conv audio frontend is a STUB
(input_specs provides precomputed frame embeddings, per the assignment).

Source: Whisper [arXiv:2212.04356].
6+6 layers, d_model 512, 8 heads (head_dim 64), d_ff 2048 (plain GeLU MLP),
vocab 51865, LayerNorm, learned positions, encoder length 1500 frames.
"""

from .base import LayerKind, ModelConfig

CONFIG = ModelConfig(
    name="whisper-base",
    family="encdec",
    n_layers=6,                   # decoder layers (assignment: 6L backbone)
    d_model=512,
    n_heads=8,
    n_kv_heads=8,
    head_dim=64,
    d_ff=2048,
    vocab=51_865,
    pattern=(LayerKind("encdec"),),
    norm="ln",
    activation="gelu",
    gated_mlp=False,
    positional="learned",
    max_position=32_768 + 8,      # decode_32k needs a learned table this big
    n_enc_layers=6,
    enc_seq=1500,
    remat="none",
    microbatches={},
    supports_long_context=False,  # full attention; 30 s audio context
    notes="modality frontend stubbed: encoder consumes (B,1500,512) embeddings",
)
