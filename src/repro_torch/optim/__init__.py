"""AdamW and gradient compression on dicts of tensors (the counterpart of
the reference package's ``optim``)."""

from .compression import (
    apply_error_feedback,
    compress_tree,
    compressed_roundtrip,
    dequantize_int8,
    quantize_int8,
)
from .optimizer import (
    AdamWConfig,
    OptState,
    adamw_init,
    adamw_update,
    clip_by_global_norm,
    cosine_schedule,
    global_norm,
)

__all__ = ["AdamWConfig", "OptState", "adamw_init", "adamw_update",
           "apply_error_feedback", "clip_by_global_norm", "compress_tree",
           "compressed_roundtrip", "cosine_schedule", "dequantize_int8",
           "global_norm", "quantize_int8"]
