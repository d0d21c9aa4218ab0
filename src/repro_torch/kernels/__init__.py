"""Hand-written CUDA kernels for Hopper, with their plain PyTorch versions.

``ops`` holds the public wrappers (kernel on CUDA tensors, plain version
on CPU tensors), ``ref`` the plain versions, ``build`` the nvcc + ctypes
loader, ``csrc/`` the CUDA C++ sources.
"""

from .ops import (
    LAUNCHES,
    flash_attention,
    flash_attention_bwd,
    flash_attention_trainable,
    flash_decode,
    fused_interp,
    quantize_int8,
    reset_launches,
    sizing_latency,
)

__all__ = ["LAUNCHES", "flash_attention", "flash_attention_bwd",
           "flash_attention_trainable", "flash_decode", "fused_interp",
           "quantize_int8", "reset_launches", "sizing_latency"]
