"""Hand-written CUDA kernels for Hopper, with their plain PyTorch versions.

``ops`` holds the public wrappers (kernel on CUDA tensors, plain version
on CPU tensors), ``ref`` the plain versions, ``build`` the nvcc + ctypes
loader, ``csrc/`` the CUDA C++ sources.
"""

from .ops import (
    LAUNCHES,
    anneal_walk,
    flash_attention,
    flash_attention_bwd,
    flash_attention_trainable,
    flash_decode,
    fused_interp,
    pairwise_sqdist,
    quantize_int8,
    reset_launches,
    rglru_scan,
    sizing_latency,
    wkv6,
)

__all__ = ["LAUNCHES", "anneal_walk", "flash_attention",
           "flash_attention_bwd", "flash_attention_trainable", "flash_decode", "fused_interp",
           "pairwise_sqdist", "quantize_int8", "reset_launches",
           "rglru_scan", "sizing_latency", "wkv6"]
