"""The LM stack for the dense family (the counterpart of the reference
package's ``models``): ``transformer`` holds the weights as ``nn.Module``s
in the reference's layout and runs the training forward, ``decode`` the
prefill and one-token decode traversals over a per-layer KV cache."""

from . import attention, common, decode, mlp, transformer
from .decode import init_cache, model_decode, model_prefill
from .transformer import Model, init_model

__all__ = ["attention", "common", "decode", "mlp", "transformer", "Model",
           "init_cache", "init_model", "model_decode", "model_prefill"]
