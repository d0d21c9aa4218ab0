"""Device selection shared by every entry point of the package.

Entry points take an explicit ``device`` (default ``"cuda"``).  Asking for
the card where there is none is an error, never a silent move to the CPU:
the CPU path exists for tests and small runs, and callers ask for it by
name (``device="cpu"``).
"""

from __future__ import annotations

import numpy as np
import torch


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """``device`` as a :class:`torch.device`; raises when it names CUDA
    and no card is visible."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device='cuda' requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run the plain PyTorch path")
    return dev


def generator(seed: int, *stream: int,
              device: str | torch.device = "cpu") -> torch.Generator:
    """A :class:`torch.Generator` on ``device`` whose state depends only on
    ``(seed, *stream)`` — the counterpart of ``jax.random.fold_in`` chains
    (e.g. ``generator(seed, round)`` for one control round)."""
    words = np.random.SeedSequence([int(seed), *map(int, stream)]) \
        .generate_state(2, np.uint32)
    g = torch.Generator(device=torch.device(device))
    g.manual_seed((int(words[0]) << 31) ^ int(words[1]))
    return g
