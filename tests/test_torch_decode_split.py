"""How ``flash_decode``'s card kernel cuts the cache into splits.

``ops.decode_split`` is pure Python: the wrapper calls it before the two
launches, and the kernel takes its answer as given (it only refuses a
split length that is not a multiple of 32 or above 128).  So what the
card relies on is held here, on the CPU: enough blocks to fill the card at
the serve paths' shapes, every split non-empty, the splits covering the
cache exactly, and each split's rows fitting the block's shared memory.
"""

import numpy as np
import pytest

from repro_torch.kernels import ops

SERVE_W = 512 + 16 + 1          # chip_smoke.py's cache: prompt + new + 1


def _check_plan(B, W, K, G, hd, itemsize):
    n, L = ops.decode_split(B, W, K, G, hd, itemsize)
    assert L % 32 == 0 and 32 <= L <= 128
    assert (n - 1) * L < W <= n * L          # non-empty, covers W exactly
    HD = 64 if hd <= 64 else 128 if hd <= 128 else 256
    gc = 1
    while gc < G and gc < 1024 // HD:
        gc *= 2
    gp = -(-G // gc) * gc
    # launch 2's shared memory (the larger): rows, weights, sums
    smem = L * HD * itemsize + 4 * (L * gp + 4 * gc * HD + 3 * gp)
    assert smem <= 74 * 1024
    return n, L


@pytest.mark.parametrize("label,B,W,K,G,hd", [
    ("path C step (qwen3-8b)", 16, SERVE_W, 8, 4, 128),
    ("path E step (recurrentgemma-2b)", 16, SERVE_W, 1, 10, 256),
    ("DECODE_32K, batch 32", 32, 32768, 8, 4, 128)])
def test_decode_split_fills_the_card_at_the_path_shapes(label, B, W, K, G,
                                                        hd):
    n, L = _check_plan(B, W, K, G, hd, 2)
    assert B * K * n >= ops.DECODE_MIN_BLOCKS == 264, label


def test_decode_split_at_the_path_shapes_is_what_the_notes_say():
    """The counts the kernel's source note and PERF.md quote."""
    assert ops.decode_split(16, SERVE_W, 8, 4, 128, 2) == (5, 128)
    assert ops.decode_split(16, SERVE_W, 1, 10, 256, 2) == (17, 32)
    assert ops.decode_split(32, 32768, 8, 4, 128, 2) == (256, 128)


@pytest.mark.parametrize("itemsize", [2, 4])
@pytest.mark.parametrize("hd", [32, 64, 96, 128, 200, 256])
def test_decode_split_covers_any_cache(itemsize, hd):
    rng = np.random.default_rng(hd + itemsize)
    for _ in range(200):
        B, K = int(rng.integers(1, 40)), int(rng.integers(1, 9))
        G = int(rng.integers(1, 17))
        W = int(rng.integers(1, 40000))
        n, L = _check_plan(B, W, K, G, hd, itemsize)
        if W >= 32 * -(-ops.DECODE_MIN_BLOCKS // (B * K)):
            assert B * K * n >= ops.DECODE_MIN_BLOCKS


@pytest.mark.parametrize("W", [1, 31, 32, 33, 255, 256, 257])
def test_decode_split_small_caches(W):
    n, L = _check_plan(1, W, 1, 1, 64, 2)
    assert L == 32 and n == -(-W // 32)


def test_decode_split_refuses_what_does_not_fit():
    with pytest.raises(ValueError, match="shared memory"):
        ops.decode_split(1, 100, 1, 4096, 256, 4)
