"""The port's serve slice against the JAX package's: the dense model's
prefill and decode (reduced qwen3-8b, weights carried across), the serve
engine's queueing, and the annealed serve loop's entry point.

Model outputs are compared at the bf16 tolerance of the JAX kernel tests
(atol 0.03, rtol 0.05).  The reference runs under ``jax.disable_jit()``,
operation by operation, so each jnp operation rounds to bf16 where its
source says: compiled, XLA on the CPU keeps some bf16 intermediates of a
fused computation in float32 (excess precision), which moves logits by up
to two bf16 steps and is no property of the model's code.  Logits are
compared, not argmax tokens: near-ties make token equality a coin toss.
"""

import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import common as jcommon
from repro.models import decode as jdecode
from repro.models import init_model as jax_init_model
from repro.models import split_boxes
from repro.serving import Request as JRequest
from repro.serving import ServeEngine as JServeEngine
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.interop import model_params_from_jax
from repro_torch.kernels import ops
from repro_torch.models import common as pcommon
from repro_torch.models import decode as pdecode
from repro_torch.models import transformer
from repro_torch.runtime.serve import build_decode_step, build_prefill_step
from repro_torch.serving import Request, ServeEngine
from repro_torch.serving.anneal import anneal_serving

BF16_TOL = dict(atol=0.03, rtol=0.05)     # tests/test_kernels.py:17-18
ARCH = "qwen3-8b-reduced"                  # 2 layers, d 128, 4/2 heads x 32


def _np(x):
    a = np.asarray(x)
    return a.astype(np.float32) if a.dtype == ml_dtypes.bfloat16 else a


@pytest.fixture(scope="module")
def models():
    """The reference's random reduced qwen3-8b (tp=1) and the port's model
    holding the same weights."""
    jcfg = jax_get_config(ARCH)
    params, _ = split_boxes(jax_init_model(jax.random.key(0), jcfg, tp=1))
    params = jax.tree.map(np.asarray, params)
    return jcfg, params, model_params_from_jax(params, get_config(ARCH),
                                               device="cpu")


def test_weights_carry_across_exactly(models):
    _, jparams, model = models
    scan = jparams["stack"]["scan"][0]
    assert len(model.layers) == 2
    for r, block in enumerate(model.layers):
        for name in ("wq", "wk", "wv", "wo"):
            got = getattr(block.attn, name)
            assert got.dtype == torch.bfloat16
            np.testing.assert_array_equal(
                got.float().numpy(), _np(scan["attn"][name][r]))
        np.testing.assert_array_equal(block.ffn.w_gate.float().numpy(),
                                      _np(scan["ffn"]["w_gate"][r]))
    np.testing.assert_array_equal(model.embed.float().numpy(),
                                  _np(jparams["embed"]))


def test_prefill_and_teacher_forced_decode_match_reference(models):
    jcfg, jparams, model = models
    cfg = get_config(ARCH)
    B, S, steps = 2, 24, 8
    max_len = S + steps + 1
    tokens = np.random.default_rng(0).integers(0, cfg.vocab, (B, S),
                                               dtype=np.int32)
    with jax.disable_jit():
        jlogits, jcache, _ = jdecode.model_prefill(
            jparams, {"tokens": tokens}, jcfg, max_len)
    prefill = build_prefill_step(cfg, ShapeConfig("t", max_len, B, "decode"),
                                 "cpu")
    decode = build_decode_step(cfg, ShapeConfig("t", max_len, B, "decode"),
                               "cpu")
    logits, cache = prefill(model, {"tokens": tokens})
    np.testing.assert_allclose(logits.float().numpy(), _np(jlogits),
                               **BF16_TOL)
    assert len(cache) == len(jcache["layers"]) == 2
    for c, jc in zip(cache, jcache["layers"]):
        for kv in ("k", "v"):
            assert tuple(c[kv].shape) == jc[kv].shape == (B, max_len, 2, 32)
            np.testing.assert_allclose(c[kv].float().numpy(), _np(jc[kv]),
                                       **BF16_TOL)

    tok = jnp.argmax(jlogits, -1)[:, None].astype(jnp.int32)
    for i in range(steps):
        pos = S + i
        with jax.disable_jit():
            jlogits, jcache = jdecode.model_decode(jparams, jcache, tok,
                                                   jnp.int32(pos), jcfg)
        logits, cache = decode(model, cache, np.asarray(tok), pos)
        np.testing.assert_allclose(logits.float().numpy(), _np(jlogits),
                                   **BF16_TOL)
        tok = jnp.argmax(jlogits, -1)[:, None].astype(jnp.int32)
    for c, jc in zip(cache, jcache["layers"]):
        for kv in ("k", "v"):
            np.testing.assert_allclose(c[kv].float().numpy(), _np(jc[kv]),
                                       **BF16_TOL)


def _bf16(a):
    return torch.from_numpy(a.astype(ml_dtypes.bfloat16).view(np.uint16)) \
        .view(torch.bfloat16)


def test_common_blocks_match_reference():
    """Norms, activations, RoPE, masks and head padding, bit for bit on
    bf16 inputs (float32 math, cast back, at the reference's points)."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 5, 3, 32)).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, 32).astype(np.float32)
    xj = jnp.asarray(x.astype(ml_dtypes.bfloat16))
    xt = _bf16(x)
    pos = np.arange(5, dtype=np.int32)[None] + 7
    pairs = [
        (jcommon.rms_norm(xj, jnp.asarray(scale)),
         pcommon.rms_norm(xt, torch.from_numpy(scale))),
        (jcommon.layer_norm(xj, jnp.asarray(scale), jnp.asarray(scale)),
         pcommon.layer_norm(xt, torch.from_numpy(scale),
                            torch.from_numpy(scale))),
        (jcommon.apply_rope(xj, jnp.asarray(pos), 1e6),
         pcommon.apply_rope(xt, torch.from_numpy(pos), 1e6)),
        (jax.nn.silu(xj), pcommon.ACTIVATIONS["silu"](xt)),
        (jcommon.causal_mask(6, 9, 2), pcommon.causal_mask(6, 9, 2)),
        (jcommon.window_mask(6, 9, 3, 2), pcommon.window_mask(6, 9, 3, 2)),
        (jcommon.chunk_mask(6, 9, 4, 2), pcommon.chunk_mask(6, 9, 4, 2)),
    ]
    for want, got in pairs:
        np.testing.assert_array_equal(
            got.float().numpy() if got.dtype != torch.bool else got.numpy(),
            _np(want))
    assert [pcommon.padded_heads(n, 16) for n in (4, 40, 48)] \
        == [jcommon.padded_heads(n, 16) for n in (4, 40, 48)]


def test_ring_buffer_wraps_like_the_reference():
    """A window layer's ring: prompts longer than W keep their last W
    positions at slots p % W, and the validity mask follows the kind."""
    k = torch.arange(2 * 10 * 1 * 2, dtype=torch.float32).reshape(2, 10, 1, 2)
    ring = pdecode._fill_ring((2, 4, 1, 2), k, 4)
    jring = jdecode._fill_ring((2, 4, 1, 2), jnp.asarray(k.numpy()), 4)
    np.testing.assert_array_equal(ring.float().numpy(), _np(jring))
    for kind in ("causal", "window", "chunk"):
        for pos in (2, 5, 9):
            np.testing.assert_array_equal(
                pdecode._ring_mask(pos, 4, kind).numpy(),
                np.asarray(jdecode._ring_mask(jnp.int32(pos), 4, kind)))


def test_decode_writes_the_cache_in_place(models):
    _, _, model = models
    cfg = get_config(ARCH)
    shape = ShapeConfig("t", 12, 1, "decode")
    logits, cache = build_prefill_step(cfg, shape, "cpu")(
        model, {"tokens": np.ones((1, 8), np.int32)})
    buffers = [c["k"].data_ptr() for c in cache]
    assert torch.count_nonzero(cache[0]["k"][:, 8]) == 0
    _, cache2 = build_decode_step(cfg, shape, "cpu")(
        model, cache, np.ones((1, 1), np.int32), 8)
    assert cache2 is cache
    assert [c["k"].data_ptr() for c in cache] == buffers
    assert torch.count_nonzero(cache[0]["k"][:, 8]) > 0


def test_tp_padded_tree_is_refused():
    jcfg = jax_get_config(ARCH)
    params, _ = split_boxes(jax_init_model(jax.random.key(1), jcfg, tp=8))
    with pytest.raises(ValueError, match="tp=1"):
        model_params_from_jax(jax.tree.map(np.asarray, params),
                              get_config(ARCH), device="cpu")


@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "whisper-base",
                                  "phi-3-vision-4.2b"])
def test_unported_families_raise(arch):
    cfg = get_config(arch).reduced()
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        transformer.init_model(torch.Generator().manual_seed(0), cfg)


def test_init_cache_matches_reference_layout():
    jcfg, cfg = jax_get_config(ARCH), get_config(ARCH)
    jcache = jdecode.init_cache(jcfg, 3, 20)
    cache = pdecode.init_cache(cfg, 3, 20, device="cpu")
    assert len(cache) == len(jcache["layers"]) + len(jcache["tail"])
    for c, jc in zip(cache, jcache["layers"]):
        for kv in ("k", "v"):
            assert tuple(c[kv].shape) == jc[kv].value.shape
            assert c[kv].dtype == torch.bfloat16
            assert torch.count_nonzero(c[kv]) == 0


def test_steps_refuse_parameters_on_another_device(models):
    cfg = get_config(ARCH)
    shape = ShapeConfig("t", 8, 1, "decode")
    with pytest.raises(ValueError, match="parameters lie on cpu"):
        build_prefill_step(cfg, shape, "meta")(
            models[2], {"tokens": np.ones((1, 4), np.int32)})


def test_entry_points_default_to_the_card(models):
    cfg = get_config(ARCH)
    shape = ShapeConfig("t", 8, 1, "decode")
    if torch.cuda.is_available():
        build_prefill_step(cfg, shape)
        assert pdecode.init_cache(cfg, 1, 8)[0]["k"].is_cuda
        return
    for build in (build_prefill_step, build_decode_step):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            build(cfg, shape)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        anneal_serving(cfg, rounds=1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pdecode.init_cache(cfg, 1, 8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        model_params_from_jax(models[1], cfg)


# ---------------------------------------------------------------------------
# The engine, on a scripted clock with plain-closure steps.
# ---------------------------------------------------------------------------


class _Clock:
    """Time advances by 1 s at every reading."""

    def __init__(self):
        self.t = 0.0

    def __call__(self):
        self.t += 1.0
        return self.t


def _steps(xp, seen):
    """Prefill/decode closures over a vocab of 7: the logits pick token
    (sum of the row's prompt + pos) % 7, so each token depends on what the
    engine passed in.  ``seen`` records the prompt batches."""

    def onehot(ids):
        return np.eye(7, dtype=np.float32)[np.asarray(ids) % 7]

    def prefill(params, batch):
        toks = np.asarray(batch["tokens"])
        seen.append(toks.copy())
        return xp(onehot(toks.sum(1))), {"pos": []}

    def decode(params, cache, tokens, pos):
        cache["pos"].append(int(pos))
        return xp(onehot(np.asarray(tokens)[:, 0] + int(pos))), cache

    return prefill, decode


def _requests(cls):
    return [cls(rid=i, prompt=np.arange(1, 2 + 3 * i, dtype=np.int32),
                max_new=2 + i % 3) for i in range(5)]


def test_engine_pads_batches_and_counts_sojourn():
    seen = []
    pre, dec = _steps(torch.from_numpy, seen)
    eng = ServeEngine(None, pre, dec, max_batch=2, prompt_len=6,
                      clock=_Clock())
    for r in _requests(Request):
        eng.submit(r)
    results = eng.drain()
    assert [b.shape for b in seen] == [(2, 6)] * 3     # padded to max_batch
    # left-padded with zeros; a prompt longer than 6 keeps its last 6
    np.testing.assert_array_equal(seen[0][0], [0, 0, 0, 0, 0, 1])
    np.testing.assert_array_equal(seen[0][1], [0, 0, 1, 2, 3, 4])
    np.testing.assert_array_equal(seen[1][1], [5, 6, 7, 8, 9, 10])
    np.testing.assert_array_equal(seen[2][0], [8, 9, 10, 11, 12, 13])
    np.testing.assert_array_equal(seen[2][1], 0)        # the empty slot
    assert [r.rid for r in results] == [0, 1, 2, 3, 4]
    assert [len(r.tokens) for r in results] == [2, 3, 4, 2, 3]
    for r in results:
        assert r.sojourn_s >= r.finish_s - r.start_s > 0
        assert r.queue_s >= 0
    assert results[4].start_s > results[2].finish_s     # served in order
    assert eng.mean_sojourn_s() == pytest.approx(
        np.mean([r.sojourn_s for r in results]))


def test_engine_matches_reference_engine():
    """Same requests, same scripted clock, same closures: the JAX engine
    and the port's give the same batches, tokens and sojourns."""
    out = {}
    for name, eng_cls, req_cls, xp in (
            ("jax", JServeEngine, JRequest, jnp.asarray),
            ("torch", ServeEngine, Request, torch.from_numpy)):
        seen = []
        pre, dec = _steps(xp, seen)
        eng = eng_cls(None, pre, dec, max_batch=2, prompt_len=6,
                      clock=_Clock())
        for r in _requests(req_cls):
            eng.submit(r)
        res = eng.drain()
        out[name] = (seen, [(r.rid, r.tokens.tolist(), r.arrival_s,
                             r.start_s, r.finish_s) for r in res],
                     eng.mean_sojourn_s(), eng.p99_sojourn_s())
    (seen_j, res_j, mean_j, p99_j), (seen_t, res_t, mean_t, p99_t) = \
        out["jax"], out["torch"]
    assert len(seen_j) == len(seen_t)
    for a, b in zip(seen_j, seen_t):
        np.testing.assert_array_equal(a, b)
    assert res_j == res_t
    assert (mean_j, p99_j) == (mean_t, p99_t)


def test_anneal_serving_runs_on_the_cpu():
    cfg = dataclasses.replace(get_config(ARCH), n_layers=1)
    rounds = []
    before = dict(ops.LAUNCHES)
    out = anneal_serving(cfg, device="cpu", prompt_len=12, max_new=3,
                         requests=5, rounds=3, on_round=rounds.append)
    assert [r["round"] for r in out["rounds"]] == [0, 1, 2] and rounds
    for r in out["rounds"]:
        assert r["batch"] in (1, 2, 4, 8, 16)
        assert r["tokens_ok"] and r["mean_sojourn_s"] > 0
        assert r["batches"] == -(-5 // r["batch"])
        assert r["decode_steps"] == 2 * r["batches"]
    assert ops.LAUNCHES == before          # the CPU runs the plain versions
    assert out["best_batch"] in (1, 2, 4, 8, 16)
