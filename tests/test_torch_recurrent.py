"""The port's recurrent families against the JAX package's: the Griffin
recurrent block (recurrentgemma-2b) and RWKV-6's time and channel mix
(rwkv6-7b), block by block and as whole reduced models through prefill and
teacher-forced decode, with the reference's weights carried across; the
serve loop on both; and what the port refuses for them.

The reference runs under ``jax.disable_jit()``, operation by operation (as
in tests/test_torch_serve.py), and takes its parameters as JAX arrays: fed
numpy arrays, its ``_mix`` computes ``1.0 - mu`` in numpy, which promotes
the bf16 mixing weights to float32 and changes every later rounding.  In
bf16 the models agree at the JAX kernel tests' bf16 tolerance (they are in
fact bit-equal but for the recurrences' float32 summation order); with
float32 weights at the float32 tolerance.
"""

import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import decode as jdecode
from repro.models import init_model as jax_init_model
from repro.models import rglru as jrglru
from repro.models import rwkv6 as jrwkv
from repro.models import split_boxes
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.interop import model_params_from_jax
from repro_torch.kernels import ops
from repro_torch.models import decode as pdecode
from repro_torch.models import rglru as prglru
from repro_torch.models import rwkv6 as prwkv
from repro_torch.models import transformer
from repro_torch.runtime.serve import build_decode_step, build_prefill_step
from repro_torch.runtime.train import build_train_step
from repro_torch.serving.anneal import anneal_serving

BF16_TOL = dict(atol=0.03, rtol=0.05)     # tests/test_kernels.py:17-18
F32_TOL = dict(atol=2e-5, rtol=1e-4)
ARCHS = ["recurrentgemma-2b-reduced",      # 3 layers (R, R, A), d 128
         "rwkv6-7b-reduced"]               # 2 layers, d 128, 4 heads x 32


def _np(x):
    a = np.asarray(x)
    return a.astype(np.float32) if a.dtype == ml_dtypes.bfloat16 else a


def _tol(dtype):
    return BF16_TOL if dtype in (torch.bfloat16, "bfloat16") else F32_TOL


def _reference(arch, dtype="bfloat16"):
    """(JAX config, the reference's random params (tp=1) as JAX arrays,
    the port's model on the CPU holding the same weights); with
    ``dtype="float32"`` every weight is cast to float32 on both sides."""
    jcfg = jax_get_config(arch)
    params, _ = split_boxes(jax_init_model(jax.random.key(0), jcfg, tp=1))
    params = jax.tree.map(np.asarray, params)
    if dtype == "float32":
        params = jax.tree.map(lambda a: a.astype(np.float32), params)
    model = model_params_from_jax(params, get_config(arch), device="cpu")
    return jcfg, jax.tree.map(jnp.asarray, params), model


@pytest.fixture(scope="module", params=ARCHS)
def reduced(request):
    return (request.param, *_reference(request.param))


def _layer0(params, part):
    return jax.tree.map(lambda t: t[0], params["stack"]["scan"][0][part])


def _bf16(a):
    return torch.from_numpy(np.asarray(a).astype(ml_dtypes.bfloat16)
                            .view(np.uint16)).view(torch.bfloat16)


def test_weights_carry_across_exactly(reduced):
    arch, _, jparams, model = reduced
    scan = jparams["stack"]["scan"]
    block = model.layers[0]
    part = "rec" if arch.startswith("recurrentgemma") else "time"
    tree = jax.tree.map(lambda t: t[0], scan[0][part])
    mod = getattr(block, part)
    for name in mod.NAMES:
        got = getattr(mod, name)
        assert got.dtype == {"bfloat16": torch.bfloat16,
                             "float32": torch.float32}[str(tree[name].dtype)]
        np.testing.assert_array_equal(got.float().numpy(), _np(tree[name]))
    if part == "time":
        for name in prwkv.RWKVChannel.NAMES:
            np.testing.assert_array_equal(
                getattr(block.chan, name).float().numpy(),
                _np(scan[0]["chan"][name][0]))
        # LayerNorm: scale and bias, per block and final
        np.testing.assert_array_equal(block.ln1.bias.numpy(),
                                      _np(scan[0]["ln1"]["bias"][0]))
        np.testing.assert_array_equal(model.final_norm.bias.numpy(),
                                      _np(jparams["final_norm"]["bias"]))
    else:
        assert [b.kind.kind for b in model.layers] == ["rglru", "rglru",
                                                       "dense"]


def test_rglru_block_prefill_and_step_match_reference():
    _, jparams, model = _reference("recurrentgemma-2b-reduced")
    jp, rec = _layer0(jparams, "rec"), model.layers[0].rec
    spec = prglru.RGLRUSpec(d_model=128, d_rnn=128, conv_width=4)
    jspec = jrglru.RGLRUSpec(d_model=128, d_rnn=128, conv_width=4)
    rng = np.random.default_rng(1)
    for S in (2, 24):                  # a prompt shorter than the conv
        x = rng.standard_normal((2, S, 128)).astype(ml_dtypes.bfloat16)
        with jax.disable_jit():
            jout, jstate = jrglru.rglru_block_prefill(jp, jnp.asarray(x),
                                                      jspec)
        out, state = prglru.rglru_block_prefill(rec, _bf16(x), spec)
        np.testing.assert_allclose(out.float().numpy(), _np(jout), **BF16_TOL)
        np.testing.assert_allclose(state["h"].numpy(), _np(jstate["h"]),
                                   **F32_TOL)
        assert state["conv"].dtype == torch.bfloat16
        np.testing.assert_array_equal(state["conv"].float().numpy(),
                                      _np(jstate["conv"]))
    for _ in range(3):
        x_t = rng.standard_normal((2, 128)).astype(ml_dtypes.bfloat16)
        with jax.disable_jit():
            jout, jstate = jrglru.rglru_block_step(jp, jnp.asarray(x_t),
                                                   jstate)
        out, state = prglru.rglru_block_step(rec, _bf16(x_t), state)
        np.testing.assert_allclose(out.float().numpy(), _np(jout), **BF16_TOL)
        np.testing.assert_allclose(state["h"].numpy(), _np(jstate["h"]),
                                   **F32_TOL)
        np.testing.assert_array_equal(state["conv"].float().numpy(),
                                      _np(jstate["conv"]))


def test_rglru_scan_with_state_matches_the_associative_scan():
    """The prefill's recurrence (through ``ops.rglru_scan``, the sequential
    plain version on the CPU) against the reference's associative scan,
    float32 inputs: outputs and final state at atol 1e-5 / rtol 1e-4."""
    _, jparams, model = _reference("recurrentgemma-2b-reduced", "float32")
    jp, rec = _layer0(jparams, "rec"), model.layers[0].rec
    x = np.random.default_rng(2).standard_normal((3, 40, 128)) \
        .astype(np.float32)
    with jax.disable_jit():
        jh, jlast = jrglru.rg_lru_scan_with_state(jp, jnp.asarray(x))
    h, last = prglru.rg_lru_scan_with_state(rec, torch.from_numpy(x))
    np.testing.assert_allclose(h.numpy(), _np(jh), atol=1e-5, rtol=1e-4)
    np.testing.assert_allclose(last.numpy(), _np(jlast), atol=1e-5,
                               rtol=1e-4)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_rwkv_time_and_channel_match_reference(dtype):
    _, jparams, model = _reference("rwkv6-7b-reduced", dtype)
    jt, jc = _layer0(jparams, "time"), _layer0(jparams, "chan")
    block = model.layers[0]
    spec = prwkv.RWKV6Spec(d_model=128, head_dim=32, d_ff=256, chunk=8)
    jspec = jrwkv.RWKV6Spec(d_model=128, head_dim=32, d_ff=256, chunk=8)
    rng = np.random.default_rng(3)
    npt = ml_dtypes.bfloat16 if dtype == "bfloat16" else np.float32
    conv = _bf16 if dtype == "bfloat16" else torch.from_numpy

    def same(got, want, tol):
        np.testing.assert_allclose(got.float().numpy(), _np(want), **tol)

    x = rng.standard_normal((2, 16, 128)).astype(npt)
    with jax.disable_jit():
        jto, jts = jrwkv.rwkv_time_prefill(jt, jnp.asarray(x), jspec)
        jco, jcs = jrwkv.rwkv_channel_prefill(jc, jnp.asarray(x))
    to, ts = prwkv.rwkv_time_prefill(block.time, conv(x), spec)
    co, cs = prwkv.rwkv_channel_prefill(block.chan, conv(x))
    same(to, jto, _tol(dtype))
    same(co, jco, _tol(dtype))
    same(ts["S"], jts["S"], dict(atol=5e-4, rtol=1e-3))
    same(ts["shift"], jts["shift"], dict(atol=0, rtol=0))
    same(cs["shift"], jcs["shift"], dict(atol=0, rtol=0))
    for _ in range(3):
        x_t = rng.standard_normal((2, 128)).astype(npt)
        with jax.disable_jit():
            jto, jts = jrwkv.rwkv_time_step(jt, jnp.asarray(x_t), jts, jspec)
            jco, jcs = jrwkv.rwkv_channel_step(jc, jnp.asarray(x_t), jcs)
        to, ts = prwkv.rwkv_time_step(block.time, conv(x_t), ts, spec)
        co, cs = prwkv.rwkv_channel_step(block.chan, conv(x_t), cs)
        same(to, jto, _tol(dtype))
        same(co, jco, _tol(dtype))
        same(ts["S"], jts["S"], dict(atol=5e-4, rtol=1e-3))


def test_rwkv_prefill_needs_whole_chunks():
    _, _, model = _reference("rwkv6-7b-reduced")
    spec = prwkv.RWKV6Spec(d_model=128, head_dim=32, d_ff=256, chunk=8)
    with pytest.raises(ValueError, match="multiple of 8"):
        prwkv.rwkv_time_prefill(model.layers[0].time,
                                torch.zeros((1, 12, 128),
                                            dtype=torch.bfloat16), spec)


def _state_tol(t):
    return F32_TOL if t.dtype == torch.float32 else BF16_TOL


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_teacher_forced_decode_match_reference(arch, dtype):
    """Whole reduced models: logits after the prefill and after each of 6
    teacher-forced decode steps, and every layer's cache (recurrent states
    at the tolerance of their type, attention caches too).  The
    reference's attention caches are bf16 whatever the weights' type; the
    port's hold k/v in their own type, so with float32 weights its caches
    are cast to bf16 after the prefill, as the reference's are."""
    jcfg, jparams, model = _reference(arch, dtype)
    cfg = get_config(arch)
    B, S, steps = 2, 16, 6
    max_len = S + steps + 1
    shape = ShapeConfig("t", max_len, B, "decode")
    tokens = np.random.default_rng(4).integers(0, cfg.vocab, (B, S),
                                               dtype=np.int32)
    with jax.disable_jit():
        jlogits, jcache, _ = jdecode.model_prefill(
            jparams, {"tokens": tokens}, jcfg, max_len)
    logits, cache = build_prefill_step(cfg, shape, "cpu")(
        model, {"tokens": tokens})
    tol = _tol(dtype)
    np.testing.assert_allclose(logits.float().numpy(), _np(jlogits), **tol)
    for c in cache:
        for name in ("k", "v"):
            if name in c:
                c[name] = c[name].to(torch.bfloat16)
    decode = build_decode_step(cfg, shape, "cpu")
    tok = jnp.argmax(jlogits, -1)[:, None].astype(jnp.int32)
    for i in range(steps):
        with jax.disable_jit():
            jlogits, jcache = jdecode.model_decode(jparams, jcache, tok,
                                                   jnp.int32(S + i), jcfg)
        logits, cache = decode(model, cache, np.asarray(tok), S + i)
        np.testing.assert_allclose(logits.float().numpy(), _np(jlogits),
                                   **tol)
        tok = jnp.argmax(jlogits, -1)[:, None].astype(jnp.int32)
    jlayers = jcache.get("layers", []) + jcache["tail"]
    assert len(cache) == len(jlayers) == cfg.n_layers
    for c, jc in zip(cache, jlayers):
        assert set(c) == set(jc)
        for name, t in c.items():
            assert tuple(t.shape) == jc[name].shape
            np.testing.assert_allclose(t.float().numpy(), _np(jc[name]),
                                       **_state_tol(t))


@pytest.mark.parametrize("arch", ARCHS)
def test_init_cache_matches_reference_layout(arch):
    jcfg, cfg = jax_get_config(arch), get_config(arch)
    jcache = jdecode.init_cache(jcfg, 3, 20)
    jlayers = jcache.get("layers", []) + jcache["tail"]
    cache = pdecode.init_cache(cfg, 3, 20, device="cpu")
    assert len(cache) == len(jlayers)
    for c, jc in zip(cache, jlayers):
        assert set(c) == set(jc)
        for name, t in c.items():
            want = jc[name].value
            assert tuple(t.shape) == want.shape
            assert str(t.dtype) == f"torch.{want.dtype}"
            assert torch.count_nonzero(t) == 0


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_updates_the_cache_list_in_place(arch):
    _, _, model = _reference(arch)
    cfg = get_config(arch)
    shape = ShapeConfig("t", 20, 1, "decode")
    _, cache = build_prefill_step(cfg, shape, "cpu")(
        model, {"tokens": np.ones((1, 16), np.int32)})
    before = [dict(c) for c in cache]
    _, cache2 = build_decode_step(cfg, shape, "cpu")(
        model, cache, np.ones((1, 1), np.int32), 16)
    assert cache2 is cache
    for old, new in zip(before, cache):
        for name in ("h", "S"):
            if name in new:
                assert new[name] is not old[name]
                assert not torch.equal(new[name], old[name])


@pytest.mark.parametrize("arch", ARCHS)
def test_anneal_serving_runs_on_the_cpu(arch):
    cfg = get_config(arch)
    rounds = []
    before = dict(ops.LAUNCHES)
    out = anneal_serving(cfg, device="cpu", prompt_len=16, max_new=3,
                         requests=5, rounds=3, on_round=rounds.append)
    assert [r["round"] for r in out["rounds"]] == [0, 1, 2] and rounds
    for r in out["rounds"]:
        assert r["batch"] in (1, 2, 4, 8, 16)
        assert r["tokens_ok"] and r["mean_sojourn_s"] > 0
        assert r["decode_steps"] == 2 * r["batches"]
    assert ops.LAUNCHES == before          # the CPU runs the plain versions


@pytest.mark.parametrize("arch", ARCHS)
def test_entry_points_default_to_the_card(arch):
    cfg = get_config(arch)
    shape = ShapeConfig("t", 8, 1, "decode")
    if torch.cuda.is_available():
        build_prefill_step(cfg, shape)
        assert next(iter(pdecode.init_cache(cfg, 1, 8)[0].values())).is_cuda
        return
    for build in (build_prefill_step, build_decode_step):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            build(cfg, shape)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        anneal_serving(cfg, rounds=1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pdecode.init_cache(cfg, 1, 8)


@pytest.mark.parametrize("arch", ARCHS)
def test_recurrent_kinds_are_served_not_trained(arch):
    """Serving builds; the training forward and step refuse the recurrent
    kinds (their kernels have no backward yet), naming ROADMAP."""
    cfg = get_config(arch)
    model = transformer.init_model(torch.Generator().manual_seed(0), cfg)
    transformer.check_ported(cfg)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        transformer.model_fwd(model, {"tokens": torch.zeros(
            (1, 8), dtype=torch.int64)}, cfg)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        build_train_step(cfg, ShapeConfig("t", 8, 1, "train"),
                         device="cpu")


def test_blocks_take_exactly_their_kinds_parts():
    cfg = get_config("rwkv6-7b-reduced")
    block = transformer.init_block(torch.Generator().manual_seed(0), cfg,
                                   cfg.pattern[0])
    with pytest.raises(ValueError, match="parts"):
        transformer.Block(cfg.pattern[0], block.ln1, block.ln2,
                          time=block.time)
    assert dataclasses.asdict(transformer.rwkv_spec_for(cfg)) == \
        dataclasses.asdict(prwkv.RWKV6Spec(d_model=128, head_dim=32,
                                           d_ff=256, chunk=8))
