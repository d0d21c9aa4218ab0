"""The port's training slice against the JAX package's: the loss, AdamW
(with the weight-decay rank of the reference's stacked leaves), int8
compression with error feedback, the model's loss and gradients, whole
train steps from one carried state, remat, checkpoints, resume after a
failure, and the two training entry points.

Every comparison starts both packages from the same numpy values: the
reference's random reduced model (tp=1) carried across with
``interop.model_params_from_jax`` / ``train_state_from_jax``, batches from
the (copied) synthetic pipeline.  Float32 runs (both trees cast) are held
to float32 tolerances; bf16 runs to the reference's own bf16-vs-float32
gap, as the serve slice is.
"""

import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs.base import ShapeConfig as JShapeConfig
from repro.data import DataConfig as JDataConfig
from repro.data import SyntheticLM as JSyntheticLM
from repro.launch.mesh import make_host_mesh
from repro.models import init_model as jax_init_model
from repro.models import split_boxes
from repro.models import transformer as jtransformer
from repro.optim import compression as jcomp
from repro.optim import optimizer as jopt
from repro.runtime import loss as jloss
from repro.runtime import train as jtrain
from repro_torch.checkpoint import CheckpointManager, committed_steps, \
    restore_pytree, save_pytree
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.interop import model_params_from_jax, train_state_from_jax
from repro_torch.kernels import ops
from repro_torch.launch.train import TrainRun, run_training
from repro_torch.launch.train_anneal import anneal_training
from repro_torch.optim import compression as pcomp
from repro_torch.optim import optimizer as popt
from repro_torch.runtime import loss as ploss
from repro_torch.runtime.fault_tolerance import FailureInjector
from repro_torch.runtime.train import TrainStepOptions, build_train_step, \
    reference_ranks

B, S = 4, 32


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    a = np.asarray(x)
    return a.astype(np.float32) if a.dtype == ml_dtypes.bfloat16 else a


def _reference_params(arch, dtype=None):
    """The reference's random model of ``arch`` (tp=1) as numpy leaves,
    cast to ``dtype`` when given."""
    params, _ = split_boxes(jax_init_model(jax.random.key(0),
                                           jax_get_config(arch), tp=1))
    if dtype is not None:
        params = jax.tree.map(lambda p: p.astype(dtype), params)
    return jax.tree.map(np.asarray, params)


def _named(tree, arch):
    """A reference-layout tree as ``{port parameter name: tensor}``."""
    return {n: p.detach() for n, p in model_params_from_jax(
        tree, get_config(arch), device="cpu").named_parameters()}


def _batch(vocab, seed=0, step=0):
    data = JSyntheticLM(JDataConfig(vocab=vocab, seq_len=S, global_batch=B,
                                    seed=seed))
    return data.batch_at(step)


def _close(got, want, rtol):
    """allclose at ``rtol``, with an absolute floor of ``rtol`` times the
    reference's largest magnitude (so near-zero entries of a tensor are
    held to its own scale)."""
    want = _np(want)
    np.testing.assert_allclose(
        _np(got), want, rtol=rtol,
        atol=rtol * float(np.abs(want).max(initial=0.0)))


# ---------------------------------------------------------------------------
# Loss.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("z_loss", [0.0, 1e-4])
def test_softmax_xent_matches_reference(masked, z_loss):
    rng = np.random.default_rng(5)
    logits = (3 * rng.standard_normal((2, 7, 50))).astype(np.float32)
    labels = rng.integers(0, 50, (2, 7)).astype(np.int32)
    mask = (rng.random((2, 7)) < 0.7).astype(np.float32) if masked else None
    want, wm = jloss.softmax_xent(jnp.asarray(logits), jnp.asarray(labels),
                                  None if mask is None else jnp.asarray(mask),
                                  z_loss=z_loss)
    lt = torch.from_numpy(logits).requires_grad_(True)
    got, gm = ploss.softmax_xent(lt, torch.from_numpy(labels),
                                 None if mask is None
                                 else torch.from_numpy(mask), z_loss=z_loss)
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)
    for k in wm:
        np.testing.assert_allclose(gm[k].item(), float(wm[k]), rtol=1e-6)
    got.backward()
    jg = jax.grad(lambda x: jloss.softmax_xent(
        x, jnp.asarray(labels), None if mask is None else jnp.asarray(mask),
        z_loss=z_loss)[0])(jnp.asarray(logits))
    np.testing.assert_allclose(lt.grad.numpy(), np.asarray(jg), atol=1e-7,
                               rtol=1e-5)


def test_token_accuracy_matches_reference():
    rng = np.random.default_rng(6)
    logits = rng.standard_normal((3, 5, 11)).astype(np.float32)
    labels = rng.integers(0, 11, (3, 5)).astype(np.int32)
    mask = (rng.random((3, 5)) < 0.5).astype(np.float32)
    for m in (None, mask):
        want = jloss.token_accuracy(jnp.asarray(logits), jnp.asarray(labels),
                                    None if m is None else jnp.asarray(m))
        got = ploss.token_accuracy(torch.from_numpy(logits),
                                   torch.from_numpy(labels),
                                   None if m is None else torch.from_numpy(m))
        assert got.item() == pytest.approx(float(want), rel=1e-7)


# ---------------------------------------------------------------------------
# AdamW and compression on a carried parameter tree.
# ---------------------------------------------------------------------------

ARCH = "repro-100m-reduced"       # 2 layers, d 128, 4 heads x 32, MHA


def _grad_tree(params, seed, scale=1e-2):
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda p: (scale * rng.standard_normal(p.shape))
                        .astype(p.dtype), params)


def _adamw_runs(params, cfg, pcfg, steps=3):
    """``steps`` AdamW updates of ``params`` in both packages (the port's
    per-layer tensors decayed by the reference's leaf ranks); returns the
    reference's (params, m, v) and the port's, keyed by port name."""
    model = model_params_from_jax(params, get_config(ARCH), device="cpu")
    ranks = reference_ranks(model)
    pp = {n: p.detach() for n, p in model.named_parameters()}
    jp, jstate, pstate = params, jopt.adamw_init(params, cfg), \
        popt.adamw_init(pp, pcfg)
    update = jax.jit(jopt.adamw_update, static_argnums=(3,))
    for i in range(steps):
        g = _grad_tree(params, i, scale=[1e-2, 0.3, 3e-5][i])
        jp, jstate = update(g, jstate, jp, cfg, 1e-3)
        pp, pstate = popt.adamw_update(_named(g, ARCH), pstate, pp, pcfg,
                                       lr=1e-3, ranks=ranks)
    assert int(pstate.count) == int(jstate.count) == steps
    return ([_named(t, ARCH) for t in (jp, jstate.m, jstate.v)],
            [pp, pstate.m, pstate.v])


@pytest.mark.parametrize("grad_clip", [1.0, 0.0])
def test_adamw_update_matches_reference(grad_clip):
    """Three AdamW steps on the reference's reduced model from carried
    values.  In float32 (params and moments) the port agrees to rtol 1e-5.
    In the models' own types (bf16 matrices, float32 norm scales) with
    bf16 moments, a last-bit difference of a float32 sum can flip a bf16
    rounding, so each tensor is held within the reference's own gap
    between that run and its float32 run."""
    p16 = _reference_params(ARCH)
    p32 = jax.tree.map(lambda p: p.astype(np.float32), p16)
    kw = dict(grad_clip=grad_clip)
    want32, got32 = _adamw_runs(p32, jopt.AdamWConfig(**kw),
                                popt.AdamWConfig(**kw))
    for want, got in zip(want32, got32):
        for n in want:
            assert got[n].dtype == want[n].dtype == torch.float32
            _close(got[n], want[n], rtol=1e-5)
    kw["state_dtype"] = "bfloat16"
    want16, got16 = _adamw_runs(p16, jopt.AdamWConfig(**kw),
                                popt.AdamWConfig(**kw))
    for want, got, ref32 in zip(want16, got16, want32):
        for n in want:
            assert got[n].dtype == want[n].dtype, n
            gap = float((want[n].float() - ref32[n]).abs().max())
            assert float((got[n].float() - want[n].float()).abs().max()) \
                <= gap, n


def test_weight_decay_follows_the_reference_leaf_rank():
    """Pinned difference of layout: the reference's scanned layers keep
    their (D,) norm scales stacked as (L, D) leaves, which AdamW decays;
    the port holds them per layer and decays them by that rank.  With a
    zero gradient only decay moves a parameter."""
    params = _reference_params(ARCH)
    model = model_params_from_jax(params, get_config(ARCH), device="cpu")
    ranks = reference_ranks(model)
    assert ranks["layers.0.ln1.scale"] == 2 and ranks["final_norm.scale"] == 1
    assert ranks["layers.1.attn.wq"] == 4 and ranks["embed"] == 2
    assert all(r == p.dim() + n.startswith("layers.")
               for n, p in model.named_parameters() for r in [ranks[n]])
    cfg = jopt.AdamWConfig(grad_clip=0.0)
    zeros = jax.tree.map(np.zeros_like, params)
    jp, _ = jax.jit(jopt.adamw_update, static_argnums=(3,))(
        zeros, jopt.adamw_init(params, cfg), params, cfg, 0.1)
    pp = {n: p.detach() for n, p in model.named_parameters()}
    pcfg = popt.AdamWConfig(grad_clip=0.0)
    got, _ = popt.adamw_update(_named(zeros, ARCH), popt.adamw_init(pp, pcfg),
                               pp, pcfg, lr=0.1, ranks=ranks)
    want = _named(jp, ARCH)
    assert torch.equal(got["final_norm.scale"], pp["final_norm.scale"])
    for n in ("layers.0.ln1.scale", "layers.1.ln2.scale"):
        assert not torch.equal(got[n], pp[n])         # decayed, as there
        torch.testing.assert_close(got[n], want[n], rtol=1e-6, atol=0)
    # without the ranks, a tensor's own rank would leave them undecayed
    plain, _ = popt.adamw_update(_named(zeros, ARCH),
                                 popt.adamw_init(pp, pcfg), pp, pcfg, lr=0.1)
    assert torch.equal(plain["layers.0.ln1.scale"], pp["layers.0.ln1.scale"])


def test_clip_by_global_norm_and_schedule_match_reference():
    params = _reference_params(ARCH, jnp.float32)
    for scale in (1e-3, 1.0):
        g = _grad_tree(params, 9, scale)
        (jg, jn) = jopt.clip_by_global_norm(g, 1.0)
        pg, pn = popt.clip_by_global_norm(_named(g, ARCH), 1.0)
        np.testing.assert_allclose(pn.item(), float(jn), rtol=1e-6)
        for n, w in _named(jg, ARCH).items():
            _close(pg[n], w, rtol=1e-6)
    jlr = jopt.cosine_schedule(3e-4, 100, 1000)
    plr = popt.cosine_schedule(3e-4, 100, 1000)
    for s in (0, 1, 50, 99, 100, 101, 500, 999, 1000, 5000):
        np.testing.assert_allclose(
            plr(torch.tensor(s, dtype=torch.int32)).item(),
            float(jlr(jnp.int32(s))), rtol=1e-6)


def test_compress_tree_and_error_feedback_match_reference():
    """Two error-feedback cycles over the carried tree: payloads, scales,
    residuals and the decompressed gradients equal the reference's, bit
    for bit (the reference run op by op: compiled, XLA turns the division
    by 127 into a product with its reciprocal)."""
    params = _reference_params(ARCH)
    jres, pres = None, None
    for i in range(2):
        g = _grad_tree(params, 20 + i, 0.1)
        jdeq, jres = jcomp.compressed_roundtrip(g, jres)
        pdeq, pres = pcomp.compressed_roundtrip(_named(g, ARCH), pres)
        for tree, got in ((jdeq, pdeq), (jres, pres)):
            for n, w in _named(tree, ARCH).items():
                assert got[n].dtype == w.dtype
                assert torch.equal(got[n], w), n
    g = jax.tree.map(lambda p: p.astype(jnp.float32), _grad_tree(params, 7))
    jq, je = jcomp.compress_tree(g)
    pq, pe = pcomp.compress_tree(_named(g, ARCH))
    def pair(x):
        return isinstance(x, tuple) and len(x) == 2 and hasattr(x[0],
                                                                "dtype")

    jqs = _named(jax.tree.map(lambda t: t[0], jq, is_leaf=pair), ARCH)
    jss = _named(jax.tree.map(lambda t: t[1], jq, is_leaf=pair), ARCH)
    for n in jqs:
        assert torch.equal(pq[n][0], jqs[n]) and torch.equal(pq[n][1], jss[n])


# ---------------------------------------------------------------------------
# The model's loss and gradients.
# ---------------------------------------------------------------------------


def _jax_loss_and_grads(params, batch, arch, eager=False):
    """The reference's loss and gradients, compiled, or op by op under
    ``jax.disable_jit()`` with ``eager`` (each bf16 operation then rounds
    where the source says, as the port's do; compiled, XLA on the CPU keeps
    some bf16 intermediates in float32, as the serve slice's tests note)."""
    jcfg = jax_get_config(arch)
    jtransformer.set_constrain_hook(None)
    jtransformer.set_embed_hook(None)

    def f(params):
        hidden, aux = jtransformer.model_fwd(
            params, {"tokens": jnp.asarray(batch["tokens"])}, jcfg, tp=1)
        logits = jtransformer.logits_fn(params, hidden)
        loss, _ = jloss.softmax_xent(logits, jnp.asarray(batch["labels"]),
                                     z_loss=1e-4)
        return loss + aux

    if eager:
        with jax.disable_jit():
            loss, grads = jax.value_and_grad(f)(params)
    else:
        loss, grads = jax.jit(jax.value_and_grad(f))(params)
    return float(loss), _named(jax.tree.map(np.asarray, grads), arch)


def _port_loss_and_grads(params, batch, arch, remat="none"):
    cfg = get_config(arch)
    built = build_train_step(cfg, ShapeConfig("t", S, B, "train"),
                             TrainStepOptions(remat=remat), device="cpu")
    model = model_params_from_jax(params, cfg, device="cpu")
    loss, metrics, grads = built.grads(
        model, {k: torch.from_numpy(v.astype(np.int64))
                for k, v in batch.items()})
    return loss.item(), grads, metrics


@pytest.mark.parametrize("arch", ["repro-100m-reduced", "qwen3-8b-reduced"])
def test_model_loss_and_grads_match_reference(arch):
    """model_fwd + logits_fn + loss and autograd through them (the flash
    attention kernels' plain versions, forward and backward) against
    ``jax.value_and_grad`` of the reference's.  Float32 (both trees cast):
    loss to rtol 1e-5, gradients to atol 1e-4 / rtol 1e-3.  bf16 (the
    models' own types, the reference run op by op): loss to rtol 2e-2,
    and each gradient no farther from the reference's than the reference's
    bf16 gradient is from its float32 one."""
    batch = _batch(jax_get_config(arch).vocab)
    p32 = _reference_params(arch, jnp.float32)
    jl32, jg32 = _jax_loss_and_grads(p32, batch, arch)
    pl32, pg32, _ = _port_loss_and_grads(p32, batch, arch)
    np.testing.assert_allclose(pl32, jl32, rtol=1e-5)
    for n, w in jg32.items():
        np.testing.assert_allclose(pg32[n].numpy(), w.numpy(), atol=1e-4,
                                   rtol=1e-3, err_msg=n)
    p16 = _reference_params(arch)
    jl16, jg16 = _jax_loss_and_grads(p16, batch, arch, eager=True)
    pl16, pg16, _ = _port_loss_and_grads(p16, batch, arch)
    np.testing.assert_allclose(pl16, jl16, rtol=2e-2)
    for n, w in jg16.items():
        assert pg16[n].dtype == w.dtype, n
        gap = float((w.float() - jg32[n]).abs().max())
        assert float((pg16[n].float() - w.float()).abs().max()) <= gap, n


def test_remat_modes_give_equal_results():
    """"none", "block" and "full" (with 4 layers, two groups of two, so the
    sqrt schedule nests) compute the same loss and gradients."""
    arch = "repro-100m-reduced"
    cfg = dataclasses.replace(get_config(arch), n_layers=4)
    from repro_torch.models.transformer import init_model
    from repro_torch.device import generator

    with torch.no_grad():
        model = init_model(generator(3), cfg)
    batch = {k: torch.from_numpy(v.astype(np.int64))
             for k, v in _batch(cfg.vocab).items()}
    out = {}
    for remat in ("none", "block", "full"):
        built = build_train_step(cfg, ShapeConfig("t", S, B, "train"),
                                 TrainStepOptions(remat=remat), device="cpu")
        before = ops.LAUNCHES.copy()
        out[remat] = built.grads(model, batch)
        assert ops.LAUNCHES == before
    for remat in ("block", "full"):
        assert out[remat][0].item() == out["none"][0].item()
        for n, g in out["none"][2].items():
            assert torch.equal(out[remat][2][n], g), (remat, n)


# ---------------------------------------------------------------------------
# Whole train steps from one carried state.
# ---------------------------------------------------------------------------


def _state_pair(arch, options_kw):
    """The reference's TrainState (float32 params, fresh AdamW, zero
    residual under int8) and the port's carried copy."""
    params = _reference_params(arch, jnp.float32)
    jparams = jax.tree.map(jnp.asarray, params)
    res = (jax.tree.map(lambda p: jnp.zeros(p.shape, jnp.float32), jparams)
           if options_kw.get("compression") == "int8" else None)
    jstate = jtrain.TrainState(jparams, jopt.adamw_init(
        jparams, jopt.AdamWConfig()), res)
    pstate = train_state_from_jax(
        jax.tree.map(np.asarray, jstate), get_config(arch),
        TrainStepOptions(**options_kw), device="cpu")
    return jstate, pstate


@pytest.mark.parametrize("compression", ["none", "int8"])
@pytest.mark.parametrize("microbatches", [1, 2])
def test_train_steps_match_reference(microbatches, compression):
    """Two steps of the port's ``build_train_step`` against the
    reference's (on its host mesh) from one carried float32 state: the
    metrics, new params, moments and the error-feedback residual.

    int8 quantization rounds each gradient element to a step of its row's
    scale; a float32 sum taken in another order can move an element across
    a rounding boundary, which moves its residual by one step and its
    moments with it.  So under int8, elements whose residual differs are
    allowed where the difference is one quantization step, and they must
    be rare (here about 1 in 10^5); every other element is held tight."""
    arch = ARCH
    kw = dict(microbatches=microbatches, compression=compression)
    jstate, pstate = _state_pair(arch, kw)
    jbuilt = jtrain.build_train_step(jax_get_config(arch), make_host_mesh(),
                                     JShapeConfig("t", S, B, "train"),
                                     jtrain.TrainStepOptions(**kw))
    pbuilt = build_train_step(get_config(arch), ShapeConfig("t", S, B,
                                                            "train"),
                              TrainStepOptions(**kw), device="cpu")
    jstep = jbuilt.jit()
    names = [n for n, _ in pstate.params.named_parameters()]
    flipped = {n: torch.zeros(p.shape, dtype=torch.bool)
               for n, p in pstate.params.named_parameters()}
    for step in range(2):
        batch = _batch(512, step=step)
        jstate, jm = jstep(jstate, {k: jnp.asarray(v)
                                    for k, v in batch.items()})
        pstate, pm = pbuilt.step(pstate, batch)
        assert set(pm) == set(jm) == {"nll", "z", "aux", "loss", "lr",
                                      "step"}
        for k in jm:
            np.testing.assert_allclose(pm[k].item(), float(jm[k]), rtol=1e-5,
                                       err_msg=k)
        want = train_state_from_jax(jax.tree.map(np.asarray, jstate),
                                    get_config(arch), device="cpu")
        assert int(pstate.opt.count) == int(want.opt.count) == step + 1
        if compression == "int8":
            for n, r in want.residual.items():
                d = (pstate.residual[n] - r).abs()
                # one quantization step of the row: twice its largest
                # residual
                row = r.abs().amax(dim=-1, keepdim=True)
                assert bool((d <= 2.02 * row + 1e-7).all()), n
                flipped[n] |= d > 1e-3 * float(r.abs().max())
                keep = ~flipped[n]
                _close(pstate.residual[n][keep], r[keep], rtol=1e-3)
            assert sum(int(f.sum()) for f in flipped.values()) \
                <= 1e-3 * sum(f.numel() for f in flipped.values())
        got_p = {n: p.detach() for n, p in pstate.params.named_parameters()}
        want_p = {n: p.detach() for n, p in want.params.named_parameters()}
        for got, ref in ((pstate.opt.m, want.opt.m),
                         (pstate.opt.v, want.opt.v)):
            for n in names:
                keep = ~flipped[n]
                _close(got[n][keep], ref[n][keep], rtol=1e-4)
        for n in names:
            _close(got_p[n], want_p[n], rtol=1e-5)


# ---------------------------------------------------------------------------
# Checkpoints, resume, entry points.
# ---------------------------------------------------------------------------


def test_checkpoint_reads_back_bit_for_bit(tmp_path):
    built = build_train_step(get_config(ARCH), ShapeConfig("t", S, B,
                                                           "train"),
                             TrainStepOptions(compression="int8"),
                             device="cpu")
    state = built.init(4)
    state, _ = built.step(state, _batch(512))
    tree = state.tree()
    path = save_pytree(tree, str(tmp_path), step=1, extra={"step": 1})
    assert committed_steps(str(tmp_path)) == [1]
    assert sorted(p.name for p in (tmp_path / "step_00000001").iterdir())[:2] \
        == ["_COMMITTED", "arr_00000.npy"]
    back, extra = restore_pytree(tree, str(tmp_path), device="cpu")
    assert extra == {"step": 1} and path.endswith("step_00000001")

    def leaves(t):
        return [t] if isinstance(t, torch.Tensor) else [
            x for k in sorted(t) for x in leaves(t[k])] if t else []

    def bits(t):
        return t.reshape(-1).view({1: torch.uint8, 2: torch.int16,
                                   4: torch.int32}[t.element_size()])

    a, b = leaves(tree), leaves(back)
    assert len(a) == len(b) == 4 * 21 + 1     # params, m, v, residual, count
    assert any(t.dtype == torch.bfloat16 for t in b)
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert torch.equal(bits(x), bits(y))
    # a fresh state restored from it continues exactly like the original
    fresh = built.init(9)
    fresh.load_tree(back)
    _, m1 = built.step(state, _batch(512, step=1))
    _, m2 = built.step(fresh, _batch(512, step=1))
    assert m1["loss"].item() == m2["loss"].item()


def test_async_checkpoints_snapshot_at_the_call(tmp_path):
    """An async save copies the state when called: updating the tensors in
    place afterwards does not reach the files; keep-last-k holds."""
    mgr = CheckpointManager(str(tmp_path), keep=2)
    t = {"w": torch.ones(4, dtype=torch.bfloat16), "n": torch.arange(3)}
    for step in range(3):
        mgr.save(t, step, extra={"step": step}, blocking=False)
        t["w"].add_(1)
    mgr.wait()
    assert committed_steps(str(tmp_path)) == [1, 2]
    back, extra = mgr.restore(t)
    assert extra == {"step": 2}
    assert back["w"].tolist() == [3.0] * 4 and back["n"].tolist() == [0, 1, 2]


def test_training_resumes_identically(tmp_path):
    """Kill at step 7 -> restore from step 4 -> the final loss equals the
    uninterrupted run's (the port of tests/test_runtime_systems.py:72, on
    the dense family, with int8 compression so the restored state carries
    an error-feedback residual)."""
    def mk(ckpt):
        return TrainRun(arch=ARCH, steps=12, batch=2, seq=32, ckpt_dir=ckpt,
                        save_every=4, device="cpu",
                        options=TrainStepOptions(compression="int8"))

    base = run_training(mk(str(tmp_path / "a")))
    injected = run_training(mk(str(tmp_path / "b")),
                            injector=FailureInjector(fail_steps=(7,)))
    assert injected["restarts"] == 1
    assert [e["step"] for e in injected["events"]] == [7]
    np.testing.assert_allclose(base["losses"][-1], injected["losses"][-1],
                               rtol=1e-6)
    assert injected["final_step"] == base["final_step"] == 12
    assert len(injected["losses"]) == 12 + 3      # steps 4-6 ran twice
    assert committed_steps(str(tmp_path / "b"))[-1] == 12


def test_train_entry_points_run_on_the_cpu(capsys):
    """``python -m repro_torch.launch.train`` and ``.train_anneal`` at the
    reduced width on the CPU; the annealer's loop keeps its records."""
    from repro_torch.launch import train as train_mod
    from repro_torch.launch import train_anneal

    assert train_mod.main(["--arch", ARCH, "--device", "cpu", "--steps", "3",
                           "--batch", "2", "--seq", "32", "--compression",
                           "int8", "--microbatches", "2"]) == 0
    assert "final step 3" in capsys.readouterr().out
    out = anneal_training(ARCH, steps=8, batch=4, seq=32, anneal_every=2,
                          ckpt_dir=None, device="cpu")
    assert len(out["rounds"]) == 4 and out["steps"] == 10
    assert out["best"]["microbatches"] in (1, 2, 4)
    assert all(r["config"]["remat"] in ("none", "block")
               for r in out["rounds"])
    assert train_anneal.LAMBDA == 10.0


def test_train_state_from_jax_carries_every_leaf():
    arch = "qwen3-8b-reduced"
    params = _reference_params(arch)
    jstate = jtrain.TrainState(params, jopt.adamw_init(
        params, jopt.AdamWConfig()), _grad_tree(params, 1))
    jstate.opt.count = np.int32(5)
    st = train_state_from_jax(jstate, get_config(arch),
                              TrainStepOptions(compression="int8"),
                              device="cpu")
    assert int(st.opt.count) == 5 and st.opt.count.dtype == torch.int32
    assert all(p.requires_grad for p in st.params.parameters())
    for tree, got in ((jstate.residual, st.residual),
                      (jstate.opt.m, st.opt.m)):
        for n, w in _named(tree, arch).items():
            assert torch.equal(got[n], w)
    assert set(st.opt.v) == {n for n, _ in st.params.named_parameters()}
    with pytest.raises(ValueError, match="residual"):
        train_state_from_jax(jstate, get_config(arch), TrainStepOptions(),
                             device="cpu")
