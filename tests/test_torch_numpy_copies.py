"""The PyTorch port's copies of the numpy-only modules behave bit for bit
like the reference's: same inputs (numpy, from a seed) through both, exact
equality of every output."""

import dataclasses
import math

import numpy as np
import pytest

from repro import configs as ref_configs
from repro.workloads import simulator as ref_sim
from repro.core import change_detect as ref_cd
from repro.core import landscape as ref_land
from repro.core import objective as ref_obj
from repro.core import state as ref_state
from repro.core import surrogate as ref_sur
from repro.workloads import microservice as ref_ms
from repro_torch import configs as pt_configs
from repro_torch.core import change_detect as pt_cd
from repro_torch.core import landscape as pt_land
from repro_torch.core import objective as pt_obj
from repro_torch.core import state as pt_state
from repro_torch.core import surrogate as pt_sur
from repro_torch.workloads import microservice as pt_ms
from repro_torch.workloads import simulator as pt_sim


def _space(mod, valid: bool):
    dims = (mod.Dimension("nodes", (1, 2, 4, 8)),
            mod.Dimension("family", ("a", "b", "c"), kind="categorical"),
            mod.Dimension("remat", ("none", "block", "full")))
    rule = (lambda cfg: cfg["nodes"] * (1 + (cfg["family"] == "c")) <= 8) \
        if valid else None
    return mod.ConfigSpace(dims, rule)


@pytest.mark.parametrize("valid", [False, True])
def test_config_space_encoded_is_identical(valid):
    a = _space(ref_state, valid).encoded()
    b = _space(pt_state, valid).encoded()
    assert a.shape == b.shape and a.categorical == b.categorical
    if valid:
        assert np.array_equal(a.valid_mask, b.valid_mask)
    else:
        assert a.valid_mask is None and b.valid_mask is None


@pytest.mark.parametrize("valid", [False, True])
def test_tabulate_is_identical(valid):
    def fn(cfg):
        return math.log(cfg["nodes"]) + 0.3 * len(cfg["remat"]) \
            + {"a": 0.1, "b": 0.7, "c": 0.2}[cfg["family"]]

    a = ref_land.tabulate(_space(ref_state, valid), fn)
    b = pt_land.tabulate(_space(pt_state, valid), fn)
    assert np.array_equal(a, b)


def test_objective_is_identical():
    rng = np.random.default_rng(0)
    for _ in range(50):
        t, c, ms, mu = rng.uniform(0.0, 5.0, 4)
        kw = dict(lambda_cost=float(rng.uniform(0, 3)),
                  slo_s=float(rng.uniform(0.5, 4.0)),
                  slo_penalty=float(rng.uniform(0, 20)),
                  include_migration=bool(rng.integers(2)))
        a = ref_obj.Objective(**kw)(ref_obj.Measurement(t, c, ms, mu))
        b = pt_obj.Objective(**kw)(pt_obj.Measurement(t, c, ms, mu))
        assert a == b


def test_page_hinkley_is_identical():
    rng = np.random.default_rng(1)
    stream = np.concatenate([rng.normal(1.0, 0.1, 80),
                             rng.normal(1.6, 0.1, 80)])
    a, b = ref_cd.PageHinkley(), pt_cd.PageHinkley()
    sig_a = [a.update(float(v)) for v in stream]
    sig_b = [b.update(float(v)) for v in stream]
    assert sig_a == sig_b and any(sig_a)
    assert (a._n, a._mean, a._m2, a._up, a._down) \
        == (b._n, b._mean, b._m2, b._up, b._down)


@pytest.mark.parametrize("max_age", [None, 3.0])
def test_measurement_store_best_is_identical(max_age):
    rng = np.random.default_rng(2)
    a = ref_sur.MeasurementStore(3, half_life=4.0, capacity=40)
    b = pt_sur.MeasurementStore(3, half_life=4.0, capacity=40)
    for t in range(60):
        s = tuple(int(v) for v in rng.integers(0, 4, 3))
        y = float(rng.normal())
        a.add(s, y, float(t))
        b.add(s, y, float(t))
    now = 59.0 if max_age is not None else None
    assert a.best(now, max_age) == b.best(now, max_age)
    for x, z in zip(a.arrays(), b.arrays()):
        assert np.array_equal(x, z)
    assert np.array_equal(a.weights(60.0), b.weights(60.0))


@pytest.mark.parametrize("kind", ["idw", "rbf"])
def test_host_interp_is_identical(kind):
    rng = np.random.default_rng(3)
    xq = rng.uniform(size=(40, 6))
    xm = rng.uniform(size=(25, 6))
    ys = rng.normal(size=25)
    rec = rng.uniform(0.0, 1.0, size=25)
    a = ref_sur.host_interp(xq, xm, ys, rec, kind=kind)
    b = pt_sur.host_interp(xq, xm, ys, rec, kind=kind)
    assert np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])


def _dag(mod):
    tiers = (mod.ServiceTier("gw", base_rate=60.0),
             mod.ServiceTier("auth", base_rate=80.0),
             mod.ServiceTier("catalog", base_rate=40.0, mem_per_rps_gb=0.08),
             mod.ServiceTier("product", base_rate=35.0),
             mod.ServiceTier("pricing", base_rate=90.0),
             mod.ServiceTier("inventory", base_rate=50.0))
    edges = (("gw", "auth"), ("gw", "catalog"), ("catalog", "product"),
             ("product", "pricing"), ("product", "inventory"),
             ("auth", "inventory"))
    classes = (
        mod.RequestClass("browse", "gw",
                         {"gw": 1, "catalog": 1, "product": 2, "pricing": 2,
                          "inventory": 1}, slo_s=0.35),
        mod.RequestClass("checkout", "gw",
                         {"gw": 1, "auth": 1, "inventory": 2, "pricing": 1},
                         slo_s=0.5))
    return mod.MicroserviceDAG(tiers, edges, classes)


def test_class_latencies_are_identical():
    rng = np.random.default_rng(4)
    da, db = _dag(ref_ms), _dag(pt_ms)
    sizes = [(1, 2.0), (2, 4.0), (4, 8.0)]
    for _ in range(30):
        picks = [(sizes[int(rng.integers(3))], int(rng.integers(1, 4)))
                 for _ in da.tiers]
        mix = {"browse": float(rng.uniform(0, 60)),
               "checkout": float(rng.uniform(0, 60))}
        sa = {t.name: (ref_ms.ContainerSize("x", c, m), r)
              for t, ((c, m), r) in zip(da.tiers, picks)}
        sb = {t.name: (pt_ms.ContainerSize("x", c, m), r)
              for t, ((c, m), r) in zip(db.tiers, picks)}
        assert np.array_equal(da.class_latencies(sa, mix),
                              db.class_latencies(sb, mix))


# ---------------------------------------------------------------------------
# configs/: plain dataclasses, pinned field by field.
# ---------------------------------------------------------------------------


def _fields(obj):
    """A config's fields as plain values (LayerKinds as tuples)."""
    out = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if f.name == "pattern":
            v = tuple(dataclasses.astuple(lk) for lk in v)
        out[f.name] = v
    return out


def test_config_registry_is_identical():
    assert pt_configs.ARCH_NAMES == ref_configs.ARCH_NAMES
    assert [f.name for f in dataclasses.fields(pt_configs.ModelConfig)] \
        == [f.name for f in dataclasses.fields(ref_configs.ModelConfig)]
    assert [f.name for f in dataclasses.fields(pt_configs.LayerKind)] \
        == [f.name for f in dataclasses.fields(ref_configs.LayerKind)]
    assert {k: dataclasses.astuple(v) for k, v in pt_configs.SHAPES.items()} \
        == {k: dataclasses.astuple(v)
            for k, v in ref_configs.SHAPES.items()}
    assert dataclasses.astuple(pt_configs.PREFILL_32K) \
        == ("prefill_32k", 32768, 32, "prefill")
    assert dataclasses.astuple(pt_configs.DECODE_32K) \
        == ("decode_32k", 32768, 128, "decode")


@pytest.mark.parametrize("name", list(ref_configs.ARCH_NAMES) + ["repro-100m"])
def test_config_copy_is_identical(name):
    a, b = ref_configs.get_config(name), pt_configs.get_config(name)
    assert _fields(a) == _fields(b)
    assert _fields(a.reduced()) == _fields(b.reduced())
    assert _fields(ref_configs.get_config(name + "-reduced")) \
        == _fields(pt_configs.get_config(name + "-reduced"))
    assert a.param_count() == b.param_count()
    assert a.active_param_count() == b.active_param_count()
    assert [dataclasses.astuple(lk) for lk in a.layers] \
        == [dataclasses.astuple(lk) for lk in b.layers]
    assert [s.name for s in ref_configs.shapes_for(a)] \
        == [s.name for s in pt_configs.shapes_for(b)]


# ---------------------------------------------------------------------------
# workloads/simulator.py: streams and queues, pinned bit for bit.
# ---------------------------------------------------------------------------


def test_job_streams_are_identical():
    blend = {"a": 0.5, "b": 0.3, "c": 0.2}
    ja, jb = ref_sim.JobStream(blend, seed=3), pt_sim.JobStream(blend, seed=3)
    assert [next(ja) for _ in range(200)] == [next(jb) for _ in range(200)]
    assert ref_sim.blended_stream(blend, {"c": 1.0}, 40, 100, seed=1) \
        == pt_sim.blended_stream(blend, {"c": 1.0}, 40, 100, seed=1)


def test_poisson_arrivals_and_queue_are_identical():
    service = {"a": 0.2, "b": 0.7}
    pa = ref_sim.PoissonArrivals(ref_sim.JobStream({"a": 1, "b": 2}, 5),
                                 rate_per_s=3.0, seed=5)
    pb = pt_sim.PoissonArrivals(pt_sim.JobStream({"a": 1, "b": 2}, 5),
                                rate_per_s=3.0, seed=5)
    arr_a = [next(pa) for _ in range(300)]
    arr_b = [next(pb) for _ in range(300)]
    assert [(a.n, a.job, a.t) for a in arr_a] \
        == [(b.n, b.job, b.t) for b in arr_b]
    qa = ref_sim.QueueSimulator(service.__getitem__)
    qb = pt_sim.QueueSimulator(service.__getitem__)
    assert [(c.start_t, c.finish_t) for c in qa.run(arr_a)] \
        == [(c.start_t, c.finish_t) for c in qb.run(arr_b)]
    assert qa.mean_sojourn(arr_a) == qb.mean_sojourn(arr_b)


def test_multi_tenant_streams_are_identical():
    def tenants(mod):
        return [mod.TenantWorkload("t0", {"a": 1.0, "b": 1.0}),
                mod.TenantWorkload("t1", {"a": 1.0}, {"b": 1.0}, 4)]

    ma = ref_sim.MultiTenantStream(tenants(ref_sim), seed=2)
    mb = pt_sim.MultiTenantStream(tenants(pt_sim), seed=2)
    out_a, out_b = [], []
    for r in range(12):
        if r == 6:
            for m, mod in ((ma, ref_sim), (mb, pt_sim)):
                m.add_tenant(mod.TenantWorkload("t2", {"b": 2.0, "c": 1.0}))
                m.set_blend("t0", {"c": 1.0})
        if r == 9:
            ma.remove_tenant("t1")
            mb.remove_tenant("t1")
        out_a.append(next(ma))
        out_b.append(next(mb))
    assert out_a == out_b
    assert ma.blend_of("t2") == mb.blend_of("t2")


@pytest.mark.parametrize("n_hosts,host_id", [(1, 0), (2, 1)])
def test_synthetic_lm_batches_are_identical(n_hosts, host_id):
    from repro.data import pipeline as ref_pipe
    from repro_torch.data import pipeline as pt_pipe

    kw = dict(vocab=512, seq_len=64, global_batch=4, seed=3,
              mean_doc_len=24, n_hosts=n_hosts, host_id=host_id)
    a = ref_pipe.SyntheticLM(ref_pipe.DataConfig(**kw))
    b = pt_pipe.SyntheticLM(pt_pipe.DataConfig(**kw))
    for step in (0, 1, 7, 100):
        x, y = a.batch_at(step), b.batch_at(step)
        assert x.keys() == y.keys()
        for k in x:
            assert x[k].dtype == y[k].dtype
            assert np.array_equal(x[k], y[k])


@pytest.mark.parametrize("prefetch", [0, 2])
def test_make_pipeline_streams_are_identical(prefetch):
    from repro.data import pipeline as ref_pipe
    from repro_torch.data import pipeline as pt_pipe

    kw = dict(vocab=300, seq_len=32, global_batch=2, seed=1)
    a = ref_pipe.make_pipeline(ref_pipe.DataConfig(**kw), start_step=5,
                               prefetch=prefetch)
    b = pt_pipe.make_pipeline(pt_pipe.DataConfig(**kw), start_step=5,
                              prefetch=prefetch)
    for _ in range(3):
        (sa, xa), (sb, xb) = next(a), next(b)
        assert sa == sb
        assert all(np.array_equal(xa[k], xb[k]) for k in xa)
    for it in (a, b):
        if hasattr(it, "close"):
            it.close()


def _supervised_run(mod, fail_steps, rate, seed, max_restarts=8):
    saved = {"state": 0, "step": 0}
    log = []
    inj = mod.FailureInjector(fail_steps=fail_steps, rate=rate, seed=seed)

    def step_fn(state, step):
        inj.check(step)
        log.append(step)
        if step % 3 == 2:
            saved.update(state=state + 1, step=step + 1)
        return state + 1

    sup = mod.Supervisor(restore=lambda: (saved["state"], saved["step"]),
                         max_restarts=max_restarts)
    try:
        state, final = sup.run(0, 0, 20, step_fn)
    except RuntimeError as e:
        return ("exhausted", str(e), log, sup.restarts)
    return (state, final, log, sup.restarts,
            [(e["step"], e["error"]) for e in sup.events])


@pytest.mark.parametrize("fail_steps,rate,seed", [
    ((5, 11), 0.0, 0), ((), 0.2, 4), ((3,), 0.5, 1)])
def test_fault_tolerance_copy_is_identical(fail_steps, rate, seed):
    from repro.runtime import fault_tolerance as ref_ft
    from repro_torch.runtime import fault_tolerance as pt_ft

    assert _supervised_run(ref_ft, fail_steps, rate, seed) \
        == _supervised_run(pt_ft, fail_steps, rate, seed)
    with pytest.raises(pt_ft.StepFailure):
        pt_ft.FailureInjector(fail_steps=(2,)).check(2)


def _code_without_docstrings(path):
    """The module's syntax tree with every docstring removed, dumped."""
    import ast

    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef,
                             ast.AsyncFunctionDef)) and node.body:
            first = node.body[0]
            if isinstance(first, ast.Expr) and isinstance(
                    getattr(first, "value", None), ast.Constant) and \
                    isinstance(first.value.value, str):
                node.body = node.body[1:] or [ast.Pass()]
    return ast.dump(tree)


def test_evalpipe_copy_is_the_reference_code():
    """The port's evaluation runtime is the reference's module with only
    its docstrings changed (its imports are the same relative ones)."""
    import repro.core.evalpipe as ref_ep
    import repro_torch.core.evalpipe as pt_ep

    assert _code_without_docstrings(pt_ep.__file__) \
        == _code_without_docstrings(ref_ep.__file__)


def test_store_predictor_is_identical():
    from repro.core import evalpipe as ref_ep
    from repro_torch.core import evalpipe as pt_ep

    rng = np.random.default_rng(6)
    space_a, space_b = _space(ref_state, True), _space(pt_state, True)
    a = ref_sur.MeasurementStore(3, half_life=5.0)
    b = pt_sur.MeasurementStore(3, half_life=5.0)
    valid = space_a.valid_states()
    pa, pb = ref_ep.StorePredictor(space_a, a), pt_ep.StorePredictor(
        space_b, b)
    assert pa(valid[:3]) is None and pb(valid[:3]) is None
    for t in range(30):
        s = valid[int(rng.integers(len(valid)))]
        y = float(rng.normal())
        a.add(s, y, float(t))
        b.add(s, y, float(t))
    for now in (None, 40.0):
        for x, z in zip(pa(valid, now), pb(valid, now)):
            assert np.array_equal(x, z)


@pytest.mark.parametrize("half_width", [1, 2, 6])
def test_window_space_is_identical(half_width):
    dims_a = (ref_state.Dimension("n", tuple(range(20))),
              ref_state.Dimension("f", ("a", "b", "c"), kind="categorical"),
              ref_state.Dimension("m", (1, 2, 4)))
    dims_b = (pt_state.Dimension("n", tuple(range(20))),
              pt_state.Dimension("f", ("a", "b", "c"), kind="categorical"),
              pt_state.Dimension("m", (1, 2, 4)))
    a_space = ref_state.ConfigSpace(dims_a)
    b_space = pt_state.ConfigSpace(dims_b)
    for center in [(0, 1, 0), (9, 0, 2), (19, 2, 1)]:
        a, oa = ref_sur.window_space(a_space, center, half_width)
        b, ob = pt_sur.window_space(b_space, center, half_width)
        assert [d.values for d in a.dimensions] \
            == [d.values for d in b.dimensions]
        assert [d.kind for d in a.dimensions] \
            == [d.kind for d in b.dimensions]
        assert np.array_equal(oa, ob)
    with pytest.raises(ValueError):
        pt_sur.window_space(b_space, (0, 0, 0), 0)


def test_expected_improvement_is_identical():
    rng = np.random.default_rng(8)
    mean = rng.normal(size=(7, 5))
    unc = np.abs(rng.normal(size=(7, 5)))
    unc[0] = 0.0                                  # measured: no credit
    for y_best in (-1.0, 0.0, 0.7):
        a = ref_sur.expected_improvement(mean, unc, y_best)
        b = pt_sur.expected_improvement(mean, unc, y_best)
        assert np.array_equal(a, b)
    assert (b >= 0).all()
