"""The port's container-sizing slice against the JAX package: the grid
table, the surrogate table, both controllers on the same drifting mix, and
a JAX controller's state carried into the port mid-run.  Everything runs
on the CPU at the 6-tier size of tests/test_sizing.py."""

import numpy as np
import pytest
import torch

from repro.core import sizing as jsz
from repro.core import surrogate as jsur
from repro.workloads import microservice as jms
from repro_torch import interop
from repro_torch.core import sizing as psz
from repro_torch.core import surrogate as psur
from repro_torch.kernels import ops
from repro_torch.workloads import microservice as pms

MIX_BROWSE = {"browse": 40.0, "checkout": 8.0}
MIX_CHECKOUT = {"browse": 10.0, "checkout": 45.0}


def _dag(ms):
    """The 6-tier DAG of tests/test_sizing.py (fan-out, a memory-bound
    tier, two classes loading different tiers)."""
    tiers = (
        ms.ServiceTier("gw", base_rate=60.0),
        ms.ServiceTier("auth", base_rate=80.0),
        ms.ServiceTier("catalog", base_rate=40.0, mem_per_rps_gb=0.08),
        ms.ServiceTier("product", base_rate=35.0),
        ms.ServiceTier("pricing", base_rate=90.0),
        ms.ServiceTier("inventory", base_rate=50.0),
    )
    edges = (("gw", "auth"), ("gw", "catalog"), ("catalog", "product"),
             ("product", "pricing"), ("product", "inventory"),
             ("auth", "inventory"))
    classes = (
        ms.RequestClass("browse", "gw",
                        {"gw": 1, "catalog": 1, "product": 2, "pricing": 2,
                         "inventory": 1}, slo_s=0.35),
        ms.RequestClass("checkout", "gw",
                        {"gw": 1, "auth": 1, "inventory": 2, "pricing": 1},
                        slo_s=0.5),
    )
    return ms.MicroserviceDAG(tiers, edges, classes)


def _spec(sz, ms, **kw):
    kw.setdefault("sizes", (ms.ContainerSize("s", 1, 2.0),
                            ms.ContainerSize("l", 4, 8.0)))
    kw.setdefault("replica_counts", (1, 2, 3))
    kw.setdefault("lambda_cost", 0.5)
    kw.setdefault("slo_penalty", 50.0)
    return sz.SizingSpace(_dag(ms), **kw)


def _pspec(**kw):
    return _spec(psz, pms, **kw)


def _jspec(**kw):
    return _spec(jsz, jms, **kw)


def _true_optimum(spec, mix):
    """The grid optimum on the numpy ground truth.  The table (float32,
    within 2e-4 of the truth — see the table test) narrows the grid to the
    states within 1e-3 of its minimum, which must hold the true argmin."""
    table = psz.sizing_table_device(spec, mix, device="cpu").numpy()
    grid = psz.full_grid(spec.space)
    near = grid[table <= table.min() * (1 + 1e-3)]
    return min(spec.host_objective(spec.space.decode(s), mix)["y"]
               for s in near)


@pytest.mark.parametrize("mix", [MIX_BROWSE, MIX_CHECKOUT])
def test_sizing_table_matches_jax(mix):
    want = np.asarray(jsz.sizing_table_device(_jspec(), mix))
    spec = _pspec()
    got = psz.sizing_table_device(spec, mix, device="cpu")
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4)


def test_evaluate_sizing_batch_matches_host_model_and_jax():
    spec, jspec = _pspec(), _jspec()
    rng = np.random.default_rng(0)
    grid = psz.full_grid(spec.space)
    cand = grid[rng.choice(len(grid), 32, replace=False)]
    res = psz.evaluate_sizing_batch(spec, cand, MIX_BROWSE, device="cpu")
    jres = jsz.evaluate_sizing_batch(jspec, cand, MIX_BROWSE)
    for k in ("y", "latency", "cost", "slo_attainment"):
        np.testing.assert_allclose(res[k], jres[k], rtol=2e-4, atol=1e-6)
    for i, idx in enumerate(cand):
        host = spec.host_objective(spec.space.decode(list(idx)), MIX_BROWSE)
        assert res["y"][i] == pytest.approx(host["y"], rel=2e-4)


def test_surrogate_source_table_matches_jax():
    jspec, spec = _jspec(replica_counts=(1, 2)), _pspec(replica_counts=(1, 2))
    jsrc = jsur.SurrogateSource(n_probe=256, seed=0)
    psrc = psur.SurrogateSource(n_probe=256, seed=0, device="cpu")
    # the same numpy seed probes the same states
    np.testing.assert_array_equal(
        jsur.SurrogateSource(n_probe=256, seed=0)._probe_states(
            jspec.space, None),
        psur.SurrogateSource(n_probe=256, seed=0)._probe_states(
            spec.space, None))
    want = jsrc.table(jspec.space, lambda d: float(
        jspec.host_objective(d, MIX_BROWSE)["y"]))
    got = psrc.table(spec.space, lambda d: float(
        spec.host_objective(d, MIX_BROWSE)["y"]))
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=1e-4)
    assert psrc.counts() == jsrc.counts()
    assert psrc.true_measures == 256


def test_both_controllers_converge_and_track_drift():
    """The assertions of tests/test_sizing.py's controller test, for the
    JAX controller and the port's on the same spec and drifting mix."""
    spec = _pspec()
    opt1 = _true_optimum(spec, MIX_BROWSE)
    opt2 = _true_optimum(spec, MIX_CHECKOUT)
    runs = {
        "jax": jsz.SizingController(
            _jspec(), jms.DriftingMix(MIX_BROWSE, MIX_CHECKOUT, change_at=6),
            steps_per_round=64, n_chains=16, seed=0).run(14),
        "torch": psz.SizingController(
            spec, pms.DriftingMix(MIX_BROWSE, MIX_CHECKOUT, change_at=6),
            steps_per_round=64, n_chains=16, seed=0, device="cpu").run(14),
    }
    for name, ds in runs.items():
        pre, post = ds[5], ds[-1]
        assert pre.y <= 1.10 * opt1, name
        assert post.y <= 1.10 * opt2, name
        assert post.slo_attainment == 1.0, name
        assert pre.sizing != post.sizing, name
        assert pre.y >= opt1 - 1e-9 and post.y >= opt2 - 1e-9, name
        tms = [d.true_measures for d in ds]
        assert tms == sorted(tms), name
    # every committed y is the ground truth at the committed sizing
    for r, d in enumerate(runs["torch"]):
        mix = MIX_BROWSE if r < 6 else MIX_CHECKOUT
        assert d.y == spec.host_objective(d.sizing, mix)["y"]
        assert isinstance(d, psz.SizingDecision)


def test_port_controller_is_deterministic_under_seed():
    runs = []
    for _ in range(2):
        ctrl = psz.SizingController(_pspec(), MIX_BROWSE, steps_per_round=16,
                                    n_chains=4, seed=3, device="cpu")
        runs.append([(d.sizing, d.y, d.explored) for d in ctrl.run(4)])
    assert runs[0] == runs[1]
    other = psz.SizingController(_pspec(), MIX_BROWSE, steps_per_round=16,
                                 n_chains=4, seed=4, device="cpu").run(4)
    assert [(d.sizing, d.y, d.explored) for d in other] != runs[0]


@pytest.mark.parametrize("topk", [1, 4])
def test_device_loop_and_host_path_decide_alike(topk):
    """The on-device top-K selection reproduces the host path's stable
    argsort + first-distinct dedup exactly, for the same walks."""
    logs = []
    for device_loop in (True, False):
        ctrl = psz.SizingController(
            _pspec(), pms.DriftingMix(MIX_BROWSE, MIX_CHECKOUT, change_at=3),
            steps_per_round=32, n_chains=8, seed=1, measure_topk=topk,
            device_loop=device_loop, device="cpu")
        logs.append([(d.sizing, d.y, d.explored, d.true_measures)
                     for d in ctrl.run(6)])
    assert logs[0] == logs[1]


def test_sizing_select_pads_and_flags():
    shape = (3, 2)
    table = torch.tensor([5.0, 4.0, 3.0, 2.0, 1.0, 0.5])
    inits = torch.tensor([[0, 0], [0, 0]], dtype=torch.int32)
    states = torch.tensor([[[0, 1], [0, 1]], [[0, 0], [1, 0]]],
                          dtype=torch.int32)
    ys = torch.tensor([[4.0, 4.0], [5.0, 3.0]])
    accepts = torch.tensor([[True, False], [False, True]])
    sel, explored = psz.sizing_select(shape, 5, inits, states, table, ys,
                                      accepts)
    # distinct visited states by table value: (1,0)=3, (0,1)=4, (0,0)=5
    assert sel.tolist() == [[1, 0], [0, 1], [0, 0], [-1, -1], [-1, -1]]
    assert not bool(explored)          # every accepted move went downhill
    _, explored = psz.sizing_select(shape, 1, inits, states, table,
                                    torch.tensor([[6.0, 4.0], [5.0, 3.0]]),
                                    accepts)
    assert bool(explored)              # chain 0 accepted 6.0 over 5.0


def test_jax_controller_state_continues_in_the_port():
    mix = jms.DriftingMix(MIX_BROWSE, MIX_CHECKOUT, change_at=2)
    jctrl = jsz.SizingController(_jspec(), mix, steps_per_round=32,
                                 n_chains=8, seed=2)
    jctrl.force_reheat()
    jctrl.run(3)
    state = interop.sizing_state(jctrl)
    spec = _pspec()
    ctrl = psz.SizingController(
        spec, pms.DriftingMix(MIX_BROWSE, MIX_CHECKOUT, change_at=2),
        steps_per_round=32, n_chains=8, seed=2, device="cpu")
    ctrl.load_state(state)
    assert interop.sizing_state(ctrl) == state
    assert ctrl._schedule.tau_array(96, 4).tolist() \
        == jctrl._schedule.tau_array(96, 4).tolist()
    loaded = ctrl.incumbent
    d = ctrl.round()
    assert d.n == 3 and ctrl._round == 4
    table = psz.sizing_table_device(spec, MIX_CHECKOUT, device="cpu")
    flat = lambda s: int(np.ravel_multi_index(s, spec.space.shape))
    assert table[flat(ctrl.incumbent)] <= table[flat(loaded)]


def test_measurement_store_from_arrays_round_trips():
    rng = np.random.default_rng(5)
    src = jsur.MeasurementStore(4, half_life=3.0, capacity=16)
    for t in range(30):
        src.add(tuple(rng.integers(0, 3, 4)), float(rng.normal()), float(t))
    obs, ys, ts = src.arrays()
    dst = interop.measurement_store_from_arrays(obs, ys, ts, half_life=3.0,
                                                capacity=16)
    for a, b in zip(src.arrays(), dst.arrays()):
        np.testing.assert_array_equal(a, b)
    assert dst.best(29.0, 5.0) == src.best(29.0, 5.0)


@pytest.mark.parametrize("kind", ["idw", "rbf"])
def test_surrogate_predict_matches_jax(kind):
    """Queries at measured and unmeasured states through both models (the
    JAX one through its Pallas kernel in interpret mode)."""
    spec = _pspec(replica_counts=(1, 2))
    rng = np.random.default_rng(6)
    grid = psz.full_grid(spec.space)
    picks = grid[rng.choice(len(grid), 50, replace=False)]
    stores = (jsur.MeasurementStore(len(spec.space.shape), half_life=5.0),
              psur.MeasurementStore(len(spec.space.shape), half_life=5.0))
    for t, s in enumerate(picks):
        y = float(spec.host_objective(spec.space.decode(list(s)),
                                      MIX_BROWSE)["y"])
        for store in stores:
            store.add(s, y, float(t))
    queries = np.concatenate([picks, grid[::7]])
    want = jsur.SurrogateModel(
        jsur.SpaceEncoding.from_space(_jspec(replica_counts=(1, 2)).space),
        kind=kind).predict(queries, stores[0])
    got = psur.SurrogateModel(psur.SpaceEncoding.from_space(spec.space),
                              kind=kind, device="cpu").predict(queries,
                                                               stores[1])
    for g, w in zip(got, want):
        assert g.dtype == np.float64 and g.shape == w.shape
        np.testing.assert_allclose(g, w, atol=2e-5, rtol=1e-4)
    assert (got[1][:len(picks)] == 0).all()       # no uncertainty there


def test_controller_refusals():
    big = _pspec(sizes=(pms.ContainerSize("s", 1, 2.0),
                        pms.ContainerSize("m", 2, 4.0),
                        pms.ContainerSize("l", 4, 8.0)),
                 replica_counts=(1, 2, 3, 4))
    with pytest.raises(ValueError, match="SurrogateSource"):
        psz.SizingController(big, MIX_BROWSE, device="cpu")


def test_cpu_main_path_launches_no_kernel():
    ops.reset_launches()
    psz.SizingController(_pspec(replica_counts=(1, 2)), MIX_BROWSE,
                         steps_per_round=8, n_chains=2, device="cpu").run(2)
    assert ops.LAUNCHES == dict.fromkeys(
        ("sizing_latency", "fused_interp", "flash_attention",
         "flash_decode", "flash_attention_bwd", "quantize_int8",
         "rglru_scan", "wkv6", "pairwise_sqdist", "anneal_walk"), 0)
