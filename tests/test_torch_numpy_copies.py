"""The PyTorch port's copies of the numpy-only modules behave bit for bit
like the reference's: same inputs (numpy, from a seed) through both, exact
equality of every output."""

import math

import numpy as np
import pytest

from repro.core import change_detect as ref_cd
from repro.core import landscape as ref_land
from repro.core import objective as ref_obj
from repro.core import state as ref_state
from repro.core import surrogate as ref_sur
from repro.workloads import microservice as ref_ms
from repro_torch.core import change_detect as pt_cd
from repro_torch.core import landscape as pt_land
from repro_torch.core import objective as pt_obj
from repro_torch.core import state as pt_state
from repro_torch.core import surrogate as pt_sur
from repro_torch.workloads import microservice as pt_ms


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
