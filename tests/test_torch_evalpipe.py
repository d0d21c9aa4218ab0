"""The port's evaluation runtime (``core/evalpipe.py``, numpy and threads)
and the controllers that run on it, side by side with the reference's.

``ProcurementController`` is numpy end to end, so under one seed the
port's decision trace equals the reference's bit for bit: inline, and
through the speculative pipeline at lookahead 1 and 8, hedged or not,
with probe prefetch and under forced reheats.  ``SizingController``'s
pooled measurement (``eval_workers`` > 1) decides as the serial one and
as the reference's on a space small enough that every round's walk finds
its optimum."""

import dataclasses
import threading

import numpy as np
import pytest

from repro.core import ProcurementController as JController
from repro.core import make_ec2_space as j_ec2_space
from repro.core import sizing as jsz
from repro.core.change_detect import PageHinkley as JPageHinkley
from repro.core.costmodel import SimulatedEvaluator as JEvaluator
from repro.core.evalpipe import measure_requests as j_measure_requests
from repro.core.objective import Objective as JObjective
from repro.core.pricing import EC2_CATALOG_ADJUSTED as J_CATALOG
from repro.workloads import microservice as jms
from repro_torch.core import (
    EC2_CATALOG_ADJUSTED,
    Annealer,
    ConfigSpace,
    Dimension,
    EvalDispatcher,
    EvalRequest,
    EvalResult,
    MeasurementStore,
    Objective,
    PageHinkley,
    ProcurementController,
    StepNeighborhood,
    make_ec2_space,
    measure_requests,
)
from repro_torch.core import sizing as psz
from repro_torch.core.costmodel import SimulatedEvaluator
from repro_torch.core.landscape import BLEND_BEFORE
from repro_torch.workloads import microservice as pms

CORES = tuple(range(4, 68, 8))


@dataclasses.dataclass
class CountingEvaluator(SimulatedEvaluator):
    """Simulated measurements with a thread-safe call counter — the
    ground truth for exactly-once accounting."""

    wall_clock = True     # route through the worker pool

    def __post_init__(self):
        super().__post_init__()
        self.calls = 0
        self._call_lock = threading.Lock()

    def measure(self, config, job, n):
        with self._call_lock:
            self.calls += 1
        return super().measure(config, job, n)


@dataclasses.dataclass
class JCountingEvaluator(JEvaluator):
    wall_clock = True


def _port(evaluator=None, **kw):
    return ProcurementController(
        space=make_ec2_space(EC2_CATALOG_ADJUSTED, core_counts=CORES),
        catalog=EC2_CATALOG_ADJUSTED,
        evaluator=evaluator or SimulatedEvaluator(EC2_CATALOG_ADJUSTED),
        objective=Objective(lambda_cost=1.0), blend=dict(BLEND_BEFORE),
        schedule=1.0, seed=0, device="cpu", **kw)


def _ref(evaluator=None, **kw):
    return JController(
        space=j_ec2_space(J_CATALOG, core_counts=CORES), catalog=J_CATALOG,
        evaluator=evaluator or JEvaluator(J_CATALOG),
        objective=JObjective(lambda_cost=1.0), blend=dict(BLEND_BEFORE),
        schedule=1.0, seed=0, **kw)


def _trace(decisions):
    """The whole decision sequence, configs and measurements as tuples
    (the two packages' dataclasses are different classes), without the
    cumulative counters."""
    return [(d.n, d.job, dataclasses.astuple(d.config), d.y, d.accepted,
             d.explored, d.tau, d.reheated,
             dataclasses.astuple(d.measurement)) for d in decisions]


def _walk(decisions):
    """The realized walk: migration billing follows the speculative
    execution order, so a pipelined run's measurements may differ."""
    return [(d.n, d.job, dataclasses.astuple(d.config), d.y, d.accepted,
             d.explored) for d in decisions]


# ---------------------------------------------------------------------------
# The dispatcher and the batched measurement seam.
# ---------------------------------------------------------------------------


def _req(i):
    return EvalRequest(state=(i,), decoded={"x": i}, job="j", n=i)


def test_dispatcher_batched_is_one_ordered_call():
    calls = []

    def many(reqs):
        calls.append(len(reqs))
        return [EvalResult(y=float(r.n)) for r in reqs]

    d = EvalDispatcher(lambda r: EvalResult(y=-1.0), mode="batched",
                       measure_many=many)
    futs = d.submit_many([_req(i) for i in range(5)])
    assert calls == [5]
    assert [f.result().y for f in futs] == [0.0, 1.0, 2.0, 3.0, 4.0]
    assert d.landed == 5 and d.dispatched == 5


def test_dispatcher_pool_preserves_request_order():
    d = EvalDispatcher(lambda r: EvalResult(y=float(r.n) * 2),
                       mode="pool", max_workers=4)
    futs = d.submit_many([_req(i) for i in range(8)])
    assert [f.result().y for f in futs] == [2.0 * i for i in range(8)]
    d.close()
    assert d.landed == 8


def test_dispatcher_validates():
    with pytest.raises(ValueError):
        EvalDispatcher(lambda r: None, mode="wat")
    with pytest.raises(ValueError):
        EvalDispatcher(lambda r: None, mode="pool", max_workers=0)
    bad = EvalDispatcher(lambda r: None, mode="batched",
                         measure_many=lambda reqs: [])
    with pytest.raises(ValueError):
        bad.submit_many([_req(0)])


@pytest.mark.parametrize("workers", [None, 4])
def test_measure_requests_matches_reference(workers):
    space = make_ec2_space(EC2_CATALOG_ADJUSTED, core_counts=CORES)
    items = [(space.decode((i % 4, i % len(CORES))), "wordcount", i)
             for i in range(6)]
    got = measure_requests(SimulatedEvaluator(EC2_CATALOG_ADJUSTED), items,
                           eval_workers=workers)
    jspace = j_ec2_space(J_CATALOG, core_counts=CORES)
    jitems = [(jspace.decode((i % 4, i % len(CORES))), "wordcount", i)
              for i in range(6)]
    want = j_measure_requests(JEvaluator(J_CATALOG), jitems,
                              eval_workers=workers)
    assert [dataclasses.astuple(m) for m in got] \
        == [dataclasses.astuple(m) for m in want]
    assert got == measure_requests(SimulatedEvaluator(EC2_CATALOG_ADJUSTED),
                                   items)


def test_controller_measure_batch_counts_each_measurement_once():
    c = _port()
    items = [(c.space.decode((i % 4, i)), "kmeans", i) for i in range(5)]
    before = c.evaluation_counts()["true_measures"]
    out = c._measure_batch(items, eval_workers=3)
    assert len(out) == 5
    assert c.evaluation_counts()["true_measures"] == before + 5
    assert out == measure_requests(c.evaluator, items)


def test_annealer_snapshot_replay_reproduces_the_walk():
    space = ConfigSpace((Dimension("a", tuple(range(8))),
                         Dimension("b", tuple(range(6)))))
    table = {(i, j): (i - 3) ** 2 + (j - 2) ** 2
             for i in range(8) for j in range(6)}

    def ev(decoded, n):
        return float(table[(decoded["a"], decoded["b"])])

    ann = Annealer(space, StepNeighborhood(space), ev, schedule=0.7, seed=3)
    ann.run(5)
    snap = ann.snapshot()
    first = [(s.proposed, s.accepted, s.state) for s in ann.run(10)]
    ann.restore(snap)
    replay = [(s.proposed, s.accepted, s.state) for s in ann.run(10)]
    assert first == replay
    assert len(ann.history) == 25


# ---------------------------------------------------------------------------
# ProcurementController: the port's decisions are the reference's.
# ---------------------------------------------------------------------------

#: (controller options, jobs, whole trace or the walk only)
PROCUREMENT_CASES = {
    "inline": ({}, 60, _trace),
    "k1": ({"use_pipeline": True, "lookahead": 1}, 40, _trace),
    "k1_hedged": ({"use_pipeline": True, "lookahead": 1,
                   "hedge_margin": 0.5}, 40, _trace),
    "k8": ({"use_pipeline": True, "lookahead": 8}, 50, _walk),
    "k8_hedged": ({"use_pipeline": True, "lookahead": 8,
                   "hedge_margin": 0.3}, 60, _walk),
    "k8_prefetch": ({"lookahead": 8, "prefetch_probes": 4}, 50, _walk),
    "blend": ({"evaluate_blend": True}, 60, _trace),
    "blend_k8": ({"evaluate_blend": True, "lookahead": 8}, 50, _walk),
}


@pytest.mark.parametrize("case", list(PROCUREMENT_CASES))
def test_procurement_decisions_equal_the_reference(case):
    kw, n, view = PROCUREMENT_CASES[case]
    port, ref = _port(**kw), _ref(**kw)
    got, want = port.run(n), ref.run(n)
    port.close()
    ref.close()
    assert view(got) == view(want)
    # and the pipelined walk is the port's own serial walk
    serial = _port(**{k: v for k, v in kw.items()
                      if k == "evaluate_blend"}).run(n)
    assert _walk(got) == _walk(serial)
    if kw.get("lookahead", 1) > 1:
        assert port.stats()["pipeline"]["resolved"] == n


@pytest.mark.parametrize("lookahead", [1, 8])
def test_procurement_detector_and_reheats_equal_the_reference(lookahead):
    port = _port(evaluate_blend=True, detector=PageHinkley(min_obs=5),
                 lookahead=lookahead)
    ref = _ref(evaluate_blend=True, detector=JPageHinkley(min_obs=5),
               lookahead=lookahead)
    got, want = [], []
    for _ in range(3):
        got += port.run(12)
        want += ref.run(12)
        port.force_reheat()
        ref.force_reheat()
    port.close()
    ref.close()
    assert _walk(got) == _walk(want)
    assert [d.reheated for d in got] == [d.reheated for d in want]


@pytest.mark.parametrize("hedge", [0.0, 0.3])
def test_speculative_measurements_counted_exactly_once(hedge):
    ev = CountingEvaluator(EC2_CATALOG_ADJUSTED)
    c = _port(evaluator=ev, lookahead=8, hedge_margin=hedge)
    c.run(50)
    c.close()
    stats = c.stats()["pipeline"]
    assert stats["mispredictions"] > 0
    counts = c.evaluation_counts()
    assert counts["true_measures"] == ev.calls
    assert c.annealer.measure_count == ev.calls
    assert 0 < len(c.recycle_store) <= ev.calls
    disp = c._pipeline.dispatcher
    assert disp.dispatched == disp.landed + stats["cancelled"]
    if hedge:
        assert stats["hedged"] > 0


def test_wall_clock_pipeline_equals_the_reference():
    port = _port(evaluator=CountingEvaluator(EC2_CATALOG_ADJUSTED),
                 lookahead=8, hedge_margin=0.3)
    ref = _ref(evaluator=JCountingEvaluator(J_CATALOG), lookahead=8,
               hedge_margin=0.3)
    got, want = port.run(40), ref.run(40)
    port.close()
    ref.close()
    assert _walk(got) == _walk(want)


def test_pipeline_close_leaves_chain_serially_continuable():
    a = _port()
    b = _port(use_pipeline=True, lookahead=8)
    da = a.run(30)
    db = b.run(20)
    b.close()
    b._pipeline = None            # continue inline on the same chain
    db += b.run(10)
    assert [(d.n, d.config, d.accepted) for d in da] \
        == [(d.n, d.config, d.accepted) for d in db]


# ---------------------------------------------------------------------------
# SizingController on the measurement pool.
# ---------------------------------------------------------------------------


def _sizing_spec(sz, ms):
    tiers = (ms.ServiceTier("gw", base_rate=60.0),
             ms.ServiceTier("auth", base_rate=80.0))
    classes = (ms.RequestClass("browse", "gw", {"gw": 1, "auth": 1},
                               slo_s=0.35),)
    dag = ms.MicroserviceDAG(tiers, (("gw", "auth"),), classes)
    return sz.SizingSpace(dag,
                          sizes=(ms.ContainerSize("s", 1, 2.0),
                                 ms.ContainerSize("l", 4, 8.0)),
                          replica_counts=(1, 2, 3), lambda_cost=0.5,
                          slo_penalty=50.0)


@pytest.mark.parametrize("topk", [1, 4])
def test_sizing_pool_decides_as_serial_and_as_the_reference(topk):
    """36 states, 8 chains x 48 steps a round: every round's walk visits
    the optimum and the top-K candidates, in the reference as in the port,
    so the committed decisions agree whatever the random streams."""
    mix = {"browse": 40.0}

    def tr(ds):
        return [(d.n, d.y, tuple(sorted(d.sizing.items())), d.reheated,
                 d.true_measures) for d in ds]

    spec = _sizing_spec(psz, pms)
    serial = psz.SizingController(spec, mix, seed=0, measure_topk=topk,
                                  device="cpu").run(5)
    store = MeasurementStore(len(spec.space.dimensions))
    pooled = psz.SizingController(spec, mix, seed=0, measure_topk=topk,
                                  eval_workers=4, recycle_store=store,
                                  device="cpu").run(5)
    want = jsz.SizingController(_sizing_spec(jsz, jms), mix, seed=0,
                                measure_topk=topk, eval_workers=4).run(5)
    assert tr(pooled) == tr(serial) == tr(want)
    if topk > 1:
        assert len(store) >= topk                 # candidates recycled
    assert np.isfinite([d.y for d in pooled]).all()
