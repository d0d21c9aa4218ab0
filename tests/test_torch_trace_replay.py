"""The port's trace-driven fleet replay against the reference's.

``TraceReplayController`` under the reference's replayed draws replays the
reference's parity case (16 tenants, 240 s, seed 7; ``trace_fleet.py``'s
smoke) decision for decision, full and incremental; its own event guards,
ticking, stats and metrics; the fleet's benchmark twins
(``repro_torch.figures``) run on the CPU with every check passing, and
``pipeline_overlap``'s decision checks without its modelled latency."""

import dataclasses
import math

import pytest

from repro.core import EC2_CATALOG_ADJUSTED as J_EC2
from repro.core import Objective as JObjective
from repro.core import PenalizedObjective as JPenalized
from repro.core import make_ec2_space as j_space
from repro.core.costmodel import SimulatedEvaluator as JEvaluator
from repro.core.trace_replay import TraceReplayController as JReplay
from repro.workloads.trace import synthetic_trace as j_trace
from repro_torch import telemetry
from repro_torch.core import (
    EC2_CATALOG_ADJUSTED,
    Objective,
    PenalizedObjective,
    TraceReplayController,
    make_ec2_space,
)
from repro_torch.core import fleet as pfleet
from repro_torch.core.costmodel import SimulatedEvaluator
from repro_torch.figures import fleet_arbitration, pipeline_overlap
from repro_torch.figures import trace_fleet
from repro_torch.workloads.trace import TraceEvent, synthetic_trace

from test_torch_fleet import decision_log
from test_torch_jax_draws import fleet_draws


def _replay(pkg, T, horizon_s, seed, **kw):
    """``benchmarks/trace_fleet.py``'s controller in either package."""
    if pkg == "jax":
        cat_src, space_fn, Ev, Obj, Pen, gen, Ctl = (
            J_EC2, j_space, JEvaluator, JObjective, JPenalized, j_trace,
            JReplay)
    else:
        cat_src, space_fn, Ev, Obj, Pen, gen, Ctl = (
            EC2_CATALOG_ADJUSTED, make_ec2_space, SimulatedEvaluator,
            Objective, PenalizedObjective, synthetic_trace,
            TraceReplayController)
        kw["device"] = "cpu"
    catalog = cat_src.with_capacities(
        {f: 12.0 * T for f in cat_src.names()})
    space = space_fn(catalog, core_counts=tuple(range(4, 132, 8)))
    evaluator = Ev(catalog)
    trace = gen(sorted(evaluator.jobs), n_tenants=T, horizon_s=horizon_s,
                seed=seed, n_profiles=12)
    return Ctl(trace, space, catalog, evaluator,
               objective=Pen(Obj(lambda_cost=200.0), weight=25.0),
               budget_usd_hr=1.6 * T, steps_per_round=32, slo_s=3600.0,
               seed=seed, **kw)


def _strip(d):
    return {k: v for k, v in d.items() if k != "wall_s"}


@pytest.mark.parametrize("incremental", [False, True])
def test_replay_equals_jax_under_replayed_draws(monkeypatch, incremental):
    monkeypatch.setattr(pfleet, "tenant_draws", fleet_draws)
    kw = dict(incremental=incremental, keep_decision_log=True)
    ref = _replay("jax", 16, 240.0, 7, chain_bucketing=False, **kw)
    port = _replay("torch", 16, 240.0, 7, **kw)
    want, got = ref.replay(), port.replay()
    assert decision_log(port.fleet.decisions) == \
        decision_log(ref.fleet.decisions)
    assert _strip(got) == _strip(want)
    assert [_strip(r) for r in port.rounds] == [_strip(r) for r in ref.rounds]
    assert port.fleet.violation_history == ref.fleet.violation_history
    assert (port.fleet._incumbents == ref.fleet._incumbents).all()
    assert got["events_applied"]["depart"] > 0 and got["rounds"] >= 8


def test_replay_is_deterministic_and_its_summary_consistent():
    a, b = (_replay("torch", 6, 420.0, 3, keep_decision_log=True)
            for _ in range(2))
    sa, sb = a.replay(), b.replay()
    assert decision_log(a.fleet.decisions) == decision_log(b.fleet.decisions)
    assert _strip(sa) == _strip(sb)
    assert sa["rounds"] == len(a.rounds)
    assert sa["tenant_rounds"] == sum(r["n_tenants"] for r in a.rounds)
    assert 0.0 <= sa["annealed_fraction"] <= 1.0
    assert 0.0 <= sa["slo_attainment"] <= 1.0
    st = a.trace.stats()
    assert sa["events_applied"]["arrive"] == \
        st["arrivals"] - len(a.trace.founding())
    stats = a.stats()
    assert stats["controller"] == "TraceReplayController"
    assert stats["rounds"] == sa["rounds"] and stats["pipeline"] is None
    assert _strip(stats["summary"]) == _strip(sa)
    assert stats["fleet"]["controller"] == "FleetController"
    with pytest.warns(DeprecationWarning):
        assert _strip(a.summary()) == _strip(sa)


def test_incremental_holds_inactive_tenants():
    ctl = _replay("torch", 6, 420.0, 2, detectors=False, incremental=True,
                  settle_rounds=1)
    fleet = ctl.fleet
    fleet.run(3)
    before = fleet._incumbents.copy()
    ds = fleet.round()
    assert fleet.last_annealed == 0
    assert all(d.action == "hold" for d in ds)
    assert (fleet._incumbents == before).all()


def test_event_guards_skip_last_departures_and_unknown_tenants():
    ctl = _replay("torch", 2, 300.0, 0)
    trace = ctl.trace
    a, b = (e.tenant for e in trace.founding())
    events = (tuple(trace.founding())
              + (TraceEvent(10.0, "depart", a),
                 TraceEvent(20.0, "depart", b),      # would empty the fleet
                 TraceEvent(30.0, "phase", a, 1),    # a has left
                 TraceEvent(40.0, "depart", "ghost")))
    ctl.trace = dataclasses.replace(trace, events=events, horizon_s=100.0)
    s = ctl.replay()
    assert s["skipped"] == {"depart_last_tenant": 1, "unknown_tenant": 2}
    assert s["events_applied"] == {"arrive": 0, "depart": 1, "phase": 0}
    assert [t.name for t in ctl.fleet.tenants] == [b]
    # event time: the quiet tail is one jump to the horizon
    assert [r["t"] for r in ctl.rounds][-1] == 100.0


def test_tick_metrics_and_violation_events_under_telemetry():
    with telemetry.session() as tel:
        ctl = _replay("torch", 8, 240.0, 3)
        ctl.replay()
        ctl.fleet.budget_usd_hr *= 0.02
        ctl.trace = dataclasses.replace(ctl.trace, events=(),
                                        horizon_s=270.0)
        ctl.replay()
    snap = tel.snapshot()["metrics"]
    series = snap["series"]
    for name in ("trace/tenants", "trace/annealed", "trace/violation",
                 "trace/slo_attainment", "trace/round_wall_s",
                 "fleet/objective", "fleet/violation"):
        assert name in series, name
    assert snap["counters"].get("trace/events/arrive", 0) > 0
    kinds = {e.kind for e in tel.provenance.events()}
    assert {"arrive", "depart", "violation"} <= kinds
    assert math.isfinite(ctl.rounds[-1]["violation"])
    assert ctl.rounds[-1]["violation"] > 0


@pytest.mark.parametrize("module", [trace_fleet, fleet_arbitration],
                         ids=["trace_fleet", "fleet_arbitration"])
def test_fleet_figure_twins_pass_on_the_cpu(monkeypatch, tmp_path, module):
    monkeypatch.setenv("REPRO_BENCH_OUT", str(tmp_path))
    assert module.main(module.BENCHES, ["--device", "cpu", "--smoke"],
                       smoke=True) == 0
    assert list(tmp_path.glob("BENCH_torch_*.json"))


def _procurement_trace(n_jobs, **kw):
    ev = pipeline_overlap.SlowSimulatedEvaluator(
        pipeline_overlap.EC2_CATALOG_ADJUSTED, latency_s=0.0)
    ctl = pipeline_overlap._controller(ev, "cpu", **kw)
    try:
        return pipeline_overlap._trace(ctl.run(n_jobs))
    finally:
        ctl.close()


@pytest.mark.parametrize("case", ["k8_against_serial", "k1_against_inline",
                                  "fleet_pool_against_serial"])
def test_pipeline_overlap_decisions_match_without_latency(case):
    """``pipeline_overlap``'s decision checks, its timings left out (the
    twin's full run, ~20 s of modelled job latency, is timed on purpose):
    the K=8 pipeline walks the serial loop's chain, K=1 repeats the inline
    loop's whole trace, and the fleet's worker pool decides as its serial
    measurement loop does — here with no latency a job."""
    po = pipeline_overlap
    if case == "k8_against_serial":
        serial = _procurement_trace(60)
        piped = _procurement_trace(60, lookahead=po.LOOKAHEAD,
                                   hedge_margin=po.HEDGE_MARGIN)
        assert [t[:8] for t in serial] == [t[:8] for t in piped]
    elif case == "k1_against_inline":
        assert _procurement_trace(40, use_pipeline=False) \
            == _procurement_trace(40, use_pipeline=True, lookahead=1)
    else:
        serial = po._fleet(1, "cpu", latency_s=0.0).run(2)
        pooled = po._fleet(po.FLEET_TENANTS, "cpu", latency_s=0.0).run(2)
        assert po._fleet_trace(serial) == po._fleet_trace(pooled)
