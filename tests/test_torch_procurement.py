"""The port's procurement loop against the reference's: ``offline_plan``
under the reference's replayed draws, ``plan()`` through both objective
sources, the decision-provenance contract, the spaces, and the paper's
figure checks (Figs. 2-11) run on the CPU."""

import functools

import jax
import numpy as np
import pytest
import torch

import repro_torch.telemetry as telemetry
from repro.core import annealing as jann
from repro.core import procurement as jproc
from repro.core.costmodel import SimulatedEvaluator as JEvaluator
from repro.core.landscape import BLEND_BEFORE as J_BLEND
from repro.core.objective import Objective as JObjective
from repro.core.pricing import EC2_CATALOG_ADJUSTED as J_EC2
from repro.core.pricing import TPU_CATALOG as J_TPU
from repro_torch import quickstart
from repro_torch.core import annealing as pann
from repro_torch.core import procurement as pproc
from repro_torch.core.costmodel import SimulatedEvaluator
from repro_torch.core.landscape import BLEND_BEFORE
from repro_torch.core.objective import Objective
from repro_torch.core.pricing import EC2_CATALOG_ADJUSTED, TPU_CATALOG
from repro_torch.core.surrogate import SurrogateSource
from repro_torch.figures import blended_workloads, common, paper_figures
from repro_torch.kernels import ops
from repro_torch.telemetry.provenance import F32_EPS, ladder_sum

from test_torch_jax_draws import nd_chain_draws, numpy_draws

CORES = tuple(range(4, 132, 8))


def _port(seed=0, **kw):
    kw.setdefault("blend", dict(BLEND_BEFORE))
    return pproc.ProcurementController(
        space=pproc.make_ec2_space(EC2_CATALOG_ADJUSTED, core_counts=CORES),
        catalog=EC2_CATALOG_ADJUSTED,
        evaluator=SimulatedEvaluator(EC2_CATALOG_ADJUSTED),
        objective=Objective(lambda_cost=1.0), schedule=1.0, seed=seed,
        device="cpu", **kw)


def _ref(seed=0, **kw):
    kw.setdefault("blend", dict(J_BLEND))
    return jproc.ProcurementController(
        space=jproc.make_ec2_space(J_EC2, core_counts=CORES), catalog=J_EC2,
        evaluator=JEvaluator(J_EC2), objective=JObjective(lambda_cost=1.0),
        schedule=1.0, seed=seed, **kw)


# ---------------------------------------------------------------------------
# offline_plan and plan()
# ---------------------------------------------------------------------------


def _replayed_fleet(space, seed, n_chains, n_steps):
    """``repro_torch.core.annealing.anneal_fleet`` with the initial states
    and draws the reference's ``anneal_fleet(jax.random.key(seed), ...)``
    makes: ``split(key)`` -> (key, k_init), the inits from k_init, then
    ``split(key, n_chains)``, each chain on ``_chain_nd_core``'s
    schedule."""
    enc = space.encoded()
    key, k_init = jax.random.split(jax.random.key(seed))
    inits = np.array(jann.random_valid_states(k_init, enc, n_chains))
    keys = jax.random.split(key, n_chains)
    draws = numpy_draws(jax.vmap(nd_chain_draws, (0, None, None))(
        keys, enc.shape, n_steps))
    return functools.partial(pann.anneal_fleet, inits=inits, draws=draws)


@pytest.mark.parametrize("seed,n_chains,n_steps,tau", [
    (0, 16, 40, 1.0), (3, 8, 120, 0.3), (5, 32, 10, 4.0)])
def test_offline_plan_equals_jax_under_replayed_draws(monkeypatch, seed,
                                                       n_chains, n_steps,
                                                       tau):
    port, ref = _port(), _ref()
    want = jproc.offline_plan(ref.space, ref._plan_objective,
                              n_chains=n_chains, n_steps=n_steps, tau=tau,
                              seed=seed)
    monkeypatch.setattr(pproc, "anneal_fleet", _replayed_fleet(
        ref.space, seed, n_chains, n_steps))
    got = pproc.offline_plan(port.space, port._plan_objective,
                             n_chains=n_chains, n_steps=n_steps, tau=tau,
                             seed=seed, device="cpu")
    assert got == want


@pytest.mark.parametrize("source", ["exhaustive", "surrogate"])
def test_plan_lands_near_the_tables_valid_minimum(source):
    """As tests/test_annealing_nd.py's planner check: the planned y is
    within 1.02x of the table's valid minimum; the online chain restarts
    there with its objective unmeasured; one walk for the plan."""
    kw = {"evaluate_blend": True}
    if source == "surrogate":
        kw["objective_source"] = SurrogateSource(n_probe=24, seed=1,
                                                 device="cpu")
    c = _port(**kw)
    calls = []
    real = ops.anneal_walk

    def count(*a, **k):
        calls.append(1)
        return real(*a, **k)

    ops.reset_launches()
    pann_ops = pann.ops
    try:
        pann_ops.anneal_walk = count
        cfg, y = c.plan(n_chains=64, n_steps=100)
    finally:
        pann_ops.anneal_walk = real
    assert calls == [1]
    assert ops.LAUNCHES["anneal_walk"] == 0       # the plain walk on the CPU
    enc = c.space.encoded()
    if source == "exhaustive":
        table = pproc.tabulate(c.space, c._plan_objective,
                               valid_mask=enc.valid_mask)
    else:
        table = c.objective_source.table(c.space, c._plan_objective,
                                         valid_mask=enc.valid_mask)
    assert y <= 1.02 * float(np.min(table))
    assert c.annealer.y is None
    assert c.space.decode(c.annealer.state)["n_workers"] == cfg.n_workers
    d = c.submit()                                # re-measured online
    assert np.isfinite(d.y)


@pytest.mark.parametrize("where", ["cuda", "cuda:1", "meta"])
def test_controller_refuses_a_surrogate_source_on_another_device(where):
    """A source built for another device is refused, not moved: the
    caller's object keeps its device."""
    src = SurrogateSource(n_probe=24, seed=1, device=where)
    with pytest.raises(ValueError, match="objective_source interpolates"):
        _port(objective_source=src)
    assert src.device == where


def test_controller_on_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present; the refusal needs a host without")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pproc.ProcurementController(
            space=pproc.make_ec2_space(EC2_CATALOG_ADJUSTED),
            catalog=EC2_CATALOG_ADJUSTED,
            evaluator=SimulatedEvaluator(EC2_CATALOG_ADJUSTED))


# ---------------------------------------------------------------------------
# Spaces and schedules.
# ---------------------------------------------------------------------------


def _same_space(a, b):
    ea, eb = a.encoded(), b.encoded()
    assert a.names == b.names
    assert [d.values for d in a.dimensions] == [d.values for d in b.dimensions]
    assert ea.shape == eb.shape and ea.categorical == eb.categorical
    if ea.valid_mask is None:
        assert eb.valid_mask is None
    else:
        assert np.array_equal(ea.valid_mask, eb.valid_mask)


def test_make_ec2_space_matches_reference():
    _same_space(pproc.make_ec2_space(EC2_CATALOG_ADJUSTED),
                jproc.make_ec2_space(J_EC2))
    _same_space(pproc.make_ec2_space(EC2_CATALOG_ADJUSTED, CORES),
                jproc.make_ec2_space(J_EC2, CORES))


def test_make_tpu_space_matches_reference():
    a = pproc.make_tpu_space(TPU_CATALOG)
    _same_space(a, jproc.make_tpu_space(J_TPU))
    assert 0 < a.encoded().valid_mask.mean() < 1


def test_default_adaptive_schedule_matches_reference():
    a = pproc.default_adaptive_schedule(0.5)
    b = jproc.default_adaptive_schedule(0.5)
    for s in (a, b):
        s.reheat(10)
    assert [a(n) for n in range(40)] == [b(n) for n in range(40)]


# ---------------------------------------------------------------------------
# Decision provenance: the two-tier contract, and the reference's records.
# ---------------------------------------------------------------------------


def _records(tel):
    return [r for r in tel.provenance.records()
            if r.controller == "procurement"]


@pytest.mark.parametrize("evaluate_blend", [False, True])
def test_procurement_records_hold_the_two_tier_contract(evaluate_blend):
    """Tier 1: the exact split, summed as the controller committed it (a
    left-to-right ladder from 0.0, ``provenance.ladder_sum``; Python's
    compensated ``sum()`` can differ in the last place), is y exactly.
    Tier 2: the named terms are within the float32 bar.  And every record
    is the reference's."""
    import repro.telemetry as jtel

    with telemetry.session() as tel:
        _port(seed=1, evaluate_blend=evaluate_blend).run(16)
        recs = _records(tel)
    with jtel.session() as jt:
        _ref(seed=1, evaluate_blend=evaluate_blend).run(16)
        jrecs = [r for r in jt.provenance.records()
                 if r.controller == "procurement"]
    assert len(recs) == 16
    for r in recs:
        assert ladder_sum(r.exact_split) == r.y, (r.round, r.exact_split)
        assert r.check(), (r.round, r.residual())
        assert abs(r.residual()) <= 4 * F32_EPS * max(abs(r.y), 1.0)
    blend = [r for r in recs
             if any(n.startswith("blend/") for n, _ in r.terms)]
    assert bool(blend) == evaluate_blend
    assert {r.action for r in recs} == {"accept", "reject"}
    fields = ("round", "action", "state", "y", "terms", "exact_split", "tau",
              "accept_prob", "rejected", "rejected_y", "counterfactual",
              "reheated")
    # assert_equal: NaN (no rejected candidate, no previous y) equals NaN
    np.testing.assert_equal(
        [[getattr(r, f) for f in fields] for r in recs],
        [[getattr(r, f) for f in fields] for r in jrecs])


# ---------------------------------------------------------------------------
# The figure modules and the quickstart, on the CPU.
# ---------------------------------------------------------------------------

#: The one check that is the card's to meet: the plain walk on the CPU is
#: a Python loop of torch operations, a few times the Python Annealer's
#: speed, not ten.
CARD_ONLY = ">= 10x speedup over the Python Annealer"


@pytest.fixture
def bench_out(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_BENCH_OUT", str(tmp_path))
    return tmp_path


@pytest.mark.parametrize(
    "bench", paper_figures.BENCHES + blended_workloads.BENCHES,
    ids=lambda f: f.__name__)
def test_figure_checks_pass_on_the_cpu(bench, bench_out):
    res = bench("cpu")
    failed = [c["description"] for c in res["checks"]
              if not c["ok"] and not c["description"].startswith(CARD_ONLY)]
    assert res["checks"] and not failed, failed
    assert list(bench_out.iterdir())              # evidence was written


def test_figure_cli_exit_codes(bench_out, capsys):
    def good(device):
        b = common.Bench("good", "-")
        b.check("holds", True)
        return b.finish()

    def bad(device):
        b = common.Bench("bad", "-")
        b.check("fails", False)
        return b.finish()

    assert common.main([good], ["--device", "cpu"]) == 0
    assert common.main([good, bad], ["--device", "cpu"]) == 1
    out = capsys.readouterr().out
    assert "[PASS] good" in out and "[FAIL] bad" in out
    assert common.out_dir() == bench_out


def test_quickstart_runs_on_the_cpu(capsys):
    assert quickstart.main(["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "best seen: (memory" in out and "same decisions" in out
