"""The port's multi-tenant fleet against the reference's.

``FleetController`` under the reference's replayed draws
(``fold_in(fold_in(key, r), id)`` per tenant) decides exactly as
``repro.core.fleet.FleetController`` does, through defers, preemptions, a
budget cap, a staggered blend change and churn; the reference's fleet
properties (``tests/test_fleet.py``, ``test_fleet_sharding.py``,
``test_ledger_properties.py``) re-pinned on the port with its own draws;
and ``tenant_draws``, the port's per-tenant streams."""

import dataclasses

import numpy as np
import pytest
import torch
from _hypothesis_shim import given, settings, st

from repro.core import fleet as jfleet
from repro.core.costmodel import SimulatedEvaluator as JEvaluator
from repro.core.objective import Objective as JObjective
from repro.core.objective import PenalizedObjective as JPenalized
from repro.core.pricing import EC2_CATALOG as J_EC2
from repro.core.pricing import ServiceCatalog as JCatalog
from repro.core.procurement import make_ec2_space as j_space
from repro_torch.core import (
    EC2_CATALOG,
    EC2_CATALOG_ADJUSTED,
    Decision,
    FleetController,
    FleetDecision,
    Objective,
    PenalizedObjective,
    ServiceCatalog,
    TenantSpec,
    make_ec2_space,
    tenant_draws,
)
from repro_torch.core import fleet as pfleet
from repro_torch.core.costmodel import SimulatedEvaluator
from repro_torch.core.state import EncodedSpace

from test_torch_jax_draws import fleet_draws

CORES = tuple(range(4, 68, 8))
FAMS = ("general", "compute", "memory", "storage")


# ---------------------------------------------------------------------------
# The port against the reference, under the reference's draws.
# ---------------------------------------------------------------------------


def _scenario(pkg, **kw):
    """Five tenants on a 64-core-a-family catalog under a $6/hr budget:
    two start on the biggest compute state (preempted in round 0), one's
    blend changes at round 3; ``churn`` below swaps and retunes tenants."""
    if pkg == "jax":
        Catalog, cat_src, Spec, Ctl = (JCatalog, J_EC2, jfleet.TenantSpec,
                                       jfleet.FleetController)
        space_fn, Ev, Obj, Pen = j_space, JEvaluator, JObjective, JPenalized
    else:
        Catalog, cat_src, Spec, Ctl = (ServiceCatalog, EC2_CATALOG,
                                       TenantSpec, FleetController)
        space_fn, Ev, Obj, Pen = (make_ec2_space, SimulatedEvaluator,
                                  Objective, PenalizedObjective)
        kw["device"] = "cpu"
    cat = Catalog({f: cat_src[f] for f in FAMS},
                  capacities={f: 64.0 for f in FAMS})
    space = space_fn(cat, core_counts=CORES)
    big = space.encode({"instance_type": "compute", "n_workers": CORES[-1]})
    tenants = [
        Spec("t0", {"wordcount": 1.0, "kmeans": 1.0}, init=big),
        Spec("t1", {"wordcount": 1.0}, priority=2.0, init=big),
        Spec("t2", {"pagerank": 1.0}, priority=1.5,
             blend_after={"wordcount": 1.0, "kmeans": 2.0}, change_at=3),
        Spec("t3", {"kmeans": 1.0, "pagerank": 1.0}, priority=1.25),
        Spec("t4", {"pagerank": 1.0, "kmeans": 3.0}, priority=0.5)]
    ctl = Ctl(space, cat, Ev(cat), tenants,
              objective=Pen(Obj(lambda_cost=200.0), weight=25.0),
              budget_usd_hr=6.0, steps_per_round=16, seed=3, **kw)
    return ctl, Spec


def _churn(ctl, Spec):
    ctl.remove_tenant("t3")
    ctl.add_tenant(Spec("late", {"kmeans": 1.0}, priority=3.0))
    ctl.retune_tenant("t4", {"wordcount": 1.0, "pagerank": 2.0})


def decision_log(decisions):
    """Every field of the fleet's audit record but the measurement
    counters; the configuration as plain values."""
    return [(d.round, d.tenant, d.action, dataclasses.astuple(d.config),
             d.y, d.accepted, d.explored, d.tau, d.reheated, d.violation,
             d.job, dataclasses.astuple(d.measurement)) for d in decisions]


@pytest.mark.parametrize("incremental", [False, True])
@pytest.mark.parametrize("detectors", [True, False])
def test_fleet_equals_jax_under_replayed_draws(monkeypatch, incremental,
                                               detectors):
    monkeypatch.setattr(pfleet, "tenant_draws", fleet_draws)
    kw = dict(incremental=incremental, detectors=detectors)
    (ref, jspec), (port, pspec) = _scenario("jax", **kw), \
        _scenario("torch", **kw)
    actions = set()
    for r in range(7):
        if r == 3:
            _churn(ref, jspec)
            _churn(port, pspec)
        want, got = ref.round(), port.round()
        assert decision_log(got) == decision_log(want), f"round {r}"
        assert np.array_equal(port._incumbents, ref._incumbents)
        assert np.array_equal(port._stream_ids, ref._stream_ids)
        assert port.last_annealed == ref.last_annealed
        actions |= {d.action for d in got}
    assert port.violation_history == ref.violation_history
    assert port.aggregate_usage() == ref.aggregate_usage()
    assert port.evaluation_counts() == ref.evaluation_counts()
    assert {"admit", "defer", "preempt"} <= actions    # the scenario bites
    # the budget binds: the final spend sits within a cheap state of it
    assert 5.0 < port.aggregate_usage()["usd_per_hr"] <= 6.0


def test_decision_records_are_what_the_dataclass_builds():
    ctl, _ = _scenario("torch")
    d = ctl.round()[0]
    values = [getattr(d, name) for name in pfleet._DECISION_FIELDS]
    built = FleetDecision(*values[:9], true_measures=values[9],
                          surrogate_queries=values[10], tenant=values[11],
                          round=values[12], action=values[13],
                          violation=values[14])
    assert d == built and hash(d) == hash(built) and repr(d) == repr(built)
    assert vars(d) == vars(built)
    with pytest.raises(dataclasses.FrozenInstanceError):
        d.action = "admit"


def test_coupling_rows_and_penalty_hook_equal_jax():
    (ref, _), (port, _) = _scenario("jax"), _scenario("torch")
    for ctl in (ref, port):
        ctl.run(2)
    assert np.array_equal(port.coupling_rows(), ref.coupling_rows())
    inc = np.arange(5) * 7 % port.space.size()
    assert np.array_equal(port.coupling_rows(inc), ref.coupling_rows(inc))
    enc = port.space.encoded()
    assert np.array_equal(port.coupling_penalty(enc, 5),
                          ref.coupling_penalty(ref.space.encoded(), 5))


# ---------------------------------------------------------------------------
# tenant_draws: the port's per-tenant streams.
# ---------------------------------------------------------------------------

ENC = EncodedSpace((4, 16), (True, False))


def test_tenant_draws_ranges_and_types():
    d = tenant_draws(7, 3, [0, 5, 2**32 - 1], ENC, 50, device="cpu")
    assert {k: (tuple(v.shape), v.dtype) for k, v in d.items()} == {
        "axis": ((3, 50), torch.int64), "up": ((3, 50), torch.bool),
        "pick": ((3, 50), torch.int64), "uniform": ((3, 50), torch.float32)}
    assert ((d["axis"] >= 0) & (d["axis"] < 2)).all()
    limit = torch.tensor([3, 15])[d["axis"]]       # max(n - 1, 1) per axis
    assert ((d["pick"] >= 0) & (d["pick"] < limit)).all()
    u = d["uniform"]
    assert ((u >= 0) & (u < 1)).all()
    # 24-bit uniforms: exact multiples of 2^-24
    assert torch.equal(u * 2 ** 24, (u * 2 ** 24).floor())
    one_axis = tenant_draws(7, 3, [0, 5], EncodedSpace((1,), (False,)), 9,
                            device="cpu")
    assert (one_axis["axis"] == 0).all() and (one_axis["pick"] == 0).all()


def test_tenant_draws_uniform_and_independent_across_ids():
    A, S = 3125, 32                                # 10^5 draws a key
    d = tenant_draws(11, 0, np.arange(A), ENC, S, device="cpu")
    u = d["uniform"].double().numpy()
    n = u.size
    hist = np.histogram(u, bins=20, range=(0.0, 1.0))[0]
    chi2 = float(((hist - n / 20) ** 2 / (n / 20)).sum())
    assert chi2 < 43.8                             # 19 dof, p = 0.001
    assert abs(u.mean() - 0.5) < 4 * np.sqrt(1 / 12 / n)
    for key, p in (("up", 0.5), ("axis", 0.5)):
        m = d[key].double().mean().item()
        assert abs(m - p) < 4 * np.sqrt(p * (1 - p) / n)
    picks = d["pick"][d["axis"] == 1].numpy()
    hist = np.bincount(picks, minlength=15)
    e = picks.size / 15
    assert float(((hist - e) ** 2 / e).sum()) < 36.1     # 14 dof
    # neighbouring ids (and steps) uncorrelated
    bound = 4 / np.sqrt(n / 2)
    assert abs(np.corrcoef(u[0:-1:2].ravel(), u[1::2].ravel())[0, 1]) < bound
    assert abs(np.corrcoef(u[:, :-1].ravel(), u[:, 1:].ravel())[0, 1]) \
        < 4 / np.sqrt(A * (S - 1))
    # other rounds and seeds: other streams
    r1 = tenant_draws(11, 1, np.arange(A), ENC, S, device="cpu")["uniform"]
    s1 = tenant_draws(12, 0, np.arange(A), ENC, S, device="cpu")["uniform"]
    for other in (r1, s1):
        c = np.corrcoef(u.ravel(), other.double().numpy().ravel())[0, 1]
        assert abs(c) < 4 / np.sqrt(n)
        assert (other.numpy() == u).mean() < 1e-3


def test_tenant_draws_rows_depend_only_on_the_id():
    """Churn invariance (the reference's
    ``test_churn_invariant_chain_keys``): a surviving id's row is the same
    whoever else is drawn with it, in any order, and for any horizon."""
    a = tenant_draws(5, 4, [0, 1, 2], ENC, 12, device="cpu")
    b = tenant_draws(5, 4, [9, 2, 7, 1], ENC, 20, device="cpu")
    for k in a:
        assert torch.equal(a[k][2], b[k][1, :12])
        assert torch.equal(a[k][1], b[k][3, :12])
    c = tenant_draws(5, 4, torch.tensor([2]), ENC, 12, device="cpu")
    assert all(torch.equal(a[k][2:], c[k]) for k in a)


def test_tenant_draws_launch_a_few_dozen_ops_whatever_the_fleet():
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.n += 1
            return func(*args, **(kwargs or {}))

    counts = []
    for A in (1, 64, 1024):
        with Count() as c:
            c.n = 0
            tenant_draws(0, 1, torch.arange(A), ENC, 32, device="cpu")
        counts.append(c.n)
    assert counts[0] == counts[1] == counts[2] <= 80, counts


def test_the_fleet_draws_through_tenant_draws(monkeypatch):
    """The fleet's one draw seam: a round's draws are ``tenant_draws`` of
    (seed, round, stream ids) of its active tenants."""
    seen = []
    real = pfleet.tenant_draws

    def spy(seed, r, ids, enc, S, *, device):
        seen.append((seed, r, np.asarray(ids).tolist(), S))
        return real(seed, r, ids, enc, S, device=device)

    monkeypatch.setattr(pfleet, "tenant_draws", spy)
    ctl, _ = _scenario("torch", incremental=True, settle_rounds=1,
                       detectors=False)
    ctl.run(2)
    ctl.remove_tenant("t1")
    ctl.add_tenant(TenantSpec("new", {"kmeans": 1.0}))
    ctl.round()
    assert seen[0] == (3, 0, [0, 1, 2, 3, 4], 16)
    rounds = [s[1] for s in seen]               # one call a walked round
    assert rounds == sorted(set(rounds))
    assert seen[-1][1] == 2 and 5 in seen[-1][2] and 1 not in seen[-1][2]
    assert ctl.last_annealed == len(seen[-1][2])


# ---------------------------------------------------------------------------
# The reference's fleet properties, re-pinned on the port.
# ---------------------------------------------------------------------------


def _catalog(cap=80.0, families=FAMS):
    return ServiceCatalog({f: EC2_CATALOG[f] for f in families},
                          capacities={f: cap for f in families})


def _controller(n_tenants=4, cap=80.0, budget=float("inf"), steps=16,
                weight=25.0, seed=0, **kw):
    catalog = _catalog(cap)
    space = make_ec2_space(catalog, core_counts=CORES)
    tenants = [TenantSpec(f"t{i}", {"wordcount": 1.0, "kmeans": 1.0},
                          priority=1.0 + 0.25 * i)
               for i in range(n_tenants)]
    return FleetController(
        space, catalog, SimulatedEvaluator(catalog), tenants,
        objective=PenalizedObjective(Objective(lambda_cost=200.0),
                                     weight=weight),
        budget_usd_hr=budget, steps_per_round=steps, seed=seed,
        device="cpu", **kw)


def test_fleet_respects_capacity_and_logs_all_tenants():
    fc = _controller(n_tenants=4, cap=60.0, steps=12, seed=1)
    fc.run(4)
    assert len(fc.decisions) == 16
    assert all(isinstance(d, FleetDecision) and isinstance(d, Decision)
               for d in fc.decisions)
    assert fc.violation_history == [0.0] * 4
    usage = fc.aggregate_usage()
    for fam, cores in usage["cores"].items():
        assert cores <= fc.catalog.capacity(fam) + 1e-9
        assert fc.catalog.reserved(fam) == pytest.approx(cores)
    assert fc.spend() > 0.0


def test_fleet_budget_is_enforced():
    fc = _controller(n_tenants=4, cap=1e9, budget=3.0, steps=12, seed=2)
    fc.run(5)
    assert fc.aggregate_usage()["usd_per_hr"] <= 3.0 + 1e-9
    assert fc.violation_history[-1] == 0.0


def test_fleet_unconstrained_improves_and_capacity_pressure_bites():
    fc = _controller(n_tenants=3, cap=1e9, steps=40, seed=3)
    y0 = [a["y"] for a in fc.allocations().values()]
    fc.run(6)
    assert sum(a["y"] for a in fc.allocations().values()) < sum(y0)
    assert any(d.action == "admit" for d in fc.decisions)
    tight = _controller(n_tenants=6, cap=40.0, steps=16, seed=4)
    tight.run(6)
    assert {d.action for d in tight.decisions} & {"defer", "preempt"} \
        or any(d.violation > 0 for d in tight.decisions)
    assert tight.violation_history[-1] == 0.0


def test_preemption_targets_offenders_after_a_capacity_shrink():
    cat = ServiceCatalog({f: EC2_CATALOG[f] for f in ("general", "compute")},
                         capacities={"compute": 200.0, "general": 1000.0})
    space = make_ec2_space(cat, core_counts=(4, 8, 16, 32))
    on_compute = space.encode({"instance_type": "compute", "n_workers": 32})
    on_general = space.encode({"instance_type": "general", "n_workers": 8})
    tenants = [TenantSpec("c-hi", {"wordcount": 1.0}, priority=5.0,
                          init=on_compute),
               TenantSpec("c-lo", {"wordcount": 1.0}, priority=0.5,
                          init=on_compute),
               TenantSpec("innocent", {"wordcount": 1.0}, init=on_general)]
    fc = FleetController(space, cat, SimulatedEvaluator(cat), tenants,
                         objective=PenalizedObjective(
                             Objective(lambda_cost=200.0), weight=25.0),
                         steps_per_round=4, detectors=False, seed=5,
                         device="cpu")
    cat.set_capacity("compute", 20.0)               # a spot revocation
    by = {d.tenant: d for d in fc.round()}
    assert by["innocent"].action != "preempt"
    assert by["innocent"].violation == 0.0
    assert by["c-lo"].action == "preempt"
    assert fc.violation_history[-1] == 0.0
    assert fc.aggregate_usage()["cores"]["compute"] <= 20.0 + 1e-9


def test_foreign_reservations_are_kept_and_respected():
    fc = _controller(n_tenants=2, cap=200.0, steps=8, seed=11)
    fc.catalog.reserve("general", 37.0)            # an operator's hold
    fc.run(3)
    own = fc.aggregate_usage()["cores"]["general"]
    assert fc.catalog.reserved("general") == pytest.approx(own + 37.0)
    catalog = _catalog(cap=60.0)
    catalog.reserve("compute", 58.0)               # 2 cores left
    space = make_ec2_space(catalog, core_counts=CORES)
    fc = FleetController(space, catalog, SimulatedEvaluator(catalog),
                         [TenantSpec(f"t{i}", {"wordcount": 1.0})
                          for i in range(3)], steps_per_round=8, seed=13,
                         device="cpu")
    fc.run(4)
    assert fc.aggregate_usage()["cores"]["compute"] == 0.0
    assert catalog.reserved("compute") == pytest.approx(58.0)


def test_staggered_blend_change_rebuilds_the_table():
    catalog = _catalog(cap=1e9)
    space = make_ec2_space(catalog, core_counts=CORES)
    fc = FleetController(
        space, catalog, SimulatedEvaluator(catalog),
        [TenantSpec("drifter", {"wordcount": 1.0},
                    blend_after={"pagerank": 1.0}, change_at=2),
         TenantSpec("steady", {"wordcount": 1.0})],
        objective=Objective(lambda_cost=200.0), steps_per_round=24, seed=7,
        device="cpu")
    before = fc._tenant_tables[0]
    fc.run(6)
    assert fc._tenant_tables[0] is not before
    assert fc._tenant_tables[1] is before           # cached per blend
    alloc = fc.allocations()
    assert alloc["drifter"]["config"] != alloc["steady"]["config"]


def test_fleet_validation_device_and_mesh():
    catalog = _catalog()
    space = make_ec2_space(catalog, core_counts=CORES)
    ev = SimulatedEvaluator(catalog)
    t = TenantSpec("t", {"wordcount": 1.0})
    for bad in ([], [t, t]):
        with pytest.raises(ValueError):
            FleetController(space, catalog, ev, bad, device="cpu")
    with pytest.raises(ValueError):
        TenantSpec("t", {"wordcount": 1.0}, priority=0.0)
    with pytest.raises(ValueError):
        FleetController(space, catalog, ev, [t], steps_per_round=0,
                        device="cpu")
    with pytest.raises(ValueError, match="A8.3"):
        FleetController(space, catalog, ev, [t], mesh=object(),
                        device="cpu")


def test_fleet_controller_on_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present; the refusal needs a host without")
    catalog = _catalog()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        FleetController(make_ec2_space(catalog, core_counts=CORES), catalog,
                        SimulatedEvaluator(catalog),
                        [TenantSpec("t", {"wordcount": 1.0})])


def test_churn_releases_capacity_and_keeps_streams():
    ctrl = _controller(n_tenants=4, cap=80.0)
    ctrl.run(3)
    gone = ctrl.allocations()["t1"]
    fam = gone["config"].instance_type
    before = ctrl.catalog.remaining(fam)
    ctrl.remove_tenant("t1")
    assert ctrl.catalog.remaining(fam) == pytest.approx(
        before + gone["config"].total_cores)
    ctrl.add_tenant(TenantSpec("fresh", {"pagerank": 1.0}, priority=3.0))
    decisions = ctrl.round()
    assert sorted(d.tenant for d in decisions) == ["fresh", "t0", "t2", "t3"]
    assert ctrl.violation_history[-1] == 0.0
    with pytest.raises(ValueError):
        ctrl.add_tenant(TenantSpec("t0", {"wordcount": 1.0}))
    with pytest.raises(KeyError):
        ctrl.remove_tenant("nope")
    # job streams of survivors do not move under churn
    a, b = _controller(n_tenants=3, seed=7), _controller(n_tenants=3, seed=7)
    jobs_a = [[d.job for d in a.round() if d.tenant == "t2"]
              for _ in range(2)]
    b.round()
    b.remove_tenant("t0")
    b.add_tenant(TenantSpec("late", {"kmeans": 1.0}))
    jobs_b = [[d.job for d in b.decisions if d.tenant == "t2"],
              [d.job for d in b.round() if d.tenant == "t2"]]
    assert jobs_b == jobs_a


def test_swap_never_reuses_a_stream_and_resets_the_detector():
    ctl = _controller(n_tenants=3, seed=0)
    ctl.run(3)
    old_ids = ctl._stream_ids.copy()
    assert ctl._detector._n[1] > 0
    victim = ctl.tenants[1]
    ctl.remove_tenant(victim.name)
    ctl.add_tenant(TenantSpec("newcomer", dict(victim.blend)))
    assert ctl._stream_ids[-1] not in old_ids
    assert ctl._detector._n[-1] == 0
    old = ctl._chain_draws(ctl._round, old_ids[[1]])
    new = ctl._chain_draws(ctl._round, ctl._stream_ids[[-1]])
    assert not torch.equal(old["uniform"], new["uniform"])


# -- test_fleet_sharding.py: bucketing, incremental rounds ---------------

T5 = 5


def _sharding_controller(seed=4, **kw):
    catalog = EC2_CATALOG_ADJUSTED.with_capacities(
        {f: 12.0 * T5 for f in EC2_CATALOG_ADJUSTED.names()})
    space = make_ec2_space(catalog, core_counts=CORES)
    evaluator = SimulatedEvaluator(catalog)
    jobs = sorted(evaluator.jobs)
    rng = np.random.default_rng(17)
    tenants = [TenantSpec(f"t{i}",
                          dict(zip(jobs, rng.dirichlet(np.ones(len(jobs))))),
                          priority=1.0 + 0.5 * (i % 3)) for i in range(T5)]
    return FleetController(space, catalog, evaluator, tenants,
                           budget_usd_hr=1.6 * T5, steps_per_round=16,
                           seed=seed, device="cpu", **kw)


def _sig(decisions):
    return [(d.round, d.tenant, d.action, d.config, d.y, d.explored)
            for d in decisions]


def test_bucketed_equals_unbucketed_through_churn():
    a = _sharding_controller(chain_bucketing=False)
    b = _sharding_controller(chain_bucketing=True)
    for _ in range(3):
        assert _sig(a.round()) == _sig(b.round())
    for ctl in (a, b):
        victim = ctl.tenants[2]
        ctl.remove_tenant(victim.name)
        ctl.add_tenant(TenantSpec("late", dict(victim.blend)))
    for _ in range(3):
        assert _sig(a.round()) == _sig(b.round())
    assert np.array_equal(a._incumbents, b._incumbents)


def test_incremental_matches_full_when_all_are_active():
    a = _sharding_controller(incremental=False, detectors=False)
    b = _sharding_controller(incremental=True, settle_rounds=6,
                             detectors=False)
    for _ in range(5):
        da, db = a.round(), b.round()
        assert b.last_annealed == T5
        assert _sig(da) == _sig(db)
    assert np.array_equal(a._incumbents, b._incumbents)


def test_incremental_subset_shrinks_and_a_retune_reactivates_one():
    ctl = _sharding_controller(incremental=True, settle_rounds=2,
                               detectors=False)
    counts = []
    for _ in range(5):
        ctl.round()
        counts.append(ctl.last_annealed)
    assert counts[0] == T5 and counts[-1] == 0
    ctl = _sharding_controller(incremental=True, settle_rounds=1,
                               detectors=False)
    ctl.run(3)
    assert ctl.last_annealed == 0
    ctl.retune_tenant("t3", dict(ctl.tenants[0].blend))
    ctl.round()
    assert ctl.last_annealed == 1
    ctl.round()
    assert ctl.last_annealed == 0


# -- test_ledger_properties.py: the incremental reservation ledger -------

SEEDS = st.integers(min_value=0, max_value=2**31 - 1)
OPS = st.lists(
    st.composite(lambda draw: (
        draw(st.integers(min_value=0, max_value=4)),
        draw(st.integers(min_value=0, max_value=7)),
        draw(st.floats(min_value=0.25, max_value=2.0, allow_nan=False)),
    ))(),
    min_size=1, max_size=12)


def _ledger_controller(seed, T=3):
    catalog = EC2_CATALOG_ADJUSTED.with_capacities(
        {f: 14.0 * T for f in EC2_CATALOG_ADJUSTED.names()})
    space = make_ec2_space(catalog, core_counts=(4, 12, 20, 28))
    evaluator = SimulatedEvaluator(catalog)
    jobs = sorted(evaluator.jobs)
    rng = np.random.default_rng(seed)
    pool = [dict(zip(jobs, rng.dirichlet(np.ones(len(jobs)))))
            for _ in range(4)]
    tenants = [TenantSpec(f"t{i}", pool[i % len(pool)]) for i in range(T)]
    ctl = FleetController(
        space, catalog, evaluator, tenants, budget_usd_hr=2.5 * T,
        steps_per_round=8, seed=seed, incremental=True, settle_rounds=2,
        ledger_check_every=0, device="cpu")
    return ctl, catalog, pool


def _apply(ctl, catalog, pool, op, next_id):
    kind, a, x = op
    if kind == 0:
        ctl.round()
    elif kind == 1:
        ctl.add_tenant(TenantSpec(f"n{next_id}", pool[a % len(pool)]))
        next_id += 1
    elif kind == 2 and len(ctl.tenants) > 1:
        ctl.remove_tenant(ctl.tenants[a % len(ctl.tenants)].name)
    elif kind == 3:
        fam = catalog.names()[a % len(catalog.names())]
        catalog.set_capacity(fam, x * 14.0 * len(ctl.tenants))
        ctl.round()
    elif kind == 4:
        ctl.retune_tenant(ctl.tenants[a % len(ctl.tenants)].name,
                          pool[a % len(pool)])
    return next_id


@settings(max_examples=8, deadline=None)
@given(OPS, SEEDS)
def test_incremental_ledger_equals_recompute(ops, seed):
    ctl, catalog, pool = _ledger_controller(seed % 1000)
    next_id = 0
    for op in ops:
        next_id = _apply(ctl, catalog, pool, op, next_id)
    ctl._ledger_crosscheck()      # raises RuntimeError on any drift
    assert catalog.reserved_snapshot() == {
        f: c for f, c in ctl._mirrored.items() if c > 0}


@settings(max_examples=8, deadline=None)
@given(SEEDS)
def test_departed_share_reusable_next_round(seed):
    ctl, catalog, _ = _ledger_controller(seed % 1000)
    ctl.run(2)
    assert ctl._feasible(ctl._incumbents)
    victim = ctl.tenants[1]
    s = int(ctl._incumbents[1])
    before = sum(catalog.reserved(f) for f in catalog.names())
    ctl.remove_tenant(victim.name)
    after = sum(catalog.reserved(f) for f in catalog.names())
    assert after <= before - float(ctl._cores_by_family[:, s].sum()) + 1e-9
    init = tuple(int(v) for v in np.unravel_index(s, ctl._shape))
    ctl.add_tenant(TenantSpec("reuser", dict(victim.blend), init=init))
    assert ctl._feasible(ctl._incumbents)
    ctl.round()
    assert ctl.violation_history[-1] <= 1e-9
    ctl._ledger_crosscheck()


def test_crosscheck_detects_seeded_drift_and_runs_on_schedule():
    ctl, _, _ = _ledger_controller(0)
    ctl.run(2)
    fam = next(iter(ctl._mirrored))
    ctl._mirrored[fam] += 3.0          # simulated drift (catalog not
    with pytest.raises(RuntimeError):  # updated to match)
        ctl._ledger_crosscheck()
    ctl, _, _ = _ledger_controller(0)
    ctl.ledger_check_every = 2
    checked = []
    real = ctl._ledger_crosscheck
    ctl._ledger_crosscheck = lambda: (checked.append(ctl._round), real())
    ctl.run(5)
    assert checked == [1, 3]
