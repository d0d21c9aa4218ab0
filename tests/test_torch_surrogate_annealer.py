"""The port's ``SurrogateAnnealer`` against the reference's.

Under the reference's replayed draws (``fold_in(key(seed), r)``, split
into the chains' starts and their walk, handed in through the one seam
the round's randomness passes, ``SurrogateAnnealer._chains``) the round
logs equal JAX's field for field, in both loops, both acquisitions, with
drift, a worker pool, a validity rule and out-of-band adds.  Two near
ties whose order float32 rounding decides differently in the two
packages' refits are pinned with their scores.  On the port's own streams
the reference's own assertions hold (``tests/test_surrogate.py``), and so
do the provenance and telemetry contracts and the ``surrogate_scale``
twin's checks."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

import repro_torch.telemetry as telemetry
from repro.core import annealing as jann
from repro.core import surrogate as jsur
from repro.core.state import ConfigSpace as JConfigSpace
from repro.core.state import Dimension as JDimension
from repro_torch.core import surrogate as psur
from repro_torch.core.annealing import DRAW_KEYS
from repro_torch.core.state import ConfigSpace, Dimension
from repro_torch.figures import surrogate_scale
from repro_torch.kernels import ops
from repro_torch.telemetry.provenance import ladder_sum

from test_torch_jax_draws import nd_chain_draws, numpy_draws

#: a small mixed space: ordinal, categorical, ordinal
DIMS = (("n", tuple(range(1, 41)), "ordinal"),
        ("c", ("a", "b", "c"), "categorical"),
        ("tp", (1, 2, 4), "ordinal"))
C, S, M = 8, 24, 5


def _valid(cfg):
    return cfg["n"] % cfg["tp"] == 0


def _spaces(valid=False):
    rule = _valid if valid else None
    return (JConfigSpace(tuple(JDimension(n, v, k) for n, v, k in DIMS),
                         is_valid=rule),
            ConfigSpace(tuple(Dimension(n, v, k) for n, v, k in DIMS),
                        is_valid=rule))


def _fn(cfg):
    return (abs(cfg["n"] - 27) * 0.7
            + {"a": 3.0, "b": 0.0, "c": 1.5}[cfg["c"]] + 0.9 * cfg["tp"])


def replayed_chains(seed, n_chains, n_steps):
    """``SurrogateAnnealer._chains`` as the reference's round makes its
    randomness: ``fold_in(key(seed), r)`` split into (k_init, k_run), the
    starts ``random_valid_states(k_init)``, then ``anneal_fleet(k_run,
    inits=...)``'s draws: ``split(k_run)`` -> (key, unused),
    ``split(key, C)``, each chain on ``_chain_nd_core``'s schedule."""
    def chains(self, r, win):
        k_init, k_run = jax.random.split(
            jax.random.fold_in(jax.random.key(seed), r))
        inits = np.array(jann.random_valid_states(k_init, win.enc, n_chains),
                         np.int32)
        key, _ = jax.random.split(k_run)
        d = numpy_draws(jax.vmap(nd_chain_draws, (0, None, None))(
            jax.random.split(key, n_chains), win.enc.shape, n_steps))
        return (torch.from_numpy(inits), None, {k: d[k] for k in DRAW_KEYS})
    return chains


def _pair(seed=0, half_life=None, valid=False, **kw):
    """(the reference's annealer, the port's on the CPU under replayed
    draws) with the same arguments."""
    js, ps = _spaces(valid)
    kw = dict(half_width=5, n_chains=C, steps_per_round=S,
              measures_per_round=M, seed=seed, **kw)
    ref = jsur.SurrogateAnnealer(
        js, _fn, store=jsur.MeasurementStore(3, half_life=half_life), **kw)
    port = psur.SurrogateAnnealer(
        ps, _fn, store=psur.MeasurementStore(3, half_life=half_life),
        device="cpu", **kw)
    port._chains = replayed_chains(seed, C, S).__get__(port)
    return ref, port


#: Near ties the two packages' refits order differently (pinned with their
#: scores in test_pinned_near_ties): configuration -> (round, the state the
#: reference ranks first, the one the port ranks first, the ranking: the
#: acquisition "lcb" (mean - kappa * unc, lower first) or "unc" (the
#: exploration share's uncertainty, higher first))
FLIPS = {
    "device lcb": (5, (25, 1, 0), (27, 1, 0), "lcb"),
    "device lcb, 4 workers": (5, (25, 1, 0), (27, 1, 0), "lcb"),
    "device ei, drift": (9, (28, 0, 2), (22, 1, 2), "unc"),
    "host lcb, drift": (7, (25, 1, 0), (27, 1, 0), "lcb"),
}

CONFIGS = {
    "device lcb": dict(),
    "device ei": dict(acquisition="ei"),
    "device lcb, drift": dict(half_life=2.0),
    "device ei, drift": dict(half_life=2.0, acquisition="ei"),
    "device lcb, validity rule": dict(valid=True),
    "device lcb, 4 workers": dict(eval_workers=4),
    "host lcb": dict(device_loop=False),
    "host ei": dict(device_loop=False, acquisition="ei"),
    "host lcb, drift": dict(device_loop=False, half_life=2.0),
    "host lcb, validity rule": dict(device_loop=False, valid=True),
}


def _assert_logs_equal(ref_rounds, port_rounds, flip=None):
    """Field for field.  At a pinned flip the two states come in the
    other order, or (when only one of them fits the round's picks) the
    port measures the other one in its place; every other field is equal.
    After a swap the two stores hold the same entries in another refresh
    order, so later rounds compare ``measured`` as a set and every other
    field exactly; after a replaced pick the stores differ and later
    rounds are not compared."""
    assert len(ref_rounds) == len(port_rounds)
    r_flip, first, second, _ = flip or (float("inf"), None, None, None)
    for a, b in zip(ref_rounds, port_rounds):
        a, b = dataclasses.astuple(a), dataclasses.astuple(b)
        if a[0] < r_flip:
            assert a == b, a[0]
            continue
        ra = [s for s, _ in a[-1]]
        rb = [s for s, _ in b[-1]]
        swapped = second in ra
        if a[0] > r_flip and not swapped:
            break
        assert a[:-1] == b[:-1], a[0]
        if a[0] > r_flip:
            assert sorted(a[-1]) == sorted(b[-1]), a[0]
            continue
        i = ra.index(first)
        assert rb[i] == second
        if swapped:
            j = ra.index(second)
            assert rb[j] == first
            rb[j] = second
        rb[i] = first
        assert ra == rb


@pytest.mark.parametrize("name", list(CONFIGS))
def test_round_logs_equal_jax_under_replayed_draws(name):
    kw = dict(CONFIGS[name])
    rounds = 10 if "half_life" in kw else 8
    ref, port = _pair(**kw)
    _assert_logs_equal(ref.run(rounds), port.run(rounds), FLIPS.get(name))
    assert port.stale_refreshes == ref.stale_refreshes
    if "half_life" in kw:
        assert port.stale_refreshes >= 1
    assert port.counts() == ref.counts()
    assert port.best() == ref.best()


def test_out_of_band_adds_reload_the_device_store():
    """A store fed out of band (a shared recycle store) is reloaded into
    the device twin at the next round, in both packages alike: the rows
    and the next rounds' logs equal the reference's.  (Round 6 reaches a
    near tie in the uncertainty ranking, the kind test_pinned_near_ties
    pins, so three rounds are compared.)"""
    ref, port = _pair(half_life=3.0)
    ref.run(3)
    port.run(3)
    for sa in (ref, port):
        sa.store.add((20, 2, 1), 3.5, 2.0)
        sa.store.add((33, 0, 0), 9.0, 2.0)
    _assert_logs_equal(ref.run(3), port.run(3))
    port._dstore.flush()
    np.testing.assert_array_equal(port._dstore._states.numpy(),
                                  np.asarray(ref._dstore._states))
    np.testing.assert_array_equal(port._dstore._seq.numpy(),
                                  np.asarray(ref._dstore._seq))


def _capture_scores(monkeypatch, ref, port, device_loop):
    """Each package's window means and uncertainties of its last refit:
    the device loop's from the selection's inputs, the host loop's from
    the model's predictions (with their query states)."""
    got = {}
    if device_loop:
        real_select = psur._select
        real_jit = jsur._select_jit

        def select(*a, **k):
            got["port"] = (a[2].numpy(), a[3].numpy())
            return real_select(*a, **k)

        def select_jit(*args):
            run = real_jit(*args)

            def spy(*b):
                got["ref"] = (np.asarray(b[2]), np.asarray(b[3]))
                return run(*b)
            return spy

        monkeypatch.setattr(psur, "_select", select)
        monkeypatch.setattr(jsur, "_select_jit", select_jit)
    else:
        for name, sa in (("ref", ref), ("port", port)):
            real = sa.model.predict

            def predict(states, store, now=None, real=real, name=name):
                mean, unc = real(states, store, now=now)
                got[name] = (mean, unc, np.asarray(states))
                return mean, unc
            monkeypatch.setattr(sa.model, "predict", predict)
    return got


@pytest.mark.parametrize("name", list(FLIPS))
def test_pinned_near_ties(monkeypatch, name):
    """At the pinned round the two states' scores lie within float32
    rounding of each other in both packages, which order them
    oppositely: the reference ranks the first state first, the port the
    second.  "lcb": both states are measured (unc 0), so the score is the
    IDW estimate at a measured state, its reading 1.6 to within eps's
    pull, within 8 float32 ulps.  "unc": the two nearest-measurement
    distances are equal in exact arithmetic; the expansion ``|q|^2 +
    |m|^2 - 2 q.m`` cancels, so each package's float32 distance carries
    an error of about an ulp of ``|q|^2``, 1e-4 of these uncertainties.
    The two refits sum in other orders (XLA's dot over 128 padded
    features against torch's over F)."""
    kw = dict(CONFIGS[name])
    r_flip, first, second, kind = FLIPS[name]
    ref, port = _pair(**kw)
    ref.run(r_flip)
    port.run(r_flip)
    device_loop = kw.get("device_loop", True)
    got = _capture_scores(monkeypatch, ref, port, device_loop)
    inc = ref.incumbent
    ref.round()
    port.round()
    sub, offs = jsur.window_space(ref.space, inc, ref.half_width)
    scores = {}
    for pkg in ("ref", "port"):
        mean, unc = got[pkg][:2]
        for st in (first, second):
            if device_loop:
                f = np.ravel_multi_index(tuple(np.asarray(st) - offs),
                                         sub.shape)
            else:
                f = int(np.flatnonzero((got[pkg][2] == st).all(1))[0])
            if kind == "lcb":
                assert unc[f] == 0.0
                scores[pkg, st] = float(mean[f] - 1.0 * unc[f])
            else:
                scores[pkg, st] = -float(unc[f])
    for pkg in ("ref", "port"):
        gap = abs(scores[pkg, first] - scores[pkg, second])
        if kind == "lcb":
            ulp = float(np.spacing(np.float32(1.6)))
            assert gap <= 8 * ulp
            assert abs(scores[pkg, first] - 1.6) <= 16 * ulp
        else:
            assert gap <= 1e-4 * abs(scores[pkg, first])
    assert scores["ref", first] <= scores["ref", second]
    assert scores["port", second] < scores["port", first]


def test_provenance_records_equal_jax_and_sum_by_the_ladder():
    """One DecisionRecord a round whose one term, summed as a ladder
    (``provenance.ladder_sum``), is y exactly, equal to the reference's
    record field for field under replayed draws."""
    import repro.telemetry as jtel

    for kw in (dict(acquisition="ei"), dict(device_loop=False)):
        ref, port = _pair(**kw)
        with telemetry.session() as tel:
            port.run(6)
            recs = [r for r in tel.provenance.records()
                    if r.controller == "surrogate"]
        with jtel.session() as jt:
            ref.run(6)
            jrecs = [r for r in jt.provenance.records()
                     if r.controller == "surrogate"]
        assert [r.round for r in recs] == list(range(6))
        for r in recs:
            assert ladder_sum(r.exact_split) == r.y
            assert ladder_sum(r.terms) == r.y and r.check()
        fields = ("round", "action", "state", "y", "terms", "exact_split",
                  "tau", "rejected", "rejected_y", "counterfactual")
        np.testing.assert_equal(
            [[getattr(r, f) for f in fields] for r in recs],
            [[getattr(r, f) for f in fields] for r in jrecs])
        # the acceptance probability is exp(-dy / tau) of the window's
        # float32 refit, whose sums round in other orders in the two
        # packages (see test_pinned_near_ties): equal to float32 rounding
        np.testing.assert_allclose([r.accept_prob for r in recs],
                                   [r.accept_prob for r in jrecs],
                                   rtol=1e-5)


def test_spans_metrics_and_stats():
    _, ps = _spaces()
    sa = psur.SurrogateAnnealer(ps, _fn, half_width=5, n_chains=C,
                                steps_per_round=S, measures_per_round=M,
                                seed=1, device="cpu")
    with telemetry.session() as tel:
        sa.run(3)
        names = {s[0] for s in tel.spans.spans()}
        stats = sa.stats()
        snap = tel.metrics.snapshot(prefix="surrogate")
    assert {"surrogate.round", "surrogate.refit", "surrogate.anneal",
            "surrogate.measure"} <= names
    assert stats["controller"] == "SurrogateAnnealer"
    assert stats["rounds"] == 3 and stats["pipeline"] is None
    assert stats["store_size"] == len(sa.store)
    assert stats["true_measures"] == sa.true_measures
    assert stats["metrics"] == snap
    recorded = {k for kind in snap.values() if isinstance(kind, dict)
                for k in kind}
    assert {"surrogate/best_y", "surrogate/window", "surrogate/store_size",
            "surrogate/stale_refreshes", "surrogate/refit_s",
            "surrogate/anneal_s"} <= recorded


def test_cpu_round_launches_no_kernel_and_runs_one_refit_and_walk():
    """On the CPU the wrappers run their plain versions (no launch is
    counted); a device-loop round calls each wrapper once."""
    _, ps = _spaces(valid=True)
    sa = psur.SurrogateAnnealer(ps, _fn, half_width=5, n_chains=C,
                                steps_per_round=S, measures_per_round=M,
                                seed=2, device="cpu")
    calls = {"fused_interp": 0, "anneal_walk": 0}
    real = {k: getattr(ops, k) for k in calls}

    def counted(name):
        def call(*a, **k):
            calls[name] += 1
            return real[name](*a, **k)
        return call

    ops.reset_launches()
    try:
        for k in calls:
            ops.__dict__[k] = counted(k)
        sa.run(4)
    finally:
        for k, f in real.items():
            ops.__dict__[k] = f
    assert calls == {"fused_interp": 4, "anneal_walk": 4}
    assert sum(ops.LAUNCHES.values()) == 0


def test_annealer_refuses_the_card_without_one():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    _, ps = _spaces()
    with pytest.raises(RuntimeError, match="cuda"):
        psur.SurrogateAnnealer(ps, _fn)


# ---------------------------------------------------------------------------
# On the port's own streams: the reference's assertions
# (tests/test_surrogate.py)
# ---------------------------------------------------------------------------


def _smooth_space(n):
    return ConfigSpace((
        Dimension("family", ("a", "b", "c", "d"), kind="categorical"),
        Dimension("x", tuple(range(n))),
    ))


def _smooth_fn(cfg):
    off = {"a": 0.0, "b": 2.0, "c": 5.0, "d": 1.0}[cfg["family"]]
    return (cfg["x"] - 37.0) ** 2 / 50.0 + off + 10.0


@pytest.mark.parametrize("device_loop", [True, False])
def test_converges_within_tolerance(device_loop):
    """Within 5% of the tabulated optimum at <= 10% of the exhaustive
    evaluation count; the counters cumulative in the records."""
    from repro_torch.core.landscape import tabulate

    space = _smooth_space(120)                     # 480 states
    y_star = float(tabulate(space, _smooth_fn).min())
    sa = psur.SurrogateAnnealer(space, _smooth_fn, half_width=6,
                                n_chains=16, steps_per_round=48,
                                measures_per_round=6, n_bootstrap=8, seed=0,
                                device_loop=device_loop, device="cpu")
    sa.run(6)
    _, y_best = sa.best()
    assert sa.true_measures <= 0.10 * space.size()
    assert (y_best - y_star) / abs(y_star) <= 0.05
    assert sa.rounds[-1].true_measures == sa.true_measures
    assert sa.rounds[-1].surrogate_queries == sa.surrogate_queries
    assert [r.true_measures for r in sa.rounds] == sorted(
        r.true_measures for r in sa.rounds)


def test_ei_converges_on_960_state_validation_space():
    space, fn = surrogate_scale.validation_problem(smoke=False)
    assert space.size() == 960
    from repro_torch.core.landscape import tabulate

    y_star = float(tabulate(space, fn).min())
    sa = psur.SurrogateAnnealer(space, fn, acquisition="ei", half_width=6,
                                n_chains=16, steps_per_round=48,
                                measures_per_round=6, n_bootstrap=8, seed=0,
                                device="cpu")
    sa.run(14)
    _, y_best = sa.best()
    assert sa.true_measures <= 0.10 * space.size()
    assert (y_best - y_star) / abs(y_star) <= 0.05


def test_rejects_unknown_acquisition():
    with pytest.raises(ValueError, match="acquisition"):
        psur.SurrogateAnnealer(_smooth_space(20), _smooth_fn,
                               acquisition="ucb", device="cpu")


@pytest.mark.parametrize("device_loop", [True, False])
def test_deterministic_under_fixed_seed(device_loop):
    space = _smooth_space(60)
    runs = []
    for _ in range(2):
        sa = psur.SurrogateAnnealer(space, _smooth_fn, half_width=5,
                                    n_chains=8, steps_per_round=32,
                                    measures_per_round=4, seed=7,
                                    device_loop=device_loop, device="cpu")
        sa.run(3)
        runs.append((sa.best(), [r.incumbent for r in sa.rounds],
                     [r.measured for r in sa.rounds]))
    assert runs[0] == runs[1]


def test_bootstrap_states_equal_the_references():
    """The global bootstrap design comes from numpy's ``default_rng(seed)``
    in both packages, so round 0's first measurements are the same."""
    js, ps = _spaces(valid=True)
    for seed in (0, 5):
        ref = jsur.SurrogateAnnealer(js, _fn, n_bootstrap=12, seed=seed)
        port = psur.SurrogateAnnealer(ps, _fn, n_bootstrap=12, seed=seed,
                                      device="cpu")
        assert port.incumbent == ref.incumbent
        assert ([ref._random_valid_state() for _ in range(11)]
                == [port._random_valid_state() for _ in range(11)])


@pytest.mark.parametrize("device_loop", [True, False])
def test_tracks_drifting_landscape(device_loop):
    """With a recency half-life a stale incumbent is re-measured and old
    low readings age out of best(), so the loop re-converges after the
    landscape moves."""
    space = ConfigSpace((Dimension("x", tuple(range(60))),))
    target = {"v": 10}

    def fn(cfg):
        return abs(cfg["x"] - target["v"]) + 1.0

    sa = psur.SurrogateAnnealer(
        space, fn, store=psur.MeasurementStore(1, half_life=2.0),
        half_width=6, n_chains=8, steps_per_round=32, measures_per_round=6,
        seed=0, device_loop=device_loop, device="cpu")
    sa.run(5)
    s1, _ = sa.best()
    assert abs(s1[0] - 10) <= 2
    target["v"] = 50                        # the landscape drifts
    sa.run(14)
    s2, y2 = sa.best()
    assert abs(s2[0] - 50) <= 3, (s2, y2)
    assert sa.stale_refreshes >= 1


@pytest.mark.parametrize("device_loop", [True, False])
def test_respects_validity(device_loop):
    space = ConfigSpace(
        (Dimension("n", tuple(range(1, 65))),
         Dimension("tp", (1, 2, 4, 8))),
        is_valid=lambda c: c["n"] % c["tp"] == 0)

    def fn(cfg):
        assert cfg["n"] % cfg["tp"] == 0, "measured an invalid state"
        return abs(cfg["n"] - 40) + 3.0 * cfg["tp"]

    sa = psur.SurrogateAnnealer(space, fn, half_width=4, n_chains=8,
                                steps_per_round=24, measures_per_round=4,
                                seed=1, device_loop=device_loop,
                                device="cpu")
    sa.run(4)
    state, _ = sa.best()
    assert space.contains(state)


def test_surrogate_scale_smoke_passes_on_the_cpu(monkeypatch, tmp_path):
    """The twin's eight checks at its smoke sizes; its result file under
    ``REPRO_BENCH_OUT``, never the reference's root file."""
    monkeypatch.setenv("REPRO_BENCH_OUT", str(tmp_path))
    res = surrogate_scale.surrogate_scale("cpu", smoke=True)
    assert res["ok"] and len(res["checks"]) == 8, res["checks"]
    assert (tmp_path / "BENCH_torch_surrogate.json").exists()
    assert res["numbers"]["ours"]["scale_states"] == 1_179_648
