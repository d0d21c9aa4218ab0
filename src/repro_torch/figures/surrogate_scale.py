"""Surrogate-driven annealing at the million-state scale, on the port: the
twin of the reference's ``benchmarks/surrogate_scale.py``, with its
constants, problems and checks.

``SurrogateAnnealer`` anneals chains on a windowed interpolation of
sparse measurements and spends the real budget on promising or uncertain
states only; in its device loop each round is one ``fused_interp``
launch (the refit), one ``anneal_walk`` launch (the chains), the
selection on the device and one read-back.

Claims checked (the reference's eight, at its thresholds):

  * validation: on a tabulable EC2 blended-HiBench space the run reaches
    within 5% of the exhaustive optimum using <= 10% of the exhaustive
    evaluation count;
  * scale: a >= 1,000,000-state TPU procurement space, which ``tabulate``
    refuses, improves on a random valid configuration with fewer than
    1,000 real evaluations;
  * drift: with a ``half_life`` store the loop converges within 10%
    before a mid-run blend flip, re-measures stale incumbents after it,
    and re-converges within 10% of the new optimum.

Writes ``BENCH_torch_surrogate.json`` (under ``build/figures``), never
the reference's root ``BENCH_surrogate.json``; prints the reference's
committed quality numbers beside the twin's (the random streams differ,
so they are printed, not checked).  The reference's speedup against the
JAX package's committed baseline is not ported; the twin reports its own
warm-up and steady-state round times.

    python -m repro_torch.figures.surrogate_scale --device {cuda,cpu} [--smoke]
"""

from __future__ import annotations

import json
import sys
import time

from ..core import (
    EC2_CATALOG_ADJUSTED,
    TPU_CATALOG,
    ConfigSpace,
    Dimension,
    MeasurementStore,
    Objective,
    RooflineEvaluator,
    StepCosts,
    SurrogateAnnealer,
    cluster_config_from,
    make_ec2_space,
    tabulate,
)
from ..core.costmodel import SimulatedEvaluator
from .common import ROOT, Bench, main, write_json

LAMBDA = 200.0   # dollars-vs-seconds weight (cf. blended_workloads)
#: the reference's committed result, its quality numbers printed beside
REFERENCE = ROOT / "BENCH_surrogate.json"


# ---------------------------------------------------------------------------
# Objectives.
# ---------------------------------------------------------------------------


def validation_problem(smoke: bool):
    """A tabulable EC2 blended-HiBench space (paper Figs. 7-8 shape)."""
    cores = tuple(range(4, 244, 2 if smoke else 1))     # 120 / 240 values
    catalog = EC2_CATALOG_ADJUSTED
    space = make_ec2_space(catalog, core_counts=cores)
    ev = SimulatedEvaluator(catalog)
    obj = Objective(lambda_cost=LAMBDA)
    blend = {"wordcount": 0.5, "kmeans": 0.3, "pagerank": 0.2}

    def fn(decoded):
        cfg = cluster_config_from(decoded)
        return float(sum(w * obj(ev.measure(cfg, name, 0))
                         for name, w in blend.items()))

    return space, fn


def scale_problem():
    """A 1,179,648-state TPU procurement space (3 x 512 x 16 x 8 x 3 x 2)
    under the roofline evaluator — the space ``tabulate`` refuses."""
    space = ConfigSpace(
        (
            Dimension("instance_type", tuple(TPU_CATALOG.names())),
            Dimension("n_workers", tuple(range(8, 8 * 512 + 1, 8))),
            Dimension("tp_degree", tuple(range(1, 17))),
            Dimension("microbatches", tuple(range(1, 9))),
            Dimension("remat", ("none", "block", "full"),
                      kind="categorical"),
            Dimension("compression", ("none", "int8"), kind="categorical"),
        ),
        is_valid=lambda cfg: cfg["n_workers"] % cfg["tp_degree"] == 0,
    )
    ev = RooflineEvaluator(
        catalog=TPU_CATALOG,
        workloads={"train": StepCosts(
            flops=6.0e18, hbm_bytes=2.0e16, collective_bytes=4.0e13,
            steps_per_job=50)},
        grad_bytes={"train": 2.8e10},
    )
    obj = Objective(lambda_cost=1.0)

    def fn(decoded):
        dp = max(decoded["n_workers"] // decoded["tp_degree"], 1)
        cfg = cluster_config_from(decoded).replace(dp_degree=dp)
        return float(obj(ev.measure(cfg, "train", 0)))

    return space, fn


def drift_problem(smoke: bool):
    """A tabulable EC2 space whose workload blend flips mid-run: the
    pre-drift optimum (a small cheap cluster for a wordcount-heavy blend)
    becomes badly suboptimal once the blend turns kmeans-heavy.  Returns
    (space, fn, set_phase, tables) — ``fn`` reads the mutable phase, and
    ``tables`` holds the exhaustive ground truth for both phases."""
    cores = tuple(range(4, 244, 4 if smoke else 2))
    catalog = EC2_CATALOG_ADJUSTED
    space = make_ec2_space(catalog, core_counts=cores)
    ev = SimulatedEvaluator(catalog)
    obj = Objective(lambda_cost=LAMBDA)
    blends = ({"wordcount": 0.8, "kmeans": 0.1, "pagerank": 0.1},
              {"wordcount": 0.1, "kmeans": 0.7, "pagerank": 0.2})
    phase = [0]

    def fn(decoded):
        cfg = cluster_config_from(decoded)
        return float(sum(w * obj(ev.measure(cfg, name, 0))
                         for name, w in blends[phase[0]].items()))

    def set_phase(p: int) -> None:
        phase[0] = p

    tables = []
    for p in range(2):
        set_phase(p)
        tables.append(tabulate(space, fn))
    set_phase(0)
    return space, fn, set_phase, tables


class TimedFn:
    """An objective that adds up the time spent in it, so each round's
    measurement time can be taken out of its wall time: what is left is
    the controller's own refit, anneal and selection."""

    def __init__(self, fn):
        self.fn = fn
        self.seconds = 0.0

    def __call__(self, decoded):
        t0 = time.perf_counter()
        try:
            return self.fn(decoded)
        finally:
            self.seconds += time.perf_counter() - t0


def run_rounds(sa: SurrogateAnnealer, n_rounds: int,
               timed_fn: TimedFn | None = None) -> list[dict]:
    """Drive the loop round by round, recording the trajectory (the
    device's work included in each round's wall time: the round ends in
    its read-back)."""
    traj = []
    for _ in range(n_rounds):
        m0 = timed_fn.seconds if timed_fn is not None else 0.0
        t0 = time.perf_counter()
        rec = sa.round()
        wall = time.perf_counter() - t0
        row = {
            "round": rec.n,
            "true_measures": rec.true_measures,
            "surrogate_queries": rec.surrogate_queries,
            "best_y": rec.best_y,
            "window_size": rec.window_size,
            "wall_s": wall,
        }
        if timed_fn is not None:
            row["measure_s"] = timed_fn.seconds - m0
            row["overhead_s"] = max(wall - row["measure_s"], 0.0)
        traj.append(row)
    return traj


def timing_summary(traj: list[dict]) -> dict:
    """Round 0 (the bootstrap, first window encodings and kernel builds)
    apart from the steady-state rounds after it."""
    steady = traj[1:] or traj
    out = {
        "warmup_wall_s": traj[0]["wall_s"],
        "steady_rounds": len(steady),
        "steady_wall_s_mean": sum(r["wall_s"] for r in steady) / len(steady),
    }
    if "overhead_s" in steady[0]:
        out["steady_overhead_s_mean"] = (
            sum(r["overhead_s"] for r in steady) / len(steady))
    return out


def drift_recovery(b: Bench, smoke: bool, device: str) -> dict:
    """``MeasurementStore`` drift (``half_life``) end to end.  The
    objective flips at a known round; the loop must (1) notice that the
    incumbent's low pre-drift reading has gone stale and re-measure it
    (``stale_refreshes``), and (2) re-converge to the post-drift optimum
    using only recency-decayed measurements."""
    space, fn, set_phase, (table0, table1) = drift_problem(smoke)
    half_life = 4.0
    # acquisition="ei": an exactly-measured incumbent has zero expected
    # improvement, so acquisition alone never re-measures it; the store's
    # half_life staleness rule is what lets best() move on after the flip
    sa = SurrogateAnnealer(
        space, fn,
        store=MeasurementStore(len(space.dimensions), half_life=half_life),
        half_width=6, n_chains=16, steps_per_round=48,
        measures_per_round=8, n_bootstrap=16, seed=0, acquisition="ei",
        device=device)
    pre_rounds = 8 if smoke else 12
    post_rounds = 16 if smoke else 24
    traj = run_rounds(sa, pre_rounds)
    y0_star = float(table0.min())
    _, y_pre = sa.best()
    gap_pre = (y_pre - y0_star) / abs(y0_star)

    set_phase(1)                      # the landscape drifts NOW
    refreshes_before = sa.stale_refreshes
    traj += run_rounds(sa, post_rounds)
    refreshes = sa.stale_refreshes - refreshes_before
    y1_star = float(table1.min())
    _, y_post = sa.best()
    gap_post = (y_post - y1_star) / abs(y1_star)

    result = {
        "half_life": half_life,
        "pre_rounds": pre_rounds, "post_rounds": post_rounds,
        "phase0_optimum": y0_star, "phase0_best": y_pre,
        "phase0_gap_pct": 100.0 * gap_pre,
        "phase1_optimum": y1_star, "phase1_best": y_post,
        "phase1_gap_pct": 100.0 * gap_post,
        "stale_incumbent_refreshes": refreshes,
        "true_measures": sa.true_measures,
        "trajectory": traj,
    }
    b.check(f"drift: pre-drift convergence within 10% of the phase-0 "
            f"optimum (gap {100 * gap_pre:.2f}%)", gap_pre <= 0.10)
    b.check(f"drift: stale incumbents were re-measured after the flip "
            f"({refreshes} half_life-driven refreshes)", refreshes >= 1)
    b.check(f"drift: re-converged within 10% of the post-drift optimum "
            f"(gap {100 * gap_post:.2f}%) without any explicit drift "
            f"signal", gap_post <= 0.10)
    return result


def validation_run(b: Bench, smoke: bool, device: str,
                   device_loop: bool = True) -> dict:
    """The surrogate against the exhaustive optimum on a tabulable
    space, at <= 10% of the exhaustive evaluation count."""
    space, fn = validation_problem(smoke)
    n_exh = space.size()                       # unconstrained: all valid
    y_star = float(tabulate(space, fn).min())
    budget = n_exh // 10                       # <= 10% of exhaustive count
    measures_per_round = 6
    n_bootstrap = 8
    n_rounds = (budget - n_bootstrap) // measures_per_round
    timed = TimedFn(fn)
    sa = SurrogateAnnealer(
        space, timed, half_width=6, n_chains=16, steps_per_round=48,
        measures_per_round=measures_per_round, n_bootstrap=n_bootstrap,
        seed=0, device_loop=device_loop, device=device)
    traj = run_rounds(sa, n_rounds, timed_fn=timed)
    _, y_best = sa.best()
    gap = (y_best - y_star) / abs(y_star)
    loop = "device loop" if device_loop else "host loop"
    b.check(f"validation ({n_exh} states, {loop}): surrogate within 5% of "
            f"the exhaustive optimum (gap {100 * gap:.2f}%)", gap <= 0.05)
    b.check(f"validation ({loop}): <= 10% of the exhaustive evaluation "
            f"count ({sa.true_measures}/{n_exh})",
            sa.true_measures <= 0.10 * n_exh)
    return {
        "states": n_exh,
        "exhaustive_evals": n_exh,
        "exhaustive_optimum": y_star,
        "surrogate_best": y_best,
        "gap_pct": 100.0 * gap,
        "true_measures": sa.true_measures,
        "surrogate_queries": sa.surrogate_queries,
        "trajectory": traj,
    }


def scale_run(b: Bench, smoke: bool, device: str) -> tuple[dict, object]:
    """The 1,179,648-state space ``tabulate`` refuses, end to end.
    Returns (its result, the annealer)."""
    big, big_fn = scale_problem()
    result = {"states": big.size()}
    b.check(f"scale space has >= 1,000,000 states ({big.size():,})",
            big.size() >= 1_000_000)
    try:
        tabulate(big, big_fn)
        tab_refused = False
    except ValueError:
        tab_refused = True
    b.check("tabulate() refuses the scale space (over the 200k cap)",
            tab_refused)

    t0 = time.perf_counter()
    sa = SurrogateAnnealer(
        big, big_fn, half_width=6, n_chains=16,
        steps_per_round=32 if smoke else 64,
        measures_per_round=8, kappa=1.0, seed=0, device=device)
    traj = run_rounds(sa, 4 if smoke else 16)
    wall = time.perf_counter() - t0
    _, y_big = sa.best()
    # baseline: the very first measurement (the random valid incumbent) —
    # what the loop buys over picking a random configuration
    y_first = sa.rounds[0].measured[0][1]
    improvement = (y_first - y_big) / abs(y_first)
    result.update({
        "first_measured_y": y_first,
        "best_y_round0": traj[0]["best_y"],
        "best_y_final": y_big,
        "best_config": big.decode(sa.best()[0]),
        "improvement_pct": 100.0 * improvement,
        "true_measures": sa.true_measures,
        "surrogate_queries": sa.surrogate_queries,
        "wall_s": wall,
        "trajectory": traj,
    })
    b.check(f"scale: improved {100 * improvement:.1f}% over a random "
            f"valid configuration with {sa.true_measures} real "
            f"evaluations ({sa.true_measures / big.size():.5%} of "
            f"the space)",
            improvement > 0.0 and sa.true_measures < 1000)
    return result, sa


def reference_numbers() -> dict | None:
    """The reference's committed quality numbers (``BENCH_surrogate.json``
    at the repository root), or None when it is not there."""
    if not REFERENCE.exists():
        return None
    ref = json.loads(REFERENCE.read_text())
    return {"smoke": ref["smoke"],
            "validation_gap_pct": ref["validation_gap_pct"],
            "drift_gap_pct": ref["drift_gap_pct"],
            "drift_stale_refreshes": ref["drift_stale_refreshes"],
            "scale_states": ref["scale_states"],
            "scale_true_measures":
                ref["scale_trajectory"][-1]["true_measures"]}


def surrogate_scale(device: str = "cuda", smoke: bool = False) -> dict:
    b = Bench("surrogate_scale",
              "ROADMAP: surrogate objective beyond the tabulation cap")
    result: dict = {"smoke": smoke, "lambda": LAMBDA, "device": device}
    result["validation"] = validation_run(b, smoke, device)
    result["scale"], _ = scale_run(b, smoke, device)
    result["drift"] = drift_recovery(b, smoke, device)
    result["timing"] = {
        "validation": timing_summary(result["validation"]["trajectory"]),
        "scale": timing_summary(result["scale"]["trajectory"]),
        "drift": timing_summary(result["drift"]["trajectory"]),
    }
    ours = {"validation_gap_pct": result["validation"]["gap_pct"],
            "drift_gap_pct": result["drift"]["phase1_gap_pct"],
            "drift_stale_refreshes":
                result["drift"]["stale_incumbent_refreshes"],
            "scale_states": result["scale"]["states"],
            "scale_true_measures": result["scale"]["true_measures"]}
    ref = reference_numbers()
    print(f"surrogate_scale on {device}: {ours}")
    print(f"the reference's BENCH_surrogate.json (its own streams; printed, "
          f"not checked): {ref}")
    for name, t in result["timing"].items():
        print(f"  {name}: warm-up round {t['warmup_wall_s']:.4f} s, "
              f"{t['steady_rounds']} steady rounds "
              f"{t['steady_wall_s_mean']:.4f} s each")
    b.numbers.update(ours=ours, reference=ref, timing=result["timing"])
    write_json("BENCH_torch_surrogate.json", {
        "bench": "surrogate_scale", "device": device, "smoke": smoke,
        **ours,
        "validation_trajectory": result["validation"]["trajectory"],
        "scale_trajectory": result["scale"]["trajectory"],
        "drift_trajectory": result["drift"]["trajectory"],
        "timing": result["timing"], "reference": ref})
    return b.finish()


BENCHES = (surrogate_scale,)

if __name__ == "__main__":
    sys.exit(main(BENCHES, smoke=True))
