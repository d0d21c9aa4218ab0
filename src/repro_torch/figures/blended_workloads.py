"""Reproductions of the paper's HiBench experiments (Figs 6-11) on the
port: blended workloads over EC2 instance families, explore/exploit vs
temperature, and adaptation to a blend change, with the checks of the
reference's ``benchmarks/blended_workloads.py``.

The online figures (9, 10, 11) run ``ProcurementController`` (numpy: its
decisions are the reference's under the same seeds); Fig. 10's fleet form
walks the (temperature x seed) grid through the batched engine, one
``anneal_walk`` launch a family-axis kind on the card.

    python -m repro_torch.figures.blended_workloads --device {cuda,cpu}
"""

from __future__ import annotations

import sys

import numpy as np

from ..core import jobs_to_min_vs_tau_fleet
from ..core.change_detect import PageHinkley
from ..core.costmodel import SimulatedEvaluator
from ..core.landscape import (
    BLEND_AFTER,
    BLEND_BEFORE,
    HIBENCH_JOBS,
    blended_surface,
    uniform_hw_jobs,
)
from ..core.objective import Objective
from ..core.pricing import EC2_CATALOG, EC2_CATALOG_ADJUSTED
from ..core.procurement import ProcurementController, make_ec2_space
from ..core.schedules import AdaptiveReheat
from ..core.state import ConfigSpace, Dimension
from ..device import generator, resolve_device
from .common import Bench, main, write_csv

CORES = tuple(range(4, 132, 8))
# lambda chosen so dollars and seconds are the same magnitude for these
# job sizes (a user priority, paper sec. 3); makes the Fig. 7 pricing
# ridge visible exactly as in the paper
LAMBDA = 200.0


def fig7_blended_surface(device: str = "cuda") -> dict:
    """Figs 7-8: objective surface over (family x cores); the storage
    family's pricing creates peaks (Fig. 7) removed by the hypothetical
    re-pricing (Fig. 8).  Host numpy: ``device`` is not used."""
    b = Bench("fig7_blended", "Fig. 7-8")
    rows = []
    surfaces = {}
    for name, cat in (("fig7", EC2_CATALOG), ("fig8", EC2_CATALOG_ADJUSTED)):
        Y = blended_surface(cat, BLEND_BEFORE, CORES, lambda_cost=LAMBDA)
        surfaces[name] = Y
        fams = cat.ordered_by_price()
        for fi, fam in enumerate(fams):
            for ci, c in enumerate(CORES):
                rows.append([name, fam, c, float(Y[fi, ci])])
    write_csv("fig7_blended_surface.csv",
              ["figure", "family", "cores", "objective"], rows)

    f7, f8 = surfaces["fig7"], surfaces["fig8"]
    fams7 = EC2_CATALOG.ordered_by_price()
    storage_row = fams7.index("storage")
    others = [i for i in range(len(fams7)) if i != storage_row]
    b.check("Fig. 7: storage family forms an objective ridge (peaks)",
            float(f7[storage_row].min()) > 1.02 * float(f7[others].min()))
    b.check("Fig. 8: re-priced storage family is comparable",
            abs(float(f8[storage_row].min()) - float(f8[others].min()))
            < 0.25 * float(f8[others].min()))
    b.check("surface has an interior optimum in cores",
            0 < int(np.argmin(f8.min(axis=0))) < len(CORES) - 1)
    return b.finish()


def _controller(tau, seed=0, detector=None, schedule=None, device="cuda"):
    space = make_ec2_space(EC2_CATALOG_ADJUSTED, core_counts=CORES)
    return ProcurementController(
        space=space, catalog=EC2_CATALOG_ADJUSTED,
        evaluator=SimulatedEvaluator(EC2_CATALOG_ADJUSTED),
        objective=Objective(lambda_cost=LAMBDA),
        blend=dict(BLEND_BEFORE), evaluate_blend=True,
        schedule=schedule if schedule is not None else tau,
        detector=detector, seed=seed, device=device)


def fig9_explore_exploit(device: str = "cuda") -> dict:
    """Fig. 9: occurrences of exploration vs exploitation depend on tau."""
    b = Bench("fig9_explore_exploit", "Fig. 9")
    rows, rates = [], {}
    for tau in (0.25, 1.0, 4.0):
        ctrl = _controller(tau, seed=2, device=device)
        ctrl.run(400)
        explo = sum(d.explored for d in ctrl.decisions)
        accept = sum(d.accepted for d in ctrl.decisions)
        rates[tau] = explo / 400
        rows.append([tau, explo, accept - explo, 400 - accept])
    write_csv("fig9_explore_exploit.csv",
              ["tau", "explorations", "improvements", "rejections"], rows)
    b.numbers["exploration_rate"] = rates
    b.check("P4: exploration occurrences increase with tau",
            rates[0.25] < rates[1.0] < rates[4.0])
    return b.finish()


def _ridge_space(kind: str = "ordinal") -> ConfigSpace:
    # uniform CloudLab hardware, price-only family differences (sec. 4.1):
    # storage (priciest) ordered mid-axis = the sec. 4.2.1 ridge
    families = ("memory", "storage", "compute", "general")
    return ConfigSpace((Dimension("instance_type", families, kind=kind),
                        Dimension("n_workers", CORES)))


def fig10_blended_jobs_to_min(device: str = "cuda") -> dict:
    """Fig. 10: jobs until minimum objective, blended workload.

    Uses the UNADJUSTED catalog with the storage family ordered
    mid-axis — the paper's sec. 4.2.1 observation that a poor ordering of
    the categorical instance types introduces non-global local minima:
    the storage-price ridge separates the cheap (compute) and
    memory-rich (memory) basins, so escaping genuinely needs temperature.
    """
    b = Bench("fig10_blended_jobs", "Fig. 10")
    jobs = uniform_hw_jobs(HIBENCH_JOBS)
    space = _ridge_space()
    Y = blended_surface(EC2_CATALOG, BLEND_BEFORE, CORES,
                        lambda_cost=LAMBDA, jobs=jobs)
    y_opt = Y.min()
    rows, means = [], {}
    for tau in (0.25, 1.0, 4.0):
        hits = []
        for seed in range(16):
            ctrl = ProcurementController(
                space=space, catalog=EC2_CATALOG,
                evaluator=SimulatedEvaluator(EC2_CATALOG, jobs=jobs),
                objective=Objective(lambda_cost=LAMBDA),
                blend=dict(BLEND_BEFORE), evaluate_blend=True,
                schedule=tau, seed=seed,
                init=space.encode({"instance_type": "memory",
                                   "n_workers": CORES[6]}),
                device=device)
            ctrl.run(400)
            ys = [d.y for d in ctrl.decisions]
            good = [i for i, yy in enumerate(ys) if yy <= 1.05 * y_opt]
            hits.append(good[0] if good else 400)
        means[tau] = float(np.mean(hits))
        rows.append([tau, means[tau], float(np.std(hits, ddof=1))])
    write_csv("fig10_blended_jobs.csv", ["tau", "mean_jobs", "std_jobs"],
              rows)
    b.numbers["mean_jobs"] = means
    b.check("P2 (blended): jobs-to-near-optimum decreases with tau "
            "(0.25 -> 4)", means[0.25] > means[4.0])
    b.check("most chains reach within 5% of optimum at tau>=1",
            means[1.0] < 400)
    return b.finish()


def fig10_blended_fleet(device: str = "cuda") -> dict:
    """Fig. 10 at fleet scale, through the batched engine: the blended
    surface tabulated over (family x cores), the whole (temperature x
    seed) grid one walk.

    Also exercises the sec. 4.2.1 mitigation the batched engine adds:
    treating the family axis as *categorical* (uniform resample) lets cold
    chains jump the storage-price ridge that traps the ordinal +-1 walk.
    """
    b = Bench("fig10_blended_fleet", "Fig. 10 (batched engine)")
    dev = resolve_device(device)
    jobs = uniform_hw_jobs(HIBENCH_JOBS)
    families = ("memory", "storage", "compute", "general")  # ridge mid-axis
    fams_by_price = EC2_CATALOG.ordered_by_price()
    Y = blended_surface(EC2_CATALOG, BLEND_BEFORE, CORES,
                        lambda_cost=LAMBDA, jobs=jobs)
    table = Y[[fams_by_price.index(f) for f in families], :]
    taus = (0.25, 1.0, 4.0)
    init = (0, 6)                                # memory family, mid cores

    results, rows = {}, []
    for kind in ("ordinal", "categorical"):
        res = jobs_to_min_vs_tau_fleet(
            generator(10, device=dev), _ridge_space(kind), table, taus,
            n_seeds=64, n_steps=2000, init=init, device=dev)
        results[kind] = res
        for t, m, s in zip(res["taus"], res["mean_jobs"], res["std_jobs"]):
            rows.append([kind, t, m, s])
    write_csv("fig10_blended_fleet.csv",
              ["family_axis", "tau", "mean_jobs", "std_jobs"], rows)

    mo = results["ordinal"]["mean_jobs"]
    mc = results["categorical"]["mean_jobs"]
    b.numbers["mean_jobs"] = {"ordinal": mo.tolist(),
                              "categorical": mc.tolist()}
    b.check("P2 (blended, fleet): ordinal jobs-to-minimum decreases with "
            "tau (the ridge needs temperature)",
            mo[0] > mo[1] > mo[2])
    b.check("sec 4.2.1: categorical resampling crosses the pricing ridge "
            "faster than the ordinal walk at cold tau",
            mc[0] < mo[0])
    b.check("with the ridge gone, cold categorical chains reach the "
            "optimum almost immediately",
            mc[0] < 50)
    return b.finish()


def fig11_adaptation(device: str = "cuda") -> dict:
    """Fig. 11: blend changes mid-stream; controller adapts (detector-
    driven re-heat)."""
    b = Bench("fig11_adaptation", "Fig. 11")
    ctrl = _controller(
        None, seed=3,
        schedule=AdaptiveReheat(tau_base=0.8, tau_hot=6.0, relax=0.95),
        detector=PageHinkley(delta=0.2, threshold=4.0), device=device)
    ctrl.run(250)
    ctrl.reweight(BLEND_AFTER)
    ctrl.run(350)
    rows = [[d.n, d.y, d.tau, int(d.reheated), d.config.instance_type,
             d.config.n_workers] for d in ctrl.decisions]
    write_csv("fig11_adaptation.csv",
              ["job", "objective", "tau", "reheated", "family", "cores"],
              rows)

    Y2 = blended_surface(EC2_CATALOG_ADJUSTED, BLEND_AFTER, CORES,
                         lambda_cost=LAMBDA)
    post = ctrl.decisions[250:]
    best_post = min(d.y for d in post)
    b.numbers["best_post_over_optimum"] = best_post / float(Y2.min())
    b.check("P3 (blended): near-optimal for the NEW blend after change",
            best_post <= 1.2 * Y2.min())
    b.check("detector fired after the change",
            any(d.reheated for d in post))
    b.check("temperature spiked after the change",
            max(d.tau for d in post) > 2 * 0.8)
    return b.finish()


BENCHES = (fig7_blended_surface, fig9_explore_exploit,
           fig10_blended_jobs_to_min, fig10_blended_fleet, fig11_adaptation)


def run_all(device: str = "cuda") -> list[dict]:
    return [bench(device) for bench in BENCHES]


if __name__ == "__main__":
    sys.exit(main(BENCHES))
