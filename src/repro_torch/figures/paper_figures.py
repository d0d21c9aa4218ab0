"""Reproductions of the paper's illustrative experiments (Figs 2-5) on the
port: the 1-D bimodal landscape, job streams under annealing,
jobs-to-minimum vs temperature, and adaptation to a mid-stream workload
change, with the checks of the reference's ``benchmarks/paper_figures.py``.

The sweeps run through the batched engine (``anneal_fleet``): a
temperature's 16 seeds (Fig. 3) or the whole temperatures x seeds grid
(Fig. 4) is one walk, and Fig. 5's 6,000 steps are one; each walk is one
``anneal_walk`` launch on the card.  ``fig4_engine_speedup`` times the
per-job Python ``Annealer`` against the batched engine.

    python -m repro_torch.figures.paper_figures --device {cuda,cpu}
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch

from ..core import (
    Annealer,
    EncodedSpace,
    StepNeighborhood,
    anneal_chain_nd,
    anneal_fleet,
    bimodal_landscape,
    changed_landscape,
    first_hit_time,
    jobs_to_min_vs_tau_fleet,
)
from ..core.state import ConfigSpace, Dimension
from ..device import generator, resolve_device
from .common import Bench, main, write_csv, write_json


def fig3_jobstream(device: str = "cuda") -> dict:
    """Fig. 3: execution time per submitted job at several temperatures;
    higher tau reaches the global minimum (green line) more rapidly.  A
    temperature's 16 seeds walk as one batched call (the check is a median
    over seeds)."""
    b = Bench("fig3_jobstream", "Fig. 2-3")
    dev = resolve_device(device)
    y = torch.as_tensor(bimodal_landscape(), dtype=torch.float32,
                        device=dev)
    target = int(torch.argmin(y))
    local = 10
    taus = [0.25, 1.0, 2.0, 4.0]
    line = EncodedSpace((y.shape[0],), (False,))
    rows, hits = [], {}
    for i, tau in enumerate(taus):
        out = anneal_fleet(generator(0, i, device=dev), line, y, 3000, tau,
                           inits=[local], n_chains=16, device=dev)
        states = out["states"][..., 0]
        med = first_hit_time(states, target).cpu().numpy()
        s0, y0 = states[0].cpu().numpy(), out["ys"][0].cpu().numpy()
        rows += [[tau, n, int(s0[n]), float(y0[n])]
                 for n in range(0, 3000, 10)]
        hits[tau] = float(np.median(med))
    write_csv("fig3_jobstream.csv",
              ["tau", "job", "state", "exec_time"], rows)
    b.numbers["median_jobs_to_min"] = hits

    b.check("P1: tau=2 chains reach the global minimum (median < horizon)",
            hits[2.0] < 3000)
    b.check("global minimum is deeper than the local one",
            float(y[target]) < float(y[local]))
    b.check("higher tau reaches the minimum faster (tau 0.25 vs 4)",
            hits[4.0] < hits[0.25])
    return b.finish()


def _cores_space(y: np.ndarray) -> ConfigSpace:
    return ConfigSpace((Dimension("cores", tuple(range(len(y)))),))


def fig4_temperature(device: str = "cuda") -> dict:
    """Fig. 4: #jobs until the global minimum vs tau, +-2 std bars; the
    whole (temperatures x seeds) grid is one batched walk."""
    b = Bench("fig4_temperature", "Fig. 4")
    dev = resolve_device(device)
    y = bimodal_landscape()
    taus = [0.25, 0.5, 1.0, 2.0, 4.0]
    res = jobs_to_min_vs_tau_fleet(generator(0, device=dev), _cores_space(y),
                                   y, taus, n_seeds=64, n_steps=4000,
                                   init=(0,), device=dev)
    write_csv("fig4_temperature.csv", ["tau", "mean_jobs", "std_jobs"],
              [[t, m, s] for t, m, s in
               zip(res["taus"], res["mean_jobs"], res["std_jobs"])])
    m = res["mean_jobs"]
    b.numbers["mean_jobs"] = m.tolist()
    b.check("P2: mean jobs-to-minimum decreases with temperature",
            all(m[i] > m[i + 1] for i in range(len(m) - 1)))
    # at the coldest tau some seeds never reach the optimum inside the
    # horizon (all hit the cap -> zero variance); bars just need to exist
    # where the chain actually moves
    b.check("confidence bars computed (std > 0 for tau >= 0.5)",
            (res["std_jobs"][1:] > 0).all())
    return b.finish()


def fig5_change(device: str = "cuda") -> dict:
    """Fig. 5: the landscape changes mid-stream; annealing re-finds the
    new global minimum through exploration."""
    b = Bench("fig5_change", "Fig. 5")
    dev = resolve_device(device)
    y1, y2 = bimodal_landscape(), changed_landscape()
    n, change_at = 6000, 2000
    tables = np.stack([y1 if i < change_at else y2 for i in range(n)]) \
        .astype(np.float32)
    states, ys, _ = anneal_chain_nd(
        generator(0, device=dev), _cores_space(y1), tables, n, tau=1.0,
        init=(int(np.argmin(y1)),), device=dev)
    states = states[:, 0].cpu().numpy()
    ys = ys.cpu().numpy()
    rows = [[i, int(states[i]), float(ys[i])] for i in range(0, n, 10)]
    write_csv("fig5_change.csv", ["job", "state", "exec_time"], rows)

    new_target = int(np.argmin(y2))
    post = states[change_at:]
    b.check("P3: new global minimum visited after the change",
            bool((post == new_target).any()))
    b.check("chain concentrates near the new optimum in steady state",
            float(np.mean(np.abs(post[len(post) // 2:] - new_target) <= 3))
            > 0.2)
    pre = states[:change_at]
    b.check("pre-change chain concentrated near the old optimum",
            float(np.mean(np.abs(pre[change_at // 2:] - int(np.argmin(y1)))
                          <= 3)) > 0.2)
    return b.finish()


def fig4_engine_speedup(device: str = "cuda") -> dict:
    """Fig. 4-style temperature sweep, per-job Python ``Annealer`` vs the
    batched engine: same landscape, same (tau x seed) grid, same step
    budget.  The fleet walks the whole grid in one call; the Python
    annealer steps one proposal per job per chain.  The fleet's times end
    with the first-hit times on the host, so they hold the device's work."""
    b = Bench("fig4_engine_speedup", "Fig. 4 (engine timing)")
    dev = resolve_device(device)
    y = bimodal_landscape()
    space = _cores_space(y)
    taus = [0.25, 0.5, 1.0, 2.0, 4.0]
    n_seeds, n_steps = 8, 1500
    n_chains = len(taus) * n_seeds

    t0 = time.perf_counter()
    py_means = []
    for tau in taus:
        hits = []
        for seed in range(n_seeds):
            ann = Annealer(space, StepNeighborhood(space),
                           evaluate=lambda cfg, n: float(y[cfg["cores"]]),
                           schedule=float(tau), seed=seed, init=(0,))
            steps = ann.run(n_steps)
            target = int(np.argmin(y))
            good = [s.n for s in steps if s.state == (target,)]
            hits.append(good[0] if good else n_steps)
        py_means.append(float(np.mean(hits)))
    t_python = time.perf_counter() - t0

    t0 = time.perf_counter()
    jobs_to_min_vs_tau_fleet(generator(0, device=dev), space, y, taus,
                             n_seeds=n_seeds, n_steps=n_steps, init=(0,),
                             device=dev)
    t_fleet_cold = time.perf_counter() - t0   # includes the kernel's load
    t0 = time.perf_counter()
    res = jobs_to_min_vs_tau_fleet(generator(0, device=dev), space, y, taus,
                                   n_seeds=n_seeds, n_steps=n_steps,
                                   init=(0,), device=dev)
    t_fleet = time.perf_counter() - t0        # steady state

    speedup = t_python / t_fleet
    chain_steps = n_chains * n_steps
    b.numbers = {
        "device": str(dev), "chains": n_chains, "steps_per_chain": n_steps,
        "python_annealer_s": t_python, "fleet_cold_s": t_fleet_cold,
        "fleet_warm_s": t_fleet, "speedup_warm": speedup,
        "speedup_cold": t_python / t_fleet_cold,
        "python_steps_per_s": chain_steps / t_python,
        "fleet_steps_per_s": chain_steps / t_fleet,
    }
    write_json("fig4_engine_speedup.json", b.numbers)
    print(f"    python {t_python:.4f} s, fleet cold {t_fleet_cold:.4f} s, "
          f"warm {t_fleet:.4f} s on {dev}", flush=True)
    b.check("both engines agree on P2 (jobs-to-min decreases with tau)",
            py_means[0] > py_means[-1]
            and res["mean_jobs"][0] > res["mean_jobs"][-1])
    b.check(f">= 10x speedup over the Python Annealer "
            f"(got {speedup:.0f}x warm, cold {t_python / t_fleet_cold:.0f}x)",
            speedup >= 10.0)
    return b.finish()


BENCHES = (fig3_jobstream, fig4_temperature, fig5_change,
           fig4_engine_speedup)


def run_all(device: str = "cuda") -> list[dict]:
    return [bench(device) for bench in BENCHES]


if __name__ == "__main__":
    sys.exit(main(BENCHES))
