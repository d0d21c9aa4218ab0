"""Quickstart: the paper's method on the port — plus the pipeline.

Anneal an IaaS cluster configuration online over a stream of blended
HiBench-like jobs (simulated execution-time models calibrated to the
paper's Figs 6-11), then print the chosen configuration and the spend.
Part two runs the same controller through the speculative evaluation
pipeline (:mod:`repro_torch.core.evalpipe`): the chain speculates 8
transitions ahead, measurements overlap on a worker pool, and the
decision walk stays identical to the serial loop.  The online loop is
host numpy; ``--device`` is where the controller would plan
(``ProcurementController.plan``, the batched walk).

    python -m repro_torch.quickstart --device {cuda,cpu}
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
import time
from typing import Sequence

from . import telemetry
from .core.costmodel import SimulatedEvaluator
from .core.landscape import BLEND_BEFORE, blended_surface
from .core.objective import Objective
from .core.pricing import EC2_CATALOG_ADJUSTED
from .core.procurement import ProcurementController, make_ec2_space


def main(argv: Sequence[str] | None = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    device = ap.parse_args(argv).device

    cores = tuple(range(4, 132, 8))
    space = make_ec2_space(EC2_CATALOG_ADJUSTED, core_counts=cores)
    print(f"configuration space: {space.size()} states "
          f"({' x '.join(space.names)})")

    controller = ProcurementController(
        space=space,
        catalog=EC2_CATALOG_ADJUSTED,
        evaluator=SimulatedEvaluator(EC2_CATALOG_ADJUSTED, noise_std=0.02),
        objective=Objective(lambda_cost=1.0),     # Y = t + 1.0 * c
        blend=dict(BLEND_BEFORE),                 # wordcount/kmeans/pagerank
        evaluate_blend=True,
        schedule=1.0,                             # fixed tau (online mode)
        seed=0,
        device=device,
    )

    # run under a telemetry session so the controller's guarded call
    # sites record the per-round series (dark — zero cost — otherwise)
    with telemetry.session(meta={"example": "quickstart"}) as tel:
        for i in range(300):
            d = controller.submit()
            if i % 50 == 0:
                print(f"job {d.n:4d}  Y={d.y:7.2f}  "
                      f"config=({d.config.instance_type}, "
                      f"{d.config.n_workers} cores)  "
                      f"{'explored' if d.explored else ''}")
    ys = tel.metrics.series("procurement/y").values()
    print(f"\nround dashboard: Y "
          f"{telemetry.sparkline(ys, width=60)}  (300 rounds)")

    # the flight recorder rode along: every committed decision carries
    # an exact objective-term decomposition and a one-line explanation
    why = next(r for r in tel.provenance.records() if r.round == 1)
    print(f"why (round 1): {why.why()}")

    best_cfg, best_y = controller.best_config()
    Y = blended_surface(EC2_CATALOG_ADJUSTED, BLEND_BEFORE, cores)
    print(f"\nbest seen: ({best_cfg.instance_type}, "
          f"{best_cfg.n_workers} cores) Y={best_y:.2f} "
          f"(exhaustive optimum {Y.min():.2f})")
    print(f"exploration rate: {controller.exploration_rate():.1%}")
    print(f"total spend: ${controller.spend():.2f}")

    pipelined(space, device)
    return 0


@dataclasses.dataclass
class SlowEvaluator(SimulatedEvaluator):
    """A wall-clock evaluator: each measurement 'runs the job' for 20 ms.
    `wall_clock` routes it through the evaluation runtime's worker pool."""

    wall_clock = True

    def measure(self, config, job, n):
        time.sleep(0.02)
        return super().measure(config, job, n)


def pipelined(space, device: str) -> None:
    """Part two: the speculative evaluation pipeline.  When measurements
    cost wall-clock time, `lookahead=8` runs the chain ahead of its
    measurements: proposals are speculated, dispatched concurrently, and
    resolved in order — mispredictions rewind the RNG, so the walk is the
    serial chain's, and mis-speculated measurements are recycled into a
    surrogate store instead of discarded."""
    print("\n-- speculative evaluation pipeline (20 ms/job) --")
    walls = {}
    for name, kw in [("serial", {}), ("lookahead=8", {"lookahead": 8})]:
        c = ProcurementController(
            space=space, catalog=EC2_CATALOG_ADJUSTED,
            evaluator=SlowEvaluator(EC2_CATALOG_ADJUSTED),
            objective=Objective(lambda_cost=1.0), blend=dict(BLEND_BEFORE),
            schedule=1.0, seed=0, device=device, **kw)
        t0 = time.perf_counter()
        c.run(60)
        walls[name] = time.perf_counter() - t0
        c.close()
        stats = c.stats()["pipeline"]
        extra = (f"  hit rate {stats['hit_rate']:.0%}, "
                 f"{len(c.recycle_store)} states recycled into the store"
                 if stats else "")
        print(f"{name:>12}: {walls[name]:5.2f}s for 60 jobs{extra}")
    print(f"     speedup: {walls['serial'] / walls['lookahead=8']:.1f}x, "
          f"same decisions")


if __name__ == "__main__":
    sys.exit(main())
