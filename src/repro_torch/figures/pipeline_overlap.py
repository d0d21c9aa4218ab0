"""Speculative evaluation pipeline: the wall-clock overlap win, on the
port — the twin of the reference's ``benchmarks/pipeline_overlap.py``,
with its constants and checks.

The paper's online controller evaluates exactly one job per annealing
transition, so it is serialized on measurement latency.  The speculative
evaluation runtime (:mod:`repro_torch.core.evalpipe`) runs the chain
``K`` transitions ahead, dispatches the speculated measurements over a
bounded worker pool, and resolves acceptance in transition order —
recycling every mis-speculated measurement into the surrogate store.

Claims checked:

  * on a measured (wall-clock) evaluator with 50 ms/job latency, the
    pipelined controller at lookahead K=8 is >= 3x faster end-to-end than
    the serial inline loop;
  * at K=1 the pipeline is decision-sequence *identical* to the inline
    loop under the same seed, as in the reference's committed
    ``BENCH_pipeline.json``;
  * the fleet controller's per-round measurement phase overlaps the same
    way: T wall-clock tenants measured by the worker pool in ~1/T of the
    serial loop's time, with identical decisions.

Writes ``pipeline_overlap.json`` and ``BENCH_torch_pipeline.json`` under
``build/figures``.

    python -m repro_torch.figures.pipeline_overlap --device {cuda,cpu} \\
        [--smoke]
"""

from __future__ import annotations

import dataclasses
import json
import sys
import time

from ..core import (
    EC2_CATALOG,
    EC2_CATALOG_ADJUSTED,
    FleetController,
    Objective,
    PenalizedObjective,
    ProcurementController,
    ServiceCatalog,
    TenantSpec,
    make_ec2_space,
)
from ..core.costmodel import SimulatedEvaluator
from ..core.landscape import BLEND_BEFORE
from .common import ROOT, Bench, main, write_json

JOB_LATENCY_S = 0.050        # the acceptance criterion's 50 ms/job
LOOKAHEAD = 8
HEDGE_MARGIN = 0.25          # hedge when |p_hat - u| is within this
#: the reference's committed result
REFERENCE = ROOT / "BENCH_pipeline.json"


@dataclasses.dataclass
class SlowSimulatedEvaluator(SimulatedEvaluator):
    """A ``MeasuredEvaluator``-shaped workload: every measurement costs
    real wall-clock time (the job "runs" for ``latency_s``), but the
    measured values come from the deterministic simulator so decision
    parity is checkable.  ``wall_clock`` routes it through the evaluation
    runtime's worker pool."""

    wall_clock = True

    latency_s: float = JOB_LATENCY_S

    def measure(self, config, job, n):
        time.sleep(self.latency_s)
        return super().measure(config, job, n)


def _controller(evaluator, device: str, **kw) -> ProcurementController:
    space = make_ec2_space(EC2_CATALOG_ADJUSTED,
                           core_counts=tuple(range(4, 68, 8)))
    return ProcurementController(
        space=space, catalog=EC2_CATALOG_ADJUSTED, evaluator=evaluator,
        objective=Objective(lambda_cost=1.0), blend=dict(BLEND_BEFORE),
        schedule=1.0, seed=0, device=device, **kw)


def _trace(decisions):
    """The decision sequence, counters excluded (they also count recycled
    speculative measurements, which is the point, not a divergence)."""
    return [(d.n, d.job, d.config, round(d.y, 9), d.accepted, d.explored,
             d.tau, d.reheated, d.measurement) for d in decisions]


FLEET_TENANTS = 8
FLEET_FAMILIES = ("general", "compute", "memory", "storage")


def _fleet_catalog() -> ServiceCatalog:
    return ServiceCatalog({f: EC2_CATALOG[f] for f in FLEET_FAMILIES},
                          capacities={f: 600.0 for f in FLEET_FAMILIES})


def _fleet(workers: int, device: str,
           latency_s: float = JOB_LATENCY_S) -> FleetController:
    """The fleet leg's controller: tables come from the instant
    simulator; only the per-round ground-truth measurement phase pays
    wall-clock latency.  Each controller gets its own catalog (the fleet
    reserves into its ledger and honors foreign holds)."""
    cat = _fleet_catalog()
    space = make_ec2_space(cat, core_counts=tuple(range(4, 36, 8)))
    tenants = [TenantSpec(f"t{i}", {"wordcount": 1.0, "kmeans": 1.0})
               for i in range(FLEET_TENANTS)]
    f = FleetController(
        space, cat, SimulatedEvaluator(cat), tenants,
        objective=PenalizedObjective(Objective(lambda_cost=200.0),
                                     weight=25.0),
        steps_per_round=8, seed=0, eval_workers=workers, device=device)
    f.evaluator = SlowSimulatedEvaluator(cat, latency_s=latency_s)
    return f


def _fleet_trace(decisions):
    return [(d.tenant, d.round, d.action, d.accepted, round(d.y, 9),
             d.config, d.measurement) for d in decisions]


def pipeline_overlap(device: str = "cuda", smoke: bool = False) -> dict:
    b = Bench("pipeline_overlap",
              "speculative evaluation pipeline wall-clock win")
    n_jobs = 60 if smoke else 120
    result: dict = {"smoke": smoke, "device": device, "n_jobs": n_jobs,
                    "job_latency_ms": JOB_LATENCY_S * 1e3,
                    "lookahead": LOOKAHEAD}
    reference = json.loads(REFERENCE.read_text())

    # -- serial inline loop (the paper's mode: one job per transition) --
    serial = _controller(SlowSimulatedEvaluator(EC2_CATALOG_ADJUSTED),
                         device)
    t0 = time.perf_counter()
    d_serial = serial.run(n_jobs)
    wall_serial = time.perf_counter() - t0

    # -- pipelined at K=8, hedged both-branch speculation --
    piped = _controller(SlowSimulatedEvaluator(EC2_CATALOG_ADJUSTED),
                        device, lookahead=LOOKAHEAD,
                        hedge_margin=HEDGE_MARGIN)
    t0 = time.perf_counter()
    d_piped = piped.run(n_jobs)
    wall_piped = time.perf_counter() - t0
    piped.close()
    stats = piped.stats()["pipeline"]

    speedup = wall_serial / max(wall_piped, 1e-9)
    result["procurement"] = {
        "wall_serial_s": round(wall_serial, 3),
        "wall_pipelined_s": round(wall_piped, 3),
        "speedup": round(speedup, 2),
        "serial_measures": serial.evaluation_counts()["true_measures"],
        "pipelined_measures": piped.evaluation_counts()["true_measures"],
        "recycled_into_store": len(piped.recycle_store),
        "speculation": stats,
    }
    b.check(f"pipelined K={LOOKAHEAD} is >= 3x faster than the serial "
            f"loop on a {JOB_LATENCY_S * 1e3:.0f} ms/job evaluator "
            f"({wall_serial:.2f}s -> {wall_piped:.2f}s, {speedup:.1f}x; "
            f"the reference's committed {reference['speedup']}x)",
            speedup >= 3.0)
    b.check(f"speculation hit rate {stats['hit_rate']:.0%} with "
            f"{stats['recycled_landed']} mis-speculated measurements "
            f"recycled into the surrogate store (exactly once each) and "
            f"{stats['cancelled']} cancelled before running",
            stats["recycled_landed"] + stats["cancelled"]
            == stats["recycled"]
            and len(piped.recycle_store) > 0)
    b.check(f"hedged speculation covers the measurement stall on "
            f"{stats['hedged_covered']}/{stats['mispredictions']} "
            f"mispredictions (hit rate {stats['hit_rate']:.0%} > 90% at "
            f"K={LOOKAHEAD})", stats["hit_rate"] > 0.9)
    b.check("decision trace at K=8 matches the serial loop (same seed; "
            "rng-rewind on misprediction keeps the realized walk serial-"
            "identical)", _trace(d_serial)[:1] == _trace(d_piped)[:1]
            and [t[:8] for t in _trace(d_serial)]
            == [t[:8] for t in _trace(d_piped)])

    # -- K=1 degenerate path: full decision-sequence parity --
    inline = _controller(SlowSimulatedEvaluator(EC2_CATALOG_ADJUSTED),
                         device, use_pipeline=False)
    piped1 = _controller(SlowSimulatedEvaluator(EC2_CATALOG_ADJUSTED),
                         device, use_pipeline=True, lookahead=1)
    k = min(n_jobs, 40)
    tr_inline = _trace(inline.run(k))
    tr_piped1 = _trace(piped1.run(k))
    piped1.close()
    parity = tr_inline == tr_piped1
    result["parity_k1"] = {"n_jobs": k, "equal": parity}
    b.check(f"K=1 decision-sequence parity with the inline loop "
            f"(accept/reject trace, configs, objectives, measurements), as "
            f"in the reference (parity_k1 {reference['parity_k1']})",
            parity and parity == reference["parity_k1"])

    # -- fleet: the round measurement phase overlaps across tenants --
    T = FLEET_TENANTS
    rounds = 2 if smoke else 4
    _fleet(1, device).run(1)   # build and load the walk kernel untimed
    fa = _fleet(1, device)
    t0 = time.perf_counter()
    dfa = fa.run(rounds)
    wall_fleet_serial = time.perf_counter() - t0
    fb = _fleet(T, device)
    t0 = time.perf_counter()
    dfb = fb.run(rounds)
    wall_fleet_pool = time.perf_counter() - t0
    fleet_speedup = wall_fleet_serial / max(wall_fleet_pool, 1e-9)

    result["fleet"] = {
        "tenants": T, "rounds": rounds,
        "wall_serial_s": round(wall_fleet_serial, 3),
        "wall_pool_s": round(wall_fleet_pool, 3),
        "speedup": round(fleet_speedup, 2),
    }
    b.check(f"fleet measurement phase: {T}-tenant rounds "
            f"{fleet_speedup:.1f}x faster through the worker pool (> 1x; "
            f"the reference's committed {reference['fleet_speedup']}x; "
            f">= 2x its own bar), identical decisions",
            fleet_speedup >= 2.0 and _fleet_trace(dfa) == _fleet_trace(dfb))

    write_json("pipeline_overlap.json", result)
    summary = {
        "bench": "pipeline_overlap", "smoke": smoke, "device": device,
        "speedup": result["procurement"]["speedup"],
        "fleet_speedup": result["fleet"]["speedup"],
        "parity_k1": parity, "speculation": stats,
    }
    write_json("BENCH_torch_pipeline.json", summary)
    b.numbers.update({k: summary[k] for k in ("speedup", "fleet_speedup",
                                              "parity_k1")})
    return b.finish()


BENCHES = (pipeline_overlap,)


if __name__ == "__main__":
    sys.exit(main(BENCHES, smoke=True))
