"""Multi-tenant fleet arbitration at scale, on the port: the twin of the
reference's ``benchmarks/fleet_arbitration.py``, with its constants and
checks.

A Fig. 10-style blended-fleet run: T tenants (8-64), each with its own
HiBench blend (staggered sec. 4.3-style change points for a quarter of
them), anneal over the shared EC2 catalog under per-family core capacities
and a global $/hr budget.  The FleetController walks all tenants' chains
in ONE ``anneal_walk`` launch per control round with the coupling penalty
folded into the acceptance rule, then arbitrates (admit/defer/preempt).

Claims checked:
  * zero aggregate capacity/budget violations over the final 25% of rounds
    at every fleet size, with the capacity actually binding;
  * >= 5x wall-clock win over T independent ProcurementControllers given
    the same per-tenant transition budget (rounds x steps jobs each);
  * the independent controllers — annealing the same blends with no shared
    coupling — DO blow the aggregate capacity, which is the motivating
    failure mode (per-service tuning overspends without a cluster budget).

``--smoke`` runs one fleet of 32 tenants for 48 rounds (the reference runs
8, 32 and 64 tenants, timed at 32, for 384 rounds).

    python -m repro_torch.figures.fleet_arbitration --device {cuda,cpu} \\
        [--smoke]
"""

from __future__ import annotations

import sys
import time

import numpy as np

from ..core import (
    EC2_CATALOG_ADJUSTED,
    HIBENCH_JOBS,
    FleetController,
    Objective,
    PenalizedObjective,
    ProcurementController,
    TenantSpec,
    make_ec2_space,
)
from ..core.costmodel import SimulatedEvaluator
from .common import Bench, main, write_json

CORES = tuple(range(4, 132, 8))
LAMBDA = 200.0          # dollars vs seconds weight (cf. blended_workloads)
PENALTY_WEIGHT = 25.0   # objective units per core (or $/hr) of overshoot
CORES_PER_FAMILY = 12.0     # capacity per family, scaled by T
BUDGET_PER_TENANT = 1.6     # $/hr of global budget, scaled by T


def tenants(T: int, rounds: int, seed: int = 0) -> list[TenantSpec]:
    """Deterministic per-tenant blends; every 4th tenant's blend flips at a
    staggered round (the paper's sec. 4.3 change, per tenant)."""
    rng = np.random.default_rng(seed)
    jobs = list(HIBENCH_JOBS)
    out = []
    for i in range(T):
        w = rng.dirichlet(np.ones(len(jobs)) * 2.0)
        blend = {j: float(x) for j, x in zip(jobs, w)}
        after, change = None, None
        if i % 4 == 0:
            after = {j: float(x) for j, x in zip(jobs, w[::-1])}
            change = rounds // 2 + (i // 4) % max(rounds // 4, 1)
        out.append(TenantSpec(
            name=f"tenant{i:02d}", blend=blend,
            priority=1.0 + 0.5 * (i % 3),
            blend_after=after, change_at=change))
    return out


def capped_catalog(T: int):
    caps = {f: CORES_PER_FAMILY * T for f in EC2_CATALOG_ADJUSTED.names()}
    return EC2_CATALOG_ADJUSTED.with_capacities(caps)


def fleet(T: int, rounds: int, steps: int, seed: int = 0,
          device: str = "cuda") -> FleetController:
    catalog = capped_catalog(T)
    space = make_ec2_space(catalog, core_counts=CORES)
    ctrl = FleetController(
        space, catalog, SimulatedEvaluator(catalog),
        tenants(T, rounds, seed=seed),
        objective=PenalizedObjective(Objective(lambda_cost=LAMBDA),
                                     weight=PENALTY_WEIGHT),
        budget_usd_hr=BUDGET_PER_TENANT * T,
        steps_per_round=steps, tau=1.0, seed=seed, device=device)
    ctrl.run(rounds)
    return ctrl


def independent_violations(
    controllers, T: int, rounds: int, steps: int
) -> list[float]:
    """Replay the uncoupled controllers' decision logs at round boundaries
    and measure the aggregate overshoot they would have caused."""
    catalog = capped_catalog(T)
    budget = BUDGET_PER_TENANT * T
    out = []
    for r in range(rounds):
        n = (r + 1) * steps - 1
        cores: dict[str, float] = {f: 0.0 for f in catalog.names()}
        spend = 0.0
        for ctrl in controllers:
            cfg = ctrl.decisions[n].config
            cores[cfg.instance_type] += cfg.total_cores
            spend += (catalog[cfg.instance_type].price_per_core_hr
                      * cfg.total_cores)
        over = sum(max(0.0, c - catalog.capacity(f))
                   for f, c in cores.items())
        out.append(over + max(0.0, spend - budget))
    return out


def fleet_arbitration(
    device: str = "cuda", tenant_counts=(8, 32, 64), timed_T: int = 32,
    rounds: int = 384, steps: int = 40, smoke: bool = False,
) -> dict:
    """``rounds`` is a realistic control horizon: the fleet's one-time
    costs (per-tenant tabulation, the kernel's build) amortize over it, so
    the cold speedup below is the end-to-end wall-clock ratio (the warm
    one is reported separately as ``speedup_warm``)."""
    if smoke:
        tenant_counts, timed_T, rounds = (32,), 32, 48
    b = Bench("fleet_arbitration", "sec. 5 (multi-tenant, beyond paper)")
    result: dict = {"smoke": smoke, "device": device, "rounds": rounds,
                    "steps_per_round": steps, "lambda": LAMBDA,
                    "penalty_weight": PENALTY_WEIGHT, "fleet": {},
                    "timed": {}}

    # -- violation profile across fleet sizes; the timed_T run is timed
    # in place (cold: tabulation included) --
    fleet_ctrl = None
    t_fleet_cold = None
    for T in tenant_counts:
        t0 = time.perf_counter()
        ctrl = fleet(T, rounds, steps, seed=T, device=device)
        elapsed = time.perf_counter() - t0
        if T == timed_T:
            fleet_ctrl, t_fleet_cold = ctrl, elapsed
        tail = ctrl.violation_history[-max(rounds // 4, 1):]
        result["fleet"][str(T)] = {
            "violations_by_round": list(ctrl.violation_history),
            "final_quarter_violations": float(np.sum(tail)),
            "usage": {k: v for k, v in ctrl.aggregate_usage().items()
                      if k != "cores"},
            "cores": ctrl.aggregate_usage()["cores"],
            "actions": {a: sum(d.action == a for d in ctrl.decisions)
                        for a in ("admit", "hold", "defer", "preempt")},
        }
        b.check(f"T={T}: zero aggregate violations in the final 25% of "
                f"rounds", float(np.sum(tail)) == 0.0)
        b.check(f"T={T}: capacity/budget pressure is actually binding "
                f"(some defer/preempt/penalty activity)",
                any(d.action in ("defer", "preempt") for d in ctrl.decisions)
                or any(d.violation > 0 for d in ctrl.decisions))

    # -- timed head-to-head at timed_T tenants --
    if fleet_ctrl is None:
        t0 = time.perf_counter()
        fleet_ctrl = fleet(timed_T, rounds, steps, seed=timed_T,
                           device=device)
        t_fleet_cold = time.perf_counter() - t0
    fleet_tail = fleet_ctrl.violation_history[-max(rounds // 4, 1):]
    # warm steady-state rate: the same controller continuing
    t0 = time.perf_counter()
    fleet_ctrl.run(rounds)
    t_fleet_warm = time.perf_counter() - t0

    specs = tenants(timed_T, rounds, seed=timed_T)
    catalog = capped_catalog(timed_T)
    space = make_ec2_space(catalog, core_counts=CORES)
    t0 = time.perf_counter()
    independents = []
    for i, spec in enumerate(specs):
        ctrl = ProcurementController(
            space=space, catalog=catalog,
            evaluator=SimulatedEvaluator(catalog),
            objective=Objective(lambda_cost=LAMBDA),
            blend=dict(spec.blend), evaluate_blend=True,
            schedule=1.0, seed=i, device=device)
        # same transition budget AND the same blend change points as the
        # fleet run — a drifting tenant reweights mid-stream
        if spec.change_at is None:
            ctrl.run(rounds * steps)
        else:
            ctrl.run(spec.change_at * steps)
            ctrl.reweight(dict(spec.blend_after))
            ctrl.run((rounds - spec.change_at) * steps)
        independents.append(ctrl)
    t_indep = time.perf_counter() - t0
    speedup_cold = t_indep / max(t_fleet_cold, 1e-9)
    speedup_warm = t_indep / max(t_fleet_warm, 1e-9)

    indep_viol = independent_violations(independents, timed_T, rounds,
                                        steps)
    result["timed"] = {
        "tenants": timed_T,
        "t_fleet_cold_s": t_fleet_cold,    # tabulation included
        "t_fleet_warm_s": t_fleet_warm,    # steady-state, same #rounds
        "t_independent_s": t_indep,
        "speedup": speedup_cold,
        "speedup_warm": speedup_warm,
        "fleet_final_quarter_violations": float(np.sum(fleet_tail)),
        "independent_violations_by_round": indep_viol,
        "independent_rounds_in_violation":
            int(np.sum(np.asarray(indep_viol) > 0)),
    }
    b.check(f"T={timed_T}: fleet controller >= 5x faster than "
            f"{timed_T} independent controllers, cold start included "
            f"(cold {speedup_cold:.1f}x, warm {speedup_warm:.1f}x)",
            speedup_cold >= 5.0)
    b.check("independent (uncoupled) controllers blow the aggregate "
            "capacity — the motivating failure",
            max(indep_viol) > 0)
    b.numbers.update({k: v for k, v in result["timed"].items()
                      if not isinstance(v, list)})
    write_json("BENCH_torch_fleet_arbitration.json", result)
    return b.finish()


BENCHES = (fleet_arbitration,)


if __name__ == "__main__":
    sys.exit(main(BENCHES, smoke=True))
