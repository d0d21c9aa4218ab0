"""Trace-driven fleet replay at 1k+ tenants, on the port: the twin of the
reference's ``benchmarks/trace_fleet.py``, with its constants and checks.

Replays synthetic Alibaba-style churn traces (tenant arrivals with
heavy-tailed lifetimes, mid-life phase changes, departures releasing
capacity) against the FleetController in its scaled configuration:
event-driven round clock, incremental re-annealing (only churned /
drifted tenants), pow-2 chain bucketing and the incremental reservation
ledger; each round's chains walk in one ``anneal_walk`` launch on the
card.  Writes the tenants-vs-wall-clock scaling curve and SLO attainment
under churn to ``BENCH_torch_trace.json`` (under ``build/figures``).

Claims checked:
  * the 1024-tenant replay is SUB-LINEAR in wall-clock vs the 64-tenant
    baseline (<= half the linear tenant ratio);
  * incremental rounds anneal a small fraction of tenant-rounds (the
    churned subset), yet the fleet stays feasible: zero aggregate
    capacity/budget violations in the final quarter of every replay;
  * SLO attainment under churn stays above the floor at every scale, and
    where the reference's committed ``BENCH_trace.json`` ran the same
    configuration, the attainment and the violation rounds equal its;
  * the bucketed execution path is DECISION-IDENTICAL to the unbucketed
    one on the parity case, under both full and incremental policies
    (the reference's sharded legs need a mesh, which waits for the
    multi-card slice);
  * telemetry, provenance (exact splits summed as the controller's
    ladder, ``provenance.ladder_sum``) and the budget-cut alert as in the
    reference.

    python -m repro_torch.figures.trace_fleet --device {cuda,cpu} [--smoke]
"""

from __future__ import annotations

import json
import sys
import time

import numpy as np

from .. import telemetry
from ..core import (
    EC2_CATALOG_ADJUSTED,
    Objective,
    PenalizedObjective,
    TraceReplayController,
    make_ec2_space,
)
from ..core.costmodel import SimulatedEvaluator
from ..telemetry.provenance import ladder_sum
from ..workloads.trace import synthetic_trace, trace_fingerprint
from .common import ROOT, Bench, main, out_dir, write_json

CORES = tuple(range(4, 132, 8))
LAMBDA = 200.0
PENALTY_WEIGHT = 25.0
CORES_PER_FAMILY = 12.0      # per family, scaled by T
BUDGET_PER_TENANT = 1.6      # $/hr, scaled by T
SLO_S = 3600.0               # per-job sojourn SLO under churn
N_PROFILES = 12              # finite blend pool (objective-table cache)
#: the reference's committed result, its quality metrics the yardstick
REFERENCE = ROOT / "BENCH_trace.json"


def controller(T: int, horizon_s: float, seed: int = 0,
               device: str = "cuda", **kw) -> TraceReplayController:
    """The reference's replay controller at T founding tenants."""
    catalog = EC2_CATALOG_ADJUSTED.with_capacities(
        {f: CORES_PER_FAMILY * T for f in EC2_CATALOG_ADJUSTED.names()})
    space = make_ec2_space(catalog, core_counts=CORES)
    evaluator = SimulatedEvaluator(catalog)
    trace = synthetic_trace(
        sorted(evaluator.jobs), n_tenants=T, horizon_s=horizon_s,
        seed=seed, n_profiles=N_PROFILES)
    kw.setdefault("incremental", True)
    return TraceReplayController(
        trace, space, catalog, evaluator,
        objective=PenalizedObjective(Objective(lambda_cost=LAMBDA),
                                     weight=PENALTY_WEIGHT),
        budget_usd_hr=BUDGET_PER_TENANT * T,
        steps_per_round=32, slo_s=SLO_S, seed=seed, device=device, **kw)


def decision_sig(ctl: TraceReplayController) -> list[tuple]:
    return [(d.round, d.tenant, d.action, d.config, round(d.y, 9))
            for d in ctl.fleet.decisions]


def _check_telemetry(b: Bench, tel: "telemetry.Telemetry", n_rounds: int,
                     result: dict) -> None:
    """The telemetry-armed baseline leg: one fleet.round span per replay
    round with the measure/anneal/arbitrate phases nested inside it, the
    dashboard's series, and bit-exact provenance records."""
    spans: dict[str, list] = {}
    for s in tel.spans.spans():               # (name, cat, ts, dur, ...)
        spans.setdefault(s[0], []).append(s)
    rounds = spans.get("fleet.round", [])
    b.check(f"telemetry: one fleet.round span per replay round "
            f"({len(rounds)}/{n_rounds})", len(rounds) == n_rounds)

    def nested(child) -> bool:                # ts containment, +-2us slack
        cs, ce = child[2], child[2] + child[3]
        return any(p[2] - 2 <= cs and ce <= p[2] + p[3] + 2
                   for p in rounds)

    for phase in ("fleet.measure", "fleet.anneal", "fleet.arbitrate"):
        ph = spans.get(phase, [])
        b.check(f"telemetry: {phase} spans present and nested inside "
                f"fleet.round ({len(ph)})",
                bool(ph) and all(nested(s) for s in ph))
    dash = tel.dashboard()
    for series in ("fleet/objective", "fleet/spend_usd_hr",
                   "trace/slo_attainment"):
        b.check(f"telemetry: dashboard renders {series}", series in dash)
    recs = tel.provenance.records() if tel.provenance is not None else ()
    fleet_recs = [r for r in recs if r.controller == "fleet"]
    rounds_seen = {r.round for r in fleet_recs}
    lo = min(rounds_seen) if rounds_seen else 0
    committed = set(range(lo, n_rounds))
    b.check(f"provenance: every committed round in recorder window has "
            f"decision records ({len(rounds_seen & committed)}/"
            f"{len(committed)})",
            bool(fleet_recs) and committed <= rounds_seen)
    split_ok = all(ladder_sum(r.exact_split) == r.y for r in fleet_recs)
    terms_ok = all(r.check() for r in fleet_recs)
    b.check(f"provenance: exact_split sums bit-equal to committed y "
            f"on all {len(fleet_recs)} records", split_ok)
    b.check(f"provenance: named terms ladder within float32 exactness "
            f"on all {len(fleet_recs)} records", terms_ok)
    result["provenance"] = {
        "records": len(fleet_recs), "rounds_covered": len(rounds_seen),
        "dropped": tel.provenance.dropped if tel.provenance else 0,
        "exact_split_bit_equal": split_ok, "terms_f32_exact": terms_ok}
    pages = [a.rule for a in tel.alerts.fired
             if a.severity == "page"] if tel.alerts is not None else []
    result["alerts"] = {
        "fired": [a.to_dict() for a in tel.alerts.fired]
        if tel.alerts is not None else [],
        "pages": pages,
    }
    paths = tel.write_artifacts("TELEMETRY_torch_trace",
                                out_dir=str(out_dir()))
    with open(paths["perfetto"]) as f:
        events = json.load(f)["traceEvents"]
    b.check(f"telemetry: Perfetto artifact loads "
            f"({len(events)} trace events)", len(events) > 0)
    result["telemetry"] = {"artifacts": paths,
                           "trace_events": len(events),
                           "spans_dropped": tel.spans.dropped}


def _budget_cut_leg(b: Bench, result: dict, device: str) -> None:
    """Inject a budget cut on a small replayed fleet and require the
    default ``spend_over_budget`` page alert to fire, in its own
    telemetry session."""
    with telemetry.session(meta={"bench": "trace_fleet",
                                 "leg": "budget_cut"}) as tel:
        ctl = controller(8, 240.0, seed=3, keep_decision_log=False,
                         device=device)
        ctl.replay()                       # populate tenants, warm state
        fleet = ctl.fleet
        fleet.budget_usd_hr *= 0.02        # even the cheapest states breach
        for _ in range(6):
            fleet.round()
        fired = [a.rule for a in tel.alerts.fired]
    b.check(f"alerts: spend_over_budget page alert fires under an "
            f"injected 98% budget cut (fired: {fired})",
            "spend_over_budget" in fired)
    result["budget_cut_leg"] = {"fired": fired}


def _reference_leg(T: int, horizon_s: float) -> dict | None:
    """The committed reference result at T tenants over ``horizon_s``,
    if it ran that configuration."""
    ref = json.loads(REFERENCE.read_text()).get("scaling", {}).get(str(T))
    return ref if ref and ref["horizon_s"] == horizon_s else None


def trace_fleet(device: str = "cuda", tenant_counts=(64, 256, 1024),
                horizon_s: float = 3600.0, parity_T: int = 64,
                parity_horizon_s: float = 300.0, smoke: bool = False
                ) -> dict:
    if smoke:
        tenant_counts, horizon_s = (64,), 600.0
        parity_T, parity_horizon_s = 16, 240.0
    b = Bench("trace_fleet", "sec. 5 (trace-driven fleet, beyond paper)")
    result: dict = {"smoke": smoke, "device": device, "slo_s": SLO_S,
                    "horizon_s": horizon_s, "scaling": {}, "parity": {}}

    # -- tenants-vs-wall-clock scaling curve ---------------------------
    base_T = tenant_counts[0]
    for T in tenant_counts:
        t0 = time.perf_counter()
        ctl = controller(T, horizon_s, seed=T, keep_decision_log=False,
                         device=device)
        if T == base_T:
            # the baseline leg doubles as the observability check; the
            # larger legs stay dark so the scaling curve is unperturbed
            with telemetry.session(
                    meta={"bench": "trace_fleet", "T": T,
                          "horizon_s": horizon_s}) as tel:
                summary = ctl.replay()
            _check_telemetry(b, tel, len(ctl.rounds), result)
        else:
            summary = ctl.replay()
        total_s = time.perf_counter() - t0
        tail = [r["violation"] for r in
                ctl.rounds[-max(len(ctl.rounds) // 4, 1):]]
        result["scaling"][str(T)] = {
            **summary,
            "total_s": total_s,          # + trace gen, tables, builds
            "trace": trace_fingerprint(ctl.trace),
            "final_quarter_violations": float(np.sum(tail)),
        }
        b.check(f"T={T}: zero aggregate violations in the final 25% of "
                f"rounds", float(np.sum(tail)) == 0.0)
        b.check(f"T={T}: SLO attainment under churn >= 0.8 "
                f"(got {summary['slo_attainment']:.3f})",
                summary["slo_attainment"] >= 0.8)
        b.check(f"T={T}: incremental rounds anneal < 60% of "
                f"tenant-rounds (got "
                f"{summary['annealed_fraction']:.3f})",
                summary["annealed_fraction"] < 0.6)
        ref = _reference_leg(T, horizon_s)
        if ref is not None:
            b.check(f"T={T}: the reference's trace (crc32 "
                    f"{ref['trace']['crc32']}), SLO attainment "
                    f"{ref['slo_attainment']} and violation rounds "
                    f"{ref['violation_rounds']} reproduced (got "
                    f"{summary['slo_attainment']}, "
                    f"{summary['violation_rounds']})",
                    trace_fingerprint(ctl.trace) == ref["trace"]
                    and summary["slo_attainment"] == ref["slo_attainment"]
                    and summary["violation_rounds"]
                    == ref["violation_rounds"])

    if len(tenant_counts) > 1:
        top = str(tenant_counts[-1])
        w0 = result["scaling"][str(base_T)]["wall_s"]
        w1 = result["scaling"][top]["wall_s"]
        lin = tenant_counts[-1] / base_T
        ratio = w1 / max(w0, 1e-9)
        result["scaling_ratio"] = {
            "tenants": lin, "wall_clock": ratio, "sublinear": ratio < lin}
        b.check(f"{top}-tenant replay sub-linear vs {base_T}-tenant "
                f"baseline: wall ratio {ratio:.1f}x <= {lin / 2:.0f}x "
                f"(half of the {lin:.0f}x linear ratio)",
                ratio <= lin / 2)

    # -- unbucketed vs bucketed execution paths: decision identity -----
    variants = {
        "dense_full": dict(incremental=False, chain_bucketing=False),
        "bucketed_full": dict(incremental=False, chain_bucketing=True),
        "dense_incremental": dict(incremental=True, chain_bucketing=False),
        "bucketed_incremental": dict(incremental=True,
                                     chain_bucketing=True),
    }
    sigs = {}
    for name, kw in variants.items():
        ctl = controller(parity_T, parity_horizon_s, seed=7,
                         keep_decision_log=True, device=device, **kw)
        ctl.replay()
        sigs[name] = decision_sig(ctl)
        result["parity"][name] = {"rounds": len(ctl.rounds),
                                  "decisions": len(sigs[name])}
    ok_full = sigs["dense_full"] == sigs["bucketed_full"]
    ok_incr = sigs["dense_incremental"] == sigs["bucketed_incremental"]
    result["parity"]["full_identical"] = ok_full
    result["parity"]["incremental_identical"] = ok_incr
    b.check(f"T={parity_T}: bucketed FULL replay decision-identical to "
            f"unbucketed", ok_full)
    b.check(f"T={parity_T}: bucketed INCREMENTAL replay "
            f"decision-identical to unbucketed", ok_incr)

    # -- provenance is observation-only --------------------------------
    with telemetry.session(meta={"bench": "trace_fleet",
                                 "leg": "parity_armed"}):
        ctl = controller(parity_T, parity_horizon_s, seed=7,
                         keep_decision_log=True, incremental=True,
                         chain_bucketing=False, device=device)
        ctl.replay()
        armed_sig = decision_sig(ctl)
    ok_armed = armed_sig == sigs["dense_incremental"]
    result["parity"]["provenance_armed_identical"] = ok_armed
    b.check(f"T={parity_T}: provenance-armed replay decision-identical "
            f"to dark (observation-only)", ok_armed)

    _budget_cut_leg(b, result, device)
    b.numbers.update({k: v for k, v in result.items()
                      if k in ("scaling", "scaling_ratio", "parity")})
    write_json("BENCH_torch_trace.json", result)
    return b.finish()


BENCHES = (trace_fleet,)


if __name__ == "__main__":
    sys.exit(main(BENCHES, smoke=True))
