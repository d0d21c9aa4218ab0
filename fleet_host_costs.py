#!/usr/bin/env python3
"""Host time of the fleet's round, piece by piece, and the spread of path
H's sub-linear ratio.

Run from the root of a checkout (on the card's machine by default):

    python3 fleet_host_costs.py [--device cuda|cpu] [--tenants 64,1024]
        [--horizon 3600] [--round 60] [--repeats 20] [--turns 5]

(1) For each fleet size, ``repro_torch.figures.trace_fleet``'s controller
(trace and controller seed = the size) is replayed tick by tick to round
``--round``.  On that round's state, each exact shortcut the port's
``FleetController`` round takes over the reference's plain form is timed
both ways, the two forms in turns (three turns of ``--repeats`` calls
each; a form's time is the mean call of its fastest turn), after checking
that both forms give the same result:

  refit              ``_refit`` (replaced blend dicts only) against a
                     ``blend_of`` and a table lookup a tenant
  violation shares   ``_violation_shares`` against each tenant's others'
                     aggregate taken anew
  job draws          ``MultiTenantStream.__next__`` (JobStream's bisect)
                     against numpy's ``Generator.choice(p=)`` a tenant
  measurements       ``_measure_batch`` with SimulatedEvaluator's memo
                     against measuring every tenant anew
  arbitration walk   the improving tenants only against every tenant with
                     a skip test
  coupling rows      ``coupling_rows`` (a family at a time) against one
                     (families, tenants, states) array
  migration copies   a measurement copied only where its migration
                     differs against a copy a tenant
  decision records   ``fleet._decision`` (the record's fields filled
                     directly) against ``FleetDecision(...)``

(2) Replays the smallest and the largest size over ``--horizon`` seconds
in ``--turns`` alternating turns, each begun after a full collection,
and prints each turn's milliseconds a round, each pair's ratio, and the
fastest turns' ratio against half the tenant ratio (``chip_smoke.py``'s
path H (b) check, without its counting); then two turns of each with
Python's cyclic garbage collector paused, for its share of a round.
"""

from __future__ import annotations

import argparse
import copy
import dataclasses
import gc
import sys
import time

import chip_smoke as cs


def best_mean_s(forms: dict, repeats: int, turns: int = 3) -> dict:
    """Each form's mean call (seconds) in its fastest of ``turns`` turns of
    ``repeats`` calls, the forms taking turns.  A form is a callable of
    the call's index."""
    best = {name: float("inf") for name in forms}
    for _ in range(turns):
        for name, fn in forms.items():
            t0 = time.perf_counter()
            for k in range(repeats):
                fn(k)
            best[name] = min(best[name], (time.perf_counter() - t0) / repeats)
    return best


def advance(tf, T: int, horizon: float, rounds: int, device: str):
    """The replay of T tenants ticked to round ``rounds``: the controller,
    the last round's arbitration inputs, the configs the round migrated
    from, and its decisions."""
    from repro_torch.workloads.trace import replay_ticks

    ctl = tf.controller(T, horizon, seed=T, keep_decision_log=False,
                        device=device)
    fleet = ctl.fleet
    ticks = replay_ticks(ctl.trace, ctl.control_period_s)
    store = {}
    real = fleet._arbitrate

    def arbitrate(proposals, pen_tables):
        store["arb"] = (fleet._incumbents.copy(), proposals.copy(),
                        pen_tables.copy())
        return real(proposals, pen_tables)

    fleet._arbitrate = arbitrate
    for _ in range(rounds):
        _, events = next(ticks)
        ctl._apply_events(events)
        prev_cfgs = list(fleet._prev_cfgs)
        decisions = fleet.round()
    del fleet._arbitrate
    return ctl, store["arb"], prev_cfgs, decisions


def piece_costs(T: int, horizon: float, rounds: int, repeats: int,
                device: str) -> dict:
    """Milliseconds a call of each piece in both forms (the port's, the
    other), on the state of round ``rounds`` of the T-tenant replay."""
    import numpy as np

    from repro_torch.core.costmodel import SimulatedEvaluator
    from repro_torch.core.fleet import (_DECISION_FIELDS, FleetDecision,
                                        _decision)
    from repro_torch.core.objective import Measurement
    from repro_torch.figures import trace_fleet as tf
    from repro_torch.workloads.simulator import JobStream

    ctl, (cur, proposals, pen_tables), prev_cfgs, decisions = advance(
        tf, T, horizon, rounds, device)
    f = ctl.fleet
    final = f._incumbents.copy()
    final_v = f._violation(final)
    out = {}

    def timed(name, port, plain, same):
        cs.check(same, f"{T} tenants, {name}: both forms give the same "
                       f"result")
        ms = best_mean_s({"port": port, "plain": plain}, repeats)
        out[name] = (1e3 * ms["port"], 1e3 * ms["plain"])

    def plain_refit(_):
        return [f._table_for(f._stream.blend_of(t.name)) for t in f.tenants]

    f._refit()
    timed("refit", lambda _: f._refit(), plain_refit,
          all(a is b for a, b in zip(plain_refit(0), f._tenant_tables)))

    def plain_shares(_):
        return [max(0.0, final_v - f._overshoot(*f._others_usage(i, final)))
                for i in range(len(final))]

    timed("violation shares", lambda _: f._violation_shares(final, final_v),
          plain_shares,
          f._violation_shares(final, final_v) == plain_shares(0))

    def plain_next(self):
        job = self._names[int(self._rng.choice(len(self._names), p=self._w))]
        self.n += 1
        return job

    port_next = JobStream.__next__

    def draw(impl, stream):
        JobStream.__next__ = impl
        try:
            return next(stream)
        finally:
            JobStream.__next__ = port_next

    live = copy.deepcopy(f._stream)
    timed("job draws", lambda _: draw(port_next, live),
          lambda _: draw(plain_next, live),
          draw(port_next, copy.deepcopy(f._stream))
          == draw(plain_next, copy.deepcopy(f._stream)))

    def plain_measure(self, config, job, n):
        t = self.jobs[job].exec_time(
            config.instance_type, config.total_cores, self.catalog)
        c = self.catalog.cost(config.instance_type, config.total_cores, t)
        return Measurement(exec_time_s=t, cost_usd=c)

    placed = [f._decode_config(s) for s in final.tolist()]
    jobs = [d.job for d in decisions]
    items = [(decoded, job, rounds, cfg)
             for (decoded, cfg), job in zip(placed, jobs)]
    cs.check(f.evaluator.noise_std <= 0, "the simulator measures noise-free")
    memo = SimulatedEvaluator.measure

    def measured(impl):
        SimulatedEvaluator.measure = impl
        try:
            return f._measure_batch(items, eval_workers=f.eval_workers)
        finally:
            SimulatedEvaluator.measure = memo

    timed("measurements", lambda _: measured(memo),
          lambda _: measured(plain_measure),
          measured(memo) == measured(plain_measure))

    rng_t = np.arange(len(cur))
    deltas = pen_tables[rng_t, cur] - pen_tables[rng_t, proposals]
    weights = np.asarray([t.priority for t in f.tenants])
    order = np.argsort(-(weights * deltas), kind="stable")

    def port_walk(_):
        moving = (proposals != cur) & (deltas > 0)
        return [int(i) for i in order[moving[order]]]

    def plain_walk(_):
        out = []
        for i in order:
            if proposals[i] == cur[i] or deltas[i] <= 0:
                continue
            out.append(int(i))
        return out

    timed("arbitration walk", port_walk, plain_walk,
          port_walk(0) == plain_walk(0))

    def plain_rows(_):
        inc = f._incumbents
        agg_cores = f._cores_by_family[:, inc].sum(1)
        agg_spend = float(f._spend_rate[inc].sum())
        others_c = agg_cores[:, None] - f._cores_by_family[:, inc]
        others_s = agg_spend - f._spend_rate[inc]
        over_c = np.clip(
            f._cores_by_family[:, None, :]
            + (others_c - f._capacity[:, None])[:, :, None],
            0.0, None).sum(0)
        over_b = np.clip(f._spend_rate[None, :]
                         + (others_s - f.budget_usd_hr)[:, None], 0.0, None)
        return f.objective.penalize(0.0, over_c + over_b)

    timed("coupling rows", lambda _: f.coupling_rows(), plain_rows,
          np.array_equal(f.coupling_rows(), plain_rows(0)))

    ms_l = measured(memo)
    migs = [f.evaluator.migration(old, cfg, f.catalog)
            for old, (_, cfg) in zip(prev_cfgs, placed)]

    def port_copies(_):
        return [m if (s, u) == (m.migration_s, m.migration_usd)
                else dataclasses.replace(m, migration_s=s, migration_usd=u)
                for (s, u), m in zip(migs, ms_l)]

    def plain_copies(_):
        return [dataclasses.replace(m, migration_s=s, migration_usd=u)
                for (s, u), m in zip(migs, ms_l)]

    timed("migration copies", port_copies, plain_copies,
          port_copies(0) == plain_copies(0)
          == [d.measurement for d in decisions])

    values = [tuple(getattr(d, k) for k in _DECISION_FIELDS)
              for d in decisions]

    def built(v):
        return FleetDecision(*v[:9], true_measures=v[9],
                             surrogate_queries=v[10], tenant=v[11],
                             round=v[12], action=v[13], violation=v[14])

    timed("decision records", lambda _: [_decision(*v) for v in values],
          lambda _: [built(v) for v in values],
          [_decision(*v) for v in values] == decisions
          == [built(v) for v in values])
    print(f"round {rounds} of {T} tenants: {len(f.tenants)} tenants, "
          f"violation {final_v}, {sum(p != c for p, c in zip(proposals, cur))}"
          f" proposals moved, {sum(m != (0.0, 0.0) for m in migs)} "
          f"migrations")
    return out


def replay(tf, T: int, horizon: float, device: str, collector: bool):
    """One replay of T tenants, begun after a full collection (each turn
    starts from the same collector state), with the cyclic collector
    running or paused.  Returns its summary."""
    ctl = tf.controller(T, horizon, seed=T, keep_decision_log=False,
                        device=device)
    gc.collect()
    if not collector:
        gc.disable()
    try:
        return ctl.replay()
    finally:
        gc.enable()


def ratio_turns(sizes: tuple[int, int], horizon: float, turns: int,
                device: str) -> None:
    """The two sizes' replays in alternating turns: each turn's ms a round
    and each pair's ratio, the fastest turns' ratio against the bar; then
    two more turns of each with the cyclic collector paused (its share of
    the round)."""
    from repro_torch.figures import trace_fleet as tf

    small, large = sizes
    for collector, n in ((True, turns), (False, 2)):
        label = "" if collector else ", collector paused"
        walls = {T: [] for T in sizes}
        for turn in range(n):
            for T in sizes:
                s = replay(tf, T, horizon, device, collector)
                walls[T].append(s["wall_s"])
                print(f"turn {turn + 1}{label}: {T} tenants, {s['rounds']} "
                      f"rounds, wall {s['wall_s']} s in rounds, "
                      f"{1e3 * s['wall_s'] / s['rounds']} ms a round")
            print(f"turn {turn + 1}{label}: ratio "
                  f"{walls[large][-1] / walls[small][-1]}")
        ratio = min(walls[large]) / min(walls[small])
        print(f"fastest of {n} turns{label}: {large} tenants "
              f"{min(walls[large])} s, {small} tenants {min(walls[small])} "
              f"s, ratio {ratio} against {large / small / 2} (half the "
              f"tenant ratio)")


def main(argv: list[str]) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--tenants", default="64,1024")
    ap.add_argument("--horizon", type=float, default=3600.0)
    ap.add_argument("--round", type=int, default=60)
    ap.add_argument("--repeats", type=int, default=20)
    ap.add_argument("--turns", type=int, default=5)
    args = ap.parse_args(argv)
    sizes = tuple(int(t) for t in args.tenants.split(","))
    sys.path.insert(0, str(cs.ROOT / "src"))
    if args.device == "cuda":
        import torch

        cs.check(torch.cuda.is_available(), "a CUDA card is visible")
        print(cs.card_line())
    for T in sizes:
        costs = piece_costs(T, args.horizon, args.round, args.repeats,
                            args.device)
        for name, (port, plain) in costs.items():
            print(f"{T} tenants, {name}: port {port} ms, other form "
                  f"{plain} ms, the port's saving {plain - port} ms a "
                  f"round")
    ratio_turns((min(sizes), max(sizes)), args.horizon, args.turns,
                args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
