"""Synthetic cluster traces: tenant arrival / departure / phase-change
event streams with heavy churn.

A numpy copy of the reference package's ``workloads/trace.py``, pinned
bit for bit by ``tests/test_torch_numpy_copies.py``.

The fleet benchmarks historically ran a FIXED cohort of tenants on a fixed
round grid — every tenant present from round 0 to the end, every tenant
re-annealed every round.  Real multi-tenant clusters (the Alibaba cluster
traces being the canonical public example) look nothing like that: tasks
arrive continuously, run for heavy-tailed lifetimes, *release* their
resources on departure, and shift workload phase mid-life.  This module
generates such a stream deterministically from a seed:

* **arrivals** follow a Poisson process whose rate is chosen so the
  steady-state concurrency hovers around ``n_tenants`` (Little's law:
  ``rate = churn * n_tenants / mean_lifetime_s``), on top of a founding
  cohort of ``n_tenants`` tenants present at t=0;
* **lifetimes** are lognormal (heavy right tail — a few long-running
  services among many short tasks), truncated to a configurable floor;
* **phase changes** fire as a per-tenant Poisson process over the
  tenant's lifetime, switching the tenant's blend to another profile from
  a finite pool (real workloads cluster into a small number of types —
  the pool is what keeps the fleet's objective-table cache effective);
* **blend profiles** are Dirichlet draws over the job-type simplex, plus
  a priority class per tenant.

Everything is drawn from one :class:`numpy.random.Generator` in a fixed
order, so a seed fully determines the event sequence; a compact
:func:`trace_fingerprint` guards the generator against silent
distribution drift (golden test).  This module deliberately imports
nothing from :mod:`repro_torch.core` — job names are parameters — so the
dependency keeps pointing core -> workloads only.
"""

from __future__ import annotations

import dataclasses
import zlib
from typing import Any, Iterator, Mapping, Sequence

import numpy as np

# stable sort rank per event kind at equal timestamps: departures first
# (their capacity must be claimable by an arrival in the same tick), then
# arrivals, then phase changes
_KIND_ORDER = {"depart": 0, "arrive": 1, "phase": 2}


@dataclasses.dataclass(frozen=True)
class TraceEvent:
    """One event of a replayable cluster trace.

    ``kind`` is ``"arrive"`` (tenant joins the fleet, with a blend
    ``profile`` and a ``priority``), ``"depart"`` (tenant leaves,
    releasing its catalog share), or ``"phase"`` (the tenant's workload
    blend switches to ``profile`` — the per-tenant drift the controllers'
    detectors exist for).
    """

    t: float
    kind: str
    tenant: str
    profile: int = -1           # blend-profile index; -1 for departures
    priority: float = 1.0

    def __post_init__(self) -> None:
        if self.kind not in _KIND_ORDER:
            raise ValueError(f"unknown event kind {self.kind!r}")
        if self.kind != "depart" and self.profile < 0:
            raise ValueError(f"{self.kind} event needs a profile index")

    def sort_key(self) -> tuple:
        return (self.t, _KIND_ORDER[self.kind], self.tenant)


@dataclasses.dataclass(frozen=True)
class SyntheticTrace:
    """A generated trace: the sorted event list plus the blend-profile
    pool the events' ``profile`` indices refer to."""

    events: tuple[TraceEvent, ...]
    profiles: tuple[Mapping[str, float], ...]
    priorities: tuple[float, ...]        # priority classes used
    horizon_s: float
    seed: int

    def founding(self) -> list[TraceEvent]:
        """The t=0 arrival cohort (tenants present when replay starts)."""
        return [e for e in self.events if e.t == 0.0 and e.kind == "arrive"]

    def concurrency_curve(self) -> list[tuple[float, int]]:
        """(t, live tenant count) after each arrive/depart event."""
        n, out = 0, []
        for e in self.events:
            if e.kind == "arrive":
                n += 1
            elif e.kind == "depart":
                n -= 1
            else:
                continue
            out.append((e.t, n))
        return out

    def stats(self) -> dict[str, Any]:
        kinds = {k: 0 for k in _KIND_ORDER}
        for e in self.events:
            kinds[e.kind] += 1
        curve = self.concurrency_curve()
        return {
            "n_events": len(self.events),
            "arrivals": kinds["arrive"],
            "departures": kinds["depart"],
            "phase_changes": kinds["phase"],
            "peak_tenants": max(n for _, n in curve) if curve else 0,
            "horizon_s": self.horizon_s,
            "n_profiles": len(self.profiles),
        }


def synthetic_trace(
    job_names: Sequence[str],
    n_tenants: int = 64,
    horizon_s: float = 3600.0,
    seed: int = 0,
    n_profiles: int = 8,
    mean_lifetime_s: float = 900.0,
    min_lifetime_s: float = 60.0,
    lifetime_sigma: float = 1.0,
    churn: float = 1.0,
    phase_changes_per_lifetime: float = 0.5,
    priority_classes: Sequence[float] = (1.0, 1.5, 2.0),
) -> SyntheticTrace:
    """Generate an Alibaba-style tenant churn trace.

    ``churn`` scales the arrival rate relative to the Little's-law
    replacement rate: 1.0 keeps concurrency roughly flat at ``n_tenants``;
    0 disables arrivals entirely (the founding cohort only ages out).
    ``phase_changes_per_lifetime`` is the expected number of mid-life
    blend switches per tenant.  Draw order is fixed, so a seed pins the
    entire event sequence (golden-tested via :func:`trace_fingerprint`).
    """
    if not job_names:
        raise ValueError("job_names must not be empty")
    if n_tenants < 1:
        raise ValueError("n_tenants must be >= 1")
    if n_profiles < 2:
        raise ValueError("n_profiles must be >= 2 (phase changes switch "
                         "to a different profile)")
    rng = np.random.default_rng(seed)

    profiles = tuple(
        {j: float(w) for j, w in
         zip(job_names, rng.dirichlet(np.ones(len(job_names)) * 2.0))}
        for _ in range(n_profiles))

    # lognormal with the requested mean: mean = exp(mu + sigma^2/2)
    mu = float(np.log(mean_lifetime_s)) - 0.5 * lifetime_sigma ** 2

    def draw_lifetime() -> float:
        return max(float(rng.lognormal(mu, lifetime_sigma)),
                   float(min_lifetime_s))

    events: list[TraceEvent] = []
    tid = 0

    def admit(t_arrive: float) -> None:
        nonlocal tid
        name = f"job-{tid:05d}"
        tid += 1
        prof = int(rng.integers(n_profiles))
        prio = float(priority_classes[int(rng.integers(
            len(priority_classes)))])
        events.append(TraceEvent(t_arrive, "arrive", name, prof, prio))
        life = draw_lifetime()
        t_depart = t_arrive + life
        if t_depart <= horizon_s:
            events.append(TraceEvent(t_depart, "depart", name))
        # phase changes: Poisson count over the (in-horizon) lifetime,
        # uniform times, each switching to a DIFFERENT profile
        span = min(t_depart, horizon_s) - t_arrive
        k = int(rng.poisson(phase_changes_per_lifetime))
        if k > 0 and span > 0:
            times = np.sort(rng.uniform(0.0, span, k))
            cur = prof
            for dt in times:
                nxt = int(rng.integers(n_profiles - 1))
                if nxt >= cur:
                    nxt += 1          # uniform over the OTHER profiles
                events.append(TraceEvent(
                    float(t_arrive + dt), "phase", name, nxt, prio))
                cur = nxt

    for _ in range(n_tenants):        # founding cohort
        admit(0.0)

    if churn > 0:
        rate = churn * n_tenants / float(mean_lifetime_s)
        t = 0.0
        while True:
            t += float(rng.exponential(1.0 / rate))
            if t >= horizon_s:
                break
            admit(t)

    events.sort(key=TraceEvent.sort_key)
    return SyntheticTrace(
        events=tuple(events), profiles=profiles,
        priorities=tuple(float(p) for p in priority_classes),
        horizon_s=float(horizon_s), seed=int(seed))


def trace_fingerprint(trace: SyntheticTrace) -> dict[str, Any]:
    """A compact, stable digest of a trace: event counts, concurrency
    extremes, and a CRC over the canonical event sequence (times rounded
    to microseconds so the digest is reproducible across platforms).
    The golden test pins this against a checked-in copy, which catches
    silent distribution drift in the generator (a reordered draw, a
    changed default) without storing megabytes of events."""
    canon = "\n".join(
        f"{e.kind}:{e.tenant}:{e.t:.6f}:{e.profile}:{e.priority:.3f}"
        for e in trace.events)
    return {
        **trace.stats(),
        "seed": trace.seed,
        "crc32": zlib.crc32(canon.encode()),
        "profile_crc32": zlib.crc32(
            "\n".join(
                ",".join(f"{k}={v:.9f}" for k, v in sorted(p.items()))
                for p in trace.profiles).encode()),
    }


def replay_ticks(
    trace: SyntheticTrace,
    control_period_s: float = 30.0,
) -> Iterator[tuple[float, list[TraceEvent]]]:
    """Group a trace into event-driven control ticks.

    Yields ``(t, events)`` pairs where each tick advances event-time to
    the next event at least ``control_period_s`` after the previous tick
    — when events are dense, ticks fire at the control cadence with all
    intervening events batched; when the trace goes quiet, the clock
    JUMPS to the next event instead of spinning idle rounds (the
    event-driven advance that replaces the fixed round grid).  A final
    tick at the horizon flushes any trailing quiet period.
    """
    if control_period_s <= 0:
        raise ValueError("control_period_s must be > 0")
    events = list(trace.events)
    i = 0
    t = 0.0
    n = len(events)
    while i < n:
        # batch everything due by the end of this control period...
        t_due = t + control_period_s
        j = i
        while j < n and events[j].t <= t_due:
            j += 1
        if j == i:
            # ...or jump straight to the next event (quiet gap)
            t_due = events[i].t
            while j < n and events[j].t <= t_due:
                j += 1
        yield (min(t_due, trace.horizon_s), events[i:j])
        t = t_due
        i = j
    if t < trace.horizon_s:
        yield (trace.horizon_s, [])


__all__ = [
    "SyntheticTrace",
    "TraceEvent",
    "replay_ticks",
    "synthetic_trace",
    "trace_fingerprint",
]
