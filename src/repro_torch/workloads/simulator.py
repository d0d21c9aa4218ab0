"""Job streams, blends, arrival processes and the sojourn-time queue.

A numpy copy of the reference package's ``workloads/simulator.py``,
pinned bit for bit by ``tests/test_torch_numpy_copies.py``.

Paper constructs reproduced here:
  * a *job stream* of blended types (sec. 3): each arriving job is drawn
    from the blend distribution alpha (which may change mid-stream,
    sec. 4.3);
  * *jobs executed in parallel* with a queue (sec. 4.2.2): a single-server
    (cluster) queue where the objective measures sojourn = wait + service
    time instead of bare execution time;
  * a *multi-tenant* multiplexer (:class:`MultiTenantStream`): T per-tenant
    blended streams with staggered change points, one job per tenant per
    control round — the workload side of the FleetController.
"""

from __future__ import annotations

import dataclasses
import heapq
from typing import Callable, Iterator, Mapping, Sequence

import numpy as np


@dataclasses.dataclass(frozen=True)
class Arrival:
    n: int
    job: str
    t: float            # arrival time (seconds)


class JobStream:
    """Deterministic stream of blended job types (paper sec. 3)."""

    def __init__(self, blend: Mapping[str, float], seed: int = 0):
        self._rng = np.random.default_rng(seed)
        self.set_blend(blend)
        self.n = 0

    def set_blend(self, blend: Mapping[str, float]) -> None:
        names = list(blend)
        w = np.asarray([blend[k] for k in names], np.float64)
        self._names, self._w = names, w / w.sum()

    def __iter__(self) -> Iterator[str]:
        return self

    def __next__(self) -> str:
        job = self._names[int(self._rng.choice(len(self._names),
                                               p=self._w))]
        self.n += 1
        return job


def blended_stream(blend_before: Mapping[str, float],
                   blend_after: Mapping[str, float],
                   change_at: int, n_jobs: int, seed: int = 0
                   ) -> list[str]:
    """The sec. 4.3 experiment stream: blend changes at job `change_at`."""
    s = JobStream(blend_before, seed)
    out = []
    for i in range(n_jobs):
        if i == change_at:
            s.set_blend(blend_after)
        out.append(next(s))
    return out


@dataclasses.dataclass(frozen=True)
class TenantWorkload:
    """One tenant's workload: a blend, optionally switching to
    ``blend_after`` at draw index ``change_at`` (the draw with that index
    is the first from the new blend).  Change points are per-tenant, so a
    fleet's tenants drift at *staggered* times (paper sec. 4.3 per tenant).
    """

    name: str
    blend: Mapping[str, float]
    blend_after: Mapping[str, float] | None = None
    change_at: int | None = None

    def __post_init__(self) -> None:
        if (self.blend_after is None) != (self.change_at is None):
            raise ValueError(
                f"tenant {self.name!r}: blend_after and change_at must be "
                f"given together")


class MultiTenantStream:
    """Per-tenant :class:`JobStream` multiplexer for fleet control rounds.

    ``next(stream)`` draws ONE job per tenant (a control round) and applies
    any change points that fire at that round.  Per-tenant streams are
    independently seeded, so one tenant's draws do not perturb another's —
    adding a tenant never changes the others' job sequences.
    """

    def __init__(self, tenants: Sequence[TenantWorkload], seed: int = 0):
        names = [t.name for t in tenants]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate tenant names: {names}")
        if not tenants:
            raise ValueError("at least one tenant required")
        self.tenants = tuple(tenants)
        self._seed = seed
        self._next_offset = len(tenants)   # never reused, even after churn
        self._streams = {
            t.name: JobStream(t.blend, seed=seed + i)
            for i, t in enumerate(tenants)
        }
        self._blends = {t.name: dict(t.blend) for t in tenants}
        self.round = 0

    def add_tenant(self, tenant: TenantWorkload) -> None:
        """Admit a tenant mid-run.  Its stream gets a never-before-used
        seed offset, so arrivals and departures leave every other tenant's
        job sequence untouched.  ``change_at`` counts *global* rounds (the
        shared control clock), not rounds since arrival."""
        if tenant.name in self._streams:
            raise ValueError(f"duplicate tenant name: {tenant.name!r}")
        self.tenants = self.tenants + (tenant,)
        self._streams[tenant.name] = JobStream(
            tenant.blend, seed=self._seed + self._next_offset)
        self._next_offset += 1
        self._blends[tenant.name] = dict(tenant.blend)

    def remove_tenant(self, name: str) -> None:
        """Retire tenant ``name``; the other streams are unaffected."""
        if name not in self._streams:
            raise KeyError(f"unknown tenant {name!r}")
        if len(self.tenants) == 1:
            raise ValueError("at least one tenant required")
        self.tenants = tuple(t for t in self.tenants if t.name != name)
        del self._streams[name]
        del self._blends[name]

    def set_blend(self, name: str, blend: Mapping[str, float]) -> None:
        """Retune a live tenant's blend mid-run (a trace *phase-change*
        event).  The tenant's RNG stream continues — only the draw
        distribution switches, exactly like a declared ``change_at``
        firing — and any still-pending declared change point is cleared
        (the phase event supersedes it)."""
        if name not in self._streams:
            raise KeyError(f"unknown tenant {name!r}")
        self._blends[name] = dict(blend)
        self._streams[name].set_blend(blend)
        self.tenants = tuple(
            dataclasses.replace(t, blend=dict(blend), blend_after=None,
                                change_at=None)
            if t.name == name else t
            for t in self.tenants)

    @property
    def tenant_names(self) -> tuple[str, ...]:
        return tuple(t.name for t in self.tenants)

    def blend_of(self, name: str) -> dict[str, float]:
        """The blend tenant ``name`` draws from at the CURRENT round."""
        self._apply_changes()
        return dict(self._blends[name])

    def _apply_changes(self) -> None:
        for t in self.tenants:
            if t.change_at is not None and self.round >= t.change_at:
                if self._blends[t.name] != dict(t.blend_after):
                    self._blends[t.name] = dict(t.blend_after)
                    self._streams[t.name].set_blend(t.blend_after)

    def __iter__(self) -> Iterator[dict[str, str]]:
        return self

    def __next__(self) -> dict[str, str]:
        self._apply_changes()
        jobs = {t.name: next(self._streams[t.name]) for t in self.tenants}
        self.round += 1
        return jobs


class PoissonArrivals:
    """Poisson arrival process over a JobStream."""

    def __init__(self, stream: JobStream, rate_per_s: float, seed: int = 0):
        self.stream = stream
        self.rate = float(rate_per_s)
        self._rng = np.random.default_rng(seed + 1)
        self._t = 0.0
        self._n = 0

    def __iter__(self) -> Iterator[Arrival]:
        return self

    def __next__(self) -> Arrival:
        self._t += float(self._rng.exponential(1.0 / self.rate))
        a = Arrival(n=self._n, job=next(self.stream), t=self._t)
        self._n += 1
        return a


@dataclasses.dataclass
class Completion:
    arrival: Arrival
    start_t: float
    finish_t: float

    @property
    def sojourn_s(self) -> float:
        return self.finish_t - self.arrival.t


class QueueSimulator:
    """Single-server FIFO queue over a service-time function.

    ``service_time(job_name) -> seconds`` is evaluated under the *current*
    cluster configuration (the annealer changes it between jobs); the
    measured objective input is the sojourn time (paper sec. 4.2.2).
    """

    def __init__(self, service_time: Callable[[str], float]):
        self.service_time = service_time

    def run(self, arrivals: list[Arrival]) -> list[Completion]:
        completions = []
        free_at = 0.0
        for a in sorted(arrivals, key=lambda a: a.t):
            start = max(a.t, free_at)
            finish = start + float(self.service_time(a.job))
            free_at = finish
            completions.append(Completion(a, start, finish))
        return completions

    def mean_sojourn(self, arrivals: list[Arrival]) -> float:
        cs = self.run(arrivals)
        return float(np.mean([c.sojourn_s for c in cs])) if cs else 0.0
