"""Annealing objectives.

Paper sec. 3:  ``Y_n = t_n + lambda * c_n`` where ``t_n`` is the execution
time of job n under the current configuration and ``c_n`` its cost; the user
parameter ``lambda > 0`` weighs cost against time.  Blended workloads use
``Y = sum_i alpha_i * Y_i`` with priorities ``alpha_i > 0`` summing to one.

Extensions implemented here (flagged; all default off so the faithful paper
objective is the baseline):

* SLO penalty: hinge penalty when t exceeds an SLO deadline (the paper's
  motivation mentions "minimize cost subject to performance requirements").
* Sojourn time: for jobs executed in parallel with queueing (paper
  sec. 4.2.2) ``t`` is the sojourn (queue + service) time; the measurement
  plumbing lives in :mod:`repro_torch.workloads.simulator` — the objective is
  unchanged, as the paper notes.
* Migration cost: reconfiguration (autoscaling) expense when the annealing
  move changes the cluster (spin-up + checkpoint restore), amortized into
  the job objective.  The paper lists "consideration of autoscaling costs"
  as part of the goal (sec. 3).
"""

from __future__ import annotations

import dataclasses
from typing import Mapping, Sequence


@dataclasses.dataclass(frozen=True)
class Measurement:
    """What the evaluator observed for one job under one configuration."""

    exec_time_s: float          # execution (or sojourn) time, seconds
    cost_usd: float             # dollars actually spent on the job
    migration_s: float = 0.0    # reconfiguration time incurred before the job
    migration_usd: float = 0.0  # reconfiguration spend
    slo_violated: bool = False


@dataclasses.dataclass(frozen=True)
class Objective:
    """The paper's macroscopic objective Y = t + lambda * c (+ options)."""

    lambda_cost: float = 1.0
    slo_s: float | None = None       # deadline; None disables the penalty
    slo_penalty: float = 0.0         # added per second of violation
    include_migration: bool = False  # amortize reconfiguration into Y

    def __post_init__(self) -> None:
        if self.lambda_cost < 0:
            raise ValueError("lambda_cost must be >= 0")

    def __call__(self, m: Measurement) -> float:
        t = m.exec_time_s
        c = m.cost_usd
        if self.include_migration:
            t += m.migration_s
            c += m.migration_usd
        y = t + self.lambda_cost * c
        # the deadline tests the same t that enters Y: with migration
        # folded in, a reconfiguration that blows the deadline must be
        # penalized even when the bare execution time would have met it
        if self.slo_s is not None and t > self.slo_s:
            y += self.slo_penalty * (t - self.slo_s)
        return float(y)


@dataclasses.dataclass(frozen=True)
class PenalizedObjective:
    """Coupling wrapper: ``Y'(m) = base(m) + weight * violation``.

    The violation is *exogenous* to the measurement — for the multi-tenant
    FleetController it is the aggregate capacity/budget overshoot a tenant's
    candidate configuration would cause given the other tenants' incumbents.
    Folding it into the objective (rather than clamping configurations after
    the fact) keeps the arbitration pressure inside the annealing acceptance
    rule, which is what prevents the per-service oscillation AutoTune-style
    tuners exhibit under shared budgets.

    Drop-in where an :class:`Objective` is expected: with the default
    ``violation=0`` it reduces exactly to the base objective.
    :meth:`penalize` is the array-friendly form used to build whole penalty
    tables (numpy or JAX).
    """

    base: Objective = dataclasses.field(default_factory=Objective)
    weight: float = 1.0

    def __post_init__(self) -> None:
        if self.weight < 0:
            raise ValueError("penalty weight must be >= 0")

    def __call__(self, m: Measurement, violation: float = 0.0) -> float:
        return float(self.base(m) + self.weight * violation)

    def penalize(self, y, violation):
        """``y + weight * violation`` elementwise (array friendly)."""
        return y + self.weight * violation


@dataclasses.dataclass(frozen=True)
class BlendedObjective:
    """Y = sum_i alpha_i Y_i over N workload types (paper sec. 3).

    ``alphas`` are normalized at construction; they may be *re-weighted* at
    runtime (the paper: "may change dynamically as the workloads experience
    variations over time") via :meth:`reweighted`.
    """

    objectives: tuple[Objective, ...]
    alphas: tuple[float, ...]

    def __post_init__(self) -> None:
        if len(self.objectives) != len(self.alphas):
            raise ValueError("objectives/alphas length mismatch")
        if any(a <= 0 for a in self.alphas):
            raise ValueError("alphas must be positive")
        s = sum(self.alphas)
        object.__setattr__(self, "alphas", tuple(a / s for a in self.alphas))

    def __call__(self, ms: Sequence[Measurement]) -> float:
        if len(ms) != len(self.objectives):
            raise ValueError("one Measurement per workload type required")
        return float(
            sum(a * obj(m) for a, obj, m in zip(self.alphas, self.objectives, ms))
        )

    def reweighted(self, alphas: Sequence[float]) -> "BlendedObjective":
        return BlendedObjective(self.objectives, tuple(alphas))


def blend_from_weights(
    weights: Mapping[str, float], lambda_cost: float = 1.0
) -> BlendedObjective:
    """Convenience: identical per-type objectives with given blend weights."""
    names = tuple(weights)
    return BlendedObjective(
        tuple(Objective(lambda_cost=lambda_cost) for _ in names),
        tuple(weights[n] for n in names),
    )
