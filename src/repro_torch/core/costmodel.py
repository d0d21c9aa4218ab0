"""Evaluators: configuration -> (execution time, cost) -> objective.

The paper's evaluator is "run the next job under the proposed configuration
and measure".  Three evaluators implement that contract at different cost:

* :class:`SimulatedEvaluator` — calibrated execution-time models (the
  landscapes of :mod:`repro_torch.core.landscape`); reproduces the paper's
  figures and drives fast tests.

* :class:`MeasuredEvaluator` — wraps a callable that *actually executes*
  the job (e.g. a jitted ``train_step`` for k steps) and times it.  Used by
  the DNN-annealing reproduction (paper sec. 4.4) on real JAX models.

* :class:`RooflineEvaluator` — beyond-paper: estimates step time from the
  three-term roofline of a compiled dry-run artifact (or an analytic model
  of the same terms), letting the annealer search mesh/microbatch/remat
  spaces without spending cluster time.  The terms mirror
  :mod:`repro.tools.roofline`.

All return :class:`repro_torch.core.objective.Measurement`; composing with an
:class:`Objective` yields the scalar Y the chain needs.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Mapping, Sequence

import numpy as np

from .landscape import HIBENCH_JOBS, JobModel
from .objective import Measurement, Objective
from .pricing import (
    V5E_HBM_BW,
    V5E_ICI_BW,
    V5E_PEAK_FLOPS_BF16,
    ServiceCatalog,
)
from .state import ClusterConfig


class Evaluator:
    """Maps (config, job_name, job_index) -> Measurement."""

    #: True for evaluators whose :meth:`measure` spends *wall-clock* time
    #: (really executes jobs).  The evaluation runtime
    #: (:mod:`repro_torch.core.evalpipe`) overlaps these with a bounded worker
    #: pool; simulated/tabulated evaluators instead get ONE vectorized
    #: :meth:`measure_many` call.  Wall-clock evaluators must therefore
    #: tolerate concurrent :meth:`measure` calls.
    wall_clock: bool = False

    def measure(
        self, config: ClusterConfig, job: str, n: int
    ) -> Measurement:
        raise NotImplementedError

    def measure_many(
        self,
        requests: "Sequence[tuple[Mapping[str, Any], str, int]]",
    ) -> "list[Measurement]":
        """Measure a batch of ``(decoded_config, job, n)`` requests.

        The asynchronous seam of the evaluation runtime: the default is a
        synchronous loop over :meth:`measure_decoded` (exactly the
        historical per-item behavior, in request order), so every evaluator
        supports batching; vectorizable evaluators may override with one
        batched call.  Wall-clock evaluators normally never see this —
        :class:`repro_torch.core.evalpipe.EvalDispatcher` fans their requests out
        over a thread pool instead.
        """
        return [self.measure_decoded(d, job, n) for d, job, n in requests]

    def measure_decoded(
        self, decoded: Mapping[str, Any], job: str, n: int,
        config: ClusterConfig | None = None,
    ) -> Measurement:
        """Measure from the decoded ConfigSpace mapping.

        The default derives a :class:`ClusterConfig` (or takes the one
        the caller already built) and defers to :meth:`measure`.
        Evaluators whose objective depends on axes a ClusterConfig
        cannot carry — per-tier container sizings
        (:class:`repro_torch.core.sizing.MicroserviceEvaluator`) — override
        this; the FleetController routes every measurement through it.
        """
        from .state import cluster_config_from

        if config is None:
            config = cluster_config_from(decoded)
        return self.measure(config, job, n)

    def migration(
        self, old: ClusterConfig | None, new: ClusterConfig,
        catalog: ServiceCatalog,
    ) -> tuple[float, float]:
        """(seconds, dollars) to move the cluster old -> new.

        Zero when the configuration is unchanged; otherwise the new
        family's spin-up latency billed at the new configuration's rate.
        """
        if old == new:
            return 0.0, 0.0
        fam = catalog[new.instance_type]
        secs = fam.spin_up_s
        usd = catalog.cost(new.instance_type, new.total_cores, secs)
        return secs, usd


@dataclasses.dataclass
class SimulatedEvaluator(Evaluator):
    """Execution times from parametric job models (paper Figs. 6-11)."""

    catalog: ServiceCatalog
    jobs: Mapping[str, JobModel] = dataclasses.field(
        default_factory=lambda: dict(HIBENCH_JOBS))
    noise_std: float = 0.0        # multiplicative run-to-run noise
    seed: int = 0

    def __post_init__(self) -> None:
        self._rng = np.random.default_rng(self.seed)
        # noise-free measurements by (job, family, cores), with the job
        # model and catalog they came from: a fleet measures one job a
        # tenant a round, mostly on a few states
        self._memo: dict[tuple, tuple] = {}

    def measure(self, config: ClusterConfig, job: str, n: int) -> Measurement:
        model = self.jobs[job]
        if self.noise_std <= 0:
            key = (job, config.instance_type, config.total_cores)
            hit = self._memo.get(key)
            if hit is not None and hit[0] is model \
                    and hit[1] is self.catalog:
                return hit[2]
        t = model.exec_time(
            config.instance_type, config.total_cores, self.catalog)
        if self.noise_std > 0:
            t *= float(np.exp(self._rng.normal(0.0, self.noise_std)))
        c = self.catalog.cost(config.instance_type, config.total_cores, t)
        m = Measurement(exec_time_s=t, cost_usd=c)
        if self.noise_std <= 0:
            self._memo[key] = (model, self.catalog, m)
        return m


@dataclasses.dataclass
class MeasuredEvaluator(Evaluator):
    """Times a real job execution — the paper's own operating mode.

    ``runner(config, job, n) -> None`` must execute the job synchronously
    (e.g. call a jitted train_step ``k`` times and block on the result).

    ``wall_clock`` marks it for the evaluation runtime's worker pool: when
    the speculative pipeline dispatches several measurements concurrently,
    ``runner`` may be called from multiple threads — runners that cannot
    tolerate that should be driven with ``eval_workers=1``.
    """

    wall_clock = True

    catalog: ServiceCatalog
    runner: Callable[[ClusterConfig, str, int], Any]
    warmup: int = 1

    def measure(self, config: ClusterConfig, job: str, n: int) -> Measurement:
        for _ in range(self.warmup):
            self.runner(config, job, n)
        t0 = time.perf_counter()
        self.runner(config, job, n)
        t = time.perf_counter() - t0
        c = self.catalog.cost(config.instance_type, config.total_cores, t)
        return Measurement(exec_time_s=t, cost_usd=c)


@dataclasses.dataclass(frozen=True)
class StepCosts:
    """Per-step roofline inputs for one (model, shape) workload, either from
    a compiled dry-run (tools/roofline.py) or an analytic estimate.

    All quantities are *totals for the whole step across the job*, i.e. the
    global FLOPs / HBM bytes / per-hop collective bytes at parallel degree 1.
    """

    flops: float               # global FLOPs per step
    hbm_bytes: float           # global HBM traffic per step
    collective_bytes: float    # bytes crossing links per step (at dp=1 ref)
    steps_per_job: int = 1


@dataclasses.dataclass
class RooflineEvaluator(Evaluator):
    """Step-time estimate = max(compute, memory, collective) terms.

    compute    = flops / (chips * peak)
    memory     = hbm_bytes / (chips * hbm_bw)
    collective = collective_bytes(dp, tp) / (chips * link_bw)

    Collective traffic scales with the layout: gradient all-reduce bytes
    grow with dp as 2(dp-1)/dp per ring; tensor-parallel activation
    collectives grow with tp.  ``workloads`` maps job name -> StepCosts.
    Efficiency (<=1) models achievable fraction of peak.
    """

    catalog: ServiceCatalog
    workloads: Mapping[str, StepCosts]
    peak_flops: float = V5E_PEAK_FLOPS_BF16
    hbm_bw: float = V5E_HBM_BW
    link_bw: float = V5E_ICI_BW
    efficiency: float = 0.55
    grad_bytes: Mapping[str, float] | None = None  # model grad bytes per job

    def step_time(self, config: ClusterConfig, job: str) -> float:
        w = self.workloads[job]
        chips = max(config.n_workers, 1)
        dp = max(config.dp_degree, 1)
        tp = max(config.tp_degree, 1)
        compute = w.flops / (chips * self.peak_flops * self.efficiency)
        memory = w.hbm_bytes / (chips * self.hbm_bw)
        coll = w.collective_bytes
        if self.grad_bytes:
            g = self.grad_bytes.get(job, 0.0)
            comp = {"int8": 0.25, "none": 1.0}.get(config.compression, 1.0)
            coll = coll + comp * g * 2.0 * (dp - 1) / dp
        coll_t = coll / (chips * self.link_bw)
        # remat trades memory for recompute: ~1/3 extra forward compute
        if config.remat == "full":
            compute *= 4.0 / 3.0
        elif config.remat == "block":
            compute *= 7.0 / 6.0
        # microbatching amortizes but adds per-microbatch launch overhead
        compute *= 1.0 + 0.01 * max(config.microbatches - 1, 0)
        return max(compute, memory, coll_t) + 0.3 * min(
            sorted([compute, memory, coll_t])[1], compute)

    def measure(self, config: ClusterConfig, job: str, n: int) -> Measurement:
        w = self.workloads[job]
        t = self.step_time(config, job) * w.steps_per_job
        c = self.catalog.cost(config.instance_type, config.total_cores, t)
        return Measurement(exec_time_s=t, cost_usd=c)


def objective_of(
    evaluator: Evaluator, objective: Objective, catalog: ServiceCatalog,
    job: str = "job",
) -> Callable[[dict[str, Any], int], float]:
    """Adapt an Evaluator to the Annealer's evaluate(decoded_cfg, n) shape,
    tracking the previous config to bill migrations."""
    from .state import cluster_config_from

    prev: list[ClusterConfig | None] = [None]

    def evaluate(decoded: dict[str, Any], n: int) -> float:
        cfg = cluster_config_from(decoded)
        mig_s, mig_usd = evaluator.migration(prev[0], cfg, catalog)
        m = evaluator.measure(cfg, decoded.get("job", job), n)
        m = Measurement(
            exec_time_s=m.exec_time_s, cost_usd=m.cost_usd,
            migration_s=mig_s, migration_usd=mig_usd,
            slo_violated=m.slo_violated,
        )
        prev[0] = cfg
        return objective(m)

    return evaluate
