"""The annealing chain.

Heat-bath acceptance (paper sec. 2.2/3):  a proposal ``z`` from ``nu(x)`` is
accepted with probability

    exp(-max{Y(z) - Y(x), 0} / tau)

i.e. always accepted when the objective does not increase.  Two engines:

* :class:`Annealer` — the *online* engine used by the controllers: one
  proposal per arriving job, objective evaluated by running (or
  simulating) the job under the proposed configuration.  This is the
  paper's operating mode: evaluation *is* execution.  numpy, a copy of the
  reference's.

* :func:`anneal_fleet` — the batched chain over a precomputed objective
  table on a full N-dimensional :class:`ConfigSpace` (mixed
  ordinal/categorical axes, validity masks, time-indexed tables, array
  temperature schedules with reheats): C chains walk every step in one
  :func:`repro_torch.kernels.ops.anneal_walk` call (a hand kernel on the
  card, its plain torch version on the CPU).  Its random draws come from
  an explicit :class:`torch.Generator`, or are handed in whole through
  ``draws=`` (the tests replay another engine's draws so the walks can be
  compared step for step).  :func:`anneal_chain`,
  :func:`anneal_chain_dynamic` and :func:`anneal_chain_nd` are its
  one-chain forms, :func:`fleet_chains` its bucket-padded per-tenant form,
  and :func:`jobs_to_min_vs_tau` / :func:`jobs_to_min_vs_tau_fleet` the
  paper's Fig. 4 / Fig. 10 sweeps over it.
"""

from __future__ import annotations

import copy
import dataclasses
import math
from typing import Any, Callable, Mapping, Sequence

import numpy as np
import torch

from ..device import resolve_device
from ..kernels import ops
from .neighborhood import Neighborhood, row_major_strides
from .schedules import FixedTemperature, Schedule
from .state import ConfigSpace, EncodedSpace, random_valid_state
from .tabu import TabuMemory


def acceptance_probability(dy: float, tau: float) -> float:
    """Heat-bath rule: exp(-max(dy, 0)/tau)."""
    if tau <= 0:
        return 1.0 if dy <= 0 else 0.0
    return math.exp(-max(dy, 0.0) / tau)


@dataclasses.dataclass
class Step:
    """Record of one annealing transition (one job)."""

    n: int
    proposed: tuple[int, ...]
    accepted: bool
    explored: bool            # True if proposal increased Y but was accepted
    y_proposed: float
    y_current: float          # Y of the incumbent *after* the step
    tau: float
    state: tuple[int, ...]    # incumbent after the step


@dataclasses.dataclass
class ChainSnapshot:
    """Replayable checkpoint of an online :class:`Annealer` at a transition
    index: the incumbent, its stored (possibly unmeasured) objective, and
    the full bit-generator state.  Restoring one rewinds the *walk* — the
    speculative evaluation pipeline (:mod:`repro_torch.core.evalpipe`)
    runs the chain ahead of landed measurements and rolls back to the last
    resolved transition on a misprediction, which is what keeps a
    pipelined run's realized RNG stream identical to the serial loop's."""

    n: int
    state: tuple[int, ...]
    y: float | None
    rng_state: dict[str, Any]


class Annealer:
    """Online simulated annealing over a ConfigSpace.

    ``evaluate`` maps a *decoded* configuration (and the job index) to the
    objective value Y_n — in production this runs the job.  Note the paper's
    subtlety: Y_{n-1} was measured for the *previous* job; under workload
    drift the incumbent's objective is stale, which is precisely what allows
    the chain to adapt after a change (the next evaluation of the incumbent
    refreshes it).  We follow the paper: compare Y_n(z_n) against the stored
    Y of the incumbent, refreshing the incumbent's Y whenever the incumbent
    is re-evaluated (rejected proposals do not refresh it).
    """

    def __init__(
        self,
        space: ConfigSpace,
        neighborhood: Neighborhood,
        evaluate: Callable[[dict[str, Any], int], float],
        schedule: Schedule | float = 1.0,
        seed: int | np.random.Generator = 0,
        init: tuple[int, ...] | None = None,
        tabu: TabuMemory | None = None,
    ):
        self.space = space
        self.nbhd = neighborhood
        self.evaluate = evaluate
        self.schedule = (
            FixedTemperature(schedule) if isinstance(schedule, (int, float))
            else schedule
        )
        self.rng = (
            seed if isinstance(seed, np.random.Generator)
            else np.random.default_rng(seed)
        )
        self.tabu = tabu
        if init is None:
            init = self._random_valid_state()
        if not space.contains(init):
            raise ValueError(f"initial state {init} not in the valid region")
        self.state: tuple[int, ...] = tuple(init)
        self.y: float | None = None   # incumbent objective (lazily measured)
        self.n = 0
        self.history: list[Step] = []
        # every measurement taken, incumbent refreshes included — proposals
        # alone under-report `best()` when the initial state is never beaten
        self.evaluations: list[tuple[tuple[int, ...], float]] = []

    # -- paper sec. 3: "Starting with a random configuration for x_0" --
    def _random_valid_state(self, tries: int = 10_000) -> tuple[int, ...]:
        return random_valid_state(self.space, self.rng, tries)

    def reheat(self) -> None:
        """Signal a workload/offering change: raise the temperature AND
        invalidate the incumbent's stored objective — it was measured on
        the pre-change workload, and without a refresh a now-false low Y
        can pin the chain to the stale optimum forever (the comparison
        would reject every honestly-measured proposal)."""
        self.schedule.reheat(self.n)
        self.y = None

    # -- snapshot / replay (speculative pipelining support) --
    def snapshot(self) -> ChainSnapshot:
        """Checkpoint the walk at the current transition index.  History and
        past measurements are not part of the snapshot — they record what
        really ran and survive a :meth:`restore`."""
        return ChainSnapshot(
            n=self.n, state=tuple(self.state), y=self.y,
            rng_state=copy.deepcopy(self.rng.bit_generator.state))

    def restore(self, snap: ChainSnapshot) -> None:
        """Rewind the walk (incumbent, stored objective, RNG) to ``snap``.
        ``history`` and ``evaluations`` are left intact: measurements taken
        past the snapshot were real evaluator runs and stay counted."""
        self.state = tuple(snap.state)
        self.y = snap.y
        self.n = snap.n
        self.rng.bit_generator.state = copy.deepcopy(snap.rng_state)

    def draw_transition(
        self,
        propose_hook: Callable[[tuple[int, ...]], Any] | None = None,
        state: Sequence[int] | None = None,
    ) -> tuple[tuple[int, ...], float, Any]:
        """Draw the next (proposal, acceptance uniform) pair in exactly the
        RNG order of :meth:`step`.  ``propose_hook`` runs between the
        proposal draw and the uniform draw — the slot where :meth:`step`'s
        evaluation sits, so a caller whose evaluation consumes this RNG
        (e.g. the procurement controller's blend-draw) keeps a pipelined
        run's stream identical to the serial loop's.  ``state`` overrides
        the incumbent the proposal is drawn around (the speculative
        pipeline proposes from its lookahead frontier, not the committed
        incumbent).  Returns ``(proposal, u, hook_result)``."""
        x = tuple(self.state if state is None else state)
        proposal = self.nbhd.propose(x, self.rng)
        if self.tabu is not None:
            proposal = self.tabu.filter(
                x, proposal,
                lambda: self.nbhd.propose(x, self.rng),
            )
        hooked = propose_hook(proposal) if propose_hook is not None else None
        u = float(self.rng.random())
        return proposal, u, hooked

    def record_evaluation(self, state: Sequence[int], y: float) -> None:
        """Count one real measurement.  The speculative pipeline records
        every landed measurement through here exactly once — resolved
        transitions AND mis-speculated (discarded) proposals, which were
        still real evaluator runs and still inform :meth:`best`."""
        self.evaluations.append((tuple(int(i) for i in state), float(y)))

    def apply_transition(
        self, proposal: tuple[int, ...], u: float, y_new: float,
        *, n: int, tau: float,
    ) -> Step:
        """Commit one transition given a landed measurement ``y_new`` and
        the acceptance uniform ``u`` drawn by :meth:`draw_transition`.
        Shared by the inline :meth:`step` and the speculative pipeline, so
        both resolve acceptance with identical semantics."""
        dy = y_new - self.y
        p = acceptance_probability(dy, tau)
        accepted = bool(u < p)
        explored = accepted and dy > 0

        if accepted:
            self.state, self.y = proposal, y_new
        if self.tabu is not None:
            self.tabu.visit(proposal, y_new)

        rec = Step(
            n=n, proposed=proposal, accepted=accepted, explored=explored,
            y_proposed=y_new, y_current=self.y, tau=tau, state=self.state,
        )
        self.history.append(rec)
        self.n += 1
        return rec

    def step(self, job: int | None = None) -> Step:
        """Process one arriving job: propose, evaluate, accept/reject."""
        n = self.n if job is None else job
        tau = self.schedule(n)

        if self.y is None:  # first job, or incumbent invalidated (reheat):
            # this job runs under the incumbent to refresh its objective
            self.y = float(self.evaluate(self.space.decode(self.state), n))
            self.record_evaluation(self.state, self.y)

        proposal, u, y_new = self.draw_transition(
            lambda z: float(self.evaluate(self.space.decode(z), n)))
        self.record_evaluation(proposal, y_new)
        return self.apply_transition(proposal, u, y_new, n=n, tau=tau)

    def run(self, n_jobs: int) -> list[Step]:
        return [self.step() for _ in range(n_jobs)]

    # -- diagnostics used by the paper's figures --
    @property
    def measure_count(self) -> int:
        """Real objective evaluations taken so far (incumbent refreshes
        included) — the denominator of any measurement-savings claim."""
        return len(self.evaluations)

    def best(self) -> tuple[tuple[int, ...], float]:
        """Lowest measured objective over ALL evaluations — incumbent
        initial/refresh measurements included, not just proposals."""
        state, y = min(self.evaluations, key=lambda e: e[1])
        return state, y

    def exploration_rate(self) -> float:
        if not self.history:
            return 0.0
        return sum(s.explored for s in self.history) / len(self.history)


# ---------------------------------------------------------------------------
# N-dimensional batched engine: the chain fleet over full ConfigSpaces.
# ---------------------------------------------------------------------------


def _as_encoded(space: ConfigSpace | EncodedSpace) -> EncodedSpace:
    return space.encoded() if isinstance(space, ConfigSpace) else space


def _upload(a: np.ndarray, dev: torch.device) -> torch.Tensor:
    """A host array on ``dev`` without the host waiting on the card: the
    pageable copy is staged before ``.to`` returns."""
    return torch.from_numpy(np.ascontiguousarray(a)).to(dev,
                                                        non_blocking=True)


def random_valid_states(
    generator: torch.Generator | None,
    space: ConfigSpace | EncodedSpace,
    n: int,
    device: str | torch.device = "cuda",
    valid_flat: torch.Tensor | None = None,
) -> torch.Tensor:
    """(n, ndim) int32 index vectors uniform over the VALID region.

    ``valid_flat``: the valid states' flat indices (int64, ascending) on
    ``device``, for a caller that keeps them; else they are found from the
    space's mask and uploaded."""
    dev = resolve_device(device)
    enc = _as_encoded(space)
    if enc.valid_mask is None:
        u = torch.rand((n, enc.ndim), generator=generator, device=dev,
                       dtype=torch.float64)
        sizes = _upload(np.asarray(enc.shape, np.float64), dev)
        return (u * sizes).floor().to(torch.int32)
    if valid_flat is None:
        valid_flat = _upload(np.flatnonzero(enc.valid_mask.reshape(-1)), dev)
    if valid_flat.numel() == 0:
        raise ValueError("space has no valid states")
    picks = valid_flat[torch.randint(0, valid_flat.numel(), (n,),
                                     generator=generator, device=dev)]
    cols = []
    for stride in row_major_strides(enc.shape):
        cols.append(picks // stride)
        picks = picks % stride
    return torch.stack(cols, dim=-1).to(torch.int32)


#: Keys of the ``draws=`` dict of :func:`anneal_fleet`, each (C, n_steps):
#: the proposal axis, its direction (True is +1), the categorical pick in
#: ``[0, max(n - 1, 1))`` for the drawn axis, and the acceptance uniform.
#: ``"noise"`` (C, n_steps) and ``"noise0"`` (C,) are standard normals,
#: read only when ``noise_std > 0``.
DRAW_KEYS = ("axis", "up", "pick", "uniform")


def _draw(generator, enc: EncodedSpace, C: int, S: int, noise: bool,
          dev: torch.device) -> dict[str, torch.Tensor]:
    """All of one call's random draws, made up front on ``dev``."""
    axis = torch.randint(0, enc.ndim, (C, S), generator=generator,
                         device=dev)
    up = torch.rand((C, S), generator=generator, device=dev) < 0.5
    sizes = _upload(np.asarray(enc.shape, np.int64), dev)
    m = torch.clamp(sizes[axis] - 1, min=1)
    u_cat = torch.rand((C, S), generator=generator, device=dev,
                       dtype=torch.float64)
    pick = torch.minimum((u_cat * m).floor().to(torch.int64), m - 1)
    out = {"axis": axis, "up": up, "pick": pick,
           "uniform": torch.rand((C, S), generator=generator, device=dev)}
    if noise:
        out["noise0"] = torch.randn((C,), generator=generator, device=dev)
        out["noise"] = torch.randn((C, S), generator=generator, device=dev)
    return out


# ---------------------------------------------------------------------------
# Per-tenant draw streams: a counter-based hash of (seed, round, stream id,
# step), the counterpart of the reference's fold_in(fold_in(key, r), id).
# ---------------------------------------------------------------------------

_M32 = 0xFFFFFFFF
#: The hash's multipliers: odd and below 2^31, so a 32-bit word times one
#: stays below 2^63 and every int64 product is exact on any device.
_MUL = (0x7FEB352D, 0x21F0AAAD)
#: The words a step draws: proposal axis, direction, pick, acceptance.
_WORDS = 4


def _mix32_int(x: int) -> int:
    """:func:`_mix32` on a Python int: the per-call words, made on the host
    without a tensor op."""
    x &= _M32
    x ^= x >> 16
    x = (x * _MUL[0]) & _M32
    x ^= x >> 15
    x = (x * _MUL[1]) & _M32
    return x ^ (x >> 15)


def _mix32(x: torch.Tensor) -> torch.Tensor:
    """A bijective 32-bit mixer (xorshift-multiply rounds) on int64
    tensors holding 32-bit words."""
    x = x ^ (x >> 16)
    x = (x * _MUL[0]) & _M32
    x = x ^ (x >> 15)
    x = (x * _MUL[1]) & _M32
    return x ^ (x >> 15)


def tenant_draws(seed: int, round: int, stream_ids, enc, n_steps: int, *,
                 device: str | torch.device = "cuda"
                 ) -> dict[str, torch.Tensor]:
    """The walk's :data:`DRAW_KEYS` arrays, each (A, n_steps), for A
    chains at once: row ``a`` depends only on ``(seed, round,
    stream_ids[a], step)`` — not on A, on the row's place or on the other
    ids — so a tenant's walk is the same whoever else is in the fleet.

    Every word is a counter-based hash of those values in int64 tensor
    ops (32-bit words, products below 2^63), so the arrays are
    bit-identical on the CPU and on the card; a few dozen launches
    whatever A is.  From each step's four words: ``axis`` the high word
    of ``w * ndim``, ``up`` the top bit, ``pick`` the high word of ``w *
    max(n_axis - 1, 1)``, ``uniform`` the top 24 bits times 2^-24.
    ``stream_ids`` are ints in [0, 2^32) (array-like, or an int64 tensor
    on ``device``); ``seed`` is in [0, 2^64), ``round`` in [0, 2^32)."""
    dev = resolve_device(device)
    enc = _as_encoded(enc)
    S = int(n_steps)
    seed = int(seed)
    if not (0 <= seed < 1 << 64 and 0 <= int(round) < 1 << 32):
        raise ValueError(f"seed {seed} or round {round} out of range")
    base = 0x243F6A88
    for word in (seed & _M32, seed >> 32, int(round)):
        base = _mix32_int(base ^ word)
    ids = (stream_ids.to(device=dev, dtype=torch.int64)
           if isinstance(stream_ids, torch.Tensor)
           else torch.from_numpy(np.asarray(stream_ids, np.int64)
                                 .reshape(-1)).to(dev, non_blocking=True))
    key = _mix32(_mix32((ids & _M32) ^ base))             # (A,)
    ctr = _mix32(torch.arange(S * _WORDS, device=dev) * 0x9E3779B1 & _M32)
    w = _mix32(_mix32(key[:, None] ^ ctr[None, :])).reshape(-1, S, _WORDS)
    sizes = torch.from_numpy(np.maximum(np.asarray(enc.shape, np.int64) - 1,
                                        1)).to(dev, non_blocking=True)
    axis = (w[..., 0] * enc.ndim) >> 32
    return {"axis": axis,
            "up": (w[..., 1] >> 31).bool(),
            "pick": (w[..., 2] * sizes[axis]) >> 32,
            "uniform": (w[..., 3] >> 8).to(torch.float32) * 2.0 ** -24}


def anneal_fleet(
    generator: torch.Generator | None,
    space: ConfigSpace | EncodedSpace,
    y_table: torch.Tensor | np.ndarray,
    n_steps: int,
    taus: torch.Tensor | np.ndarray | Sequence[float] | float,
    inits: torch.Tensor | np.ndarray | None = None,
    n_chains: int | None = None,
    noise_std: float = 0.0,
    per_chain_tables: bool = False,
    extra_costs: torch.Tensor | np.ndarray | None = None,
    draws: Mapping[str, Any] | None = None,
    device: str | torch.device = "cuda",
) -> dict[str, torch.Tensor]:
    """A fleet of N-dim chains walked together on ``device`` (paper Figs.
    4/5/10 at scale: seeds x temperatures x tenants).

    ``y_table`` has shape ``space.shape`` (static landscape) or
    ``(n_steps,) + space.shape`` (time-indexed — workload drift; the
    incumbent's stored objective goes stale exactly as in the online
    :class:`Annealer`); with ``per_chain_tables`` it carries a leading (C,)
    axis — one table per chain.  ``taus``: scalar (shared), (C,) per-chain
    constants, or (C, n_steps) per-chain schedules (reheats baked in).
    ``inits``: None (uniform over the valid region) or (ndim,) / (C, ndim).
    Ordinal axes move +-1 (reflected); categorical axes resample
    uniformly; invalid states are rejection-masked.

    ``extra_costs``: optional per-chain additive cost rows, shape
    ``(C,) + space.shape`` or ``(C, size)`` — every measurement of chain c
    at state s sees ``y_table[...] + extra_costs[c, s]`` (the multi-tenant
    coupling channel).

    ``draws``: the random numbers to use instead of ``generator`` — a dict
    with the :data:`DRAW_KEYS`, each (C, n_steps), plus ``"noise"`` /
    ``"noise0"`` when ``noise_std > 0``.  The main path never passes it.

    Returns ``{"states": (C, n_steps, ndim) int32, "ys": (C, n_steps)
    float32, "accepts": (C, n_steps) bool, "inits": (C, ndim) int32}`` on
    ``device``; ``ys`` include the extra-cost term when one is supplied.
    No value is read back to the host.
    """
    dev = resolve_device(device)
    enc = _as_encoded(space)
    y = torch.as_tensor(y_table, dtype=torch.float32, device=dev)
    base = y.ndim - (1 if per_chain_tables else 0)
    if base == enc.ndim + 1:
        dynamic = True
    elif base == enc.ndim:
        dynamic = False
    else:
        raise ValueError(f"table rank {y.ndim} vs space rank {enc.ndim}")

    taus_arr = torch.as_tensor(taus, dtype=torch.float32, device=dev)
    if n_chains is None:
        if taus_arr.ndim >= 1:
            n_chains = taus_arr.shape[0]
        elif inits is not None and np.ndim(inits) == 2:
            n_chains = len(inits)
        elif per_chain_tables:
            n_chains = y.shape[0]
        else:
            raise ValueError("pass n_chains (or batched taus/inits/tables)")
    C, S = int(n_chains), int(n_steps)
    if taus_arr.ndim == 1:
        taus_arr = taus_arr[:, None]
    taus_b = torch.broadcast_to(taus_arr, (C, S))

    if inits is None:
        inits = random_valid_states(generator, enc, C, device=dev)
    else:
        inits = torch.as_tensor(inits, dtype=torch.int32, device=dev)
        if inits.ndim == 1:
            inits = torch.broadcast_to(inits, (C, enc.ndim))

    lead = (C,) if per_chain_tables else ()
    time = (S,) if dynamic else ()
    expect = lead + time + enc.shape
    if tuple(y.shape) != expect:
        raise ValueError(f"table shape {tuple(y.shape)} != expected {expect} "
                         f"(chains={C}, steps={S}, space={enc.shape})")
    y_flat = y.reshape(lead + time + (-1,))
    valid_flat = (None if enc.valid_mask is None
                  else _upload(enc.valid_mask.reshape(-1), dev))

    extra = None
    if extra_costs is not None:
        extra = torch.as_tensor(extra_costs, dtype=torch.float32, device=dev)
        if tuple(extra.shape) == (C,) + enc.shape:
            extra = extra.reshape(C, -1)
        if tuple(extra.shape) != (C, enc.size()):
            raise ValueError(
                f"extra_costs shape {tuple(extra.shape)} != "
                f"{(C,) + enc.shape} (or its flattened form)")

    d = (_draw(generator, enc, C, S, noise_std > 0.0, dev) if draws is None
         else _given_draws(draws, C, S, noise_std > 0.0, dev))
    states, ys, accepts = _walk(enc.shape, enc.categorical, valid_flat,
                                y_flat, taus_b, inits, extra, d,
                                dynamic=dynamic, per_chain=per_chain_tables,
                                noise_std=noise_std)
    return {"states": states, "ys": ys, "accepts": accepts,
            "inits": inits}


def _given_draws(draws: Mapping[str, Any], C: int, S: int, noisy: bool,
                 dev: torch.device) -> dict[str, torch.Tensor]:
    """``draws=`` as the walk takes them: on ``dev``, in the kernel's
    dtypes, each checked against (C, S) (``noise0`` against (C,))."""
    keys = DRAW_KEYS + (("noise", "noise0") if noisy else ())
    types = {"axis": torch.int64, "up": torch.bool, "pick": torch.int64,
             "uniform": torch.float32, "noise": torch.float32,
             "noise0": torch.float32}
    d = {k: torch.as_tensor(draws[k], device=dev).to(types[k]).contiguous()
         for k in keys}
    for k in keys:
        want = (C,) if k == "noise0" else (C, S)
        if tuple(d[k].shape) != want:
            raise ValueError(f"draws[{k!r}] shape {tuple(d[k].shape)} "
                             f"!= {want}")
    return d


def _walk(shape, categorical, valid_flat, y_flat, taus_b, inits, extra, d,
          *, dynamic: bool, per_chain: bool, noise_std: float):
    """One :func:`repro_torch.kernels.ops.anneal_walk` call: the kernel on
    the card, its plain version on the CPU."""
    noisy = noise_std > 0.0
    return ops.anneal_walk(
        inits.contiguous(), y_flat.contiguous(), taus_b.contiguous(),
        d["axis"], d["up"], d["pick"], d["uniform"], shape=tuple(shape),
        categorical=tuple(categorical), dynamic=dynamic, per_chain=per_chain,
        extra=None if extra is None else extra.contiguous(),
        valid=valid_flat, noise=d["noise"] if noisy else None,
        noise0=d["noise0"] if noisy else None, noise_std=float(noise_std))


def chain_accept_stats(
    ys: np.ndarray,                     # (C, n_steps) proposal objectives
    accepts: np.ndarray,                # (C, n_steps) accept flags
    y0: np.ndarray | float,             # (C,) objective at the inits
    taus: np.ndarray,                   # (C, n_steps) temperatures
) -> tuple[np.ndarray, np.ndarray]:
    """Temperature and heat-bath probability at each chain's LAST
    accepted transition, recovered post hoc from one compiled round's
    outputs (numpy only — the provenance layer's read path, same
    forward-fill trick as ``ControllerMixin.explored_flags``).

    Returns ``(tau_at, p)`` of shape (C,): ``tau_at[c]`` is the
    temperature at the last accepted step (the final step's temperature
    when nothing was accepted) and ``p[c] = exp(-max(dy, 0)/tau)`` the
    acceptance probability of that transition against the incumbent the
    chain actually held before it (NaN when nothing was accepted).
    """
    ys = np.asarray(ys, np.float64)
    accepts = np.asarray(accepts, bool)
    C, n_steps = ys.shape
    taus = np.broadcast_to(np.asarray(taus, np.float64), (C, n_steps))
    kk = np.broadcast_to(np.arange(n_steps)[None, :], (C, n_steps))
    last_acc = np.maximum.accumulate(np.where(accepts, kk, -1), axis=1)
    prev_acc = np.concatenate(
        [np.full((C, 1), -1), last_acc[:, :-1]], axis=1)
    y0_col = np.broadcast_to(
        np.asarray(y0, np.float64).reshape(-1, 1), (C, 1)).copy()
    inc_before = np.where(
        prev_acc >= 0,
        np.take_along_axis(ys, np.maximum(prev_acc, 0), axis=1), y0_col)
    k_last = last_acc[:, -1]
    has = k_last >= 0
    idx = np.maximum(k_last, 0)[:, None]
    dy = (np.take_along_axis(ys, idx, axis=1)[:, 0]
          - np.take_along_axis(inc_before, idx, axis=1)[:, 0])
    tau_at = np.where(has,
                      np.take_along_axis(taus, idx, axis=1)[:, 0],
                      taus[:, -1])
    pos_tau = np.maximum(tau_at, 1e-300)
    p = np.exp(-np.maximum(dy, 0.0) / pos_tau)
    p = np.where(tau_at <= 0.0, (dy <= 0.0).astype(np.float64), p)
    return tau_at, np.where(has, p, np.nan)




# ---------------------------------------------------------------------------
# One-chain forms of the engine (the paper's illustrative figures).
# ---------------------------------------------------------------------------


def _line(n: int) -> EncodedSpace:
    """The 1-D ordinal space of an ``n``-state landscape."""
    return EncodedSpace((int(n),), (False,))


def _one_chain(draws: Mapping[str, Any] | None) -> dict[str, Any] | None:
    """One chain's draws, (n_steps,) each and ``noise0`` a scalar, as the
    fleet's (1, n_steps) and (1,)."""
    if draws is None:
        return None
    return {k: torch.as_tensor(v).reshape((1,) if k == "noise0" else (1, -1))
            for k, v in draws.items()}


def _tau_row(tau, n_steps: int, dev: torch.device) -> torch.Tensor:
    """A scalar or (n_steps,) temperature as one chain's (1, n_steps)."""
    t = torch.as_tensor(tau, dtype=torch.float32, device=dev)
    return torch.broadcast_to(t, (n_steps,))[None, :]


def anneal_chain(
    generator: torch.Generator | None,
    y_table: torch.Tensor | np.ndarray,
    n_steps: int,
    tau: torch.Tensor | np.ndarray | float,
    init: int = 0,
    noise_std: float = 0.0,
    draws: Mapping[str, Any] | None = None,
    device: str | torch.device = "cuda",
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One annealing chain on a 1-D landscape ``y_table`` (S,) with +-1
    moves, reflected at the ends (paper Figs. 2-3).

    ``tau`` is a scalar or (n_steps,) temperatures; ``noise_std`` adds a
    standard normal times it to every measurement, the initial one
    included (jobs are stochastic).  ``draws``: the chain's random numbers
    in :data:`DRAW_KEYS` form, (n_steps,) each (``axis`` all 0; ``pick``
    unread), plus ``"noise"`` (n_steps,) and ``"noise0"`` (a scalar) when
    ``noise_std > 0``.  Returns ``(states, ys, accepts)``, each
    (n_steps,), on ``device``.
    """
    dev = resolve_device(device)
    y = torch.as_tensor(y_table, dtype=torch.float32, device=dev)
    out = anneal_fleet(generator, _line(y.shape[0]), y, n_steps,
                       _tau_row(tau, n_steps, dev), inits=[int(init)],
                       n_chains=1, noise_std=noise_std,
                       draws=_one_chain(draws), device=dev)
    return out["states"][0, :, 0], out["ys"][0], out["accepts"][0]


def anneal_chain_dynamic(
    generator: torch.Generator | None,
    y_tables: torch.Tensor | np.ndarray,
    n_steps: int,
    tau: torch.Tensor | np.ndarray | float,
    init: int = 0,
    draws: Mapping[str, Any] | None = None,
    device: str | torch.device = "cuda",
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """:func:`anneal_chain` on a time-indexed landscape ``y_tables``
    (n_steps, S) (paper Fig. 5), without noise.

    The incumbent's stored objective, ``y_tables[0, init]`` at the start,
    goes stale after a change; it is refreshed only when the incumbent is
    re-measured, exactly as in the online algorithm (proposals are
    measured on the *current* landscape)."""
    dev = resolve_device(device)
    y = torch.as_tensor(y_tables, dtype=torch.float32, device=dev)
    out = anneal_fleet(generator, _line(y.shape[1]), y, n_steps,
                       _tau_row(tau, n_steps, dev), inits=[int(init)],
                       n_chains=1, draws=_one_chain(draws), device=dev)
    return out["states"][0, :, 0], out["ys"][0], out["accepts"][0]


def _default_init(enc: EncodedSpace) -> np.ndarray:
    if enc.valid_mask is None:
        return np.zeros(enc.ndim, np.int32)
    flat = enc.valid_mask.reshape(-1)
    first = int(np.argmax(flat))
    if not flat[first]:
        raise ValueError("space has no valid states")
    return np.asarray(np.unravel_index(first, enc.shape), np.int32)


def anneal_chain_nd(
    generator: torch.Generator | None,
    space: ConfigSpace | EncodedSpace,
    y_table: torch.Tensor | np.ndarray,
    n_steps: int,
    tau: torch.Tensor | np.ndarray | float,
    init: Sequence[int] | None = None,
    noise_std: float = 0.0,
    draws: Mapping[str, Any] | None = None,
    device: str | torch.device = "cuda",
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One chain over an N-dim ConfigSpace (the compiled online algorithm).

    ``y_table`` has shape ``space.shape`` (static) or ``(n_steps,) +
    space.shape`` (time-indexed); ``tau`` is a scalar or (n_steps,)
    temperatures (:func:`repro_torch.core.schedules.schedule_to_array`
    output traces reheat events); ``init`` defaults to the first valid
    state.  ``draws`` as in :func:`anneal_chain`.  Returns ``(states
    (n_steps, ndim), ys (n_steps,), accepts (n_steps,))`` on ``device``.
    """
    dev = resolve_device(device)
    enc = _as_encoded(space)
    if init is None:
        init = _default_init(enc)
    out = anneal_fleet(generator, enc, y_table, n_steps,
                       _tau_row(tau, n_steps, dev),
                       inits=np.asarray(init, np.int32), n_chains=1,
                       noise_std=noise_std, draws=_one_chain(draws),
                       device=dev)
    return out["states"][0], out["ys"][0], out["accepts"][0]


def first_hit_time(states: torch.Tensor,
                   target: torch.Tensor | int) -> torch.Tensor:
    """Index of the first visit to ``target`` along the last axis of
    ``states`` (its length if never reached)."""
    hits = states == target
    n = states.shape[-1]
    first = hits.to(torch.uint8).argmax(-1)
    return torch.where(hits.any(-1), first, torch.full_like(first, n))


def jobs_to_min_vs_tau(
    generator: torch.Generator | None,
    y_table: torch.Tensor | np.ndarray,
    taus: Sequence[float],
    n_seeds: int = 64,
    n_steps: int = 2000,
    init: int | None = None,
    draws: Sequence[Mapping[str, Any]] | None = None,
    device: str | torch.device = "cuda",
) -> dict[str, np.ndarray]:
    """Paper Fig. 4 / Fig. 10: #jobs until the global minimum of a 1-D
    landscape is selected, vs temperature, with +-2 sample std bars over
    seeds: one batched call of ``n_seeds`` chains per temperature.

    ``draws``: one :func:`anneal_fleet` draws dict per temperature, each
    (n_seeds, n_steps)."""
    dev = resolve_device(device)
    y = torch.as_tensor(y_table, dtype=torch.float32, device=dev)
    target = int(torch.argmin(y))
    enc = _line(y.shape[0])
    means, stds, raw = [], [], []
    for i, tau in enumerate(taus):
        out = anneal_fleet(generator, enc, y, n_steps, float(tau),
                           inits=[0 if init is None else int(init)],
                           n_chains=n_seeds,
                           draws=None if draws is None else draws[i],
                           device=dev)
        hits = first_hit_time(out["states"][..., 0], target).cpu().numpy()
        means.append(hits.mean())
        stds.append(hits.std(ddof=1))
        raw.append(hits)
    return {
        "taus": np.asarray(taus, np.float64),
        "mean_jobs": np.asarray(means),
        "std_jobs": np.asarray(stds),
        "raw": np.stack(raw),
    }


def jobs_to_min_vs_tau_fleet(
    generator: torch.Generator | None,
    space: ConfigSpace | EncodedSpace,
    y_table: torch.Tensor | np.ndarray,
    taus: Sequence[float],
    n_seeds: int = 64,
    n_steps: int = 2000,
    init: Sequence[int] | None = None,
    target: Sequence[int] | None = None,
    draws: Mapping[str, Any] | None = None,
    device: str | torch.device = "cuda",
) -> dict[str, np.ndarray]:
    """Fig. 4 / Fig. 10 sweep through the batched engine: the whole
    (temperature x seed) grid is ONE :func:`anneal_fleet` call on any
    N-dim ConfigSpace, chain ``i * n_seeds + s`` at ``taus[i]``; only the
    first-hit times come back to the host."""
    dev = resolve_device(device)
    enc = _as_encoded(space)
    y_np = np.asarray(y_table, np.float64)
    if target is None:
        masked = (y_np if enc.valid_mask is None
                  else np.where(enc.valid_mask, y_np, np.inf))
        target = np.unravel_index(int(np.argmin(masked)), enc.shape)
    target = np.asarray(target, np.int32)

    n_taus = len(taus)
    n_chains = n_taus * n_seeds
    taus_b = np.repeat(np.asarray(taus, np.float32), n_seeds)
    inits = (None if init is None
             else np.tile(np.asarray(init, np.int32), (n_chains, 1)))
    out = anneal_fleet(generator, enc, y_np, n_steps, taus_b, inits=inits,
                       n_chains=n_chains, draws=draws, device=dev)
    hit = (out["states"] == torch.as_tensor(target, device=dev)).all(-1)
    first = hit.to(torch.uint8).argmax(1)
    hits = torch.where(hit.any(1), first, torch.full_like(first, n_steps))
    hits = hits.cpu().numpy().reshape(n_taus, n_seeds)
    return {
        "taus": np.asarray(taus, np.float64),
        "mean_jobs": hits.mean(1),
        "std_jobs": hits.std(1, ddof=1),
        "raw": hits,
    }


# ---------------------------------------------------------------------------
# Fleet-chain dispatch: the chain axis padded to a bucket (the per-tenant
# path of the fleet controllers).
# ---------------------------------------------------------------------------


def chain_bucket(n: int, multiple: int = 1) -> int:
    """Next power-of-two >= ``n``, rounded up to a ``multiple``.  The fleet
    pads its chain axis to these buckets, so a churning tenant count
    (arrivals and departures every round) walks a handful of chain-axis
    sizes instead of a new one per fleet size."""
    if n < 1:
        raise ValueError("n must be >= 1")
    p = 1
    while p < n:
        p *= 2
    if multiple > 1 and p % multiple:
        p = ((p + multiple - 1) // multiple) * multiple
    return p


def _pad_chains(a: torch.Tensor, p: int) -> torch.Tensor:
    """Pad axis 0 from C to ``p`` by repeating row 0 (valid chain data —
    the padding chains run and are sliced away; chains never read each
    other's rows, so rows 0..C-1 are bit-identical)."""
    pad = p - a.shape[0]
    if pad == 0:
        return a
    return torch.cat([a, a[:1].expand((pad,) + tuple(a.shape[1:]))])


def fleet_chains(
    generator: torch.Generator | None,
    tables: torch.Tensor | np.ndarray,       # (C, size) float32, per-chain
    valid_flat: torch.Tensor | np.ndarray | None,   # (size,) bool or None
    taus: torch.Tensor | np.ndarray,         # (C, n_steps)
    inits: torch.Tensor | np.ndarray,        # (C, ndim) int32
    extra: torch.Tensor | np.ndarray | None,  # (C, size) or None
    *,
    shape: tuple[int, ...],
    categorical: tuple,
    noise_std: float = 0.0,
    bucket: bool = True,
    draws: Mapping[str, Any] | None = None,
    device: str | torch.device = "cuda",
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Run C per-chain-table fleet chains with the chain axis padded to
    :func:`chain_bucket` (with ``bucket``).

    The draws are made for the C true chains (from ``generator``, exactly
    as :func:`anneal_fleet` makes them, or taken from ``draws``); then the
    draws, tables, temperatures, initial states and extra rows are padded
    alike by repeating chain 0, so rows 0..C-1 are bit-identical with and
    without padding, and equal to ``anneal_fleet(per_chain_tables=True,
    extra_costs=extra)`` from the same generator.  Returns ``(states,
    ys, accepts)`` sliced back to the true C, on ``device``.
    """
    dev = resolve_device(device)
    tab = torch.as_tensor(tables, dtype=torch.float32, device=dev)
    C, size = tab.shape
    taus_t = torch.as_tensor(taus, dtype=torch.float32, device=dev)
    if taus_t.ndim != 2 or taus_t.shape[0] != C:
        raise ValueError(f"taus shape {tuple(taus_t.shape)} != (C, n_steps) "
                         f"with C = {C}")
    S = taus_t.shape[1]
    enc = EncodedSpace(tuple(shape), tuple(categorical))
    if enc.size() != size:
        raise ValueError(f"tables hold {size} states, shape {enc.shape} "
                         f"{enc.size()}")
    init_t = torch.as_tensor(inits, dtype=torch.int32, device=dev)
    ext = (None if extra is None else
           torch.as_tensor(extra, dtype=torch.float32, device=dev))
    valid = (None if valid_flat is None else torch.as_tensor(
        valid_flat, dtype=torch.bool, device=dev).reshape(-1))
    noisy = noise_std > 0.0
    d = (_draw(generator, enc, C, S, noisy, dev) if draws is None
         else _given_draws(draws, C, S, noisy, dev))
    P = chain_bucket(C) if bucket else C
    d = {k: _pad_chains(v, P) for k, v in d.items()}
    states, ys, accepts = _walk(
        enc.shape, enc.categorical, valid, _pad_chains(tab, P),
        _pad_chains(taus_t, P), _pad_chains(init_t, P),
        None if ext is None else _pad_chains(ext, P), d, dynamic=False,
        per_chain=True, noise_std=noise_std)
    return states[:C], ys[:C], accepts[:C]
