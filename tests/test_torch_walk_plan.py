"""How ``anneal_walk``'s card kernel is laid out for a call.

``ops.walk_plan`` is pure Python: the wrapper calls it before each launch
and hands its answer to the kernel (``anneal_walk_set_plan``), which only
checks that the plan's shared memory covers its own layout.  So what the
card relies on is held here, on the CPU: the plans at the paths' shapes,
windows of 32 or 64 steps, and a block's shared memory (``ops.walk_smem``,
the kernel's ``layout``) never above the limit the plan was given.
"""

import numpy as np
import pytest

from repro_torch.kernels import ops

FLAGS = ("per_chain", "dynamic", "extra", "valid", "noisy")

# (C, S, ndim, size, per_chain, dynamic, extra, valid, noisy) at the paths'
# walks: path A's and path B's rounds (16 chains x 64 steps on the 4^8 and
# 6^8 sizing grids, no mask), Fig. 4's sweep (5 seeds x 64 temperatures on
# 48 states), Fig. 5's time-indexed table, fleet_chains' bucket (1,024 x 32
# on the paper's 4 x 30 space, per-tenant tables and extra rows), path H's
# fleet buckets (the 64-state EC2 space, tenants' tables and coupling rows)
PATHS = {
    "path A round": (16, 64, 16, 4 ** 8, False, False, False, False, False),
    "path B round": (16, 64, 16, 6 ** 8, False, False, False, False, False),
    "Fig. 4 sweep": (320, 4000, 1, 48, False, False, False, False, False),
    "Fig. 5 table": (1, 6000, 1, 48, False, True, False, False, False),
    "fleet_chains bucket": (1024, 32, 2, 120, True, False, True, False,
                            False),
    "path H bucket 16": (16, 32, 2, 64, True, False, True, False, False),
    "path H bucket 32": (32, 32, 2, 64, True, False, True, False, False),
    "path H bucket 1024": (1024, 32, 2, 64, True, False, True, False,
                           False),
}


def _plan(C, S, ndim, size, *flags, **kw):
    return ops.walk_plan(C, S, ndim, size, **dict(zip(FLAGS, flags)), **kw)


def _check(plan, ndim, size, flags, smem_limit):
    assert plan.window in (32, 64)
    assert plan.smem == ops.walk_smem(plan.window, plan.staged, ndim, size,
                                      **dict(zip(FLAGS, flags)))
    assert plan.smem <= smem_limit


def test_walk_plan_at_the_path_shapes_is_what_the_notes_say():
    """The plans the kernel's source note, PERF.md and chip_smoke.py's
    printed plans quote, on the H100's 227 KB and 132 SMs."""
    want = {
        # the tables do not fit: unstaged
        "path A round": ops.WalkPlan(64, False, 135_680),
        "path B round": ops.WalkPlan(64, False, 135_680),
        # staged, a window of 64 steps
        "Fig. 4 sweep": ops.WalkPlan(64, True, 127_456),
        "Fig. 5 table": ops.WalkPlan(64, True, 151_840),
        # per-chain rows and extra rows staged a block at a time; S = 32
        "fleet_chains bucket": ops.WalkPlan(32, True, 101_392),
        # the fleet's per-tenant rows and coupling rows staged at any C
        "path H bucket 16": ops.WalkPlan(32, True, 87_056),
        "path H bucket 32": ops.WalkPlan(32, True, 87_056),
        "path H bucket 1024": ops.WalkPlan(32, True, 87_056),
    }
    for label, shape in PATHS.items():
        assert _plan(*shape) == want[label], label


@pytest.mark.parametrize("label", list(PATHS))
def test_walk_plan_fits_the_limit_it_was_given(label):
    C, S, ndim, size, *flags = PATHS[label]
    for limit in (ops.H100_SMEM, 160 * 1024, 100 * 1024):
        try:
            plan = _plan(C, S, ndim, size, *flags, smem_limit=limit)
        except ValueError:
            assert ops.walk_smem(32, False, ndim, size,
                                 **dict(zip(FLAGS, flags))) > limit
            continue
        _check(plan, ndim, size, flags, limit)


def test_walk_plan_stages_a_table_exactly_when_it_fits():
    """One float under and one over the room a shared static table has
    beside the rest of a block of the smaller window: staged at that
    window, then unstaged at the larger one."""
    ndim, S = 1, 4000
    flags = dict(per_chain=False, dynamic=False, extra=False, valid=False,
                 noisy=False)
    room = (ops.H100_SMEM - ops.walk_smem(32, False, ndim, 1, **flags)) // 4
    while ops.walk_smem(32, True, ndim, room, **flags) > ops.H100_SMEM:
        room -= 1
    under = _plan(320, S, ndim, room, False, False, False, False, False)
    over = _plan(320, S, ndim, room + 1, False, False, False, False, False)
    assert under.staged and under.window == 32
    assert under.smem <= ops.H100_SMEM
    assert not over.staged and over.window == 64


@pytest.mark.parametrize("sms", [ops.H100_SMS, 16])
def test_walk_plan_takes_the_short_window_past_one_block_an_sm(sms):
    """64-step windows while the blocks (32 chains each) fit on the SMs
    one each; past that 32-step ones, which take half the shared memory,
    so that several blocks share an SM."""
    flags = (False,) * 5
    for C in (1, 32 * sms - 31, 32 * sms):
        assert _plan(C, 4000, 1, 48, *flags, sms=sms).window == 64
    for C in (32 * sms + 1, 16_000, 64_000):
        plan = _plan(C, 4000, 1, 48, *flags, sms=sms)
        assert plan.window == 32 and plan.staged
        assert 2 * plan.smem <= ops.H100_SMEM
    # a fleet of the paper's 4 x 30 space, per-tenant tables, 32 steps
    fleet = _plan(65_536, 32, 2, 120, True, False, True, False, False,
                  sms=sms)
    assert fleet == _plan(1024, 32, 2, 120, True, False, True, False, False)


@pytest.mark.parametrize("extra", [False, True])
def test_walk_plan_stages_static_per_chain_tables_at_any_chain_count(extra):
    """A static per-chain table that fits is staged whatever the number
    of chains, from one chain to a fleet's largest bucket (reading a
    few chains' tables unstaged saves microseconds a walk, in fleet
    rounds of milliseconds: the plan keeps one rule)."""
    flags = (True, False, extra, False, False)
    plans = {C: _plan(C, 32, 2, 64, *flags) for C in (1, 4, 16, 32, 2048)}
    assert all(p.staged and p.window == 32 for p in plans.values()), plans
    assert len({p.smem for p in plans.values()}) == 1


def test_walk_plan_time_indexed_rows_staged_only_while_small():
    """A time-indexed table is staged a window at a time only while a
    lane's share of a step's rows is at most WALK_STAGE_ROW_MAX floats."""
    small = ops.WALK_STAGE_ROW_MAX
    assert _plan(3, 100, 2, small, True, True, False, False, False).staged
    assert not _plan(3, 100, 2, small + 1, True, True, False, False,
                     False).staged
    assert _plan(1, 100, 1, 32 * small, False, True, False, False,
                 False).staged
    assert not _plan(1, 100, 1, 32 * small + 1, False, True, False, False,
                     False).staged


@pytest.mark.parametrize("noisy", [False, True])
def test_walk_plan_fits_any_call(noisy):
    rng = np.random.default_rng(int(noisy))
    for _ in range(400):
        ndim = int(rng.integers(1, ops.WALK_MAX_DIM + 1))
        size = int(rng.choice([1, 7, 48, 120, 4 ** 8, 6 ** 8, 3 << 20]))
        C, S = int(rng.integers(1, 5000)), int(rng.integers(1, 9000))
        flags = (bool(rng.integers(2)), bool(rng.integers(2)),
                 bool(rng.integers(2)), bool(rng.integers(2)), noisy)
        limit = int(rng.choice([ops.H100_SMEM, 200 * 1024]))
        try:
            plan = _plan(C, S, ndim, size, *flags, smem_limit=limit)
        except ValueError:
            # only below the card's own limit can a space not fit
            assert limit < ops.H100_SMEM
            assert ops.walk_smem(32, False, ndim, size,
                                 **dict(zip(FLAGS, flags))) > limit
            continue
        _check(plan, ndim, size, flags, limit)
        assert plan.window == 32 or S > 32


def test_walk_plan_refuses_what_cannot_fit():
    with pytest.raises(ValueError, match="shared memory"):
        _plan(16, 64, 32, 100, *(False,) * 5, smem_limit=64 * 1024)
    with pytest.raises(ValueError, match=">= 1"):
        _plan(0, 64, 2, 100, *(False,) * 5)
