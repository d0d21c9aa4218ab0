"""The reciprocal step of ``kernels/csrc/ieee_div.cuh`` (``rcp_rn``), over
every float32 significand, in exact integer arithmetic.

``rcp_rn`` takes the card's approximate reciprocal r, a faithful rounding
of 1 / d (one of the two floats around it), and returns r + r (1 - d r) by
fmaf, one ulp up when d's significand is all ones and that step returned a
power of two.  This holds the step for d in [1, 2) from both faithful
neighbours; scaling d by a power of two scales every quantity exactly, so
the whole normal range follows.  The card test
``test_reciprocal_is_correctly_rounded`` checks the compiled function
against IEEE division on the card.

Units: d = D * 2^-23 with D in [2^23, 2^24); 1 / d in (1/2, 1] is Y * 2^-24.
"""

import numpy as np
import pytest

D = np.arange(1 << 23, 1 << 24, dtype=np.int64)
ONE = np.int64(1) << 47                       # 1 = 2^47 in units d * y
RD = ONE // D                                 # 1 / d rounded down
REM = ONE - RD * D
RU = RD + (REM > 0)
RN = np.where(2 * REM > D, RD + 1, RD)        # no reciprocal is a midpoint


def _step(Y, fix=True):
    """rcp_rn's step from the seed Y: e = 1 - d y (exact: the residual of
    a faithful seed fits 24 bits), then y + y e rounded to nearest, even on
    ties; with ``fix``, one ulp up for the all-ones significand."""
    E = ONE - D * Y
    assert np.all(np.abs(E) < (1 << 24))      # fmaf(-d, y, 1) is exact
    q, r = np.divmod(Y * E, ONE)              # y e = (q + r / 2^47) ulps
    half = ONE // 2
    Y2 = Y + q + ((r > half) | ((r == half) & ((Y + q) % 2 == 1)))
    if fix:
        Y2 = Y2 + ((D == (1 << 24) - 1) & (Y2 == (1 << 23)))
    return Y2


def test_no_reciprocal_is_a_midpoint():
    assert not np.any(2 * REM == D)


@pytest.mark.parametrize("seed", ["below", "above"])
def test_one_step_from_a_faithful_seed_rounds_to_nearest(seed):
    """Every significand, from the float below 1 / d and from the one
    above: the step and its fix give the correctly rounded reciprocal."""
    Y = RD if seed == "below" else RU
    assert np.array_equal(_step(Y), RN)


def test_the_fix_is_needed_only_for_the_all_ones_significand():
    """Without the fix the step misses exactly one case: d = 2 - 2^-23
    from the seed 1/2, where 1 / d lies a hair above the midpoint over 1/2
    and the step lands on 1/2."""
    wrong = np.nonzero(_step(RD, fix=False) != RN)[0]
    assert [int(D[i]) for i in wrong] == [(1 << 24) - 1]
    assert int(RD[wrong[0]]) == 1 << 23 and int(RN[wrong[0]]) == (1 << 23) + 1
    assert np.array_equal(_step(RU, fix=False), RN)
