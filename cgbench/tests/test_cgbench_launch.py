"""Each rank's CPUs: a slice of its own of the usable CPUs."""

import pytest

from cgbench import launch


@pytest.mark.parametrize("ranks, usable, want", [
    (4, range(32), [range(0, 8), range(8, 16), range(16, 24),
                    range(24, 32)]),
    (1, range(8), [range(8)]),
    # the last rank takes what is left over
    (3, range(8), [range(0, 2), range(2, 4), range(4, 8)]),
    (2, [2, 3, 4, 20, 21], [[2, 3], [4, 20, 21]]),
    # more ranks than CPUs: each still gets one
    (3, [5], [[5], [5], [5]]),
    (3, [5, 6], [[5], [6], [6]]),
])
def test_cpu_plan(ranks, usable, want):
    assert launch.cpu_plan(ranks, set(usable)) == [set(w) for w in want]
