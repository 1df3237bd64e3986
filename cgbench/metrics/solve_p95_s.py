"""The 95th percentile (nearest rank) of the wall time of every solve in
the window, each from its call to the synchronise after it."""

import math


def read(run):
    walls = sorted(w for w, _, _ in run.solves)
    return walls[max(math.ceil(0.95 * len(walls)) - 1, 0)]
