"""Every CG iteration completed in the window over the window's
seconds (host clock; the reference's "total solver time" protocol).
Also read as ``iters_per_s.np4``: on several ranks rank 0's clock,
which closes the window for every rank."""

from cgbench.readers import iteration_rate


def read(run):
    return iteration_rate(run)
