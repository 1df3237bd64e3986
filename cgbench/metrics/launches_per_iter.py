"""Device launches an iteration in the traced slice (NCCL's kernels and
the convergence reads' copies count too); on several cards the mean.
Also read as ``launches_per_iter.rtol`` and ``.np4``."""

from cgbench.readers import launches_per_iter


def read(run):
    return launches_per_iter(run)
