"""Device-to-host copies (the convergence reads and the solve's closing
reads) in the first card's traced slice, over the solves in it."""

from cgbench.readers import traced


def read(run):
    if not traced(run) or not run.slice_solves:
        return None
    return run.cards[0]["dtoh_copies"] / run.slice_solves
