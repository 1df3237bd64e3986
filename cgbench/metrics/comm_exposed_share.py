"""NCCL kernel time not covered by a compute kernel on the same card,
over the slice's wall, in %; the mean over cards.  Silent where no NCCL
kernel ran."""

from cgbench.readers import mean_over_cards, traced


def read(run):
    if not traced(run) or not any(c["nccl_s"] > 0 for c in run.cards):
        return None
    return mean_over_cards(
        run, lambda c: 100.0 * c["nccl_exposed_s"] / c["window_s"])
