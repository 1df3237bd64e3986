"""Helpers the metric readers under ``metrics/`` share.  A reader that
finds nothing to read returns None and the metric is left out."""

from __future__ import annotations

from cgbench import counts, trace


def traced(run) -> bool:
    return bool(run.cards) and run.slice_iterations > 0


def iteration_rate(run) -> float:
    """Every CG iteration completed in the window over its seconds."""
    return sum(k for _, k, _ in run.solves) / run.window_s


def launches_per_iter(run):
    """Device events (kernels, copies, fills) a card launched in the
    traced slice, over the iterations in it; the mean over cards."""
    if not traced(run):
        return None
    per = [c["launches"] for c in run.cards]
    return sum(per) / len(per) / run.slice_iterations


def idle_share(run):
    """``1 - busy_s / window_s`` of the traced slice, in %."""
    if not run.cards:
        return None
    busy, window = trace.combine(run.cards)
    return 100.0 * (1.0 - busy / window)


def mean_over_cards(run, f):
    vals = [f(c) for c in run.cards]
    vals = [v for v in vals if v is not None]
    return sum(vals) / len(vals) if vals else None


def hbm_share(nbytes: float, seconds: float) -> float:
    """``nbytes`` in ``seconds`` as a % of the published HBM rate."""
    return 100.0 * nbytes / seconds / counts.HBM_BYTES_PER_S


def spmv_roofline(run):
    """K1's share of its HBM roofline: the benchmark's SpMV bytes a card
    times K1's launches in the traced slice, over K1's summed device
    time, over the published HBM rate; the mean over cards.  None when
    no K1 launch is in the slice."""
    if not traced(run):
        return None
    return mean_over_cards(
        run, lambda c: hbm_share(run.spmv_bytes_card * c["k1_launches"],
                                 c["k1_s"]) if c["k1_launches"] else None)


def iter_hbm_roofline(run):
    """The whole iteration's share of the HBM roofline: the benchmark's
    bytes of one classic iteration a card times the slice's iterations,
    over the slice's wall, over the published HBM rate; the mean over
    cards.  It bounds every kernel's share from above in time."""
    if not traced(run):
        return None
    return mean_over_cards(
        run, lambda c: hbm_share(run.iteration_bytes_card
                                 * run.slice_iterations, c["window_s"]))
