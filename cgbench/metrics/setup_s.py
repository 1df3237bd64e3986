"""Seconds from process start to the first timed solve (host clock)."""


def read(run):
    return run.setup_s
