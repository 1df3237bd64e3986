"""Seconds of the problem build (the device planes and the solver),
host clock around the builder call with a synchronise after it."""


def read(run):
    return run.build_s
