"""The window's seconds over the solves it completed to tolerance."""


def read(run):
    done = sum(1 for _, _, c in run.solves if c)
    return run.window_s / done if done else None
