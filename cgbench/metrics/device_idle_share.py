"""The share of the traced slice in which no device operation ran:
1 - busy_s / window_s, in %; on several cards from the mean busy share.
Also read as ``device_idle_share.rtol`` and ``.np4``."""

from cgbench.readers import idle_share


def read(run):
    return idle_share(run)
