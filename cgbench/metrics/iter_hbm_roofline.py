"""The whole iteration's share of the HBM roofline, in %; on several
cards the mean, each counted for its share of the operator.  Also read
as ``iter_hbm_roofline.np4``."""

from cgbench.readers import iter_hbm_roofline


def read(run):
    return iter_hbm_roofline(run)
