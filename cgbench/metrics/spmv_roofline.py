"""K1's share of its HBM roofline, in %; on several cards the mean, each
counted for its share of the operator.  Also read as
``spmv_roofline.np4``."""

from cgbench.readers import spmv_roofline


def read(run):
    return spmv_roofline(run)
