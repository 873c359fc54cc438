"""Kernels #4 and #5 (dQ, dK/dV and the combine) in the train step: least
time of their calls over their device time."""
from bench import readers as R


def read(r):
    return R.roofline_pct(r, "swat_bwd")
