"""Kernel #1 (fused ring decode): least time of its calls in the traced
window over its device time."""
from bench import readers as R


def read(r):
    return R.roofline_pct(r, "swat_decode")
