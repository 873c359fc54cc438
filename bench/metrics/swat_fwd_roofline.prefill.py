"""Kernel #2 (banded forward) in prefill: least time of its calls over
its device time."""
from bench import readers as R


def read(r):
    return R.roofline_pct(r, "swat_fwd")
