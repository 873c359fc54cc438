"""The least time of the traced window's useful work (bench/work.py) at
the H100's peaks, over the window's length."""
from bench import readers as R


def read(r):
    return R.mfu_pct(r)
