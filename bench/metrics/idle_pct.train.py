"""100 x (1 - union of device operations / traced window)."""
from bench import readers as R


def read(r):
    return R.idle_pct(r)
