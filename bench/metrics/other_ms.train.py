"""Device time per train step in kernels that are neither GEMMs nor SWAT
kernels: the MoE sort dispatch, norms, elementwise, the optimizer."""
from bench import readers as R


def read(r):
    return R.other_ms(r, "train_steps")
