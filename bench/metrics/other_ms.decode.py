"""Device time per decode step in kernels that are neither GEMMs nor SWAT
kernels, inside engine.decode_block spans."""
from bench import readers as R


def read(r):
    return R.other_ms(r, "decode_steps", "engine.decode_block")
