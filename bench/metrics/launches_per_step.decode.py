"""Device kernels per decode step inside engine.decode_block spans."""
from bench import readers as R


def read(r):
    return R.launches_per_step(r, "engine.decode_block", "decode_steps")
