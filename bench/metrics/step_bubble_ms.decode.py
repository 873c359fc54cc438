"""Device-idle ms per decode step inside engine.decode_block.read, where
the host only waits for the replayed block: the gaps between its
kernels."""
from bench import readers as R
from bench import span_readers as S


def read(r):
    idle = S.idle_s(r, S.DECODE_READ)
    return None if idle is None else R.per(r, idle, "decode_steps", 1e3)
