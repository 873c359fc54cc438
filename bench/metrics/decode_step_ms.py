"""Host-clock decode-block time over decode steps (the engine tracer's
block records) in the traced window."""
from bench import readers as R


def read(r):
    if r.trace is None:
        return None
    return R.per(r, r.trace.work.get("decode_block_s", 0.0), "decode_steps",
                 1e3)
