"""Share of the traced window inside engine.prefill spans."""
from bench import readers as R


def read(r):
    return R.span_share_pct(r, "engine.prefill")
