"""90th percentile of (finish - first token) / (tokens - 1) over the
requests whose first token and finish both fall inside the window."""
from bench import readers as R


def read(r):
    return R.percentile_ms(r.records.get("tpot_s", []), 90)
