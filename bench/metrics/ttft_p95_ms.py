"""95th percentile over the window's requests of the time from their
burst's submit to their first token."""
from bench import readers as R


def read(r):
    return R.percentile_ms(r.records.get("ttft_s", []), 95)
