"""100 x (padded - real) / real prompt tokens of the traced window's
admission batches, from the counts of the engine.prefill.model spans."""
from bench import span_readers as S


def read(r):
    if r.trace is None or not r.trace.ops:
        return None
    recs = S.ring("engine.prefill.model")
    real = sum(s["counts"]["real_tokens"] for s in recs or [])
    if not real:
        return None
    padded = sum(s["counts"]["padded_tokens"] for s in recs)
    return 100.0 * (padded - real) / real
