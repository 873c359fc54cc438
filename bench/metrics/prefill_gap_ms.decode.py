"""Device-idle ms per admission batch inside the phases of engine.prefill
(upload, model, insert, read, hooks, retire), over the count of
engine.prefill ranges."""
from bench import span_readers as S


def read(r):
    return S.idle_ms_per_range(r, S.PREFILL_PHASES, "engine.prefill")
