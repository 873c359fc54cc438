"""Device-idle ms per decode block inside the engine's host phases of the
block (engine.decode_block.stage, .launch, .hooks, .retire), over the
count of engine.decode_block ranges: the host's time between blocks."""
from bench import span_readers as S


def read(r):
    return S.idle_ms_per_range(r, S.DECODE_HOST, "engine.decode_block")
