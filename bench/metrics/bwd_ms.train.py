"""Device ms per train step of train.backward (its CUDA events in the
program's span ring)."""
from bench import span_readers as S


def read(r):
    return S.device_ms(r, "train.backward")
