"""A frozen copy of the port's synthetic LM data
(`repro_torch/data/pipeline.py`: `DataConfig`, `SyntheticLM`), so the
benchmark makes its training batches itself: Zipf unigrams over the
vocabulary with copy spans (the second half of each 2 * copy_span block
repeats the first). batch(step) depends only on (seed, step).
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 1234
    zipf_alpha: float = 1.1
    copy_span: int = 32


class SyntheticLM:
    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        ranks = np.arange(1, cfg.vocab_size + 1, dtype=np.float64)
        probs = ranks ** (-cfg.zipf_alpha)
        self._probs = probs / probs.sum()

    def global_batch(self, step: int) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        rng = np.random.RandomState(
            np.uint32((cfg.seed * 1_000_003 + step) % (2**31 - 1)))
        b, l = cfg.global_batch, cfg.seq_len
        toks = rng.choice(cfg.vocab_size, size=(b, l),
                          p=self._probs).astype(np.int32)
        span = cfg.copy_span
        for s in range(0, l - 2 * span + 1, 4 * span):
            toks[:, s + span:s + 2 * span] = toks[:, s:s + span]
        return {"tokens": toks, "labels": toks.copy()}
