"""Deterministic synthetic LM data (a numpy-only copy of the JAX package's
`data/pipeline.py`, kept in the port so it imports nothing of that
package; its batches are bitwise the JAX package's).

A seeded token stream whose content is a learnable synthetic language
(Zipf unigrams plus copy spans), so training loss falls. batch(step) depends
only on (seed, step): a resumed run regenerates the identical stream.
Sharding a batch across devices belongs to the distributed slice.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 1234
    zipf_alpha: float = 1.1
    copy_span: int = 32         # induction-head fodder: repeated spans
    pad_id: int = -1


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
        # copy structure: second half of each span repeats the first half
        span = cfg.copy_span
        for s in range(0, l - 2 * span + 1, 4 * span):
            toks[:, s + span:s + 2 * span] = toks[:, s:s + span]
        return {"tokens": toks, "labels": toks.copy()}


def make_host_loader(cfg: DataConfig) -> Callable[[int], Dict[str,
                                                          np.ndarray]]:
    """Returns batch_fn(step) -> numpy global batch; the caller moves it to
    its device."""
    return SyntheticLM(cfg).global_batch
