"""The benchmark's one traffic generator: serving requests and training
batches from a cell's traffic parameters and the run's seed.

Sizes come from a fixed grid and the seed only orders them, so every seed
sends the same work: `lengths` spaces `n` values log-uniformly over
[lo, hi] at the midpoints of n equal quantiles, and each cycle of `cycle`
consecutive requests holds the whole grid once, in an order drawn from the
seed. Prompt tokens are uniform over the vocabulary. A training batch is
the port's synthetic language (`lm_data.SyntheticLM`), seeded by the run.
"""
from __future__ import annotations

import dataclasses
from typing import List

import numpy as np

from bench.traffic import lm_data

# independent streams of one seed
_PROMPT_LEN, _OUTPUT_LEN, _TOKENS, _SAMPLE = range(4)


def rng(seed: int, stream: int) -> np.random.Generator:
    return np.random.default_rng([int(seed), stream])


def grid(lo: int, hi: int, n: int) -> np.ndarray:
    """n lengths log-uniform over [lo, hi] at the quantile midpoints."""
    q = (np.arange(n) + 0.5) / n
    return np.rint(np.exp(np.log(lo) + q * (np.log(hi) - np.log(lo)))
                   ).astype(np.int64)


def cycled(values: np.ndarray, count: int, r: np.random.Generator
           ) -> np.ndarray:
    """`count` values: whole cycles of `values`, each in its own order."""
    cycles = -(-count // len(values))
    return np.concatenate([values[r.permutation(len(values))]
                           for _ in range(cycles)])[:count]


@dataclasses.dataclass
class Prompt:
    rid: int
    tokens: np.ndarray       # (L,) int32
    max_new_tokens: int


def serve_requests(traffic: dict, seed: int, vocab: int) -> List[Prompt]:
    """traffic: {"requests", "cycle", "prompt_len": [lo, hi],
    "output_len": [lo, hi]}. Output lengths count every generated token,
    the one sampled at prefill included."""
    n, cyc = traffic["requests"], traffic["cycle"]
    plen = cycled(grid(*traffic["prompt_len"], cyc), n,
                  rng(seed, _PROMPT_LEN))
    olen = cycled(grid(*traffic["output_len"], cyc), n,
                  rng(seed, _OUTPUT_LEN))
    tr = rng(seed, _TOKENS)
    return [Prompt(i, tr.integers(0, vocab, int(p), dtype=np.int32), int(o))
            for i, (p, o) in enumerate(zip(plen, olen))]


def sample(seed: int, population: List[int], k: int,
           always: List[int] = ()) -> List[int]:
    """k members of `population` drawn from the seed, `always` among
    them."""
    rest = [x for x in population if x not in set(always)]
    r = rng(seed, _SAMPLE)
    pick = list(r.permutation(rest)[:max(0, k - len(always))])
    return sorted(set(always) | {int(x) for x in pick})


def train_batches(traffic: dict, seed: int, vocab: int):
    """batch_fn(step) -> {"tokens", "labels"} (B, L) int32 numpy."""
    return lm_data.SyntheticLM(lm_data.DataConfig(
        vocab_size=vocab, seq_len=traffic["seq_len"],
        global_batch=traffic["batch"], seed=int(seed),
        zipf_alpha=traffic["zipf_alpha"],
        copy_span=traffic["copy_span"])).global_batch
