"""Static block-sparsity patterns for window/global/random attention.

Host-side copy of the JAX package's `core/patterns.py` (pure numpy), kept
in the port so it imports nothing of that package.

The paper sets sparsity (window width, global token indices, random token
indices) as *synthesis-time parameters* of the FPGA design. Here it is a
host-side block pattern: for every q block we precompute (in numpy) the
exact list of kv blocks it touches, upload it to the device once, and the
banded CUDA kernel iterates only those.

Slot kinds:
  PAD    - unused slot (rectangular grid padding), fully masked
  BAND   - sliding-window block, per-element band mask applied in-kernel
  GLOBAL - global-column block (first g tokens), only kv-bounds mask
  RANDOM - BigBird random block, only kv-bounds mask
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np

from repro_torch.core.types import AttentionSpec

PAD, BAND, GLOBAL, RANDOM = 0, 1, 2, 3


@dataclasses.dataclass(frozen=True, eq=False)  # eq=False: hash by identity
class BlockPattern:
    """Rectangular block-sparse schedule for one (seq_q, seq_kv) problem.

    kv_block_map : (num_q_blocks, num_slots) int32 - kv block index per slot
                   (0 where PAD; masked out by slot_kinds).
    slot_kinds   : (num_q_blocks, num_slots) int32 - PAD/BAND/GLOBAL/RANDOM.
    """

    spec: AttentionSpec
    seq_q: int
    seq_kv: int
    block_q: int
    block_kv: int
    kv_block_map: np.ndarray
    slot_kinds: np.ndarray

    @property
    def num_q_blocks(self) -> int:
        return self.kv_block_map.shape[0]

    @property
    def num_slots(self) -> int:
        return self.kv_block_map.shape[1]

    @property
    def num_kv_blocks(self) -> int:
        return _cdiv(self.seq_kv, self.block_kv)

    def active_fraction(self) -> float:
        """Fraction of the dense (q_blocks x kv_blocks) grid actually visited
        -- the block-level compute saving vs dense attention."""
        active = int((self.slot_kinds != PAD).sum())
        return active / float(self.num_q_blocks * self.num_kv_blocks)

    def inverse(self) -> "InversePattern":
        """For the dK/dV backward kernel: per kv block, which q blocks touch
        it. Pure numpy inversion of kv_block_map."""
        nkv = self.num_kv_blocks
        buckets = [[] for _ in range(nkv)]
        kinds = [[] for _ in range(nkv)]
        for i in range(self.num_q_blocks):
            for s in range(self.num_slots):
                k = int(self.slot_kinds[i, s])
                if k == PAD:
                    continue
                j = int(self.kv_block_map[i, s])
                buckets[j].append(i)
                kinds[j].append(k)
        width = max(1, max(len(b) for b in buckets))
        q_map = np.zeros((nkv, width), np.int32)
        q_kinds = np.full((nkv, width), PAD, np.int32)
        for j in range(nkv):
            q_map[j, : len(buckets[j])] = buckets[j]
            q_kinds[j, : len(kinds[j])] = kinds[j]
        return InversePattern(q_block_map=q_map, slot_kinds=q_kinds)


@dataclasses.dataclass(frozen=True, eq=False)
class InversePattern:
    q_block_map: np.ndarray   # (num_kv_blocks, num_q_slots)
    slot_kinds: np.ndarray    # (num_kv_blocks, num_q_slots)

    @property
    def num_slots(self) -> int:
        return self.q_block_map.shape[1]


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def band_block_range(spec: AttentionSpec, q_block: int, block_q: int,
                     block_kv: int, seq_kv: int,
                     q_shift: int = 0) -> Tuple[int, int]:
    """Inclusive [lo, hi] kv-block range intersecting the band of q block i.

    q_shift: constant local-coordinate shift between q and kv rows (context
    parallelism: q row i aligns with LOCAL kv row i + q_shift because the kv
    buffer is prefixed by the halo received from the left neighbour)."""
    q_lo = q_block * block_q + q_shift
    q_hi = q_lo + block_q - 1
    lo_tok = max(0, q_lo - spec.window)
    hi_tok = q_hi if spec.causal else q_hi + spec.window
    hi_tok = min(seq_kv - 1, hi_tok)
    if lo_tok > hi_tok:  # band entirely outside this kv buffer
        return 0, -1
    return lo_tok // block_kv, min(hi_tok // block_kv,
                                   _cdiv(seq_kv, block_kv) - 1)


def build_block_pattern(spec: AttentionSpec, seq_q: int, seq_kv: int,
                        block_q: int, block_kv: int,
                        q_shift: int = 0) -> BlockPattern:
    """Compute the rectangular block schedule for `spec`.

    Dense specs get the full kv range (the same kernels then implement vanilla
    flash attention -- used for the paper's dense baseline and for gemma2
    global layers)."""
    nq = _cdiv(seq_q, block_q)
    nkv = _cdiv(seq_kv, block_kv)

    if not spec.is_sparse:
        if spec.causal and seq_q == seq_kv:
            rows = []
            for i in range(nq):
                hi = ((i + 1) * block_q - 1) // block_kv
                rows.append([(j, BAND) for j in range(min(hi, nkv - 1) + 1)])
        else:
            rows = [[(j, GLOBAL) for j in range(nkv)] for _ in range(nq)]
        return _pack(spec, seq_q, seq_kv, block_q, block_kv, rows)

    n_global_blocks = _cdiv(spec.num_global, block_kv) if spec.num_global else 0
    rng = np.random.RandomState(spec.random_seed)

    rows = []
    for i in range(nq):
        slots = []
        taken = set()
        # global columns first (paper: dedicated pinned attention cores)
        for j in range(min(n_global_blocks, nkv)):
            slots.append((j, GLOBAL))
            taken.add(j)
        lo, hi = band_block_range(spec, i, block_q, block_kv, seq_kv, q_shift)
        for j in range(lo, hi + 1):
            if j not in taken:
                slots.append((j, BAND))
                taken.add(j)
        if spec.num_random:
            candidates = [j for j in range(nkv) if j not in taken]
            if spec.causal:  # random blocks must stay in the visible prefix
                hi_vis = ((i + 1) * block_q - 1) // block_kv
                candidates = [j for j in candidates if j <= hi_vis]
            rng_pick = rng.permutation(len(candidates))[: spec.num_random]
            for idx in sorted(rng_pick):
                slots.append((candidates[idx], RANDOM))
        rows.append(slots)
    return _pack(spec, seq_q, seq_kv, block_q, block_kv, rows)


def _pack(spec, seq_q, seq_kv, block_q, block_kv, rows) -> BlockPattern:
    num_slots = max(len(r) for r in rows)
    nq = len(rows)
    kv_map = np.zeros((nq, num_slots), np.int32)
    kinds = np.full((nq, num_slots), PAD, np.int32)
    for i, r in enumerate(rows):
        for s, (j, kind) in enumerate(r):
            kv_map[i, s] = j
            kinds[i, s] = kind
    return BlockPattern(spec=spec, seq_q=seq_q, seq_kv=seq_kv,
                        block_q=block_q, block_kv=block_kv,
                        kv_block_map=kv_map, slot_kinds=kinds)


def dense_mask(spec: AttentionSpec, seq_q: int, seq_kv: int,
               q_offset: int = 0) -> np.ndarray:
    """O(N^2) boolean mask — the oracle the kernels are tested against.
    mask[i, j] True where q token (i + q_offset) may attend kv token j."""
    i = np.arange(seq_q)[:, None] + q_offset
    j = np.arange(seq_kv)[None, :]
    if not spec.is_sparse:
        return (j <= i) if spec.causal else np.ones((seq_q, seq_kv), bool)
    band = (j >= i - spec.window)
    if not spec.causal:
        band = band & (j <= i + spec.window)
    m = band
    if spec.num_global:
        g = spec.num_global
        m = m | (j < g) | (i < g)  # global cols + global rows
    if spec.causal:
        m = m & (j <= i)
    return m


def random_blocks_mask(pattern: BlockPattern) -> np.ndarray:
    """Adds the pattern's RANDOM blocks to dense_mask (block granularity is
    part of the spec, so the oracle derives it from the pattern itself)."""
    m = dense_mask(pattern.spec, pattern.seq_q, pattern.seq_kv)
    bq, bk = pattern.block_q, pattern.block_kv
    i_tok = np.arange(pattern.seq_q)[:, None]
    for i in range(pattern.num_q_blocks):
        for s in range(pattern.num_slots):
            if pattern.slot_kinds[i, s] == RANDOM:
                j = pattern.kv_block_map[i, s]
                rows = slice(i * bq, min((i + 1) * bq, pattern.seq_q))
                cols = slice(j * bk, min((j + 1) * bk, pattern.seq_kv))
                blk = np.ones((rows.stop - rows.start, cols.stop - cols.start),
                              bool)
                if pattern.spec.causal:
                    blk &= (np.arange(cols.start, cols.stop)[None, :]
                            <= i_tok[rows, :])
                m[rows, cols] |= blk
    return m


def sliding_chunks_flops_ratio(seq_len: int, window: int) -> float:
    """Paper §1: redundant-FLOP ratio of the sliding-chunks baseline,
    1/2 - 1/(4|chunks|). Used by benchmarks/fig2."""
    n_chunks = max(1, seq_len // (2 * window))
    return 0.5 - 1.0 / (4.0 * n_chunks)
