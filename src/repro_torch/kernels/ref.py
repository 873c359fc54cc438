"""Plain PyTorch oracles (the port of the JAX package's `kernels/ref.py`).

O(N^2) masked attention and the ring-cache arithmetic, written for clarity,
not speed. They are the CPU oracles of the port's tests, and the fused
decode kernel's plain version is built from `ring_insert_ref` and
`decode_ref`. Three attention references matter to the paper:

  attention_ref       - the standard 3-step QK / softmax / SV computation
  fused_attention_ref - the paper's Eq. 1 rewrite (exp, SV, divide at the
                        end); attention_ref == fused_attention_ref is the
                        paper's kernel-fusion correctness claim
  sliding_chunks_ref  - the HuggingFace Longformer schedule the paper
                        measures SWAT against (dense 2w-wide chunks, ~50%
                        redundant FLOPs): `ops.swat_attention`'s
                        impl="sliding_chunks", plain tensor code on
                        whichever device its tensors lie
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.core import patterns
from repro_torch.core.types import AttentionSpec
from repro_torch.kernels import dots


def _soft_cap(s: torch.Tensor, cap: float) -> torch.Tensor:
    return cap * torch.tanh(s / cap) if cap else s


def attention_ref(q, k, v, spec: AttentionSpec, *,
                  pattern: Optional[patterns.BlockPattern] = None,
                  scale: Optional[float] = None) -> torch.Tensor:
    """Masked softmax attention, standard 3-step form, fp32 math.

    q: (B, Hq, Lq, D), k/v: (B, Hkv, Lk, D). GQA by head repetition. The
    mask comes from the *pattern* when given (includes random blocks), else
    from the dense spec mask."""
    _, hq, lq, d = q.shape
    hkv = k.shape[1]
    scale = scale if scale is not None else d ** -0.5
    if hq != hkv:
        k = k.repeat_interleave(hq // hkv, dim=1)
        v = v.repeat_interleave(hq // hkv, dim=1)
    if pattern is not None:
        mask = patterns.random_blocks_mask(pattern)
    else:
        mask = patterns.dense_mask(spec, lq, k.shape[2])
    mask = torch.as_tensor(mask, device=q.device)[None, None]
    s = dots.einsum_f32("bhqd,bhkd->bhqk", q, k) * scale
    s = _soft_cap(s, spec.softcap)
    s = torch.where(mask, s, float("-inf"))
    p = torch.softmax(s, dim=-1)
    p = torch.where(mask, p, 0.0)  # rows with no valid kv produce 0, not NaN
    return torch.einsum("bhqk,bhkd->bhqd", p, v.float()).to(q.dtype)


def _repeat_kv(q, k, v):
    """GQA: repeat each kv head over its group of q heads."""
    hq, hkv = q.shape[1], k.shape[1]
    if hq == hkv:
        return k, v
    return (k.repeat_interleave(hq // hkv, dim=1),
            v.repeat_interleave(hq // hkv, dim=1))


def fused_attention_ref(q, k, v, spec: AttentionSpec, *,
                        pattern: Optional[patterns.BlockPattern] = None,
                        scale: Optional[float] = None,
                        stabilize: bool = True) -> torch.Tensor:
    """Paper Eq. 1: Z_i = (1/sum_l exp(S_il)) * sum_n exp(S_in) V_n, the
    denominator applied once at the end.

    stabilize=False is the paper's literal form (no max subtraction: it
    overflows for large |S|); stabilize=True subtracts the row max first
    (mathematically identical). Masks, GQA and softcap as attention_ref;
    a row with no valid key gives 0 (the 1e-30 floor)."""
    _, _, lq, d = q.shape
    scale = scale if scale is not None else d ** -0.5
    k, v = _repeat_kv(q, k, v)
    if pattern is not None:
        mask = patterns.random_blocks_mask(pattern)
    else:
        mask = patterns.dense_mask(spec, lq, k.shape[2])
    mask = torch.as_tensor(mask, device=q.device)[None, None]
    s = dots.einsum_f32("bhqd,bhkd->bhqk", q, k) * scale
    s = _soft_cap(s, spec.softcap)
    s = torch.where(mask, s, float("-inf"))
    if stabilize:
        m = s.amax(dim=-1, keepdim=True)
        m = torch.where(torch.isfinite(m), m, 0.0)
        e = torch.where(mask, torch.exp(s - m), 0.0)
    else:
        e = torch.where(mask, torch.exp(s), 0.0)
    num = torch.einsum("bhqk,bhkd->bhqd", e, v.float())
    den = e.sum(dim=-1, keepdim=True)
    return (num / den.clamp_min(1e-30)).to(q.dtype)


def sliding_chunks_ref(q, k, v, spec: AttentionSpec, *,
                       scale: Optional[float] = None) -> torch.Tensor:
    """HF Longformer "sliding chunks": the sequence cut into chunks of 2w,
    *dense* attention of every chunk against [previous, itself] (causal)
    or [previous, itself, next] (bidirectional), masked to the band
    afterwards; the zero-padded neighbours of the first and last chunk are
    masked too. The overlap is the paper's ~50% wasted FLOPs; the output
    equals attention_ref's with the band mask, only the schedule differs.
    fp32 math, returned in q's dtype.

    Needs seq divisible by 2w. Globals and random blocks are not applied
    (HF runs globals as a separate dense pass)."""
    assert spec.kind in ("swat", "sliding_chunks"), spec.kind
    w = spec.window
    c = 2 * w
    b, h, l, d = q.shape
    assert l % c == 0, f"sliding_chunks needs seq % {c} == 0, got {l}"
    k, v = _repeat_kv(q, k, v)
    scale = scale if scale is not None else d ** -0.5
    n = l // c
    qc, kc, vc = (x.float().reshape(b, h, n, c, d) for x in (q, k, v))

    def neigh(x, shift):  # the chunk at `shift`, zeros past the ends
        if shift == 0:
            return x
        pad = torch.zeros_like(x[:, :, :1])
        if shift == -1:
            return torch.cat([pad, x[:, :, :-1]], dim=2)
        return torch.cat([x[:, :, 1:], pad], dim=2)

    shifts = (-1, 0) if spec.causal else (-1, 0, 1)
    ks = torch.cat([neigh(kc, sh) for sh in shifts], dim=3)
    vs = torch.cat([neigh(vc, sh) for sh in shifts], dim=3)
    s = torch.einsum("bhncd,bhnkd->bhnck", qc, ks) * scale
    s = _soft_cap(s, spec.softcap)

    # the band in chunk coordinates, and the padded neighbours of the end
    # chunks
    q_idx = np.arange(c)[:, None]
    k_off = np.concatenate([np.arange(c) + sh * c for sh in shifts])[None]
    band = (k_off >= q_idx - w) & ((k_off <= q_idx) if spec.causal
                                   else (k_off <= q_idx + w))
    chunk = np.arange(n)[:, None, None]
    pad = (((k_off < 0)[None] & (chunk == 0))
           | ((k_off >= c)[None] & (chunk == n - 1)))
    mask = torch.as_tensor(band[None] & ~pad, device=q.device)[None, None]

    s = torch.where(mask, s, float("-inf"))
    p = torch.softmax(s, dim=-1)
    p = torch.where(mask, p, 0.0)
    out = torch.einsum("bhnck,bhnkd->bhncd", p, vs)
    return out.reshape(b, h, l, d).to(q.dtype)


def ring_slot_positions(total, wcap: int, *, ring_cap: int, num_global: int):
    """Which absolute token index each cache slot holds, given per-slot
    `total` (B,) tokens inserted so far. Pinned slot s (< num_global) holds
    token s; ring slot r holds the newest token congruent to r below
    `total`. Returns (positions (B, W) int64, valid (B, W) bool); slots in
    the tile-rounding tail [ring_cap, W) are never valid."""
    g, ring = num_global, ring_cap - num_global
    total = torch.as_tensor(total).reshape(-1, 1).long()
    s_idx = torch.arange(wcap, device=total.device)[None, :]
    last = total - 1
    t_ring = last - torch.remainder((last - g) - (s_idx - g), ring)
    t_s = torch.where(s_idx < g, s_idx, t_ring)
    valid = torch.where(s_idx < g, s_idx <= last, t_ring >= g)
    return t_s, valid & (s_idx < ring_cap)


def ring_insert_ref(cache, new, pos, num_new, *, ring_cap: int,
                    num_global: int) -> torch.Tensor:
    """Insert `new` (B, H, T, D) rows at their ring slots of `cache`
    (B, H, W, D): token pos+j -> slot g + (pos+j-g) mod ring (pinned below
    g); rows j >= num_new[b] are not written. Returns a new tensor (ascending
    j: last writer wins)."""
    b, _, wcap, _ = cache.shape
    t = new.shape[2]
    g, ring = num_global, ring_cap - num_global
    pos = torch.as_tensor(pos).reshape(b).long()
    num_new = torch.as_tensor(num_new).reshape(b).long()
    s_idx = torch.arange(wcap, device=cache.device)[None, :]
    for j in range(t):
        pj = pos + j
        slot = torch.where(pj < g, pj, g + torch.remainder(pj - g, ring))
        hit = ((s_idx == slot[:, None])
               & (j < num_new)[:, None])[:, None, :, None]
        cache = torch.where(hit, new[:, :, j:j + 1].to(cache.dtype), cache)
    return cache


def decode_ref(q, k_cache, v_cache, spec: AttentionSpec, *, total=None,
               q0=None, cache_len=None, scale: Optional[float] = None,
               ring_cap: Optional[int] = None) -> torch.Tensor:
    """Decode T query tokens against a (ring) cache. q: (B, Hq, T, D),
    caches: (B, Hkv, W, D). Two masking modes, as in the JAX oracle:

    * positional (total / q0 given, (B,) tokens in the cache and the first
      query's token index): every slot's absolute token index is rebuilt
      from the ring layout (`ring_slot_positions`) and query token q0+t
      sees a slot iff its token is causally past and within spec.window
      (globals always).
    * prefix (cache_len given, (B,) or scalar; T = 1 only): the first
      min(cache_len, W) slots are valid, with no window or causal terms.

    Scores and P.V accumulate in fp32; the probabilities are rounded to the
    cache dtype before P.V, as the JAX oracle does."""
    b, hq, t, d = q.shape
    hkv, wcap = k_cache.shape[1], k_cache.shape[2]
    group = hq // hkv
    scale = scale if scale is not None else d ** -0.5
    qg = q.reshape(b, hkv, group * t, d)
    s = dots.einsum_f32("bhrd,bhwd->bhrw", qg, k_cache) * scale
    s = _soft_cap(s, spec.softcap)
    dev = q.device
    if total is None:
        if t != 1:
            raise ValueError("multi-token decode_ref needs positional masks")
        cl = torch.as_tensor(cache_len, device=dev).reshape(-1, 1).long()
        vis = (torch.arange(wcap, device=dev)[None, :]
               < torch.clamp(cl, max=wcap))[:, None, :]     # (B, 1, W)
        vis = vis.expand(b, group * t, wcap)
    else:
        cap = wcap if ring_cap is None else ring_cap
        g = spec.num_global if spec.is_sparse else 0
        t_s, ok = ring_slot_positions(total, wcap, ring_cap=cap, num_global=g)
        trow = torch.arange(group * t, device=dev) % t
        qp = torch.as_tensor(q0, device=dev).reshape(b, 1).long() + trow[None]
        vis = ok[:, None, :]                                  # (B, G*T, W)
        if spec.causal:
            vis = vis & (t_s[:, None, :] <= qp[:, :, None])
        if spec.is_sparse and spec.window:
            keep = t_s[:, None, :] >= qp[:, :, None] - spec.window
            if g > 0:
                keep = keep | (torch.arange(wcap, device=dev) < g)[None, None]
            vis = vis & keep
    valid = vis[:, None]                                      # (B,1,G*T,W)
    s = torch.where(valid, s, float("-inf"))
    p = torch.softmax(s, dim=-1)
    p = torch.where(valid, p, 0.0)
    out = dots.einsum_f32("bhrw,bhwd->bhrd", p.to(v_cache.dtype), v_cache)
    return out.reshape(b, hq, t, d).to(q.dtype)
