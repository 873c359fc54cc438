"""Public attention ops (the port of the JAX package's `kernels/ops.py`).

Implementations (impl=):
  kernel  - the hand-written CUDA kernels (`swat_attention.py`,
            `swat_backward.py`, `swat_decode.py`). For CUDA tensors they
            launch the kernel or raise; for CPU tensors the wrappers run
            their plain versions. `swat_attention` goes through
            `_SwatAttentionFn`, whose backward is the dQ and dK/dV kernels.
            The default for CUDA tensors.
  banded  - the plain exact-band PyTorch version (twin of the JAX
            package's `_xla_banded`), differentiated by autograd. The
            default for CPU tensors.
  ref     - O(N^2) masked reference (tests, tiny shapes), differentiated by
            autograd.

"banded" and "ref" run wherever their tensors lie; a caller names them
explicitly to hold the kernel path against the plain path (the CPU tests,
chip_smoke.py's end-to-end phase). The engine and the launcher never pass
`impl`, so on the card they always run the kernels.

Global tokens (Longformer) are composed here as in the JAX package: the
band+global-column pass covers every non-global row; a second dense pass
over the first g rows replaces their output. Gradients flow through both
passes.

`prefill_chunk_attention` is a prefill chunk's attention against the ring
cache: on the card the banded forward with offsets over the ring tail
gathered into token order, and a second launch over the pinned globals,
merged by their LSEs; its plain version is the JAX package's expression.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import torch

from repro_torch.core import patterns
from repro_torch.core.types import AttentionSpec
from repro_torch.kernels import dots
from repro_torch.kernels import ref as ref_impl
from repro_torch.kernels import swat_attention as fwd_mod
from repro_torch.kernels import swat_backward as bwd_mod
from repro_torch.kernels import swat_decode as dec_mod

NEG_INF = fwd_mod.NEG_INF
IMPLS = ("kernel", "banded", "ref")


@functools.lru_cache(maxsize=512)
def get_pattern(spec: AttentionSpec, seq_q: int, seq_kv: int,
                block_q: int, block_kv: int,
                q_shift: int = 0) -> patterns.BlockPattern:
    """The block pattern, built once per (spec, shape, q_shift) on the host.
    q_shift: q_offset - kv_offset of a call with offsets (a prefill chunk)."""
    return patterns.build_block_pattern(spec, seq_q, seq_kv, block_q,
                                        block_kv, q_shift=q_shift)


def default_impl(t: torch.Tensor) -> str:
    """"kernel" for CUDA tensors, "banded" for CPU tensors."""
    return "kernel" if t.is_cuda else "banded"


def _resolve(impl: Optional[str], t: torch.Tensor) -> str:
    impl = default_impl(t) if impl is None else impl
    if impl not in IMPLS:
        raise ValueError(f"impl={impl!r}; expected one of {IMPLS}")
    return impl


class _SwatAttentionFn(torch.autograd.Function):
    """One banded-attention pass with a hand-written backward (the port of
    the JAX package's `_pallas_attention` custom VJP). Forward: the banded
    forward with its row LSE; q, k, v, O and the LSE are saved. Backward:
    `swat_attention_bwd` (the dQ and dK/dV kernels on CUDA tensors, their
    plain version on CPU tensors). spec, pattern and scale get no
    gradient."""

    @staticmethod
    def forward(ctx, q, k, v, spec, pattern, scale):
        out, lse = fwd_mod.swat_attention_fwd(q, k, v, spec, pattern=pattern,
                                              scale=scale, return_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.spec, ctx.pattern, ctx.scale = spec, pattern, scale
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = bwd_mod.swat_attention_bwd(
            q, k, v, out, lse, do, ctx.spec, pattern=ctx.pattern,
            scale=ctx.scale)
        return dq, dk, dv, None, None, None


def swat_attention(q, k, v, spec: AttentionSpec, *,
                   block_q: int = 128, block_kv: int = 128,
                   scale: Optional[float] = None,
                   impl: Optional[str] = None) -> torch.Tensor:
    """Fused window/global/random attention. q: (B, Hq, Lq, D);
    k, v: (B, Hkv, Lkv, D). Differentiable for every impl."""
    lq, lkv, d = q.shape[2], k.shape[2], q.shape[3]
    scale = float(d ** -0.5 if scale is None else scale)
    impl = _resolve(impl, q)
    pat = get_pattern(spec, lq, lkv, block_q, block_kv)
    if impl == "ref":
        return ref_impl.attention_ref(q, k, v, spec, pattern=pat, scale=scale)

    def run(qq, sp, pp):
        if impl == "kernel":
            return _SwatAttentionFn.apply(qq, k, v, sp, pp, scale)
        return fwd_mod.banded_plain(qq, k, v, sp, pp, scale)

    out = run(q, spec, pat)
    g = spec.num_global
    if spec.is_sparse and g > 0:
        # dense pass for global rows (paper §4.1's pinned global cores)
        gspec = dataclasses.replace(spec, kind="dense", window=0,
                                    num_global=0, num_random=0)
        gpat = get_pattern(gspec, g, lkv, block_q, block_kv)
        og = run(q[:, :, :g].contiguous(), gspec, gpat)
        out = torch.cat([og, out[:, :, g:]], dim=2)
    return out


def _per_slot(x, b: int, device) -> torch.Tensor:
    """Scalar / (B,) / (B,1,1,1) spellings -> (B,) int32 on `device`."""
    x = torch.as_tensor(x, device=device).to(torch.int32)
    x = x.reshape(()) if x.numel() == 1 else x.reshape(b)
    return x.expand(b).contiguous()


def decode_attention(q, k_cache, v_cache, cache_len, spec: AttentionSpec, *,
                     scale: Optional[float] = None, impl: Optional[str] = None,
                     new_kv=None, num_new=None, pos=None,
                     ring_cap: Optional[int] = None):
    """Decode T >= 1 tokens vs a (ring) KV cache. q: (B, Hq, T, D); caches
    (B, Hkv, W, D). cache_len / pos / num_new are per-slot (scalar, (B,) or
    (B,1,1,1)). `ring_cap` is the LOGICAL rotation modulus (defaults to the
    cache width).

    * plain (new_kv=None): the cache already holds everything; `cache_len`
      is the valid count (or `pos` the absolute token count) and the query
      tokens are its newest. Returns out. impl "kernel" runs the plain-mode
      CUDA kernel (`swat_decode_plain`) with positional masks from
      pos = cache_len, as the JAX package's pallas impl does; the plain
      impls follow the JAX ref routing: positional masks for T > 1 or a
      ring wider than the band, else the valid-prefix mask. The JAX model
      calls this mode at its default impl="ref" (whisper's cross attention,
      `model.py:378`); the port sends it to the kernel on the card, where
      it runs no plain version.
    * fused (new_kv = (k_new, v_new), each (B, Hkv, T, D)): the step's K/V
      rows are inserted at their ring slots AND attended in the same call.
      `pos` (required) counts tokens BEFORE the insert; `num_new`
      optionally limits how many of the T rows are real per slot. Returns
      (out, k_cache, v_cache): the caches are the given tensors, updated
      IN PLACE for every impl (where the JAX engine donated them)."""
    b, _, t, _ = q.shape
    w_phys = k_cache.shape[2]
    cap = w_phys if ring_cap is None else int(ring_cap)
    g = spec.num_global if spec.is_sparse else 0
    impl = _resolve(impl, q)
    dev = q.device
    if new_kv is None:
        wide = bool(spec.is_sparse and spec.window
                    and cap > spec.window + 1 + g)
        if wide and pos is None:
            raise ValueError(
                "window masking on a cache wider than window+1+globals needs "
                "absolute per-slot `pos=` (cache_len is clamped and loses "
                "the ring phase after a wrap)")
        if cache_len is None and pos is None:
            raise ValueError("plain decode needs cache_len (valid prefix) or "
                             "pos (absolute token count)")
        cl = _per_slot(cache_len if cache_len is not None else 0, b, dev)
        pos = cl if pos is None else _per_slot(pos, b, dev)
        if impl == "kernel":
            return dec_mod.swat_decode_plain(q.contiguous(), k_cache,
                                             v_cache, pos, spec,
                                             ring_cap=cap, scale=scale)
        if t > 1 or wide:
            return dec_mod.swat_decode_plain_ref(q, k_cache, v_cache, pos,
                                                 spec, ring_cap=cap,
                                                 scale=scale)
        return ref_impl.decode_ref(q, k_cache, v_cache, spec, cache_len=cl,
                                   scale=scale)
    if pos is None:
        raise ValueError("fused insert needs per-slot `pos`")
    if t > cap - g:
        raise ValueError(
            f"{t} new tokens would overwrite each other in a {cap - g}-row "
            "ring: allocate the cache with lookahead >= T-1")
    if t > 1 and spec.is_sparse and spec.window and cap - g < spec.window + t:
        raise ValueError(
            f"T={t} fused decode on a {cap - g}-row ring would evict tokens "
            "still inside early queries' windows (sequential equivalence "
            "needs ring >= window + T): allocate with lookahead >= T-1")
    pos = _per_slot(pos, b, dev)
    nn = (torch.full((b,), t, dtype=torch.int32, device=dev)
          if num_new is None else _per_slot(num_new, b, dev))
    k_new, v_new = new_kv
    k_new = k_new.to(k_cache.dtype).contiguous()
    v_new = v_new.to(v_cache.dtype).contiguous()
    if impl == "kernel":
        out = dec_mod.swat_decode_fused(q.contiguous(), k_cache, v_cache,
                                        k_new, v_new, pos, nn, spec,
                                        ring_cap=cap, scale=scale)
        return out, k_cache, v_cache
    out, kn, vn = dec_mod.swat_decode_fused_plain(
        q, k_cache, v_cache, k_new, v_new, pos, nn, spec, ring_cap=cap,
        scale=scale)
    k_cache.copy_(kn)
    v_cache.copy_(vn)
    return out, k_cache, v_cache


def prefill_chunk_attention(q, k_new, v_new, k_cache, v_cache,
                            spec: AttentionSpec, pos0: int, lengths, *,
                            ring_cap: int, scale: Optional[float] = None,
                            impl: Optional[str] = None) -> torch.Tensor:
    """Attention of one prefill chunk: queries at tokens [pos0, pos0+T),
    every row at the same positions, against the ring cache (the tokens
    before pos0 that a band query can still see) plus the chunk itself.
    q: (B, Hq, T, D); k_new, v_new: (B, Hkv, T, D), roped; caches
    (B, Hkv, W, D) as they stand BEFORE the chunk's insert; lengths: (B,)
    real tokens per row; ring_cap: the logical ring capacity. Causal specs
    only; random blocks are not part of the function (the JAX package's
    `attention_prefill_chunk` has none). Returns (B, Hq, T, D). Outputs at
    positions >= a row's length are garbage the caller drops.

    impl "kernel" (the default for CUDA tensors) runs `_chunk_route`, the
    banded forward with offsets; "banded" and "ref" (the default for CPU
    tensors) run `_chunk_plain`, the JAX function's expression."""
    if not spec.causal:
        raise ValueError("prefill chunks need a causal spec")
    scale = float(q.shape[-1] ** -0.5 if scale is None else scale)
    if _resolve(impl, q) == "kernel":
        return _chunk_route(q, k_new, v_new, k_cache, v_cache, spec,
                            int(pos0), ring_cap, scale)
    return _chunk_plain(q, k_new, v_new, k_cache, v_cache, spec, int(pos0),
                        lengths, ring_cap, scale)


def _chunk_plain(q, k_new, v_new, k_cache, v_cache, spec: AttentionSpec,
                 pos0: int, lengths, cap: int, scale: float):
    """One fp32 softmax over (T, cap+T) scores: the twin of the attention
    in the JAX package's `layers.attention_prefill_chunk`. Every cache slot
    gets the token it holds just before the chunk (pinned slot s holds
    token s; ring slot r the newest token < pos0 congruent to r), so band,
    global and per-row length masks are positional."""
    b, hq, t, d = q.shape
    hkv, cap_phys = k_cache.shape[1], k_cache.shape[2]
    dev = q.device
    g = spec.num_global if spec.is_sparse else 0
    ring = cap - g
    w = spec.window if spec.is_sparse else cap + t      # dense: no band
    lens = lengths.to(device=dev, dtype=torch.long)
    pos = pos0 + torch.arange(t, device=dev)
    s_idx = torch.arange(cap_phys, device=dev)
    r = s_idx - g
    t_ring = (pos0 - 1) - torch.remainder((pos0 - 1 - g) - r, ring)
    slot_pos = torch.where(s_idx < g, s_idx, t_ring)
    occupied = torch.where(s_idx < g, pos0 > s_idx,
                           (pos0 > g + r) & (t_ring >= g)) & (s_idx < cap)
    live = occupied[None, :] & (slot_pos[None, :] < lens[:, None])  # (B,W)
    allow_c = ((s_idx[None, :] < g)
               | (slot_pos[None, :] >= pos[:, None] - w)
               | (pos[:, None] < g))                             # (T, W)
    mask_c = live[:, None, :] & allow_c[None]                    # (B, T, W)
    mask_s = ((pos[None, :] <= pos[:, None])
              & ((pos[None, :] >= pos[:, None] - w)
                 | (pos[None, :] < g) | (pos[:, None] < g)))     # (T, T)
    qg = (q.reshape(b, hkv, hq // hkv, t, d)
          * torch.tensor(scale, dtype=q.dtype, device=dev))
    s_c = dots.einsum_f32("bhgtd,bhcd->bhgtc", qg, k_cache)
    s_s = dots.einsum_f32("bhgtd,bhkd->bhgtk", qg, k_new)
    if spec.softcap:
        s_c = spec.softcap * torch.tanh(s_c / spec.softcap)
        s_s = spec.softcap * torch.tanh(s_s / spec.softcap)
    mask = torch.cat([mask_c[:, None, None].expand(s_c.shape),
                      mask_s[None, None, None].expand(s_s.shape)], dim=-1)
    s_all = torch.where(mask, torch.cat([s_c, s_s], dim=-1), NEG_INF)
    m = s_all.amax(dim=-1, keepdim=True)
    p = torch.where(mask, torch.exp(s_all - m), 0.0)
    den = torch.clamp(p.sum(-1, keepdim=True), min=1e-30)
    v_all = torch.cat([v_cache, v_new.to(v_cache.dtype)], dim=2)
    o = dots.einsum_f32("bhgtk,bhkd->bhgtd", (p / den).to(v_all.dtype),
                        v_all)
    return o.reshape(b, hq, t, d).to(q.dtype)


def _chunk_route(q, k_new, v_new, k_cache, v_cache, spec: AttentionSpec,
                 pos0: int, cap: int, scale: float):
    """The chunk's attention through the banded forward (#2), in two passes
    merged by their row LSEs.

    pos0 is shared by every row, so every earlier token sits in the same
    ring slot in every row. Pass A: the ring tail gathered into token order,
    positions [lo, pos0) with lo = max(g, pos0 - ring) (empty, lo = pos0,
    while pos0 < g), then the chunk; one launch with q_offset = pos0,
    kv_offset = lo, seq_kv_bound = pos0 + T and the layer's spec. The ring
    holds no position below g, and ring >= window + 1, so every band key of
    a chunk query lies in [lo, q]. Pass B (sparse specs, pos0 > 0): the
    min(pos0, g) pinned global rows, every key visible to every query (all
    lie before pos0). Dense layers take pass A alone, with g = 0. Rows
    shorter than pos0 + T attend slots they never wrote only from
    positions past their length, outputs the caller drops.

    On CPU tensors `swat_attention_fwd` runs `banded_plain` with the same
    offsets, so the CPU tests hold this algorithm too."""
    t = q.shape[2]
    dev = q.device
    g = spec.num_global if spec.is_sparse else 0
    ring = cap - g
    lo = max(g, pos0 - ring) if pos0 >= g else pos0
    tail = torch.arange(lo, pos0, device=dev)
    slots = g + torch.remainder(tail - g, ring)
    # torch.cat allocates: contiguous and 16-byte aligned, as the
    # tensor-core route's cp.async rows need
    k_buf = torch.cat([k_cache.index_select(2, slots),
                       k_new.to(k_cache.dtype)], dim=2)
    v_buf = torch.cat([v_cache.index_select(2, slots),
                       v_new.to(v_cache.dtype)], dim=2)
    band = dataclasses.replace(spec, num_random=0)
    lkv = k_buf.shape[2]
    out, lse = fwd_mod.swat_attention_fwd(
        q, k_buf, v_buf, band,
        pattern=get_pattern(band, t, lkv, 128, 128, q_shift=pos0 - lo),
        scale=scale, return_lse=True, q_offset=pos0, kv_offset=lo,
        seq_kv_bound=pos0 + t)
    ng = min(pos0, g)
    if not ng:
        return out
    pinned = AttentionSpec(kind="dense", causal=False, softcap=spec.softcap)
    out_g, lse_g = fwd_mod.swat_attention_fwd(
        q, k_cache[:, :, :ng].contiguous(), v_cache[:, :, :ng].contiguous(),
        pinned, pattern=get_pattern(pinned, t, ng, 128, 128), scale=scale,
        return_lse=True)
    # softmax over both key sets: pass A's share is exp(lse) / (exp(lse) +
    # exp(lse_g)) = sigmoid(lse - lse_g)
    share = torch.sigmoid(lse - lse_g)[..., None]
    return torch.lerp(out_g.float(), out.float(), share).to(q.dtype)
