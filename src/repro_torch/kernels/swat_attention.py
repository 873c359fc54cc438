"""SWAT banded attention forward: the CUDA kernel's wrapper and its plain
version.

Port of the JAX package's `kernels/swat_attention.py` (the
`swat_attention_fwd` pallas_call): block-sparse flash attention in which
every q block visits only the kv blocks of `patterns.build_block_pattern`,
with the per-element mask of `element_mask` (band, global columns,
whole-block RANDOM slots, causality, kv bounds), GQA by `h // group`,
softcap, and the fp32 row logsumexp. The kernel source is
`repro_torch/csrc/swat_attention_fwd.cu`; the LSE is stored (B, H, L), not
in the TPU's 128-lane layout.

`swat_attention_fwd` launches a kernel for CUDA tensors and raises on
anything the kernel does not take. `route` picks the kernel from the dtype
and head dim: bf16 at head dim 64, 128 or 256 runs the tensor-core kernel
(`swat_attention_fwd_tc`), everything else the SIMT kernel
(`swat_attention_fwd`); each route counts its own launches. For CPU
(and meta) tensors, and only for them, it runs `banded_plain`, the torch twin of the
JAX package's `ops._xla_banded`.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from repro_torch.core import patterns
from repro_torch.core.types import AttentionSpec
from repro_torch.kernels import _build
from repro_torch.kernels import dots

NEG_INF = -1e30
HEAD_DIMS = (16, 32, 64, 128, 256)
TC_HEAD_DIMS = (64, 128, 256)
MAX_BLOCK_Q = 256   # one thread per query row (SIMT)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# launches of either route, and of each route alone
LAUNCHES = _build.LaunchCounter("swat_attention_fwd")
ROUTE_LAUNCHES = {r: _build.LaunchCounter(f"swat_attention_fwd.{r}")
                  for r in ("tc", "simt")}
_ENTRY = {"tc": "swat_attention_fwd_tc", "simt": "swat_attention_fwd"}


def route(dtype: torch.dtype, head_dim: int) -> str:
    """The forward kernel for (dtype, head dim): "tc" (tensor cores, bf16
    at head dim 64, 128 or 256) or "simt" (fp32 at any head dim, bf16 at
    16 or 32: the tensor cores would compute fp32 in TF32). Raises for a
    case no kernel takes."""
    if dtype not in _DTYPES or head_dim not in HEAD_DIMS:
        raise ValueError(f"swat_attention_fwd: no kernel for {dtype} at "
                         f"head dim {head_dim}")
    if dtype == torch.bfloat16 and head_dim in TC_HEAD_DIMS:
        return "tc"
    return "simt"


def _dense_plain(q, k, v, spec: AttentionSpec, scale: float,
                 return_lse: bool):
    """Plain masked attention (twin of `ops._xla_dense`; the running max is
    detached, as the twin's stop_gradient)."""
    b, hq, lq, d = q.shape
    _, hkv, lkv, _ = k.shape
    group = hq // hkv
    qb = q.reshape(b, hkv, group, lq, d) * scale
    s = dots.einsum_f32("bhgld,bhkd->bhglk", qb, k)
    if spec.softcap:
        s = spec.softcap * torch.tanh(s / spec.softcap)
    if spec.causal:
        mask = (torch.arange(lkv, device=q.device)[None, :]
                <= torch.arange(lq, device=q.device)[:, None])
        s = torch.where(mask, s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True).detach()
    p = torch.exp(s - m)
    den = torch.clamp(p.sum(-1, keepdim=True), min=1e-30)
    o = dots.einsum_f32("bhglk,bhkd->bhgld", (p / den).to(v.dtype), v)
    o = o.reshape(b, hq, lq, d).to(q.dtype)
    if return_lse:
        return o, (m + torch.log(den)).reshape(b, hq, lq)
    return o


def slot_mask(spec: AttentionSpec, pattern: patterns.BlockPattern,
              device, *, q_offset: int = 0, kv_offset: int = 0,
              bound: int):
    """The gathered kv rows of every q block and their visibility.

    Returns (flat, mask): flat (nq, num_slots*block_kv) int64 local kv row
    indices (the pattern's slot blocks, row by row) and mask (nq, block_q,
    num_slots*block_kv) bool, `element_mask` in global token coordinates
    (band, global columns, RANDOM slots, causality, kv bounds) with PAD
    slots masked."""
    bq, bk = pattern.block_q, pattern.block_kv
    nq, ns = pattern.num_q_blocks, pattern.num_slots
    kv_map = torch.as_tensor(pattern.kv_block_map, device=device).long()
    kinds = torch.as_tensor(pattern.slot_kinds, device=device)
    flat = (kv_map[:, :, None] * bk
            + torch.arange(bk, device=device)[None, None, :]
            ).reshape(nq, ns * bk)
    q_idx = (q_offset + torch.arange(nq, device=device)[:, None] * bq
             + torch.arange(bq, device=device)[None, :])[:, :, None]
    k_idx = (kv_offset + flat)[:, None, :]                       # (nq,1,S)
    full = kinds.repeat_interleave(bk, dim=1)[:, None, :]        # (nq,1,S)
    mask = (k_idx >= 0) & (k_idx < bound) & (full != patterns.PAD)
    if spec.is_sparse:
        band = k_idx >= q_idx - spec.window
        if not spec.causal:
            band = band & (k_idx <= q_idx + spec.window)
        allowed = band
        if spec.num_global:
            allowed = allowed | (k_idx < spec.num_global)
        if spec.num_random:
            allowed = allowed | (full == patterns.RANDOM)
        mask = mask & allowed
    if spec.causal:
        mask = mask & (k_idx <= q_idx)
    return flat, mask


def banded_plain(q, k, v, spec: AttentionSpec, pattern: patterns.BlockPattern,
                 scale: float, *, return_lse: bool = False,
                 q_offset: int = 0, kv_offset: int = 0,
                 seq_kv_bound: Optional[int] = None):
    """Exact-band attention, vectorised: every q block gathers only its
    slot kv blocks (twin of `ops._xla_banded`). Masks use global token
    coordinates (q_offset / kv_offset / seq_kv_bound, as the kernel does);
    K/V rows past the buffer read as zeros. Returns O (B, Hq, Lq, D), and
    the fp32 row LSE (B, Hq, Lq) with return_lse. Differentiable (the
    running max is detached, as the JAX twin's stop_gradient)."""
    b, hq, lq, d = q.shape
    _, hkv, lkv, _ = k.shape
    bound = kv_offset + lkv if seq_kv_bound is None else seq_kv_bound
    plain_coords = q_offset == 0 and kv_offset == 0 and bound == lkv
    if not spec.is_sparse and plain_coords:
        return _dense_plain(q, k, v, spec, scale, return_lse)
    if (plain_coords and spec.num_random == 0 and spec.window >= lkv
            and (spec.causal or spec.window >= lq)):
        # degenerate window (w >= seq): the band covers everything; the
        # gather would duplicate the whole KV per q block
        return _dense_plain(q, k, v, spec, scale, return_lse)
    group = hq // hkv
    bq, bk = pattern.block_q, pattern.block_kv
    nq, ns = pattern.num_q_blocks, pattern.num_slots
    lq_pad, lkv_pad = nq * bq, pattern.num_kv_blocks * bk
    if lq_pad != lq:
        q = torch.nn.functional.pad(q, (0, 0, 0, lq_pad - lq))
    if lkv_pad != lkv:
        k = torch.nn.functional.pad(k, (0, 0, 0, lkv_pad - lkv))
        v = torch.nn.functional.pad(v, (0, 0, 0, lkv_pad - lkv))
    flat, mask = slot_mask(spec, pattern, q.device, q_offset=q_offset,
                           kv_offset=kv_offset, bound=bound)
    qb = q.reshape(b, hkv, group, nq, bq, d)
    kg = k[:, :, flat.reshape(-1)].reshape(b, hkv, nq, ns * bk, d)
    vg = v[:, :, flat.reshape(-1)].reshape(b, hkv, nq, ns * bk, d)
    s = dots.einsum_f32("bhgnqd,bhnkd->bhgnqk", qb * scale, kg)
    if spec.softcap:
        s = spec.softcap * torch.tanh(s / spec.softcap)
    mask = mask[None, None, None]
    s = torch.where(mask, s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True).detach()
    p = torch.where(mask, torch.exp(s - m), 0.0)
    den = torch.clamp(p.sum(-1, keepdim=True), min=1e-30)
    o = dots.einsum_f32("bhgnqk,bhnkd->bhgnqd", (p / den).to(v.dtype), vg)
    o = o.to(q.dtype).reshape(b, hq, lq_pad, d)[:, :, :lq]
    if return_lse:
        lse = (m + torch.log(den)).reshape(b, hq, lq_pad)[:, :, :lq]
        return o, lse
    return o


@functools.lru_cache(maxsize=256)
def _pattern_tensors(pattern: patterns.BlockPattern, device: torch.device):
    """The pattern's block map and slot kinds as int32 device tensors,
    uploaded once per (pattern, device). Patterns hash by identity and
    `ops.get_pattern` caches them per shape, so this is one upload per
    shape."""
    return (torch.as_tensor(pattern.kv_block_map, dtype=torch.int32,
                            device=device).contiguous(),
            torch.as_tensor(pattern.slot_kinds, dtype=torch.int32,
                            device=device).contiguous())


def _check(q, k, v, pattern, fn: str = "swat_attention_fwd"):
    dev = q.device
    for arg, t in dict(q=q, k=k, v=v).items():
        if t.device != dev:
            raise ValueError(f"{fn}: {arg} on {t.device}, "
                             f"q on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{fn}: {arg} must be "
                             "contiguous")
        if t.dtype != q.dtype:
            raise TypeError(f"{fn}: {arg} is {t.dtype}, "
                            f"q is {q.dtype}")
    if q.dtype not in _DTYPES:
        raise TypeError(f"{fn}: dtype {q.dtype} not supported "
                        "(float32 or bfloat16)")
    b, hq, lq, d = q.shape
    if k.dim() != 4 or k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"{fn}: k shape {tuple(k.shape)} vs "
                         f"q {tuple(q.shape)}")
    if v.shape != k.shape:
        raise ValueError(f"{fn}: k and v shapes differ")
    if hq % k.shape[1]:
        raise ValueError(f"{fn}: {hq} q heads vs "
                         f"{k.shape[1]} kv heads")
    if d not in HEAD_DIMS:
        raise ValueError(f"{fn}: head dim {d} not in "
                         f"{HEAD_DIMS}")
    if pattern.block_q > MAX_BLOCK_Q:
        raise ValueError(f"{fn}: block_q {pattern.block_q} > "
                         f"{MAX_BLOCK_Q}")
    if pattern.num_q_blocks * pattern.block_q < lq:
        raise ValueError(f"{fn}: pattern does not cover q")


def swat_attention_fwd(q, k, v, spec: AttentionSpec, *,
                       pattern: Optional[patterns.BlockPattern] = None,
                       block_q: int = 128, block_kv: int = 128,
                       scale: Optional[float] = None,
                       return_lse: bool = False,
                       q_offset: int = 0, kv_offset: int = 0,
                       seq_kv_bound: Optional[int] = None):
    """q: (B, Hq, Lq, D); k, v: (B, Hkv, Lkv, D). Returns (B, Hq, Lq, D)
    (and the fp32 row logsumexp (B, Hq, Lq) with return_lse).

    q_offset / kv_offset: global token coordinates of q[..., 0, :] /
    k[..., 0, :]; seq_kv_bound: the global kv length (defaults to
    kv_offset + Lkv)."""
    _, hq, lq, d = q.shape
    lkv = k.shape[2]
    scale = float(d ** -0.5 if scale is None else scale)
    if pattern is None:
        pattern = patterns.build_block_pattern(
            spec, lq, lkv, block_q, block_kv, q_shift=q_offset - kv_offset)
    bound = kv_offset + lkv if seq_kv_bound is None else seq_kv_bound
    if q.device.type in _build.PLAIN_DEVICES:
        return banded_plain(q, k, v, spec, pattern, scale,
                            return_lse=return_lse, q_offset=q_offset,
                            kv_offset=kv_offset, seq_kv_bound=bound)
    if q.device.type != "cuda":
        raise ValueError(f"swat_attention_fwd: no kernel for {q.device}")
    _check(q, k, v, pattern)
    b, _, _, _ = q.shape
    hkv = k.shape[1]
    kv_map, kinds = _pattern_tensors(pattern, q.device)
    out = torch.empty_like(q)
    lse = torch.empty((b, hq, lq), dtype=torch.float32, device=q.device)
    which = route(q.dtype, d)
    if which == "tc":
        for arg, t in dict(q=q, k=k, v=v).items():
            if t.data_ptr() % 16:   # 16-byte cp.async rows
                raise ValueError(f"swat_attention_fwd: {arg} is not "
                                 "16-byte aligned")
    fn = _kernel(_ENTRY[which])
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        status = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                    kv_map.data_ptr(), kinds.data_ptr(), out.data_ptr(),
                    lse.data_ptr(), b, hq, hkv, lq, lkv, d,
                    pattern.num_q_blocks, pattern.num_slots, pattern.block_q,
                    pattern.block_kv, int(spec.is_sparse), int(spec.window),
                    int(spec.causal), int(spec.num_global),
                    int(spec.num_random), int(q_offset), int(kv_offset),
                    int(bound), scale, float(spec.softcap),
                    _DTYPES[q.dtype], stream)
    LAUNCHES.n += 1
    ROUTE_LAUNCHES[which].n += 1
    _build.check_status(_ENTRY[which], status)
    return (out, lse) if return_lse else out


def _kernel(name: str = "swat_attention_fwd"):
    fn = getattr(_build.load("swat_attention_fwd"), name)
    if fn.argtypes is None:
        vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn.argtypes = [vp] * 7 + [ci] * 18 + [cf, cf, ci, vp]
        fn.restype = ctypes.c_int
    return fn
