"""SWAT banded attention backward: the CUDA kernels' wrappers and their plain
version.

Port of the JAX package's `kernels/swat_backward.py`: dQ over the forward
block pattern, and dK/dV over its inverse (per kv block, the q blocks that
touch it), both recomputing the scores in fp32 from the forward's row LSE,
with the softcap chain rule. The kernel source is
`repro_torch/csrc/swat_attention_bwd.cu` (`swat_attention_dq`,
`swat_attention_dkv`). Unlike the TPU kernels, dK/dV is produced per KV
head with the GQA group summed inside the kernel, and padded rows are
masked explicitly.

`swat_attention_bwd` launches both kernels for CUDA tensors and raises on
anything they do not take. For CPU tensors, and only for them, it runs
`swat_attention_bwd_plain`.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from repro_torch.core import patterns
from repro_torch.core.types import AttentionSpec
from repro_torch.kernels import _build
from repro_torch.kernels import swat_attention as fwd_mod

DQ_LAUNCHES = _build.LaunchCounter()
DKV_LAUNCHES = _build.LaunchCounter()
MAX_BLOCK_KV = 256   # one thread per kv row in dK/dV


def _pad_rows(x, n: int):
    """Zero-pad dim 2 of a (B, H, L[, D]) tensor to n rows."""
    extra = n - x.shape[2]
    if not extra:
        return x
    pad = (0, 0, 0, extra) if x.dim() == 4 else (0, extra)
    return torch.nn.functional.pad(x, pad)


def swat_attention_bwd_plain(q, k, v, o, lse, do, spec: AttentionSpec,
                             pattern: patterns.BlockPattern, scale: float,
                             q_offset: int = 0, kv_offset: int = 0,
                             seq_kv_bound: Optional[int] = None):
    """Plain PyTorch version: dQ, dK and dV written out explicitly (no
    autograd) from the kv blocks `banded_plain` gathers, in fp32. Per
    visible pair: p = exp(s - lse), dp = dO.V^T, ds = p (dp - delta) times
    the softcap chain 1 - t^2, dq = ds.K scale, dk = ds^T.Q scale,
    dv = p^T.dO; dK/dV are scattered back to their kv rows with index_add_
    (summing the GQA group and every q block that gathered the row).
    Returns (dq, dk, dv) in q's, k's and v's dtypes."""
    b, hq, lq, d = q.shape
    _, hkv, lkv, _ = k.shape
    group = hq // hkv
    bound = kv_offset + lkv if seq_kv_bound is None else seq_kv_bound
    bq, bk = pattern.block_q, pattern.block_kv
    nq, ns = pattern.num_q_blocks, pattern.num_slots
    lq_pad, lkv_pad = nq * bq, pattern.num_kv_blocks * bk
    delta = (do.float() * o.float()).sum(-1)
    flat, mask = fwd_mod.slot_mask(spec, pattern, q.device,
                                   q_offset=q_offset, kv_offset=kv_offset,
                                   bound=bound)
    rows = torch.arange(lq_pad, device=q.device).reshape(nq, bq, 1)
    mask = (mask & (rows < lq))[None, None, None]    # padded q rows: none
    qb = _pad_rows(q.float(), lq_pad).reshape(b, hkv, group, nq, bq, d)
    dob = _pad_rows(do.float(), lq_pad).reshape(b, hkv, group, nq, bq, d)
    lse_b = _pad_rows(lse.float(), lq_pad).reshape(b, hkv, group, nq, bq, 1)
    delta_b = _pad_rows(delta, lq_pad).reshape(b, hkv, group, nq, bq, 1)
    idx = flat.reshape(-1)
    kg = _pad_rows(k.float(), lkv_pad)[:, :, idx].reshape(b, hkv, nq,
                                                          ns * bk, d)
    vg = _pad_rows(v.float(), lkv_pad)[:, :, idx].reshape(b, hkv, nq,
                                                          ns * bk, d)
    s = torch.einsum("bhgnqd,bhnkd->bhgnqk", qb * scale, kg)
    chain = None
    if spec.softcap:
        t = torch.tanh(s / spec.softcap)
        s = spec.softcap * t
        chain = 1.0 - t * t
    p = torch.where(mask, torch.exp(s - lse_b), 0.0)
    dp = torch.einsum("bhgnqd,bhnkd->bhgnqk", dob, vg)
    ds = p * (dp - delta_b)
    if chain is not None:
        ds = ds * chain
    ds = torch.where(mask, ds, 0.0)
    dq = torch.einsum("bhgnqk,bhnkd->bhgnqd", ds, kg) * scale
    dkg = torch.einsum("bhgnqk,bhgnqd->bhnkd", ds, qb) * scale
    dvg = torch.einsum("bhgnqk,bhgnqd->bhnkd", p, dob)
    dk = torch.zeros((b, hkv, lkv_pad, d), device=q.device)
    dv = torch.zeros((b, hkv, lkv_pad, d), device=q.device)
    dk.index_add_(2, idx, dkg.reshape(b, hkv, nq * ns * bk, d))
    dv.index_add_(2, idx, dvg.reshape(b, hkv, nq * ns * bk, d))
    dq = dq.reshape(b, hq, lq_pad, d)[:, :, :lq]
    return (dq.to(q.dtype), dk[:, :, :lkv].to(k.dtype),
            dv[:, :, :lkv].to(v.dtype))


@functools.lru_cache(maxsize=256)
def _inverse_tensors(pattern: patterns.BlockPattern, device: torch.device):
    """The inverse pattern's q block map and slot kinds as int32 device
    tensors, built and uploaded once per (pattern, device)."""
    inv = pattern.inverse()
    return (torch.as_tensor(inv.q_block_map, dtype=torch.int32,
                            device=device).contiguous(),
            torch.as_tensor(inv.slot_kinds, dtype=torch.int32,
                            device=device).contiguous(),
            inv.num_slots)


def _check(q, k, v, o, lse, do, pattern):
    fwd_mod._check(q, k, v, pattern, fn="swat_attention_bwd")
    for arg, t in dict(o=o, do=do).items():
        if t.shape != q.shape or t.dtype != q.dtype or t.device != q.device:
            raise ValueError(f"swat_attention_bwd: {arg} is "
                             f"{tuple(t.shape)} {t.dtype} on {t.device}, q "
                             f"is {tuple(q.shape)} {q.dtype} on {q.device}")
    if (lse.shape != q.shape[:3] or lse.dtype != torch.float32
            or lse.device != q.device or not lse.is_contiguous()):
        raise ValueError("swat_attention_bwd: lse must be a contiguous fp32 "
                         f"(B, Hq, Lq) tensor on {q.device}")
    if pattern.block_kv > MAX_BLOCK_KV:
        raise ValueError(f"swat_attention_bwd: block_kv {pattern.block_kv} "
                         f"> {MAX_BLOCK_KV}")
    if pattern.num_kv_blocks * pattern.block_kv < k.shape[2]:
        raise ValueError("swat_attention_bwd: pattern does not cover kv")


def _spec_args(spec: AttentionSpec, q_offset: int, kv_offset: int,
               bound: int, scale: float):
    """The mask and score arguments both entry points take, in order."""
    return [int(spec.is_sparse), int(spec.window), int(spec.causal),
            int(spec.num_global), int(spec.num_random), int(q_offset),
            int(kv_offset), int(bound), scale, float(spec.softcap)]


def launch_dq(q, k, v, do, lse, delta, spec: AttentionSpec,
              pattern: patterns.BlockPattern, scale: float, *,
              q_offset: int = 0, kv_offset: int = 0, bound: int):
    """One launch of the dQ kernel on checked, contiguous CUDA tensors
    (delta = rowsum(dO * O), fp32 (B, Hq, Lq)). Returns dq."""
    b, hq, lq, d = q.shape
    hkv, lkv = k.shape[1], k.shape[2]
    kv_map, kinds = fwd_mod._pattern_tensors(pattern, q.device)
    dq = torch.empty_like(q)
    fn = _kernel("swat_attention_dq", 9)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        status = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                    lse.data_ptr(), delta.data_ptr(), kv_map.data_ptr(),
                    kinds.data_ptr(), dq.data_ptr(), b, hq, hkv, lq, lkv, d,
                    pattern.num_q_blocks, pattern.num_slots, pattern.block_q,
                    pattern.block_kv,
                    *_spec_args(spec, q_offset, kv_offset, bound, scale),
                    fwd_mod._DTYPES[q.dtype], stream)
    DQ_LAUNCHES.n += 1
    _build.check_status("swat_attention_dq", status)
    return dq


def launch_dkv(q, k, v, do, lse, delta, spec: AttentionSpec,
               pattern: patterns.BlockPattern, scale: float, *,
               q_offset: int = 0, kv_offset: int = 0, bound: int):
    """One launch of the dK/dV kernel on checked, contiguous CUDA tensors.
    Returns (dk, dv), (B, Hkv, Lkv, D), the GQA group summed."""
    b, hq, lq, d = q.shape
    hkv, lkv = k.shape[1], k.shape[2]
    q_map, ikinds, ninv = _inverse_tensors(pattern, q.device)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    fn = _kernel("swat_attention_dkv", 10)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        status = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                    lse.data_ptr(), delta.data_ptr(), q_map.data_ptr(),
                    ikinds.data_ptr(), dk.data_ptr(), dv.data_ptr(), b, hq,
                    hkv, lq, lkv, d, pattern.num_kv_blocks, ninv,
                    pattern.block_q, pattern.block_kv,
                    *_spec_args(spec, q_offset, kv_offset, bound, scale),
                    fwd_mod._DTYPES[q.dtype], stream)
    DKV_LAUNCHES.n += 1
    _build.check_status("swat_attention_dkv", status)
    return dk, dv


def swat_attention_bwd(q, k, v, o, lse, do, spec: AttentionSpec, *,
                       pattern: patterns.BlockPattern,
                       scale: Optional[float] = None,
                       q_offset: int = 0, kv_offset: int = 0,
                       seq_kv_bound: Optional[int] = None):
    """Returns (dq, dk, dv). q, o, do: (B, Hq, Lq, D); k, v: (B, Hkv, Lkv,
    D); lse: the forward's fp32 row LSE (B, Hq, Lq). Offsets: global token
    coordinates, as in the forward call. For CUDA tensors delta =
    rowsum(dO * O) is computed here in plain torch (as the JAX wrapper does
    outside its kernels), then the dQ kernel and the dK/dV kernel run."""
    d = q.shape[3]
    lkv = k.shape[2]
    scale = float(d ** -0.5 if scale is None else scale)
    bound = kv_offset + lkv if seq_kv_bound is None else seq_kv_bound
    if q.device.type == "cpu":
        return swat_attention_bwd_plain(q, k, v, o, lse, do, spec, pattern,
                                        scale, q_offset=q_offset,
                                        kv_offset=kv_offset,
                                        seq_kv_bound=bound)
    if q.device.type != "cuda":
        raise ValueError(f"swat_attention_bwd: no kernel for {q.device}")
    do = do.contiguous()
    _check(q, k, v, o, lse, do, pattern)
    delta = (do.float() * o.float()).sum(-1)
    kw = dict(q_offset=q_offset, kv_offset=kv_offset, bound=bound)
    dq = launch_dq(q, k, v, do, lse, delta, spec, pattern, scale, **kw)
    dk, dv = launch_dkv(q, k, v, do, lse, delta, spec, pattern, scale, **kw)
    return dq, dk, dv


def _kernel(name: str, n_ptrs: int):
    fn = getattr(_build.load("swat_attention_bwd"), name)
    if fn.argtypes is None:
        vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn.argtypes = [vp] * n_ptrs + [ci] * 18 + [cf, cf, ci, vp]
        fn.restype = ctypes.c_int
    return fn
