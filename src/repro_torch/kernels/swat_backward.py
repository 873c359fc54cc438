"""SWAT banded attention backward: the CUDA kernels' wrappers and their plain
version.

Port of the JAX package's `kernels/swat_backward.py`: dQ over the forward
block pattern, and dK/dV over its inverse (per kv block, the q blocks that
touch it), both recomputing the scores in fp32 from the forward's row LSE,
with the softcap chain rule. The kernel source is
`repro_torch/csrc/swat_attention_bwd.cu` (`swat_attention_dq`,
`swat_attention_dq_tc`, `swat_attention_dkv`, `swat_attention_dkv_tc`,
`swat_attention_dkv_combine`). Unlike the TPU kernels, dK/dV is produced
per KV head with the GQA group summed inside the kernel, and padded rows
are masked explicitly.

Each gradient has two routes, chosen by `route` (also named `dq_route` and
`dkv_route`): bf16 at head dim 64, 128 or 256 runs the tensor-core kernels,
every other case the SIMT ones. Tensor-core dQ takes one CTA per 64 query
rows. Tensor-core dK/dV takes one CTA per 64 kv rows (at head dim 256 two
warpgroups share them, one accumulator each) over a chunk plan
(`dkv_plan`) that cuts the long inverse rows (kv block 0, which every q
block visits for its global columns) into chunks of at most the longest
other row; the chunks of a cut row write fp32 partials that a second
kernel sums in chunk order.

`swat_attention_bwd` launches the kernels for CUDA tensors and raises on
anything they do not take. For CPU (and meta) tensors, and only for them, it runs
`swat_attention_bwd_plain`.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Optional

import numpy as np
import torch

from repro_torch.core import patterns
from repro_torch.core.types import AttentionSpec
from repro_torch.kernels import _build
from repro_torch.kernels import swat_attention as fwd_mod

# dQ and dK/dV launches of either route, and of each route alone
DQ_LAUNCHES = _build.LaunchCounter("swat_attention_dq")
DQ_ROUTE_LAUNCHES = {r: _build.LaunchCounter(f"swat_attention_dq.{r}")
                     for r in ("tc", "simt")}
DKV_LAUNCHES = _build.LaunchCounter("swat_attention_dkv")
DKV_ROUTE_LAUNCHES = {r: _build.LaunchCounter(f"swat_attention_dkv.{r}")
                      for r in ("tc", "simt")}
# the split rows' sum
COMBINE_LAUNCHES = _build.LaunchCounter("swat_attention_dkv_combine")
MAX_BLOCK_KV = 256   # one thread per kv row in dK/dV (SIMT)


def route(dtype: torch.dtype, head_dim: int) -> str:
    """The route of both backward kernels, dQ and dK/dV, for (dtype, head
    dim): "tc" (tensor cores, bf16 at head dim 64, 128 or 256, as the
    forward's) or "simt" (fp32, which the tensor cores would compute in
    TF32, and bf16 at 16 and 32). Raises for a case no kernel takes."""
    if (dtype not in fwd_mod._DTYPES
            or head_dim not in fwd_mod.HEAD_DIMS):
        raise ValueError(f"swat_attention_bwd: no kernel for {dtype} at "
                         f"head dim {head_dim}")
    if dtype == torch.bfloat16 and head_dim in fwd_mod.TC_HEAD_DIMS:
        return "tc"
    return "simt"


dq_route = dkv_route = route


@dataclasses.dataclass(frozen=True)
class DkvPlan:
    """The tensor-core dK/dV kernel's work list over an inverse pattern.

    chunks  : (n_chunks, 4) int32 rows (kv block, first inverse slot, end
              slot, partial index or -1), in kv block and slot order; one
              CTA per chunk (and kv head, batch).
    combine : (n_combine, 3) int32 rows (kv block, first partial, partial
              count) for the kv blocks cut into several chunks, whose
              partials are summed in chunk order.
    cap     : the most slots a chunk holds.
    """
    chunks: np.ndarray
    combine: np.ndarray
    cap: int

    @property
    def n_parts(self) -> int:
        return int(self.combine[:, 2].sum())


def dkv_plan(inv: patterns.InversePattern) -> DkvPlan:
    """Cut every inverse row longer than the longest count of its non-GLOBAL
    slots (the band and random blocks; 3 at the llama train shape) into
    chunks of at most that many slots, in slot order. Without GLOBAL slots
    no row is cut. A row with no slot keeps one empty chunk, which writes
    zeros."""
    live = inv.slot_kinds != patterns.PAD
    lengths = live.sum(axis=1)
    local = (live & (inv.slot_kinds != patterns.GLOBAL)).sum(axis=1)
    cap = int(local.max()) if local.any() else int(lengths.max())
    cap = max(cap, 1)
    chunks, combine, n_parts = [], [], 0
    for j, n in enumerate(lengths.tolist()):
        if n <= cap:
            chunks.append((j, 0, n, -1))
            continue
        starts = list(range(0, n, cap))
        combine.append((j, n_parts, len(starts)))
        for c, s0 in enumerate(starts):
            chunks.append((j, s0, min(n, s0 + cap), n_parts + c))
        n_parts += len(starts)
    return DkvPlan(chunks=np.asarray(chunks, np.int32).reshape(-1, 4),
                   combine=np.asarray(combine, np.int32).reshape(-1, 3),
                   cap=cap)


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
                             seq_kv_bound: Optional[int] = None,
                             dlse=None):
    """Plain PyTorch version: dQ, dK and dV written out explicitly (no
    autograd) from the kv blocks `banded_plain` gathers, in fp32. Per
    visible pair: p = exp(s - lse), dp = dO.V^T, ds = p (dp - delta) times
    the softcap chain 1 - t^2, dq = ds.K scale, dk = ds^T.Q scale,
    dv = p^T.dO; dK/dV are scattered back to their kv rows with index_add_
    (summing the GQA group and every q block that gathered the row).
    delta = rowsum(dO * O), less `dlse` (B, Hq, Lq) where the row LSE is an
    output too (dLSE/ds = p). Returns (dq, dk, dv) in q's, k's and v's
    dtypes."""
    b, hq, lq, d = q.shape
    _, hkv, lkv, _ = k.shape
    group = hq // hkv
    bound = kv_offset + lkv if seq_kv_bound is None else seq_kv_bound
    bq, bk = pattern.block_q, pattern.block_kv
    nq, ns = pattern.num_q_blocks, pattern.num_slots
    lq_pad, lkv_pad = nq * bq, pattern.num_kv_blocks * bk
    delta = _delta(o, do, dlse)
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


def _delta(o, do, dlse=None):
    """rowsum(dO * O) in fp32, less the row LSE's cotangent when given."""
    delta = (do.float() * o.float()).sum(-1)
    return delta if dlse is None else delta - dlse.float()


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


@functools.lru_cache(maxsize=256)
def _plan_tensors(pattern: patterns.BlockPattern, device: torch.device):
    """The dK/dV chunk plan of the pattern's inverse, built on the host and
    uploaded as int32 device tensors once per (pattern, device)."""
    plan = dkv_plan(pattern.inverse())
    return (torch.as_tensor(plan.chunks, device=device).contiguous(),
            torch.as_tensor(plan.combine, device=device).contiguous(),
            plan.n_parts)


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


def _check_aligned(fn: str, **tensors) -> None:
    """The tensor-core kernels copy rows in 16-byte cp.async pieces."""
    for name, t in tensors.items():
        if t.data_ptr() % 16:
            raise ValueError(f"{fn}: {name} is not 16-byte aligned")


def launch_dq(q, k, v, do, lse, delta, spec: AttentionSpec,
              pattern: patterns.BlockPattern, scale: float, *,
              q_offset: int = 0, kv_offset: int = 0, bound: int):
    """One launch of the dQ kernel of `dq_route` on checked, contiguous
    CUDA tensors (delta = rowsum(dO * O), fp32 (B, Hq, Lq)). Returns dq."""
    b, hq, lq, d = q.shape
    hkv, lkv = k.shape[1], k.shape[2]
    route = dq_route(q.dtype, d)
    if route == "tc":
        _check_aligned("swat_attention_dq_tc", q=q, k=k, v=v, do=do)
    kv_map, kinds = fwd_mod._pattern_tensors(pattern, q.device)
    dq = torch.empty_like(q)
    name = "swat_attention_dq_tc" if route == "tc" else "swat_attention_dq"
    fn = _kernel(name, 9)
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
    DQ_ROUTE_LAUNCHES[route].n += 1
    _build.check_status(name, status)
    return dq


def launch_dkv(q, k, v, do, lse, delta, spec: AttentionSpec,
               pattern: patterns.BlockPattern, scale: float, *,
               q_offset: int = 0, kv_offset: int = 0, bound: int):
    """The dK/dV kernel of `dkv_route` on checked, contiguous CUDA tensors
    (on the tensor-core route, followed by `dkv_combine` where the plan cut
    a row). Returns (dk, dv), (B, Hkv, Lkv, D), the GQA group summed."""
    kw = dict(q_offset=q_offset, kv_offset=kv_offset, bound=bound)
    if dkv_route(q.dtype, q.shape[3]) == "simt":
        return _launch_dkv_simt(q, k, v, do, lse, delta, spec, pattern,
                                scale, **kw)
    dk, dv, part_k, part_v, combine = launch_dkv_tc(
        q, k, v, do, lse, delta, spec, pattern, scale, **kw)
    if combine.shape[0]:
        dkv_combine(part_k, part_v, combine, dk, dv)
    return dk, dv


def _launch_dkv_simt(q, k, v, do, lse, delta, spec, pattern, scale, *,
                     q_offset, kv_offset, bound):
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
    DKV_ROUTE_LAUNCHES["simt"].n += 1
    _build.check_status("swat_attention_dkv", status)
    return dk, dv


def launch_dkv_tc(q, k, v, do, lse, delta, spec: AttentionSpec,
                  pattern: patterns.BlockPattern, scale: float, *,
                  q_offset: int = 0, kv_offset: int = 0, bound: int):
    """One launch of the tensor-core dK/dV kernel (bf16, head dim 64, 128
    or 256) over the pattern's chunk plan. Returns (dk, dv, part_k, part_v,
    combine): the rows of kv blocks that the plan cut are not yet written
    in dk / dv; their fp32 partials (n_parts, B, Hkv, block_kv, D) and the
    plan's combine rows are what `dkv_combine` sums."""
    b, hq, lq, d = q.shape
    hkv, lkv = k.shape[1], k.shape[2]
    if dkv_route(q.dtype, d) != "tc":
        raise ValueError(f"swat_attention_dkv_tc: no kernel for {q.dtype} "
                         f"at head dim {d}")
    _check_aligned("swat_attention_dkv_tc", q=q, k=k, v=v, do=do)
    q_map, ikinds, ninv = _inverse_tensors(pattern, q.device)
    chunks, combine, n_parts = _plan_tensors(pattern, q.device)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    part_k = torch.empty((n_parts, b, hkv, pattern.block_kv, d),
                         dtype=torch.float32, device=q.device)
    part_v = torch.empty_like(part_k)
    fn = _kernel("swat_attention_dkv_tc", 13)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        status = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                    lse.data_ptr(), delta.data_ptr(), chunks.data_ptr(),
                    q_map.data_ptr(), ikinds.data_ptr(), dk.data_ptr(),
                    dv.data_ptr(), part_k.data_ptr(), part_v.data_ptr(), b,
                    hq, hkv, lq, lkv, d, chunks.shape[0], ninv,
                    pattern.block_q, pattern.block_kv,
                    *_spec_args(spec, q_offset, kv_offset, bound, scale),
                    fwd_mod._DTYPES[q.dtype], stream)
    DKV_LAUNCHES.n += 1
    DKV_ROUTE_LAUNCHES["tc"].n += 1
    _build.check_status("swat_attention_dkv_tc", status)
    return dk, dv, part_k, part_v, combine


def dkv_combine_plain(part_k, part_v, combine, dk, dv) -> None:
    """Plain version of `dkv_combine`: for every (kv block j, first partial,
    count) row of `combine`, the partials added one by one in chunk order
    (as the kernel adds them), cast and written into dk / dv's rows of
    block j, in place."""
    block_kv, lkv = part_k.shape[3], dk.shape[2]
    for j, p0, n in combine.tolist():
        rows = min(block_kv, lkv - j * block_kv)
        acc_k, acc_v = part_k[p0], part_v[p0]
        for p in range(p0 + 1, p0 + n):
            acc_k, acc_v = acc_k + part_k[p], acc_v + part_v[p]
        sl = slice(j * block_kv, j * block_kv + rows)
        dk[:, :, sl] = acc_k[:, :, :rows].to(dk.dtype)
        dv[:, :, sl] = acc_v[:, :, :rows].to(dv.dtype)


def dkv_combine(part_k, part_v, combine, dk, dv) -> None:
    """Writes the kv blocks that the chunk plan cut: the sum of their fp32
    partials (n_parts, B, Hkv, block_kv, D) in chunk order, cast to bf16,
    into dk / dv (B, Hkv, Lkv, D), in place. `combine`: int32 (n, 3) rows
    (kv block, first partial, partial count). Launches the combine kernel
    for CUDA tensors; for CPU tensors, and only for them, it runs
    `dkv_combine_plain` (which reads the combine table's values: no meta
    tensor reaches it, the plain backward has no combine)."""
    if dk.device.type == "cpu":
        return dkv_combine_plain(part_k, part_v, combine, dk, dv)
    if dk.device.type != "cuda":
        raise ValueError(f"swat_attention_dkv_combine: no kernel for "
                         f"{dk.device}")
    b, hkv, lkv, d = dk.shape
    for name, t in dict(part_k=part_k, part_v=part_v, combine=combine,
                        dk=dk, dv=dv).items():
        if t.device != dk.device or not t.is_contiguous():
            raise ValueError(f"swat_attention_dkv_combine: {name} must be "
                             f"contiguous on {dk.device}")
    if (dk.dtype != torch.bfloat16 or dv.dtype != torch.bfloat16
            or part_k.dtype != torch.float32 or part_v.shape != part_k.shape
            or combine.dtype != torch.int32 or dv.shape != dk.shape
            or part_k.shape[1:3] != (b, hkv) or part_k.shape[4] != d):
        raise ValueError("swat_attention_dkv_combine: bf16 dk/dv, fp32 "
                         "partials (n, B, Hkv, block_kv, D) and int32 "
                         "combine rows expected")
    with torch.cuda.device(dk.device):
        stream = torch.cuda.current_stream(dk.device).cuda_stream
        status = _combine_kernel()(
            part_k.data_ptr(), part_v.data_ptr(), combine.data_ptr(),
            dk.data_ptr(), dv.data_ptr(), b, hkv, lkv, d, combine.shape[0],
            part_k.shape[3], stream)
    COMBINE_LAUNCHES.n += 1
    _build.check_status("swat_attention_dkv_combine", status)


def swat_attention_bwd(q, k, v, o, lse, do, spec: AttentionSpec, *,
                       pattern: patterns.BlockPattern,
                       scale: Optional[float] = None,
                       q_offset: int = 0, kv_offset: int = 0,
                       seq_kv_bound: Optional[int] = None, dlse=None):
    """Returns (dq, dk, dv). q, o, do: (B, Hq, Lq, D); k, v: (B, Hkv, Lkv,
    D); lse: the forward's fp32 row LSE (B, Hq, Lq). Offsets: global token
    coordinates, as in the forward call. dlse: the cotangent of the LSE
    where the caller differentiates it (context parallelism's merge), or
    None. For CUDA tensors delta = rowsum(dO * O) - dlse is computed here in
    plain torch (as the JAX wrapper does outside its kernels), then the dQ
    kernel and the dK/dV kernel run."""
    d = q.shape[3]
    lkv = k.shape[2]
    scale = float(d ** -0.5 if scale is None else scale)
    bound = kv_offset + lkv if seq_kv_bound is None else seq_kv_bound
    if q.device.type in _build.PLAIN_DEVICES:
        return swat_attention_bwd_plain(q, k, v, o, lse, do, spec, pattern,
                                        scale, q_offset=q_offset,
                                        kv_offset=kv_offset,
                                        seq_kv_bound=bound, dlse=dlse)
    if q.device.type != "cuda":
        raise ValueError(f"swat_attention_bwd: no kernel for {q.device}")
    do = do.contiguous()
    _check(q, k, v, o, lse, do, pattern)
    delta = _delta(o, do, dlse).contiguous()
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


def _combine_kernel():
    fn = _build.load("swat_attention_bwd").swat_attention_dkv_combine
    if fn.argtypes is None:
        vp, ci = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [vp] * 5 + [ci] * 6 + [vp]
        fn.restype = ctypes.c_int
    return fn
