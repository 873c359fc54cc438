"""SWAT fused ring-decode: the CUDA kernel's wrapper and its plain version.

Port of the JAX package's `kernels/swat_decode.py` in fused mode (the
`swat_decode_fused` pallas_call). T new tokens per slot are written into
their ring slots (token pos+j -> slot g + (pos+j-g) mod ring, pinned globals
below g, rows j >= num_new not written) and the window is attended in the
same kernel, with positional masks rebuilt from the per-slot `pos`. The
kernel source is `repro_torch/csrc/swat_decode.cu`.

`swat_decode_fused` launches the kernel for CUDA tensors and raises on
anything the kernel does not take. For CPU tensors, and only for them, it
runs `swat_decode_fused_plain` (ring_insert_ref + decode_ref). Either way
the caches are updated IN PLACE (the JAX kernel aliased them
input->output; the engine donated them).
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.core.types import AttentionSpec
from repro_torch.kernels import _build
from repro_torch.kernels import ref as ref_impl

LAUNCHES = _build.LaunchCounter()
HEAD_DIMS = (16, 32, 64, 128)
MAX_ROWS = 128   # group*T query rows per CTA (one thread row each)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _ring_geometry(spec: AttentionSpec, w: int,
                   ring_cap: Optional[int]) -> Tuple[int, int, int]:
    cap = w if ring_cap is None else int(ring_cap)
    g = spec.num_global if spec.is_sparse else 0
    window = spec.window if spec.is_sparse else 0
    return cap, g, window


def swat_decode_fused_plain(q, k_cache, v_cache, new_k, new_v, pos, num_new,
                            spec: AttentionSpec, *,
                            ring_cap: Optional[int] = None,
                            scale: Optional[float] = None):
    """Plain PyTorch version: scatter the new rows, then attend with the
    positional masks. Functional: returns (out, k_cache', v_cache')."""
    cap, g, _ = _ring_geometry(spec, k_cache.shape[2], ring_cap)
    k_cache = ref_impl.ring_insert_ref(k_cache, new_k, pos, num_new,
                                       ring_cap=cap, num_global=g)
    v_cache = ref_impl.ring_insert_ref(v_cache, new_v, pos, num_new,
                                       ring_cap=cap, num_global=g)
    total = pos.long() + num_new.long()
    out = ref_impl.decode_ref(q, k_cache, v_cache, spec, total=total,
                              q0=pos, scale=scale, ring_cap=cap)
    return out, k_cache, v_cache


def _check(q, k_cache, v_cache, new_k, new_v, pos, num_new, cap, g):
    dev = q.device
    tensors = dict(q=q, k_cache=k_cache, v_cache=v_cache, new_k=new_k,
                   new_v=new_v, pos=pos, num_new=num_new)
    for name, t in tensors.items():
        if t.device != dev:
            raise ValueError(f"swat_decode: {name} on {t.device}, q on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"swat_decode: {name} must be contiguous")
    if q.dtype not in _DTYPES:
        raise TypeError(f"swat_decode: dtype {q.dtype} not supported "
                        f"(float32 or bfloat16)")
    for name in ("k_cache", "v_cache", "new_k", "new_v"):
        if tensors[name].dtype != q.dtype:
            raise TypeError(f"swat_decode: {name} is {tensors[name].dtype}, "
                            f"q is {q.dtype}")
    for name in ("pos", "num_new"):
        if tensors[name].dtype != torch.int32:
            raise TypeError(f"swat_decode: {name} must be int32")
    b, hq, t, d = q.shape
    if k_cache.dim() != 4 or k_cache.shape[0] != b or k_cache.shape[3] != d:
        raise ValueError(f"swat_decode: cache shape {tuple(k_cache.shape)} "
                         f"does not match q {tuple(q.shape)}")
    hkv, w = k_cache.shape[1], k_cache.shape[2]
    if v_cache.shape != k_cache.shape:
        raise ValueError("swat_decode: k_cache and v_cache shapes differ")
    if hq % hkv:
        raise ValueError(f"swat_decode: {hq} q heads vs {hkv} kv heads")
    for name in ("new_k", "new_v"):
        if tuple(tensors[name].shape) != (b, hkv, t, d):
            raise ValueError(f"swat_decode: {name} shape "
                             f"{tuple(tensors[name].shape)} != "
                             f"{(b, hkv, t, d)}")
    for name in ("pos", "num_new"):
        if tuple(tensors[name].shape) != (b,):
            raise ValueError(f"swat_decode: {name} must have shape ({b},)")
    if d not in HEAD_DIMS:
        raise ValueError(f"swat_decode: head dim {d} not in {HEAD_DIMS}")
    if (hq // hkv) * t > MAX_ROWS:
        raise ValueError(f"swat_decode: group*T = {(hq // hkv) * t} query "
                         f"rows > {MAX_ROWS}")
    if not g < cap <= w or t > cap - g:
        raise ValueError(f"swat_decode: ring geometry cap={cap} g={g} W={w} "
                         f"T={t} (need g < cap <= W and T <= cap - g)")


def swat_decode_fused(q, k_cache, v_cache, new_k, new_v, pos, num_new,
                      spec: AttentionSpec, *, ring_cap: Optional[int] = None,
                      scale: Optional[float] = None) -> torch.Tensor:
    """q: (B, Hq, T, D); caches: (B, Hkv, W, D), updated in place;
    new_k/new_v: (B, Hkv, T, D) in the cache dtype; pos/num_new: int32
    (B,). Returns out (B, Hq, T, D). Rows j >= num_new are neither written
    nor attendable, and their outputs are garbage the caller discards."""
    cap, g, window = _ring_geometry(spec, k_cache.shape[2], ring_cap)
    scale = float(q.shape[-1] ** -0.5 if scale is None else scale)
    if q.device.type == "cpu":
        out, kn, vn = swat_decode_fused_plain(
            q, k_cache, v_cache, new_k, new_v, pos, num_new, spec,
            ring_cap=cap, scale=scale)
        k_cache.copy_(kn)
        v_cache.copy_(vn)
        return out
    if q.device.type != "cuda":
        raise ValueError(f"swat_decode: no kernel for device {q.device}")
    _check(q, k_cache, v_cache, new_k, new_v, pos, num_new, cap, g)
    b, hq, t, d = q.shape
    hkv, w = k_cache.shape[1], k_cache.shape[2]
    out = torch.empty_like(q)
    fn = _kernel()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        status = fn(q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
                    new_k.data_ptr(), new_v.data_ptr(), pos.data_ptr(),
                    num_new.data_ptr(), out.data_ptr(), b, hkv,
                    (hq // hkv) * t, t, d, w, cap, g, window,
                    int(spec.causal), scale, float(spec.softcap),
                    _DTYPES[q.dtype], stream)
    LAUNCHES.n += 1
    _build.check_status("swat_decode_fused", status)
    return out


def _kernel():
    fn = _build.load("swat_decode").swat_decode_fused
    if fn.argtypes is None:
        vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn.argtypes = [vp] * 8 + [ci] * 10 + [cf, cf, ci, vp]
        fn.restype = ctypes.c_int
    return fn
