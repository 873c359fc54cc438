"""SWAT ring decode: the CUDA kernels' wrappers and their plain versions.

Port of the JAX package's `kernels/swat_decode.py`, whose one Pallas kernel
(`_decode_kernel`) runs in two modes. So does the CUDA kernel in
`repro_torch/csrc/swat_decode.cu` (a compile-time flag), with an entry point
for each mode. Both cut each (slot, head)'s cache into chunks, one CTA
each, and merge the chunks' softmax states in rank order inside a
thread-block cluster: one launch, no workspace.

* Fused (`swat_decode_fused`, the `swat_decode_fused` pallas_call). T new
  tokens per slot are written into their ring slots (token pos+j -> slot
  g + (pos+j-g) mod ring, pinned globals below g, rows j >= num_new not
  written) and the window is attended in the same kernel, with positional
  masks rebuilt from the per-slot `pos`. The caches are updated IN PLACE
  (the JAX kernel aliased them input->output; the engine donated them).
  Each ring is cut into `fused_splits` chunks.
* Plain (`swat_decode_plain`, the `swat_decode` pallas_call). The cache
  already holds every token; `pos` is the number of tokens in it and the T
  queries are its newest (q0 = pos - T). Nothing is written. Each cache is
  cut into `plain_splits` chunks. Both GQA layouts of the JAX kernel are
  kept: packed (group*T rows per kv head) and unpacked (T rows per q
  head).

Each wrapper launches its kernel for CUDA tensors and raises on anything
the kernel does not take. For CPU (and meta) tensors, and only for them, it runs its
plain version (`swat_decode_fused_plain`, `swat_decode_plain_ref`).

`set_force_fail(True)` (the fault harness's `install_kernel_failure`) arms
both wrappers to raise `KernelDispatchError` at entry, before any operand
is read or written, on every device (`model.decode_step` checks it too,
before its first layer); the serving engine steps down to the plain
version when it sees one.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from repro_torch.core.types import AttentionSpec
from repro_torch.kernels import _build
from repro_torch.kernels import ref as ref_impl
from repro_torch.telemetry import kernelprof as KP

LAUNCHES = _build.LaunchCounter("swat_decode_fused")
PLAIN_LAUNCHES = _build.LaunchCounter("swat_decode_plain")
HEAD_DIMS = (16, 32, 64, 128, 256)
MAX_ROWS = 128   # query rows per CTA (group*T packed, T unpacked)
MAX_SPLITS = 8   # CTAs per fused ring: the portable thread-block cluster size
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_FORCE_FAIL = False
_PAD_EVENTS: list = []


def consume_pad_events() -> list:
    """Drain the structured fallback record (one dict per event since the
    last drain), as the JAX package's `consume_pad_events`. The static
    analyzer (`repro_torch.analysis`) drains it after tracing an engine, so
    a fallback surfaces as a warn-level finding. Only paged-gather events
    are recorded here: the JAX kernel pads and copies a cache whose
    capacity no block size tiles, while #1 takes any capacity (it cuts the
    ring into `fused_splits` chunks), so it records no pad event."""
    out, _PAD_EVENTS[:] = list(_PAD_EVENTS), []
    return out


def record_paged_fallback(nb: int, page: int, reason: str) -> None:
    """Record that a paged decode step resolved its block table outside
    the kernel: `layers.paged_gather` copies the slots' pages into a
    contiguous view, #1 runs on the view and the view is scattered back (a
    pool-sized copy each way per step). Host-only bookkeeping, deduplicated
    per (nb, page) per drain; a captured graph's replays do not record."""
    if any(e.get("kind") == "paged_gather" and e.get("nb") == nb
           and e.get("page") == page for e in _PAD_EVENTS):
        return
    _PAD_EVENTS.append({"kind": "paged_gather", "nb": nb, "page": page,
                        "reason": reason})


def set_force_fail(enabled: bool) -> None:
    """Arm or disarm the injected dispatch failure: while armed, every call
    of `swat_decode_fused` or `swat_decode_plain` raises
    `KernelDispatchError` at entry, before touching an operand. A graph
    captured before it was armed replays without Python and so does not
    raise. Module-global; `serving.faults` manages it."""
    global _FORCE_FAIL
    _FORCE_FAIL = bool(enabled)


def check_force_fail() -> None:
    """Raise `KernelDispatchError` if the injected failure is armed (each
    wrapper's entry, and `model.decode_step`'s before its first layer)."""
    if _FORCE_FAIL:
        from repro_torch.serving.faults import KernelDispatchError
        raise KernelDispatchError(
            "injected decode kernel dispatch failure (set_force_fail armed)")


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
    for name in ("q", "k_cache", "v_cache", "new_k", "new_v"):
        if tensors[name].data_ptr() % 16:
            raise ValueError(f"swat_decode: {name} must be 16-byte aligned "
                             "(the kernel moves 16-byte vectors)")


def _chunks(cap: int, nsplit: int) -> Tuple[int, int]:
    """(chunk, nsplit'): [0, cap) cut into nsplit' <= nsplit contiguous
    chunks of `chunk` rows (the last may be shorter; none is empty)."""
    chunk = -(-cap // max(1, min(MAX_SPLITS, nsplit, cap)))
    return chunk, -(-cap // chunk)


def fused_splits(n_heads: int, cap: int, sms: int) -> Tuple[int, int]:
    """(chunk, nsplit) of the fused mode: the ring [0, cap) cut into
    nsplit <= MAX_SPLITS chunks so that n_heads * nsplit CTAs cover the
    card's `sms` SMs about once (4 splits of 66 rows at llama's serve
    shape: 32 rings of 261 rows on 132 SMs)."""
    return _chunks(cap, sms // n_heads)


def swat_decode_fused(q, k_cache, v_cache, new_k, new_v, pos, num_new,
                      spec: AttentionSpec, *, ring_cap: Optional[int] = None,
                      scale: Optional[float] = None,
                      split_rings: Optional[int] = None) -> torch.Tensor:
    """q: (B, Hq, T, D); caches: (B, Hkv, W, D), updated in place;
    new_k/new_v: (B, Hkv, T, D) in the cache dtype; pos/num_new: int32
    (B,). Returns out (B, Hq, T, D). Rows j >= num_new are neither written
    nor attendable, and their outputs are garbage the caller discards.
    split_rings: the ring count the split is planned for (`fused_splits`;
    default B x Hkv). A mesh shard passes its whole engine's, so that it
    cuts each ring where the single-device engine does: the split is the
    order of the softmax merge, and so a bit of every output."""
    check_force_fail()
    cap, g, window = _ring_geometry(spec, k_cache.shape[2], ring_cap)
    scale = float(q.shape[-1] ** -0.5 if scale is None else scale)
    if q.device.type in _build.PLAIN_DEVICES:
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
    chunk, nsplit = fused_splits(split_rings or b * hkv, cap,
                                 _num_sms(q.device))
    if KP.census_enabled():
        # the geometry the kernel runs with (the JAX package records its
        # block_kv and pad fallback here)
        KP.record_dispatch(op="swat_decode", b=b, h_q=hq, h_kv=hkv, t=t,
                           d=d, w=w, cap=cap, num_global=g,
                           window=int(window), fused=True, split=nsplit,
                           chunk=chunk)
    out = torch.empty_like(q)
    fn = _kernel("swat_decode_fused", 12)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        status = fn(q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
                    new_k.data_ptr(), new_v.data_ptr(), pos.data_ptr(),
                    num_new.data_ptr(), out.data_ptr(), b, hkv,
                    (hq // hkv) * t, t, d, w, cap, g, window,
                    int(spec.causal), chunk, nsplit, scale,
                    float(spec.softcap), _DTYPES[q.dtype], stream)
    LAUNCHES.n += 1
    _build.check_status("swat_decode_fused", status)
    return out


def _kernel(name: str, n_ints: int, n_ptrs: int = 8):
    """The `csrc/swat_decode.cu` entry point `name`: `n_ptrs` pointers,
    `n_ints` ints, scale and softcap, the dtype code and the stream."""
    fn = getattr(_build.load("swat_decode"), name)
    if fn.argtypes is None:
        vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn.argtypes = [vp] * n_ptrs + [ci] * n_ints + [cf, cf, ci, vp]
        fn.restype = ctypes.c_int
    return fn


# ------------------------------------------------------------ plain mode ---

def swat_decode_plain_ref(q, k_cache, v_cache, pos, spec: AttentionSpec, *,
                          ring_cap: Optional[int] = None,
                          scale: Optional[float] = None):
    """Plain PyTorch version of the plain-mode kernel: `decode_ref` with
    positional masks, total = pos tokens in the cache and the queries its
    newest T (q0 = pos - T). The GQA layout does not change the result."""
    cap, _, _ = _ring_geometry(spec, k_cache.shape[2], ring_cap)
    t = q.shape[2]
    return ref_impl.decode_ref(q, k_cache, v_cache, spec, total=pos,
                               q0=pos.long() - t, scale=scale, ring_cap=cap)


def _check_plain(q, k_cache, v_cache, pos, cap, g, pack_gqa):
    dev = q.device
    tensors = dict(q=q, k_cache=k_cache, v_cache=v_cache, pos=pos)
    for name, t in tensors.items():
        if t.device != dev:
            raise ValueError(f"swat_decode_plain: {name} on {t.device}, q on "
                             f"{dev}")
        if not t.is_contiguous():
            raise ValueError(f"swat_decode_plain: {name} must be contiguous")
    if q.dtype not in _DTYPES:
        raise TypeError(f"swat_decode_plain: dtype {q.dtype} not supported "
                        "(float32 or bfloat16)")
    for name in ("k_cache", "v_cache"):
        if tensors[name].dtype != q.dtype:
            raise TypeError(f"swat_decode_plain: {name} is "
                            f"{tensors[name].dtype}, q is {q.dtype}")
    if pos.dtype != torch.int32:
        raise TypeError("swat_decode_plain: pos must be int32")
    for name in ("q", "k_cache", "v_cache"):
        if tensors[name].data_ptr() % 16:
            raise ValueError(f"swat_decode_plain: {name} must be 16-byte "
                             "aligned (the kernel loads 16-byte vectors)")
    b, hq, t, d = q.shape
    if k_cache.dim() != 4 or k_cache.shape[0] != b or k_cache.shape[3] != d:
        raise ValueError(f"swat_decode_plain: cache shape "
                         f"{tuple(k_cache.shape)} does not match q "
                         f"{tuple(q.shape)}")
    if v_cache.shape != k_cache.shape:
        raise ValueError("swat_decode_plain: k_cache and v_cache shapes "
                         "differ")
    hkv, w = k_cache.shape[1], k_cache.shape[2]
    if hq % hkv:
        raise ValueError(f"swat_decode_plain: {hq} q heads vs {hkv} kv "
                         "heads")
    if tuple(pos.shape) != (b,):
        raise ValueError(f"swat_decode_plain: pos must have shape ({b},)")
    if d not in HEAD_DIMS:
        raise ValueError(f"swat_decode_plain: head dim {d} not in "
                         f"{HEAD_DIMS}")
    rows = (hq // hkv) * t if pack_gqa else t
    if rows > MAX_ROWS:
        raise ValueError(f"swat_decode_plain: {rows} query rows per CTA > "
                         f"{MAX_ROWS}")
    if not g < cap <= w:
        raise ValueError(f"swat_decode_plain: ring geometry cap={cap} g={g} "
                         f"W={w} (need g < cap <= W)")


@functools.lru_cache(maxsize=8)
def _num_sms(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def plain_splits(n_heads: int, cap: int, sms: int) -> Tuple[int, int]:
    """(chunk, nsplit) of the plain mode: the cache [0, cap) cut into
    nsplit <= MAX_SPLITS chunks, the most with n_heads * nsplit <= 1.5 x
    the card's `sms` SMs. With no insert to serialise, a long cache takes
    more CTAs than `fused_splits` gives it; but a cluster's CTAs must all
    be resident at once, and two fit an SM. On the H100 (chip_smoke.py
    phase 12's sweep) whisper's cross attention, 48 caches of 1500 rows,
    ran fastest at 4 CTAs a cluster (192 CTAs) and 30% slower at 5 (240)
    or more; gemma2's 16 caches of 4097 rows ran fastest at 8 (128)."""
    return _chunks(cap, 3 * sms // (2 * n_heads))


def swat_decode_plain(q, k_cache, v_cache, pos, spec: AttentionSpec, *,
                      ring_cap: Optional[int] = None,
                      scale: Optional[float] = None,
                      pack_gqa: bool = True) -> torch.Tensor:
    """q: (B, Hq, T, D); caches: (B, Hkv, W, D), read only; pos: int32 (B,)
    tokens in each slot's cache (the queries are its newest T). Returns out
    (B, Hq, T, D). pack_gqa: one cluster per kv head holding its group*T
    query rows (True), or per q head with its T rows (False). Each cache
    is cut into `plain_splits` chunks."""
    check_force_fail()
    cap = _ring_geometry(spec, k_cache.shape[2], ring_cap)[0]
    scale = float(q.shape[-1] ** -0.5 if scale is None else scale)
    if q.device.type in _build.PLAIN_DEVICES:
        return swat_decode_plain_ref(q, k_cache, v_cache, pos, spec,
                                     ring_cap=cap, scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"swat_decode_plain: no kernel for device "
                         f"{q.device}")
    heads = k_cache.shape[1] if pack_gqa else q.shape[1]
    _, nsplit = plain_splits(q.shape[0] * heads, cap, _num_sms(q.device))
    return launch_plain(q, k_cache, v_cache, pos, spec, ring_cap=cap,
                        scale=scale, pack_gqa=pack_gqa, nsplit=nsplit)


def launch_plain(q, k_cache, v_cache, pos, spec: AttentionSpec, *,
                 ring_cap: int, scale: float, pack_gqa: bool,
                 nsplit: int) -> torch.Tensor:
    """One launch of the plain-mode kernel on CUDA tensors (checked here),
    each cache cut into `_chunks(cap, nsplit)`: the wrapper's split from
    `plain_splits`, or another (chip_smoke.py's split sweep)."""
    cap, g, window = _ring_geometry(spec, k_cache.shape[2], ring_cap)
    _check_plain(q, k_cache, v_cache, pos, cap, g, pack_gqa)
    b, hq, t, d = q.shape
    hkv, w = k_cache.shape[1], k_cache.shape[2]
    group = hq // hkv
    heads_per_kv, rows = (1, group * t) if pack_gqa else (group, t)
    chunk, nsplit = _chunks(cap, nsplit)
    out = torch.empty_like(q)
    fn = _kernel("swat_decode_plain", 13, 5)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        status = fn(q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
                    pos.data_ptr(), out.data_ptr(), b, hkv, heads_per_kv,
                    rows, t, d, w, cap, g, window, int(spec.causal), chunk,
                    nsplit, scale, float(spec.softcap), _DTYPES[q.dtype],
                    stream)
    PLAIN_LAUNCHES.n += 1
    _build.check_status("swat_decode_plain", status)
    return out
