"""Kernel profiling hooks (the port of the JAX package's
`telemetry/kernelprof.py`): opt-in, never on the hot path.

  dispatch census   `kernels/ops.py decode_attention` and
                    `kernels/swat_decode.py swat_decode_fused` call
                    `record_dispatch()` when the census is enabled. They
                    run in Python, so they record at eager calls and while
                    a CUDA graph is captured, never at a replay (the
                    counterpart of the JAX package's trace time): the
                    census is a (shape -> dispatch) map of what the engine
                    ran, and its `traces` count is not a count of steps.
  analytic roofline `banded_decode_cost()`: FLOPs over the logical banded
                    geometry (window + globals + lookahead) and HBM bytes
                    over the physical ring rows a decode step touches, the
                    same arithmetic as the JAX function; `bound_ms()` turns
                    it into the least time an H100 could take (`H100`, the
                    data-sheet peaks).
  latency sampler   `sample_latency()` / `profile_decode()`: timed calls,
                    with CUDA events on the card (after warm-up, as
                    chip_smoke.py's `time_ms` times, without its L2 flush)
                    and the host clock on the CPU.

Census state is module-global and OFF by default: `enable_census()` in a
`try/finally`.
"""
from __future__ import annotations

import time
from typing import Any, Dict, List, Optional, Tuple

# NVIDIA H100 SXM data sheet, dense rates at the 700 W power limit
H100 = {"hbm_bytes_per_s": 3.35e12,
        "bfloat16": 989e12,          # tensor-core bf16 FLOP/s
        "float32": 67e12}            # fp32 FLOP/s outside the tensor cores

# a spin kernel queued ahead of each timed call (~2 ms at ~2 GHz) keeps the
# card busy while the host enqueues the call, so host launch latency never
# lands between the two events
SPIN_CYCLES = 4_000_000

_CENSUS_ON = False
_CENSUS: Dict[Tuple, Dict[str, Any]] = {}


def enable_census(on: bool = True) -> None:
    """Start (or stop) recording kernel dispatches. Recording changes no
    kernel and no captured graph."""
    global _CENSUS_ON
    _CENSUS_ON = on


def census_enabled() -> bool:
    return _CENSUS_ON


def record_dispatch(**fields) -> None:
    """Record one dispatch (deduped by field tuple; `traces` counts how
    many times Python dispatched this exact shape)."""
    if not _CENSUS_ON:
        return
    key = tuple(sorted((k, repr(v)) for k, v in fields.items()))
    rec = _CENSUS.get(key)
    if rec is None:
        _CENSUS[key] = {**fields, "traces": 1}
    else:
        rec["traces"] += 1


def consume_census() -> List[Dict[str, Any]]:
    """Drain the census (insertion order)."""
    out = list(_CENSUS.values())
    _CENSUS.clear()
    return out


# ------------------------------------------------------------- roofline ---

def banded_decode_cost(*, b: int, h_q: int, h_kv: int, t: int, d: int,
                       window: int, num_global: int = 0,
                       cap: Optional[int] = None,
                       dtype_bytes: int = 2,
                       fused: bool = True) -> Dict[str, float]:
    """Analytic cost of one T-token banded decode step.

    FLOPs count the LOGICAL band each query row attends: min(cap, window +
    globals + T) rows for sparse specs, the whole cap for dense (window=0
    means dense here), with 2*d per QK and AV MAC plus ~4 ops per softmax
    cell. Bytes count the PHYSICAL traffic: both ring caches streamed once
    (cap rows), q read, out written, and the fused insert's T new K/V rows
    written back. intensity (flops/byte) says which side of the roofline
    ridge the shape sits on."""
    assert cap is not None and cap >= 1
    band = min(cap, window + num_global + t) if window else cap
    q_rows = b * h_q * t
    flops = q_rows * band * (4 * d + 4)
    bytes_ = (2 * b * h_kv * cap * d * dtype_bytes      # K+V stream
              + q_rows * d * dtype_bytes                # q read
              + q_rows * d * dtype_bytes)               # out write
    if fused:
        bytes_ += 2 * b * h_kv * t * d * dtype_bytes    # ring insert
    return {"flops": float(flops), "hbm_bytes": float(bytes_),
            "intensity": float(flops) / float(bytes_), "band_rows": band}


def bound_ms(cost: Dict[str, float], dtype: str = "bfloat16"
             ) -> Tuple[float, str]:
    """(the least time, ms, an H100 could take for `cost`, what bounds it):
    the larger of its bytes over the HBM rate and its operations over the
    peak for `dtype` ("bfloat16" or "float32")."""
    tb = cost["hbm_bytes"] / H100["hbm_bytes_per_s"] * 1e3
    to = cost["flops"] / H100[dtype] * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


# ------------------------------------------------------- latency sampling --

def sample_latency(fn, *args, iters: int = 30, warmup: int = 3
                   ) -> Dict[str, float]:
    """Latency samples of fn(*args): median / p95 / best, microseconds.
    With a CUDA tensor among the args each call is timed by CUDA events
    behind a spin kernel (device time); otherwise by the host clock."""
    import numpy as np
    import torch
    dev = next((a.device for a in args
                if isinstance(a, torch.Tensor) and a.is_cuda), None)
    for _ in range(max(1, warmup)):
        fn(*args)
    ts = []
    for _ in range(max(1, iters)):
        if dev is None:
            t0 = time.perf_counter()
            fn(*args)
            ts.append((time.perf_counter() - t0) * 1e6)
            continue
        with torch.cuda.device(dev):
            torch.cuda._sleep(SPIN_CYCLES)
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            fn(*args)
            e.record()
            e.synchronize()
            ts.append(s.elapsed_time(e) * 1e3)
    arr = np.asarray(ts)
    return {"p50_us": float(np.percentile(arr, 50)),
            "p95_us": float(np.percentile(arr, 95)),
            "best_us": float(arr.min()), "iters": int(arr.size)}


def profile_decode(shapes: List[Dict[str, int]], *, impl: str = "ref",
                   device: str = "cuda", iters: int = 20,
                   seed: int = 0) -> List[Dict[str, Any]]:
    """Per-shape latency + roofline rows for the fused decode op
    (`ops.decode_attention` with new_kv, bf16), impl "kernel" (the CUDA
    kernel; needs the card) or "ref" (its plain version).

    Each shape dict: {b, h_kv, group, t, d, window, num_global, cap} (cap =
    physical ring rows, >= window + globals + t for windowed specs). Each
    row merges the measured latency with the analytic cost, its H100 bound
    (`bound_ms`, `bound_by`) and, on the card, the share of the bound the
    p50 reached (`bound_share`; None on the CPU, whose times are not the
    card's)."""
    import numpy as np
    import torch

    from repro_torch.core.types import AttentionSpec
    from repro_torch.kernels import ops

    if impl == "kernel" and not str(device).startswith("cuda"):
        raise ValueError("impl='kernel' times the CUDA decode kernel; "
                         f"device {device!r} has none")
    rows: List[Dict[str, Any]] = []
    rng = np.random.RandomState(seed)
    dt = torch.bfloat16
    for sh in shapes:
        b, h_kv, group = sh["b"], sh["h_kv"], sh.get("group", 1)
        t, d, cap = sh.get("t", 1), sh["d"], sh["cap"]
        window, g = sh.get("window", 0), sh.get("num_global", 0)
        h_q = h_kv * group
        spec = (AttentionSpec(kind="swat", window=window, num_global=g)
                if window else AttentionSpec(kind="dense"))
        mk = lambda *s: torch.as_tensor(rng.randn(*s), dtype=torch.float32
                                        ).to(device=device, dtype=dt)
        q = mk(b, h_q, t, d)
        kc, vc = mk(b, h_kv, cap, d), mk(b, h_kv, cap, d)
        nk, nv = mk(b, h_kv, t, d), mk(b, h_kv, t, d)
        pos = torch.full((b,), max(cap - t, g), dtype=torch.int32,
                         device=device)

        def fn(q, kc, vc, nk, nv, pos):
            return ops.decode_attention(q, kc, vc, None, spec, impl=impl,
                                        new_kv=(nk, nv), pos=pos,
                                        ring_cap=cap)[0]

        lat = sample_latency(fn, q, kc, vc, nk, nv, pos, iters=iters)
        cost = banded_decode_cost(b=b, h_q=h_q, h_kv=h_kv, t=t, d=d,
                                  window=window, num_global=g, cap=cap)
        b_ms, b_by = bound_ms(cost)
        us = max(lat["p50_us"], 1e-9)
        on_card = q.is_cuda
        rows.append({**sh, "impl": impl,
                     "device": (torch.cuda.get_device_name(q.device)
                                if on_card else "cpu"),
                     **lat, **cost,
                     "achieved_gflops": cost["flops"] / us / 1e3,
                     "achieved_gbps": cost["hbm_bytes"] / us / 1e3,
                     "bound_ms": b_ms, "bound_by": b_by,
                     "bound_share": b_ms * 1e3 / us if on_card else None})
    return rows
