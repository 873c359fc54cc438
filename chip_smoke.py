#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (`src/repro_torch`).

    python3 chip_smoke.py

Needs one CUDA card and the CUDA toolkit; exits non-zero, with no result
line, when there is no card or when it is run outside a checkout. Phases,
each of which raises on failure:

  1. build   - compile every kernel in src/repro_torch/csrc (nvcc, in
               parallel) and print the card's name and power limit.
  2. kernels - each CUDA kernel against its plain PyTorch version at the
               serving path's shapes (fused decode: caches bitwise equal,
               outputs within bf16 atol 3e-2 / fp32 atol 2e-5 rtol 1e-4;
               banded forward: O at the same tolerances, LSE atol 1e-3,
               for the band pass, the global-row pass, and both composed
               by ops.swat_attention).
  3. serve   - full-width llama3.2-1b + SWAT (window 256, 4 globals), bf16,
               random weights from seed 0: 8 requests, 4 slots, prompt 512,
               64 new tokens, greedy, through ServingEngine. Launch counts
               are zeroed just before and read just after; both kernels
               must have run on every layer.
  4. e2e     - the kernel path against the plain path on the card: prefill
               last-token logits and 8 teacher-forced decode steps.
  5. times   - each kernel, its plain version and one PyTorch library call
               of the same function (timed only; the port never calls it),
               beside the least time the card could take.
  6. trace   - torch.profiler over a short serve run: the device's busy
               share of the wall time and device time by kernel category.

Prints the kernels JSON line and the card line, then as its last line
{"ok": true, "device": {...}}.
"""
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(HERE, "src")

HBM_BYTES_PER_S = 3.35e12          # H100 SXM data sheet
PEAK_OPS = {"bfloat16": 989e12,    # dense tensor-core bf16
            "float32": 67e12}      # fp32 outside the tensor cores

MAIN = dict(b=4, hq=32, hkv=8, d=64, window=256, num_global=4,
            prompt=512, new_tokens=64, max_len=1024)
TOL = {"bfloat16": dict(atol=3e-2, rtol=1e-2),
       "float32": dict(atol=2e-5, rtol=1e-4)}
LOGIT_BOUND = 0.25          # bf16 kernel path vs plain path, max |dlogit|
AGREE_BOUND = 0.75          # greedy agreement, kernel vs plain path
SPIN_CYCLES = 40_000_000    # ~20 ms at the H100's ~2 GHz: covers the host
                            # time of enqueuing the slowest plain version


def log(msg):
    print(f"[chip_smoke] {msg}", flush=True)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()
    return out.splitlines()[0].strip()


def max_err(a, b):
    return float((a.float() - b.float()).abs().max())


def check_close(name, got, want, dtype_name, **tol):
    import torch
    tol = tol or TOL[dtype_name]
    err = max_err(got, want)
    if not torch.allclose(got.float(), want.float(), **tol):
        raise AssertionError(f"{name}: max abs err {err} outside {tol}")
    return err


# ------------------------------------------------------------- phase 2 ---

def _ring_inputs(torch, gen, dtype, b, group, hkv, t, d, lens):
    cap = MAIN["window"] + 1 + (t - 1) + MAIN["num_global"]
    w = 320                                   # _round_capacity(cap)
    dev = "cuda"
    mk = lambda *s: torch.randn(*s, generator=gen, device=dev).to(dtype)
    q = mk(b, group * hkv, t, d)
    kc, vc = mk(b, hkv, w, d), mk(b, hkv, w, d)
    nk, nv = mk(b, hkv, t, d), mk(b, hkv, t, d)
    pos = torch.tensor(lens, dtype=torch.int32, device=dev)
    nn = torch.tensor([t, max(1, t - 1), t, t][:b], dtype=torch.int32,
                      device=dev)
    return q, kc, vc, nk, nv, pos, nn, cap


def check_decode(torch, spec):
    from repro_torch.kernels import swat_decode as SD
    gen = torch.Generator(device="cuda").manual_seed(1)
    main_err = None
    for dtype in (torch.bfloat16, torch.float32):
        dn = str(dtype).split(".")[-1]
        for t in (1, 4):
            for group in (1, 4, 8):
                for lens, tag in (([0, 3, 100, 200], "cold"),
                                  ([600, 261, 1037, 5000], "wrapped")):
                    q, kc, vc, nk, nv, pos, nn, cap = _ring_inputs(
                        torch, gen, dtype, MAIN["b"], group, MAIN["hkv"], t,
                        MAIN["d"], lens)
                    want, kw, vw = SD.swat_decode_fused_plain(
                        q, kc, vc, nk, nv, pos, nn, spec, ring_cap=cap)
                    k2, v2 = kc.clone(), vc.clone()
                    got = SD.swat_decode_fused(q, k2, v2, nk, nv, pos, nn,
                                               spec, ring_cap=cap)
                    torch.cuda.synchronize()
                    name = f"swat_decode {dn} T={t} group={group} {tag}"
                    if not (torch.equal(k2, kw) and torch.equal(v2, vw)):
                        raise AssertionError(f"{name}: caches not bitwise "
                                             "equal to the plain version")
                    err = 0.0
                    for i in range(MAIN["b"]):
                        real = int(nn[i])   # rows past num_new: garbage
                        err = max(err, check_close(
                            name, got[i, :, :real], want[i, :, :real], dn))
                    if (dn, t, group, tag) == ("bfloat16", 1, 4, "wrapped"):
                        main_err = err
    log("swat_decode: 24 cases, caches bitwise equal, outputs within "
        "tolerance")
    return main_err


def check_banded(torch, spec):
    import dataclasses
    from repro_torch.kernels import ops
    from repro_torch.kernels import swat_attention as SA
    gen = torch.Generator(device="cuda").manual_seed(2)
    b, hq, hkv, d, l = MAIN["b"], MAIN["hq"], MAIN["hkv"], MAIN["d"], \
        MAIN["prompt"]
    specs = {"causal+globals": spec,
             "bidirectional": dataclasses.replace(spec, causal=False,
                                                  window=64),
             "random blocks": dataclasses.replace(spec, num_random=2,
                                                  random_seed=7)}
    main_err = None
    for dtype in (torch.bfloat16, torch.float32):
        dn = str(dtype).split(".")[-1]
        mk = lambda *s: torch.randn(*s, generator=gen,
                                    device="cuda").to(dtype)
        q, k, v = mk(b, hq, l, d), mk(b, hkv, l, d), mk(b, hkv, l, d)
        for tag, sp in specs.items():
            pat = ops.get_pattern(sp, l, l, 128, 128)
            want, wl = SA.banded_plain(q, k, v, sp, pat, d ** -0.5,
                                       return_lse=True)
            got, gl = SA.swat_attention_fwd(q, k, v, sp, pattern=pat,
                                            return_lse=True)
            torch.cuda.synchronize()
            name = f"swat_attention_fwd {dn} {tag}"
            err = check_close(name, got, want, dn)
            check_close(name + " lse", gl, wl, dn, atol=1e-3, rtol=1e-4)
            if (dn, tag) == ("bfloat16", "causal+globals"):
                main_err = err
        # the global-row pass that ops.swat_attention runs after the band
        # pass: the first g rows against every key, under the dense causal
        # spec (Lq=4, Lkv=512: a q block mostly past Lq, sparse==0)
        g = spec.num_global
        gspec = dataclasses.replace(spec, kind="dense", window=0,
                                    num_global=0, num_random=0)
        gpat = ops.get_pattern(gspec, g, l, 128, 128)
        qg = q[:, :, :g].contiguous()
        want, wl = SA.banded_plain(qg, k, v, gspec, gpat, d ** -0.5,
                                   return_lse=True)
        got, gl = SA.swat_attention_fwd(qg, k, v, gspec, pattern=gpat,
                                        return_lse=True)
        torch.cuda.synchronize()
        name = f"swat_attention_fwd {dn} global rows"
        gerr = check_close(name, got, want, dn)
        check_close(name + " lse", gl, wl, dn, atol=1e-3, rtol=1e-4)
        # both passes composed as the serve path calls them
        got = ops.swat_attention(q, k, v, spec, impl="kernel")
        want = ops.swat_attention(q, k, v, spec, impl="banded")
        torch.cuda.synchronize()
        err = check_close(f"ops.swat_attention {dn} kernel vs banded", got,
                          want, dn)
        if dn == "bfloat16":        # the serve path's shapes and dtype
            main_err = max(main_err, gerr, err)
    log("swat_attention_fwd: 10 cases (3 specs, the global-row pass, and "
        "ops.swat_attention's two passes composed, x bf16/fp32), O and LSE "
        "within tolerance")
    return main_err


# ------------------------------------------------------------- phase 3 ---

def serve(torch, cfg, params):
    import numpy as np
    from repro_torch.kernels import swat_attention as SA
    from repro_torch.kernels import swat_decode as SD
    from repro_torch.serving.engine import Request, ServingEngine
    rng = np.random.RandomState(0)
    prompts = [rng.randint(0, cfg.vocab_size, (MAIN["prompt"],))
               .astype(np.int32) for _ in range(8)]

    def run(n_new, reqs):
        eng = ServingEngine(cfg, params, batch_slots=4,
                            max_len=MAIN["max_len"], scan_steps=8)
        t0 = time.perf_counter()
        res = eng.run([Request(rid=i, prompt=p, max_new_tokens=n_new)
                       for i, p in enumerate(reqs)])
        torch.cuda.synchronize()
        return eng, res, time.perf_counter() - t0

    run(4, prompts[:4])                      # warm-up (cuBLAS, allocator)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    SD.LAUNCHES.reset()
    SA.LAUNCHES.reset()
    eng, res, wall = run(MAIN["new_tokens"], prompts)
    launches = {"swat_decode": SD.LAUNCHES.n,
                "swat_attention_fwd": SA.LAUNCHES.n}
    st = eng.stats
    n_tok = sum(len(r.tokens) for r in res)
    for r in res:
        if r.status != "ok" or len(r.tokens) != MAIN["new_tokens"]:
            raise AssertionError(f"request {r.rid}: {r.status}, "
                                 f"{len(r.tokens)} tokens")
        if min(r.tokens) < 0 or max(r.tokens) >= cfg.vocab_size:
            raise AssertionError(f"request {r.rid}: token out of range")
    layers = cfg.num_layers
    if launches["swat_decode"] < layers * st["decode_steps"]:
        raise AssertionError(f"swat_decode launched {launches} times for "
                             f"{st['decode_steps']} decode steps")
    if launches["swat_attention_fwd"] < layers * st["prefill_batches"]:
        raise AssertionError(f"swat_attention_fwd launched {launches} times "
                             f"for {st['prefill_batches']} prefill batches")
    summary = {
        "requests": len(res), "tokens": n_tok, "wall_s": wall,
        "tok_per_s": n_tok / wall,
        "prefill_batches": st["prefill_batches"],
        "prefill_ms_per_batch": st["prefill_s"] * 1e3
        / st["prefill_batches"],
        "decode_steps": st["decode_steps"],
        "decode_ms_per_step": st["decode_s"] * 1e3 / st["decode_steps"],
        "decode_ms_per_token": st["decode_s"] * 1e3
        / max(1, st["tokens_emitted"]),
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
        "launches": launches}
    log("serve: " + json.dumps(summary))
    return summary, [r.tokens for r in res]


# ------------------------------------------------------------- phase 4 ---

def end_to_end(torch, cfg, params, tokens):
    """Kernel path vs plain path on the same prompts (the serve run's first
    four). Also reports whether the serve run's first tokens are the kernel
    path's greedy prefill tokens."""
    import numpy as np
    from repro_torch.core import model as Mod
    rng = np.random.RandomState(0)
    prompts = np.stack([rng.randint(0, cfg.vocab_size, (MAIN["prompt"],))
                        for _ in range(4)]).astype(np.int64)
    tok = torch.as_tensor(prompts, device="cuda")
    lk, ck = Mod.prefill(params, cfg, {"tokens": tok}, MAIN["max_len"],
                         impl="kernel")
    lp, cp = Mod.prefill(params, cfg, {"tokens": tok}, MAIN["max_len"],
                         impl="banded")
    nxt = lk[:, 0].argmax(-1)
    first = nxt.tolist()
    diffs = [max_err(lk, lp)]
    agree = [(lk.argmax(-1) == lp.argmax(-1)).float().mean().item()]
    for _ in range(8):
        batch = {"tokens": nxt[:, None]}
        lk, _ = Mod.decode_step(params, cfg, batch, ck, impl="kernel")
        lp, _ = Mod.decode_step(params, cfg, batch, cp, impl="banded")
        diffs.append(max_err(lk, lp))
        agree.append((lk.argmax(-1) == lp.argmax(-1)).float().mean().item())
        nxt = lk[:, 0].argmax(-1)       # teacher-forced on the kernel run
    torch.cuda.synchronize()
    out = {"max_abs_logit_diff": max(diffs),
           "greedy_agreement": sum(agree) / len(agree),
           "logit_bound": LOGIT_BOUND, "agreement_bound": AGREE_BOUND,
           "serve_first_tokens_match": all(
               tokens[i][0] == first[i] for i in range(4))}
    log("e2e kernel vs plain: " + json.dumps(out))
    if not all(np.isfinite(diffs)):
        raise AssertionError("non-finite logits")
    if not (out["max_abs_logit_diff"] <= LOGIT_BOUND
            and out["greedy_agreement"] >= AGREE_BOUND):
        raise AssertionError(f"kernel path vs plain path: {out}")
    return out


# ------------------------------------------------------------- phase 5 ---

def time_ms(torch, fn, iters=30):
    """Mean device time of fn(), L2 flushed before each call (the serving
    loop reaches each layer's data cold). A spin kernel queued ahead of the
    start event keeps the card busy while the host enqueues fn's launches,
    so host launch latency never lands between the two events."""
    flush = torch.empty(128 * 2 ** 20, dtype=torch.uint8, device="cuda")
    for _ in range(3):
        fn()
    total = 0.0
    for _ in range(iters):
        flush.zero_()
        torch.cuda._sleep(SPIN_CYCLES)
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        total += s.elapsed_time(e)
    return total / iters


def time_decode(torch, spec):
    import torch.nn.functional as F
    from repro_torch.kernels import ref
    from repro_torch.kernels import swat_decode as SD
    gen = torch.Generator(device="cuda").manual_seed(3)
    b, hq, hkv, d, t = MAIN["b"], MAIN["hq"], MAIN["hkv"], MAIN["d"], 1
    lens = [600, 575, 530, 700]             # mid-serve ring depths
    q, kc, vc, nk, nv, pos, nn, cap = _ring_inputs(
        torch, gen, torch.bfloat16, b, hq // hkv, hkv, t, d, lens)
    k_ms = time_ms(torch, lambda: SD.swat_decode_fused(
        q, kc, vc, nk, nv, pos, nn, spec, ring_cap=cap))
    p_ms = time_ms(torch, lambda: SD.swat_decode_fused_plain(
        q, kc, vc, nk, nv, pos, nn, spec, ring_cap=cap))
    # library yardstick: SDPA on the updated rings with the same mask
    w = kc.shape[2]
    t_s, ok = ref.ring_slot_positions(pos.long() + nn.long(), w,
                                      ring_cap=cap, num_global=4)
    qp = pos.long()[:, None]
    vis = ok & (t_s <= qp) & ((t_s >= qp - spec.window)
                              | (torch.arange(w, device="cuda") < 4))
    mask = vis[:, None, None, :]
    ke = kc.repeat_interleave(hq // hkv, dim=1)
    ve = vc.repeat_interleave(hq // hkv, dim=1)
    l_ms = time_ms(torch, lambda: F.scaled_dot_product_attention(
        q, ke, ve, attn_mask=mask))
    n_vis = int(vis.sum())                   # visible ring rows, all slots
    itm = 2
    bytes_ = (itm * d * (2 * b * hq * t          # q in, out
                         + 4 * b * hkv * t       # new k/v in, written rows
                         + 2 * hkv * n_vis))     # visible K and V rows
    ops_ = 4 * d * hq * t * n_vis
    return k_ms, p_ms, l_ms, bytes_, ops_


def time_banded(torch, spec):
    import torch.nn.functional as F
    from repro_torch.core import patterns
    from repro_torch.kernels import ops
    from repro_torch.kernels import swat_attention as SA
    gen = torch.Generator(device="cuda").manual_seed(4)
    b, hq, hkv, d, l = MAIN["b"], MAIN["hq"], MAIN["hkv"], MAIN["d"], \
        MAIN["prompt"]
    mk = lambda *s: torch.randn(*s, generator=gen,
                                device="cuda").to(torch.bfloat16)
    q, k, v = mk(b, hq, l, d), mk(b, hkv, l, d), mk(b, hkv, l, d)
    pat = ops.get_pattern(spec, l, l, 128, 128)
    k_ms = time_ms(torch, lambda: SA.swat_attention_fwd(
        q, k, v, spec, pattern=pat, return_lse=True))
    p_ms = time_ms(torch, lambda: SA.banded_plain(
        q, k, v, spec, pat, d ** -0.5, return_lse=True))
    dm = torch.as_tensor(patterns.dense_mask(spec, l, l), device="cuda")
    ke = k.repeat_interleave(hq // hkv, dim=1)
    ve = v.repeat_interleave(hq // hkv, dim=1)
    l_ms = time_ms(torch, lambda: F.scaled_dot_product_attention(
        q, ke, ve, attn_mask=dm))
    n_vis = int(dm.sum())
    bytes_ = 2 * d * l * b * (2 * hq + 2 * hkv) + 4 * b * hq * l
    ops_ = 4 * d * b * hq * n_vis
    return k_ms, p_ms, l_ms, bytes_, ops_


# ------------------------------------------------------------- phase 6 ---

_CATEGORIES = (("swat_decode", ("decode_fused_kernel",)),
               ("swat_attention_fwd", ("attention_fwd_kernel",)),
               ("matmul", ("gemm", "cutlass", "xmma", "nvjet", "cublas")))


def _union_ms(ranges):
    """Length of the union of profiler time ranges (us -> ms)."""
    spans = sorted((r.start, r.end) for r in ranges)
    busy, cur_s, cur_e = 0.0, spans[0][0], spans[0][1]
    for s_, e_ in spans[1:]:
        if s_ > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s_, e_
        else:
            cur_e = max(cur_e, e_)
    return (busy + cur_e - cur_s) / 1e3


def trace_decode(torch, cfg, params):
    """torch.profiler over one admitted batch of 4 requests and two decode
    blocks of 8 steps: device busy share of the wall time, and device time
    by kernel category."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.serving.engine import Request, ServingEngine
    rng = np.random.RandomState(1)
    reqs = [Request(rid=i, prompt=rng.randint(0, cfg.vocab_size,
                                              (MAIN["prompt"],)),
                    max_new_tokens=17) for i in range(4)]
    eng = ServingEngine(cfg, params, batch_slots=4, max_len=MAIN["max_len"],
                        scan_steps=8)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng.run(reqs)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.events()
    dt = torch.autograd.DeviceType
    kernels = [e for e in events if e.device_type == dt.CUDA
               and not e.name.startswith("engine.")]
    blocks = [e.time_range for e in events
              if e.name == "engine.decode_block" and e.device_type == dt.CPU]
    out = {"wall_ms": wall_ms, "prefill_ms": eng.stats["prefill_s"] * 1e3,
           "decode_ms": eng.stats["decode_s"] * 1e3,
           "decode_steps": eng.stats["decode_steps"],
           "device_kernels": len(kernels)}
    if not kernels or not blocks:
        out["device_time"] = "not measured (no device events traced)"
        log("trace: " + json.dumps(out))
        return out
    # decode blocks end in a host sync and start after the previous one, so
    # a kernel belongs to the block whose host range holds its start
    dec = [e for e in kernels
           if any(b.start <= e.time_range.start <= b.end for b in blocks)]
    if not dec:
        out["device_time"] = "not measured (no kernel inside a decode block)"
        log("trace: " + json.dumps(out))
        return out
    block_ms = sum(b.elapsed_us() for b in blocks) / 1e3
    by_cat = {}
    for e in dec:
        name = e.name.lower()
        cat = next((c for c, keys in _CATEGORIES
                    if any(k in name for k in keys)), "other")
        by_cat[cat] = by_cat.get(cat, 0.0) + e.time_range.elapsed_us() / 1e3
    steps = max(1, eng.stats["decode_steps"])
    out.update(
        decode_block_host_ms=block_ms,
        decode_device_busy_ms=_union_ms([e.time_range for e in dec]),
        decode_busy_share=_union_ms([e.time_range for e in dec]) / block_ms,
        decode_device_ms_per_step_by_category={
            k: v / steps for k, v in sorted(by_cat.items())},
        decode_kernels_per_step=len(dec) / steps,
        run_busy_share=_union_ms([e.time_range for e in kernels]) / wall_ms)
    log("trace: " + json.dumps(out))
    return out


def bound(bytes_, ops_, dtype_name="bfloat16"):
    tb = bytes_ / HBM_BYTES_PER_S * 1e3
    to = ops_ / PEAK_OPS[dtype_name] * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


# --------------------------------------------------------------- main ----

def main():
    try:
        import torch
    except ImportError:
        print("chip_smoke: PyTorch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels run only on "
              "the card", file=sys.stderr)
        return 1
    if not os.path.isdir(os.path.join(SRC, "repro_torch")):
        print(f"chip_smoke: {SRC}/repro_torch not found; run from a "
              "checkout of the repository", file=sys.stderr)
        return 1
    sys.path.insert(0, SRC)
    import repro_torch  # noqa: F401  (pins TF32 off)
    from repro_torch.configs import get_config, with_swat
    from repro_torch.core import model as Mod
    from repro_torch.kernels import _build

    t_start = time.perf_counter()
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}")
    card = card_line()
    t0 = time.perf_counter()
    libs = _build.build_all()
    log(f"build: {sorted(libs)} in {time.perf_counter() - t0:.1f}s")
    for stem, out in sorted(_build.BUILD_LOG.items()):
        for line in out.splitlines():
            if "registers" in line or "spill" in line:
                log(f"ptxas {stem}: {line.strip()}")

    cfg = with_swat(get_config("llama3.2-1b"), window=MAIN["window"],
                    num_global=MAIN["num_global"])
    spec = cfg.attention
    dec_err = check_decode(torch, spec)
    fwd_err = check_banded(torch, spec)

    params = Mod.init_model(cfg, seed=0, device="cuda")
    summary, tokens = serve(torch, cfg, params)
    e2e = end_to_end(torch, cfg, params, tokens)

    dk, dp, dl, db, do = time_decode(torch, spec)
    fk, fp, fl, fb, fo = time_banded(torch, spec)
    trace = trace_decode(torch, cfg, params)
    db_ms, db_by = bound(db, do)
    fb_ms, fb_by = bound(fb, fo)
    kernels = [
        {"name": "swat_decode_fused", "route": "cuda",
         "source": "src/repro_torch/csrc/swat_decode.cu",
         "replaces": "src/repro/kernels/swat_decode.py:116",
         "launches": summary["launches"]["swat_decode"],
         "max_abs_err": dec_err, "ms": dk, "plain_ms": dp,
         "bound_ms": db_ms, "bound_by": db_by, "library_ms": dl},
        {"name": "swat_attention_fwd", "route": "cuda",
         "source": "src/repro_torch/csrc/swat_attention_fwd.cu",
         "replaces": "src/repro/kernels/swat_attention.py:64",
         "launches": summary["launches"]["swat_attention_fwd"],
         "max_abs_err": fwd_err, "ms": fk, "plain_ms": fp,
         "bound_ms": fb_ms, "bound_by": fb_by, "library_ms": fl},
    ]
    log(f"serve summary: {json.dumps(summary)}")
    log(f"e2e: {json.dumps(e2e)}")
    log(f"trace: {json.dumps(trace)}")
    log(f"total {time.perf_counter() - t_start:.1f}s")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
