#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (`src/repro_torch`).

    python3 chip_smoke.py

Needs one CUDA card and the CUDA toolkit; exits non-zero, with no result
line, when there is no card or when it is run outside a checkout. Phases,
each of which raises on failure:

  1. build   - compile every kernel in src/repro_torch/csrc (nvcc, in
               parallel) and print the card's name and power limit, and
               each kernel's registers and spills (ptxas): no spill in the
               tensor-core dQ and dK/dV kernels or the decode kernels.
  2. kernels - each CUDA kernel against its plain PyTorch version at the
               serving path's shapes (fused decode at head dim 64, 128 and
               256, T=1/4/5/8 (5 and 8: verify steps on lookahead rings), on
               cold, wrapped and chunk-border rings, the chosen split
               printed: caches bitwise equal, two launches bitwise equal,
               outputs within bf16 atol 3e-2 / fp32 atol 2e-5 rtol 1e-4;
               banded forward: O at the same tolerances, LSE atol 1e-3,
               for the band pass, the global-row pass, and both composed
               by ops.swat_attention; also at head dim 128 and on
               whisper's ragged 1500-row encoder band). Each forward
               launch must count on its route's counter: bf16 at head dim
               64/128/256 on the tensor-core kernel, fp32 on the SIMT one.
  3. serve   - full-width llama3.2-1b + SWAT (window 256, 4 globals), bf16,
               random weights from seed 0: 8 requests, 4 slots, prompt 512,
               64 new tokens, greedy, through ServingEngine. Launch counts
               are zeroed just before and read just after; they must equal
               one per layer and step (and pass, for the forward), every
               forward launch on the tensor-core route.
  4. e2e     - the kernel path against the plain path on the card: prefill
               last-token logits and 8 teacher-forced decode steps.
  5. times   - each kernel, its plain version and one PyTorch library call
               of the same function (timed only; the port never calls it),
               beside the least time the card could take.
  6. trace   - torch.profiler over a short serve run: the device's busy
               share of the wall time and device time by kernel category;
               one fused decode kernel per layer and decode step, and no
               other decode kernel (the cluster merge launches nothing).
 17. chunk   - (run after phase 6) kernel #2 as a prefill chunk launches
               it, against banded_plain with the same arguments: pass A
               (the gathered ring tail and the chunk, q_offset / kv_offset
               / seq_kv_bound, return_lse) and pass B (the pinned globals)
               at llama's 64-token chunk at pos0 0, 64 and 448 (after a
               wrap), on its dense layer, and at gemma2-2b's D=256 local
               layer after a wrap, bf16 and fp32, each launch on its route;
               the whole chunk route against the plain chunk attention on
               the card. Then pass A's time beside banded_plain's and one
               SDPA call (boolean band mask over the gathered buffer), and
               the fused decode's at T=5.
 18. serve slice - full-width llama3.2-1b + SWAT, bf16, the 8 requests of
               phase 3 through ServingEngine(prefill_chunk=64) and
               ServingEngine(speculative=4, n-gram drafter 3/64): launch
               counts zeroed before and read after each run (the forward:
               one pass A per layer and chunk, one pass B per layer and
               chunk after the first; the fused decode: one per layer and
               decode or verify step; every forward launch on the
               tensor-core route); chunked against single-shot first-token
               logits within LOGIT_BOUND, the speculative tokens against
               sequential decode teacher-forced along them within
               AGREE_BOUND; traced chunked and single-shot prefill batches
               and a traced verify block split by kernel category.
 19. serve slice fp32 - the same 8 requests at fp32 through the default,
               chunked and speculative engines (SIMT forward): greedy
               tokens equal on every request.
  7. backward - the dQ and dK/dV kernels against their plain version at the
               training shapes (B=4, Hq=32, Hkv=8, L=2048, D=64, window
               256, 4 globals, causal; plus group 1 and 8, softcap 30 and
               50, random blocks, the longformer-paper bidirectional spec,
               the global-row pass, head dim 128 and 256, whisper's ragged
               1500-row encoder band and its cross shape, 448 queries
               against 1500 keys), bf16 and fp32, each dQ and dK/dV
               launch on its route's counter (bf16 at head dim 64/128/256
               on the tensor-core kernels); two launches bitwise equal (the
               split dK/dV rows and their combine included); the combine
               kernel bitwise equal to its plain version; autograd
               through ops.swat_attention, kernel against banded, both
               passes composed.
  8. train   - full-width llama3.2-1b + SWAT, bf16, 6 AdamW steps (lr
               3e-5) of 4 x 2048 tokens (remat "nothing"): losses finite
               and falling, launch counts of all three attention kernels
               (forward and dK/dV on the tensor-core route, one combine
               per band pass).
  9. train e2e - one loss/grad at full width and 4 layers, kernel path
               against the plain path.
 10. resume  - the smoke config trained 8 steps uninterrupted and with a
               failure at step 6 resumed from the step-4 checkpoint give
               bitwise-equal params (deterministic algorithms).
 11. train times - the backward kernels, their plain version and SDPA's
               backward at the training shapes, the split combine, the
               forward at L=2048 (band pass and global-row pass apart),
               the unembed product, and a profiled train step split by
               kernel category.
 12. plain decode - the plain-mode decode kernel (the fused kernel's
               cluster split without the insert) against its plain version,
               bf16 and fp32, both GQA layouts, two launches bitwise equal,
               one launch a call: whisper's cross attention (B=8, 6 heads,
               T=1, D=64, 1500 encoder rows, dense non-causal),
               kernel_bench.py's unpacked shape (B=8, group 4, 2 kv heads,
               W=512, wrapped) and a causal window + globals + softcap ring
               with T=4; then its time at every split count (1-8 CTAs a
               cluster) at whisper's cross shape and at D=256, beside the
               split `plain_splits` picks.
 13. gemma2 D=256 - all five kernel entry points against their plain
               versions at gemma2-2b's shapes (head dim 256, 8 q heads
               over 4 kv heads, L=8192): the local layer (window 4096,
               softcap 50; decode on its wrapped 4097-row ring) and the
               dense causal global layer (softcap 50; decode on its
               8192-row cache), bf16 and fp32, each dQ and dK/dV launch on
               its route (bf16: the tensor cores), two backward launches
               bitwise equal; then the kernels' times at the local layer
               (dK/dV also at the global layer), each beside one SDPA call
               of the same shapes and mask (the backward's as
               forward+backward minus forward).
 14. whisper - full-width whisper-tiny + SWAT (window 128, 4 globals),
               bf16, random weights from seed 0: 8 clips of 1500 encoder
               frames, prefill of a 16-token prompt, 200 greedy decode
               steps through model.prefill / model.decode_step; launch
               counts of the three serving kernels equal to the expected
               counts, every forward launch on the tensor-core route.
 15. whisper e2e - the same run with every kernel swapped for its plain
               version: fp32 greedy tokens equal on every step and fp32
               logits within WHISPER_FP32_LOGIT_BOUND; bf16 logits,
               teacher-forced on the kernel path's tokens, within
               WHISPER_LOGIT_BOUND. The fp32 run's forward launches all
               count on the SIMT route.
 16. whisper times - encoder, prefill and decode step times, tokens/s,
               peak memory, a traced decode block split by kernel (one
               decode_plain_kernel a plain decode call and no other decode
               kernel but the fused one), and the plain decode kernel, its
               plain version and SDPA at the cross shape.

Prints the kernels JSON line and the card line, then as its last line
{"ok": true, "device": {...}}.
"""
import json
import os
import subprocess
import sys
import time

# cuBLAS is deterministic only with a fixed workspace; set before the first
# cuBLAS call (the resume drill runs under torch.use_deterministic_algorithms)
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

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

# lr 3e-5: at 3e-4 AdamW's first sign-sized updates on the random init
# push the loss up before it falls (12.155 -> 12.330 over the 6 steps)
TRAIN = dict(b=4, seq=2048, steps=6, lr=3e-5, warmup=2, e2e_layers=4)
# backward kernels vs their plain version. fp32: the JAX package's own
# gradient tolerance (tests/test_kernels.py). bf16: both compute in fp32
# from the same bf16 inputs and round once at the end, so they differ by at
# most one bf16 ulp (2^-8..2^-7 relative) plus fp32 summation order
BWD_TOL = {"bfloat16": dict(atol=1e-2, rtol=1e-2),
           "float32": dict(atol=5e-5, rtol=1e-3)}
# autograd through ops.swat_attention, kernel vs banded. bf16: the banded
# path rounds the probabilities to bf16 before P.V and autograd sums the
# gathered K/V gradients in bf16 (up to 16 gathers of a global block), a
# few bf16 ulps
GRAD_TOL = {"bfloat16": dict(atol=6e-2, rtol=3e-2),
            "float32": dict(atol=5e-5, rtol=1e-3)}
TRAIN_LOSS_BOUND = 0.02     # |loss kernel - loss plain|, bf16, 4 layers
TRAIN_GRAD_BOUND = 0.05     # max over leaves of |g_k - g_p| / |g_p|

# whisper-tiny + SWAT at full width (4+4 layers, d_model 384, 6 heads, head
# dim 64, vocab 51865): 8 clips of ENCODER_FRAMES, a 16-token prompt, 200
# greedy decode steps (the decoder ring of 133 rows wraps within them)
WHISPER = dict(clips=8, frames=1500, prompt=16, steps=200, max_len=448,
               window=128, num_global=4)
# bf16, kernel vs plain path, teacher-forced: about 4x the 0.0163 that the
# sound runs read on the H100 (a logit's spread at this init is ~0.4)
WHISPER_LOGIT_BOUND = 0.06
# fp32, kernel vs plain path on equal tokens: both accumulate in fp32 and
# differ in summation order only, far below bf16's ~1e-2
WHISPER_FP32_LOGIT_BOUND = 1e-3
# whisper's encoder band (AttentionSpec fields): bidirectional window 128,
# 4 global tokens
WHISPER_BAND = dict(kind="swat", window=WHISPER["window"],
                    num_global=WHISPER["num_global"], causal=False)
# gemma2-2b's attention shapes (configs/gemma2_2b.py): head dim 256, 8 q
# heads over 4 kv heads, local window 4096, softcaps 50
GEMMA = dict(b=1, hq=8, hkv=4, d=256, seq=8192, window=4096, softcap=50.0)
# the chunked and speculative serve cells (phases 17-19): prefill chunk,
# drafts per verify step, and the n-gram drafter (the JAX launcher's
# --draft-ngram / --draft-history defaults)
CHUNK = 64
SPEC_K = 4
DRAFT = dict(max_ngram=3, history=64)


# kernels whose design keeps every register row in registers: a spill in
# them is a fault (phase 1)
NO_SPILL = ("attention_dkv_tc_kernel", "attention_dq_tc_kernel",
            "decode_fused_kernel", "decode_plain_kernel")


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


def route_counts():
    """Launch counts of the forward's, dQ's and dK/dV's routes and the
    combine."""
    from repro_torch.kernels import swat_attention as SA
    from repro_torch.kernels import swat_backward as SB
    return {"fwd_tc": SA.ROUTE_LAUNCHES["tc"].n,
            "fwd_simt": SA.ROUTE_LAUNCHES["simt"].n,
            "dq_tc": SB.DQ_ROUTE_LAUNCHES["tc"].n,
            "dq_simt": SB.DQ_ROUTE_LAUNCHES["simt"].n,
            "dkv_tc": SB.DKV_ROUTE_LAUNCHES["tc"].n,
            "dkv_simt": SB.DKV_ROUTE_LAUNCHES["simt"].n,
            "combine": SB.COMBINE_LAUNCHES.n}


def check_route(name, before, kernel, route, n=1):
    """Since `before` (route_counts()), `kernel` ("fwd", "dq" or "dkv") was
    launched n times, every time on `route` ("tc" or "simt")."""
    now = route_counts()
    other = "simt" if route == "tc" else "tc"
    got = now[f"{kernel}_{route}"] - before[f"{kernel}_{route}"]
    stray = now[f"{kernel}_{other}"] - before[f"{kernel}_{other}"]
    if got != n or stray:
        raise AssertionError(f"{name}: {got} {kernel} launches on the {route} "
                             f"route and {stray} on the {other} route, "
                             f"expected {n} and 0")


def expected_route(dtype, d, kernel):
    from repro_torch.kernels import swat_attention as SA
    from repro_torch.kernels import swat_backward as SB
    return {"fwd": SA.route, "dq": SB.dq_route,
            "dkv": SB.dkv_route}[kernel](dtype, d)


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


def _border_lens(chunk, cap):
    """Ring depths (tokens before the insert) whose first insert slot is
    the last row of chunk 0 (so T=4 straddles the border), the first row
    of chunk 1, the last row of chunk 1 and the first of chunk 2, each
    after one or more wraps of the ring."""
    g = MAIN["num_global"]
    ring = cap - g
    return [chunk - 1 + 2 * ring, chunk + 3 * ring, 2 * chunk - 1 + ring,
            2 * chunk + 5 * ring]


def check_decode(torch, spec):
    """The fused decode kernel against its plain version: head dim 64, 128
    and 256 x bf16/fp32 x T=1/4/5/8 (5 and 8: a speculative verify step's
    k+1 rows on a ring with k lookahead rows) x group 1/4/8 x three rings
    (cold: slot 0
    at pos 0, so that most of the cluster's chunks see nothing; wrapped;
    insert slots on the split's chunk borders). Caches bitwise equal,
    outputs within TOL, two launches bitwise equal. Returns the bf16 error
    of the serve shape (D=64, group 4, wrapped) for each T."""
    from repro_torch.kernels import swat_decode as SD
    gen = torch.Generator(device="cuda").manual_seed(1)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    main_err, n, splits = {}, 0, set()
    for d in (64, 128, 256):
        for dtype in (torch.bfloat16, torch.float32):
            dn = str(dtype).split(".")[-1]
            for t in (1, 4, 5, 8):
                cap = MAIN["window"] + 1 + (t - 1) + MAIN["num_global"]
                chunk, nsplit = SD.fused_splits(MAIN["b"] * MAIN["hkv"], cap,
                                                sms)
                splits.add((cap, nsplit, chunk))
                rings = (([0, 3, 100, 200], "cold"),
                         ([600, 261, 1037, 5000], "wrapped"),
                         (_border_lens(chunk, cap), "chunk borders"))
                for group in (1, 4, 8):
                    for lens, tag in rings:
                        q, kc, vc, nk, nv, pos, nn, cap = _ring_inputs(
                            torch, gen, dtype, MAIN["b"], group, MAIN["hkv"],
                            t, d, lens)
                        want, kw, vw = SD.swat_decode_fused_plain(
                            q, kc, vc, nk, nv, pos, nn, spec, ring_cap=cap)
                        k2, v2 = kc.clone(), vc.clone()
                        got = SD.swat_decode_fused(q, k2, v2, nk, nv, pos,
                                                   nn, spec, ring_cap=cap)
                        k3, v3 = kc.clone(), vc.clone()
                        again = SD.swat_decode_fused(q, k3, v3, nk, nv, pos,
                                                     nn, spec, ring_cap=cap)
                        torch.cuda.synchronize()
                        name = (f"swat_decode D={d} {dn} T={t} group={group}"
                                f" {tag}")
                        if not (torch.equal(k2, kw) and torch.equal(v2, vw)):
                            raise AssertionError(f"{name}: caches not bitwise "
                                                 "equal to the plain version")
                        if not torch.equal(got, again):
                            raise AssertionError(f"{name}: two launches "
                                                 "differ")
                        err = 0.0
                        for i in range(MAIN["b"]):
                            real = int(nn[i])   # rows past num_new: garbage
                            err = max(err, check_close(
                                name, got[i, :, :real], want[i, :, :real],
                                dn))
                        n += 1
                        if (d, dn, group, tag) == (64, "bfloat16", 4,
                                                   "wrapped"):
                            main_err[t] = err
    log(f"swat_decode: {n} cases, caches bitwise equal, outputs within "
        "tolerance, bitwise repeatable; split (cap, CTAs per ring, chunk "
        f"rows) for {MAIN['b']} slots x {MAIN['hkv']} kv heads on {sms} "
        f"SMs: {sorted(splits)}")
    return main_err


def check_banded(torch, spec):
    import dataclasses
    from repro_torch.core.types import AttentionSpec
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
            before = route_counts()
            got, gl = SA.swat_attention_fwd(q, k, v, sp, pattern=pat,
                                            return_lse=True)
            torch.cuda.synchronize()
            name = f"swat_attention_fwd {dn} {tag}"
            check_route(name, before, "fwd",
                        expected_route(dtype, d, "fwd"))
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
        # head dim 128 (granite-8b, qwen2.5-32b, moonshot, jamba), and
        # whisper's encoder band: 1500 rows, not a multiple of any tile
        for tag, sp, bb, hq_, hkv_, ll, dd in (
                ("D=128", spec, b, hq, hkv, l, 128),
                ("ragged whisper band", AttentionSpec(**WHISPER_BAND),
                 WHISPER["clips"], 6, 6, WHISPER["frames"], 64)):
            qq, kk, vv = mk(bb, hq_, ll, dd), mk(bb, hkv_, ll, dd), \
                mk(bb, hkv_, ll, dd)
            pat = ops.get_pattern(sp, ll, ll, 128, 128)
            want, wl = SA.banded_plain(qq, kk, vv, sp, pat, dd ** -0.5,
                                       return_lse=True)
            before = route_counts()
            got, gl = SA.swat_attention_fwd(qq, kk, vv, sp, pattern=pat,
                                            return_lse=True)
            torch.cuda.synchronize()
            name = f"swat_attention_fwd {dn} {tag}"
            check_route(name, before, "fwd",
                        expected_route(dtype, dd, "fwd"))
            err = check_close(name, got, want, dn)
            check_close(name + " lse", gl, wl, dn, atol=1e-3, rtol=1e-4)
            log(f"{name}: max abs err {err:.3g}")
            del qq, kk, vv, want, wl, got, gl
    log("swat_attention_fwd: 14 cases (3 specs, the global-row pass, "
        "ops.swat_attention's two passes composed, head dim 128 and the "
        "ragged whisper band, x bf16/fp32), O and LSE within tolerance, "
        "each launch on its route")
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
    before = route_counts()
    eng, res, wall = run(MAIN["new_tokens"], prompts)
    launches = {"swat_decode": SD.LAUNCHES.n,
                "swat_attention_fwd": SA.LAUNCHES.n}
    check_route("serve", before, "fwd", "tc", n=SA.LAUNCHES.n)
    st = eng.stats
    n_tok = sum(len(r.tokens) for r in res)
    for r in res:
        if r.status != "ok" or len(r.tokens) != MAIN["new_tokens"]:
            raise AssertionError(f"request {r.rid}: {r.status}, "
                                 f"{len(r.tokens)} tokens")
        if min(r.tokens) < 0 or max(r.tokens) >= cfg.vocab_size:
            raise AssertionError(f"request {r.rid}: token out of range")
    layers = cfg.num_layers
    passes = 2 if cfg.attention.num_global else 1   # band + global rows
    expected = {"swat_decode": layers * st["decode_steps"],
                "swat_attention_fwd": layers * passes
                * st["prefill_batches"]}
    if launches != expected:
        raise AssertionError(f"serve launches {launches}, expected "
                             f"{expected} for {st['decode_steps']} decode "
                             f"steps and {st['prefill_batches']} prefill "
                             "batches")
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


def time_decode(torch, spec, t=1):
    """The fused decode at T rows a slot (T=1: a decode step; T=5: a
    speculative verify step at k=4) on a ring with T-1 lookahead rows."""
    import torch.nn.functional as F
    from repro_torch.kernels import ref
    from repro_torch.kernels import swat_decode as SD
    gen = torch.Generator(device="cuda").manual_seed(3)
    b, hq, hkv, d = MAIN["b"], MAIN["hq"], MAIN["hkv"], MAIN["d"]
    lens = [600, 575, 530, 700]             # mid-serve ring depths
    q, kc, vc, nk, nv, pos, nn, cap = _ring_inputs(
        torch, gen, torch.bfloat16, b, hq // hkv, hkv, t, d, lens)
    nn.fill_(t)
    k_ms = time_ms(torch, lambda: SD.swat_decode_fused(
        q, kc, vc, nk, nv, pos, nn, spec, ring_cap=cap))
    p_ms = time_ms(torch, lambda: SD.swat_decode_fused_plain(
        q, kc, vc, nk, nv, pos, nn, spec, ring_cap=cap))
    # library yardstick: SDPA on the updated rings with the same mask
    w = kc.shape[2]
    t_s, ok = ref.ring_slot_positions(pos.long() + nn.long(), w,
                                      ring_cap=cap, num_global=4)
    qp = pos.long()[:, None, None] + torch.arange(t, device="cuda")[:, None]
    vis = ok[:, None] & (t_s[:, None] <= qp) & (
        (t_s[:, None] >= qp - spec.window)
        | (torch.arange(w, device="cuda") < 4))            # (B, T, W)
    mask = vis[:, None]
    ke = kc.repeat_interleave(hq // hkv, dim=1)
    ve = vc.repeat_interleave(hq // hkv, dim=1)
    l_ms = time_ms(torch, lambda: F.scaled_dot_product_attention(
        q, ke, ve, attn_mask=mask))
    rows = int(vis.any(dim=1).sum())        # ring rows read, all slots
    pairs = int(vis.sum())                  # visible (query, row) pairs
    itm = 2
    bytes_ = (itm * d * (2 * b * hq * t          # q in, out
                         + 4 * b * hkv * t       # new k/v in, written rows
                         + 2 * hkv * rows))      # visible K and V rows
    ops_ = 4 * d * hq * pairs
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

_CATEGORIES = (("swat_decode_plain", ("decode_plain_",)),
               ("swat_decode", ("decode_fused_kernel",)),
               ("swat_attention_fwd", ("attention_fwd_kernel",
                                       "attention_fwd_tc_kernel")),
               ("swat_attention_dq", ("attention_dq_kernel",
                                      "attention_dq_tc_kernel")),
               ("swat_attention_dkv", ("attention_dkv_kernel",
                                       "attention_dkv_tc_kernel")),
               ("swat_attention_dkv_combine", ("dkv_combine_kernel",)),
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


def trace_decode(torch, cfg, params, span="engine.decode_block",
                 n_new=17, **engine_kw):
    """torch.profiler over one admitted batch of 4 requests served by a
    ServingEngine(**engine_kw): the device's busy share of the wall time
    and of the host time of the `span` ranges ("engine.decode_block": the
    decode or verify blocks; "engine.prefill": the admission), and device
    time by kernel category inside them. Decode blocks must hold one
    fused decode kernel per layer and step and no other decode kernel."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.serving.engine import Request, ServingEngine
    rng = np.random.RandomState(1)
    reqs = [Request(rid=i, prompt=rng.randint(0, cfg.vocab_size,
                                              (MAIN["prompt"],)),
                    max_new_tokens=n_new) for i in range(4)]
    eng = ServingEngine(cfg, params, batch_slots=4, max_len=MAIN["max_len"],
                        scan_steps=8, **engine_kw)
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
              if e.name == span and e.device_type == dt.CPU]
    out = {"span": span, "wall_ms": wall_ms,
           "prefill_ms": eng.stats["prefill_s"] * 1e3,
           "decode_ms": eng.stats["decode_s"] * 1e3,
           "decode_steps": eng.stats["decode_steps"],
           "spec_steps": eng.stats["spec_steps"],
           "device_kernels": len(kernels)}
    if not kernels or not blocks:
        out["device_time"] = "not measured (no device events traced)"
        log("trace: " + json.dumps(out))
        return out
    # spans end in a host sync and start after the previous one, so a
    # kernel belongs to the span whose host range holds its start
    dec = [e for e in kernels
           if any(b.start <= e.time_range.start <= b.end for b in blocks)]
    if not dec:
        out["device_time"] = f"not measured (no kernel inside {span})"
        log("trace: " + json.dumps(out))
        return out
    block_ms = sum(b.elapsed_us() for b in blocks) / 1e3
    by_cat = {}
    for e in dec:
        name = e.name.lower()
        cat = next((c for c, keys in _CATEGORIES
                    if any(k in name for k in keys)), "other")
        by_cat[cat] = by_cat.get(cat, 0.0) + e.time_range.elapsed_us() / 1e3
    if span == "engine.decode_block":
        per = max(1, eng.stats["decode_steps"])
        # the fused decode is one kernel per layer and step: its cluster
        # merge launches nothing else
        fused = sum("decode_fused_kernel" in e.name for e in dec)
        stray = sorted({e.name[:60] for e in dec
                        if "decode" in e.name.lower()
                        and "decode_fused_kernel" not in e.name})
        if fused != cfg.num_layers * eng.stats["decode_steps"] or stray:
            raise AssertionError(
                f"trace: {fused} fused decode kernels in "
                f"{eng.stats['decode_steps']} decode steps of "
                f"{cfg.num_layers} layers; other decode kernels: {stray}")
        out["fused_decode_kernels_per_step"] = fused / per
        unit = "step"
    else:
        per = max(1, eng.stats["prefill_batches"])
        out["attention_fwd_kernels_per_batch"] = sum(
            "attention_fwd" in e.name for e in dec) / per
        unit = "batch"
    busy = _union_ms([e.time_range for e in dec])
    out.update({
        "span_host_ms": block_ms,
        "span_device_busy_ms": busy,
        "span_busy_share": busy / block_ms,
        f"device_ms_per_{unit}_by_category": {
            k: v / per for k, v in sorted(by_cat.items())},
        f"kernels_per_{unit}": len(dec) / per,
        "run_busy_share": _union_ms([e.time_range for e in kernels])
        / wall_ms})
    log("trace: " + json.dumps(out))
    return out


# ------------------------------------------------------------- phase 7 ---

def _bwd_inputs(torch, gen, dtype, b, hq, hkv, lq, lkv, d, sp, pat):
    from repro_torch.kernels import swat_attention as SA
    mk = lambda *s: torch.randn(*s, generator=gen, device="cuda").to(dtype)
    q, k, v = mk(b, hq, lq, d), mk(b, hkv, lkv, d), mk(b, hkv, lkv, d)
    do = mk(b, hq, lq, d)
    o, lse = SA.swat_attention_fwd(q, k, v, sp, pattern=pat, return_lse=True)
    return q, k, v, o, lse, do


def check_backward(torch, spec):
    """dQ and dK/dV kernels against swat_attention_bwd_plain at the
    training shapes; a second launch must be bitwise equal, and each dQ
    and dK/dV launch must count on its route (with one combine launch where
    the chunk plan cut a row). The combine kernel is held bitwise against
    its plain version on the main case's partials. Then autograd through
    ops.swat_attention (both passes), kernel against banded. Returns the
    largest bf16 error of dQ and of dK/dV on the main case."""
    import dataclasses
    from repro_torch.core.types import AttentionSpec
    from repro_torch.kernels import ops
    from repro_torch.kernels import swat_backward as SB
    gen = torch.Generator(device="cuda").manual_seed(5)
    b, d, l = MAIN["b"], MAIN["d"], TRAIN["seq"]
    gspec = dataclasses.replace(spec, kind="dense", window=0, num_global=0,
                                num_random=0)
    wl = WHISPER["frames"]
    # (tag, spec, batch, q heads, kv heads, Lq, Lkv, head dim)
    cases = [("causal+globals group 4", spec, b, 32, 8, l, l, d),
             ("group 1", spec, b, 8, 8, l, l, d),
             ("group 8", spec, b, 32, 4, l, l, d),
             ("softcap 30", dataclasses.replace(spec, softcap=30.0), b, 32,
              8, l, l, d),
             ("softcap 50", dataclasses.replace(spec, softcap=50.0), b, 32,
              8, l, l, d),
             ("random blocks", dataclasses.replace(spec, num_random=2,
                                                   random_seed=7),
              b, 32, 8, l, l, d),
             ("longformer bidirectional", AttentionSpec(
                 kind="swat", window=256, num_global=1, causal=False),
              b, 12, 12, l, l, d),
             ("global rows", gspec, b, 32, 8, spec.num_global, l, d),
             ("D=128", spec, b, 32, 8, l, l, 128),
             # gemma2-2b's head dim: the two-warpgroup tensor-core dK/dV,
             # with kv block 0 cut by the chunk plan (the combine at D=256)
             ("D=256", spec, 1, 8, 4, l, l, 256),
             ("ragged whisper band", AttentionSpec(**WHISPER_BAND),
              WHISPER["clips"], 6, 6, wl, wl, d),
             # Lq != Lkv: whisper's cross attention, the decoder's max_len
             # queries against the 1500 encoder rows, dense non-causal
             ("whisper cross Lq != Lkv", AttentionSpec(kind="dense",
                                                       causal=False),
              WHISPER["clips"], 6, 6, WHISPER["max_len"], wl, d)]
    errs = {}
    for dtype in (torch.bfloat16, torch.float32):
        dn = str(dtype).split(".")[-1]
        for tag, sp, bb, hq, hkv, lq, lkv, dd in cases:
            pat = ops.get_pattern(sp, lq, lkv, 128, 128)
            q, k, v, o, lse, do = _bwd_inputs(torch, gen, dtype, bb, hq, hkv,
                                              lq, lkv, dd, sp, pat)
            want = SB.swat_attention_bwd_plain(q, k, v, o, lse, do, sp, pat,
                                               dd ** -0.5)
            before = route_counts()
            got = SB.swat_attention_bwd(q, k, v, o, lse, do, sp, pattern=pat)
            again = SB.swat_attention_bwd(q, k, v, o, lse, do, sp,
                                          pattern=pat)
            torch.cuda.synchronize()
            name = f"swat_attention_bwd {dn} {tag}"
            dq_route = expected_route(dtype, dd, "dq")
            check_route(name, before, "dq", dq_route, n=2)
            route = expected_route(dtype, dd, "dkv")
            check_route(name, before, "dkv", route, n=2)
            split = SB.dkv_plan(pat.inverse()).combine.shape[0] > 0
            combines = route_counts()["combine"] - before["combine"]
            if combines != (2 if route == "tc" and split else 0):
                raise AssertionError(f"{name}: {combines} combine launches "
                                     f"for 2 dK/dV launches (split: {split})")
            if not all(torch.equal(x, y) for x, y in zip(got, again)):
                raise AssertionError(f"{name}: two launches differ")
            e = [check_close(f"{name} d{n}", g, w, dn, **BWD_TOL[dn])
                 for n, g, w in zip("qkv", got, want)]
            errs[(dn, tag)] = e
            log(f"{name}: max abs err dq {e[0]:.3g} dk {e[1]:.3g} "
                f"dv {e[2]:.3g}, bitwise deterministic, dQ on the "
                f"{dq_route} route, dK/dV on the {route} route, {combines} "
                "combine launches")
            if (dn, tag) == ("bfloat16", "causal+globals group 4"):
                combine_err = check_combine(torch, SB, q, k, v, o, lse, do,
                                            sp, pat, got)
            del q, k, v, o, lse, do, want, got, again
    for dtype in (torch.bfloat16, torch.float32):
        dn = str(dtype).split(".")[-1]
        mk = lambda *s: torch.randn(*s, generator=gen,
                                    device="cuda").to(dtype)
        q, k, v = mk(b, 32, l, d), mk(b, 8, l, d), mk(b, 8, l, d)
        w = mk(b, 32, l, d)
        grads = {}
        for impl in ("kernel", "banded"):
            qkv = [t.detach().clone().requires_grad_() for t in (q, k, v)]
            out = ops.swat_attention(*qkv, spec, impl=impl)
            grads[impl] = torch.autograd.grad((out.float() * w.float()).sum(),
                                              qkv)
        torch.cuda.synchronize()
        for n, g, p in zip("qkv", grads["kernel"], grads["banded"]):
            err = check_close(f"autograd {dn} d{n} kernel vs banded", g, p,
                              dn, **GRAD_TOL[dn])
            log(f"autograd {dn} d{n}: kernel vs banded max abs err {err:.3g}")
    main = errs[("bfloat16", "causal+globals group 4")]
    log(f"swat_attention_bwd: {len(errs)} cases, bitwise deterministic, "
        "within tolerance, each dQ and dK/dV launch on its route; autograd "
        "kernel vs banded within tolerance")
    return main[0], max(main[1], main[2]), combine_err


def check_combine(torch, SB, q, k, v, o, lse, do, sp, pat, full):
    """The tensor-core dK/dV launch alone, then its combine launch and the
    combine's plain version on the same partials: bitwise equal to each
    other and to the full dK/dV of `full` (dq, dk, dv). Returns the max
    abs difference of the combine against its plain version (0)."""
    delta = (do.float() * o.float()).sum(-1)
    dk, dv, part_k, part_v, combine = SB.launch_dkv_tc(
        q, k, v, do, lse, delta, sp, pat, q.shape[3] ** -0.5,
        bound=k.shape[2])
    dk2, dv2 = dk.clone(), dv.clone()
    SB.dkv_combine(part_k, part_v, combine, dk, dv)
    SB.dkv_combine_plain(part_k, part_v, combine, dk2, dv2)
    torch.cuda.synchronize()
    if not (torch.equal(dk, dk2) and torch.equal(dv, dv2)):
        raise AssertionError("dkv_combine: kernel and plain version differ")
    if not (torch.equal(dk, full[1]) and torch.equal(dv, full[2])):
        raise AssertionError("dkv_combine: launch_dkv_tc + dkv_combine "
                             "differ from swat_attention_bwd's dK/dV")
    err = max(max_err(dk, dk2), max_err(dv, dv2))
    log(f"dkv_combine: {combine.shape[0]} split kv block(s), "
        f"{part_k.shape[0]} partials; bitwise equal to its plain version "
        "and to the full dK/dV")
    return err


# ------------------------------------------------------------- phase 8 ---

def _train_batches(torch, cfg, n):
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size,
                                  seq_len=TRAIN["seq"],
                                  global_batch=TRAIN["b"], seed=1234))
    return [{k: torch.as_tensor(v, device="cuda")
             for k, v in data.global_batch(s).items()} for s in range(n)]


def train(torch, cfg):
    """6 AdamW steps at full width; launch counts zeroed just before and
    read just after. Returns (summary, launches, (params, opt, step_fn,
    batch)) for the profiled step of phase 11."""
    import math
    from repro_torch import tree
    from repro_torch.core import model as Mod
    from repro_torch.kernels import swat_attention as SA
    from repro_torch.kernels import swat_backward as SB
    from repro_torch.launch import steps as St
    from repro_torch.optim import adamw
    n = TRAIN["steps"]
    params = Mod.init_model(cfg, seed=0, device="cuda")
    n_params = sum(p.numel() for p in tree.leaves(params))
    opt = adamw.init_opt_state(params)
    step_fn = St.make_train_step(
        cfg, adamw.AdamWConfig(lr=TRAIN["lr"], warmup_steps=TRAIN["warmup"],
                               total_steps=n), remat_policy="nothing")
    batches = _train_batches(torch, cfg, n)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for c in (SA.LAUNCHES, SB.DQ_LAUNCHES, SB.DKV_LAUNCHES):
        c.reset()
    before = route_counts()
    losses, gnorms, times = [], [], []
    for s in range(n):
        t0 = time.perf_counter()
        params, opt, m = step_fn(params, opt, batches[s])
        loss, gn = torch.stack([m["loss"], m["grad_norm"]]).tolist()
        times.append(time.perf_counter() - t0)
        losses.append(loss)
        gnorms.append(gn)
        log(f"train step {s}: loss {loss:.4f} grad_norm {gn:.4f} "
            f"{times[-1] * 1e3:.1f} ms")
    launches = {"swat_attention_fwd": SA.LAUNCHES.n,
                "swat_attention_dq": SB.DQ_LAUNCHES.n,
                "swat_attention_dkv": SB.DKV_LAUNCHES.n}
    check_route("train", before, "fwd", "tc", n=SA.LAUNCHES.n)
    check_route("train", before, "dq", "tc", n=SB.DQ_LAUNCHES.n)
    check_route("train", before, "dkv", "tc", n=SB.DKV_LAUNCHES.n)
    combines = route_counts()["combine"] - before["combine"]
    launches["swat_attention_dkv_combine"] = combines
    tokens = TRAIN["b"] * TRAIN["seq"]
    steady = sum(times[1:]) / (n - 1)
    summary = {"losses": losses, "grad_norms": gnorms,
               "step_ms": [t * 1e3 for t in times],
               "tokens_per_s_steps_2_6": tokens * (n - 1) / sum(times[1:]),
               "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
               "params": n_params,
               "model_tflop_per_step": 6 * n_params * tokens / 1e12,
               "model_flop_share": 6 * n_params * tokens / steady
               / PEAK_OPS["bfloat16"],
               "launches": launches}
    log("train: " + json.dumps(summary))
    if not all(math.isfinite(x) for x in losses + gnorms):
        raise AssertionError(f"non-finite training metrics: {summary}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"loss did not fall: {losses}")
    layers = cfg.num_layers
    need = {"swat_attention_fwd": 2 * layers * 2 * n,   # 2 passes, remat
            "swat_attention_dq": 2 * layers * n,
            "swat_attention_dkv": 2 * layers * n,
            # the band pass's plan cuts kv block 0; the global-row pass's
            # plan cuts nothing
            "swat_attention_dkv_combine": layers * n}
    if launches != need:
        raise AssertionError(f"train launches {launches} in {n} steps, "
                             f"expected {need}")
    return summary, launches, (params, opt, step_fn, batches[0])


# ------------------------------------------------------------- phase 9 ---

def train_end_to_end(torch, cfg):
    """One loss and gradient at full width, depth cut to 4 layers so the
    plain path fits the time: kernel path against the plain path."""
    import dataclasses
    from repro_torch import tree
    from repro_torch.core import model as Mod
    cfg4 = dataclasses.replace(cfg, num_layers=TRAIN["e2e_layers"])
    params = Mod.init_model(cfg4, seed=0, device="cuda")
    leaves = tree.leaves(params)
    batch = _train_batches(torch, cfg4, 1)[0]
    res = {}
    for impl in ("kernel", "banded"):
        for p in leaves:
            p.requires_grad_(True)
        total, _ = Mod.loss_fn(params, cfg4, batch, impl=impl)
        res[impl] = (total.item(), torch.autograd.grad(total, leaves))
    lk, gk = res["kernel"]
    lp, gp = res["banded"]
    rel = [float((a.float() - b.float()).norm() / b.float().norm().clamp(
        min=1e-30)) for a, b in zip(gk, gp)]
    worst = max(range(len(rel)), key=rel.__getitem__)
    paths = [p for p, _ in tree.flatten_with_paths(params)]
    out = {"layers": cfg4.num_layers, "loss_kernel": lk, "loss_plain": lp,
           "loss_diff": abs(lk - lp), "loss_bound": TRAIN_LOSS_BOUND,
           "max_leaf_rel_grad_err": rel[worst], "worst_leaf": paths[worst],
           "grad_bound": TRAIN_GRAD_BOUND}
    log("train e2e kernel vs plain: " + json.dumps(out))
    if not (out["loss_diff"] <= TRAIN_LOSS_BOUND
            and out["max_leaf_rel_grad_err"] <= TRAIN_GRAD_BOUND):
        raise AssertionError(f"train step kernel path vs plain path: {out}")
    return out


# ------------------------------------------------------------ phase 10 ---

def resume_drill(torch):
    """The JAX package's bit-exact resume test on the card: an
    uninterrupted 8-step run and a run that fails at step 6, then resumes
    from the step-4 checkpoint, end with bitwise-equal params."""
    import shutil
    import tempfile
    from repro_torch import tree
    from repro_torch.configs import get_smoke_config, with_swat
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.optim import adamw
    from repro_torch.runtime.trainer import TrainConfig, Trainer
    cfg = with_swat(get_smoke_config("llama3.2-1b"), window=16, num_global=4)
    root = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")

    def make(sub, fail_at=-1):
        return Trainer(
            cfg, adamw.AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=8),
            TrainConfig(total_steps=8, ckpt_every=4,
                        ckpt_dir=os.path.join(root, sub), log_every=100,
                        fail_at_step=fail_at, device="cuda"),
            DataConfig(vocab_size=cfg.vocab_size, seq_len=32,
                       global_batch=4, seed=7))

    torch.use_deterministic_algorithms(True)
    try:
        ref = make("ref").train()
        try:
            make("x", fail_at=6).train()
        except RuntimeError as e:
            if "injected failure" not in str(e):
                raise
        else:
            raise AssertionError("the failure drill did not fail")
        out = make("x").train()
    finally:
        torch.use_deterministic_algorithms(False)
        shutil.rmtree(root, ignore_errors=True)
    a = tree.leaves(ref["state"]["params"])
    b = tree.leaves(out["state"]["params"])
    same = len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))
    res = {"leaves": len(a), "bitwise_equal": same,
           "resumed_steps": len(out["history"]),
           "final_loss": out["history"][-1]["loss"]}
    log("resume drill: " + json.dumps(res))
    if not same:
        raise AssertionError("resumed params differ from the uninterrupted "
                             "run's")
    return res


# ------------------------------------------------------------ phase 11 ---

def time_backward(torch, spec):
    """dQ and dK/dV at the training shapes, their plain version (which
    computes all three gradients) and SDPA's backward (forward+backward
    minus forward) on head-expanded K/V with the same boolean mask."""
    import torch.nn.functional as F
    from repro_torch.core import patterns
    from repro_torch.kernels import ops
    from repro_torch.kernels import swat_backward as SB
    gen = torch.Generator(device="cuda").manual_seed(6)
    b, hq, hkv, d, l = MAIN["b"], MAIN["hq"], MAIN["hkv"], MAIN["d"], \
        TRAIN["seq"]
    pat = ops.get_pattern(spec, l, l, 128, 128)
    q, k, v, o, lse, do = _bwd_inputs(torch, gen, torch.bfloat16, b, hq, hkv,
                                      l, l, d, spec, pat)
    delta = (do.float() * o.float()).sum(-1)
    kw = dict(q_offset=0, kv_offset=0, bound=l)
    scale = d ** -0.5
    dq_ms = time_ms(torch, lambda: SB.launch_dq(q, k, v, do, lse, delta,
                                                spec, pat, scale, **kw))
    dkv_ms = time_ms(torch, lambda: SB.launch_dkv(q, k, v, do, lse, delta,
                                                  spec, pat, scale, **kw))
    tc_ms = time_ms(torch, lambda: SB.launch_dkv_tc(
        q, k, v, do, lse, delta, spec, pat, scale, **kw))
    dk, dv, part_k, part_v, combine = SB.launch_dkv_tc(
        q, k, v, do, lse, delta, spec, pat, scale, **kw)
    c_ms = time_ms(torch, lambda: SB.dkv_combine(part_k, part_v, combine,
                                                 dk, dv))
    cp_ms = time_ms(torch, lambda: SB.dkv_combine_plain(
        part_k, part_v, combine, dk, dv))
    p_ms = time_ms(torch, lambda: SB.swat_attention_bwd_plain(
        q, k, v, o, lse, do, spec, pat, scale))
    dm = torch.as_tensor(patterns.dense_mask(spec, l, l), device="cuda")
    qr = q.detach().clone().requires_grad_()
    ke = k.repeat_interleave(hq // hkv, dim=1).requires_grad_()
    ve = v.repeat_interleave(hq // hkv, dim=1).requires_grad_()

    def fwd():
        return F.scaled_dot_product_attention(qr, ke, ve, attn_mask=dm)

    def fwd_bwd():
        torch.autograd.grad(fwd(), (qr, ke, ve), do)

    with torch.no_grad():
        f_ms = time_ms(torch, fwd)
    l_ms = time_ms(torch, fwd_bwd) - f_ms
    n_vis = int(dm.sum()) * b * hq
    itm, rows_q, rows_kv = 2, b * hq * l, b * hkv * l
    dq_bytes = itm * d * (3 * rows_q + 2 * rows_kv) + 4 * 2 * rows_q
    dkv_bytes = itm * d * (2 * rows_q + 4 * rows_kv) + 4 * 2 * rows_q
    # the combine reads the partials of the cut kv blocks and writes their
    # dK and dV rows
    rows_cut = sum(min(pat.block_kv, l - j * pat.block_kv)
                   for j in combine[:, 0].tolist())
    c_bytes = (2 * part_k.numel() * 4
               + 2 * itm * d * b * hkv * rows_cut)
    out = {"visible_pairs": n_vis,
           "dq": (dq_ms, p_ms, l_ms, dq_bytes, 6 * d * n_vis),
           "dkv": (tc_ms, p_ms, l_ms, dkv_bytes, 8 * d * n_vis),
           "combine": (c_ms, cp_ms, None, c_bytes, part_k.numel() * 2),
           "dkv_total_ms": dkv_ms}
    log(f"backward times: dq {dq_ms:.4f} ms, dkv {dkv_ms:.4f} ms (the "
        f"tensor-core launch {tc_ms:.4f} ms + combine {c_ms:.4f} ms; the "
        f"combine's plain version {cp_ms:.4f} ms), plain {p_ms:.4f} ms, "
        f"SDPA backward {l_ms:.4f} ms (forward {f_ms:.4f}); {n_vis} visible "
        "pairs")
    return out


def time_forward_train(torch, spec):
    """The forward at the training shape (B=4, 32 q heads over 8 kv heads,
    L=2048, D=64, bf16): the band pass and the global-row pass apart, each
    with its plain version, SDPA on the same q/K/V with the pass's mask,
    and its bound. Returns {pass: (ms, plain_ms, sdpa_ms, bound_ms,
    bound_by)}."""
    import dataclasses
    import torch.nn.functional as F
    from repro_torch.core import patterns
    from repro_torch.kernels import ops
    from repro_torch.kernels import swat_attention as SA
    gen = torch.Generator(device="cuda").manual_seed(11)
    b, hq, hkv, d, l = MAIN["b"], MAIN["hq"], MAIN["hkv"], MAIN["d"], \
        TRAIN["seq"]
    g = spec.num_global
    mk = lambda *s: torch.randn(*s, generator=gen,
                                device="cuda").to(torch.bfloat16)
    q, k, v = mk(b, hq, l, d), mk(b, hkv, l, d), mk(b, hkv, l, d)
    ke = k.repeat_interleave(hq // hkv, dim=1)
    ve = v.repeat_interleave(hq // hkv, dim=1)
    gspec = dataclasses.replace(spec, kind="dense", window=0, num_global=0,
                                num_random=0)
    qg = q[:, :, :g].contiguous()
    out = {}
    for tag, sp, qq, lq in (("band pass", spec, q, l),
                            ("global-row pass", gspec, qg, g)):
        pat = ops.get_pattern(sp, lq, l, 128, 128)
        k_ms = time_ms(torch, lambda: SA.swat_attention_fwd(
            qq, k, v, sp, pattern=pat, return_lse=True))
        p_ms = time_ms(torch, lambda: SA.banded_plain(
            qq, k, v, sp, pat, d ** -0.5, return_lse=True))
        if tag == "band pass":
            dm = torch.as_tensor(patterns.dense_mask(sp, l, l), device="cuda")
            n_vis = int(dm.sum())
            kv_rows = l                       # every K/V row is visible
        else:                                 # causal: row i sees keys <= i
            dm = (torch.arange(l, device="cuda")[None, :]
                  <= torch.arange(g, device="cuda")[:, None])
            n_vis = g * (g + 1) // 2
            kv_rows = g
        l_ms = time_ms(torch, lambda: F.scaled_dot_product_attention(
            qq, ke, ve, attn_mask=dm))
        bytes_ = (2 * d * b * (2 * hq * lq + 2 * hkv * kv_rows)
                  + 4 * b * hq * lq)
        out[tag] = (k_ms, p_ms, l_ms, *bound(bytes_, 4 * d * b * hq * n_vis))
    log("forward at L=2048 (bf16, tensor-core route): " + json.dumps(
        {k_: dict(zip(("ms", "plain_ms", "sdpa_ms", "bound_ms", "bound_by"),
                      v_)) for k_, v_ in out.items()}))
    return out


def time_unembed(torch, params, cfg):
    """The decode step's unembed product (B=4 rows against the tied
    128256 x 2048 bf16 head): the fp32-output product the port uses, and
    the bf16-rounded product it replaced. Also reports whether
    aten::mm.dtype has a backward in this PyTorch."""
    import torch.nn.functional as F
    x = torch.randn(MAIN["b"], cfg.d_model, device="cuda").to(torch.bfloat16)
    emb = params["embed"]
    new_ms = time_ms(torch, lambda: torch.mm(x, emb.t(),
                                             out_dtype=torch.float32))
    old_ms = time_ms(torch, lambda: F.linear(x, emb).float())
    a = x.detach().clone().requires_grad_()
    has_bwd = True
    try:
        torch.mm(a, emb.t(), out_dtype=torch.float32).sum().backward()
    except RuntimeError as e:
        if "not implemented" not in str(e):
            raise
        has_bwd = False
    out = {"fp32_out_ms": new_ms, "bf16_rounded_ms": old_ms,
           "mm_dtype_has_backward": has_bwd}
    log("unembed: " + json.dumps(out))
    return out


def trace_train_step(torch, state):
    """torch.profiler over one warm full-width train step: device time by
    kernel category and the device's busy share of the step."""
    from torch.profiler import ProfilerActivity, profile
    params, opt, step_fn, batch = state
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        _, _, m = step_fn(params, opt, batch)
        m["loss"].item()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    dt = torch.autograd.DeviceType
    kernels = [e for e in prof.events() if e.device_type == dt.CUDA]
    out = {"wall_ms": wall_ms, "device_kernels": len(kernels)}
    if not kernels:
        out["device_time"] = "not measured (no device events traced)"
        log("train trace: " + json.dumps(out))
        return out
    by_cat, by_name = {}, {}
    for e in kernels:
        name = e.name.lower()
        cat = next((c for c, keys in _CATEGORIES
                    if any(k_ in name for k_ in keys)), "other")
        ms = e.time_range.elapsed_us() / 1e3
        by_cat[cat] = by_cat.get(cat, 0.0) + ms
        by_name[e.name[:80]] = by_name.get(e.name[:80], 0.0) + ms
    busy = _union_ms([e.time_range for e in kernels])
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
    out.update(device_ms_by_category=dict(sorted(by_cat.items())),
               device_busy_ms=busy, busy_share=busy / wall_ms,
               top_kernels_ms=dict(top))
    log("train trace: " + json.dumps(out))
    return out


# ------------------------------------------------------------ phase 12 ---

def _plain_cases(torch, gen, dtype):
    """(tag, q, k_cache, v_cache, pos, spec, ring_cap) at phase 12's three
    shapes; random cache rows (the comparison needs no FIFO history)."""
    from repro_torch.core.types import AttentionSpec
    mk = lambda *s: torch.randn(*s, generator=gen, device="cuda").to(dtype)
    i32 = lambda v: torch.tensor(v, dtype=torch.int32, device="cuda")
    n = WHISPER["frames"]
    ring = AttentionSpec(kind="swat", window=256, num_global=4, causal=True,
                         softcap=30.0)
    ring_cap = 256 + 1 + 3 + 4
    return [
        ("whisper cross", mk(8, 6, 1, 64), mk(8, 6, n, 64), mk(8, 6, n, 64),
         i32([n] * 8), AttentionSpec(kind="dense", causal=False), n),
        ("kernel_bench unpacked", mk(8, 8, 1, 64), mk(8, 2, 512, 64),
         mk(8, 2, 512, 64), i32([512 + 8] * 8),
         AttentionSpec(kind="dense", causal=True), 512),
        ("ring T=4", mk(4, 32, 4, 64), mk(4, 8, 320, 64), mk(4, 8, 320, 64),
         i32([4, 100, 1037, 5000]), ring, ring_cap),
    ]


def check_decode_plain(torch):
    """The plain-mode decode kernel against its plain version, both GQA
    layouts, bf16 and fp32; two launches bitwise equal. Then
    ops.decode_attention on the cross shape, kernel route (positional
    masks from pos = cache_len) against the JAX ref routing (valid-prefix
    mask). Returns the bf16 error at the whisper cross shape."""
    from repro_torch.kernels import ops
    from repro_torch.kernels import swat_decode as SD
    gen = torch.Generator(device="cuda").manual_seed(7)
    main_err, n = None, 0
    for dtype in (torch.bfloat16, torch.float32):
        dn = str(dtype).split(".")[-1]
        for tag, q, kc, vc, pos, spec, cap in _plain_cases(torch, gen, dtype):
            want = SD.swat_decode_plain_ref(q, kc, vc, pos, spec,
                                            ring_cap=cap)
            for pack in (True, False):
                before = SD.PLAIN_LAUNCHES.n
                got = SD.swat_decode_plain(q, kc, vc, pos, spec,
                                           ring_cap=cap, pack_gqa=pack)
                again = SD.swat_decode_plain(q, kc, vc, pos, spec,
                                             ring_cap=cap, pack_gqa=pack)
                torch.cuda.synchronize()
                name = f"swat_decode_plain {dn} {tag} pack_gqa={pack}"
                launches = SD.PLAIN_LAUNCHES.n - before
                if launches != 2:
                    raise AssertionError(f"{name}: {launches} launches for "
                                         "two calls")
                if not torch.equal(got, again):
                    raise AssertionError(f"{name}: two launches differ")
                err = check_close(name, got, want, dn)
                n += 1
                log(f"{name}: max abs err {err:.3g}, bitwise repeatable")
                if (dn, tag, pack) == ("bfloat16", "whisper cross", True):
                    main_err = err
            if tag == "whisper cross":
                cl = pos.reshape(-1, 1, 1, 1)
                got = ops.decode_attention(q, kc, vc, cl, spec,
                                           impl="kernel")
                ref = ops.decode_attention(q, kc, vc, cl, spec, impl="ref")
                torch.cuda.synchronize()
                check_close(f"ops.decode_attention {dn} cross kernel vs ref",
                            got, ref, dn)
    log(f"swat_decode_plain: {n} cases within tolerance and bitwise "
        "repeatable; ops.decode_attention kernel route vs the ref routing "
        "within tolerance")
    return main_err


def sweep_plain_splits(torch):
    """The plain-mode kernel's time (bf16) at each split count a cluster
    can take, at whisper's cross shape (B=8, 6 heads, T=1, D=64, 1500
    encoder rows, dense non-causal) and at gemma2's local layer (B=4, 8 q
    over 4 kv heads, D=256, a 4097-row ring, every row visible), beside
    the split `plain_splits` picks. The rule is written down from it."""
    from repro_torch.core.types import AttentionSpec
    from repro_torch.kernels import swat_decode as SD
    gen = torch.Generator(device="cuda").manual_seed(12)
    mk = lambda *s: torch.randn(*s, generator=gen,
                                device="cuda").to(torch.bfloat16)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    n, g = WHISPER["frames"], GEMMA
    local = AttentionSpec(kind="swat", window=g["window"], causal=True,
                          softcap=g["softcap"])
    cap = g["window"] + 1
    w = -(-cap // 64) * 64                    # as _gemma_ring allocates
    cases = {"whisper cross": (mk(8, 6, 1, 64), mk(8, 6, n, 64),
                               mk(8, 6, n, 64), 8 * [n],
                               AttentionSpec(kind="dense", causal=False), n),
             "gemma2 D=256": (mk(4, g["hq"], 1, g["d"]),
                              mk(4, g["hkv"], w, g["d"]),
                              mk(4, g["hkv"], w, g["d"]), 4 * [9000], local,
                              cap)}
    out = {}
    for tag, (q, kc, vc, lens, spec, cap) in cases.items():
        pos = torch.tensor(lens, dtype=torch.int32, device="cuda")
        times = {}
        for ns in range(1, SD.MAX_SPLITS + 1):
            times[ns] = time_ms(torch, lambda: SD.launch_plain(
                q, kc, vc, pos, spec, ring_cap=cap, scale=q.shape[-1] ** -0.5,
                pack_gqa=True, nsplit=ns), iters=20)
        chunk, chosen = SD.plain_splits(q.shape[0] * kc.shape[1], cap, sms)
        out[tag] = {"ms_by_splits": times, "chosen": chosen, "chunk": chunk,
                    "fastest": min(times, key=times.get)}
    log("plain decode split sweep (bf16, CTAs per cluster -> ms): "
        + json.dumps(out))
    return out


# ------------------------------------------------------------ phase 13 ---

def _band_pairs(seq, window):
    """Visible (query, key) pairs of one causal band of `window` (or dense
    causal for window 0) over `seq` tokens."""
    if not window:
        return seq * (seq + 1) // 2
    return sum(min(i, window) + 1 for i in range(seq))


def _gemma_ring(torch, mk, cap=GEMMA["window"] + 1):
    """Decode inputs on a gemma2 cache of `cap` rows (default the local
    layer's ring, window 4096 + 1 rows), allocated to a multiple of 64: 4
    slots, one new token each. Returns (q, k_cache, v_cache, new_k, new_v,
    num_new, ring_cap)."""
    g = GEMMA
    w = -(-cap // 64) * 64
    return (mk(4, g["hq"], 1, g["d"]), mk(4, g["hkv"], w, g["d"]),
            mk(4, g["hkv"], w, g["d"]), mk(4, g["hkv"], 1, g["d"]),
            mk(4, g["hkv"], 1, g["d"]),
            torch.ones(4, dtype=torch.int32, device="cuda"), cap)


def check_gemma2(torch):
    """All five kernel entry points against their plain versions at
    gemma2-2b's shapes (D=256), bf16 and fp32, the backward twice (bitwise
    equal), then the kernels' bf16 times at the local layer, and dK/dV's at
    the global layer too. Returns {kernel: max bf16 err} and the times."""
    from repro_torch.core.types import AttentionSpec
    from repro_torch.kernels import ops
    from repro_torch.kernels import swat_attention as SA
    from repro_torch.kernels import swat_backward as SB
    from repro_torch.kernels import swat_decode as SD
    g = GEMMA
    b, hq, hkv, d, l = g["b"], g["hq"], g["hkv"], g["d"], g["seq"]
    scale = d ** -0.5
    local = AttentionSpec(kind="swat", window=g["window"], causal=True,
                          softcap=g["softcap"])
    glob = AttentionSpec(kind="dense", causal=True, softcap=g["softcap"])
    gen = torch.Generator(device="cuda").manual_seed(8)
    errs = {}

    def note(key, dn, err):
        if dn == "bfloat16":
            errs[key] = max(errs.get(key, 0.0), err)

    for dtype in (torch.bfloat16, torch.float32):
        dn = str(dtype).split(".")[-1]
        mk = lambda *s: torch.randn(*s, generator=gen,
                                    device="cuda").to(dtype)
        q, k, v, do = (mk(b, hq, l, d), mk(b, hkv, l, d), mk(b, hkv, l, d),
                       mk(b, hq, l, d))
        for tag, sp in (("local", local), ("global", glob)):
            pat = ops.get_pattern(sp, l, l, 128, 128)
            name = f"gemma2 D=256 {dn} {tag}"
            wo, wl = SA.banded_plain(q, k, v, sp, pat, scale,
                                     return_lse=True)
            before = route_counts()
            o, lse = SA.swat_attention_fwd(q, k, v, sp, pattern=pat,
                                           return_lse=True)
            torch.cuda.synchronize()
            check_route(name + " forward", before, "fwd",
                        expected_route(dtype, d, "fwd"))
            note("swat_attention_fwd", dn,
                 check_close(name + " forward", o, wo, dn))
            check_close(name + " lse", lse, wl, dn, atol=1e-3, rtol=1e-4)
            del wo, wl
            want = SB.swat_attention_bwd_plain(q, k, v, o, lse, do, sp, pat,
                                               scale)
            before = route_counts()
            got = SB.swat_attention_bwd(q, k, v, o, lse, do, sp, pattern=pat)
            again = SB.swat_attention_bwd(q, k, v, o, lse, do, sp,
                                          pattern=pat)
            torch.cuda.synchronize()
            check_route(name + " dQ", before, "dq",
                        expected_route(dtype, d, "dq"), n=2)
            check_route(name + " dK/dV", before, "dkv",
                        expected_route(dtype, d, "dkv"), n=2)
            if not all(torch.equal(x, y) for x, y in zip(got, again)):
                raise AssertionError(f"{name}: two backward launches differ")
            del again
            e = [check_close(f"{name} d{c}", x, y, dn, **BWD_TOL[dn])
                 for c, x, y in zip("qkv", got, want)]
            note("swat_attention_dq", dn, e[0])
            note("swat_attention_dkv", dn, max(e[1], e[2]))
            log(f"{name}: forward and dq/dk/dv within tolerance (max abs "
                f"err dq {e[0]:.3g} dk {e[1]:.3g} dv {e[2]:.3g}), backward "
                "bitwise repeatable, dK/dV on the "
                f"{expected_route(dtype, d, 'dkv')} route")
            del want, got, o, lse
            torch.cuda.empty_cache()
        del q, k, v, do
        torch.cuda.empty_cache()
        # decode on the local layer's ring (window 4096, wrapped) and on the
        # global layer's dense causal cache (one row per token, 8192 rows);
        # `lens` counts tokens before the step's insert
        local_cap = g["window"] + 1
        for tag, sp, cap, lens in (
                ("local", local, local_cap, [4100, 9000, 100, local_cap]),
                ("global", glob, l, [l - 1, 8000, 100, 4096])):
            qd, kc, vc, nk, nv, ones, cap = _gemma_ring(torch, mk, cap)
            lens = torch.tensor(lens, dtype=torch.int32, device="cuda")
            name = f"gemma2 D=256 {dn} {tag}"
            want, kw, vw = SD.swat_decode_fused_plain(
                qd, kc, vc, nk, nv, lens, ones, sp, ring_cap=cap)
            got = SD.swat_decode_fused(qd, kc, vc, nk, nv, lens, ones, sp,
                                       ring_cap=cap)
            torch.cuda.synchronize()
            if not (torch.equal(kc, kw) and torch.equal(vc, vw)):
                raise AssertionError(f"{name} fused decode: caches not "
                                     "bitwise equal")
            note("swat_decode_fused", dn,
                 check_close(f"{name} fused decode", got, want, dn))
            # plain decode on the caches after the insert: lens + 1 tokens,
            # the query the newest
            tot = lens + 1
            want = SD.swat_decode_plain_ref(qd, kc, vc, tot, sp,
                                            ring_cap=cap)
            for pack in (True, False):
                got = SD.swat_decode_plain(qd, kc, vc, tot, sp, ring_cap=cap,
                                           pack_gqa=pack)
                torch.cuda.synchronize()
                note("swat_decode_plain", dn, check_close(
                    f"{name} plain decode pack_gqa={pack}", got, want, dn))
            del qd, kc, vc, nk, nv, kw, vw
            torch.cuda.empty_cache()
    log("gemma2 D=256: forward, dq, dk/dv, fused and plain decode within "
        "tolerance, bf16 and fp32, local and global layers: "
        + json.dumps(errs))

    # bf16 times at the local layer (a few calls each), and one SDPA call
    # of the same shapes and mask beside each (SDPA has no softcap: it is
    # timed without one)
    import torch.nn.functional as F
    from repro_torch.core import patterns
    mk = lambda *s: torch.randn(*s, generator=gen,
                                device="cuda").to(torch.bfloat16)
    q, k, v, do = (mk(b, hq, l, d), mk(b, hkv, l, d), mk(b, hkv, l, d),
                   mk(b, hq, l, d))
    pat = ops.get_pattern(local, l, l, 128, 128)
    o, lse = SA.swat_attention_fwd(q, k, v, local, pattern=pat,
                                   return_lse=True)
    delta = (do.float() * o.float()).sum(-1)
    kw = dict(q_offset=0, kv_offset=0, bound=l)
    n_vis = _band_pairs(l, g["window"]) * b * hq
    itm, rows_q, rows_kv = 2, b * hq * l, b * hkv * l
    times = {
        "swat_attention_fwd": (
            time_ms(torch, lambda: SA.swat_attention_fwd(
                q, k, v, local, pattern=pat, return_lse=True), iters=5),
            bound(itm * d * (2 * rows_q + 2 * rows_kv) + 4 * rows_q,
                  4 * d * n_vis)),
        "swat_attention_dq": (
            time_ms(torch, lambda: SB.launch_dq(q, k, v, do, lse, delta,
                                                local, pat, scale, **kw),
                    iters=3),
            bound(itm * d * (3 * rows_q + 2 * rows_kv) + 4 * 2 * rows_q,
                  6 * d * n_vis)),
        "swat_attention_dkv": (
            time_ms(torch, lambda: SB.launch_dkv(q, k, v, do, lse, delta,
                                                 local, pat, scale, **kw),
                    iters=3),
            bound(itm * d * (2 * rows_q + 4 * rows_kv) + 4 * 2 * rows_q,
                  8 * d * n_vis)),
    }
    del o, lse, delta
    # dK/dV at the dense causal global layer (softcap 50)
    gpat = ops.get_pattern(glob, l, l, 128, 128)
    o, lse = SA.swat_attention_fwd(q, k, v, glob, pattern=gpat,
                                   return_lse=True)
    delta = (do.float() * o.float()).sum(-1)
    times["swat_attention_dkv global"] = (
        time_ms(torch, lambda: SB.launch_dkv(q, k, v, do, lse, delta, glob,
                                             gpat, scale, **kw), iters=3),
        bound(itm * d * (2 * rows_q + 4 * rows_kv) + 4 * 2 * rows_q,
              8 * d * _band_pairs(l, 0) * b * hq))
    del o, lse, delta
    qd, kc, vc, nk, nv, ones, cap = _gemma_ring(torch, mk)
    lens = torch.full((4,), 9000, dtype=torch.int32, device="cuda")
    # every slot sees the whole window (cap rows): q in, out, K/V rows read
    # (fused: cap-1 cached rows plus the new one, which it also writes)
    io_q = 2 * 4 * hq
    dec_ops = 4 * d * 4 * hq * cap
    times["swat_decode_fused"] = (
        time_ms(torch, lambda: SD.swat_decode_fused(
            qd, kc, vc, nk, nv, lens, ones, local, ring_cap=cap)),
        bound(itm * d * (io_q + 2 * 4 * hkv * (cap + 1)), dec_ops))
    times["swat_decode_plain"] = (
        time_ms(torch, lambda: SD.swat_decode_plain(
            qd, kc, vc, lens, local, ring_cap=cap)),
        bound(itm * d * (io_q + 2 * 4 * hkv * cap), dec_ops))
    lib = _gemma_library_ms(torch, F, patterns, local, q, k, v, do, qd, kc,
                            vc, lens, cap)
    out = {k_: {"ms": t, "bound_ms": bd[0], "bound_by": bd[1],
                "library_ms": lib[k_]}
           for k_, (t, bd) in times.items()}
    log("gemma2 D=256 times (bf16, local layer unless named; decode B=4 "
        "on a 4097-row ring; library: SDPA, backward as forward+backward "
        "minus forward): " + json.dumps(out))
    del q, k, v, do, qd, kc, vc, nk, nv
    torch.cuda.empty_cache()
    return errs, out


def _gemma_library_ms(torch, F, patterns, local, q, k, v, do, qd, kc, vc,
                      lens, cap):
    """SDPA at phase 13's timed shapes: the local layer's forward and its
    backward (forward+backward minus forward, which computes dQ, dK and dV
    together) on head-expanded K/V with the band as a boolean mask, the
    global layer's backward (is_causal, the same function), and the
    decode query on the ring (after the step's insert) with the ring's
    visibility mask, whose row count the timed plain decode call also
    attends."""
    from repro_torch.kernels import ref
    g = GEMMA
    rep = g["hq"] // g["hkv"]
    dm = torch.as_tensor(patterns.dense_mask(local, g["seq"], g["seq"]),
                         device="cuda")
    qr = q.detach().clone().requires_grad_()
    ke = k.repeat_interleave(rep, dim=1).requires_grad_()
    ve = v.repeat_interleave(rep, dim=1).requires_grad_()

    def fwd():
        return F.scaled_dot_product_attention(qr, ke, ve, attn_mask=dm)

    def causal():  # the global layer: dense causal, SDPA's own mask
        return F.scaled_dot_product_attention(qr, ke, ve, is_causal=True)

    with torch.no_grad():
        f_ms = time_ms(torch, fwd, iters=3)
        fc_ms = time_ms(torch, causal, iters=3)
    b_ms = time_ms(torch, lambda: torch.autograd.grad(fwd(), (qr, ke, ve),
                                                      do), iters=3) - f_ms
    bc_ms = time_ms(torch, lambda: torch.autograd.grad(
        causal(), (qr, ke, ve), do), iters=3) - fc_ms
    del qr, ke, ve, dm
    w = kc.shape[2]
    t_s, ok = ref.ring_slot_positions(lens.long() + 1, w, ring_cap=cap,
                                      num_global=0)
    qp = lens.long()[:, None]
    vis = (ok & (t_s <= qp) & (t_s >= qp - local.window))[:, None, None, :]
    kce = kc.repeat_interleave(rep, dim=1)
    vce = vc.repeat_interleave(rep, dim=1)
    d_ms = time_ms(torch, lambda: F.scaled_dot_product_attention(
        qd, kce, vce, attn_mask=vis))
    torch.cuda.empty_cache()
    return {"swat_attention_fwd": f_ms, "swat_attention_dq": b_ms,
            "swat_attention_dkv": b_ms, "swat_attention_dkv global": bc_ms,
            "swat_decode_fused": d_ms, "swat_decode_plain": d_ms}


# ------------------------------------------------------------ phase 14 ---

def whisper_setup(torch, dtype_name):
    """Full-width whisper-tiny + SWAT in `dtype_name`, random weights from
    seed 0, and a batch of 8 clips of random frame embeddings (the conv
    frontend is a stub) with 16-token prompts, from seed 9."""
    import dataclasses
    from repro_torch.configs import get_config, with_swat
    from repro_torch.core import model as Mod
    cfg = with_swat(get_config("whisper-tiny"), window=WHISPER["window"],
                    num_global=WHISPER["num_global"])
    cfg = dataclasses.replace(cfg, dtype=dtype_name)
    params = Mod.init_model(cfg, seed=0, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(9)
    enc = torch.randn(WHISPER["clips"], WHISPER["frames"], cfg.d_model,
                      generator=gen, device="cuda")
    tok = torch.randint(0, cfg.vocab_size,
                        (WHISPER["clips"], WHISPER["prompt"]),
                        generator=gen, device="cuda")
    return cfg, params, {"enc_embeddings": enc, "tokens": tok}


def whisper_run(torch, cfg, params, batch, impl, steps, forced=None,
                keep_logits=False):
    """Prefill, then `steps` greedy decode steps (fed with `forced[i]`
    instead of the path's own token when given). Returns (tokens
    (steps+1, B) on the card, per-step last logits or None, host seconds
    of the prefill and of the decode steps). Two host syncs: after the
    prefill and after the last step."""
    from repro_torch.core import model as Mod
    t0 = time.perf_counter()
    logits, caches = Mod.prefill(params, cfg, batch, WHISPER["max_len"],
                                 impl=impl)
    tok = logits[:, 0].argmax(-1)
    toks, kept = [tok], ([logits[:, 0]] if keep_logits else None)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    for i in range(steps):
        feed = tok if forced is None else forced[i]
        logits, caches = Mod.decode_step(params, cfg,
                                         {"tokens": feed[:, None]}, caches,
                                         impl=impl)
        tok = logits[:, 0].argmax(-1)
        toks.append(tok)
        if keep_logits:
            kept.append(logits[:, 0])
    toks = torch.stack(toks)
    torch.cuda.synchronize()
    return toks, kept, {"prefill_s": t1 - t0,
                        "decode_s": time.perf_counter() - t1}


def whisper(torch):
    """Phase 14 (the main run, bf16, launch counts), 15 (kernel vs plain
    path, bf16 teacher-forced and fp32 free-running) and 16 (times)."""
    from repro_torch.kernels import swat_attention as SA
    from repro_torch.kernels import swat_decode as SD
    steps, clips = WHISPER["steps"], WHISPER["clips"]
    cfg, params, batch = whisper_setup(torch, "bfloat16")
    whisper_run(torch, cfg, params, batch, None, 2)     # warm-up
    torch.cuda.reset_peak_memory_stats()
    counters = {"swat_attention_fwd": SA.LAUNCHES,
                "swat_decode_fused": SD.LAUNCHES,
                "swat_decode_plain": SD.PLAIN_LAUNCHES}
    for c in counters.values():
        c.reset()
    before = route_counts()
    toks, _, host = whisper_run(torch, cfg, params, batch, None, steps)
    launches = {k: c.n for k, c in counters.items()}
    check_route("whisper bf16", before, "fwd", "tc",
                n=launches["swat_attention_fwd"])
    peak = torch.cuda.max_memory_allocated() / 1e9
    toks_host = toks.cpu()
    n_enc, n_dec = cfg.encoder_layers, cfg.num_layers
    passes = 2 if cfg.attention.num_global else 1  # band + global rows
    expected = {"swat_attention_fwd": n_enc * passes + n_dec * passes
                + n_dec,                 # encoder, decoder self, cross
                "swat_decode_fused": n_dec * steps,
                "swat_decode_plain": n_dec * steps}
    if launches != expected:
        raise AssertionError(f"whisper launches {launches}, expected "
                             f"{expected}")
    if int(toks_host.min()) < 0 or int(toks_host.max()) >= cfg.vocab_size:
        raise AssertionError("whisper: token out of range")
    summary = {"clips": clips, "frames": WHISPER["frames"],
               "prompt": WHISPER["prompt"], "decode_steps": steps,
               "tokens_per_clip": steps + 1,
               "prefill_ms": host["prefill_s"] * 1e3,
               "decode_ms_per_step": host["decode_s"] * 1e3 / steps,
               "decode_tokens_per_s": clips * steps / host["decode_s"],
               "peak_mem_gb": peak, "launches": launches,
               "expected_launches": expected,
               "distinct_tokens": int(toks_host.unique().numel())}
    log("whisper: " + json.dumps(summary))

    # phase 15a: bf16, both paths teacher-forced on the main run's tokens
    _, logits_k, _ = whisper_run(torch, cfg, params, batch, None, steps,
                                 forced=toks[:-1], keep_logits=True)
    _, logits_p, _ = whisper_run(torch, cfg, params, batch, "banded", steps,
                                 forced=toks[:-1], keep_logits=True)
    if not all(bool(torch.isfinite(x).all()) for x in logits_k):
        raise AssertionError("whisper: non-finite logits")
    diffs = [max_err(a, b) for a, b in zip(logits_k, logits_p)]
    agree = sum((a.argmax(-1) == b.argmax(-1)).float().mean().item()
                for a, b in zip(logits_k, logits_p)) / len(logits_k)
    del logits_k, logits_p
    e2e = {"bf16_max_abs_logit_diff": max(diffs),
           "bf16_logit_bound": WHISPER_LOGIT_BOUND,
           "bf16_greedy_agreement": agree, "steps": steps}

    # phase 16: device times and a traced decode block, bf16 model
    times = whisper_times(torch, cfg, params, batch)
    log("whisper times: " + json.dumps(times))
    del params
    torch.cuda.empty_cache()

    # phase 15b: fp32, both paths free-running: greedy tokens equal, and
    # (on those equal tokens) logits within WHISPER_FP32_LOGIT_BOUND
    cfg32, p32, b32 = whisper_setup(torch, "float32")
    before, fwd_before = route_counts(), SA.LAUNCHES.n
    tk, lk, _ = whisper_run(torch, cfg32, p32, b32, None, steps,
                            keep_logits=True)
    check_route("whisper fp32", before, "fwd", "simt",
                n=SA.LAUNCHES.n - fwd_before)
    tp, lp, _ = whisper_run(torch, cfg32, p32, b32, "banded", steps,
                            keep_logits=True)
    same = torch.equal(tk, tp)
    first_diff = (None if same else
                  int((tk != tp).any(dim=1).nonzero()[0, 0]))
    fp32_diff = max(max_err(a, b) for a, b in zip(lk, lp))
    del lk, lp
    e2e.update(fp32_tokens_equal=same, fp32_first_differing_step=first_diff,
               fp32_max_abs_logit_diff=fp32_diff,
               fp32_logit_bound=WHISPER_FP32_LOGIT_BOUND,
               fp32_distinct_tokens=int(tk.unique().numel()))
    log("whisper e2e kernel vs plain: " + json.dumps(e2e))
    del p32
    torch.cuda.empty_cache()
    if not same:
        raise AssertionError(f"whisper fp32: kernel path tokens differ from "
                             f"the plain path's from step {first_diff}")
    if not fp32_diff <= WHISPER_FP32_LOGIT_BOUND:
        raise AssertionError(f"whisper fp32 kernel vs plain path: {e2e}")
    if not max(diffs) <= WHISPER_LOGIT_BOUND:
        raise AssertionError(f"whisper bf16 kernel vs plain path: {e2e}")
    return summary, e2e, times


def whisper_times(torch, cfg, params, batch):
    """Encoder and prefill device times (CUDA events, mean of 5), and a
    profiled decode block of 8 steps split by kernel category."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core import model as Mod

    def timed(fn, n=5):
        fn()
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        for _ in range(n):
            fn()
        e.record()
        e.synchronize()
        return s.elapsed_time(e) / n

    with torch.no_grad():
        enc_ms = timed(lambda: Mod.encode(params, cfg, batch))
    pre_ms = timed(lambda: Mod.prefill(params, cfg, batch,
                                       WHISPER["max_len"]))
    logits, caches = Mod.prefill(params, cfg, batch, WHISPER["max_len"])
    tok = logits[:, 0].argmax(-1)
    n = 8
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            logits, caches = Mod.decode_step(params, cfg,
                                             {"tokens": tok[:, None]}, caches)
            tok = logits[:, 0].argmax(-1)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    out = {"encoder_ms": enc_ms, "prefill_ms": pre_ms, "trace_steps": n,
           "trace_wall_ms": wall_ms}
    dt = torch.autograd.DeviceType
    kernels = [e for e in prof.events() if e.device_type == dt.CUDA]
    if not kernels:
        out["device_time"] = "not measured (no device events traced)"
        return out
    by_cat = {}
    for e in kernels:
        name = e.name.lower()
        cat = next((c for c, keys in _CATEGORIES
                    if any(k_ in name for k_ in keys)), "other")
        by_cat[cat] = by_cat.get(cat, 0.0) + e.time_range.elapsed_us() / 1e3
    busy = _union_ms([e.time_range for e in kernels])
    calls = n * cfg.num_layers
    # each plain decode call is one decode_plain_kernel, merge included
    plain = [e for e in kernels if "decode_plain_kernel" in e.name]
    stray = sorted({e.name[:60] for e in kernels if "decode" in e.name.lower()
                    and "decode_plain_kernel" not in e.name
                    and "decode_fused_kernel" not in e.name})
    if len(plain) != calls or stray:
        raise AssertionError(f"whisper trace: {len(plain)} plain decode "
                             f"kernels for {calls} calls; other decode "
                             f"kernels: {stray}")
    out.update(device_kernels_per_step=len(kernels) / n,
               plain_decode_kernels_per_step=len(plain) / n,
               plain_decode_us_per_call=sum(
                   e.time_range.elapsed_us() for e in plain) / calls,
               device_ms_per_step_by_category={
                   k: v / n for k, v in sorted(by_cat.items())},
               device_busy_ms_per_step=busy / n,
               device_busy_share=busy / wall_ms)
    return out


def time_decode_plain(torch):
    """Kernel #3 at whisper's cross shape (B=8, 6 heads, T=1, D=64, 1500
    encoder rows, bf16): the kernel, its plain version, and SDPA on the
    same q, K, V (dense, no mask: the same function)."""
    import torch.nn.functional as F
    from repro_torch.core.types import AttentionSpec
    from repro_torch.kernels import swat_decode as SD
    gen = torch.Generator(device="cuda").manual_seed(10)
    b, h, d, n = WHISPER["clips"], 6, 64, WHISPER["frames"]
    mk = lambda *s: torch.randn(*s, generator=gen,
                                device="cuda").to(torch.bfloat16)
    q, kc, vc = mk(b, h, 1, d), mk(b, h, n, d), mk(b, h, n, d)
    pos = torch.full((b,), n, dtype=torch.int32, device="cuda")
    spec = AttentionSpec(kind="dense", causal=False)
    k_ms = time_ms(torch, lambda: SD.swat_decode_plain(q, kc, vc, pos, spec))
    p_ms = time_ms(torch, lambda: SD.swat_decode_plain_ref(q, kc, vc, pos,
                                                           spec))
    l_ms = time_ms(torch, lambda: F.scaled_dot_product_attention(q, kc, vc))
    bytes_ = 2 * d * (2 * b * h + 2 * b * h * n)
    ops_ = 4 * d * b * h * n
    return k_ms, p_ms, l_ms, bytes_, ops_


# ------------------------------------------------------------ phase 17 ---

def _chunk_case(torch, gen, dtype, b, hq, hkv, d, t, pos0, w):
    """A prefill chunk's inputs: q, k_new, v_new for tokens [pos0, pos0+T),
    a random ring cache (B, Hkv, W, D) as it stands before the chunk, and
    ragged lengths (row 0 runs past the chunk, row 1 ends inside it, other
    rows end at its end)."""
    mk = lambda *s: torch.randn(*s, generator=gen, device="cuda").to(dtype)
    q = mk(b, hq, t, d)
    kn, vn = mk(b, hkv, t, d), mk(b, hkv, t, d)
    kc, vc = mk(b, hkv, w, d), mk(b, hkv, w, d)
    lens = torch.full((b,), pos0 + t, dtype=torch.int32, device="cuda")
    lens[0] = pos0 + t + 100
    if b > 1:
        lens[1] = pos0 + t // 2
    return q, kn, vn, kc, vc, lens


def chunk_cases(spec):
    """(name, spec, b, hq, hkv, d, T, pos0, logical ring capacity, physical
    rows): llama's serve chunk (window 256, 4 globals, a 261-row ring in
    320 rows) at pos0 0, 64 and 448 (after a wrap), the same chunk on a
    dense causal layer (a 1024-row cache), and gemma2-2b's D=256 local
    layer (window 4096, softcap 50, a 4097-row ring in 4160 rows) after a
    wrap."""
    import dataclasses
    from repro_torch.core.types import AttentionSpec
    cap = MAIN["window"] + 1 + MAIN["num_global"]
    gl = AttentionSpec(kind="swat", window=GEMMA["window"],
                       softcap=GEMMA["softcap"])
    ll = (spec, MAIN["b"], MAIN["hq"], MAIN["hkv"], MAIN["d"], CHUNK)
    dense = dataclasses.replace(spec, kind="dense", window=0, num_global=0)
    return [(f"llama pos0={p}", *ll, p, cap, 320) for p in (0, 64, 448)] + [
        ("llama dense causal pos0=448", dense, *ll[1:], 448, MAIN["max_len"],
         MAIN["max_len"]),
        ("gemma2 local D=256 pos0=4480", gl, GEMMA["b"] + 1, GEMMA["hq"],
         GEMMA["hkv"], GEMMA["d"], CHUNK, 4480, GEMMA["window"] + 1, 4160)]


def check_chunk(torch, spec):
    """Kernel #2 as a prefill chunk launches it: pass A (the gathered ring
    tail and the chunk, q_offset = pos0, kv_offset = lo, seq_kv_bound =
    pos0 + T, return_lse) and pass B (the pinned globals) against
    `banded_plain` with the same arguments, O within TOL and the LSE within
    atol 1e-3, each launch on its route; then the whole chunk route
    (`ops.prefill_chunk_attention`, impl "kernel") against the plain chunk
    attention on the card at every real position. bf16 and fp32. Returns
    the largest error of each dtype."""
    from repro_torch.kernels import ops
    from repro_torch.kernels import swat_attention as SA
    from repro_torch.core.types import AttentionSpec
    gen = torch.Generator(device="cuda").manual_seed(17)
    worst, n = {}, 0
    for dtype in (torch.bfloat16, torch.float32):
        dn = str(dtype).split(".")[-1]
        for (name, sp, b, hq, hkv, d, t, pos0, cap, w) in chunk_cases(spec):
            q, kn, vn, kc, vc, lens = _chunk_case(torch, gen, dtype, b, hq,
                                                  hkv, d, t, pos0, w)
            g = sp.num_global if sp.is_sparse else 0
            ring = cap - g
            lo = max(g, pos0 - ring) if pos0 >= g else pos0
            slots = g + torch.remainder(
                torch.arange(lo, pos0, device="cuda") - g, ring)
            kb = torch.cat([kc.index_select(2, slots), kn], dim=2)
            vb = torch.cat([vc.index_select(2, slots), vn], dim=2)
            pat = ops.get_pattern(sp, t, kb.shape[2], 128, 128,
                                  q_shift=pos0 - lo)
            off = dict(q_offset=pos0, kv_offset=lo, seq_kv_bound=pos0 + t)
            want, wl = SA.banded_plain(q, kb, vb, sp, pat, d ** -0.5,
                                       return_lse=True, **off)
            before = route_counts()
            got, gl = SA.swat_attention_fwd(q, kb, vb, sp, pattern=pat,
                                            return_lse=True, **off)
            torch.cuda.synchronize()
            tag = f"chunk {dn} {name}"
            check_route(tag, before, "fwd", expected_route(dtype, d, "fwd"))
            err = check_close(tag + " pass A", got, want, dn)
            check_close(tag + " pass A lse", gl, wl, dn, atol=1e-3,
                        rtol=1e-4)
            ng = min(pos0, g)
            if ng:
                pinned = AttentionSpec(kind="dense", causal=False,
                                       softcap=sp.softcap)
                kp = kc[:, :, :ng].contiguous()
                vp = vc[:, :, :ng].contiguous()
                ppat = ops.get_pattern(pinned, t, ng, 128, 128)
                want, wl = SA.banded_plain(q, kp, vp, pinned, ppat,
                                           d ** -0.5, return_lse=True)
                before = route_counts()
                got, gl = SA.swat_attention_fwd(q, kp, vp, pinned,
                                                pattern=ppat,
                                                return_lse=True)
                torch.cuda.synchronize()
                check_route(tag + " pass B", before, "fwd",
                            expected_route(dtype, d, "fwd"))
                err = max(err, check_close(tag + " pass B", got, want, dn))
                check_close(tag + " pass B lse", gl, wl, dn, atol=1e-3,
                            rtol=1e-4)
            before = route_counts()
            got = ops.prefill_chunk_attention(q, kn, vn, kc, vc, sp, pos0,
                                              lens, ring_cap=cap,
                                              impl="kernel")
            want = ops.prefill_chunk_attention(q, kn, vn, kc, vc, sp, pos0,
                                               lens, ring_cap=cap,
                                               impl="banded")
            torch.cuda.synchronize()
            check_route(tag + " route", before, "fwd",
                        expected_route(dtype, d, "fwd"), n=2 if ng else 1)
            real = (pos0 + torch.arange(t, device="cuda"))[None] < lens[:, None]
            sel = real[:, None, :, None].expand_as(got)
            err = max(err, check_close(tag + " route vs plain", got[sel],
                                       want[sel], dn))
            worst[dn] = max(worst.get(dn, 0.0), err)
            n += 1
            del q, kn, vn, kc, vc, kb, vb, got, want
    log(f"chunk: {n} cases (llama's chunk at pos0 0/64/448, its dense "
        "layer, gemma2's D=256 local layer, x bf16/fp32): pass A with "
        "offsets and pass B within tolerance, LSE within 1e-3, each launch "
        "on its route; the chunk route vs the plain chunk attention within "
        f"tolerance; worst errors {json.dumps(worst)}")
    return worst


def time_chunk(torch, spec, dtype_name="bfloat16"):
    """Kernel #2's pass A at the serve chunk after a wrap (B=4, 64 queries
    at pos0 448 against the 257-row ring tail and the chunk, 321 keys):
    the kernel, `banded_plain` and SDPA with the band as a boolean mask
    over the gathered buffer; then the whole chunk route and the plain
    chunk attention. Returns (k_ms, p_ms, l_ms, bytes, ops, route_ms,
    plain_route_ms)."""
    import torch.nn.functional as F
    from repro_torch.kernels import ops
    from repro_torch.kernels import swat_attention as SA
    dtype = getattr(torch, dtype_name)
    name, sp, b, hq, hkv, d, t, pos0, cap, w = chunk_cases(spec)[2]
    gen = torch.Generator(device="cuda").manual_seed(18)
    q, kn, vn, kc, vc, lens = _chunk_case(torch, gen, dtype, b, hq, hkv, d,
                                          t, pos0, w)
    g = sp.num_global
    lo = max(g, pos0 - (cap - g))
    slots = g + torch.remainder(torch.arange(lo, pos0, device="cuda") - g,
                                cap - g)
    kb = torch.cat([kc.index_select(2, slots), kn], dim=2)
    vb = torch.cat([vc.index_select(2, slots), vn], dim=2)
    lkv = kb.shape[2]
    pat = ops.get_pattern(sp, t, lkv, 128, 128, q_shift=pos0 - lo)
    off = dict(q_offset=pos0, kv_offset=lo, seq_kv_bound=pos0 + t)
    k_ms = time_ms(torch, lambda: SA.swat_attention_fwd(
        q, kb, vb, sp, pattern=pat, return_lse=True, **off))
    p_ms = time_ms(torch, lambda: SA.banded_plain(
        q, kb, vb, sp, pat, d ** -0.5, return_lse=True, **off))
    kidx = lo + torch.arange(lkv, device="cuda")
    qidx = pos0 + torch.arange(t, device="cuda")[:, None]
    mask = (kidx <= qidx) & (kidx >= qidx - sp.window)        # (T, Lkv)
    ke = kb.repeat_interleave(hq // hkv, dim=1)
    ve = vb.repeat_interleave(hq // hkv, dim=1)
    l_ms = time_ms(torch, lambda: F.scaled_dot_product_attention(
        q, ke, ve, attn_mask=mask))
    r_ms = time_ms(torch, lambda: ops.prefill_chunk_attention(
        q, kn, vn, kc, vc, sp, pos0, lens, ring_cap=cap, impl="kernel"))
    pr_ms = time_ms(torch, lambda: ops.prefill_chunk_attention(
        q, kn, vn, kc, vc, sp, pos0, lens, ring_cap=cap, impl="banded"))
    itm = q.element_size()
    bytes_ = (itm * d * (2 * b * hq * t + 2 * b * hkv * lkv)
              + 4 * b * hq * t)
    ops_ = 4 * d * b * hq * int(mask.sum())
    return k_ms, p_ms, l_ms, bytes_, ops_, r_ms, pr_ms


# ------------------------------------------------------------ phase 18 ---

def _serve_run(torch, cfg, params, prompts, n_new, **kw):
    from repro_torch.serving.engine import Request, ServingEngine
    eng = ServingEngine(cfg, params, batch_slots=4, max_len=MAIN["max_len"],
                        scan_steps=8, **kw)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = eng.run([Request(rid=i, prompt=p, max_new_tokens=n_new)
                   for i, p in enumerate(prompts)])
    torch.cuda.synchronize()
    return eng, res, time.perf_counter() - t0


def _cell_kw(cell):
    from repro_torch.serving.drafter import NGramDrafter
    return {"default": {}, "chunked": {"prefill_chunk": CHUNK},
            "speculative": {"speculative": SPEC_K,
                            "draft": NGramDrafter(**DRAFT)}}[cell]


def serve_cells(torch, cfg, params, cells, route):
    """Each cell's engine serves the 8 requests of phase 3 after a short
    warm-up. The launch counters are zeroed just before each run and read
    just after: the banded forward launches once per layer for each chunk's
    pass A and once more for each chunk with pinned globals before it (a
    single-shot batch: the band pass and the global-row pass), the fused
    decode once per layer and decode or verify step, every forward launch
    on `route`. Returns {cell: (summary, tokens, engine)}."""
    import numpy as np
    from repro_torch.kernels import swat_attention as SA
    from repro_torch.kernels import swat_decode as SD
    rng = np.random.RandomState(0)
    prompts = [rng.randint(0, cfg.vocab_size, (MAIN["prompt"],))
               .astype(np.int32) for _ in range(8)]
    layers = cfg.num_layers
    g = cfg.attention.num_global
    out = {}
    for cell in cells:
        kw = _cell_kw(cell)
        _serve_run(torch, cfg, params, prompts[:4], 4, **kw)    # warm-up
        SD.LAUNCHES.reset()
        SA.LAUNCHES.reset()
        before = route_counts()
        eng, res, wall = _serve_run(torch, cfg, params, prompts,
                                    MAIN["new_tokens"], **kw)
        launches = {"swat_decode": SD.LAUNCHES.n,
                    "swat_attention_fwd": SA.LAUNCHES.n}
        check_route(f"serve {cell}", before, "fwd", route,
                    n=SA.LAUNCHES.n)
        st = eng.stats
        for r in res:
            if r.status != "ok" or len(r.tokens) != MAIN["new_tokens"]:
                raise AssertionError(f"{cell} request {r.rid}: {r.status}, "
                                     f"{len(r.tokens)} tokens")
        chunks = -(-MAIN["prompt"] // eng.prefill_chunk) \
            if eng.prefill_chunk else 1
        per_batch = (chunks + (chunks - 1 if g else 0) if chunks > 1
                     else (2 if g else 1))
        expected = {"swat_decode": layers * st["decode_steps"],
                    "swat_attention_fwd": layers * per_batch
                    * st["prefill_batches"]}
        if launches != expected:
            raise AssertionError(f"serve {cell}: launches {launches}, "
                                 f"expected {expected}")
        n_tok = sum(len(r.tokens) for r in res)
        summary = {
            "tokens": n_tok, "wall_s": wall, "tok_per_s": n_tok / wall,
            "prefill_batches": st["prefill_batches"],
            "prefill_ms_per_batch": st["prefill_s"] * 1e3
            / st["prefill_batches"],
            "decode_steps": st["decode_steps"],
            "decode_ms_per_step": st["decode_s"] * 1e3 / st["decode_steps"],
            "tokens_per_step_per_slot": st["tokens_emitted"]
            / (st["decode_steps"] * 4),
            "spec_steps": st["spec_steps"],
            "acceptance_rate": eng.acceptance_rate,
            "launches": launches,
            "fwd_launches_per_batch": launches["swat_attention_fwd"]
            / st["prefill_batches"]}
        log(f"serve {cell} ({str(params['embed'].dtype)}): "
            + json.dumps(summary))
        out[cell] = (summary, [r.tokens for r in res], eng)
    return out, prompts


def serve_slice(torch, cfg, params):
    """Phase 18, bf16: the chunked (prefill_chunk 64) and speculative (k=4)
    cells at full width and depth, then their gates against the default
    engine: chunked against single-shot first-token logits (max |dlogit|
    <= LOGIT_BOUND) on the first four prompts, and the speculative run's
    tokens against sequential decode teacher-forced along them (greedy
    agreement >= AGREE_BOUND)."""
    from repro_torch.core import model as Mod
    import numpy as np
    from repro_torch.serving.engine import ServingEngine
    cells, prompts = serve_cells(torch, cfg, params,
                                 ("chunked", "speculative"), "tc")
    base = ServingEngine(cfg, params, batch_slots=4, max_len=MAIN["max_len"])
    tok = torch.as_tensor(np.stack(prompts[:4]), device="cuda")
    lens = torch.full((4,), MAIN["prompt"], dtype=torch.int32, device="cuda")
    chunk_eng = cells["chunked"][2]
    lc, _ = chunk_eng.prefill_logits(tok, lens)
    ls, _ = base.prefill_logits(tok, lens)
    dlogit = max_err(lc, ls)
    spec_toks = torch.as_tensor(cells["speculative"][1][:4], device="cuda")
    logits, caches = Mod.prefill(params, cfg, {"tokens": tok},
                                 MAIN["max_len"])
    agree = [(logits[:, 0].argmax(-1) == spec_toks[:, 0]).float().mean()]
    for j in range(1, spec_toks.shape[1]):
        logits, _ = Mod.decode_step(params, cfg,
                                    {"tokens": spec_toks[:, j - 1:j]}, caches)
        agree.append((logits[:, 0].argmax(-1) == spec_toks[:, j])
                     .float().mean())
    agreement = float(torch.stack(agree).mean())
    gates = {"chunked_first_token_max_abs_logit_diff": dlogit,
             "logit_bound": LOGIT_BOUND,
             "speculative_teacher_forced_agreement": agreement,
             "agreement_bound": AGREE_BOUND}
    log("serve slice gates (bf16): " + json.dumps(gates))
    if not (dlogit <= LOGIT_BOUND and agreement >= AGREE_BOUND):
        raise AssertionError(f"serve slice gates: {gates}")
    return {c: v[0] for c, v in cells.items()}, gates


def serve_slice_fp32(torch, cfg):
    """Phase 19, fp32 at full width and depth (the SIMT forward): the
    default, chunked and speculative cells serve the same 8 requests, and
    their greedy tokens must be equal on every request."""
    import dataclasses
    from repro_torch.core import model as Mod
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    params = Mod.init_model(cfg32, seed=0, device="cuda")
    cells, _ = serve_cells(torch, cfg32, params,
                           ("default", "chunked", "speculative"), "simt")
    base = cells["default"][1]
    for cell in ("chunked", "speculative"):
        got = cells[cell][1]
        bad = [i for i, (a, b) in enumerate(zip(got, base)) if a != b]
        if bad:
            raise AssertionError(f"fp32 {cell}: greedy tokens differ from "
                                 f"the default engine's on requests {bad}")
    log("serve slice fp32: chunked and speculative greedy tokens equal the "
        "default engine's on all 8 requests")
    out = {c: v[0] for c, v in cells.items()}
    del params
    return out


def ptxas_report(out):
    """(kernel, registers, spill-store bytes) for every entry function in
    the `nvcc -Xptxas -v` output of one source; kernel reads like
    attention_fwd_tc_kernel<bf16,64>."""
    import re
    rows, name, spill = [], None, 0
    for line in out.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            k = re.search(r"\d+([a-z_]+kernel)(I(\w*?)EE|E)", m.group(1))
            name = m.group(1)[-40:]
            if k:
                targs = k.group(3) or ""
                dt = ("bf16" if "bfloat16" in targs else
                      "fp32" if targs.startswith("f") else "")
                dd = re.search(r"Li(\d+)E", targs + "E")
                name = k.group(1) + (
                    f"<{','.join(x for x in (dt, dd and dd.group(1)) if x)}>"
                    if targs else "")
            spill = 0
            continue
        m = re.search(r"(\d+) bytes spill stores", line)
        if m:
            spill = int(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            rows.append((name, int(m.group(1)), spill))
            name = None
    return rows


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
    spilled = []
    for stem, out in sorted(_build.BUILD_LOG.items()):
        for kernel, regs, spill in ptxas_report(out):
            log(f"ptxas {stem} {kernel}: {regs} registers, {spill} bytes "
                "spilled")
            if spill and kernel.startswith(NO_SPILL):
                spilled.append(kernel)
    if spilled:
        raise AssertionError(f"ptxas: register spills in {spilled}")

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
    unembed = time_unembed(torch, params, cfg)
    db_ms, db_by = bound(db, do)
    fb_ms, fb_by = bound(fb, fo)

    # this slice's path: chunked prefill and speculative decoding
    chunk_err = check_chunk(torch, spec)
    ck = time_chunk(torch, spec)
    ck32 = time_chunk(torch, spec, "float32")
    vk = time_decode(torch, spec, t=SPEC_K + 1)
    cells, cell_gates = serve_slice(torch, cfg, params)
    trace_chunked = trace_decode(torch, cfg, params, span="engine.prefill",
                                 n_new=2, **_cell_kw("chunked"))
    trace_single = trace_decode(torch, cfg, params, span="engine.prefill",
                                n_new=2)
    trace_spec = trace_decode(torch, cfg, params, **_cell_kw("speculative"))
    del params
    cells32 = serve_slice_fp32(torch, cfg)

    dq_err, dkv_err, combine_err = check_backward(torch, spec)
    tr, tr_launches, tr_state = train(torch, cfg)
    bt = time_backward(torch, spec)
    ft = time_forward_train(torch, spec)
    ttrace = trace_train_step(torch, tr_state)
    del tr_state
    tr_e2e = train_end_to_end(torch, cfg)
    resume = resume_drill(torch)

    plain_err = check_decode_plain(torch)
    sweep = sweep_plain_splits(torch)
    g2_errs, g2_times = check_gemma2(torch)
    wh, wh_e2e, wh_times = whisper(torch)
    pk, pp, pl, pb, po = time_decode_plain(torch)
    pb_ms, pb_by = bound(pb, po)
    kernels = [
        {"name": "swat_decode_fused", "route": "cuda",
         "source": "src/repro_torch/csrc/swat_decode.cu",
         "replaces": "src/repro/kernels/swat_decode.py:116",
         "launches": summary["launches"]["swat_decode"],
         "max_abs_err": dec_err[1], "ms": dk, "plain_ms": dp,
         "bound_ms": db_ms, "bound_by": db_by, "library_ms": dl},
        {"name": "swat_attention_fwd_tc", "route": "cuda",
         "source": "src/repro_torch/csrc/swat_attention_fwd.cu",
         "replaces": "src/repro/kernels/swat_attention.py:64",
         "launches": summary["launches"]["swat_attention_fwd"],
         "max_abs_err": fwd_err, "ms": fk, "plain_ms": fp,
         "bound_ms": fb_ms, "bound_by": fb_by, "library_ms": fl},
        {"name": "swat_decode_plain", "route": "cuda",
         "source": "src/repro_torch/csrc/swat_decode.cu",
         "replaces": "src/repro/kernels/swat_decode.py:368",
         "launches": wh["launches"]["swat_decode_plain"],
         "max_abs_err": plain_err, "ms": pk, "plain_ms": pp,
         "bound_ms": pb_ms, "bound_by": pb_by, "library_ms": pl},
    ]
    # this slice's launch configurations: the verify step's T = k+1 rows,
    # and pass A of a prefill chunk with offsets (bf16 on the tensor-core
    # kernel, fp32 on the SIMT one)
    vb_ms, vb_by = bound(vk[3], vk[4])
    kernels.append(
        {"name": "swat_decode_fused (verify step, T=5)", "route": "cuda",
         "source": "src/repro_torch/csrc/swat_decode.cu",
         "replaces": "src/repro/kernels/swat_decode.py:116",
         "launches": cells["speculative"]["launches"]["swat_decode"],
         "max_abs_err": dec_err[SPEC_K + 1], "ms": vk[0], "plain_ms": vk[1],
         "bound_ms": vb_ms, "bound_by": vb_by, "library_ms": vk[2]})
    for name, times, launches, dn in (
            ("swat_attention_fwd_tc (prefill chunk, offsets)", ck,
             cells["chunked"]["launches"]["swat_attention_fwd"],
             "bfloat16"),
            ("swat_attention_fwd (SIMT, fp32 prefill chunk, offsets)", ck32,
             cells32["chunked"]["launches"]["swat_attention_fwd"],
             "float32")):
        b_ms, b_by = bound(times[3], times[4], dn)
        kernels.append(
            {"name": name, "route": "cuda",
             "source": "src/repro_torch/csrc/swat_attention_fwd.cu",
             "replaces": "src/repro/kernels/swat_attention.py:64",
             "launches": launches, "max_abs_err": chunk_err[dn],
             "ms": times[0], "plain_ms": times[1], "bound_ms": b_ms,
             "bound_by": b_by, "library_ms": times[2]})
    # the combine has no single PyTorch call that computes it (library null)
    for name, key, err, counted in (
            ("swat_attention_dq_tc", "dq", dq_err, "swat_attention_dq"),
            ("swat_attention_dkv_tc", "dkv", dkv_err, "swat_attention_dkv"),
            ("swat_attention_dkv_combine", "combine", combine_err,
             "swat_attention_dkv_combine")):
        ms, p_ms, l_ms, bytes_, ops_ = bt[key]
        b_ms, b_by = bound(bytes_, ops_)
        kernels.append(
            {"name": name, "route": "cuda",
             "source": "src/repro_torch/csrc/swat_attention_bwd.cu",
             "replaces": ("src/repro/kernels/swat_backward.py:51"
                          if key == "dq" else
                          "src/repro/kernels/swat_backward.py:93"),
             "launches": tr_launches[counted], "max_abs_err": err, "ms": ms,
             "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": b_by,
             "library_ms": l_ms})
    log(f"serve summary: {json.dumps(summary)}")
    log(f"serve cells (bf16): {json.dumps(cells)}")
    log(f"serve cell gates (bf16): {json.dumps(cell_gates)}")
    log(f"serve cells (fp32): {json.dumps(cells32)}")
    log("chunked / single-shot prefill ms a batch (bf16): "
        f"{cells['chunked']['prefill_ms_per_batch'] / summary['prefill_ms_per_batch']:.3f}")
    log(f"trace chunked prefill: {json.dumps(trace_chunked)}")
    log(f"trace single-shot prefill: {json.dumps(trace_single)}")
    log(f"trace verify block: {json.dumps(trace_spec)}")
    log(f"chunk pass A (pos0 448, bf16): kernel {ck[0]:.4f} ms, plain "
        f"{ck[1]:.4f}, SDPA {ck[2]:.4f}; whole chunk route {ck[5]:.4f} ms, "
        f"plain chunk attention {ck[6]:.4f}")
    log(f"chunk pass A (pos0 448, fp32): kernel {ck32[0]:.4f} ms, plain "
        f"{ck32[1]:.4f}, SDPA {ck32[2]:.4f}; whole chunk route "
        f"{ck32[5]:.4f} ms, plain chunk attention {ck32[6]:.4f}")
    log(f"fused decode at T={SPEC_K + 1}: kernel {vk[0]:.5f} ms, plain "
        f"{vk[1]:.4f}, SDPA {vk[2]:.4f}, bound {vb_ms:.6f} ({vb_by}); "
        f"T=1 {dk:.5f} ms")
    log(f"e2e: {json.dumps(e2e)}")
    log(f"trace: {json.dumps(trace)}")
    log(f"unembed: {json.dumps(unembed)}")
    log(f"train summary: {json.dumps(tr)}")
    log(f"train trace: {json.dumps(ttrace)}")
    log(f"forward at L=2048: {json.dumps(ft)}")
    log(f"dK/dV at L=2048: tensor-core launch + combine "
        f"{bt['dkv_total_ms']:.4f} ms")
    log(f"train e2e: {json.dumps(tr_e2e)}")
    log(f"resume: {json.dumps(resume)}")
    log(f"plain decode split sweep: {json.dumps(sweep)}")
    log(f"gemma2 D=256 errors (bf16): {json.dumps(g2_errs)}")
    log(f"gemma2 D=256 times: {json.dumps(g2_times)}")
    log(f"whisper: {json.dumps(wh)}")
    log(f"whisper e2e: {json.dumps(wh_e2e)}")
    log(f"whisper times: {json.dumps(wh_times)}")
    log(f"plain decode at the cross shape: kernel {pk:.4f} ms, plain "
        f"{pp:.4f} ms, SDPA {pl:.4f} ms, bound {pb_ms:.5f} ms ({pb_by})")
    log(f"total {time.perf_counter() - t_start:.1f}s")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
