"""Serving launcher for the PyTorch/CUDA port: continuous-batching window
attention serving with ring KV caches, on the card by default.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.2-1b \
        --swat --window 256 --requests 8 --slots 4 --prompt-len 512 \
        --new-tokens 64 --max-len 1024 --scan-steps 8

Chunked prefill (`--prefill-chunk`), speculative decoding
(`--speculative`, with the n-gram drafter's `--draft-ngram` /
`--draft-history`), the paged KV layout (`--kv-layout paged`) and prefix
sharing (`--share-prefix`, with `--prefill-chunk`; it serves the JAX
launcher's shared-system-prompt demo workload) take the JAX launcher's
flags and defaults. `--decode-impl pallas` runs the fused decode kernel
(and exits non-zero without a card), `ref` its plain version; omitted, the
device picks (the kernel on the card). `--metrics` keeps the engine's
device counters, `--trace-out` / `--metrics-out` write its Chrome trace
and Prometheus text (`python -m repro_torch.launch.scope validate` checks
them); every run prints its TTFT / TPOT percentiles. `--mesh DxM` (with
`--profile tp|cp|fsdp`) serves on a mesh (`ServingEngine(mesh=,
profile=)`): a single-process LocalMesh of that shape on the one device,
or, under `torchrun` (an initialised torch.distributed group, one rank a
shard), a ProcessMesh; the run line names it ("2x2 mesh (tp)"). Resilience takes
the JAX launcher's flags: `--max-pending` sheds requests beyond a queue
depth, `--deadline` gives every request a deadline in seconds, and the
chaos flags build a fault plan: `--chaos-poison-slot S` (with
`--chaos-poison-step`) puts NaN into slot S's logits at that token,
`--chaos-fail-pallas` makes the decode kernel's dispatch fail so the
engine steps down to the plain version. Each run prints its statuses, its
degradation events and every request that did not end ok. Params are
random, from the port's own `init_model` with seed 0. On a machine without
a CUDA device the launcher exits non-zero; `--device cpu` runs the plain
versions of the kernels instead (small configs: `--smoke`). Every JAX
launcher flag is declared with the JAX launcher's default.
"""
import argparse
import sys
import time

import numpy as np


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--swat", action="store_true",
                    help="swap dense attention for SWAT window attention")
    ap.add_argument("--window", type=int, default=256)
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--slots", type=int, default=2)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--max-len", type=int, default=2048)
    ap.add_argument("--scan-steps", type=int, default=8,
                    help="decode steps per host sync (1 = per-token sync)")
    ap.add_argument("--batch-prefill", default=True,
                    action=argparse.BooleanOptionalAction,
                    help="pack pending prompts into one padded prefill "
                         "(--no-batch-prefill: one prompt per prefill)")
    ap.add_argument("--prefill-chunk", type=int, default=0,
                    help="sequence-axis prefill chunk (0 = single-shot)")
    ap.add_argument("--max-prefill-tokens", type=int, default=8192)
    ap.add_argument("--max-prompt-len", type=int, default=0,
                    help="reject (status 'rejected') prompts longer than "
                         "this (0 = no limit)")
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--top-k", type=int, default=0)
    ap.add_argument("--tokens-per-step", type=int, default=1,
                    help="ring lookahead for multi-token decode steps "
                         "(tokens unchanged)")
    ap.add_argument("--speculative", type=int, default=0,
                    help="draft tokens per verify step (0 = sequential); "
                         "greedy output is token-identical either way")
    ap.add_argument("--draft-ngram", type=int, default=3,
                    help="n-gram drafter: longest context suffix to match")
    ap.add_argument("--draft-history", type=int, default=64,
                    help="n-gram drafter: per-slot token history length")
    ap.add_argument("--spec-min-acceptance", type=float, default=0.0,
                    help="turn speculative decode off when the windowed "
                         "acceptance rate drops below this (0 = never)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    ap.add_argument("--decode-impl", choices=("ref", "pallas"),
                    default=None,
                    help="decode attention: pallas = the fused CUDA kernel "
                         "(needs the card), ref = its plain version "
                         "(default: the kernel on the card, the plain "
                         "version on the CPU)")
    ap.add_argument("--kv-layout", choices=("contiguous", "paged"),
                    default="contiguous",
                    help="cache residency: per-slot rings or the paged "
                         "block pool + tables")
    ap.add_argument("--share-prefix", action="store_true",
                    help="prefill each admission batch's common prompt "
                         "prefix once and block-share it (paged, with "
                         "--prefill-chunk); demoed with a shared system "
                         "prompt across all requests")
    ap.add_argument("--mesh", default=None,
                    help="mesh 'DxM' (e.g. 2x2): sharded serving, a "
                         "single-process mesh (one rank a shard under "
                         "torchrun); default: single-device")
    ap.add_argument("--profile", choices=("tp", "cp", "fsdp"), default="tp",
                    help="param sharding profile for --mesh")
    # resilience
    ap.add_argument("--max-pending", type=int, default=0,
                    help="reject requests beyond this queue depth (status "
                         "'rejected', queue overflow; 0 = unbounded)")
    ap.add_argument("--deadline", type=float, default=0.0,
                    help="per-request deadline in seconds from submission "
                         "(status 'deadline'; 0 = none)")
    ap.add_argument("--chaos-poison-slot", type=int, default=None,
                    help="fault injection: NaN into this slot's logits "
                         "(the slot is quarantined, status 'poisoned')")
    ap.add_argument("--chaos-poison-step", type=int, default=3,
                    help="token index at which --chaos-poison-slot fires")
    ap.add_argument("--chaos-fail-pallas", action="store_true",
                    help="fault injection: the decode kernel's dispatch "
                         "fails; the engine steps down to the plain "
                         "version")
    # observability
    ap.add_argument("--metrics", action="store_true",
                    help="keep device-resident counters in the decode and "
                         "verify steps (tokens identical; read after the "
                         "run) and print them")
    ap.add_argument("--trace-out", default=None, metavar="PATH",
                    help="write a Chrome-trace JSON of request lifecycle "
                         "spans to PATH (open in chrome://tracing / "
                         "Perfetto)")
    ap.add_argument("--metrics-out", default=None, metavar="PATH",
                    help="write the Prometheus text exposition to PATH "
                         "(implies --metrics)")
    args = ap.parse_args(argv)

    import torch

    if args.device.startswith("cuda") and not torch.cuda.is_available():
        print("[serve] no CUDA device: repro_torch serves on the card "
              "(pass --device cpu to run the plain versions on the CPU)",
              file=sys.stderr)
        return 2

    from repro_torch.configs import get_config, get_smoke_config, with_swat
    from repro_torch.core import model as Mod
    from repro_torch.serving.drafter import NGramDrafter
    from repro_torch.serving import faults as F
    from repro_torch.serving.engine import (Request, ServingEngine,
                                            ring_cache_bytes)

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    if args.swat:
        cfg = with_swat(cfg, window=args.window, num_global=4)
    params = Mod.init_model(cfg, seed=0, device=args.device)
    plan = F.FaultPlan(
        poison_logits=(((args.chaos_poison_slot, args.chaos_poison_step,
                         "nan"),)
                       if args.chaos_poison_slot is not None else ()),
        fail_pallas_dispatch=args.chaos_fail_pallas)
    try:
        engine = ServingEngine(
            cfg, params, batch_slots=args.slots, max_len=args.max_len,
            scan_steps=args.scan_steps, batch_prefill=args.batch_prefill,
            prefill_chunk=args.prefill_chunk,
            max_prefill_tokens=args.max_prefill_tokens, top_k=args.top_k,
            tokens_per_step=args.tokens_per_step,
            speculative=args.speculative,
            draft=NGramDrafter(max_ngram=args.draft_ngram,
                               history=args.draft_history),
            max_prompt_len=args.max_prompt_len or None,
            max_pending=args.max_pending or None, faults=plan,
            spec_min_acceptance=args.spec_min_acceptance,
            kv_layout=args.kv_layout, share_prefix=args.share_prefix,
            decode_impl=args.decode_impl,
            metrics=args.metrics or bool(args.metrics_out),
            mesh=args.mesh, profile=args.profile)
    except ValueError as e:
        print(f"[serve] {e}", file=sys.stderr)
        return 2
    rng = np.random.RandomState(0)
    if args.share_prefix:
        # the JAX launcher's shared-prefix demo workload: one system
        # prompt, 16-token suffixes
        sys_prompt = rng.randint(0, cfg.vocab_size,
                                 (max(args.prompt_len - 16, 16),)
                                 ).astype(np.int32)
        prompts = [np.concatenate(
            [sys_prompt, rng.randint(0, cfg.vocab_size, (16,)
                                     ).astype(np.int32)])
            for _ in range(args.requests)]
    else:
        prompts = [rng.randint(0, cfg.vocab_size, (args.prompt_len,)
                               ).astype(np.int32)
                   for _ in range(args.requests)]
    reqs = [Request(rid=i, prompt=prompts[i], max_new_tokens=args.new_tokens,
                    temperature=args.temperature,
                    deadline=args.deadline or None)
            for i in range(args.requests)]
    t0 = time.perf_counter()
    try:
        results = engine.run(reqs)
    finally:
        F.clear_kernel_failure()
    dt = time.perf_counter() - t0
    n = sum(len(r.tokens) for r in results)
    st = engine.stats
    where = (torch.cuda.get_device_name(engine.device)
             if engine.device.type == "cuda" else "cpu")
    spec = (f", speculative={args.speculative} "
            f"(acceptance {engine.acceptance_rate:.2f})"
            if args.speculative else "")
    # the engine's impl after the run: "ref" once it stepped down
    impl = engine.decode_impl or ("pallas" if engine.device.type == "cuda"
                                  else "ref")
    mdesc = "single-device" if engine.mesh is None else (
        "x".join(str(engine.mesh.shape[a]) for a in engine.mesh.axis_names)
        + f" mesh ({args.profile})")
    print(f"[serve] {len(results)} requests / {n} tokens in {dt:.3f}s "
          f"({n / dt:.1f} tok/s; scan_steps={args.scan_steps}, "
          f"batch_prefill={args.batch_prefill}, "
          f"prefill_chunk={engine.prefill_chunk}{spec}, {mdesc}, "
          f"decode_impl={impl}, kv_layout={args.kv_layout}; {where})")
    print(f"[serve] prefill {st['prefill_batches']} batches in "
          f"{st['prefill_s'] * 1e3:.1f}ms; decode {st['decode_steps']} steps "
          f"in {st['decode_s'] * 1e3:.1f}ms")
    print(f"[serve] cache bytes @max_len: "
          f"{ring_cache_bytes(cfg, args.slots, args.max_len) / 1e6:.1f}MB")
    if args.kv_layout == "paged":
        ps = engine.paged_stats()
        line = (f"[serve] paged pool: {ps['blocks_in_use']}/"
                f"{ps['blocks_total']} blocks in use")
        if args.share_prefix:
            line += (f"; prefixes shared={st['prefill_prefix_shared']}, "
                     "prefill tokens computed="
                     f"{st['prefill_tokens_computed']}, "
                     f"cow moves={st['cow_moves']}")
        print(line)
    by_status = {}
    for r in results:
        by_status[r.status] = by_status.get(r.status, 0) + 1
    print("[serve] statuses: "
          + ", ".join(f"{k}={v}" for k, v in sorted(by_status.items())))
    for ev in F.consume_events():
        kind = ev.pop("kind")
        print(f"[serve] degradation event: {kind} "
              + " ".join(f"{k}={v}" for k, v in sorted(ev.items())))
    for r in results:
        if r.status != "ok":
            print(f"[serve]   rid {r.rid}: {r.status}"
                  + (f" - {r.reason}" if r.reason else ""))
    lat = engine.tracer.latency_summary()
    if lat["ttft"]["count"]:
        ttft, tpot = lat["ttft"], lat["tpot"]
        print(f"[serve] latency: ttft p50={ttft['p50'] * 1e3:.1f}ms "
              f"p95={ttft['p95'] * 1e3:.1f}ms; "
              f"tpot p50={tpot['p50'] * 1e3:.2f}ms "
              f"p95={tpot['p95'] * 1e3:.2f}ms "
              f"({ttft['count']} finished; {where})")
    if engine.metrics:
        dev = engine.device_metrics()
        print("[serve] device counters: "
              + " ".join(f"{k}={v}" for k, v in sorted(dev.items())))
    if args.metrics_out:
        with open(args.metrics_out, "w") as f:
            f.write(engine.metrics_text())
        print(f"[serve] wrote metrics: {args.metrics_out}")
    if args.trace_out:
        import json
        with open(args.trace_out, "w") as f:
            json.dump(engine.chrome_trace(), f)
        print(f"[serve] wrote trace: {args.trace_out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
