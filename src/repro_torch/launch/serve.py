"""Serving launcher for the PyTorch/CUDA port: continuous-batching window
attention serving with ring KV caches, on the card by default.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.2-1b \
        --swat --window 256 --requests 8 --slots 4 --prompt-len 512 \
        --new-tokens 64 --max-len 1024 --scan-steps 8

Chunked prefill (`--prefill-chunk`) and speculative decoding
(`--speculative`, with the n-gram drafter's `--draft-ngram` /
`--draft-history`) take the JAX launcher's flags and defaults. Params are
random, from the port's own `init_model` with seed 0. On a machine without
a CUDA device the launcher exits non-zero; `--device cpu` runs the plain
versions of the kernels instead (small configs: `--smoke`). The JAX
launcher's flags of later slices are accepted and exit non-zero with the
ROADMAP item that will port them.
"""
import argparse
import sys
import time

import numpy as np

# JAX launcher flags whose features later slices port: dest -> ROADMAP item
_NOT_PORTED = {"kv_layout": 9, "share_prefix": 9, "mesh": 13, "profile": 13,
               "max_pending": 10, "deadline": 10, "chaos_poison_slot": 10,
               "chaos_poison_step": 10, "chaos_fail_pallas": 10,
               "decode_impl": 10, "metrics": 11, "trace_out": 11,
               "metrics_out": 11}


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
    for flag in ("--kv-layout", "--mesh", "--profile", "--trace-out",
                 "--metrics-out", "--decode-impl", "--max-pending",
                 "--deadline", "--chaos-poison-slot", "--chaos-poison-step"):
        ap.add_argument(flag, default=None, help="not ported")
    for flag in ("--share-prefix", "--chaos-fail-pallas", "--metrics"):
        ap.add_argument(flag, action="store_true", help="not ported")
    args = ap.parse_args(argv)

    used = [(f"--{n.replace('_', '-')}", item)
            for n, item in _NOT_PORTED.items()
            if getattr(args, n) not in (None, False)]
    if used:
        for flag, item in used:
            print(f"[serve] {flag}: not ported (ROADMAP item {item})",
                  file=sys.stderr)
        return 2

    import torch

    if args.device.startswith("cuda") and not torch.cuda.is_available():
        print("[serve] no CUDA device: repro_torch serves on the card "
              "(pass --device cpu to run the plain versions on the CPU)",
              file=sys.stderr)
        return 2

    from repro_torch.configs import get_config, get_smoke_config, with_swat
    from repro_torch.core import model as Mod
    from repro_torch.serving.drafter import NGramDrafter
    from repro_torch.serving.engine import (Request, ServingEngine,
                                            ring_cache_bytes)

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    if args.swat:
        cfg = with_swat(cfg, window=args.window, num_global=4)
    params = Mod.init_model(cfg, seed=0, device=args.device)
    engine = ServingEngine(
        cfg, params, batch_slots=args.slots, max_len=args.max_len,
        scan_steps=args.scan_steps, batch_prefill=args.batch_prefill,
        prefill_chunk=args.prefill_chunk,
        max_prefill_tokens=args.max_prefill_tokens, top_k=args.top_k,
        tokens_per_step=args.tokens_per_step, speculative=args.speculative,
        draft=NGramDrafter(max_ngram=args.draft_ngram,
                           history=args.draft_history),
        max_prompt_len=args.max_prompt_len or None,
        spec_min_acceptance=args.spec_min_acceptance)
    rng = np.random.RandomState(0)
    reqs = [Request(rid=i, prompt=rng.randint(0, cfg.vocab_size,
                                              (args.prompt_len,)
                                              ).astype(np.int32),
                    max_new_tokens=args.new_tokens,
                    temperature=args.temperature)
            for i in range(args.requests)]
    t0 = time.perf_counter()
    results = engine.run(reqs)
    dt = time.perf_counter() - t0
    n = sum(len(r.tokens) for r in results)
    st = engine.stats
    where = (torch.cuda.get_device_name(engine.device)
             if engine.device.type == "cuda" else "cpu")
    spec = (f", speculative={args.speculative} "
            f"(acceptance {engine.acceptance_rate:.2f})"
            if args.speculative else "")
    print(f"[serve] {len(results)} requests / {n} tokens in {dt:.3f}s "
          f"({n / dt:.1f} tok/s; scan_steps={args.scan_steps}, "
          f"batch_prefill={args.batch_prefill}, "
          f"prefill_chunk={engine.prefill_chunk}{spec}; {where})")
    print(f"[serve] prefill {st['prefill_batches']} batches in "
          f"{st['prefill_s'] * 1e3:.1f}ms; decode {st['decode_steps']} steps "
          f"in {st['decode_s'] * 1e3:.1f}ms")
    print(f"[serve] cache bytes @max_len: "
          f"{ring_cache_bytes(cfg, args.slots, args.max_len) / 1e6:.1f}MB")
    by_status = {}
    for r in results:
        by_status[r.status] = by_status.get(r.status, 0) + 1
    print("[serve] statuses: "
          + ", ".join(f"{k}={v}" for k, v in sorted(by_status.items())))
    return 0


if __name__ == "__main__":
    sys.exit(main())
