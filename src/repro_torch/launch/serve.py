"""Serving launcher for the PyTorch/CUDA port: continuous-batching window
attention serving with ring KV caches, on the card by default.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.2-1b \
        --swat --window 256 --requests 8 --slots 4 --prompt-len 512 \
        --new-tokens 64 --max-len 1024 --scan-steps 8

Params are random, from the port's own `init_model` with seed 0. On a
machine without a CUDA device the launcher exits non-zero; `--device cpu`
runs the plain versions of the kernels instead (small configs: `--smoke`).
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
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--top-k", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    import torch

    if args.device.startswith("cuda") and not torch.cuda.is_available():
        print("[serve] no CUDA device: repro_torch serves on the card "
              "(pass --device cpu to run the plain versions on the CPU)",
              file=sys.stderr)
        return 2

    from repro_torch.configs import get_config, get_smoke_config, with_swat
    from repro_torch.core import model as Mod
    from repro_torch.serving.engine import (Request, ServingEngine,
                                            ring_cache_bytes)

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    if args.swat:
        cfg = with_swat(cfg, window=args.window, num_global=4)
    params = Mod.init_model(cfg, seed=0, device=args.device)
    engine = ServingEngine(cfg, params, batch_slots=args.slots,
                           max_len=args.max_len, scan_steps=args.scan_steps,
                           top_k=args.top_k)
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
    print(f"[serve] {len(results)} requests / {n} tokens in {dt:.3f}s "
          f"({n / dt:.1f} tok/s; scan_steps={args.scan_steps}; {where})")
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
