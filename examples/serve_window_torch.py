"""Batched serving with ring KV caches on the PyTorch/CUDA port, the twin
of examples/serve_window.py: continuous batching over more requests than
slots, and the memory report of the O(window) cache (paper Fig. 3).

    PYTHONPATH=src python examples/serve_window_torch.py [--cpu]

Runs on the card (the fused decode kernel, CUDA graphs), or with --cpu on
the kernels' plain versions.
"""
import argparse
import dataclasses
import sys
import time

import numpy as np
import torch

from repro_torch.core import model as Mod
from repro_torch.core.types import AttentionSpec, ModelConfig
from repro_torch.serving.engine import Request, ServingEngine, ring_cache_bytes


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true",
                    help="run the kernels' plain versions on the CPU")
    args = ap.parse_args(argv)
    if not args.cpu and not torch.cuda.is_available():
        print("no CUDA device: pass --cpu to run on the CPU", file=sys.stderr)
        return 2
    dev = "cpu" if args.cpu else "cuda"

    cfg = ModelConfig(
        name="serve-demo", num_layers=4, d_model=256, num_heads=8,
        num_kv_heads=4, d_ff=1024, vocab_size=32000,
        attention=AttentionSpec(kind="swat", window=256, num_global=4,
                                causal=True),
        dtype="float32")
    params = Mod.init_model(cfg, seed=0, device=dev)

    rng = np.random.RandomState(0)
    requests = [
        Request(rid=i,
                prompt=rng.randint(0, cfg.vocab_size, (64,)).astype(np.int32),
                max_new_tokens=16)
        for i in range(6)
    ]
    engine = ServingEngine(cfg, params, batch_slots=2, max_len=2048)
    t0 = time.time()
    results = engine.run(requests)
    dt = time.time() - t0
    n_tok = sum(len(r.tokens) for r in results)
    print(f"[serve] {len(results)} requests, {n_tok} tokens "
          f"in {dt:.1f}s ({n_tok / dt:.1f} tok/s on {dev}, first use "
          "included)")
    for r in results[:3]:
        print(f"  rid={r.rid}: {r.tokens[:8]}...")
    if n_tok != 6 * 16 or not all(r.ok for r in results):
        print("a request was not served in full", file=sys.stderr)
        return 1

    swat_bytes = ring_cache_bytes(cfg, 2, 65536)
    dense_cfg = dataclasses.replace(
        cfg, attention=AttentionSpec(kind="dense", causal=True))
    dense_bytes = ring_cache_bytes(dense_cfg, 2, 65536)
    print(f"[serve] decode-cache @64k context: ring={swat_bytes / 1e6:.1f}MB "
          f"vs dense={dense_bytes / 1e6:.1f}MB "
          f"({dense_bytes / swat_bytes:.0f}x saving — paper Fig. 3)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
