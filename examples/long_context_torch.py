"""Long-context decode on the PyTorch/CUDA port, the twin of
examples/long_context.py: a small SWAT model decodes far past its 4k
prompt in O(window) memory, the workload that motivates the paper.

    PYTHONPATH=src python examples/long_context_torch.py [--cpu]

Runs on the card (prefill through the forward kernel, each decode step
through the fused decode kernel), or with --cpu on their plain versions.
"""
import argparse
import dataclasses
import sys
import time

import numpy as np
import torch

from repro_torch.core import model as Mod
from repro_torch.core.types import AttentionSpec, ModelConfig
from repro_torch.serving.engine import ring_cache_bytes


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
        name="long-ctx-demo", num_layers=2, d_model=128, num_heads=4,
        num_kv_heads=2, d_ff=512, vocab_size=1000,
        attention=AttentionSpec(kind="swat", window=512, num_global=8,
                                causal=True),
        dtype="float32")
    params = Mod.init_model(cfg, seed=0, device=dev)
    rng = np.random.RandomState(0)

    # prefill a 4k prompt, then decode far past it: the ring keeps memory
    # flat
    prompt = torch.from_numpy(rng.randint(0, 1000, (1, 4096))
                              .astype(np.int32)).to(dev)
    logits, caches = Mod.prefill(params, cfg, {"tokens": prompt},
                                 max_len=131072)
    tok = logits[:, 0].argmax(-1)[:, None]
    t0, n = time.time(), 256
    for _ in range(n):
        logits, caches = Mod.decode_step(params, cfg, {"tokens": tok},
                                         caches)
        tok = logits[:, 0].argmax(-1)[:, None]
    dt = time.time() - t0
    step = int(caches[0]["l0"]["step"][0])   # per-slot steps: (batch,)
    cache_mb = ring_cache_bytes(cfg, 1, 131072) / 1e6
    dense = dataclasses.replace(cfg, attention=AttentionSpec(kind="dense",
                                                             causal=True))
    print(f"[long-ctx] decoded {n} tokens at context depth {step} "
          f"({n / dt:.1f} tok/s on {dev})")
    print(f"[long-ctx] decode cache: {cache_mb:.2f}MB flat (window=512) — "
          f"dense at 131k would be "
          f"{ring_cache_bytes(dense, 1, 131072) / 1e6:.0f}MB")
    if step != 4096 + n or not bool(torch.isfinite(logits).all()):
        print("decode went wrong", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
