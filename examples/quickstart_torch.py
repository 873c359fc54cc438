"""Quickstart with the PyTorch/CUDA port: the SWAT attention op and a tiny
Longformer, the twin of examples/quickstart.py.

    PYTHONPATH=src python examples/quickstart_torch.py [--cpu]

Part 1 runs the paper's op through the hand-written kernel (impl="kernel",
the forward kernel on the card) and its plain exact-band twin
(impl="banded"), where the JAX example compares "pallas" with "xla"; part
2 takes one training step's loss and gradients of a tiny Longformer; part
3 decodes with the ring KV cache (the paper's FIFO). Runs on the card, or
with --cpu on the kernels' plain versions.
"""
import argparse
import sys

import numpy as np
import torch

from repro_torch import tree
from repro_torch.core import model as Mod
from repro_torch.core.types import AttentionSpec, ModelConfig
from repro_torch.kernels.ops import swat_attention


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true",
                    help="run the kernels' plain versions on the CPU")
    args = ap.parse_args(argv)
    if not args.cpu and not torch.cuda.is_available():
        print("no CUDA device: pass --cpu to run on the CPU", file=sys.stderr)
        return 2
    dev = "cpu" if args.cpu else "cuda"

    # --- 1. the paper's op: fused exact-band window attention ------------
    rng = np.random.RandomState(0)
    B, H, L, D = 2, 4, 1024, 64
    q, k, v = (torch.from_numpy(rng.randn(B, H, L, D).astype(np.float32))
               .to(dev) for _ in range(3))
    spec = AttentionSpec(kind="swat", window=128, num_global=16,
                         causal=False)
    with torch.no_grad():
        out = swat_attention(q, k, v, spec, impl="kernel")    # CUDA kernel
        out_banded = swat_attention(q, k, v, spec, impl="banded")
    err = float((out - out_banded).abs().max())
    print("swat attention:", tuple(out.shape),
          "kernel-vs-banded max err:", err)
    if not err < 1e-3:
        print("the kernel disagrees with its plain twin", file=sys.stderr)
        return 1

    # --- 2. a tiny Longformer LM, one training step's gradients -----------
    cfg = ModelConfig(
        name="tiny-longformer", num_layers=4, d_model=128, num_heads=4,
        num_kv_heads=4, d_ff=512, vocab_size=1000,
        attention=AttentionSpec(kind="swat", window=64, num_global=4,
                                causal=True),
        dtype="float32")
    params = Mod.init_model(cfg, seed=0, device=dev)
    tokens = torch.from_numpy(rng.randint(0, 1000, (2, 256))
                              .astype(np.int32)).to(dev)
    leaves = tree.leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    loss, _ = Mod.loss_fn(params, cfg, {"tokens": tokens, "labels": tokens})
    grads = torch.autograd.grad(loss, leaves)
    for p in leaves:
        p.requires_grad_(False)
    n_params = sum(p.numel() for p in leaves)
    print(f"tiny longformer loss={float(loss.detach()):.3f} "
          f"params={n_params:,} "
          f"grad leaves={len(grads)}")
    if not all(torch.isfinite(g).all() for g in grads):
        print("non-finite gradient", file=sys.stderr)
        return 1

    # --- 3. decode with the ring KV cache (the paper's FIFO) --------------
    logits, caches = Mod.prefill(params, cfg, {"tokens": tokens[:, :128]},
                                 max_len=512)
    tok = logits[:, 0].argmax(-1)[:, None]
    for _ in range(8):
        logits, caches = Mod.decode_step(params, cfg, {"tokens": tok},
                                         caches)
        tok = logits[:, 0].argmax(-1)[:, None]
    ring = tuple(caches[0]["l0"]["k"].shape)   # (B, Hkv, window+1+g, D)
    print("ring cache per layer:", ring, "- O(window), not O(context)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
