"""Pipeline-parallel training on the PyTorch/CUDA port, the twin of
examples/pipeline_train.py: GPipe microbatches over the super-block seam.

A 2-stage pipeline on a (pipe=2, data=2) mesh trains a small window-
attention LM; the script checks that the pipelined loss matches the
single-pass loss before training, then runs real pipeline steps. The mesh
is a single-process `LocalMesh` (every stage in one process on one
device; the JAX example forces 4 host devices).

    PYTHONPATH=src python examples/pipeline_train_torch.py [--cpu]

Runs on the card (the forward, dQ and dK/dV kernels), or with --cpu on
their plain versions.
"""
import argparse
import sys
import time

import numpy as np
import torch

from repro_torch.core import model as Mod
from repro_torch.core.types import AttentionSpec, ModelConfig
from repro_torch.distributed import pipeline as PP
from repro_torch.launch import mesh as mesh_lib
from repro_torch.optim import adamw


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
        name="pp-demo", num_layers=4, d_model=128, num_heads=4,
        num_kv_heads=4, d_ff=512, vocab_size=1000,
        attention=AttentionSpec(kind="swat", window=64, causal=True),
        dtype="float32")
    mesh = mesh_lib.make_debug_pp_mesh(n_pipe=2, n_data=2)
    pcfg = PP.PipelineConfig(num_stages=2, num_microbatches=4)
    print(f"stages=2 microbatches=4 "
          f"bubble={PP.bubble_fraction(pcfg):.2f}")

    params = Mod.init_model(cfg, seed=0, device=dev)
    rng = np.random.RandomState(0)
    tokens = torch.from_numpy(rng.randint(0, 1000, (8, 128))
                              .astype(np.int32)).to(dev)
    batch = {"tokens": tokens, "labels": tokens}

    loss_fn = PP.make_pipeline_loss(cfg, pcfg, mesh)
    with torch.no_grad():
        l_pp, _ = loss_fn(params, batch)
        l_ref, _ = Mod.loss_fn(params, cfg, batch, remat=False)
    print(f"PP loss {float(l_pp):.4f} == single-pass {float(l_ref):.4f}")
    if not abs(float(l_pp) - float(l_ref)) < 1e-2:
        print("the pipelined loss disagrees", file=sys.stderr)
        return 1

    opt_cfg = adamw.AdamWConfig(lr=3e-4, warmup_steps=5)
    opt = adamw.init_opt_state(params)
    step = PP.make_pp_train_step(cfg, opt_cfg, pcfg, mesh)
    for i in range(20):
        t0 = time.time()
        params, opt, m = step(params, opt, batch)
        if i % 5 == 0:
            print(f"step {i:>3} loss={float(m['loss']):.4f} "
                  f"({(time.time() - t0) * 1e3:.0f} ms)")
    print("pipeline training ran; loss decreased:",
          float(m["loss"]) < float(l_pp))
    return 0


if __name__ == "__main__":
    sys.exit(main())
