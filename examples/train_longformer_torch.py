"""End-to-end training on the PyTorch/CUDA port, the twin of
examples/train_longformer.py: a ~100M-param Longformer on the synthetic LM
stream, with checkpointing, auto-resume, straggler logging, and a
dense-attention control at matched size (the paper's accuracy-parity
story, Table 3, transplanted to an offline-runnable task).

    PYTHONPATH=src python examples/train_longformer_torch.py --steps 300
    PYTHONPATH=src python examples/train_longformer_torch.py --steps 300 --dense
    # kill it mid-run and re-run: it resumes from the last checkpoint

Runs on the card (the forward, dQ and dK/dV kernels), or with --cpu on
their plain versions. Checkpoints and the metrics file go under the
temporary directory unless --ckpt-dir says otherwise.
"""
import argparse
import os
import sys
import tempfile

import torch

from repro_torch import tree
from repro_torch.core import model as Mod
from repro_torch.core.types import AttentionSpec, ModelConfig
from repro_torch.data.pipeline import DataConfig
from repro_torch.optim import adamw
from repro_torch.runtime.trainer import TrainConfig, Trainer


def build_cfg(dense: bool) -> ModelConfig:
    # ~100M params: 12L x 768 with a 50k vocab
    attn = (AttentionSpec(kind="dense", causal=True) if dense else
            AttentionSpec(kind="swat", window=128, num_global=4, causal=True))
    return ModelConfig(
        name="longformer-100m" + ("-dense" if dense else ""),
        num_layers=12, d_model=768, num_heads=12, num_kv_heads=12,
        d_ff=3072, vocab_size=50265, attention=attn, tie_embeddings=True,
        dtype="float32")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=512)
    ap.add_argument("--dense", action="store_true",
                    help="dense-attention control run")
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_longformer"))
    ap.add_argument("--fail-at", type=int, default=-1,
                    help="inject a failure at this step (restart drill)")
    ap.add_argument("--cpu", action="store_true",
                    help="run the kernels' plain versions on the CPU")
    args = ap.parse_args(argv)
    if not args.cpu and not torch.cuda.is_available():
        print("no CUDA device: pass --cpu to run on the CPU", file=sys.stderr)
        return 2

    cfg = build_cfg(args.dense)
    n_params = sum(p.numel() for p in tree.leaves(
        Mod.init_model(cfg, device="meta")))
    print(f"[example] {cfg.name}: {n_params / 1e6:.1f}M params")

    ckpt_dir = args.ckpt_dir + ("-dense" if args.dense else "")
    trainer = Trainer(
        cfg,
        adamw.AdamWConfig(lr=3e-4, warmup_steps=20, total_steps=args.steps),
        TrainConfig(total_steps=args.steps, ckpt_every=50,
                    ckpt_dir=ckpt_dir, log_every=10,
                    fail_at_step=args.fail_at,
                    metrics_path=os.path.join(ckpt_dir, "metrics.jsonl"),
                    device="cpu" if args.cpu else "cuda"),
        DataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq,
                   global_batch=args.batch))
    os.makedirs(ckpt_dir, exist_ok=True)
    out = trainer.train()
    losses = [h["loss"] for h in out["history"]]
    if losses:
        head, tail = losses[:10], losses[-10:]
        print(f"[example] first-10 loss {sum(head) / len(head):.3f} -> "
              f"last-10 loss {sum(tail) / len(tail):.3f}")
    if out["stragglers"]:
        print(f"[example] straggler steps flagged: {out['stragglers'][:5]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
