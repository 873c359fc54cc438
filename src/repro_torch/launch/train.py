"""Training launcher for the PyTorch/CUDA port: single-device AdamW training
on synthetic data with auto-resume, on the card by default.

    PYTHONPATH=src python -m repro_torch.launch.train \
        --arch longformer-paper --steps 4 --batch 4 --seq 2048

Params start from the port's own `init_model` with seed 0; a SWAT model
trains through its config (longformer-paper, bigbird-paper). Checkpoints
go to --ckpt-dir, and a rerun resumes from the latest one. Without a CUDA
device the launcher exits non-zero; `--device cpu` runs the plain versions
of the kernels instead (small configs: `--smoke`). The mesh flags of the
JAX launcher are not ported.
"""
import argparse
import os
import sys
import tempfile

_NOT_PORTED = ("debug_mesh", "device_count", "multi_pod")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=512)
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced config")
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_train"))
    ap.add_argument("--grad-compression", action="store_true")
    ap.add_argument("--fail-at", type=int, default=-1)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--debug-mesh", default="", help="not ported")
    ap.add_argument("--device-count", type=int, default=0, help="not ported")
    ap.add_argument("--multi-pod", action="store_true", help="not ported")
    args = ap.parse_args(argv)

    used = [f"--{n.replace('_', '-')}" for n in _NOT_PORTED
            if getattr(args, n)]
    if used:
        print(f"[train] {', '.join(used)}: not ported (ROADMAP item 13)",
              file=sys.stderr)
        return 2

    import torch

    if args.device.startswith("cuda") and not torch.cuda.is_available():
        print("[train] no CUDA device: repro_torch trains on the card "
              "(pass --device cpu to run the plain versions on the CPU)",
              file=sys.stderr)
        return 2

    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.optim import adamw
    from repro_torch.runtime.trainer import TrainConfig, Trainer

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    trainer = Trainer(
        cfg, adamw.AdamWConfig(total_steps=args.steps, warmup_steps=10),
        TrainConfig(total_steps=args.steps, ckpt_every=50,
                    ckpt_dir=args.ckpt_dir, log_every=10,
                    grad_compression=args.grad_compression,
                    fail_at_step=args.fail_at, device=args.device),
        DataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq,
                   global_batch=args.batch))
    out = trainer.train()
    hist = out["history"]
    if hist:
        last = hist[-1]
        where = (torch.cuda.get_device_name(trainer.device)
                 if trainer.device.type == "cuda" else "cpu")
        print(f"[train] step {last['step']} loss={last['loss']:.4f} "
              f"gnorm={last['grad_norm']:.3f} "
              f"{last['step_time_s'] * 1e3:.1f}ms/step ({where})")
    print("[train] done")
    return 0


if __name__ == "__main__":
    sys.exit(main())
