"""Training launcher for the PyTorch/CUDA port: AdamW training on synthetic
data with auto-resume, on one device or on a mesh, on the card by default.

    PYTHONPATH=src python -m repro_torch.launch.train \
        --arch longformer-paper --steps 4 --batch 4 --seq 2048

    # a 2x2 (data, model) mesh of four shards on one card:
    PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-1b \
        --debug-mesh 2,2 --steps 4 --batch 4 --seq 2048

Params start from the port's own `init_model` with seed 0; a SWAT model
trains through its config (longformer-paper, bigbird-paper). Checkpoints
go to --ckpt-dir, and a rerun resumes from the latest one, on any mesh
(checkpoints hold the global leaves). An MoE config
(granite-moe-1b-a400m, moonshot-v1-16b-a3b) also prints its load-balance
loss (`aux_loss`). Without a CUDA device the launcher exits non-zero;
`--device cpu` runs the plain versions of the kernels instead (small
configs: `--smoke`).

The JAX launcher's mesh flags: `--debug-mesh D,M` trains on a (data,
model) mesh of D x M shards, a LocalMesh in this process or, under an
initialised torch.distributed group of D x M ranks, a ProcessMesh (one
shard a rank), with the tp profile's placement and sequence parallelism
where --seq divides 'model'; `--device-count N` declares the devices the
mesh may use, which it must fit; `--multi-pod` trains on the (2, 16, 16)
production mesh, which needs a process group of 512 ranks.
"""
import argparse
import os
import sys
import tempfile


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
    ap.add_argument("--debug-mesh", default="",
                    help="e.g. 2,2 -> (data, model) debug mesh")
    ap.add_argument("--device-count", type=int, default=0,
                    help="devices the mesh may use (it must fit them)")
    ap.add_argument("--multi-pod", action="store_true",
                    help="the (pod, data, model) production mesh")
    args = ap.parse_args(argv)

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

    try:
        mesh, act = _mesh(args, torch.device(args.device))
    except (RuntimeError, ValueError) as e:
        print(f"[train] {e}", file=sys.stderr)
        return 2
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    trainer = Trainer(
        cfg, adamw.AdamWConfig(total_steps=args.steps, warmup_steps=10),
        TrainConfig(total_steps=args.steps, ckpt_every=50,
                    ckpt_dir=args.ckpt_dir, log_every=10,
                    grad_compression=args.grad_compression,
                    fail_at_step=args.fail_at, device=args.device),
        DataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq,
                   global_batch=args.batch), mesh=mesh, act_sharding=act)
    out = trainer.train()
    hist = out["history"]
    if hist:
        last = hist[-1]
        where = (torch.cuda.get_device_name(trainer.device)
                 if trainer.device.type == "cuda" else "cpu")
        aux = (f"aux_loss={last['aux_loss']:.4f} " if cfg.moe.enabled
               else "")
        on = "" if mesh is None else f", {_describe(mesh, act)}"
        print(f"[train] step {last['step']} loss={last['loss']:.4f} {aux}"
              f"gnorm={last['grad_norm']:.3f} "
              f"{last['step_time_s'] * 1e3:.1f}ms/step ({where}{on})")
    print("[train] done")
    return 0


def _mesh(args, device):
    """(mesh, activation sharding) from the mesh flags, or (None, None) on
    one device. Raises with the reason a mesh cannot be built."""
    import torch.distributed as dist
    from repro_torch.distributed import sharding as Sh
    from repro_torch.launch import mesh as ML
    if args.debug_mesh:
        dims = tuple(int(x) for x in args.debug_mesh.split(","))
        if len(dims) != 2:
            raise ValueError(f"--debug-mesh {args.debug_mesh}: D,M")
        if args.device_count and args.device_count < dims[0] * dims[1]:
            raise ValueError(f"Number of devices {args.device_count} must "
                             f"be >= the product of mesh_shape {dims}")
        mesh = ML.make_debug_mesh(*dims, process=dist.is_available()
                                  and dist.is_initialized(),
                                  device_type=device.type)
    elif args.multi_pod:
        mesh = ML.make_production_mesh(multi_pod=True,
                                       device_type=device.type)
    else:
        return None, None
    act = Sh.NamedSharding(mesh, Sh.activation_spec(
        mesh, sequence_parallel=args.seq % mesh.shape["model"] == 0))
    return mesh, act


def _describe(mesh, act) -> str:
    shape = "x".join(str(mesh.shape[a]) for a in mesh.axis_names)
    sp = ", sequence parallel" if act.spec[1] == "model" else ""
    return f"{shape} {type(mesh).__name__}{sp}"


if __name__ == "__main__":
    sys.exit(main())
