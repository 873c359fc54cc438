"""Multi-pod dry-run on the meta device: trace every (arch x shape x mesh)
cell and price it on the H100 (the port of the JAX package's
`launch/dryrun.py`, which lowers and compiles each cell through XLA).

Both meshes are single-process `LocalMesh`es of the JAX shapes:
  single pod : (16, 16)    axes (data, model)        - 256 devices
  multi-pod  : (2, 16, 16) axes (pod, data, model)   - 512 devices

For each cell this builds the real step (train: forward + backward + AdamW
through `steps.make_train_step(act_sharding=)`; prefill: `model.prefill`
over `global_batch` slots; decode: one `model.decode_step` token against
caches of `seq_len`) on meta tensors (shapes only, nothing allocated),
placed by the rule tables of `distributed/sharding.py` (`TrainPlan`,
`MeshPlan`), and runs it ONCE under `roofline.CostCounter` and the mesh's
collective record. The record goes to
experiments/dryrun_torch/<arch>__<shape>__<mesh>.json (incremental:
existing files are skipped unless --force), with the JAX record's keys:
`trace_s` replaces `compile_s`; `unrolled` is always true (the port loops
over the layers in Python, so every layer is counted); `memory` holds the
argument, output, alias and temp bytes per device (temp: the peak of the
storages the step allocated; argument + temp is the predicted peak).

On meta tensors the kernel wrappers run their plain versions (`--impl
pallas` is impl "kernel", whose wrappers hand meta tensors to them; `--impl
xla` is "banded"); nothing is built and CUDA is never touched. A cell takes
minutes on the host at (16, 16): every shard runs in this process.

Usage:
  python -m repro_torch.launch.dryrun --arch llama3.2-1b --shape train_4k --mesh single
  python -m repro_torch.launch.dryrun --all --mesh both
  python -m repro_torch.launch.dryrun --all --swat-variant    # beyond-paper cells
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time
import traceback
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from repro_torch import tree
from repro_torch.analysis.collectives import record_stats
from repro_torch.configs import ARCH_IDS, canonical, get_config, with_swat
from repro_torch.core import model as Mod
from repro_torch.core import moe as moe_lib
from repro_torch.core.types import ALL_SHAPES, ModelConfig, ShapeConfig
from repro_torch.distributed import roofline as R
from repro_torch.distributed import sharding as Sh
from repro_torch.distributed import tensor_parallel as TP
from repro_torch.kernels import dots as _dots
from repro_torch.kernels import ops as kops
from repro_torch.launch import analytic
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import specs as Sp
from repro_torch.launch import steps as St
from repro_torch.optim import adamw

SHAPES = {s.name: s for s in ALL_SHAPES}
# the JAX launcher's --impl choices, as the port's impls
IMPLS = {"xla": "banded", "pallas": "kernel"}

# long_500k skip policy (DESIGN.md §4): pure full-attention archs skip in
# their faithful config; SSM/hybrid/local-attn archs run. whisper's decoder
# is structurally capped at 448 tokens.
LONG_CTX_OK = {"mamba2_1p3b", "jamba_1p5_large", "gemma2_2b"}
SKIP = {(a, "long_500k") for a in ARCH_IDS if a not in LONG_CTX_OK}


def out_dir() -> Path:
    d = Path(__file__).resolve().parents[3] / "experiments" / "dryrun_torch"
    d.mkdir(parents=True, exist_ok=True)
    return d


def make_mesh(mesh_kind: str) -> mesh_lib.LocalMesh:
    """The JAX dry-run's production mesh, every shard in this process."""
    if mesh_kind == "multi":
        return mesh_lib.LocalMesh(mesh_lib.MULTI_POD_SHAPE,
                                  ("pod", "data", "model"))
    return mesh_lib.LocalMesh(mesh_lib.PRODUCTION_SHAPE, ("data", "model"))


def model_flops_per_device(cfg: ModelConfig, shape: ShapeConfig,
                           n_devices: int) -> float:
    n_active = Sp.active_param_count(cfg)
    if shape.mode == "train":
        f = 6.0 * n_active * shape.global_batch * shape.seq_len
    elif shape.mode == "prefill":
        f = 2.0 * n_active * shape.global_batch * shape.seq_len
    else:
        f = 2.0 * n_active * shape.global_batch
    return f / n_devices


def _filled(t: torch.Tensor, gen: torch.Generator, vocab: int):
    """A real tensor for a meta spec: token ids below the vocabulary,
    small normal floats."""
    if t.dtype.is_floating_point:
        return (torch.randn(t.shape, generator=gen, device=gen.device)
                * 0.02).to(t.dtype)
    return torch.randint(0, vocab, t.shape, generator=gen,
                         device=gen.device).to(t.dtype)


@dataclasses.dataclass
class Cell:
    """One cell's step, built: `run()` runs it once on `args` (what is
    live before it, as lists over the mesh's coordinates: one tree per
    coordinate of the params, optimizer state, caches and batch rows)."""
    run: Callable[[], Any]
    args: List[List[Any]]           # per coordinate: the trees it holds
    plan: Any


def build_cell(cfg: ModelConfig, shape: ShapeConfig, mesh, *,
               impl: Optional[str] = "banded",
               sequence_parallel: bool = True, profile: str = "tp",
               remat_policy: str = "nothing", device="meta",
               seed: int = 0) -> Cell:
    """The JAX dry-run's three steps on `mesh`, placed by the rule tables:
    on meta tensors (the dry-run), or with `device` on real ones (random
    params from `seed`, random inputs) to run the same step for real."""
    device = torch.device(device)
    meta = device.type == "meta"
    params = (Sp.param_specs(cfg) if meta
              else Mod.init_model(cfg, seed=seed, device=device))
    batch = Sp.input_specs(cfg, shape)
    if not meta:
        gen = torch.Generator(device=device).manual_seed(seed + 1)
        batch = {k: _filled(v, gen, cfg.vocab_size) for k, v in
                 batch.items()}
    b, length = shape.global_batch, shape.seq_len
    if shape.mode == "train":
        act = Sh.NamedSharding(
            mesh, Sh.activation_spec(mesh, sequence_parallel, profile),
            profile)
        step = St.make_train_step(
            cfg, adamw.AdamWConfig(), impl=impl, act_sharding=act,
            remat=remat_policy != "off",
            remat_policy="nothing" if remat_policy == "off" else remat_policy)
        plan = step.plan
        placed = plan.place({"params": params,
                             "opt": adamw.init_opt_state(params)})
        ps, opts = [s["params"] for s in placed], [s["opt"] for s in placed]
        rows = plan.batch_rows(batch)
        return Cell(lambda: step(ps, opts, batch),
                    [[p, o, r] for p, o, r in zip(ps, opts, rows)], plan)
    enc_len = Sp.ENCODER_FRAMES if cfg.encoder_decoder else 0
    plan = TP.MeshPlan(cfg, mesh, params, slots=b, max_len=length,
                       lookahead=0, paged=False, profile=profile,
                       enc_len=enc_len)
    ps = plan.place_params(params)
    if shape.mode == "prefill":
        per = b // plan.groups if plan.splits(b) else b
        rows = []
        for c in plan.coords:
            lo = plan.group(c) * per if plan.splits(b) else 0
            rows.append({k: v[lo:lo + per] for k, v in batch.items()})
        return Cell(lambda: Mod.prefill(ps, cfg, rows, length, impl=impl,
                                        plan=plan),
                    [[p, r] for p, r in zip(ps, rows)], plan)
    caches = plan.init_caches(device)
    rows = [{"tokens": t} for t in plan.local_rows(batch["tokens"], 0)]
    return Cell(lambda: Mod.decode_step(ps, cfg, rows, caches, impl=impl,
                                        plan=plan),
                [[p, c, r] for p, c, r in zip(ps, caches, rows)], plan)


def _storages(trees) -> Dict[int, int]:
    out = {}
    for x in tree.leaves(trees):
        if isinstance(x, torch.Tensor):
            s = x.untyped_storage()
            out[s._cdata] = s.nbytes()
    return out


def argument_bytes(cell: Cell) -> float:
    """Bytes each device holds before the step, averaged over the mesh
    (each coordinate's distinct storages; replicas of one shard count on
    every coordinate that holds them)."""
    return sum(sum(_storages(a).values()) for a in cell.args) / len(
        cell.args)


@dataclasses.dataclass
class Traced:
    cost: dict                      # per device: flops, bytes accessed
    record: list                    # the mesh's collectives
    memory: dict                    # per device
    trace_s: float


def trace_cell(cfg: ModelConfig, shape: ShapeConfig, mesh, *,
               impl: str = "banded", sequence_parallel: bool = True,
               profile: str = "tp", remat_policy: str = "nothing"
               ) -> Traced:
    """Build one cell on meta tensors and run its step once under the cost
    counter and the mesh's record. profile 'cp' turns on halo-exchange
    context parallelism over 'model' (`ops.set_context_parallel`) and
    places params 2-D FSDP; 'fsdp' is the same placement with
    batch-parallel compute. Expert parallelism is registered on the mesh
    (`moe.set_expert_parallel`), as in the JAX dry-run."""
    kops.set_context_parallel(mesh if profile == "cp" else None, "model")
    moe_lib.set_expert_parallel(mesh)
    native = _dots._NATIVE
    # TPU-native mixed-precision dots: no fp32 operand copies are charged
    _dots.native_mixed_dot(True)
    try:
        t0 = time.perf_counter()
        cell = build_cell(cfg, shape, mesh, impl=impl,
                          sequence_parallel=sequence_parallel,
                          profile=profile, remat_policy=remat_policy)
        n = len(cell.args)
        counter = R.CostCounter()
        counter.arguments(cell.args)
        arg = argument_bytes(cell)
        before = _storages(cell.args)
        with mesh.recording() as record, counter:
            out = cell.run()
        trace_s = time.perf_counter() - t0
        outs = _storages(out)
        memory = {
            "argument_size_in_bytes": arg,
            "output_size_in_bytes": sum(outs.values()) / n,
            "alias_size_in_bytes": sum(v for k, v in outs.items()
                                       if k in before) / n,
            "temp_size_in_bytes": counter.peak / n}
        return Traced(counter.cost_analysis(n), list(record), memory,
                      trace_s)
    finally:
        _dots.native_mixed_dot(native)
        kops.set_context_parallel(None)
        moe_lib.set_expert_parallel(None)


def run_cell(arch: str, shape_name: str, mesh_kind: str, *,
             swat_variant: bool = False, impl: str = "xla",
             sequence_parallel: bool = True, tag: str = "",
             profile: str = "tp", moe_dispatch: str = "sort",
             remat_policy: str = "nothing", verbose: bool = True) -> dict:
    """One cell's record (JAX's keys; see the module docstring).
    shape_name: a name of `SHAPES`, or a ShapeConfig."""
    cfg = get_config(arch)
    if swat_variant:
        cfg = with_swat(cfg)
    if cfg.moe.enabled and moe_dispatch != cfg.moe.dispatch:
        cfg = dataclasses.replace(
            cfg, moe=dataclasses.replace(cfg.moe, dispatch=moe_dispatch))
    shape = SHAPES[shape_name] if isinstance(shape_name, str) else shape_name
    return cell_record(cfg, shape, make_mesh(mesh_kind), mesh_kind,
                       impl=impl, sequence_parallel=sequence_parallel,
                       tag=tag, profile=profile, remat_policy=remat_policy,
                       verbose=verbose, counted=get_config(arch))


def cell_record(cfg: ModelConfig, shape: ShapeConfig, mesh, mesh_kind: str,
                *, impl: str = "xla", sequence_parallel: bool = True,
                tag: str = "", profile: str = "tp",
                remat_policy: str = "nothing", verbose: bool = True,
                counted: Optional[ModelConfig] = None) -> dict:
    """The record of `cfg` x `shape` traced on `mesh` (counted: the config
    whose params the record counts, JAX's faithful one)."""
    n_dev = len(mesh.coords())
    tr = trace_cell(cfg, shape, mesh, impl=IMPLS[impl],
                    sequence_parallel=sequence_parallel, profile=profile,
                    remat_policy=remat_policy)
    coll = record_stats(tr.record)
    mf = model_flops_per_device(cfg, shape, n_dev)
    roof = R.roofline_terms(tr.cost, coll, mf,
                            R.collective_seconds(tr.record, mesh))
    counted = counted or cfg
    rec = {
        "arch": cfg.name, "shape": shape.name, "mesh": mesh_kind,
        "mode": shape.mode, "devices": n_dev, "impl": impl,
        "params": Sp.param_count(counted),
        "active_params": Sp.active_param_count(counted),
        "trace_s": round(tr.trace_s, 2),
        "unrolled": True,
        "profile": profile,
        "memory": tr.memory,
        "roofline": roof.to_dict(),
        "analytic_flops_per_device": analytic.step_flops(cfg, shape) / n_dev,
        "tag": tag,
    }
    if verbose:
        print(f"[dryrun] {cfg.name} x {shape.name} x {mesh_kind} "
              f"({n_dev} dev): trace={tr.trace_s:.1f}s "
              f"flops/dev={roof.flops:.3e} bytes/dev={roof.bytes_accessed:.3e} "
              f"coll/dev={roof.collective_bytes:.3e} "
              f"dominant={roof.dominant} "
              f"roofline_frac={roof.roofline_fraction:.3f}")
        print(f"  memory: {tr.memory}")
        print(f"  collectives: {roof.counts}")
    return rec


def cell_path(arch, shape_name, mesh_kind, swat_variant, tag="",
              root: Optional[Path] = None) -> Path:
    suffix = "+swat" if swat_variant else ""
    t = f"__{tag}" if tag else ""
    return ((root or out_dir())
            / f"{canonical(arch)}{suffix}__{shape_name}__{mesh_kind}{t}.json")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None,
                    choices=list(SHAPES) + [None])
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--swat-variant", action="store_true",
                    help="beyond-paper: dense archs with SWAT window attn")
    ap.add_argument("--impl", default="xla", choices=["xla", "pallas"],
                    help="xla: the banded plain version; pallas: the "
                         "kernel wrappers (on meta tensors, their plain "
                         "versions)")
    ap.add_argument("--profile", default="tp", choices=["tp", "cp", "fsdp"],
                    help="cp: 2D-FSDP + halo-exchange context parallelism; "
                         "fsdp: 2D-FSDP, batch-parallel compute, no TP")
    ap.add_argument("--moe-dispatch", default="sort",
                    choices=["sort", "dense", "ep"])
    ap.add_argument("--remat", default="nothing",
                    choices=["nothing", "dots", "off"])
    ap.add_argument("--no-sp", action="store_true",
                    help="disable sequence-parallel activation sharding")
    ap.add_argument("--tag", default="")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--out-dir", default=None,
                    help="where the records go (default "
                         "experiments/dryrun_torch/)")
    args = ap.parse_args(argv)

    archs = ARCH_IDS if (args.all or not args.arch) else [args.arch]
    shapes = list(SHAPES) if (args.all or not args.shape) else [args.shape]
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    root = Path(args.out_dir) if args.out_dir else out_dir()
    root.mkdir(parents=True, exist_ok=True)

    failures: List[Tuple[str, str, str, str]] = []
    for arch in archs:
        for shape_name in shapes:
            skip_set = SKIP if not args.swat_variant else {
                (canonical(a), "long_500k") for a in ("whisper_tiny",
                                                      "mamba2_1p3b")}
            if (canonical(arch), shape_name) in skip_set:
                print(f"[dryrun] SKIP {arch} x {shape_name} "
                      f"(policy: DESIGN.md §4)")
                continue
            if args.swat_variant and get_config(arch).is_attention_free:
                continue
            for mesh_kind in meshes:
                path = cell_path(arch, shape_name, mesh_kind,
                                 args.swat_variant, args.tag, root)
                if path.exists() and not args.force:
                    print(f"[dryrun] cached {path.name}")
                    continue
                try:
                    rec = run_cell(arch, shape_name, mesh_kind,
                                   swat_variant=args.swat_variant,
                                   impl=args.impl,
                                   sequence_parallel=not args.no_sp,
                                   profile=args.profile,
                                   moe_dispatch=args.moe_dispatch,
                                   remat_policy=args.remat,
                                   tag=args.tag)
                    path.write_text(json.dumps(rec, indent=2))
                except Exception as e:
                    traceback.print_exc()
                    failures.append((arch, shape_name, mesh_kind, repr(e)))
    if failures:
        print("\nFAILURES:")
        for f in failures:
            print(" ", f)
        raise SystemExit(1)
    print("\nAll requested dry-run cells traced successfully.")


if __name__ == "__main__":
    main()
