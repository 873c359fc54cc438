"""Pipeline parallelism: GPipe microbatching over the super-block seam (the
port of the JAX package's `distributed/pipeline.py`).

The model is a list of super-blocks; pipeline parallelism cuts that list
into n stages over a "pipe" mesh axis (`launch/mesh.py`) and shifts
activations stage to stage. The loop is written forward only: autograd
runs it in reverse, the shift's gradient being the opposite shift, so the
backward pipeline falls out of autodiff as in JAX.

Schedule (n stages, m microbatches, T = n + m - 1 ticks): at tick t stage
0 injects microbatch t (t < m); every stage applies its super-blocks;
outputs shift +1; the last stage banks microbatch t - (n-1). The bubble
fraction is (n-1)/T (`bubble_fraction`).

Mesh kinds. On a process mesh each rank holds its stage's super-blocks
(`stage_params`) and runs every tick as the JAX program does: it embeds
and applies its stage on every tick, injection and banking are masks on
the stage index, and only the last stage's loss counts. Every rank thus
runs the same collectives in the same order, forward and backward; its
warm-up and drain ticks compute on zeros or stale activations that never
reach a result (the unembed sees zeros, never drain garbage). On a
single-process mesh every stage runs in one loop and one autograd graph,
and a stage that would compute such a result, which nothing reads, is
skipped: the live (tick, stage) pairs are exactly the plain forward's
work.

The loss and the aux loss are summed over the pipe axis. The
pipe-replicated leaves (embed, head, final norm) get their gradients
summed over the stages: on a process mesh through `mesh.replicated` (the
transposed psum of JAX), on a single-process mesh because every stage
reads the same tensor.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch

from repro_torch import tree
from repro_torch.core import model as Mod
from repro_torch.core.types import ModelConfig


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    num_stages: int
    num_microbatches: int
    axis: str = "pipe"

    def __post_init__(self):
        if self.num_microbatches < self.num_stages:
            raise ValueError("microbatches < stages leaves permanent "
                             "bubbles")


def bubble_fraction(pcfg: PipelineConfig) -> float:
    n, m = pcfg.num_stages, pcfg.num_microbatches
    return (n - 1) / (n + m - 1)


def _stage_apply(blocks, cfg: ModelConfig, x, *, impl: Optional[str],
                 remat: bool, remat_policy: str = "nothing"):
    """One stage: this shard's super-blocks."""
    return Mod._stack_forward(blocks, cfg, x, impl=impl, remat=remat,
                              remat_policy=remat_policy)


def stage_params(params: Dict[str, Any], cfg: ModelConfig,
                 pcfg: PipelineConfig, stage: int) -> Dict[str, Any]:
    """A process mesh rank's params: stage `stage`'s super-blocks, and the
    pipe-replicated leaves as they are (the same tensors)."""
    per = cfg.num_super_blocks // pcfg.num_stages
    return {**params,
            "blocks": params["blocks"][stage * per:(stage + 1) * per]}


def pipeline_loss_fn(params, cfg: ModelConfig, batch, pcfg: PipelineConfig,
                     *, mesh, impl: Optional[str] = None, remat: bool = True,
                     aux_weight: float = 0.01,
                     remat_policy: str = "nothing"):
    """GPipe cross-entropy loss. params["blocks"] holds the local shards'
    super-blocks in stage order (a process mesh rank: its stage's; a
    single-process mesh: all); everything else is pipe-replicated. The
    batch is whole on every shard; only stage 0 reads its tokens. Returns
    (total, {"loss", "aux_loss", "tokens"}), the same on every shard."""
    axis = pcfg.axis
    n = mesh.shape[axis]
    stages = mesh.index(axis)
    m = pcfg.num_microbatches
    every_tick = not mesh.one_graph
    tokens, labels = batch["tokens"], batch["labels"]
    bsz, seq = tokens.shape
    if bsz % m:
        raise ValueError(f"batch {bsz} does not split into {m} microbatches")
    mb = bsz // m
    tok_mb = tokens.reshape(m, mb, seq)
    per = len(params["blocks"]) // len(stages)
    blocks = [params["blocks"][j * per:(j + 1) * per]
              for j in range(len(stages))]
    shared = {k: v for k, v in params.items() if k != "blocks"}
    flat = tree.leaves(shared)
    reps = [mesh.replicated(p, axis) for p in flat]
    views = [tree.unflatten(shared, [r[j] for r in reps])
             for j in range(len(stages))]
    dev = tokens.device
    dt = Mod._dtype(cfg)

    zeros = torch.zeros((mb, seq, cfg.d_model), dtype=dt, device=dev)
    bufs = [zeros] * len(stages)
    banked = [[zeros] * m for _ in stages]
    aux_total = [torch.zeros((), device=dev) for _ in stages]
    for t in range(m + n - 1):
        ys = []
        for j, s in enumerate(stages):
            live = t >= s and t - s < m
            if not (live or every_tick):
                ys.append(zeros)
                continue
            if every_tick:
                # every rank embeds and reads its buffer, so its graph (and
                # its collectives' backward) matches every other rank's
                inj = Mod.embed_tokens(views[j], cfg,
                                       {"tokens": tok_mb[min(t, m - 1)]})
                x = torch.where(torch.tensor(s == 0, device=dev),
                                inj.to(dt), bufs[j])
            elif s == 0:
                x = Mod.embed_tokens(views[j], cfg,
                                     {"tokens": tok_mb[t]}).to(dt)
            else:
                x = bufs[j]
            y, aux = _stage_apply(blocks[j], cfg, x, impl=impl, remat=remat,
                                  remat_policy=remat_policy)
            if live:          # warm-up and drain ticks add no aux loss
                aux_total[j] = aux_total[j] + aux
            out_idx = t - (n - 1)
            if out_idx >= 0 and (s == n - 1 or every_tick):
                banked[j][out_idx] = y * float(s == n - 1)
            ys.append(y)
        if t < m + n - 2:
            bufs = mesh.shift(ys, axis, +1)

    # unembed + CE on the banked outputs (zeros on the other stages: finite
    # logits, weighted out below)
    ces = []
    for j, s in enumerate(stages):
        if not (s == n - 1 or every_tick):
            ces.append(torch.zeros((), device=dev))
            continue
        x = torch.stack(banked[j]).reshape(bsz, seq, cfg.d_model)
        ce, denom = Mod.cross_entropy(Mod._unembed(views[j], cfg, x), labels)
        ces.append(ce * float(s == n - 1))
    loss = mesh.sum_out(ces, axis)
    # aux is a per-token mean statistic: average over microbatches so the
    # pipeline matches the single-pass loss (which sees the batch once)
    aux_all = mesh.sum_out(aux_total, axis) / m
    total = loss + aux_weight * aux_all
    return total, {"loss": loss, "aux_loss": aux_all,
                   "tokens": denom.to(torch.float32)}


def make_pipeline_loss(cfg: ModelConfig, pcfg: PipelineConfig, mesh, *,
                       impl: Optional[str] = None, remat: bool = True,
                       remat_policy: str = "nothing"):
    """loss(params, batch) -> (total, metrics) over `mesh`'s pipe axis."""
    n = mesh.shape[pcfg.axis]
    if n != pcfg.num_stages:
        raise ValueError(f"{pcfg.num_stages} stages on a pipe axis of {n}")
    if cfg.num_super_blocks % pcfg.num_stages:
        raise ValueError(f"{cfg.num_super_blocks} super-blocks not divisible "
                         f"into {pcfg.num_stages} stages")
    local = cfg.num_super_blocks // n * len(mesh.index(pcfg.axis))

    def loss(params, batch):
        if len(params["blocks"]) != local:
            raise ValueError(f"{len(params['blocks'])} super-blocks given, "
                             f"{local} local to {mesh!r}")
        return pipeline_loss_fn(params, cfg, batch, pcfg, mesh=mesh,
                                impl=impl, remat=remat,
                                remat_policy=remat_policy)

    return loss


def make_pp_train_step(cfg: ModelConfig, opt_cfg, pcfg: PipelineConfig,
                       mesh, *, impl: Optional[str] = None,
                       remat: bool = True, remat_policy: str = "nothing"):
    """train_step(params, opt_state, batch) -> (params, opt_state, metrics):
    the pipeline loss, its reverse pipeline by autograd, then AdamW (in
    place, as `launch.steps.make_train_step`). On a process mesh each rank
    steps its own stage's params; the replicated leaves' gradients are
    already summed over the stages, so every rank updates them alike."""
    from repro_torch.optim import adamw
    loss_fn = make_pipeline_loss(cfg, pcfg, mesh, impl=impl, remat=remat,
                                 remat_policy=remat_policy)

    def train_step(params, opt_state, batch):
        leaves = tree.leaves(params)
        try:
            with torch.enable_grad():
                for p in leaves:
                    p.requires_grad_(True)
                total, metrics = loss_fn(params, batch)
                grads = torch.autograd.grad(total, leaves)
        finally:
            for p in leaves:
                p.requires_grad_(False)
        grads = tree.unflatten(params, list(grads))
        gnorm = None
        if not mesh.one_graph:
            # the clipping norm over the whole model: every stage's blocks
            # (summed over the axis) and the replicated leaves once
            sq = [sum(g.float().square().sum() for g in tree.leaves(part))
                  for part in (grads["blocks"],
                               {k: v for k, v in grads.items()
                                if k != "blocks"})]
            with torch.no_grad():
                gnorm = torch.sqrt(mesh.psum([sq[0]], pcfg.axis)[0] + sq[1])
        params, opt_state, om = adamw.apply_updates(params, grads, opt_state,
                                                    opt_cfg, gnorm=gnorm)
        return params, opt_state, {k: v.detach()
                                   for k, v in {**metrics, **om}.items()}

    return train_step
