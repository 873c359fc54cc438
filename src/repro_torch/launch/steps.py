"""Step functions: the units the trainer and the launchers run (the port of
the JAX package's `launch/steps.py`).

  train_step  : forward + backward + AdamW update (+ optional int8 EF
                compression)
  eval_step   : loss metrics, no gradient
  prefill_step: prompt -> (last logits, primed caches)
  serve_step  : one decode step against the caches

PyTorch runs eagerly, so these are plain closures (no jit). A train step
updates params and optimizer moments IN PLACE, where the JAX trainer
donated them, and returns the same objects. With `act_sharding` (a mesh
and its activation spec, `distributed.sharding.NamedSharding`, whose
`profile` picks the parameter placement) the train
step runs on that mesh through the plan's hooks
(`distributed.train_parallel.TrainPlan`); params, optimizer state and
residual are then lists over the mesh's local coordinates, placed by
`train_step.plan.place`. One step body serves both: one device is a list
of one coordinate (`OneDeviceTraining`).

While a torch profiler is active the train step records three phase spans
(`telemetry.tracer.span`): "train.forward" (the loss), "train.backward"
(`torch.autograd.grad`) and "train.optimizer" (gradient reduction,
compression, the global norm and AdamW), each with its device time from
a pair of CUDA events when the params are on the card: the host runs
ahead of the card, so its own stamps time only the enqueue.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from repro_torch import tree
from repro_torch.core import model as Mod
from repro_torch.core.types import ModelConfig
from repro_torch.optim import adamw, compress
from repro_torch.telemetry.tracer import span


class OneDeviceTraining:
    """The train step's hooks on one device (a mesh's are
    `distributed.train_parallel.TrainPlan`'s): the params whole, nothing
    to reduce. Gradients come as lists of trees, one per coordinate."""

    amax_reduce = None

    def train_loss(self, ps, cfg: ModelConfig, batch, **kw):
        return Mod.loss_fn(ps[0], cfg, batch, **kw)

    def reduce_grads(self, grads):
        return grads

    def global_norm(self, grads):
        return adamw.global_norm(grads)


def unique_leaves(trees):
    """The distinct tensors of a list of trees, in order (a LocalMesh's
    replicas of one shard are one tensor)."""
    seen, out = set(), []
    for t in trees:
        for x in tree.leaves(t):
            if id(x) not in seen:
                seen.add(id(x))
                out.append(x)
    return out


def make_train_step(cfg: ModelConfig, opt_cfg: adamw.AdamWConfig, *,
                    impl: Optional[str] = None, act_sharding=None,
                    grad_compression: bool = False, remat: bool = True,
                    remat_policy: str = "nothing") -> Callable:
    """train_step(params, opt_state, batch[, residual]) -> (params,
    opt_state, metrics[, residual]). Metrics are 0-dim device tensors:
    loss, aux_loss, tokens, grad_norm, lr. act_sharding: see the module
    docstring; `train_step.plan` holds the step's hooks (the mesh's
    `TrainPlan`)."""
    one = act_sharding is None
    if one:
        plan = OneDeviceTraining()
    else:
        from repro_torch.distributed import train_parallel
        plan = train_parallel.TrainPlan(cfg, act_sharding.mesh,
                                        act_sharding.spec,
                                        profile=act_sharding.profile)

    def train_step(params, opt_state, batch, residual=None):
        ps, opts, rs = (([params], [opt_state], [residual]) if one
                        else (params, opt_state, residual))
        leaves = unique_leaves(ps)
        card = leaves[0].is_cuda
        # the params carry requires_grad only inside this step: afterwards
        # serving on them (prefill, decode, the engine) records no autograd
        try:
            with torch.enable_grad():
                for p in leaves:
                    p.requires_grad_(True)
                with span("train.forward", device=card):
                    total, metrics = plan.train_loss(
                        ps, cfg, batch, impl=impl, remat=remat,
                        remat_policy=remat_policy)
                with span("train.backward", device=card):
                    grads = torch.autograd.grad(total, leaves)
        finally:
            for p in leaves:
                p.requires_grad_(False)
        with span("train.optimizer", device=card):
            by_id = {id(x): g for x, g in zip(leaves, grads)}
            grads = plan.reduce_grads(
                [tree.tree_map(lambda x: by_id[id(x)], t) for t in ps])
            if grad_compression:
                grads, rs = compress.compress_decompress(grads, rs,
                                                         plan.amax_reduce)
            gnorm = plan.global_norm(grads)
            # AdamW once on each distinct param with its gradient and
            # moments
            quads, seen = [], set()
            for p, g, o in zip(ps, grads, opts):
                for q in zip(tree.leaves(p), tree.leaves(g),
                             tree.leaves(o.mu), tree.leaves(o.nu),
                             strict=True):
                    if id(q[0]) not in seen:
                        seen.add(id(q[0]))
                        quads.append(q)
            p_, g_, mu, nu = (list(x) for x in zip(*quads))
            _, new, om = adamw.apply_updates(
                p_, g_, adamw.OptState(opts[0].step, mu, nu), opt_cfg,
                gnorm=gnorm)
        opts = [adamw.OptState(new.step, o.mu, o.nu) for o in opts]
        metrics = {k: v.detach() for k, v in {**metrics, **om}.items()}
        out = (params, opts[0] if one else opts, metrics)
        if grad_compression:
            out += (rs[0] if one else rs,)
        return out

    train_step.plan = plan
    return train_step


def make_eval_step(cfg: ModelConfig, *,
                   impl: Optional[str] = None) -> Callable:
    @torch.no_grad()
    def eval_step(params, batch):
        _, metrics = Mod.loss_fn(params, cfg, batch, impl=impl, remat=False)
        return metrics
    return eval_step


def make_prefill_step(cfg: ModelConfig, max_len: int, *,
                      impl: Optional[str] = None) -> Callable:
    def prefill_step(params, batch):
        return Mod.prefill(params, cfg, batch, max_len, impl=impl)
    return prefill_step


def make_serve_step(cfg: ModelConfig, *,
                    impl: Optional[str] = None) -> Callable:
    def serve_step(params, caches, batch):
        return Mod.decode_step(params, cfg, batch, caches, impl=impl)
    return serve_step
