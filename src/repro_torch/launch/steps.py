"""Step functions: the units the trainer and the launchers run (the port of
the JAX package's `launch/steps.py`).

  train_step  : forward + backward + AdamW update (+ optional int8 EF
                compression)
  eval_step   : loss metrics, no gradient
  prefill_step: prompt -> (last logits, primed caches)
  serve_step  : one decode step against the caches

PyTorch runs eagerly, so these are plain closures (no jit). A train step
updates params and optimizer moments IN PLACE, where the JAX trainer
donated them, and returns the same objects.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from repro_torch import tree
from repro_torch.core import model as Mod
from repro_torch.core.types import ModelConfig
from repro_torch.optim import adamw, compress


def make_train_step(cfg: ModelConfig, opt_cfg: adamw.AdamWConfig, *,
                    impl: Optional[str] = None,
                    grad_compression: bool = False, remat: bool = True,
                    remat_policy: str = "nothing") -> Callable:
    """train_step(params, opt_state, batch[, residual]) -> (params,
    opt_state, metrics[, residual]). Metrics are 0-dim device tensors:
    loss, aux_loss, tokens, grad_norm, lr."""
    def train_step(params, opt_state, batch, residual=None):
        leaves = tree.leaves(params)
        # the params carry requires_grad only inside this step: afterwards
        # serving on them (prefill, decode, the engine) records no autograd
        try:
            with torch.enable_grad():
                for p in leaves:
                    p.requires_grad_(True)
                total, metrics = Mod.loss_fn(params, cfg, batch, impl=impl,
                                             remat=remat,
                                             remat_policy=remat_policy)
                grads = torch.autograd.grad(total, leaves)
        finally:
            for p in leaves:
                p.requires_grad_(False)
        grads = tree.unflatten(params, list(grads))
        if grad_compression:
            grads, residual = compress.compress_decompress(grads, residual)
        params, opt_state, om = adamw.apply_updates(params, grads, opt_state,
                                                    opt_cfg)
        metrics = {k: v.detach() for k, v in {**metrics, **om}.items()}
        if grad_compression:
            return params, opt_state, metrics, residual
        return params, opt_state, metrics
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
