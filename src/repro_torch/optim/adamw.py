"""AdamW with decoupled weight decay, global-norm clipping and a cosine
schedule (the port of the JAX package's `optim/adamw.py`).

Written on tensors rather than `torch.optim`, so the arithmetic follows the
JAX formula term for term: fp32 moments `mu` and `nu` shaped like the
params, an int32 step tensor, the math in fp32 and the params keeping
their dtype. Where the JAX trainer donated params and optimizer state,
`apply_updates` updates `mu`, `nu` and the params IN PLACE (under
torch.no_grad) and returns the same objects.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple, Optional

import torch

from repro_torch import tree


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1


class OptState(NamedTuple):
    step: torch.Tensor   # () int32
    mu: Any              # fp32 tree like params
    nu: Any              # fp32 tree like params


def init_opt_state(params) -> OptState:
    first = tree.leaves(params)[0]
    zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                  device=p.device)
    return OptState(step=torch.zeros((), dtype=torch.int32,
                                     device=first.device),
                    mu=tree.tree_map(zeros, params),
                    nu=tree.tree_map(zeros, params))


def schedule(cfg: AdamWConfig, step) -> torch.Tensor:
    """Linear warmup to cfg.lr, then cosine decay to min_lr_ratio * lr;
    fp32 0-dim tensor."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * prog))
    return cfg.lr * warm * (cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * cos)


def global_norm(grads) -> torch.Tensor:
    sq = [g.float().square().sum() for g in tree.leaves(grads)]
    return torch.sqrt(torch.stack(sq).sum())


@torch.no_grad()
def apply_updates(params, grads, state: OptState, cfg: AdamWConfig,
                  gnorm: Optional[torch.Tensor] = None):
    """One AdamW step. Returns (params, state, {"grad_norm", "lr"}): params
    and the moments are the given tensors, updated in place; the step is a
    new tensor. Weight decay applies to leaves with ndim >= 2. `gnorm`: the
    clipping norm where `grads` holds only part of the model (a pipeline
    stage's), else the global norm of `grads`."""
    step = state.step + 1
    if gnorm is None:
        gnorm = global_norm(grads)
    clip = torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)
    lr = schedule(cfg, step)
    stepf = step.to(torch.float32)
    b1c = 1 - cfg.beta1 ** stepf
    b2c = 1 - cfg.beta2 ** stepf
    for p, g, mu, nu in zip(tree.leaves(params), tree.leaves(grads),
                            tree.leaves(state.mu), tree.leaves(state.nu),
                            strict=True):
        g = g.float() * clip
        mu.mul_(cfg.beta1).add_((1 - cfg.beta1) * g)
        nu.mul_(cfg.beta2).add_((1 - cfg.beta2) * g * g)
        delta = (mu / b1c) / (torch.sqrt(nu / b2c) + cfg.eps)
        if p.dim() >= 2:
            delta = delta + cfg.weight_decay * p.float()
        p.copy_(p.float() - lr * delta)
    return params, OptState(step, state.mu, state.nu), {"grad_norm": gnorm,
                                                        "lr": lr}
