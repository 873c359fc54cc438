"""Convert the JAX package's param and cache pytrees, given as numpy arrays,
into the port's layout, and back. Takes and gives numpy only: the caller
(the parity tests) moves arrays between numpy and JAX; this module never
imports JAX.

JAX stacks the super-blocks: every leaf under `blocks/l{i}/...` and
`enc_blocks/l0/...` (whisper's encoder, one super-block per encoder layer),
and every cache leaf (the "xattn" cross K/V "xk"/"xv" included), has a
leading num_super_blocks axis. The port keeps a Python list with one dict
per super-block, so the converters unstack that axis.
"""
from __future__ import annotations

from typing import Any, Dict, List

import numpy as np
import torch

from repro_torch.core.types import ModelConfig


def to_torch(a, device="cuda") -> torch.Tensor:
    """numpy -> torch on `device`. bfloat16 arrays (ml_dtypes, as JAX hands
    them out) are moved as their raw 16-bit patterns, so no value is
    rounded."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        raw = torch.from_numpy(np.array(a).view(np.int16))
        return raw.view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a)).to(device)


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _unstack(tree, n: int, device) -> List[Dict[str, Any]]:
    return [_map(lambda a, i=i: to_torch(np.asarray(a)[i], device), tree)
            for i in range(n)]


def params_from_jax(tree: Dict[str, Any], cfg: ModelConfig,
                    device="cuda") -> Dict[str, Any]:
    """JAX `model.init_model` params (numpy leaves) -> port params."""
    stacked = {"blocks": cfg.num_super_blocks,
               "enc_blocks": cfg.encoder_layers}
    return {k: (_unstack(v, stacked[k], device) if k in stacked
                else _map(lambda a: to_torch(a, device), v))
            for k, v in tree.items()}


def caches_from_jax(tree: Dict[str, Any], cfg: ModelConfig,
                    device="cuda") -> List[Dict[str, Any]]:
    """JAX stacked decode caches (numpy leaves) -> port caches."""
    return _unstack(tree, cfg.num_super_blocks, device)


def _np32(t: torch.Tensor) -> np.ndarray:
    """A tensor as numpy; bf16 widened to fp32 (exact)."""
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def caches_to_numpy(caches: List[Dict[str, Any]]) -> Dict[str, Any]:
    """Port caches -> the JAX stacked layout as numpy (for comparisons)."""
    def stack(*leaves):
        return np.stack([_np32(t) for t in leaves])
    first = caches[0]
    return {name: {leaf: stack(*[c[name][leaf] for c in caches])
                   for leaf in layer}
            for name, layer in first.items()}


def params_to_numpy(params: Dict[str, Any], cfg: ModelConfig
                    ) -> Dict[str, Any]:
    """Port params (or a gradient tree shaped like them) -> the JAX stacked
    layout as numpy: `blocks/l{i}/...` leaves gain a leading
    num_super_blocks axis. The inverse of `params_from_jax`, for comparing
    gradients and trained params leaf by leaf."""
    stacked = {"blocks": cfg.num_super_blocks,
               "enc_blocks": cfg.encoder_layers}
    for k, n in stacked.items():
        if k in params and len(params[k]) != n:
            raise ValueError(f"{len(params[k])} {k}, config has {n}")

    def stack(*leaves):
        if isinstance(leaves[0], dict):
            return {k: stack(*[lf[k] for lf in leaves]) for k in leaves[0]}
        return np.stack([_np32(t) for t in leaves])

    return {k: (stack(*v) if k in stacked else _map(_np32, v))
            for k, v in params.items()}
