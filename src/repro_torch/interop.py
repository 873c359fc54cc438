"""Convert the JAX package's param and cache pytrees, given as numpy arrays,
into the port's layout. Takes numpy only: the caller (the parity tests)
turns JAX arrays into numpy; this module never imports JAX.

JAX stacks the super-blocks: every leaf under `blocks/l{i}/...` (and every
cache leaf) has a leading num_super_blocks axis. The port keeps a Python
list with one dict per super-block, so the converters unstack that axis.
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
    out = {k: _map(lambda a: to_torch(a, device), v)
           for k, v in tree.items() if k != "blocks"}
    out["blocks"] = _unstack(tree["blocks"], cfg.num_super_blocks, device)
    return out


def caches_from_jax(tree: Dict[str, Any], cfg: ModelConfig,
                    device="cuda") -> List[Dict[str, Any]]:
    """JAX stacked decode caches (numpy leaves) -> port caches."""
    return _unstack(tree, cfg.num_super_blocks, device)


def caches_to_numpy(caches: List[Dict[str, Any]]) -> Dict[str, Any]:
    """Port caches -> the JAX stacked layout as numpy (for comparisons)."""
    def stack(*leaves):
        return np.stack([t.detach().float().cpu().numpy()
                         if t.dtype == torch.bfloat16
                         else t.detach().cpu().numpy() for t in leaves])
    first = caches[0]
    return {name: {leaf: stack(*[c[name][leaf] for c in caches])
                   for leaf in layer}
            for name, layer in first.items()}
