"""int8 error-feedback gradient compression (the port of the JAX package's
`optim/compress.py`).

Quantizes each gradient (plus the carried residual) to int8 with a
per-tensor scale and dequantizes it, as the data-parallel all-reduce of a
multi-device run would see it; the quantization residual is carried to the
next step (error feedback). Single-device here: the all-reduce itself
belongs to the distributed slice.
"""
from __future__ import annotations

from typing import Any, Tuple

import torch

from repro_torch import tree


def init_residual(params) -> Any:
    return tree.tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                               device=p.device), params)


def _quantize(x: torch.Tensor):
    scale = torch.clamp(x.abs().max(), min=1e-12) / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


@torch.no_grad()
def compress_decompress(grads, residual) -> Tuple[Any, Any]:
    """Returns (effective grads in the grads' dtypes, new fp32 residual)."""
    out, res = [], []
    for g, r in zip(tree.leaves(grads), tree.leaves(residual), strict=True):
        x = g.float() + r
        q, scale = _quantize(x)
        deq = q.float() * scale
        out.append(deq.to(g.dtype))
        res.append(x - deq)
    return tree.unflatten(grads, out), tree.unflatten(residual, res)
