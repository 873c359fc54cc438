"""int8 error-feedback gradient compression (the port of the JAX package's
`optim/compress.py`).

Quantizes each gradient (plus the carried residual) to int8 with a
per-tensor scale and dequantizes it, as the data-parallel all-reduce of a
multi-device run would see it; the quantization residual is carried to the
next step (error feedback). The scale is the whole leaf's max, as the JAX
package computes it: a super-block leaf's over every super-block (the JAX
package stacks them into one leaf, the port keeps a list: `stacked_max`),
and on a mesh over all of the leaf's shards (`amax_reduce`).
"""
from __future__ import annotations

import re
from typing import Any, List, Sequence, Tuple

import torch

from repro_torch import tree


def init_residual(params) -> Any:
    return tree.tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                               device=p.device), params)


def _quantize(x: torch.Tensor, amax: torch.Tensor):
    """(int8 values, scale) of x at the scale of `amax`."""
    scale = torch.clamp(amax, min=1e-12) / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def stacked_max(paths: Sequence[str], amax: torch.Tensor
                ) -> List[torch.Tensor]:
    """Per leaf path, the max of `amax` (one entry a path) over the leaves
    of the same JAX leaf: "blocks/<i>/..." (and "enc_blocks/<i>/...") of
    every super-block i."""
    keys = [re.sub(r"(^|/)(blocks|enc_blocks)/\d+/", r"\1\2/*/", p,
                   count=1) for p in paths]
    groups: dict = {}
    for j, k in enumerate(keys):
        groups.setdefault(k, []).append(j)
    top = {k: amax[js].max() for k, js in groups.items()}
    return [top[k] for k in keys]


@torch.no_grad()
def compress_decompress(grads, residual,
                        amax_reduce=None) -> Tuple[Any, Any]:
    """Returns (effective grads in the grads' dtypes, new fp32 residual).
    `amax_reduce` maps the vector of the leaves' max |g + r| to each one's
    max over all of its shards: a mesh's (`TrainPlan.amax_reduce`), whose
    grads and residual are lists over its local coordinates of their
    shard trees; a tensor that several coordinates share (a LocalMesh's
    replicas) gives one tensor back."""
    items = tree.flatten_with_paths(grads)
    res = tree.leaves(residual)
    xs = {}
    for (_, g), r in zip(items, res, strict=True):
        if id(r) not in xs:
            xs[id(r)] = g.float() + r
    amax = torch.stack([xs[id(r)].abs().max() for r in res])
    if amax_reduce is not None:
        amax = amax_reduce(amax)
    out, new = {}, {}
    for (_, g), r, a in zip(items, res,
                            stacked_max([p for p, _ in items], amax)):
        if id(r) not in out:
            q, scale = _quantize(xs[id(r)], a)
            deq = q.float() * scale
            out[id(r)], new[id(r)] = deq.to(g.dtype), xs[id(r)] - deq
    return (tree.unflatten(grads, [out[id(r)] for r in res]),
            tree.unflatten(residual, [new[id(r)] for r in res]))
