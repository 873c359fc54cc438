"""Weights made by the benchmark from the run's seed, on the device, in the
dtypes they are served in, laid out as the port's params dict.

Two flat buffers hold every leaf: one bf16 (the matrices) and one fp32 (the
norm scales and the MoE router, which the port keeps in fp32). Each is
filled by one `normal_` from a `torch.Generator` on the device and scaled
per group of leaves that share a standard deviation (1/sqrt(fan_in), the
embedding 0.02, norm scales 0.02), so making 16 GB takes a few large calls.
The same seed on the same device gives the same values, which is how the
reference regets the initial weights after training moved them.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import torch

from bench.work import Shape

EMBED_STD = NORM_STD = 0.02


def layout(shape: Shape) -> List[Tuple[str, tuple, str, float]]:
    """(path, shape, dtype, std) of every leaf, in buffer order: grouped by
    (dtype, std) so that each group is one contiguous run."""
    s = shape
    leaves = [("embed", (s.vocab, s.d), "bf16", EMBED_STD)]
    per_layer = [("mixer.wq", (s.d, s.hq * s.hd)),
                 ("mixer.wk", (s.d, s.hkv * s.hd)),
                 ("mixer.wv", (s.d, s.hkv * s.hd)),
                 ("mixer.wo", (s.hq * s.hd, s.d))]
    if s.experts:
        per_layer += [("moe.w1", (s.experts, s.d, s.d_ff)),
                      ("moe.w3", (s.experts, s.d, s.d_ff)),
                      ("moe.w2", (s.experts, s.d_ff, s.d))]
    else:
        per_layer += [("mlp.w1", (s.d, s.d_ff)), ("mlp.w3", (s.d, s.d_ff)),
                      ("mlp.w2", (s.d_ff, s.d))]
    for name, shp in per_layer:
        fan_in = shp[-2]
        for i in range(s.layers):
            leaves.append((f"blocks.{i}.l0.{name}", shp, "bf16",
                           fan_in ** -0.5))
    for i in range(s.layers):
        for norm in ("norm1", "norm2"):
            leaves.append((f"blocks.{i}.l0.{norm}.scale", (s.d,), "fp32",
                           NORM_STD))
    leaves.append(("final_norm.scale", (s.d,), "fp32", NORM_STD))
    if s.experts:
        for i in range(s.layers):
            leaves.append((f"blocks.{i}.l0.moe.router", (s.d, s.experts),
                           "fp32", s.d ** -0.5))
    return leaves


def make(shape: Shape, seed: int, device) -> Dict:
    """The params dict (port layout) of views into two flat buffers."""
    device = torch.device(device)
    gen = torch.Generator(device=device).manual_seed(int(seed) % 2**63)
    leaves = layout(shape)
    flat = {}
    for dt, tdt in (("bf16", torch.bfloat16), ("fp32", torch.float32)):
        n = sum(_numel(shp) for _, shp, d, _ in leaves if d == dt)
        buf = torch.empty(n, dtype=tdt, device=device)
        buf.normal_(generator=gen)
        flat[dt] = buf
    params: Dict = {}
    offset = {"bf16": 0, "fp32": 0}
    run_start, run_key = {}, None
    for path, shp, dt, std in leaves:
        n = _numel(shp)
        key = (dt, std)
        if key != run_key:
            if run_key is not None:
                _scale(flat, run_key, run_start[run_key], offset)
            run_key, run_start[key] = key, offset[dt]
        view = flat[dt][offset[dt]:offset[dt] + n].view(shp)
        offset[dt] += n
        _put(params, path, view)
    _scale(flat, run_key, run_start[run_key], offset)
    return _as_port(params, shape.layers)


def _numel(shp) -> int:
    n = 1
    for x in shp:
        n *= x
    return n


def _scale(flat, key, start, offset) -> None:
    dt, std = key
    flat[dt][start:offset[dt]].mul_(std)


def _put(tree: Dict, path: str, value) -> None:
    *head, last = path.split(".")
    for k in head:
        tree = tree.setdefault(k, {})
    tree[last] = value


def _as_port(params: Dict, layers: int) -> Dict:
    """`blocks` as the port's list of super-blocks."""
    params["blocks"] = [params["blocks"][str(i)] for i in range(layers)]
    return params


def leaves(params: Dict, prefix: str = "") -> List[Tuple[str, torch.Tensor]]:
    """(path, tensor) of every leaf of a params dict, in a fixed order."""
    out = []
    items = (enumerate(params) if isinstance(params, list)
             else sorted(params.items()))
    for k, v in items:
        path = f"{prefix}{k}"
        if isinstance(v, torch.Tensor):
            out.append((path, v))
        else:
            out.extend(leaves(v, path + "."))
    return out
