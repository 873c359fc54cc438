"""Per-slot token sampling for the serving engine (the port of the JAX
package's `serving/sampling.py`).

Each slot carries its own temperature: greedy rows (temperature <= 0) take
the argmax of the raw logits, sampling rows draw from the temperature-scaled
(optionally top-k-truncated) distribution by the Gumbel-max trick. An
explicit `torch.Generator` takes the place of the JAX key.

The full path draws the same amount of noise, one uniform per (row, vocab)
entry, whatever the temperatures are, so flipping one slot's temperature
never shifts any other slot's random stream, and a fixed generator state
reproduces. The greedy-only branch (`any_sampling=False`, the JAX
sampler's `lax.cond` branch) takes one argmax and draws nothing: where the
JAX key still splits in a greedy-only block, the port's generator does not
advance. The engine decides the branch on the host, from the same slot
state for every `scan_steps`, so its runs still reproduce under a fixed
seed. The draws are not JAX's: sampled rows are held to these properties,
not to JAX's tokens.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch


def finite_rows(logits: torch.Tensor) -> torch.Tensor:
    """(B,) bool: the row is entirely finite (no NaN/Inf in its trailing
    axes). The decode loop's guard: a non-finite row is quarantined, not
    emitted."""
    return torch.isfinite(logits).reshape(logits.shape[0], -1).all(dim=-1)


def sample(generator: torch.Generator, logits: torch.Tensor,
           temperatures: torch.Tensor, top_k: int = 0,
           any_sampling: Optional[bool] = None,
           rows: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """Draw one token per row. logits: (B, V); temperatures: (B,) float.
    top_k: 0 disables truncation. any_sampling: the host's `any(temps > 0)`
    over the live rows; False takes the greedy-only branch, one argmax of
    the raw logits, bitwise the full path's greedy rows. None (the caller
    does not know) and True take the full path. rows (offset, total): the
    B rows are rows [offset, offset + B) of a block of `total`: the noise
    of the whole block is drawn and these rows of it kept, so a shard of a
    slot-parallel mesh draws what the single-device engine draws for its
    slots. Returns int32 (B,)."""
    logits = logits.float()
    greedy = logits.argmax(dim=-1).to(torch.int32)
    if any_sampling is False:
        return greedy
    temps = temperatures.to(device=logits.device, dtype=torch.float32)
    if rows is None:
        u = torch.rand(logits.shape, generator=generator,
                       device=logits.device)
    else:
        u = torch.rand((rows[1], logits.shape[1]), generator=generator,
                       device=logits.device)[rows[0]:rows[0]
                                             + logits.shape[0]]
    gumbel = -torch.log(-torch.log(u.clamp_(min=1e-20)))
    lg = logits
    if top_k and top_k < lg.shape[-1]:
        kth = torch.topk(lg, top_k, dim=-1).values[:, -1:]
        lg = torch.where(lg < kth, float("-inf"), lg)
    scaled = lg / torch.clamp(temps[:, None], min=1e-6)
    drawn = (scaled + gumbel).argmax(dim=-1).to(torch.int32)
    return torch.where(temps > 0, drawn, greedy)
