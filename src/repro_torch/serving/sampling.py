"""Per-slot token sampling for the serving engine (the port of the JAX
package's `serving/sampling.py`).

Each slot carries its own temperature: greedy rows (temperature <= 0) take
the argmax of the raw logits, sampling rows draw from the temperature-scaled
(optionally top-k-truncated) distribution by the Gumbel-max trick. An
explicit `torch.Generator` takes the place of the JAX key.

Every call draws the same amount of noise, one uniform per (row, vocab)
entry, whatever the temperatures are, so flipping one slot's temperature
never shifts any other slot's random stream, and a fixed generator state
reproduces. The draws are not JAX's: sampled rows are held to these
properties, not to JAX's tokens.
"""
from __future__ import annotations

import torch


def finite_rows(logits: torch.Tensor) -> torch.Tensor:
    """(B,) bool: the row is entirely finite (no NaN/Inf in its trailing
    axes). The decode loop's guard: a non-finite row is quarantined, not
    emitted."""
    return torch.isfinite(logits).reshape(logits.shape[0], -1).all(dim=-1)


def sample(generator: torch.Generator, logits: torch.Tensor,
           temperatures: torch.Tensor, top_k: int = 0) -> torch.Tensor:
    """Draw one token per row. logits: (B, V); temperatures: (B,) float.
    top_k: 0 disables truncation. Returns int32 (B,)."""
    logits = logits.float()
    temps = temperatures.to(device=logits.device, dtype=torch.float32)
    greedy = logits.argmax(dim=-1).to(torch.int32)
    u = torch.rand(logits.shape, generator=generator, device=logits.device)
    gumbel = -torch.log(-torch.log(u.clamp_(min=1e-20)))
    lg = logits
    if top_k and top_k < lg.shape[-1]:
        kth = torch.topk(lg, top_k, dim=-1).values[:, -1:]
        lg = torch.where(lg < kth, float("-inf"), lg)
    scaled = lg / torch.clamp(temps[:, None], min=1e-6)
    drawn = (scaled + gumbel).argmax(dim=-1).to(torch.int32)
    return torch.where(temps > 0, drawn, greedy)
