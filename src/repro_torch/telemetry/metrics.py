"""Device-resident decode counters (the port of the JAX package's
`telemetry/metrics.py`).

The JAX engine carries a pytree of int32 counters through its decode and
verify scans as one more donated carry. Here they are static int32
tensors, allocated once per engine (`init_metrics`) and updated IN PLACE
(`add_`, `copy_`) by the decode and verify bodies, which on the card are
captured as CUDA graphs: a graph replays fixed addresses, so a counter the
body rebound, or one bumped in Python on the host, would go wrong under
replay. Every update is a per-slot add derived from values the body
already computes (`ok` / `e` / `bad`), so a metrics-on engine's tokens are
bitwise a metrics-off engine's; the cost is about ten elementwise int32
kernels a step.

Counters (per slot unless noted):

  tokens           decode tokens emitted (prefill-sampled tokens are
                   host-side; see ServingEngine.stats)
  drafts_proposed  speculative drafts offered to the verifier
  drafts_accepted  drafts the verifier kept
  quarantined      numerical-guard trips (non-finite logits rows)
  ring_wraps       completed ring revolutions of decode writes, counted
                   against the engine's NARROWEST ring (`ring_modulus`);
                   cumulative across slot occupants like every counter
  pos              cumulative decode-write count (ring_wraps' phase
                   accumulator; also per-slot work done)
  steps            scalar: executed decode/verify steps

The host reads these ONLY at `ServingEngine.device_metrics()`: an
explicit sync between blocks, never inside one.
"""
from __future__ import annotations

from typing import Dict

import torch

PER_SLOT = ("tokens", "drafts_proposed", "drafts_accepted",
            "quarantined", "ring_wraps", "pos")
SCALARS = ("steps",)

COUNTER_DOC: Dict[str, str] = {
    "tokens": "decode tokens emitted on device",
    "drafts_proposed": "speculative draft tokens offered to the verifier",
    "drafts_accepted": "speculative draft tokens the verifier kept",
    "quarantined": "numerical-guard quarantine trips",
    "ring_wraps": "completed ring-cache revolutions of decode writes",
    "pos": "cumulative decode ring writes per slot",
    "steps": "executed decode/verify scan iterations",
}


def init_metrics(slots: int, device) -> Dict[str, torch.Tensor]:
    """Fresh all-zero counters on `device`: (slots,) int32 vectors and the
    () int32 step count. Allocated once; the updates below write them in
    place for the engine's lifetime."""
    mx = {k: torch.zeros((slots,), dtype=torch.int32, device=device)
          for k in PER_SLOT}
    for k in SCALARS:
        mx[k] = torch.zeros((), dtype=torch.int32, device=device)
    return mx


def ring_modulus(cfg, max_len: int, lookahead: int = 0) -> int:
    """The wrap modulus of the `ring_wraps` counter: the LOGICAL ring
    capacity of the engine's narrowest attention cache (a dense config's
    "ring" is the full context, which never wraps in practice)."""
    from repro_torch.core.layers import cache_capacity
    from repro_torch.core.model import attn_cfg
    caps = []
    for i, kind in enumerate(cfg.layer_pattern):
        if kind.startswith("mamba"):
            continue
        caps.append(cache_capacity(attn_cfg(cfg, kind, index=i), max_len,
                                   lookahead))
    return max(1, min(caps)) if caps else max(1, max_len)


def _advance_(mx: Dict[str, torch.Tensor], e: torch.Tensor,
              bad: torch.Tensor, ring_mod: int) -> None:
    """Add `e` (slots,) int32 emitted tokens and the `bad` guard trips.
    ring_wraps gains floor(new/mod) - floor(old/mod) of the advanced
    `pos` (non-negative: pos only grows)."""
    pos = mx["pos"] + e
    mx["ring_wraps"].add_(pos // ring_mod - mx["pos"] // ring_mod)
    mx["pos"].copy_(pos)
    mx["tokens"].add_(e)
    mx["quarantined"].add_(bad.to(torch.int32))
    mx["steps"].add_(1)


def seq_update_(mx: Dict[str, torch.Tensor], ok: torch.Tensor,
                bad: torch.Tensor, ring_mod: int) -> None:
    """One sequential decode step, in place: `ok` (slots,) bool = emitted
    this step, `bad` (slots,) bool = guard-quarantined this step. No effect
    on sampling, the generator or control flow."""
    _advance_(mx, ok.to(torch.int32), bad, ring_mod)


def spec_update_(mx: Dict[str, torch.Tensor], e: torch.Tensor,
                 bad: torch.Tensor, k: int, ring_mod: int) -> None:
    """One speculative verify step, in place: `e` (slots,) int32 = tokens
    emitted (accepted drafts + bonus, 0 for inactive slots), `bad` = guard
    trip, `k` = drafts proposed per active slot. Mirrors the host-side
    accounting of the verify block: a slot that ran (e >= 1) proposed k
    drafts and kept e - 1 of them."""
    ran = (e >= 1).to(torch.int32)
    mx["drafts_proposed"].add_(k * ran)
    mx["drafts_accepted"].add_((e - 1).clamp(min=0) * ran)
    _advance_(mx, e, bad, ring_mod)
