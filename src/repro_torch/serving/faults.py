"""Deterministic fault injection for the serving engine (the port of the
JAX package's `serving/faults.py`; host-only Python, no tensor is touched).

A `FaultPlan` says ahead of time, in static terms, which slots are
poisoned when, so a chaos run is a program that repeats bitwise:

  * numerical poison (`poison_logits`, `poison_cache`): NaN or +Inf put
    into a chosen slot's logits at a chosen token index (inside the decode
    and verify bodies, as a countdown vector and one masked `where`, so
    the injected bodies differ from production only by that select and
    healthy slots stay bitwise), or NaN written over a slot's K cache
    between blocks (corruption the guard did not see born).
  * kernel failure (`fail_pallas_dispatch`): the fused decode kernel's
    wrapper raises `KernelDispatchError` at entry, and the engine steps
    down to the plain version (its `_kernel_fallback`).
  * drafter corruption (`corrupt_draft_slots`): a slot's drafts are
    replaced by out-of-vocabulary ids, which `drafter.sanitize` must clip
    so that verification rejects them.

`FaultPlan()` (or no plan) gives an engine exactly the production bodies.
The degradation events go on the one telemetry bus
(`repro_torch.telemetry.events`), re-exported here as in the JAX package.
"""
from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np

from repro_torch.telemetry.events import (consume_events,  # noqa: F401
                                          peek_events, record_event)

NAN, INF = "nan", "inf"

# never-fires countdown value: the trigger is `fin == 0` (a verify step:
# `0 <= fin < T`) and fin only decreases, so a negative stage never fires
NO_FAULT = np.int32(-(2 ** 30))


class KernelDispatchError(RuntimeError):
    """A kernel dispatch failure (the injected one): the engine catches it
    and steps down to the plain decode version."""


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """Static description of the faults to inject into one engine.

    poison_logits: ((slot, token_idx, "nan"|"inf"), ...): replace the
        slot's whole logits row with the value at the decode step that
        would emit token number `token_idx` of the slot (0-based over its
        output, so index 0 is the prefill-sampled token and never fires).
        A verify step poisons the one window position that token lands on.
    poison_cache: ((slot, token_idx), ...): write NaN over the slot's K
        caches once it has emitted `token_idx` tokens (between blocks; the
        next step's attention carries it into the logits, where the guard
        quarantines the slot).
    corrupt_draft_slots: slots whose drafts are replaced by out-of-vocab
        ids inside the verify body.
    fail_pallas_dispatch: arm the fused decode kernel's wrapper to raise
        `KernelDispatchError` (at engine construction; a module-global
        flag: call `clear_kernel_failure()` when done).
    """
    poison_logits: Tuple[Tuple[int, int, str], ...] = ()
    poison_cache: Tuple[Tuple[int, int], ...] = ()
    corrupt_draft_slots: Tuple[int, ...] = ()
    fail_pallas_dispatch: bool = False

    def __post_init__(self):
        for slot, idx, kind in self.poison_logits:
            if kind not in (NAN, INF) or slot < 0 or idx < 0:
                raise ValueError(f"poison_logits entry {(slot, idx, kind)}: "
                                 "slot >= 0, token_idx >= 0, 'nan' or 'inf'")
        seen = [s for s, _, _ in self.poison_logits]
        if len(seen) != len(set(seen)):
            raise ValueError(
                "one poison_logits entry per slot (the countdown vector "
                f"holds one trigger a slot): {self.poison_logits}")

    @property
    def any(self) -> bool:
        return bool(self.poison_logits or self.poison_cache
                    or self.corrupt_draft_slots or self.fail_pallas_dispatch)

    @property
    def has_logit_faults(self) -> bool:
        """Whether the decode and verify bodies carry injection code (the
        countdown vector and one masked select)."""
        return bool(self.poison_logits)

    # ------------------------------------------------------------ staging --
    def inf_mask(self, slots: int) -> np.ndarray:
        """(slots,) bool: True where the poison value is +Inf (else NaN)."""
        m = np.zeros((slots,), bool)
        for slot, _, kind in self.poison_logits:
            if slot < slots and kind == INF:
                m[slot] = True
        return m

    def draft_mask(self, slots: int) -> np.ndarray:
        """(slots,) bool: the slots whose drafts are corrupted."""
        m = np.zeros((slots,), bool)
        for slot in self.corrupt_draft_slots:
            if slot < slots:
                m[slot] = True
        return m

    def logit_countdown(self, slots: int, tokens_done,
                        fired=()) -> np.ndarray:
        """(slots,) int32 countdown staged before a block: `token_idx -
        tokens_done[slot]`, NO_FAULT where the slot has no pending
        trigger. The bodies decrement it by each step's emitted count and
        fire where it reaches zero. `fired`: slots whose fault went off; an
        entry targets the slot's first occupant only, so a request
        admitted into the quarantined slot afterwards decodes clean."""
        fin = np.full((slots,), NO_FAULT, np.int32)
        for slot, idx, _ in self.poison_logits:
            if slot < slots and slot not in fired:
                rem = idx - int(tokens_done[slot])
                fin[slot] = rem if rem > 0 else NO_FAULT
        return fin

    def cache_poisons_due(self, slots: int, tokens_done, applied) -> list:
        """Slots whose K caches are due for poisoning: emitted at least
        `token_idx` tokens and not in `applied` yet."""
        return [s for s, idx in self.poison_cache
                if s < slots and s not in applied
                and int(tokens_done[s]) >= idx]


# ------------------------------------------------- simulated kernel fault --

def install_kernel_failure() -> None:
    """Arm the fused decode kernel's wrapper to raise `KernelDispatchError`
    at its next call. Module-global (every engine in the process): pair it
    with `clear_kernel_failure()` in a finally block."""
    from repro_torch.kernels import swat_decode as K
    K.set_force_fail(True)


def clear_kernel_failure() -> None:
    from repro_torch.kernels import swat_decode as K
    K.set_force_fail(False)


# ------------------------------------------------------ malformed inputs --

def malformed_prompts(vocab_size: int, *, oversize: int = 0,
                      seed: int = 0) -> List[Tuple[np.ndarray, str]]:
    """Adversarial prompts with the word each rejection reason holds: the
    scheduler must reject each per request, never raise. `oversize` > 0
    adds a prompt longer than that bound (the engine's `max_prompt_len`)."""
    rng = np.random.RandomState(seed)
    out: List[Tuple[np.ndarray, str]] = [
        (np.zeros((0,), np.int32), "empty"),
        (np.zeros((3, 0), np.int32), "empty"),
        (np.asarray([1, vocab_size + 7, 2], np.int32), "token id"),
        (np.asarray([-4, 1, 2], np.int32), "token id"),
    ]
    if oversize:
        out.append((rng.randint(0, vocab_size, (oversize + 1,))
                    .astype(np.int32), "longer than"))
    return out
