"""Admission scheduling for the continuous-batching engine (host-only copy
of the JAX package's `serving/scheduler.py`).

The scheduler turns the pending FCFS queue into one padded, batched prefill
call: take as many waiting prompts as there are free slots, right-pad them
to a shared bucketed length, and stop early if the padded token count would
blow the prefill budget (prefill score memory scales with padded tokens).
Bucketing pad lengths to `pad_to` multiples keeps the number of distinct
prefill shapes small.

`slot_quantum` keeps batch row counts divisible by a slot-axis size when
more than one quantum of prompts is available (the JAX engine passes its
mesh's slot-axis size; the port is single-device and passes 1).
"""
from __future__ import annotations

import dataclasses
from typing import Deque, List, Optional, Sequence, Tuple

import numpy as np


def normalize_prompt(prompt) -> np.ndarray:
    """Flatten any prompt spelling — list, list-of-lists, (L,), (1, L) —
    to the 1-D int32 the whole serving stack assumes. Measuring a (1, L)
    prompt with len() used to report 1 and mis-size the padded batch."""
    return np.asarray(prompt, np.int32).reshape(-1)


@dataclasses.dataclass
class PrefillPlan:
    """One batched prefill: `tokens` (n, L_pad) right-padded int32 prompts
    for `requests`, with per-row real `lengths` (n,). `prefix_len` is the
    longest token prefix shared by EVERY row (radix-trie LCP, 0 for
    single-row plans) — a paged engine with prefix sharing enabled prefills
    those tokens once and block-shares the untouched prefix pages."""
    requests: List
    tokens: np.ndarray
    lengths: np.ndarray
    prefix_len: int = 0


def batch_lcp(prompts: Sequence[np.ndarray]) -> int:
    """Longest token prefix shared by EVERY prompt (0 for fewer than two)."""
    if len(prompts) < 2:
        return 0
    lcp = len(prompts[0])
    for p in prompts[1:]:
        n = min(lcp, len(p))
        diff = np.nonzero(prompts[0][:n] != p[:n])[0]
        lcp = int(diff[0]) if diff.size else n
        if lcp == 0:
            break
    return lcp


class Scheduler:
    def __init__(self, *, max_prefill_tokens: int = 8192, pad_to: int = 16,
                 slot_quantum: int = 1, max_prompt_len: Optional[int] = None,
                 vocab_size: Optional[int] = None):
        """max_prompt_len / vocab_size: optional admission validation
        bounds. A request that violates one is REJECTED — popped off the
        queue into `take_rejected()` with a reason, never raised: one
        malformed request used to ValueError out of `plan` and kill the
        whole engine loop, losing every in-flight slot. max_prompt_len=None
        keeps long prompts admissible (the ring prefill serves them exactly
        — only the last window survives, as it should); set it when the
        deployment wants oversized prompts refused instead."""
        assert pad_to >= 1 and max_prefill_tokens >= pad_to
        assert slot_quantum >= 1
        self.max_prefill_tokens = max_prefill_tokens
        self.pad_to = pad_to
        self.slot_quantum = slot_quantum
        self.max_prompt_len = max_prompt_len
        self.vocab_size = vocab_size
        self._rejected: List[Tuple[object, str]] = []

    def _bucket(self, n: int) -> int:
        return -(-max(n, 1) // self.pad_to) * self.pad_to

    def _reject_reason(self, req) -> Optional[str]:
        """Why this request must not be admitted (None = admissible)."""
        try:
            head = normalize_prompt(req.prompt)
        except (ValueError, TypeError) as e:
            return f"malformed prompt: {e}"
        if head.size == 0:
            return ("empty prompt — a completion conditioned on nothing "
                    "would be silently garbage")
        if self.max_prompt_len is not None and head.size > self.max_prompt_len:
            return (f"prompt length {head.size} longer than "
                    f"max_prompt_len={self.max_prompt_len}")
        if self.vocab_size is not None and head.size:
            lo, hi = int(head.min()), int(head.max())
            if lo < 0 or hi >= self.vocab_size:
                return (f"token id out of range: [{lo}, {hi}] vs vocab "
                        f"size {self.vocab_size}")
        return None

    def take_rejected(self) -> List[Tuple[object, str]]:
        """Drain (request, reason) pairs rejected by `plan` since the last
        drain — the engine finalizes them as status='rejected' Results."""
        out, self._rejected = self._rejected, []
        return out

    def plan(self, pending: Deque, num_free: int) -> Optional[PrefillPlan]:
        """Pop FCFS prompts into one padded batch. Always admits at least
        one request when a slot is free; beyond that the padded token total
        stays under max_prefill_tokens and (when possible) the row count is
        a slot_quantum multiple so the prefill shards over the slot axis.
        Inadmissible requests (empty / oversized / out-of-vocab prompts)
        are popped into `take_rejected()` and never poison the batch."""
        if not pending or num_free <= 0:
            return None
        take: List = []
        flat: List[np.ndarray] = []
        longest = 0
        while pending and len(take) < num_free:
            reason = self._reject_reason(pending[0])
            if reason is not None:
                self._rejected.append((pending.popleft(), reason))
                continue
            head = normalize_prompt(pending[0].prompt)
            cand = max(longest, head.size)
            if take and self._bucket(cand) * (len(take) + 1) \
                    > self.max_prefill_tokens:
                break
            take.append(pending.popleft())
            flat.append(head)
            longest = cand
        if not take:          # everything pending was rejected
            return None
        q = self.slot_quantum
        if len(take) > q and len(take) % q:
            # return the sub-quantum tail to the queue head (FCFS intact):
            # a quantum-multiple batch shards; the tail rides the next batch
            keep = (len(take) // q) * q
            for req in reversed(take[keep:]):
                pending.appendleft(req)
            take, flat = take[:keep], flat[:keep]
            longest = max(p.size for p in flat)
        # prompts are NEVER truncated: the ring prefill paths handle
        # l > cache capacity exactly like the full-prompt reference (only
        # the last window+globals survive in the cache, as they should)
        l_pad = self._bucket(longest)
        tokens = np.zeros((len(take), l_pad), np.int32)
        lengths = np.zeros((len(take),), np.int32)
        for i, p in enumerate(flat):
            tokens[i, :p.size] = p
            lengths[i] = p.size
        return PrefillPlan(requests=take, tokens=tokens, lengths=lengths,
                           prefix_len=batch_lcp(flat))
