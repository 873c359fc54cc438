"""Draft proposers for speculative decoding (the port of the JAX package's
`serving/drafter.py`).

A speculative engine step proposes k tokens per slot, verifies all k+1
positions in one `decode_step` (the T = k+1 lookahead-ring primitive), and
keeps the longest prefix of drafts that match the model's own choices.
Acceptance changes only speed: every emitted token is the model's output
for a verified prefix, so greedy speculative decode is token for token the
sequential engine.

The proposer is n-gram self-drafting (prompt-lookup decoding): each slot
keeps a rolling history of its own tokens (prompt + everything emitted);
the drafts are the tokens that followed the most recent, longest earlier
occurrence of the current context suffix.

`propose`, `sanitize` and `observe` take and return torch tensors on the
engine's device, a few gathers each (no per-position or per-n-gram launch);
the state is a right-aligned (slots, history) int32 ring. `seed_row` builds
one slot's row on the host at admission.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class NGramDrafter:
    """Self-drafting n-gram proposer.

    max_ngram: longest context suffix to match (longer matches win; ties go
        to the most recent occurrence).
    history: per-slot token history, newest token at the END of the buffer.
    """
    max_ngram: int = 3
    history: int = 64

    # ------------------------------------------------------------- state --
    def init_state(self, slots: int, device=None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(hist (slots, H) int32, count (slots,) int32), zeroed."""
        return (torch.zeros((slots, self.history), dtype=torch.int32,
                            device=device),
                torch.zeros((slots,), dtype=torch.int32, device=device))

    def seed_row(self, tokens) -> Tuple[np.ndarray, np.int32]:
        """History row for a freshly admitted slot: the prompt plus the
        prefill-sampled first token, right-aligned into the buffer."""
        h = self.history
        seq = np.asarray(tokens, np.int32).reshape(-1)[-h:]
        row = np.zeros((h,), np.int32)
        if seq.size:
            row[h - seq.size:] = seq
        return row, np.int32(seq.size)

    # ------------------------------------------------------------ propose --
    def propose(self, hist: torch.Tensor, count: torch.Tensor,
                k: int) -> torch.Tensor:
        """Draft k tokens per slot. hist: (B, H) right-aligned (newest at
        H-1, the slot's pending token); count: (B,) valid entries.

        A candidate match end p (an earlier history position) scores the
        longest n <= max_ngram with hist[p-n+1 .. p] == hist[H-n .. H-1]:
        the number of leading offsets o = 0, 1, ... at which hist[p-o]
        equals hist[H-1-o], both inside the valid history. All offsets come
        from one gather. The winner is the longest match, most recent on
        ties; drafts are the tokens that followed it. A slot with no match
        proposes its last token repeated (verification gates emission; a
        bad proposal only wastes the lookahead)."""
        b, h = hist.shape
        dev = hist.device
        idx = torch.arange(h, device=dev)
        off = torch.arange(self.max_ngram, device=dev)
        src = idx[None, :] - off[:, None]                       # (N, H)
        cand = hist[:, src.clamp(0, h - 1)]                     # (B, N, H)
        suf = hist[:, h - 1 - off]                              # (B, N)
        count = count.to(device=dev, dtype=torch.long)
        first = h - count.clamp(max=h)                          # (B,)
        eq = ((cand == suf[:, :, None])
              & (src[None] >= first[:, None, None])
              # a suffix of o+1 tokens and at least one token before it
              & (count[:, None, None] >= off[None, :, None] + 2))
        score = eq.long().cumprod(dim=1).sum(dim=1)             # (B, H)
        usable = (idx[None, :] <= h - 2) & (idx[None, :] >= first[:, None])
        score = torch.where(usable, score, 0)
        best = (score * h + idx[None, :]).argmax(dim=1)        # unique ranks
        has = score.gather(1, best[:, None])[:, 0] > 0
        gather = (best[:, None] + 1
                  + torch.arange(k, device=dev)[None, :]).clamp(0, h - 1)
        drafts = hist.gather(1, gather)
        return torch.where(has[:, None], drafts, hist[:, h - 1:h])

    # ----------------------------------------------------------- sanitize --
    @staticmethod
    def sanitize(drafts: torch.Tensor, vocab_size: int) -> torch.Tensor:
        """Clip drafts into [0, vocab): a corrupt proposal must never index
        outside the embedding; clipped garbage simply fails verification."""
        return drafts.to(torch.int32).clamp(0, vocab_size - 1)

    # ------------------------------------------------------------ observe --
    def observe(self, hist: torch.Tensor, count: torch.Tensor,
                tokens: torch.Tensor, num_emitted: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Append each slot's first num_emitted[b] of tokens (B, T) to its
        history (ragged; 0 leaves the row as it is). One gather of the
        right-aligned shift."""
        h = hist.shape[1]
        e = num_emitted.to(device=hist.device, dtype=torch.long)
        buf = torch.cat([hist, tokens.to(hist.dtype)], dim=1)
        gather = e[:, None] + torch.arange(h, device=hist.device)[None, :]
        return (buf.gather(1, gather),
                (count + e.to(count.dtype)).clamp(max=h))


def get_drafter(spec: Optional[NGramDrafter]) -> NGramDrafter:
    """The engine's `draft=` knob: None gives the default NGramDrafter, a
    drafter passes through."""
    if spec is None:
        return NGramDrafter()
    if not isinstance(spec, NGramDrafter):
        raise TypeError(f"draft={spec!r}: expected an NGramDrafter")
    return spec
