"""Continuous-batching serving engine (the port of the JAX package's
`serving/engine.py` in its contiguous-cache, single-device mode).

  * a static batch of slots with PER-SLOT ring write positions: slots at
    different depths share one batched kernel call per layer,
  * batched, padded prefill: the scheduler packs the pending prompts that
    fit into one call (per-row `lengths` mask the padding), and the primed
    caches are copied into the admitted slots. With `prefill_chunk`, the
    padded batch walks the prompt in lockstep chunks (`model.prefill_chunk`)
    so attention scores stay (chunk, ring + chunk) whatever the prompt
    length; each chunk carries every row's last-real-token logits,
  * block decode: `scan_steps` decode steps per host sync. Tokens, the
    active/budget/poisoned flags and the caches stay on the device through
    a block (caches updated in place); the host reads the block's tokens
    once at its end,
  * speculative decoding (`speculative=k`): each verify step proposes k
    tokens per slot with the n-gram drafter, runs them and the pending
    token through one T = k+1 `decode_step` on a ring with k lookahead
    rows, keeps the longest verified prefix plus the model's next token,
    and rolls every ring pointer back over the rejected rows. Greedy rows
    give exactly the sequential engine's tokens. An acceptance ladder
    (`spec_min_acceptance`) turns speculation off when drafts stop landing
    and probes to turn it back on,
  * per-slot temperature / top-k sampling, and the `finite_rows` guard:
    a slot whose logits go non-finite is quarantined (status "poisoned"),
    every other slot untouched.

Blocks stop at the earliest slot completion, so the generator advances in
the same order whatever `scan_steps` is and block decode is token-for-token
stepwise decode.

Options of the JAX engine that this port does not have yet (the paged
layout and prefix sharing, meshes, fault plans, device metrics) raise
NotImplementedError at construction; none is ignored.
"""
from __future__ import annotations

import collections
import dataclasses
import time
from typing import Deque, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import model as Mod
from repro_torch.core.types import ModelConfig
from repro_torch.serving import sampling
from repro_torch.serving.drafter import NGramDrafter, get_drafter
from repro_torch.serving.scheduler import (PrefillPlan, Scheduler,
                                           normalize_prompt)

# Result statuses ported so far (the JAX engine's taxonomy also has
# "deadline" and "failed", which belong to the resilience slice):
#   ok        full budget served (or prompt-only request)
#   rejected  never admitted: malformed / oversized / out-of-vocab prompt
#   poisoned  quarantined mid-decode: non-finite logits in the slot's row;
#             tokens holds everything emitted BEFORE the poison
STATUSES = ("ok", "rejected", "poisoned")


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray           # any int spelling; normalized to (L,) int32
    max_new_tokens: int = 32
    temperature: float = 0.0

    def __post_init__(self):
        # a ragged prompt that cannot normalize is kept as-is: the
        # scheduler rejects it per request instead of raising here
        try:
            self.prompt = normalize_prompt(self.prompt)
        except (ValueError, TypeError):
            pass


@dataclasses.dataclass
class Result:
    rid: int
    tokens: List[int]
    status: str = "ok"           # one of STATUSES
    reason: str = ""             # detail for status != ok

    @property
    def ok(self) -> bool:
        return self.status == "ok"


def _refuse(name: str, value, default) -> None:
    if value != default:
        raise NotImplementedError(
            f"ServingEngine({name}={value!r}) is not ported yet")


class ServingEngine:
    def __init__(self, cfg: ModelConfig, params, *, batch_slots: int = 8,
                 max_len: int = 4096, seed: int = 0, scan_steps: int = 8,
                 batch_prefill: bool = True, prefill_chunk: int = 0,
                 max_prefill_tokens: int = 8192, pad_to: int = 16,
                 top_k: int = 0, tokens_per_step: int = 1,
                 speculative: int = 0, draft: Optional[NGramDrafter] = None,
                 max_prompt_len: Optional[int] = None,
                 spec_min_acceptance: float = 0.0,
                 spec_acceptance_window: int = 4,
                 spec_retry_blocks: int = 8,
                 spec_resume_acceptance: Optional[float] = None,
                 kv_layout: str = "contiguous", mesh=None, faults=None,
                 metrics: bool = False):
        """Runs on the device that holds `params` (see `model.init_model` /
        `interop.params_from_jax`): the CUDA kernels on a card, their plain
        versions for CPU params. scan_steps: decode steps per host sync;
        batch_prefill=False admits one prompt per prefill call;
        max_prompt_len: reject longer prompts (status "rejected").

        prefill_chunk: sequence-axis prefill chunk (0 = single-shot); set to
        0 for configs `model.prefill_chunkable` refuses. A batch no longer
        than one chunk prefills single-shot.

        tokens_per_step: ring lookahead for multi-token decode steps: the
        caches carry T-1 extra ring rows. Tokens are unchanged (the
        positional window mask hides the extra depth).

        speculative: draft tokens per verify step (0 = sequential decode),
        proposed by `draft` (default: NGramDrafter). Raises tokens_per_step
        to at least speculative+1, the lookahead rows the rollback needs.
        Acceptance counts accumulate in `stats` / `acceptance_rate`.

        spec_min_acceptance: when the draft acceptance rate over the last
        `spec_acceptance_window` speculative blocks falls below it, decode
        sequentially (same greedy tokens); after `spec_retry_blocks`
        sequential blocks, probe one speculative block and resume if its
        rate reaches `spec_resume_acceptance` (default: the same
        threshold). 0.0 (default) disables the ladder.

        kv_layout / mesh / faults / metrics exist so that a caller porting a
        JAX engine call gets an error, not a silently different engine: any
        value other than the default raises NotImplementedError."""
        _refuse("kv_layout", kv_layout, "contiguous")
        _refuse("mesh", mesh, None)
        _refuse("faults", faults, None)
        _refuse("metrics", metrics, False)
        self.speculative = max(0, speculative)
        if self.speculative and not Mod.speculative_supported(cfg):
            raise ValueError(
                f"{cfg.name}: speculative decoding needs rotary positions "
                "and attention-only layers (no mamba or encoder-decoder "
                "state to roll back)")
        if cfg.encoder_decoder:
            raise NotImplementedError(
                f"{cfg.name}: the engine serves decoder-only models, as the "
                "JAX engine does; drive encoder-decoder models through "
                "model.prefill / model.decode_step")
        self.cfg = cfg
        self.params = params
        self.device = params["embed"].device
        self.slots = batch_slots
        self.max_len = max_len
        self.scan_steps = max(1, scan_steps)
        self.batch_prefill = batch_prefill
        self.prefill_chunk = (prefill_chunk if Mod.prefill_chunkable(cfg)
                              else 0)
        self.top_k = top_k
        self.tokens_per_step = max(1, tokens_per_step, self.speculative + 1)
        self.lookahead = self.tokens_per_step - 1
        self.drafter = get_drafter(draft) if self.speculative else None
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self.scheduler = Scheduler(
            max_prefill_tokens=max_prefill_tokens, pad_to=pad_to,
            max_prompt_len=max_prompt_len, vocab_size=cfg.vocab_size)
        self.caches = Mod.init_caches(cfg, batch_slots, max_len,
                                      lookahead=self.lookahead,
                                      device=self.device)
        self.slot_free = [True] * batch_slots
        self.slot_req: List[Optional[Request]] = [None] * batch_slots
        self.slot_out: List[List[int]] = [[] for _ in range(batch_slots)]
        self.slot_last = np.zeros((batch_slots,), np.int32)
        self.slot_budget = np.zeros((batch_slots,), np.int32)
        self.slot_temp = np.zeros((batch_slots,), np.float32)
        if self.drafter is not None:
            # drafter history: device-resident, rows written at admission
            self.slot_hist, self.slot_hcnt = self.drafter.init_state(
                batch_slots, self.device)
        self.spec_min_acceptance = float(spec_min_acceptance)
        self.spec_resume_acceptance = float(
            spec_min_acceptance if spec_resume_acceptance is None
            else spec_resume_acceptance)
        self.spec_retry_blocks = spec_retry_blocks
        self._acc_window: Deque[Tuple[int, int]] = collections.deque(
            maxlen=max(1, spec_acceptance_window))
        self._spec_off = False            # acceptance-ladder state
        self._blocks_since_spec = 0
        self._hist_stale = False          # drafter history behind slot_out
        # device-staged copies of the per-slot decode vectors; None means
        # stale (every admission), rebuilt from the host mirrors
        self._dev: Optional[Dict[str, torch.Tensor]] = None
        self._completed: List[Result] = []
        # host-clock time of the work that ends in a host sync: a prefill
        # batch ends with its first sampled tokens, a decode block with its
        # token read-back. decode_steps counts executed steps of either
        # kind; spec_steps the verify steps among them, draft_proposed /
        # draft_accepted the drafts offered and kept
        self.stats = {"tokens_emitted": 0, "tokens_delivered": 0,
                      "quarantined": 0, "rejected": 0,
                      "prefill_tokens_computed": 0, "prefill_batches": 0,
                      "prefill_s": 0.0, "decode_steps": 0, "decode_s": 0.0,
                      "spec_steps": 0, "draft_proposed": 0,
                      "draft_accepted": 0, "spec_autodisable": 0,
                      "spec_resume": 0}

    @property
    def acceptance_rate(self) -> float:
        """Fraction of proposed draft tokens the verifier kept."""
        p = self.stats["draft_proposed"]
        return self.stats["draft_accepted"] / p if p else 0.0

    # ---------------------------------------------------------- results --
    def _finish(self, rid: int, tokens: List[int], status: str,
                reason: str = "") -> Result:
        res = Result(rid, tokens, status=status, reason=reason)
        self._completed.append(res)
        self.stats["tokens_delivered"] += len(tokens)
        if status == "poisoned":
            self.stats["quarantined"] += 1
        elif status == "rejected":
            self.stats["rejected"] += 1
        return res

    def take_completed(self) -> List[Result]:
        """Drain finished Results (rid order)."""
        out, self._completed = self._completed, []
        return sorted(out, key=lambda r: r.rid)

    def _drain_rejections(self):
        for req, reason in self.scheduler.take_rejected():
            self._finish(req.rid, [], "rejected", reason)

    def _free_slot(self, s: int):
        self.slot_free[s] = True
        self.slot_req[s] = None
        self.slot_budget[s] = 0

    # ---------------------------------------------------------- prefill --
    def _prefill_into(self, plan: PrefillPlan, slots: List[int]):
        with torch.profiler.record_function("engine.prefill"):
            self._prefill_batch(plan, slots)

    @torch.no_grad()
    def prefill_logits(self, tokens: torch.Tensor, lengths: torch.Tensor):
        """Prefill a padded batch (n, L) into fresh caches: single-shot, or
        in `prefill_chunk` lockstep chunks when the batch is longer than
        one. Returns (each row's last-real-token logits (n, V) fp32, the
        caches). A chunk unembeds only the (n, 1, D) rows whose last real
        token it holds."""
        n, l_pad = tokens.shape
        c = self.prefill_chunk
        if not c or l_pad <= c:
            logits, caches = Mod.prefill(self.params, self.cfg,
                                         {"tokens": tokens}, self.max_len,
                                         lengths=lengths,
                                         lookahead=self.lookahead)
            return logits[:, 0], caches
        caches = Mod.init_caches(self.cfg, n, self.max_len,
                                 lookahead=self.lookahead, device=self.device)
        last = torch.zeros((n, self.cfg.vocab_size), dtype=torch.float32,
                           device=self.device)
        rows = torch.arange(n, device=self.device)
        for p in range(0, l_pad, c):
            x = Mod.prefill_chunk(self.params, self.cfg,
                                  {"tokens": tokens[:, p:p + c]}, caches, p,
                                  lengths, lookahead=self.lookahead)
            t = x.shape[1]
            tpos = lengths.long() - 1 - p
            hit = (tpos >= 0) & (tpos < t)
            xsel = x[rows, tpos.clamp(0, t - 1)][:, None]
            sel = Mod._unembed(self.params, self.cfg, xsel)[:, 0]
            last = torch.where(hit[:, None], sel, last)
        return last, caches

    @torch.no_grad()
    def _prefill_batch(self, plan: PrefillPlan, slots: List[int]):
        t0 = time.perf_counter()
        dev = self.device
        tokens = torch.as_tensor(plan.tokens, device=dev)
        lengths = torch.as_tensor(plan.lengths, device=dev)
        logits, caches = self.prefill_logits(tokens, lengths)
        temps = torch.as_tensor([r.temperature for r in plan.requests],
                                dtype=torch.float32, device=dev)
        first = sampling.sample(self.generator, logits, temps, self.top_k)
        idx = torch.as_tensor(slots, dtype=torch.long, device=dev)
        for full, one in zip(self.caches, caches):
            for name, layer in full.items():
                for leaf, t in layer.items():
                    t.index_copy_(0, idx, one[name][leaf].to(t.dtype))
        first = first.cpu().numpy()            # the batch's host sync
        self.stats["prefill_s"] += time.perf_counter() - t0
        self.stats["prefill_batches"] += 1
        self.stats["prefill_tokens_computed"] += int(plan.lengths.sum())
        if self.drafter is not None:
            # drafter context: the prompt plus the first sampled token (the
            # history ends at slot_last, the pending token)
            self._seed_history(slots, [np.concatenate([r.prompt, [f]])
                                       for r, f in zip(plan.requests, first)])
        for i, (req, s) in enumerate(zip(plan.requests, slots)):
            self.slot_out[s] = [int(first[i])]
            self.slot_last[s] = int(first[i])
            self.slot_temp[s] = req.temperature
            budget = req.max_new_tokens - 1
            if budget <= 0:
                self._finish(req.rid, self.slot_out[s], "ok")
                self._free_slot(s)
            else:
                self.slot_free[s] = False
                self.slot_req[s] = req
                self.slot_budget[s] = budget
        self._dev = None          # host mirrors changed; restage on device

    def _seed_history(self, slots: List[int], seqs) -> None:
        """Write the drafter history rows of `slots` from host token
        sequences (one host-to-device copy)."""
        rows, cnts = zip(*(self.drafter.seed_row(q) for q in seqs))
        idx = torch.as_tensor(slots, dtype=torch.long, device=self.device)
        self.slot_hist[idx] = torch.as_tensor(np.stack(rows),
                                              device=self.device)
        self.slot_hcnt[idx] = torch.as_tensor(np.asarray(cnts, np.int32),
                                              device=self.device)

    def _admit(self, pending: Deque[Request]):
        while pending:
            free = [s for s in range(self.slots) if self.slot_free[s]]
            if not free:
                break
            width = len(free) if self.batch_prefill else 1
            plan = self.scheduler.plan(pending, width)
            if plan is None:
                break
            self._prefill_into(plan, free[:len(plan.requests)])
        self._drain_rejections()

    # ----------------------------------------------------------- decode --
    def _spec_mode(self) -> Tuple[bool, bool]:
        """(run this block speculatively?, is it a probe?) under the
        acceptance ladder. A disabled engine decodes sequentially and
        probes one speculative block every `spec_retry_blocks` blocks."""
        if not self.speculative:
            return False, False
        if not self._spec_off:
            return True, False
        self._blocks_since_spec += 1
        if self.spec_retry_blocks and \
                self._blocks_since_spec >= self.spec_retry_blocks:
            return True, True
        return False, False

    def _spec_ladder_update(self, prop: int, acc: int, probe: bool):
        """Feed one speculative block's acceptance into the ladder."""
        if self.spec_min_acceptance <= 0:
            return
        if probe:
            rate = acc / prop if prop else 0.0
            if rate >= self.spec_resume_acceptance:
                self._spec_off = False
                self.stats["spec_resume"] += 1
                self._acc_window.clear()
            else:
                self._blocks_since_spec = 0    # stay off; probe again later
            return
        self._acc_window.append((prop, acc))
        wp = sum(p for p, _ in self._acc_window)
        wa = sum(a for _, a in self._acc_window)
        if wp >= 2 * self.speculative and wa / wp < self.spec_min_acceptance:
            self._spec_off = True
            self._blocks_since_spec = 0
            self._acc_window.clear()
            self.stats["spec_autodisable"] += 1

    def _reseed_history(self, live: List[int]):
        """Sequential blocks emit tokens the drafter never observed:
        rebuild each live slot's history (prompt + full output) before the
        next speculative block."""
        self._seed_history(live, [np.concatenate([self.slot_req[s].prompt,
                                                  self.slot_out[s]])
                                  for s in live])
        self._hist_stale = False

    def _decode_block(self, n: int) -> List[Result]:
        """Run n decode steps on the device (one host sync), then retire
        finished and quarantined slots; a speculative engine runs up to n
        verify steps instead, each emitting 1..speculative+1 tokens a slot.
        The block runs inside a profiler range named "engine.decode_block"
        ("engine.prefill" for admission): free when no profiler is
        active."""
        live = [s for s in range(self.slots) if not self.slot_free[s]]
        if not live:
            return []
        use_spec, probe = self._spec_mode()
        if use_spec and self._hist_stale:
            self._reseed_history(live)
        with torch.profiler.record_function("engine.decode_block"):
            if use_spec:
                return self._verify_steps(n, live, probe)
            if self.speculative:
                self._hist_stale = True     # drafter history lags output
            return self._decode_steps(n, live)

    def _stage(self) -> Dict[str, torch.Tensor]:
        """The per-slot decode vectors on the device, restaged from the
        host mirrors after an admission and reused verbatim between
        blocks."""
        if self._dev is None:
            dev = self.device
            active = np.asarray([not f for f in self.slot_free], bool)
            self._dev = dict(
                tok=torch.as_tensor(self.slot_last, device=dev),
                active=torch.as_tensor(active, device=dev),
                budget=torch.as_tensor(self.slot_budget, device=dev),
                temps=torch.as_tensor(self.slot_temp, device=dev),
                poisoned=torch.zeros((self.slots,), dtype=torch.bool,
                                     device=dev))
        return self._dev

    @torch.no_grad()
    def _decode_steps(self, n: int, live: List[int]) -> List[Result]:
        t0 = time.perf_counter()
        dev = self.device
        d = self._stage()
        tok, active, budget, poisoned = (d["tok"], d["active"], d["budget"],
                                         d["poisoned"])
        toks = torch.empty((n, self.slots), dtype=torch.int32, device=dev)
        emit = torch.empty((n, self.slots), dtype=torch.bool, device=dev)
        for i in range(n):
            logits, _ = Mod.decode_step(self.params, self.cfg,
                                        {"tokens": tok[:, None]},
                                        self.caches,
                                        lookahead=self.lookahead)
            lg = logits[:, 0]
            nxt = sampling.sample(self.generator, lg, d["temps"], self.top_k)
            # numerical guard: a non-finite row is QUARANTINED — not
            # emitted, budget untouched, slot deactivated
            bad = active & ~sampling.finite_rows(lg)
            ok = active & ~bad
            nxt = torch.where(ok, nxt, tok)
            budget = budget - ok.to(torch.int32)
            poisoned = poisoned | bad
            active = ok & (budget > 0)
            toks[i] = nxt
            emit[i] = ok
            tok = nxt
        d.update(tok=tok, active=active, budget=budget, poisoned=poisoned)
        return self._retire(live, n, toks, emit, t0)[0]

    @torch.no_grad()
    def _verify_steps(self, n: int, live: List[int],
                      probe: bool) -> List[Result]:
        """Up to n draft/verify/accept steps. Each feeds (B, T = k+1) tokens,
        the slot's pending token and k drafts, through one `decode_step`
        on the k-row lookahead ring, then:

          accept   logits[:, j] is the model's next-token choice given
                   x[:, :j+1], so draft x[:, j+1] is kept iff it equals
                   ver[:, j]; acc is the all-match prefix and the slot emits
                   e = min(acc+1, budget) tokens (acc drafts and the model's
                   token after them). A slot about to consume a non-finite
                   position emits the clean prefix before it and is
                   quarantined; an inactive slot takes e = 0.
          rollback the step advanced every ring `step` by T; step -= T - e
                   keeps exactly the rows a sequential engine would hold.
                   The T - e rejected rows are dead: the lookahead rows mean
                   no in-window token was evicted, and the next step's
                   insert starts at step and overwrites them before any
                   read.

        Like the JAX engine's while_loop, the block ends as soon as any
        slot's `active` flips, so a freed slot refills at once and
        `spec_steps` counts as in JAX. That test is one host read of one
        bool per verify step, the only host sync inside the block."""
        t0 = time.perf_counter()
        dev = self.device
        d = self._stage()
        k = self.speculative
        t = k + 1
        tok, active, budget, poisoned = (d["tok"], d["active"], d["budget"],
                                         d["poisoned"])
        hist, hcnt = self.slot_hist, self.slot_hcnt
        temps = d["temps"].repeat_interleave(t)
        pos = torch.arange(t, device=dev)
        toks = torch.zeros((n, self.slots, t), dtype=torch.int32, device=dev)
        emit = torch.zeros((n, self.slots, t), dtype=torch.bool, device=dev)
        active0 = active
        steps = 0
        while steps < n:
            drafts = self.drafter.sanitize(
                self.drafter.propose(hist, hcnt, k), self.cfg.vocab_size)
            x = torch.cat([tok[:, None], drafts], dim=1)
            logits, _ = Mod.decode_step(self.params, self.cfg,
                                        {"tokens": x}, self.caches,
                                        lookahead=self.lookahead)
            # every verify position in one sampling call
            ver = sampling.sample(
                self.generator, logits.reshape(self.slots * t, -1), temps,
                self.top_k).reshape(self.slots, t)
            finpos = torch.isfinite(logits).all(dim=-1)          # (B, T)
            first_bad = torch.where(
                finpos.all(dim=1), t,
                finpos.to(torch.int32).argmin(dim=1)).to(torch.int32)
            match = (drafts == ver[:, :k]).to(torch.int32)
            acc = match.cumprod(dim=1).sum(dim=1, dtype=torch.int32)
            e_clean = torch.minimum(acc + 1, budget)
            bad = active & (first_bad < e_clean)
            ok = active & ~bad
            e = torch.where(active, torch.where(bad, first_bad, e_clean),
                            0).to(torch.int32)
            back = t - e
            for blk in self.caches:
                for layer in blk.values():
                    layer["step"] = layer["step"] - back
            newlast = ver.gather(1, (e - 1).clamp(min=0).long()[:, None])[:, 0]
            tok = torch.where(ok, newlast, tok)
            hist, hcnt = self.drafter.observe(hist, hcnt, ver, e)
            toks[steps] = ver
            emit[steps] = pos[None, :] < e[:, None]
            budget = budget - e
            poisoned = poisoned | bad
            active = ok & (budget > 0)
            steps += 1
            if not torch.equal(active, active0):     # one host read
                break
        self.slot_hist, self.slot_hcnt = hist, hcnt
        d.update(tok=tok, active=active, budget=budget, poisoned=poisoned)
        done, emit_np = self._retire(live, steps, toks, emit, t0)
        counts = emit_np.sum(axis=-1)                          # (n, slots)
        ran = counts >= 1
        prop = k * int(ran.sum())
        accepted = int((counts[ran] - 1).sum())
        self.stats["spec_steps"] += steps
        self.stats["draft_proposed"] += prop
        self.stats["draft_accepted"] += accepted
        self._spec_ladder_update(prop, accepted, probe)
        return done

    def _retire(self, live: List[int], steps: int, toks: torch.Tensor,
                emit: torch.Tensor, t0: float
                ) -> Tuple[List[Result], np.ndarray]:
        """The block's one host sync: read its tokens and flags back, then
        extend each live slot's output (chronologically: row-major over
        step and verify position) and retire finished and quarantined
        slots. Returns (the retired slots' Results, the emit flags)."""
        d = self._dev
        toks_np = toks.cpu().numpy()
        emit_np = emit.cpu().numpy()
        self.slot_last = d["tok"].cpu().numpy().astype(np.int32)
        self.slot_budget = d["budget"].cpu().numpy().astype(np.int32)
        poisoned_np = d["poisoned"].cpu().numpy()
        self.stats["decode_s"] += time.perf_counter() - t0
        self.stats["decode_steps"] += steps
        self.stats["tokens_emitted"] += int(emit_np.sum())
        done: List[Result] = []
        for s in live:
            self.slot_out[s].extend(
                int(x) for x in toks_np[:, s][emit_np[:, s]])
            if poisoned_np[s]:
                done.append(self._finish(
                    self.slot_req[s].rid, self.slot_out[s], "poisoned",
                    "non-finite logits; slot quarantined"))
                self._free_slot(s)
            elif self.slot_budget[s] <= 0:
                done.append(self._finish(
                    self.slot_req[s].rid, self.slot_out[s], "ok"))
                self._free_slot(s)
        return done, emit_np

    def step(self) -> List[Result]:
        """One decode (or verify) step for every live slot."""
        return self._decode_block(1)

    def _block_len(self) -> int:
        """Largest block that can't overshoot any live slot: stop at the
        earliest completion so slots free (and refill) at block boundaries
        and the random stream is the same for every scan_steps setting.
        Speculative blocks take the same floor: a verify step emits 1..T
        tokens, so b steps always suffice, and the budget clamp and the
        early exit make any length safe; sizing by ceil(b/T) would assume
        full acceptance and collapse blocks near a slot's end to one step,
        a host round trip each."""
        live_budgets = [int(self.slot_budget[s]) for s in range(self.slots)
                        if not self.slot_free[s]]
        if not live_budgets:
            return 0
        return max(1, min(self.scan_steps, min(live_budgets)))

    # -------------------------------------------------------------- run --
    def run(self, requests: List[Request]) -> List[Result]:
        """Serve a batch to completion; one Result per request, rid order.
        Finished requests land in `self._completed` as they finalize, so
        after an exception `take_completed()` recovers them."""
        pending: Deque[Request] = collections.deque(requests)
        try:
            while pending or not all(self.slot_free):
                self._admit(pending)
                n = self._block_len()
                if n:
                    self._decode_block(n)
        finally:
            self._drain_rejections()
        return self.take_completed()


def ring_cache_bytes(cfg: ModelConfig, batch: int, context: int) -> int:
    """Decode-cache bytes at the model dtype: PHYSICAL ring rows
    (`cache_allocation`) for every attention layer."""
    from repro_torch.core.layers import cache_allocation
    itemsize = 2 if cfg.dtype == "bfloat16" else 4
    total = 0
    for i, kind in enumerate(cfg.layer_pattern):
        acfg = Mod.attn_cfg(cfg, kind, index=i)
        cap = cache_allocation(acfg, context)
        total += 2 * batch * acfg.num_kv_heads * cap * acfg.head_dim * itemsize
    return total * cfg.num_super_blocks
