"""Continuous-batching serving engine (the port of the JAX package's
`serving/engine.py` in its sequential, contiguous-cache, single-device
mode).

  * a static batch of slots with PER-SLOT ring write positions: slots at
    different depths share one batched kernel call per layer,
  * batched, padded single-shot prefill: the scheduler packs the pending
    prompts that fit into one call (per-row `lengths` mask the padding),
    and the primed caches are copied into the admitted slots,
  * block decode: `scan_steps` decode steps per host sync. Tokens, the
    active/budget/poisoned flags and the caches stay on the device through
    a block (caches updated in place); the host reads the block's tokens
    once at its end,
  * per-slot temperature / top-k sampling, and the `finite_rows` guard:
    a slot whose logits go non-finite is quarantined (status "poisoned"),
    every other slot untouched.

Blocks stop at the earliest slot completion, so the generator advances in
the same order whatever `scan_steps` is and block decode is token-for-token
stepwise decode.

Options of the JAX engine that this port does not have yet (speculative
decoding, the paged layout, chunked prefill, meshes, fault plans, device
metrics) raise NotImplementedError at construction; none is ignored.
"""
from __future__ import annotations

import collections
import dataclasses
import time
from typing import Deque, Dict, List, Optional

import numpy as np
import torch

from repro_torch.core import model as Mod
from repro_torch.core.types import ModelConfig
from repro_torch.serving import sampling
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
                 batch_prefill: bool = True, max_prefill_tokens: int = 8192,
                 pad_to: int = 16, top_k: int = 0,
                 max_prompt_len: Optional[int] = None,
                 speculative: int = 0, kv_layout: str = "contiguous",
                 prefill_chunk: int = 0, mesh=None, faults=None,
                 metrics: bool = False):
        """Runs on the device that holds `params` (see `model.init_model` /
        `interop.params_from_jax`): the CUDA kernels on a card, their plain
        versions for CPU params. scan_steps: decode steps per host sync;
        batch_prefill=False admits one prompt per prefill call;
        max_prompt_len: reject longer prompts (status "rejected").

        speculative / kv_layout / prefill_chunk / mesh / faults / metrics
        exist so that a caller porting a JAX engine call gets an error, not
        a silently different engine: any value other than the default
        raises NotImplementedError."""
        _refuse("speculative", speculative, 0)
        _refuse("kv_layout", kv_layout, "contiguous")
        _refuse("prefill_chunk", prefill_chunk, 0)
        _refuse("mesh", mesh, None)
        _refuse("faults", faults, None)
        _refuse("metrics", metrics, False)
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
        self.top_k = top_k
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self.scheduler = Scheduler(
            max_prefill_tokens=max_prefill_tokens, pad_to=pad_to,
            max_prompt_len=max_prompt_len, vocab_size=cfg.vocab_size)
        self.caches = Mod.init_caches(cfg, batch_slots, max_len,
                                      device=self.device)
        self.slot_free = [True] * batch_slots
        self.slot_req: List[Optional[Request]] = [None] * batch_slots
        self.slot_out: List[List[int]] = [[] for _ in range(batch_slots)]
        self.slot_last = np.zeros((batch_slots,), np.int32)
        self.slot_budget = np.zeros((batch_slots,), np.int32)
        self.slot_temp = np.zeros((batch_slots,), np.float32)
        # device-staged copies of the per-slot decode vectors; None means
        # stale (every admission), rebuilt from the host mirrors
        self._dev: Optional[Dict[str, torch.Tensor]] = None
        self._completed: List[Result] = []
        # host-clock time of the work that ends in a host sync: a prefill
        # batch ends with its first sampled tokens, a decode block with its
        # token read-back
        self.stats = {"tokens_emitted": 0, "tokens_delivered": 0,
                      "quarantined": 0, "rejected": 0,
                      "prefill_tokens_computed": 0, "prefill_batches": 0,
                      "prefill_s": 0.0, "decode_steps": 0, "decode_s": 0.0}

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
    def _prefill_batch(self, plan: PrefillPlan, slots: List[int]):
        t0 = time.perf_counter()
        dev = self.device
        tokens = torch.as_tensor(plan.tokens, device=dev)
        lengths = torch.as_tensor(plan.lengths, device=dev)
        logits, caches = Mod.prefill(self.params, self.cfg,
                                     {"tokens": tokens}, self.max_len,
                                     lengths=lengths)
        temps = torch.as_tensor([r.temperature for r in plan.requests],
                                dtype=torch.float32, device=dev)
        first = sampling.sample(self.generator, logits[:, 0], temps,
                                self.top_k)
        idx = torch.as_tensor(slots, dtype=torch.long, device=dev)
        for full, one in zip(self.caches, caches):
            for name, layer in full.items():
                for leaf, t in layer.items():
                    t.index_copy_(0, idx, one[name][leaf].to(t.dtype))
        first = first.cpu().numpy()            # the batch's host sync
        self.stats["prefill_s"] += time.perf_counter() - t0
        self.stats["prefill_batches"] += 1
        self.stats["prefill_tokens_computed"] += int(plan.lengths.sum())
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
    def _decode_block(self, n: int) -> List[Result]:
        """Run n decode steps on the device (one host sync), then retire
        finished and quarantined slots. The block runs inside a profiler
        range named "engine.decode_block" ("engine.prefill" for admission):
        free when no profiler is active."""
        live = [s for s in range(self.slots) if not self.slot_free[s]]
        if not live:
            return []
        with torch.profiler.record_function("engine.decode_block"):
            return self._decode_steps(n, live)

    @torch.no_grad()
    def _decode_steps(self, n: int, live: List[int]) -> List[Result]:
        t0 = time.perf_counter()
        dev = self.device
        if self._dev is None:
            active = np.asarray([not f for f in self.slot_free], bool)
            self._dev = dict(
                tok=torch.as_tensor(self.slot_last, device=dev),
                active=torch.as_tensor(active, device=dev),
                budget=torch.as_tensor(self.slot_budget, device=dev),
                temps=torch.as_tensor(self.slot_temp, device=dev),
                poisoned=torch.zeros((self.slots,), dtype=torch.bool,
                                     device=dev))
        d = self._dev
        tok, active, budget, poisoned = (d["tok"], d["active"], d["budget"],
                                         d["poisoned"])
        toks = torch.empty((n, self.slots), dtype=torch.int32, device=dev)
        emit = torch.empty((n, self.slots), dtype=torch.bool, device=dev)
        for i in range(n):
            logits, _ = Mod.decode_step(self.params, self.cfg,
                                        {"tokens": tok[:, None]},
                                        self.caches)
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
        # the block's one host sync
        toks_np = toks.cpu().numpy()
        emit_np = emit.cpu().numpy()
        self.slot_last = tok.cpu().numpy().astype(np.int32)
        self.slot_budget = budget.cpu().numpy().astype(np.int32)
        poisoned_np = poisoned.cpu().numpy()
        self.stats["decode_s"] += time.perf_counter() - t0
        self.stats["decode_steps"] += n
        self.stats["tokens_emitted"] += int(emit_np.sum())
        done: List[Result] = []
        for s in live:
            self.slot_out[s].extend(int(t) for t in toks_np[:, s][emit_np[:, s]])
            if poisoned_np[s]:
                done.append(self._finish(
                    self.slot_req[s].rid, self.slot_out[s], "poisoned",
                    "non-finite logits; slot quarantined"))
                self._free_slot(s)
            elif self.slot_budget[s] <= 0:
                done.append(self._finish(
                    self.slot_req[s].rid, self.slot_out[s], "ok"))
                self._free_slot(s)
        return done

    def _block_len(self) -> int:
        """Largest block that can't overshoot any live slot: stop at the
        earliest completion so slots free (and refill) at block boundaries
        and the random stream is the same for every scan_steps setting."""
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
