"""What the serving drivers share: the port's config and engine from a
cell, the warm-up of the decode graphs, the recorder that counts the work
of every prefill batch and decode block as it completes, and the check of
served tokens against the plain reference.

The recorder hooks the engine's tracer (`engine.tracer`, the port's
lifecycle tracer): `on_first_token` closes a prefill batch, `on_block` a
decode block, before its slots retire, while each live slot's request and
tokens so far are still in place.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from bench import work as W
from bench.harness import Harness
from bench.traffic import generate

WARM_RID = 1 << 40


def port_config(c: dict, check: bool = True):
    """The port's ModelConfig for a configuration file: its named config
    under `with_swat`, with the file's sizes. check: raise where the file
    and the port's config differ (a file for tests may shrink them)."""
    from repro_torch.configs import get_config, with_swat
    from repro_torch.core.types import MoESpec
    base = with_swat(get_config(c["port_config"]), c["swat"]["window"],
                     c["swat"]["num_global"])
    moe = (dataclasses.replace(base.moe, num_experts=c["num_local_experts"],
                               top_k=c["num_experts_per_tok"])
           if c["num_local_experts"] else MoESpec())
    cfg = dataclasses.replace(
        base, num_layers=c["num_hidden_layers"], d_model=c["hidden_size"],
        num_heads=c["num_attention_heads"],
        num_kv_heads=c["num_key_value_heads"], head_dim=c["head_dim"],
        d_ff=c["intermediate_size"], vocab_size=c["vocab_size"],
        norm_eps=c["rms_norm_eps"], rope_theta=c["rope_theta"],
        tie_embeddings=c["tie_word_embeddings"], moe=moe,
        dtype=c["torch_dtype"])
    if check and cfg != base:
        raise ValueError(f"{c['name']}: the file's sizes differ from "
                         f"repro_torch's {c['port_config']} + with_swat")
    return cfg


def engine(h: Harness, cfg, params):
    from repro_torch.serving.engine import ServingEngine
    return ServingEngine(cfg, params, seed=h.seed % 2**63,
                         trace_capacity=1 << 16, **h.cell["engine"])


def requests(prompts: List[generate.Prompt]):
    from repro_torch.serving.engine import Request
    return [Request(rid=p.rid, prompt=p.tokens,
                    max_new_tokens=p.max_new_tokens) for p in prompts]


def warm_decode(eng, vocab: int, seed: int) -> None:
    """Every decode block length 1..scan_steps used twice (eager, then
    captured), one short request at a time, so no capture happens in the
    window."""
    r = generate.rng(seed, 99)
    n = eng.scan_steps
    prompts = [generate.Prompt(WARM_RID + i, r.integers(0, vocab, 64,
                                                        dtype=np.int32),
                               1 + (i % n) + 1) for i in range(2 * n)]
    for p in prompts:
        eng.run(requests([p]))


class Recorder:
    """Counts each prefill batch's and decode block's work into the window
    as it completes; calls `on_block(n)` after each decode block."""

    def __init__(self, eng, shape: W.Shape, window, prompt_len: Dict[int, int],
                 on_block: Optional[Callable[[int], None]] = None):
        self.eng, self.shape, self.window = eng, shape, window
        self.prompt_len = prompt_len
        self.on_block = on_block
        self.steps = 0
        tr = self._tracer = eng.tracer
        self._hooks = (tr.on_first_token, tr.on_block)
        tr.on_first_token, tr.on_block = self._first, self._block

    def detach(self) -> None:
        """Give the tracer its own hooks back: the event bus keeps the
        tracer, which must not keep the engine alive through us."""
        for name in ("on_first_token", "on_block"):
            self._tracer.__dict__.pop(name, None)
        self.eng = self._tracer = None

    def _first(self, rids) -> None:
        self._hooks[0](rids)
        lens = [self.prompt_len[r] for r in rids if r in self.prompt_len]
        if lens:
            w = self.shape.prefill(lens)
            self.window.add(prefill_batches=1, prefill_requests=len(lens),
                            flops=w["flops"], least_s=w["least_s"],
                            **{"least_s.swat_fwd": w["least_s.swat_fwd"]})

    def _block(self, mode, n, t0, tokens) -> None:
        self._hooks[1](mode, n, t0, tokens)
        eng, cap = self.eng, self.shape.ring_cap
        live = [(self.prompt_len.get(r.rid, r.prompt.size),
                 len(eng.slot_out[s]))
                for s, r in enumerate(eng.slot_req) if r is not None]
        acc = {"flops": 0.0, "least_s": 0.0, "least_s.swat_decode": 0.0}
        for i in range(n):
            w = self.shape.decode_step([min(p + o + i, cap)
                                        for p, o in live])
            for k in acc:
                acc[k] += w[k]
        self.steps += n
        self.window.add(decode_steps=n,
                        decode_block_s=eng.tracer.clock() - t0,
                        decode_tokens=tokens, **acc)
        if self.on_block is not None:
            self.on_block(n)


def captures(eng) -> int:
    """CUDA graphs the engine has captured so far."""
    return len(eng._compiled.captured)


def check_served(h: Harness, params, prompts: Dict[int, np.ndarray],
                 served: Dict[int, List[int]], population: List[int],
                 k: int) -> Dict[str, float]:
    """The widest gap by which a served token's logit lies below the
    reference's best, over a sample of k finished requests drawn from the
    seed, the longest (prompt + served) among them: the reference runs
    once over each prompt with its served tokens."""
    from bench.reference import lm
    if not population:
        return {"max_logit_gap": float("nan"), "tokens": 0}
    lm.exact_fp32()
    longest = max(population, key=lambda r: len(prompts[r]) + len(served[r]))
    rids = generate.sample(h.seed, population, k, [longest])
    gaps = served_gaps(lm.Model.from_config(h.config), params,
                       [prompts[r] for r in rids], [served[r] for r in rids],
                       h.device)
    return {"max_logit_gap": max(float(g.max()) for g in gaps),
            "tokens": sum(len(g) for g in gaps), "requests": len(rids)}


def served_gaps(model, params, prompts, served, device,
                control=None) -> List[torch.Tensor]:
    """Per request, each served token's gap below the fp32 reference's best
    logit at its position; with a `control` Model, the gap of the token
    that the control puts first there instead."""
    from bench.reference import lm
    seqs = [torch.as_tensor(np.concatenate([p, np.asarray(s, np.int64)]),
                            dtype=torch.long, device=device)
            for p, s in zip(prompts, served)]
    firsts = [len(p) for p in prompts]
    ref = lm.served_logits(model, params, seqs, firsts)
    if control is not None:
        pick = [lg.argmax(-1) for lg in lm.served_logits(control, params,
                                                         seqs, firsts)]
    else:
        pick = [torch.as_tensor(s, dtype=torch.long, device=device)
                for s in served]
    return [(lg.max(-1).values - lg.gather(1, t[:, None])[:, 0]).cpu()
            for lg, t in zip(ref, pick)]
