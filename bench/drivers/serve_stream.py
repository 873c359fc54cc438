"""A backlog served by one `ServingEngine.run` with continuous batching.

Set-up makes the weights and the engine, captures every decode block
length, and starts the stream: the whole backlog is submitted, the slots
fill and refill at block boundaries, and the window opens at the first
block boundary after `ramp_steps` decode steps. It closes at the first
block boundary `seconds` later, where every request still queued or live
is cut by its deadline (set to the window's end). Then the served tokens of
a sample of the window's finished requests are checked against the plain
reference.

Records: tokens delivered inside the window (each decode block's emitted
tokens and each prefill's first tokens), and the time per output token of
every request whose first token and finish both fall inside it.
"""
from __future__ import annotations

import torch

from bench import serving as S
from bench import weights as Wt
from bench.harness import Harness, Outcome, clock
from bench.traffic import generate
from bench.work import Shape


def run(h: Harness) -> Outcome:
    shape = Shape.from_config(h.config)
    cfg = S.port_config(h.config, check=h.device == "cuda")
    params = Wt.make(shape, h.seed, h.device)
    eng = S.engine(h, cfg, params)
    S.warm_decode(eng, shape.vocab, h.seed)
    prompts = generate.serve_requests(h.cell["traffic"], h.seed, shape.vocab)
    reqs = S.requests(prompts)
    win = h.window
    state = {"captures": 0}

    def on_block(n: int) -> None:
        if win.t_open is None:
            if rec.steps >= h.cell["ramp_steps"]:
                win.open()
                state["captures"] = S.captures(eng)
        elif win.is_open and win.boundary():
            state["captures"] = S.captures(eng) - state["captures"]
            for r in reqs:
                r.deadline = 0.0          # cut at the window's end

    rec = S.Recorder(eng, shape, win, {p.rid: len(p.tokens)
                                       for p in prompts}, on_block)
    results = {r.rid: r for r in eng.run(reqs)}
    if win.is_open:
        raise RuntimeError("the backlog ran out before the window closed: "
                           "give the cell more requests")
    if win.t_open is None:
        raise RuntimeError("the stream ended before the window opened")
    peak = torch.cuda.max_memory_allocated() if h.device == "cuda" else 0

    t0, t1 = win.t_open, win.t_close
    recs = [r for r in eng.tracer.records if r.rid < S.WARM_RID]
    inside = [r for r in recs if r.first_token is not None
              and t0 <= r.first_token and r.finish <= t1]
    done = [r for r in inside if r.status == "ok"]
    cut = [r for r in recs if r.status == "deadline"
           and r.first_token is not None]
    live = [r for r in recs if r.first_token is not None
            and r.first_token <= t1 and r.finish >= t0]
    failed = [r for r in live if r.status not in ("ok", "deadline")]
    tokens = win.work.get("decode_tokens", 0) \
        + win.work.get("prefill_requests", 0)
    records = {"tokens": tokens,
               "tpot_s": [r.tpot for r in done if r.tpot is not None]}
    notes = [f"{len(done)} requests finished inside the window, "
             f"{len(cut)} cut in decode by the deadline at its end (not "
             f"failures, not in the tail), "
             f"{len(recs) - len(cut) - len(done)} others",
             f"CUDA graph captures inside the window: {state['captures']}",
             f"window {win.length:.3f} s, {tokens:.0f} tokens, "
             f"{win.work.get('decode_steps', 0):.0f} decode steps, "
             f"{win.work.get('prefill_batches', 0):.0f} prefill batches"]

    prompt_of = {p.rid: p.tokens for p in prompts}
    served = {rid: res.tokens for rid, res in results.items()}
    rec.detach()
    del eng, rec
    if h.device == "cuda":
        torch.cuda.empty_cache()
    t_ref = clock()
    chk = S.check_served(h, params, prompt_of, served,
                         [r.rid for r in done], h.cell["check"]["sample"])
    notes.append(f"checked {chk.get('requests', 0)} requests, "
                 f"{chk['tokens']} served tokens against the reference in "
                 f"{clock() - t_ref:.1f} s")
    limit = h.cell["check"]["limits"]["max_logit_gap"]
    return Outcome(window=win, records=records, attempted=len(live),
                   failed=len(failed),
                   checks={"max_logit_gap": (chk["max_logit_gap"], limit)},
                   notes=notes, memory_peak_bytes=peak)
