"""A closed loop of bursts: each burst is one `ServingEngine.run` of
`burst` documents submitted together, and the next goes when it ends.

Set-up makes the weights and the engine, captures every decode block
length and serves `warm_bursts` bursts. The window opens at a burst
boundary; every burst that starts before `seconds` have passed runs to
its end and counts, and the window closes at the end of the last one.
Then the served tokens of a sample of the window's requests are checked
against the plain reference.

Records: each request's time to first token, from its burst's submit.
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
    tr = h.cell["traffic"]
    prompts = generate.serve_requests(tr, h.seed, shape.vocab)
    size = tr["burst"]
    bursts = [prompts[i:i + size] for i in range(0, len(prompts), size)]
    win = h.window
    rec = S.Recorder(eng, shape, win, {p.rid: len(p.tokens)
                                       for p in prompts})
    warm = h.cell["warm_bursts"]
    for b in bursts[:warm]:
        eng.run(S.requests(b))
    win.open()
    captures0 = S.captures(eng)
    served, rids, i = {}, [], warm
    while True:
        if i == len(bursts):
            raise RuntimeError("the bursts ran out before the window "
                               "closed: give the cell more requests")
        for res in eng.run(S.requests(bursts[i])):
            served[res.rid] = res.tokens
        rids += [p.rid for p in bursts[i]]
        i += 1
        if win.boundary():
            break
    peak = torch.cuda.max_memory_allocated() if h.device == "cuda" else 0
    ids = set(rids)
    recs = [r for r in eng.tracer.records if r.rid in ids]
    ok = [r for r in recs if r.status == "ok"]
    records = {"ttft_s": [r.ttft for r in recs if r.ttft is not None]}
    notes = [f"{i - warm} bursts, {len(recs)} requests in the window",
             f"CUDA graph captures inside the window: "
             f"{S.captures(eng) - captures0}",
             f"window {win.length:.3f} s, "
             f"{win.work.get('prefill_batches', 0):.0f} prefill batches, "
             f"{win.work.get('decode_steps', 0):.0f} decode steps"]
    prompt_of = {p.rid: p.tokens for p in prompts}
    rec.detach()
    del eng, rec
    if h.device == "cuda":
        torch.cuda.empty_cache()
    t_ref = clock()
    chk = S.check_served(h, params, prompt_of, served,
                         [r.rid for r in ok], h.cell["check"]["sample"])
    notes.append(f"checked {chk.get('requests', 0)} requests, "
                 f"{chk['tokens']} served tokens against the reference in "
                 f"{clock() - t_ref:.1f} s")
    limit = h.cell["check"]["limits"]["max_logit_gap"]
    return Outcome(window=win, records=records, attempted=len(recs),
                   failed=len(recs) - len(ok),
                   checks={"max_logit_gap": (chk["max_logit_gap"], limit)},
                   notes=notes, memory_peak_bytes=peak)
