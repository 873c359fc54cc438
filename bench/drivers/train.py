"""AdamW training through the port's `make_train_step`.

Set-up makes the weights and the optimizer state, builds the train step
once and drives that one object from the seed through its first
`checked_steps` steps (the first one warms every kernel and the
allocator), keeping what the check compares: each step's loss, the first
gradient as the optimizer got it (its first moment over 1 - beta1) and
the params' change over those steps. The window opens at a step boundary
and runs the same object on, one batch a step, each step synchronised;
it closes at the first step end `seconds` on. Then the program's state is
freed and the plain reference trains from the same weights on the same
batches for the checked steps.

Records: training tokens of the steps that finished inside the window.
"""
from __future__ import annotations

import math

import torch

from bench import serving as S
from bench import weights as Wt
from bench.harness import Harness, Outcome, clock
from bench.reference import compare
from bench.traffic import generate
from bench.work import Shape


def program_steps(h: Harness, shape: Shape, cfg, params, batch_fn,
                  fault=None):
    """The train step, its state and the checked steps' readings."""
    from repro_torch.launch.steps import make_train_step
    from repro_torch.optim import adamw
    opt_cfg = adamw.AdamWConfig(**h.cell["optimizer"])
    step_fn = make_train_step(cfg, opt_cfg)
    if fault is not None:
        step_fn = fault(step_fn)
    p0 = {k: t.clone() for k, t in Wt.leaves(params)}
    opt = adamw.init_opt_state(params)
    got = {"loss": [], "grad_norm": {}, "change": {}}
    for s in range(h.cell["checked_steps"]):
        params, opt, m = step_fn(params, opt, feed(batch_fn, s, h.device))
        got["loss"].append(float(m["loss"]))
        if s == 0:
            got["grad_norm"] = {k: float(mu.norm()) / (1 - opt_cfg.beta1)
                                for k, mu in Wt.leaves(opt.mu)}
    got["change"] = {k: float((t.float() - p0[k].float()).norm())
                     for k, t in Wt.leaves(params)}
    return step_fn, params, opt, got


def feed(batch_fn, step: int, device) -> dict:
    b = batch_fn(step)
    return {k: torch.as_tensor(v).to(device) for k, v in b.items()}


def reference(h: Harness, shape: Shape, batch_fn, half_batch=False,
              prec="fp32") -> dict:
    from bench.reference import lm
    lm.exact_fp32()
    init = Wt.leaves(Wt.make(shape, h.seed, h.device))
    batches = [feed(batch_fn, s, h.device)["tokens"]
               for s in range(h.cell["checked_steps"])]
    return lm.train(lm.Model.from_config(h.config, prec), init, batches,
                    h.cell["optimizer"], {k: t.dtype for k, t in init},
                    half_batch=half_batch)


def run(h: Harness) -> Outcome:
    shape = Shape.from_config(h.config)
    cfg = S.port_config(h.config, check=h.device == "cuda")
    tr = h.cell["traffic"]
    batch_fn = generate.train_batches(tr, h.seed, shape.vocab)
    params = Wt.make(shape, h.seed, h.device)
    step_fn, params, opt, got = program_steps(h, shape, cfg, params,
                                              batch_fn)
    lengths = [tr["seq_len"]] * tr["batch"]
    w = shape.train_step(lengths)
    win = h.window
    win.open()
    step, steps, bad = h.cell["checked_steps"], 0, 0
    while True:
        with torch.profiler.record_function("bench.feed"):
            batch = feed(batch_fn, step, h.device)
        with torch.profiler.record_function("bench.train_step"):
            params, opt, m = step_fn(params, opt, batch)
            loss = float(m["loss"])       # the step's end: a host sync
        bad += not math.isfinite(loss)
        step += 1
        steps += 1
        win.add(train_steps=1, train_tokens=sum(lengths), **w)
        if win.boundary():
            break
    peak = torch.cuda.max_memory_allocated() if h.device == "cuda" else 0
    records = {"train_tokens": win.work["train_tokens"]}
    notes = [f"{steps} train steps of {tr['batch']} x {tr['seq_len']} "
             f"tokens in a window of {win.length:.3f} s",
             f"program losses of the checked steps: {got['loss']}"]
    del step_fn, params, opt, m
    if h.device == "cuda":
        torch.cuda.empty_cache()
    t_ref = clock()
    ref = reference(h, shape, batch_fn)
    notes.append(f"reference losses: {ref['loss']} "
                 f"({clock() - t_ref:.1f} s)")
    gaps = compare.train_gaps(got, ref)
    lim = h.cell["check"]["limits"]
    return Outcome(window=win, records=records, attempted=steps, failed=bad,
                   checks={k: (gaps[k], lim[k]) for k in lim}, notes=notes,
                   memory_peak_bytes=peak)
