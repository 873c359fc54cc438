"""Phase spans inside the serving engine and the train step
(`repro_torch.telemetry.tracer.span`), on the CPU:

  * under torch.profiler every admission batch and decode or verify block
    records its phases as profiler ranges, nested in their parent and in
    order, and each span also as a record of the span ring; the prefill
    model phase counts the plan's real and padded prompt tokens;
  * with no profiler active nothing records: the ring stays empty, no CUDA
    event is made, and the served tokens are bitwise those of a profiled
    run;
  * a train step records forward, backward and optimizer once each, in
    that order, with no device time off the card;
  * one clock read a boundary: `stats["prefill_s"]` / `stats["decode_s"]`
    are the tracer's own intervals, from the times its hooks recorded;
  * the tracer's chrome trace lies on the profiler's time base: a block's
    span lies within 1 ms of the profiler's own range, and the trace
    passes the validator.
"""
import itertools

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.configs import get_smoke_config, with_swat
from repro_torch.core import model as Mod
from repro_torch.launch.steps import make_train_step
from repro_torch.optim import adamw
from repro_torch.serving.engine import Request, ServingEngine
from repro_torch.telemetry import tracer as TR
from repro_torch.telemetry import validate as V
from repro_torch.telemetry.tracer import Tracer

torch.set_num_threads(1)

PREFILL = ["upload", "model", "insert", "read", "hooks", "retire"]
BLOCK = ["stage", "launch", "read", "hooks", "retire"]


@pytest.fixture(scope="module")
def model():
    cfg = with_swat(get_smoke_config("llama3.2-1b"), window=16, num_global=4)
    return cfg, Mod.init_model(cfg, seed=0, device="cpu")


def _requests(n=5, new=9, seed=0):
    rng = np.random.RandomState(seed)
    return [Request(rid=i, prompt=rng.randint(0, 256, (int(ln),)).astype(
        np.int32), max_new_tokens=new)
        for i, ln in enumerate(rng.randint(9, 40, n))]


def _engine(model, **kw):
    cfg, params = model
    return ServingEngine(cfg, params, batch_slots=2, max_len=128,
                         scan_steps=4, **kw)


def _profiled(fn):
    """fn() under torch.profiler, the ring emptied before: (its result, the
    ring's records, the profiler's host ranges {name: [(start, end) ns]}
    in start order)."""
    TR.consume_spans()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    ranges = {}
    for e in prof.profiler.kineto_results.events():
        if e.name().startswith(("engine.", "train.")):
            s = e.start_ns()
            ranges.setdefault(e.name(), []).append((s, s + e.duration_ns()))
    return out, TR.consume_spans(), {k: sorted(v) for k, v in
                                     ranges.items()}


def _phases(ranges, parent, s0, e0):
    """The `parent.*` ranges inside [s0, e0]: (start, end, phase) in start
    order."""
    return sorted((s, e, name.rsplit(".", 1)[1])
                  for name, rs in ranges.items()
                  if name.startswith(parent + ".")
                  for s, e in rs if s0 <= s and e <= e0)


def _plans(eng):
    """Record each admission plan's (real tokens, padded tokens)."""
    got, plain = [], eng._prefill_into

    def wrap(plan, slots):
        n, l_pad = plan.tokens.shape
        got.append((int(plan.lengths.sum()), n * l_pad))
        return plain(plan, slots)
    eng._prefill_into = wrap
    return got


@pytest.mark.parametrize("kw", [{}, {"speculative": 2}],
                         ids=["sequential", "speculative"])
def test_each_batch_and_block_records_its_phases_in_order(model, kw):
    eng = _engine(model, **kw)
    plans = _plans(eng)
    _, spans, ranges = _profiled(lambda: eng.run(_requests()))
    batches = ranges["engine.prefill"]
    assert len(batches) == len(plans) == eng.stats["prefill_batches"] >= 3
    for s0, e0 in batches:
        kids = _phases(ranges, "engine.prefill", s0, e0)
        assert [k[2] for k in kids] == PREFILL
        ends = [s0] + [x for s, e, _ in kids for x in (s, e)] + [e0]
        assert ends == sorted(ends)
    counts = [s["counts"] for s in spans
              if s["name"] == "engine.prefill.model"]
    assert [(c["real_tokens"], c["padded_tokens"]) for c in counts] == plans
    blocks = ranges["engine.decode_block"]
    assert len(blocks) == len(eng.tracer.blocks) >= 4
    for s0, e0 in blocks:
        kids = _phases(ranges, "engine.decode_block", s0, e0)
        names = [k[2] for k in kids]
        if kw:
            # a launch and a flag read a verify step, then the block's read
            steps = names.count("launch")
            assert names == (["stage"] + ["launch", "read"] * steps
                             + ["read", "hooks", "retire"])
        else:
            assert names == BLOCK
        ends = [s0] + [x for s, e, _ in kids for x in (s, e)] + [e0]
        assert ends == sorted(ends)
    # each profiler range is also a ring record, appended as it closes
    for name, rs in ranges.items():
        assert len(rs) == sum(s["name"] == name for s in spans)
    prefill = [s["name"] for s in spans
               if s["name"].startswith("engine.prefill")]
    assert prefill == ([f"engine.prefill.{p}" for p in PREFILL]
                       + ["engine.prefill"]) * len(batches)


def test_no_profiler_records_nothing_and_serves_the_same_tokens(
        model, monkeypatch):
    profiled, spans, _ = _profiled(lambda: _engine(model).run(_requests()))
    assert spans
    made = []
    monkeypatch.setattr(torch.cuda, "Event",
                        lambda *a, **k: made.append(1))
    TR.consume_spans()
    plain = _engine(model).run(_requests())
    assert TR.peek_spans() == [] and made == []
    assert [r.tokens for r in plain] == [r.tokens for r in profiled]
    assert TR.span("engine.x", real_tokens=1) is TR.span("train.y")


def test_a_train_step_records_forward_backward_optimizer(model):
    cfg, params = model
    params = {k: v for k, v in params.items()}
    step = make_train_step(cfg, adamw.AdamWConfig(lr=1e-3, warmup_steps=1,
                                                  total_steps=4))
    opt = adamw.init_opt_state(params)
    tokens = torch.randint(0, 256, (2, 33), generator=torch.Generator()
                           .manual_seed(0))
    batch = {"tokens": tokens[:, :-1], "labels": tokens[:, 1:]}
    _, spans, ranges = _profiled(lambda: step(params, opt, batch))
    assert [s["name"] for s in spans] == ["train.forward", "train.backward",
                                          "train.optimizer"]
    assert all(s["device_ms"] is None for s in spans)
    assert all(len(ranges[s["name"]]) == 1 for s in spans)
    order = [ranges[s["name"]][0] for s in spans]
    assert all(a[1] <= b[0] for a, b in zip(order, order[1:]))


def test_stats_take_the_tracers_stamps(model):
    """A counting clock ticks once a read: each batch's prefill_s is its
    first-token tick less its admission tick, and decode_s the sum of the
    tracer's block spans."""
    eng = _engine(model)
    eng.tracer = Tracer(clock=itertools.count().__next__)
    eng.run(_requests())
    batches = {(r.admit, r.first_token) for r in eng.tracer.records}
    assert eng.stats["prefill_s"] == sum(b - a for a, b in batches)
    assert eng.stats["decode_s"] == sum(b["dur"] for b in eng.tracer.blocks)
    assert all(b["dur"] == 1 for b in eng.tracer.blocks)


def test_hooks_keep_the_time_they_recorded():
    tr = Tracer(clock=iter([0.0, 5.0, 7.0, 9.0, 10.0, 11.0]).__next__)
    tr.on_submit(1)                                  # epoch 0, submit 5
    assert tr.last is None
    tr.on_admit([1])
    assert tr.last == tr._open[1]["admit"] == 7.0
    tr.on_first_token([1])
    assert tr.last == tr._open[1]["first_token"] == 9.0
    tr.on_bus_event({"kind": "x"})                   # 10: not a boundary
    tr.on_block("seq", 2, 9.0, 3)
    assert tr.last == 11.0 and tr.blocks[-1]["dur"] == 2.0


def test_chrome_trace_block_lies_on_the_profilers_range(model):
    eng = _engine(model)
    _, _, ranges = _profiled(lambda: eng.run(_requests()))
    doc = eng.chrome_trace()
    assert V.validate_chrome_trace(doc) == []
    blocks = [ev for ev in doc["traceEvents"] if ev.get("cat") == "decode"]
    starts = sorted(s for s, _ in ranges["engine.decode_block"])
    assert len(blocks) == len(starts)
    for ev, s in zip(blocks, starts):
        assert abs(ev["ts"] - s / 1e3) < 1e3          # us: within 1 ms
