"""The port's telemetry (`repro_torch.telemetry`, the engine's hooks and the
scope CLI) held against the JAX package's `repro.telemetry` on the CPU.

The serve is the verify recipe's (llama3.2-1b smoke + SWAT window 64,
5 requests, 2 slots, prompt 70, 12 new tokens, max_len 256, scan_steps 8)
on params converted from the JAX init:

  * device counters: with metrics=True, the port engine's
    `device_metrics()` totals and per-slot vectors equal the JAX engine's,
    sequential and speculative, and ring_wraps on a ring small enough to
    wrap; each counter equals its host-side oracle in `stats`;
  * the counters are graph-safe: updated in place (fixed storage over whole
    runs), and the metrics-on bodies run exactly the metrics-off bodies'
    operations plus the counter updates;
  * metrics-on tokens equal metrics-off tokens, greedy and sampled;
  * quarantine bumps `quarantined`, puts `slot_quarantined` on the bus and
    in the tracer; the acceptance ladder's events equal the JAX engine's;
  * the Tracer and `prometheus_text` give the JAX outputs on the same hook
    sequence and clock; with a counting clock the two engines' request
    records and block spans are equal (the hooks fire in the same order);
  * the exports pass both packages' validators, which reject the same
    garbage with the same messages;
  * the census of `decode_attention` dispatches equals the JAX engine's
    (minus `impl` and `traces`), and `banded_decode_cost` equals the JAX
    function;
  * the serve launcher's --metrics / --trace-out / --metrics-out and the
    scope CLI's validate, census and profile.
"""
import collections
import dataclasses
import itertools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.configs import get_smoke_config, with_swat
from repro.core import model as JM
from repro.serving import engine as JE
from repro.serving.engine import Request as JRequest
from repro.serving.engine import ServingEngine as JEngine
from repro.telemetry import events as JTEV
from repro.telemetry import kernelprof as JKP
from repro.telemetry import metrics as JMX
from repro.telemetry import validate as JV
from repro.telemetry.tracer import Tracer as JTracer
from repro.telemetry.tracer import prometheus_text as j_prometheus_text
from repro_torch import interop
from repro_torch.configs import get_smoke_config as t_smoke
from repro_torch.configs import with_swat as t_swat
from repro_torch.launch import scope
from repro_torch.launch import serve as serve_launcher
from repro_torch.serving.engine import Request, ServingEngine
from repro_torch.telemetry import events as TEV
from repro_torch.telemetry import kernelprof as KP
from repro_torch.telemetry import metrics as MX
from repro_torch.telemetry import validate as V
from repro_torch.telemetry.tracer import Tracer, prometheus_text

torch.set_num_threads(1)

CELLS = {"sequential": {}, "speculative": {"speculative": 2}}
RECIPE = dict(batch_slots=2, max_len=256, scan_steps=8)


@pytest.fixture(autouse=True)
def _clean_event_buses():
    TEV.consume_events()
    JTEV.consume_events()
    yield
    TEV.consume_events()
    JTEV.consume_events()


@pytest.fixture(scope="module")
def setup():
    cfg = with_swat(get_smoke_config("llama3.2-1b"), window=64, num_global=4)
    tcfg = t_swat(t_smoke("llama3.2-1b"), window=64, num_global=4)
    jp = JM.init_model(jax.random.PRNGKey(0), cfg)
    tp = interop.params_from_jax(jax.tree.map(np.asarray, jp), tcfg,
                                 device="cpu")
    rng = np.random.RandomState(0)
    prompts = [rng.randint(0, cfg.vocab_size, (70,)).astype(np.int32)
               for _ in range(5)]
    return cfg, tcfg, jp, tp, prompts


def _counting_tracer(eng, tracer_cls, bus):
    """Give `eng` a fresh tracer whose clock returns 0, 1, 2, ... (one tick a
    hook), subscribed to `bus`."""
    eng.tracer = tracer_cls(clock=itertools.count().__next__)
    bus.subscribe(eng.tracer.on_bus_event)


def _reqs(prompts, n_new=12, temps=None, cls=Request):
    """`cls` (the port's Request, or the JAX package's) for each prompt."""
    temps = temps or [0.0] * len(prompts)
    return [cls(rid=i, prompt=p, max_new_tokens=n_new, temperature=t)
            for i, (p, t) in enumerate(zip(prompts, temps))]


@pytest.fixture(scope="module")
def served(setup):
    """Each cell served by the JAX engine and the port engine, both with
    metrics=True, a counting-clock tracer and the census on."""
    cfg, tcfg, jp, tp, prompts = setup
    # the JAX census records at trace time: start from an empty compile
    # cache so every program of these engines is traced
    JE._get_compiled.cache_clear()
    out = {}
    for cell, kw in CELLS.items():
        jeng = JEngine(cfg, jp, metrics=True, **RECIPE, **kw)
        _counting_tracer(jeng, JTracer, JTEV.BUS)
        teng = ServingEngine(tcfg, tp, metrics=True, **RECIPE, **kw)
        _counting_tracer(teng, Tracer, TEV.BUS)
        runs = {}
        for side, eng, reqs, kp in (
                ("jax", jeng, _reqs(prompts, cls=JRequest), JKP),
                ("port", teng, _reqs(prompts), KP)):
            kp.consume_census()
            kp.enable_census(True)
            try:
                res = eng.run(reqs)
            finally:
                kp.enable_census(False)
            # the tracer as the run left it (it stays subscribed to the bus)
            trace = (list(eng.tracer.records), list(eng.tracer.blocks),
                     list(eng.tracer.events), eng.tracer.latency_summary())
            runs[side] = (eng, res, kp.consume_census(), trace)
        out[cell] = runs
    JTEV.consume_events()
    TEV.consume_events()
    return out


# ---------------------------------------------------- device counters ----

@pytest.mark.parametrize("cell", CELLS)
def test_device_counters_equal_jax_engine(served, cell):
    (jeng, jres, _, _), (teng, tres, _, _) = served[cell]["jax"], \
        served[cell]["port"]
    assert [r.tokens for r in tres] == [r.tokens for r in jres]
    assert teng.device_metrics() == jeng.device_metrics()
    jslot = jeng.device_metrics(per_slot=True)
    tslot = teng.device_metrics(per_slot=True)
    assert set(tslot) == set(jslot) == set(MX.PER_SLOT + MX.SCALARS)
    for k in jslot:
        assert tslot[k].dtype == np.int32
        np.testing.assert_array_equal(tslot[k], jslot[k], err_msg=k)
    # the host oracle
    dev, st = teng.device_metrics(), teng.stats
    assert dev["tokens"] == dev["pos"] == st["tokens_emitted"] == 5 * 11
    assert dev["drafts_proposed"] == st["draft_proposed"]
    assert dev["drafts_accepted"] == st["draft_accepted"]
    assert dev["steps"] == (st["spec_steps"] if cell == "speculative"
                            else st["decode_steps"])
    assert dev["quarantined"] == 0
    if cell == "speculative":
        assert dev["drafts_proposed"] > 0
        assert dev["tokens"] == (dev["drafts_proposed"] // 2
                                 + dev["drafts_accepted"])


@pytest.mark.parametrize("cell", CELLS)
def test_ring_wraps_equal_jax_engine(setup, cell):
    """One slot, one 40-token request on a 16-token window: decode writes
    wrap the narrowest logical ring floor(emitted / modulus) times."""
    _, _, jp, _, prompts = setup
    cfg = with_swat(get_smoke_config("llama3.2-1b"), window=16, num_global=4)
    tcfg = t_swat(t_smoke("llama3.2-1b"), window=16, num_global=4)
    tp = interop.params_from_jax(jax.tree.map(np.asarray, jp), tcfg,
                                 device="cpu")
    kw = dict(batch_slots=1, max_len=64, scan_steps=4, metrics=True,
              **CELLS[cell])
    jeng = JEngine(cfg, jp, **kw)
    jeng.run(_reqs(prompts[:1], n_new=40, cls=JRequest))
    teng = ServingEngine(tcfg, tp, **kw)
    res = teng.run(_reqs(prompts[:1], n_new=40))
    assert res[0].status == "ok" and len(res[0].tokens) == 40
    mod = MX.ring_modulus(tcfg, 64, teng.lookahead)
    assert teng.ring_mod == mod == jeng._c.ring_mod
    dev = teng.device_metrics()
    assert dev["ring_wraps"] == 39 // mod > 0
    assert dev == jeng.device_metrics()
    for k, v in jeng.device_metrics(per_slot=True).items():
        np.testing.assert_array_equal(
            teng.device_metrics(per_slot=True)[k], v, err_msg=k)


@pytest.mark.parametrize("cell", CELLS)
def test_counter_updates_equal_jax_functions(cell):
    """seq_update_ / spec_update_ against the JAX seq_update / spec_update
    over 40 random steps (ring modulus 7, so rings wrap), updating the same
    tensors in place."""
    rng = np.random.RandomState(1)
    slots, k, mod = 4, 3, 7
    jmx = JMX.init_metrics(slots)
    tmx = MX.init_metrics(slots, "cpu")
    ptrs = {n: v.data_ptr() for n, v in tmx.items()}
    for _ in range(40):
        bad = rng.rand(slots) < 0.1
        if cell == "sequential":
            ok = (rng.rand(slots) < 0.8) & ~bad
            jmx = JMX.seq_update(jmx, jnp.asarray(ok), jnp.asarray(bad), mod)
            MX.seq_update_(tmx, torch.as_tensor(ok), torch.as_tensor(bad),
                           mod)
        else:
            e = rng.randint(0, k + 2, slots).astype(np.int32)
            jmx = JMX.spec_update(jmx, jnp.asarray(e), jnp.asarray(bad), k,
                                  mod)
            MX.spec_update_(tmx, torch.as_tensor(e), torch.as_tensor(bad),
                            k, mod)
    for n, v in jmx.items():
        np.testing.assert_array_equal(tmx[n].numpy(), np.asarray(v),
                                      err_msg=n)
        assert tmx[n].data_ptr() == ptrs[n]
    assert int(tmx["ring_wraps"].sum()) > 0


@pytest.mark.parametrize("arch", ["llama3.2-1b", "gemma2-2b", "mamba2-1.3b",
                                  "jamba-1.5-large", "whisper-tiny"])
@pytest.mark.parametrize("lookahead", [0, 4])
def test_ring_modulus_equals_jax(arch, lookahead):
    for swat in (False, True):
        cfg, tcfg = get_smoke_config(arch), t_smoke(arch)
        if swat:
            cfg = with_swat(cfg, window=16, num_global=4)
            tcfg = t_swat(tcfg, window=16, num_global=4)
        for max_len in (64, 256):
            assert MX.ring_modulus(tcfg, max_len, lookahead) == \
                JMX.ring_modulus(cfg, max_len, lookahead), (swat, max_len)


# -------------------------------------------------------- graph safety ----

class _OpLog(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops[str(func)] += 1
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("cell", CELLS)
def test_counters_in_place_and_only_addition(setup, cell):
    """Over whole runs the counters keep their tensors and storage (what a
    captured graph replays), and the metrics-on engine runs exactly the
    metrics-off engine's operations plus a fixed set of counter updates a
    step: the bodies a metrics-off engine captures are unchanged."""
    _, tcfg, _, tp, prompts = setup
    logs = {}
    for metrics in (False, True):
        eng = ServingEngine(tcfg, tp, metrics=metrics, **RECIPE,
                            **CELLS[cell])
        ids = {k: (id(v), v.data_ptr()) for k, v in (eng._mx or {}).items()}
        with _OpLog() as log:
            res = eng.run(_reqs(prompts[:4], n_new=6))
        assert all(r.status == "ok" for r in res)
        assert {k: (id(v), v.data_ptr())
                for k, v in (eng._mx or {}).items()} == ids
        logs[metrics] = (log.ops, eng)
    (off, eng_off), (on, eng_on) = logs[False], logs[True]
    assert eng_off._mx is None and eng_off.device_metrics() == {}
    assert not off - on                   # nothing of metrics-off is gone
    extra = on - off
    steps = eng_on.device_metrics()["steps"]
    per_step = 11 if cell == "sequential" else 18
    assert sum(extra.values()) == per_step * steps, extra
    assert {op.split(".")[1] for op in extra} <= {
        "_to_copy", "add", "add_", "floor_divide", "sub", "copy_", "ge",
        "clamp", "mul"}, extra


# -------------------------------------------------------------- tokens ----

@pytest.mark.parametrize("sampled", [False, True], ids=["greedy", "sampled"])
@pytest.mark.parametrize("cell", CELLS)
def test_metrics_on_tokens_equal_metrics_off(setup, cell, sampled):
    _, tcfg, _, tp, prompts = setup
    temps = [0.0, 1.5, 0.0, 0.8, 0.0] if sampled else None
    toks = []
    for metrics in (False, True):
        eng = ServingEngine(tcfg, tp, metrics=metrics, seed=7, **RECIPE,
                            **CELLS[cell])
        toks.append([(r.status, r.tokens)
                     for r in eng.run(_reqs(prompts, temps=temps))])
    assert toks[0] == toks[1]


# ------------------------------------------------------------- events ----

def test_quarantine_counts_and_reaches_bus_and_tracer(setup):
    """Poison slot 1's K rings (as test_torch_engine does): the slot is
    quarantined once on the device counters, a slot_quarantined event with
    its rid is on the bus, and the tracer and its chrome trace hold it."""
    _, tcfg, _, tp, prompts = setup
    eng = ServingEngine(tcfg, tp, batch_slots=2, max_len=256, metrics=True)
    eng._admit(collections.deque(_reqs(prompts[:2], n_new=6)))
    for blk in eng.caches:
        for layer in blk.values():
            layer["k"][1] = float("nan")
    while not all(eng.slot_free):
        eng._decode_block(eng._block_len())
    res = eng.take_completed()
    assert [r.status for r in res] == ["ok", "poisoned"]
    dev = eng.device_metrics(per_slot=True)
    assert dev["quarantined"].tolist() == [0, 1]
    assert eng.device_metrics()["quarantined"] == 1 == \
        eng.stats["quarantined"]
    evs = TEV.peek_events()
    assert [(e["kind"], e["rid"]) for e in evs] == [("slot_quarantined", 1)]
    assert eng.tracer.events[-1]["kind"] == "slot_quarantined"
    names = [ev["name"] for ev in eng.chrome_trace()["traceEvents"]]
    assert "slot_quarantined" in names
    assert eng.tracer.records[-1].status == "poisoned"


def test_event_bus_fans_out_weakly():
    tr = Tracer(clock=itertools.count().__next__)
    TEV.BUS.subscribe(tr.on_bus_event)
    TEV.record_event("synthetic_drill", rid=42)
    assert TEV.peek_events()[-1] == {"kind": "synthetic_drill", "rid": 42}
    assert tr.events[-1] == {"ts": 1, "kind": "synthetic_drill", "rid": 42}
    assert [e["kind"] for e in TEV.consume_events()] == ["synthetic_drill"]
    assert TEV.consume_events() == []
    n = len(TEV.BUS._subs)
    del tr
    TEV.record_event("after_gc")
    assert len(TEV.BUS._subs) == n - 1


def test_acceptance_ladder_events_equal_jax(setup):
    """spec_autodisable / spec_resume go on the bus as in the JAX engine:
    the same kinds, rates and order, and the same counters."""
    cfg, tcfg, jp, tp, prompts = setup
    kw = dict(metrics=True, speculative=2, spec_min_acceptance=0.9,
              spec_acceptance_window=1, spec_retry_blocks=1,
              spec_resume_acceptance=0.0, **RECIPE)
    jeng = JEngine(cfg, jp, **kw)
    jres = jeng.run(_reqs(prompts, cls=JRequest))
    jevs = JTEV.consume_events()
    teng = ServingEngine(tcfg, tp, **kw)
    tres = teng.run(_reqs(prompts))
    tevs = TEV.consume_events()
    assert [r.tokens for r in tres] == [r.tokens for r in jres]
    kinds = [e["kind"] for e in tevs]
    assert "spec_autodisable" in kinds and "spec_resume" in kinds
    assert tevs == jevs
    assert [e["kind"] for e in teng.tracer.events] == kinds
    for k in ("spec_autodisable", "spec_resume", "spec_steps"):
        assert teng.stats[k] == jeng.stats[k], k
    assert teng.device_metrics() == jeng.device_metrics()


# ------------------------------------------------------------- tracer ----

def _hook_script(seed):
    """A random hook sequence: submits, admission batches (some rids
    admitted twice: retries), first tokens, blocks, bus events, finishes
    (some without a submit), and a clock of random increments."""
    rng = np.random.RandomState(seed)
    ticks = list(np.cumsum(rng.exponential(0.01, 2000)))
    ops, open_, nxt = [], [], 0
    for _ in range(120):
        r = rng.rand()
        if r < 0.25 or not open_:
            ops.append(("on_submit", nxt))
            open_.append(nxt)
            nxt += 1
        elif r < 0.45:
            ops.append(("on_admit", list(rng.choice(
                open_, min(len(open_), 1 + rng.randint(3)), replace=False))))
        elif r < 0.6:
            ops.append(("on_first_token", list(open_[:2])))
        elif r < 0.75:
            ops.append(("on_block", ("seq", "spec")[rng.randint(2)],
                        int(rng.randint(1, 9)), int(rng.randint(0, 20))))
        elif r < 0.8:
            ops.append(("event", ("slot_quarantined", "request_rejected",
                                  "spec_resume")[rng.randint(3)]))
        else:
            rid = open_.pop(rng.randint(len(open_))) if rng.rand() < 0.9 \
                else 10_000 + nxt
            ops.append(("on_finish", int(rid),
                        ("ok", "poisoned", "rejected")[rng.randint(3)],
                        int(rng.randint(0, 30))))
    return ticks, ops


def _play(tracer_cls, bus, ticks, ops, capacity):
    it = iter(ticks)
    tr = tracer_cls(capacity=capacity, clock=lambda: float(next(it)))
    bus.subscribe(tr.on_bus_event)
    for op in ops:
        if op[0] == "event":
            bus.record(op[1], rid=7, reason="drill")
        elif op[0] == "on_block":
            tr.on_block(op[1], op[2], tr.clock(), op[3])
        else:
            getattr(tr, op[0])(*op[1:])
    bus.consume()
    return tr


@pytest.mark.parametrize("seed,capacity", [(0, 4096), (1, 8), (2, 3),
                                           (3, 64)])
def test_tracer_equals_jax(seed, capacity):
    ticks, ops = _hook_script(seed)
    t = _play(Tracer, TEV.BUS, ticks, ops, capacity)
    j = _play(JTracer, JTEV.BUS, ticks, ops, capacity)
    assert [dataclasses.astuple(r) for r in t.records] == \
        [dataclasses.astuple(r) for r in j.records]
    assert list(t.blocks) == list(j.blocks)
    assert list(t.events) == list(j.events)
    assert t.dropped_requests == j.dropped_requests
    assert t.latency_summary() == j.latency_summary()
    meta = {"model": "x", "slots": 2}
    assert t.chrome_trace(metadata=meta) == j.chrome_trace(metadata=meta)
    counters = {"tokens_emitted": 17, "decode_s": 0.125, "flag": True,
                "device_pos": np.int32(9), "odd name-x": 3}
    doc = {"tokens_emitted": "tokens"}
    assert prometheus_text(counters, t.latency_summary(), doc=doc) == \
        j_prometheus_text(counters, j.latency_summary(), doc=doc)


@pytest.mark.parametrize("cell", CELLS)
def test_engine_hooks_equal_jax_engine(served, cell):
    """With a counting clock every hook call is one tick, so equal records
    and block spans mean the two engines fire the same hooks in the same
    order."""
    (jrec, jblk, jev, jlat), (trec, tblk, tev, tlat) = \
        served[cell]["jax"][3], served[cell]["port"][3]
    assert [dataclasses.astuple(r) for r in trec] == \
        [dataclasses.astuple(r) for r in jrec]
    assert len(trec) == 5
    assert tblk == jblk
    assert {b["mode"] for b in tblk} == \
        {"spec" if cell == "speculative" else "seq"}
    assert tev == jev == []
    assert tlat == jlat


# ------------------------------------------------------------ exports ----

def test_exports_pass_both_validators(served):
    teng = served["sequential"]["port"][0]
    doc = teng.chrome_trace()
    assert V.validate_chrome_trace(doc) == [] == \
        JV.validate_chrome_trace(doc)
    assert any(ev.get("cat") == "request" for ev in doc["traceEvents"])
    assert doc["metadata"]["metrics"] is True
    text = teng.metrics_text()
    assert V.validate_prometheus(text) == [] == JV.validate_prometheus(text)
    assert f"swat_device_tokens {5 * 11}" in text
    assert 'swat_ttft_seconds{quantile="0.95"}' in text
    snap = json.loads(json.dumps(teng.snapshot()))
    assert snap["device"]["tokens"] == teng.stats["tokens_emitted"]
    assert snap["ring_modulus"] == teng.ring_mod == 69
    assert snap["stats"]["tokens_delivered"] == 60
    assert snap["latency"]["ttft"]["count"] == 5


@pytest.mark.parametrize("doc", [
    [], {"traceEvents": [{"ph": "X"}]}, {"traceEvents": []},
    {"traceEvents": {}},
    {"traceEvents": [{"name": "a", "ph": "Q", "pid": 0, "tid": 0}]},
    {"traceEvents": [{"name": "a", "ph": "X", "pid": 0, "tid": 0, "ts": -1,
                      "dur": "1"}]},
    {"traceEvents": [3, {"name": "a", "ph": "i", "pid": 0, "tid": 0}]}],
    ids=lambda d: json.dumps(d)[:24])
def test_chrome_validators_reject_the_same_garbage(doc):
    problems = V.validate_chrome_trace(doc)
    assert problems and problems == JV.validate_chrome_trace(doc)


@pytest.mark.parametrize("text", [
    "", "no type line 1\n", "# TYPE a bogus\na 1\n", "# random comment\n",
    "# TYPE a counter\na one\n", "# TYPE a counter\nb 1\n"])
def test_prometheus_validators_reject_the_same_garbage(text):
    problems = V.validate_prometheus(text)
    assert problems and problems == JV.validate_prometheus(text)
    assert V.validate_prometheus(prometheus_text({"a_total": 3})) == []


# -------------------------------------------------------------- census ----

def _decode_records(census):
    return {tuple(sorted((k, v) for k, v in rec.items()
                         if k not in ("impl", "traces")))
            for rec in census if rec["op"] == "decode_attention"}


@pytest.mark.parametrize("cell", CELLS)
def test_census_equals_jax_engine(served, cell):
    jcensus, tcensus = served[cell]["jax"][2], served[cell]["port"][2]
    want = _decode_records(jcensus)
    assert want and _decode_records(tcensus) == want
    t = 3 if cell == "speculative" else 1
    assert {dict(r)["t"] for r in want} == {t}
    # CPU tensors run no kernel, so no kernel geometry is recorded
    assert {rec["op"] for rec in tcensus} == {"decode_attention"}


def test_census_is_off_by_default(setup):
    _, tcfg, _, tp, prompts = setup
    KP.consume_census()
    ServingEngine(tcfg, tp, **RECIPE).run(_reqs(prompts[:2], n_new=3))
    assert KP.consume_census() == []


def test_banded_decode_cost_equals_jax():
    for b, h_kv, group, t, d, window, g, cap, nbytes, fused in \
            itertools.product((1, 4), (1, 8), (1, 4), (1, 5), (64, 256),
                              (0, 16, 256), (0, 4), (64, 261, 4096),
                              (2, 4), (True, False)):
        kw = dict(b=b, h_q=h_kv * group, h_kv=h_kv, t=t, d=d, window=window,
                  num_global=g, cap=cap, dtype_bytes=nbytes, fused=fused)
        assert KP.banded_decode_cost(**kw) == JKP.banded_decode_cost(**kw)


def test_bound_ms_at_the_serve_decode_shape():
    """llama3.2-1b+SWAT's decode step (4 slots, 8 kv heads of 4 queries,
    D=64, a 261-row ring) is bound by its bytes: 2.18 MB over 3.35 TB/s."""
    cost = KP.banded_decode_cost(b=4, h_q=32, h_kv=8, t=1, d=64, window=256,
                                 num_global=4, cap=261)
    ms, by = KP.bound_ms(cost)
    assert by == "bytes"
    assert ms == pytest.approx(cost["hbm_bytes"] / 3.35e12 * 1e3)
    assert ms == pytest.approx(0.000651, rel=1e-3)
    flops_bound = KP.bound_ms({"hbm_bytes": 1.0, "flops": 67e9}, "float32")
    assert flops_bound == (pytest.approx(1.0), "operations")


def test_profile_decode_rows_on_cpu():
    sh = dict(b=2, h_kv=2, group=2, t=1, d=64, window=16, num_global=4,
              cap=64)
    (row,) = KP.profile_decode([sh], impl="ref", device="cpu", iters=2)
    assert row["device"] == "cpu" and row["bound_share"] is None
    assert row["p50_us"] > 0 and row["bound_by"] == "bytes"
    assert {k: row[k] for k in ("flops", "hbm_bytes", "band_rows")} == {
        k: v for k, v in JKP.banded_decode_cost(
            b=2, h_q=4, h_kv=2, t=1, d=64, window=16, num_global=4,
            cap=64).items() if k != "intensity"}
    with pytest.raises(ValueError):
        KP.profile_decode([sh], impl="kernel", device="cpu")


# ------------------------------------------------------------ launchers --

def test_serve_metrics_flags_write_valid_exports(tmp_path, capsys):
    trace, prom = tmp_path / "trace.json", tmp_path / "metrics.prom"
    rc = serve_launcher.main([
        "--arch", "llama3.2-1b", "--smoke", "--swat", "--window", "64",
        "--requests", "5", "--slots", "2", "--prompt-len", "70",
        "--new-tokens", "12", "--max-len", "256", "--device", "cpu",
        "--metrics", "--trace-out", str(trace), "--metrics-out", str(prom)])
    out = capsys.readouterr().out
    assert rc == 0
    assert "[serve] latency: ttft p50=" in out
    assert "tokens=55" in out and "quarantined=0" in out
    assert scope.main(["validate", "--trace", str(trace), "--metrics",
                       str(prom)]) == 0
    out = capsys.readouterr().out
    assert "valid chrome trace" in out
    assert "valid prometheus exposition" in out
    prom.write_text(prom.read_text() + "not a sample line\n")
    assert scope.main(["validate", "--metrics", str(prom)]) == 1
    assert "INVALID" in capsys.readouterr().out


def test_scope_census_and_profile_on_cpu(capsys):
    assert scope.main(["census", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "op=decode_attention" in out
    assert '"ring_modulus": 21' in out
    assert scope.main(["profile", "--device", "cpu", "--impl", "ref",
                       "--iters", "3"]) == 0
    out = capsys.readouterr().out
    assert "on cpu: p50=" in out and "H100 bound" in out
    assert scope.main(["profile", "--device", "cpu", "--impl",
                       "pallas"]) != 0


def test_scope_profile_refuses_to_run_without_a_card(capsys):
    if torch.cuda.is_available():
        return
    assert scope.main(["profile"]) != 0
    assert scope.main(["census"]) != 0
    assert "no CUDA device" in capsys.readouterr().err
