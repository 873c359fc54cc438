"""The port's resilient serving (`repro_torch.serving.faults` and the
engine's chaos carries, deadlines, backpressure, retries and step down)
held against the JAX package's engine on the CPU.

Each case mirrors a test of `tests/test_resilience.py` (and the chaos tests
of `test_paged.py` and `test_telemetry.py`) on the same smoke config
(llama3.2-1b smoke, plain and with SWAT window 16 + 4 globals), with the
JAX params carried across through `interop`: the port engine and the JAX
engine serve the same requests under the same plan, and their tokens,
statuses, kept-token counts, retries, `stats` and event kinds must be
equal. The kernel route reaches `swat_decode_fused` on the CPU by setting
the engine's route to "kernel" (on CPU tensors the wrapper runs its plain
version); `decode_impl="pallas"` stays a ValueError for CPU params.
"""
import collections
import warnings

import jax
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.configs import get_smoke_config, with_swat
from repro.core import model as JM
from repro.serving import faults as JF
from repro.serving.engine import Request as JRequest
from repro.serving.engine import ServingEngine as JEngine
from repro_torch import interop
from repro_torch.configs import get_smoke_config as t_smoke
from repro_torch.configs import with_swat as t_swat
from repro_torch.kernels import swat_decode as SD
from repro_torch.serving import faults as F
from repro_torch.serving.engine import (STATUSES, Request, Result,
                                        ServingEngine)
from repro_torch.serving.faults import FaultPlan, KernelDispatchError

torch.set_num_threads(1)


def _pair(swat: bool):
    cfg = get_smoke_config("llama3p2_1b")
    tcfg = t_smoke("llama3p2_1b")
    if swat:
        cfg = with_swat(cfg, window=16, num_global=4)
        tcfg = t_swat(tcfg, window=16, num_global=4)
    jp = JM.init_model(jax.random.PRNGKey(0), cfg)
    tp = interop.params_from_jax(jax.tree.map(np.asarray, jp), tcfg,
                                 device="cpu")
    return cfg, tcfg, jp, tp


@pytest.fixture(scope="module")
def setup():
    return _pair(swat=False)


@pytest.fixture(scope="module")
def swat_setup():
    return _pair(swat=True)


@pytest.fixture(autouse=True)
def _clean_buses():
    """Each test sees only its own degradation events; no test leaves the
    kernel failure armed."""
    F.consume_events()
    JF.consume_events()
    yield
    F.consume_events()
    JF.consume_events()
    F.clear_kernel_failure()
    JF.clear_kernel_failure()


def mkreqs(cfg, n=3, m=10, plen=12, cls=Request, **kw):
    return [cls(rid=i, prompt=np.random.RandomState(i).randint(
                0, cfg.vocab_size, (plen,)).astype(np.int32),
                max_new_tokens=m, **kw) for i in range(n)]


def by_rid(results):
    return {r.rid: r for r in results}


def _outcome(results):
    """(rid, status, tokens, retries) per request, rid order."""
    return [(r.rid, r.status, list(r.tokens), r.retries)
            for r in sorted(results, key=lambda r: r.rid)]


def _kinds(bus):
    return [e["kind"] for e in bus.consume_events()]


def _common_stats(teng, jeng):
    """The port's stats on the JAX engine's keys, and the JAX stats."""
    return {k: teng.stats[k] for k in jeng.stats}, dict(jeng.stats)


def _engines(s, faults=None, kernel=False, **kw):
    """A port engine and a JAX engine on the same config, params and plan.
    kernel=True: the port on the fused decode kernel's wrapper, the JAX
    engine on decode_impl="pallas"."""
    cfg, tcfg, jp, tp = s
    tplan = FaultPlan(**faults) if faults is not None else None
    jplan = JF.FaultPlan(**faults) if faults is not None else None
    jeng = JEngine(cfg, jp, faults=jplan,
                   decode_impl="pallas" if kernel else "ref", **kw)
    teng = ServingEngine(tcfg, tp, faults=tplan, **kw)
    if kernel:
        teng._impl = "kernel"
    return teng, jeng


def _serve_both(s, n=3, m=10, faults=None, kernel=False, **kw):
    """Both engines serve mkreqs(n, m) under `faults`. Returns (port
    engine, port results, port event kinds, JAX engine, its results, its
    event kinds); the JAX engine runs first, its kernel flag cleared
    before the port engine is made."""
    cfg = s[0]
    tplan = FaultPlan(**faults) if faults is not None else None
    jplan = JF.FaultPlan(**faults) if faults is not None else None
    try:
        jeng = JEngine(cfg, s[2], faults=jplan,
                       decode_impl="pallas" if kernel else "ref", **kw)
        jout = jeng.run(mkreqs(cfg, n, m, cls=JRequest))
    finally:
        JF.clear_kernel_failure()
    jkinds = _kinds(JF)
    try:
        teng = ServingEngine(s[1], s[3], faults=tplan, **kw)
        if kernel:
            teng._impl = "kernel"
        tout = teng.run(mkreqs(cfg, n, m))
    finally:
        F.clear_kernel_failure()
    return teng, tout, _kinds(F), jeng, jout, jkinds


def _assert_parity(teng, tout, tkinds, jeng, jout, jkinds):
    assert _outcome(tout) == _outcome(jout)
    assert [r.reason for r in sorted(tout, key=lambda r: r.rid)] == \
        [r.reason for r in sorted(jout, key=lambda r: r.rid)]
    got, want = _common_stats(teng, jeng)
    assert got == want
    assert tkinds == jkinds


# ------------------------------------------------ logit poison / quarantine

def test_statuses_taxonomy():
    from repro.serving.engine import STATUSES as JSTATUSES
    assert STATUSES == JSTATUSES == ("ok", "rejected", "poisoned",
                                     "deadline", "failed")
    assert Result(rid=0, tokens=[1]).ok
    assert Result(rid=0, tokens=[1]).retries == 0
    assert not Result(rid=0, tokens=[], status="rejected", reason="x").ok


def test_clean_run_emits_no_events_and_default_plan_is_inert(setup):
    plan = FaultPlan()
    assert not plan.any and not plan.has_logit_faults
    run = _serve_both(setup, batch_slots=2, max_len=64, scan_steps=4)
    _assert_parity(*run)
    teng, tout, tkinds = run[:3]
    assert all(r.status == "ok" and r.reason == "" for r in tout)
    assert tkinds == []
    assert teng.stats["quarantined"] == teng.stats["kernel_fallbacks"] == 0


def test_nan_quarantine_healthy_slots_bitwise(setup):
    """NaN on slot 0 at token 4: that request ends "poisoned" with exactly
    its 4 clean tokens, the request refilling the slot decodes clean, and
    the rest are bitwise the fault-free run (and the JAX engine's)."""
    clean = by_rid(_serve_both(setup, batch_slots=2, max_len=64,
                               scan_steps=4)[1])
    run = _serve_both(setup, batch_slots=2, max_len=64, scan_steps=4,
                      faults=dict(poison_logits=((0, 4, "nan"),)))
    _assert_parity(*run)
    out = by_rid(run[1])
    assert out[0].status == "poisoned" and len(out[0].tokens) == 4
    assert "quarantined" in out[0].reason
    assert out[0].tokens == clean[0].tokens[:4]
    assert out[1].status == "ok" and out[1].tokens == clean[1].tokens
    assert out[2].status == "ok" and out[2].tokens == clean[2].tokens
    assert run[0].stats["quarantined"] == 1
    assert run[2] == ["slot_quarantined"]


def test_inf_quarantine_kernel_route(swat_setup):
    """The same contract on the fused decode kernel's route (+Inf), against
    the JAX engine on its Pallas route."""
    kw = dict(batch_slots=2, max_len=64, scan_steps=2)
    clean = by_rid(_serve_both(swat_setup, m=8, kernel=True, **kw)[1])
    run = _serve_both(swat_setup, m=8, kernel=True,
                      faults=dict(poison_logits=((1, 3, "inf"),)), **kw)
    _assert_parity(*run)
    out = by_rid(run[1])
    assert out[1].status == "poisoned" and len(out[1].tokens) == 3
    assert out[1].tokens == clean[1].tokens[:3]
    for i in (0, 2):
        assert out[i].status == "ok" and out[i].tokens == clean[i].tokens


def test_spec_quarantine_exact_count_parity(setup):
    """The verify body poisons one window position, so the speculative
    engine keeps exactly the trigger index of tokens, as the sequential
    engine does."""
    kw = dict(batch_slots=2, max_len=64, scan_steps=4)
    clean = by_rid(_serve_both(setup, speculative=2, **kw)[1])
    plan = dict(poison_logits=((1, 6, "nan"),))
    for extra in ({"speculative": 2}, {}):
        run = _serve_both(setup, faults=plan, **kw, **extra)
        _assert_parity(*run)
        out = by_rid(run[1])
        assert out[1].status == "poisoned" and len(out[1].tokens) == 6
        assert out[1].tokens == clean[1].tokens[:6]
        assert out[0].tokens == clean[0].tokens
        assert out[2].tokens == clean[2].tokens


def test_corrupt_drafts_token_identical(setup):
    """Out-of-vocab drafts are clipped and fail verification: no draft is
    kept, and the tokens are the clean speculative run's."""
    kw = dict(batch_slots=2, max_len=64, scan_steps=4, speculative=2)
    clean_run = _serve_both(setup, **kw)
    clean = by_rid(clean_run[1])
    run = _serve_both(setup, faults=dict(corrupt_draft_slots=(0, 1)), **kw)
    _assert_parity(*run)
    out = by_rid(run[1])
    for i in range(3):
        assert out[i].status == "ok" and out[i].tokens == clean[i].tokens
    assert run[0].stats["draft_accepted"] == 0
    assert clean_run[0].stats["draft_accepted"] > 0


def test_cache_poison_quarantine(setup):
    """NaN over a slot's K caches between blocks surfaces as non-finite
    logits at its next step: the slot is quarantined after a clean prefix,
    the others stay bitwise."""
    kw = dict(batch_slots=2, max_len=64, scan_steps=4)
    clean = by_rid(_serve_both(setup, **kw)[1])
    run = _serve_both(setup, faults=dict(poison_cache=((0, 3),)), **kw)
    _assert_parity(*run)
    out = by_rid(run[1])
    assert out[0].status == "poisoned"
    assert 3 <= len(out[0].tokens) < 10
    assert out[0].tokens == clean[0].tokens[:len(out[0].tokens)]
    for i in (1, 2):
        assert out[i].status == "ok" and out[i].tokens == clean[i].tokens
    assert "cache_poisoned" in run[2] and "slot_quarantined" in run[2]


# ------------------------------------------------- the step down


def test_dispatch_failure_falls_back_to_ref(swat_setup):
    """The injected dispatch failure does not end the batch: the engine
    steps down to the plain version (counted, on the bus, warned once) and
    its tokens are the plain engine's, as the JAX engine's are."""
    kw = dict(batch_slots=2, max_len=64, scan_steps=2)
    ref = by_rid(_serve_both(swat_setup, m=8, **kw)[1])
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        run = _serve_both(swat_setup, m=8, kernel=True,
                          faults=dict(fail_pallas_dispatch=True), **kw)
    _assert_parity(*run)
    teng, tout = run[:2]
    assert teng.decode_impl == "ref" and teng._impl == "ref"
    assert teng.stats["kernel_fallbacks"] == 1
    for r in tout:
        assert r.status == "ok" and r.tokens == ref[r.rid].tokens
    ours = [x for x in w if issubclass(x.category, RuntimeWarning)
            and "plain version" in str(x.message)]
    assert len(ours) == 1, "the step-down warning is one-time"
    assert run[2].count("pallas_fallback") == 1
    assert not SD._FORCE_FAIL


def test_kernel_failure_primitive_arms_and_clears():
    """Armed, both decode wrappers raise KernelDispatchError at entry,
    before touching an operand; cleared, the flag is off."""
    F.install_kernel_failure()
    try:
        with pytest.raises(KernelDispatchError, match="injected"):
            SD.swat_decode_fused(None, None, None, None, None, None, None,
                                 None)
        with pytest.raises(KernelDispatchError, match="injected"):
            SD.swat_decode_plain(None, None, None, None, None)
    finally:
        F.clear_kernel_failure()
    assert SD._FORCE_FAIL is False


def _state(eng):
    leaves = [t.clone() for blk in eng.caches for layer in blk.values()
              for t in layer.values()]
    return leaves + [t.clone() for t in eng._dev.values()]


@pytest.mark.parametrize("speculative", [0, 2], ids=["sequential",
                                                     "speculative"])
def test_raising_block_writes_nothing(swat_setup, speculative):
    """The injected failure raises at the first layer's wrapper entry: the
    caches, their steps and the staged vectors are bitwise as they were,
    and the version counters (the engine's test for a written block) have
    not moved."""
    _, tcfg, _, tp = swat_setup
    eng = ServingEngine(tcfg, tp, batch_slots=2, max_len=64, scan_steps=4,
                        speculative=speculative)
    eng._impl = "kernel"
    eng._admit(collections.deque(mkreqs(tcfg, n=2, m=8)))
    eng._stage()
    live = [0, 1]
    before, mark = _state(eng), eng._cache_versions()
    F.install_kernel_failure()
    try:
        with pytest.raises(KernelDispatchError):
            if speculative:
                eng._verify_steps(2, live, False)
            else:
                eng._decode_steps(2, live)
    finally:
        F.clear_kernel_failure()
    after = _state(eng)
    assert all(torch.equal(a, b) for a, b in zip(before, after))
    assert eng._cache_versions() == mark


@pytest.mark.parametrize("when", ["at_entry", "after_write"])
def test_step_down_branches(swat_setup, monkeypatch, when):
    """Both branches of the step down through the run loop. at_entry: the
    armed flag raises before anything is written, the block reruns on the
    plain version and every request ends ok with the plain engine's
    tokens. after_write: the wrapper raises at the second layer, after the
    first wrote its ring and step; the engine sees the written caches,
    readmits the request with a retry left (re-served from its prompt) and
    finalizes the other "failed"."""
    _, tcfg, _, tp = swat_setup
    kw = dict(batch_slots=2, max_len=64, scan_steps=2)
    reqs = lambda: [Request(rid=r.rid, prompt=r.prompt, max_new_tokens=8,
                            max_retries=1 - r.rid)
                    for r in mkreqs(tcfg, n=2, m=8)]
    ref = by_rid(ServingEngine(tcfg, tp, **kw).run(reqs()))
    eng = ServingEngine(tcfg, tp, **kw)
    eng._impl = "kernel"
    if when == "at_entry":
        F.install_kernel_failure()
    else:
        real, calls = SD.swat_decode_fused, [0]

        def second_layer_fails(*a, **k):
            calls[0] += 1
            if calls[0] == 2:
                raise KernelDispatchError("fails after the first layer")
            return real(*a, **k)
        monkeypatch.setattr(SD, "swat_decode_fused", second_layer_fails)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        out = by_rid(eng.run(reqs()))
    assert eng.stats["kernel_fallbacks"] == 1 and eng.decode_impl == "ref"
    if when == "at_entry":
        assert [out[i].status for i in (0, 1)] == ["ok", "ok"]
        assert all(out[i].tokens == ref[i].tokens for i in (0, 1))
        assert eng.stats["readmitted"] == eng.stats["failed"] == 0
    else:
        assert out[0].status == "ok" and out[0].retries == 1
        assert out[0].tokens == ref[0].tokens
        assert out[1].status == "failed" and out[1].retries == 0
        assert "after cache donation" in out[1].reason
        assert eng.stats["readmitted"] == eng.stats["failed"] == 1
        kinds = _kinds(F)
        assert kinds[:3] == ["pallas_fallback", "request_readmitted",
                             "request_failed"]


def test_spec_autodisable_and_probe_resume(setup):
    """The acceptance ladder turns speculation off, probes and resumes,
    with the JAX engine's counts and events, and the sequential engine's
    tokens."""
    kw = dict(batch_slots=2, max_len=128, scan_steps=4, speculative=2,
              spec_min_acceptance=0.95, spec_acceptance_window=2,
              spec_retry_blocks=2, spec_resume_acceptance=0.0)
    run = _serve_both(setup, n=2, m=40, **kw)
    _assert_parity(*run)
    teng, tout, tkinds = run[:3]
    assert all(r.status == "ok" and len(r.tokens) == 40 for r in tout)
    assert teng.stats["spec_autodisable"] >= 1
    assert teng.stats["spec_resume"] >= 1
    assert "spec_autodisable" in tkinds and "spec_resume" in tkinds
    seq = by_rid(ServingEngine(setup[1], setup[3], batch_slots=2,
                               max_len=128, scan_steps=4)
                 .run(mkreqs(setup[0], n=2, m=40)))
    for r in tout:
        assert r.tokens == seq[r.rid].tokens


# -------------------------------------------- admission / queue resilience


def test_malformed_prompts_rejected_per_request(setup):
    """Every malformed flavor ends "rejected" with a reason naming it (the
    same reasons as the JAX engine's), and the healthy requests serve."""
    cfg, tcfg, jp, tp = setup
    bad = F.malformed_prompts(cfg.vocab_size, oversize=40)
    jbad = JF.malformed_prompts(cfg.vocab_size, oversize=40)
    assert len(bad) == len(jbad) >= 4
    for (a, fa), (b, fb) in zip(bad, jbad):
        assert fa == fb and np.array_equal(a, b)
    kw = dict(batch_slots=2, max_len=64, scan_steps=2, max_prompt_len=32)
    teng, jeng = _engines(setup, **kw)
    tout = teng.run(mkreqs(cfg, n=2, m=4) + [
        Request(rid=10 + j, prompt=p, max_new_tokens=4)
        for j, (p, _) in enumerate(bad)])
    jout = jeng.run(mkreqs(cfg, n=2, m=4, cls=JRequest) + [
        JRequest(rid=10 + j, prompt=p, max_new_tokens=4)
        for j, (p, _) in enumerate(jbad)])
    _assert_parity(teng, tout, _kinds(F), jeng, jout, _kinds(JF))
    out = by_rid(tout)
    assert out[0].status == "ok" and out[1].status == "ok"
    for j, (_, flavor) in enumerate(bad):
        r = out[10 + j]
        assert r.status == "rejected" and r.tokens == []
        assert flavor in r.reason, (flavor, r.reason)
    assert teng.stats["rejected"] == len(bad)


def test_oversized_prompt_admissible_by_default(setup):
    cfg = setup[0]
    teng, jeng = _engines(setup, batch_slots=1, max_len=64, scan_steps=2)
    long_prompt = np.random.RandomState(0).randint(
        0, cfg.vocab_size, (80,)).astype(np.int32)
    tout = teng.run([Request(rid=0, prompt=long_prompt, max_new_tokens=4)])
    jout = jeng.run([JRequest(rid=0, prompt=long_prompt, max_new_tokens=4)])
    assert _outcome(tout) == _outcome(jout)
    assert tout[0].status == "ok" and len(tout[0].tokens) == 4


def test_backpressure_bounded_queue(setup):
    """Beyond max_pending queued requests the tail is rejected ("queue
    overflow"); the head serves."""
    run = _serve_both(setup, n=8, m=4, batch_slots=2, max_len=64,
                      scan_steps=2, max_pending=3)
    _assert_parity(*run)
    out = by_rid(run[1])
    assert [out[i].status for i in range(8)] == ["ok"] * 3 + ["rejected"] * 5
    for i in range(3, 8):
        assert "queue overflow" in out[i].reason
    assert run[0].stats["rejected"] == 5


def test_deadline_expires_queued_request(setup):
    cfg = setup[0]
    teng, jeng = _engines(setup, batch_slots=1, max_len=64, scan_steps=2)

    def reqs(cls):
        r = mkreqs(cfg, n=2, m=6, cls=cls)
        r[1] = cls(rid=1, prompt=r[1].prompt, max_new_tokens=6,
                   deadline=1e-9)
        return r
    tout, jout = teng.run(reqs(Request)), jeng.run(reqs(JRequest))
    _assert_parity(teng, tout, _kinds(F), jeng, jout, _kinds(JF))
    out = by_rid(tout)
    assert out[0].status == "ok" and len(out[0].tokens) == 6
    assert out[1].status == "deadline" and out[1].tokens == []
    assert teng.stats["deadline"] == 1


def _fake_clock(monkeypatch, module):
    """Replace `module.time` with a clock whose monotonic() advances 0.1 a
    reading; perf_counter() (the port's stats clock) stays real."""
    import time as real_time
    now = {"t": 0.0}

    class _Clock:
        perf_counter = staticmethod(real_time.perf_counter)

        @staticmethod
        def monotonic():
            now["t"] += 0.1
            return now["t"]

    monkeypatch.setattr(module + ".time", _Clock)


def test_deadline_expires_live_slot_with_partial_tokens(setup, monkeypatch):
    """A live slot past its deadline ends "deadline" with what it emitted,
    at the same block boundary as in the JAX engine (both clocks advance
    0.1 a reading), and its slot is freed."""
    cfg = setup[0]
    _fake_clock(monkeypatch, "repro.serving.engine")
    _fake_clock(monkeypatch, "repro_torch.serving.engine")
    teng, jeng = _engines(setup, batch_slots=1, max_len=128, scan_steps=2)
    prompt = np.random.RandomState(7).randint(
        0, cfg.vocab_size, (12,)).astype(np.int32)
    tout = teng.run([Request(rid=0, prompt=prompt, max_new_tokens=400,
                             deadline=0.35)])
    jout = jeng.run([JRequest(rid=0, prompt=prompt, max_new_tokens=400,
                              deadline=0.35)])
    _assert_parity(teng, tout, _kinds(F), jeng, jout, _kinds(JF))
    assert tout[0].status == "deadline" and "deadline" in tout[0].reason
    assert 0 < len(tout[0].tokens) < 400
    assert teng.stats["deadline"] == 1
    assert teng.slot_free == [True]


def test_run_flushes_completed_results_on_exception(setup):
    """Results finished before an exception mid-run survive it in
    `take_completed()`."""
    cfg, tcfg, _, tp = setup
    eng = ServingEngine(tcfg, tp, batch_slots=1, max_len=64, scan_steps=2)
    calls = {"n": 0}
    real_plan = eng.scheduler.plan

    def exploding_plan(pending, num_free):
        calls["n"] += 1
        if calls["n"] > 1:
            raise RuntimeError("scheduler exploded mid-run")
        return real_plan(pending, num_free)

    eng.scheduler.plan = exploding_plan
    with pytest.raises(RuntimeError, match="exploded"):
        eng.run(mkreqs(cfg, n=2, m=4))
    rescued = eng.take_completed()
    assert [r.rid for r in rescued] == [0]
    assert rescued[0].status == "ok" and len(rescued[0].tokens) == 4


# --------------------------------------------------------- paged chaos ----

def _paged_reqs(cfg, seed, n, budget, cls=Request):
    rng = np.random.RandomState(seed)
    return [cls(rid=i, prompt=rng.randint(0, cfg.vocab_size, (int(L),))
                .astype(np.int32), max_new_tokens=budget)
            for i, L in enumerate(rng.randint(8, 40, n))]


def test_paged_chaos_quarantine(swat_setup):
    """Cache poison on a paged slot quarantines only that slot (its blocks
    are made private first), as in the JAX engine."""
    cfg = swat_setup[0]
    kw = dict(batch_slots=3, max_len=256, kv_layout="paged")
    results = {}
    for plan in (None, dict(poison_cache=((1, 3),))):
        teng, jeng = _engines(swat_setup, faults=plan, **kw)
        tout = teng.run(_paged_reqs(cfg, 5, 3, 10))
        jout = jeng.run(_paged_reqs(cfg, 5, 3, 10, cls=JRequest))
        _assert_parity(teng, tout, _kinds(F), jeng, jout, _kinds(JF))
        results[plan is None] = by_rid(tout)
    clean, hurt = results[True], results[False]
    assert hurt[1].status == "poisoned"
    assert hurt[1].tokens == clean[1].tokens[:len(hurt[1].tokens)]
    for rid in (0, 2):
        assert hurt[rid].status == "ok"
        assert hurt[rid].tokens == clean[rid].tokens


def test_shared_prefix_cache_poison_spares_sharers(swat_setup):
    """On the shared-prefix paged cell the poisoned request's blocks are
    made private before the NaN: every sharer of its prefix blocks ends ok
    with the clean tokens, as in the JAX engine."""
    cfg = swat_setup[0]
    rng = np.random.RandomState(7)
    sys_p = rng.randint(0, cfg.vocab_size, (48,)).astype(np.int32)
    prompts = [np.concatenate([sys_p, rng.randint(0, cfg.vocab_size, (8,))
                               .astype(np.int32)]) for _ in range(4)]
    kw = dict(batch_slots=4, max_len=256, kv_layout="paged",
              prefill_chunk=16, share_prefix=True, scan_steps=2)
    results = {}
    for plan in (None, dict(poison_cache=((1, 3),))):
        teng, jeng = _engines(swat_setup, faults=plan, **kw)
        tout = teng.run([Request(rid=i, prompt=p, max_new_tokens=8)
                         for i, p in enumerate(prompts)])
        jout = jeng.run([JRequest(rid=i, prompt=p, max_new_tokens=8)
                         for i, p in enumerate(prompts)])
        _assert_parity(teng, tout, _kinds(F), jeng, jout, _kinds(JF))
        assert teng.stats["prefill_prefix_shared"] == 1
        results[plan is None] = by_rid(tout)
    clean, hurt = results[True], results[False]
    assert hurt[1].status == "poisoned"
    for rid in (0, 2, 3):
        assert hurt[rid].status == "ok"
        assert hurt[rid].tokens == clean[rid].tokens


def _lose_state(teng, jeng, n):
    """Simulate a failure after the block wrote the caches: the JAX test
    deletes the donated leaves; here the caches are overwritten with NaN
    (what a half-run block could leave) and the step down is told the
    state is lost. Returns (port Results, JAX Results) it finalized."""
    for leaf in jax.tree.leaves(jeng.caches):
        leaf.delete()
    for blk in teng.caches:
        for layer in blk.values():
            for name in ("k", "v", "pk", "pv"):
                if name in layer:
                    layer[name].fill_(float("nan"))
    with pytest.warns(RuntimeWarning):
        jdone = jeng._kernel_fallback(RuntimeError("boom"), n)
    with pytest.warns(RuntimeWarning):
        tdone = teng._kernel_fallback(RuntimeError("boom"), n, lost=True)
    return tdone, jdone


@pytest.mark.parametrize("layout", ["contiguous", "paged"])
def test_retry_readmission_after_cache_loss(layout, swat_setup):
    """A failure after the caches were written finalizes slots "failed",
    unless the request has retries left: then it is readmitted through the
    queue and served again from its prompt, its retries on the Result."""
    cfg, tcfg, jp, tp = swat_setup
    rng = np.random.RandomState(11)
    prompts = [rng.randint(0, cfg.vocab_size, (12,)).astype(np.int32)
               for _ in range(2)]

    def reqs(cls):
        return [cls(rid=0, prompt=prompts[0], max_new_tokens=8,
                    max_retries=1),
                cls(rid=1, prompt=prompts[1], max_new_tokens=8)]
    teng, jeng = _engines(swat_setup, batch_slots=2, max_len=256,
                          kv_layout=layout)
    for eng, cls in ((teng, Request), (jeng, JRequest)):
        eng._run_t0 = 0.0
        eng._admit(collections.deque(reqs(cls)))
        eng._decode_block(2)
    tdone, jdone = _lose_state(teng, jeng, 2)
    results = []
    for eng, done in ((teng, tdone), (jeng, jdone)):
        eng._run_t0 = None
        rest = eng.run([])
        results.append(done + rest + eng.take_completed())
    _assert_parity(teng, results[0], _kinds(F), jeng, results[1], _kinds(JF))
    res = by_rid(results[0])
    assert res[1].status == "failed" and res[1].retries == 0
    assert res[0].status == "ok" and res[0].retries == 1
    assert teng.stats["readmitted"] == 1
    clean = ServingEngine(tcfg, tp, batch_slots=2, max_len=256).run(
        [Request(rid=0, prompt=prompts[0], max_new_tokens=8)])
    assert res[0].tokens == clean[0].tokens


def test_retry_zero_still_fails(swat_setup):
    cfg = swat_setup[0]
    rng = np.random.RandomState(12)
    prompt = rng.randint(0, cfg.vocab_size, (10,)).astype(np.int32)
    teng, jeng = _engines(swat_setup, batch_slots=1, max_len=256,
                          kv_layout="paged")
    for eng, cls in ((teng, Request), (jeng, JRequest)):
        eng._run_t0 = 0.0
        eng._admit(collections.deque([cls(rid=0, prompt=prompt,
                                          max_new_tokens=8)]))
    tdone, jdone = _lose_state(teng, jeng, 1)
    assert _outcome(tdone) == _outcome(jdone)
    assert tdone[0].status == "failed" and tdone[0].retries == 0
    assert all(teng.slot_free) and teng.paged_stats()["blocks_in_use"] == 0


# ------------------------------------------------- telemetry under chaos --

def test_metrics_identity_under_chaos(setup):
    """With the counters on, the quarantine path gives the metrics-off
    engine's statuses and tokens, and the counter sees the quarantine."""
    kw = dict(batch_slots=2, max_len=64, scan_steps=4,
              faults=dict(poison_logits=((0, 3, "nan"),)))
    off = _serve_both(setup, **kw)
    on = _serve_both(setup, metrics=True, **kw)
    _assert_parity(*on)
    assert _outcome(on[1]) == _outcome(off[1])
    dev = on[0].device_metrics()
    assert dev["quarantined"] == 1 == on[0].stats["quarantined"]
    assert dev["quarantined"] == on[3].device_metrics()["quarantined"]


def test_retry_never_double_counts_delivered(swat_setup):
    """A step down reruns the block on the plain version: tokens_delivered
    equals the tokens the clients got, the tracer records each request's
    tokens once, and the device counters still equal the host oracle."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        run = _serve_both(swat_setup, m=8, kernel=True, metrics=True,
                          faults=dict(fail_pallas_dispatch=True),
                          batch_slots=2, max_len=64, scan_steps=2)
    _assert_parity(*run)
    eng, out = run[:2]
    assert eng.stats["kernel_fallbacks"] == 1
    assert all(r.status == "ok" for r in out)
    assert eng.stats["tokens_delivered"] == sum(len(r.tokens) for r in out)
    recs = {r.rid: r for r in eng.tracer.records}
    assert all(recs[r.rid].tokens == len(r.tokens) for r in out)
    dev = eng.device_metrics()
    assert dev["tokens"] == dev["pos"] == eng.stats["tokens_emitted"]
    assert dev["quarantined"] == 0
    assert dev == run[3].device_metrics()


def test_quarantine_event_reaches_tracer(setup):
    teng, _ = _engines(setup, batch_slots=2, max_len=64, scan_steps=4,
                       faults=dict(poison_logits=((0, 3, "nan"),)))
    teng.run(mkreqs(setup[0]))
    kinds = [e["kind"] for e in teng.tracer.events]
    assert "slot_quarantined" in kinds
    names = [ev["name"] for ev in teng.chrome_trace()["traceEvents"]]
    assert "slot_quarantined" in names


# ------------------------------------------- the production bodies ----

class _OpLog(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops[str(func)] += 1
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("speculative", [0, 2], ids=["sequential",
                                                     "speculative"])
def test_plan_off_runs_the_production_bodies(setup, speculative):
    """An engine with FaultPlan() runs exactly the operations of one with
    no plan (the bodies it would capture are the production ones), and a
    logit-fault plan that never fires only adds its countdown and select."""
    _, tcfg, _, tp = setup
    logs = []
    for plan in (None, FaultPlan(),
                 FaultPlan(poison_logits=((0, 10 ** 6, "nan"),))):
        eng = ServingEngine(tcfg, tp, batch_slots=2, max_len=64,
                            scan_steps=4, speculative=speculative,
                            faults=plan)
        with _OpLog() as log:
            out = eng.run(mkreqs(tcfg, n=2, m=6))
        assert all(r.status == "ok" for r in out)
        logs.append((log.ops, [r.tokens for r in out]))
    (none, tn), (off, to), (armed, ta) = logs
    assert off == none and to == tn
    assert ta == tn and not none - armed
    assert {op.split(".")[1] for op in armed - none} <= {
        "where", "eq", "bitwise_and", "logical_and", "sub", "_to_copy",
        "copy_", "ge", "lt", "arange", "unsqueeze", "view", "expand",
        "slice", "select", "index_put_", "_index_put_impl_", "clone",
        "lift_fresh", "empty", "fill_", "rsub"}, armed - none
