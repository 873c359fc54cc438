"""The serving engine's compiled dispatch, held on the CPU.

On the card the engine replays decode blocks, verify steps and prefill
chunks as captured CUDA graphs; a graph reads and writes fixed storage, so
every carry must be updated in place. On the CPU the engine runs the same
functions eagerly, which is where this file holds them:

  * the in-place contract: over whole runs of the contiguous sequential,
    speculative, chunked, paged and shared-prefix engines, every cache
    leaf, every step, the staged per-slot vectors, the drafter history and
    the chunked-prefill buffers stay the same tensors in the same storage,
    and the greedy tokens equal the JAX engine's;
  * the greedy-only sampler branch: bitwise the full sampler's greedy rows
    and the JAX sampler's greedy branch, drawing nothing; the engine's
    host predicate is the JAX engine's `np.any((temps > 0) & active)`;
  * `graphs=True` on CPU params raises ValueError;
  * the graph cache, with the capture stubbed: each (n, slots, greedy-only)
    key (and each verify and chunk key) is captured once, at its second
    use, and replayed from then on, with tokens unchanged; chunk graphs
    are bounded (least recently used dropped, captured again at the next
    use), and batches of every row count share one chunked-prefill set.
"""
import collections

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.configs import get_smoke_config, with_swat
from repro.core import model as JM
from repro.serving import sampling as JS
from repro.serving.engine import Request as JRequest
from repro.serving.engine import ServingEngine as JEngine
from repro_torch import interop
from repro_torch.configs import get_smoke_config as t_smoke
from repro_torch.configs import with_swat as t_swat
from repro_torch.serving import engine as E
from repro_torch.serving import sampling
from repro_torch.serving.engine import Request, ServingEngine

torch.set_num_threads(1)

BUDGET = 8
# engine arguments of each case; "paged_shared" serves prompts behind one
# 24-token system prompt
CASES = {
    "sequential": {},
    "speculative": {"speculative": 2},
    "chunked": {"prefill_chunk": 16},
    "paged": {"kv_layout": "paged", "speculative": 2},
    "paged_shared": {"kv_layout": "paged", "prefill_chunk": 16,
                     "share_prefix": True},
}


@pytest.fixture(scope="module")
def setup():
    cfg = with_swat(get_smoke_config("llama3.2-1b"), window=16, num_global=4)
    tcfg = t_swat(t_smoke("llama3.2-1b"), window=16, num_global=4)
    jp = JM.init_model(jax.random.PRNGKey(0), cfg)
    tp = interop.params_from_jax(jax.tree.map(np.asarray, jp), tcfg,
                                 device="cpu")
    return cfg, tcfg, jp, tp


def _prompts(cfg, case):
    rng = np.random.RandomState(3)
    if case == "paged_shared":
        sys_p = rng.randint(0, cfg.vocab_size, (24,))
        return [np.concatenate([sys_p, rng.randint(0, cfg.vocab_size, (8,))])
                .astype(np.int32) for _ in range(4)]
    return [rng.randint(0, cfg.vocab_size, (n,)).astype(np.int32)
            for n in (37, 21, 44, 30)]


def _carries(eng):
    """Every tensor a compiled dispatch reads and writes, by name."""
    out = {}
    for b, blk in enumerate(eng.caches):
        for name, layer in blk.items():
            for leaf, t in layer.items():
                out[f"caches/{b}/{name}/{leaf}"] = t
    out.update({f"dev/{k}": t for k, t in eng._dev.items()})
    out.update(toks=eng._toks, emit=eng._emit, sidx=eng._sidx,
               flip=eng._flip, active0=eng._active0)
    if eng.drafter is not None:
        out.update(hist=eng.slot_hist, hcnt=eng.slot_hcnt)
    if eng._chunk_buf is not None:
        buf, = eng._chunk_buf
        for b, blk in enumerate(buf["caches"]):
            for name, layer in blk.items():
                for leaf, t in layer.items():
                    out[f"chunk/{b}/{name}/{leaf}"] = t
        out.update({f"chunk/{k}": buf[k] for k in ("last", "tok", "lens")})
    return out


def _same_storage(before, after):
    """Same names, and each the same tensor object in the same storage
    (the old tensors stay referenced, so their storage cannot be reused by
    a rebound one)."""
    assert sorted(before) == sorted(after)
    moved = [k for k in before
             if after[k] is not before[k]
             or after[k].data_ptr() != before[k].data_ptr()]
    assert not moved, moved


def _serve(eng, req_cls, prompts):
    res = eng.run([req_cls(rid=i, prompt=p, max_new_tokens=BUDGET)
                   for i, p in enumerate(prompts)])
    return {r.rid: r.tokens for r in res}


@pytest.mark.parametrize("case", sorted(CASES))
def test_carries_stay_in_place_and_tokens_equal_jax(setup, case):
    """Two runs of the same requests on one engine: the first creates the
    chunked-prefill buffers, so the engine's carries are compared across
    the first run and every carry, those buffers included, across the
    second. Both runs' greedy tokens equal the JAX engine's."""
    cfg, tcfg, jp, tp = setup
    kw = {"batch_slots": 2, "max_len": 256, "scan_steps": 4, **CASES[case]}
    prompts = _prompts(cfg, case)
    eng = ServingEngine(tcfg, tp, **kw)
    assert not eng.graphs
    first = _carries(eng)
    got = _serve(eng, Request, prompts)
    shared = eng.stats["prefill_prefix_shared"]
    after = _carries(eng)
    _same_storage(first, {k: after[k] for k in first})
    assert eng._chunk_buf or not kw.get("prefill_chunk")
    again = _serve(eng, Request, prompts)
    _same_storage(after, _carries(eng))
    want = _serve(JEngine(cfg, jp, **kw), JRequest, prompts)
    assert got == want
    assert again == want
    if kw.get("speculative"):
        assert eng.stats["spec_steps"] > 0
    if kw.get("share_prefix"):
        assert shared == 2


@settings(deadline=None, max_examples=40)
@given(st.integers(1, 6), st.integers(2, 300), st.integers(0, 2 ** 31 - 1),
       st.integers(0, 5))
def test_greedy_only_branch_is_bitwise_the_greedy_rows(b, v, seed, top_k):
    """any_sampling=False: one argmax, bitwise the full sampler's rows at
    temperature <= 0 (at any top_k) and the JAX sampler's greedy branch;
    the generator does not advance. All-greedy temperatures make the two
    paths equal on every row."""
    rng = np.random.RandomState(seed % (2 ** 31))
    logits = rng.randn(b, v).astype(np.float32)
    # ties: the argmax takes the first maximum in both paths
    logits[:, rng.randint(v)] = logits.max(axis=1)
    temps = np.where(rng.rand(b) < 0.5, 0.0, 1.5).astype(np.float32)
    lt, tt = torch.from_numpy(logits), torch.from_numpy(temps)
    gen = torch.Generator().manual_seed(seed)
    state = gen.get_state()
    fast = sampling.sample(gen, lt, tt, top_k, any_sampling=False)
    assert torch.equal(gen.get_state(), state)
    full = sampling.sample(torch.Generator().manual_seed(seed), lt, tt,
                           top_k, any_sampling=True)
    greedy = temps <= 0
    assert torch.equal(fast[torch.from_numpy(greedy)],
                       full[torch.from_numpy(greedy)])
    cold = sampling.sample(torch.Generator().manual_seed(seed), lt,
                           torch.zeros(b), top_k, any_sampling=True)
    assert torch.equal(fast, cold)
    jfast = JS.sample(jax.random.PRNGKey(0), jnp.asarray(logits),
                      jnp.asarray(temps), top_k, any_sampling=False)
    np.testing.assert_array_equal(fast.numpy(), np.asarray(jfast))


@settings(deadline=None, max_examples=40)
@given(st.lists(st.tuples(st.booleans(), st.sampled_from([0.0, 0.0, 0.7,
                                                           -1.0, 2.0])),
                min_size=3, max_size=3))
def test_host_predicate_is_the_jax_engines(setup, slots):
    """After an admission the engine restages the per-slot vectors into
    their static buffers (same storage) and computes the sampler's branch
    on the host as the JAX engine does: any((temps > 0) & active)."""
    _, tcfg, _, tp = setup
    eng = ServingEngine(tcfg, tp, batch_slots=3, max_len=64)
    before = dict(eng._dev)
    free = [not a for a, _ in slots]
    temps = np.asarray([t for _, t in slots], np.float32)
    eng.slot_free = free
    eng.slot_temp = temps
    eng.slot_last = np.arange(3, dtype=np.int32) + 7
    eng.slot_budget = np.asarray([3, 1, 4], np.int32)
    eng._stale = True
    eng._stage()
    active = ~np.asarray(free)
    assert eng._anyt == bool(np.any((temps > 0) & active))
    _same_storage(before, eng._dev)
    np.testing.assert_array_equal(eng._dev["active"].numpy(), active)
    np.testing.assert_array_equal(eng._dev["temps"].numpy(), temps)
    np.testing.assert_array_equal(eng._dev["tok"].numpy(), eng.slot_last)
    assert not eng._dev["poisoned"].any()


def test_graphs_true_on_cpu_params_raises(setup):
    _, tcfg, _, tp = setup
    with pytest.raises(ValueError, match="CUDA graphs"):
        ServingEngine(tcfg, tp, batch_slots=2, max_len=64, graphs=True)
    assert not ServingEngine(tcfg, tp, batch_slots=2, max_len=64,
                             graphs=False).graphs


class _StubGraph:
    """Stands in for a captured graph: replaying runs the body eagerly."""

    def __init__(self, body):
        self.body = body
        self.replays = 0

    def replay(self):
        self.replays += 1
        self.body()


@pytest.mark.parametrize("case", ["sequential", "speculative", "chunked"])
def test_each_key_captured_once_at_its_second_use(setup, monkeypatch, case):
    """With the capture stubbed, compiled dispatch runs on the CPU: over a
    run whose blocks vary in length (budgets 3..11 at scan_steps 4, and a
    mixed-temperature request), each key runs eagerly at its first use,
    is captured at its second and replayed at every use from then on,
    never recaptured; the tokens are the eager engine's."""
    cfg, tcfg, _, tp = setup
    captures = []

    def stub(body, shared, generator):
        captures.append(body)
        return _StubGraph(body), 0

    monkeypatch.setattr(E, "capture_graph", stub)
    kw = {"batch_slots": 2, "max_len": 256, "scan_steps": 4, "seed": 7,
          **CASES[case]}
    prompts = _prompts(cfg, case) * 2
    budgets = [3, 11, 6, 9, 5, 7, 4, 10]
    temps = [0.0, 0.0, 0.0, 1.3, 0.0, 0.0, 0.0, 0.0]

    def serve(eng):
        res = eng.run([Request(rid=i, prompt=p, max_new_tokens=b,
                               temperature=t)
                       for i, (p, b, t) in enumerate(zip(prompts, budgets,
                                                         temps))])
        return [r.tokens for r in res]

    want = serve(ServingEngine(tcfg, tp, **kw))
    eng = ServingEngine(tcfg, tp, **kw)
    eng._compiled.enabled = True
    uses = []
    run = eng._compiled.run

    def spy(key, body):
        uses.append(key)
        run(key, body)

    eng._compiled.run = spy
    assert serve(eng) == want
    counts = collections.Counter(uses)
    second = [k for i, k in enumerate(uses) if uses[:i].count(k) == 1]
    assert eng._compiled.captured == second
    assert len(captures) == len(second) == len(set(second))
    assert eng._compiled.replays == len(uses) - len(counts)
    graphs = [g for g, _ in eng._compiled._graphs.values()]
    assert sum(g.replays for g in graphs) == eng._compiled.replays
    kinds = {k[0] for k in counts}
    if case == "sequential":
        lengths = {k[1] for k in counts if k[0] == "decode"}
        assert len(lengths) > 1, lengths
        # both sampler branches were keyed apart
        assert {k[3] for k in counts if k[0] == "decode"} == {True, False}
    if case == "speculative":
        assert "verify" in kinds
    if case == "chunked":
        assert any(k[0] == "chunk" for k in second)


def test_chunk_graphs_bounded_and_one_chunk_set(setup, monkeypatch):
    """A stream of mixed prompt lengths, served twice, with the capture
    stubbed and room for 3 chunk graphs: never more than 3 are held, the
    least recently used is dropped and its key captured again at its next
    use, decode keys are never dropped, and the tokens are the eager
    engine's. Batches of 1 and 2 rows run in one chunked-prefill set of
    batch_slots rows whose storage never moves."""
    cfg, tcfg, _, tp = setup
    monkeypatch.setattr(E, "CHUNK_GRAPHS", 3)
    monkeypatch.setattr(E, "capture_graph",
                        lambda body, shared, gen: (_StubGraph(body), 0))
    kw = {"batch_slots": 2, "max_len": 256, "scan_steps": 4, "seed": 7,
          "prefill_chunk": 16}
    rng = np.random.RandomState(5)
    prompts = [rng.randint(0, cfg.vocab_size, (n,)).astype(np.int32)
               for n in (37, 21, 44, 30, 58, 17, 49, 26)]
    budgets = [3, 9, 5, 7, 4, 8, 6, 3]

    def serve(eng):
        res = eng.run([Request(rid=i, prompt=p, max_new_tokens=b)
                       for i, (p, b) in enumerate(zip(prompts, budgets))])
        return [r.tokens for r in res]

    ref = ServingEngine(tcfg, tp, **kw)
    want = [serve(ref), serve(ref)]
    eng = ServingEngine(tcfg, tp, **kw)
    eng._compiled.enabled = True
    held, uses = [], []
    run = eng._compiled.run

    def spy(key, body):
        uses.append(key)
        run(key, body)
        held.append(sum(k[0] == "chunk" for k in eng._compiled._graphs))

    eng._compiled.run = spy
    got = [serve(eng)]
    chunk_set = _carries(eng)
    got.append(serve(eng))
    assert got == want
    _same_storage(chunk_set, _carries(eng))
    c = eng._compiled
    assert max(held) == 3 and c.evicted > 0
    chunk_keys = [k for k in c.captured if k[0] == "chunk"]
    assert len(chunk_keys) > len(set(chunk_keys))       # captured again
    decode_keys = [k for k in c.captured if k[0] == "decode"]
    assert len(decode_keys) == len(set(decode_keys))
    assert all(k in c._graphs for k in decode_keys)
    assert {k[1] for k in uses if k[0] == "chunk"} == {1, 2}
    assert eng._chunk_buf[0]["last"].shape[0] == kw["batch_slots"]
    with pytest.raises(ValueError, match="batch_slots"):
        eng.prefill_logits(torch.zeros((3, 40), dtype=torch.long),
                           torch.full((3,), 40, dtype=torch.int32))
