"""The paged KV layout and prefix sharing in the port, against the JAX
package on the CPU (the mirror of tests/test_paged.py).

The port's host-side copy of `serving/paged.py` (allocator, radix trie,
PagedManager) is swept under hypothesis and run in lockstep with the JAX
module; `paged_gather` / `paged_scatter` and one paged `attention_decode`
step are held against the JAX functions on the same seeded pool and table
(outputs at fp32 tolerance, pools after the step exactly equal); the
paged engine's greedy tokens equal the contiguous engine's and the JAX
paged engine's (swat and dense llama, sequential and speculative); prefix
sharing gives the unshared tokens and the JAX engine's prefill-token and
pool-block counts. Inputs come from numpy seeds."""
import collections
import dataclasses
import json
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.configs import get_smoke_config, with_swat
from repro.core import layers as JL
from repro.core import model as JM
from repro.serving import paged as JP
from repro.serving.engine import Request as JRequest
from repro.serving.engine import ServingEngine as JEngine
from repro_torch import interop
from repro_torch.configs import get_smoke_config as t_smoke
from repro_torch.configs import with_swat as t_swat
from repro_torch.core import layers as TL
from repro_torch.core import model as TM
from repro_torch.serving.engine import Request, ServingEngine
from repro_torch.serving.paged import (BlockAllocator, PagedManager,
                                       RadixTrie, batch_lcp)

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
F32 = dict(atol=2e-5, rtol=1e-4)


def _build(name, window=0):
    cfg, tcfg = get_smoke_config(name), t_smoke(name)
    if window:
        cfg = with_swat(cfg, window=window, num_global=4)
        tcfg = t_swat(tcfg, window=window, num_global=4)
    jp = JM.init_model(jax.random.PRNGKey(0), cfg)
    tp = interop.params_from_jax(jax.tree.map(np.asarray, jp), tcfg,
                                 device="cpu")
    return cfg, tcfg, jp, tp


@pytest.fixture(scope="module")
def models():
    """llama + SWAT at the JAX test's window (16) and at serve_bench.py's
    (64), and dense llama."""
    return {"swat": _build("llama3p2_1b", window=16),
            "bench": _build("llama3p2_1b", window=64),
            "dense": _build("llama3p2_1b")}


def _prompts(cfg, seed=0, n=4):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, cfg.vocab_size, (l,)).astype(np.int32)
            for l in rng.randint(5, 30, n)]


def _run(tcfg, tp, prompts, budget=8, temps=None, **kw):
    kw = {"batch_slots": 2, "max_len": 256, **kw}
    eng = ServingEngine(tcfg, tp, **kw)
    temps = temps or [0.0] * len(prompts)
    res = eng.run([Request(rid=i, prompt=p, max_new_tokens=budget,
                           temperature=t)
                   for i, (p, t) in enumerate(zip(prompts, temps))])
    return eng, {r.rid: r.tokens for r in res}


def _jax_run(cfg, jp, prompts, budget=8, **kw):
    kw = {"batch_slots": 2, "max_len": 256, **kw}
    eng = JEngine(cfg, jp, **kw)
    res = eng.run([JRequest(rid=i, prompt=p, max_new_tokens=budget)
                   for i, p in enumerate(prompts)])
    return eng, {r.rid: r.tokens for r in res}


# ---------------------------------------------------- host-side copies ---
@settings(max_examples=30, deadline=None)
@given(seed=st.integers(min_value=0, max_value=10_000),
       num_blocks=st.integers(min_value=4, max_value=24))
def test_allocator_invariants(seed, num_blocks):
    """Refcounts never go negative, the free list never double-holds an
    id, reserved ids are never handed out — against a reference model."""
    rng = np.random.RandomState(seed)
    reserved = set(rng.choice(num_blocks, size=rng.randint(0, 3),
                              replace=False).tolist())
    alc = BlockAllocator(num_blocks, reserved=reserved)
    ref: dict = {}
    live: list = []
    for _ in range(200):
        op = rng.randint(0, 3)
        if op == 0 and alc.free_count:
            bid = alc.alloc()
            assert bid not in reserved
            assert ref.get(bid, 0) == 0, "alloc returned a referenced block"
            ref[bid] = 1
            live.append(bid)
        elif op == 1 and live:
            bid = live[rng.randint(len(live))]
            alc.retain(bid)
            ref[bid] += 1
            live.append(bid)
        elif op == 2 and live:
            bid = live.pop(rng.randint(len(live)))
            alc.release(bid)
            ref[bid] -= 1
            assert ref[bid] >= 0
        for bid in set(live):
            assert alc.refcount(bid) == ref[bid]
    assert alc.allocated == sum(1 for v in ref.values() if v > 0)
    dead = [b for b, v in ref.items() if v == 0]
    if dead:
        with pytest.raises(RuntimeError):
            alc.release(dead[0])
    with pytest.raises(RuntimeError):
        BlockAllocator(4).retain(0)


@settings(max_examples=30, deadline=None)
@given(seed=st.integers(min_value=0, max_value=10_000),
       nseq=st.integers(min_value=1, max_value=8),
       alpha=st.integers(min_value=2, max_value=5))
def test_radix_trie_matches_bruteforce_and_jax(seed, nseq, alpha):
    """Trie longest_prefix == max pairwise LCP against every inserted
    sequence (small alphabet: forces edge splits), equal to the JAX
    trie's; batch_lcp == the common prefix of all rows, equal to JAX's."""
    rng = np.random.RandomState(seed)
    seqs = [rng.randint(0, alpha, rng.randint(1, 20)).tolist()
            for _ in range(nseq)]
    trie, jtrie = RadixTrie(), JP.RadixTrie()
    for s in seqs:
        trie.insert(s)
        jtrie.insert(s)
    assert len(trie) == nseq

    def lcp(a, b):
        n = 0
        for x, y in zip(a, b):
            if x != y:
                break
            n += 1
        return n
    for _ in range(10):
        q = rng.randint(0, alpha, rng.randint(0, 25)).tolist()
        want = max((lcp(q, s) for s in seqs), default=0)
        assert trie.longest_prefix(q) == want == jtrie.longest_prefix(q)
    want_all = (min(lcp(seqs[0], s) for s in seqs[1:]) if nseq > 1 else 0)
    assert batch_lcp(seqs) == want_all == JP.batch_lcp(seqs)


@settings(max_examples=25, deadline=None)
@given(seed=st.integers(min_value=0, max_value=10_000))
def test_paged_manager_admit_free_cow_cycle(seed):
    """Random admit/free/cow cycles on a shared-mode manager, in lockstep
    with the JAX manager (equal tables, moves and counts at every step):
    parked tables always point at scratch, occupied tables never reference
    a freed block, COW leaves every written block exclusively owned, and
    the shared-prefix retains keep the allocator balanced."""
    rng = np.random.RandomState(seed)
    layout = {0: {"page": 4, "nb": 6, "cap": 24, "g": 2, "ring": 22},
              2: {"page": 4, "nb": 3, "cap": 12, "g": 0, "ring": 12}}
    slots = 4
    pm = PagedManager(layout, slots, mode="shared")
    jpm = JP.PagedManager(layout, slots, mode="shared")
    pos = np.zeros(slots, np.int64)
    for _ in range(60):
        op = rng.randint(0, 3)
        parked = [s for s in range(slots) if pm.parked[s]]
        busy = [s for s in range(slots) if not pm.parked[s]]
        if op == 0 and parked:
            take = sorted(rng.choice(parked,
                                     rng.randint(1, len(parked) + 1),
                                     replace=False).tolist())
            l_pad = int(rng.randint(8, 30))
            prefix = int(rng.randint(0, l_pad)) if len(take) >= 2 else 0
            for m in (pm, jpm):
                m.admit(take, [l_pad] * len(take), prefix_len=prefix)
            pos[take] = l_pad
        elif op == 1 and busy:
            s = busy[rng.randint(len(busy))]
            for m in (pm, jpm):
                m.free(s)
                m.free(s)                   # idempotent, never double-free
        elif op == 2 and busy:
            span = int(rng.randint(1, 6))
            plan = {s: int(pos[s]) for s in busy}
            moves = pm.cow_moves(plan, span)
            assert moves == jpm.cow_moves(plan, span)
            for i, geo in layout.items():
                page, g, ring = geo["page"], geo["g"], geo["ring"]
                for s in busy:
                    p = np.arange(pos[s], pos[s] + span)
                    rows = np.where(p < g, p, g + (p - g) % ring)
                    for b in np.unique(rows // page):
                        bid = int(pm.tables[i][s][b])
                        assert pm.alloc[i].refcount(bid) == 1, \
                            "COW left a written block shared"
                for src, dst in moves[i]:
                    assert pm.alloc[i].refcount(dst) >= 1
            pos[busy] += span
        for i in pm.layout:
            np.testing.assert_array_equal(pm.tables[i], jpm.tables[i])
            for s in range(slots):
                if pm.parked[s]:
                    assert (pm.tables[i][s] == pm.scratch_id(i, s)).all()
                else:
                    for bid in pm.tables[i][s]:
                        assert pm.alloc[i].refcount(int(bid)) >= 1
        assert pm.blocks_in_use() == jpm.blocks_in_use()
    for s in range(slots):
        pm.free(s)
    assert pm.blocks_in_use() == 0
    pm.reset()
    assert pm.parked.all() and pm.blocks_total() == jpm.blocks_total()


# ------------------------------------------------- device-side functions --
def _layer_case(models, t, seed=0):
    """llama+SWAT's first attention layer (window 16, 4 globals) with a
    seeded pool of 4 slots and a table holding every kind of entry: a
    private row, a row sharing its pinned block with it (prefix sharing),
    a parked row (every entry its scratch block) and a permuted row. The
    two sharing rows write only their private blocks this step, as the
    engine's copy-on-write guarantees."""
    cfg, tcfg, jp, tp = models["swat"]
    la = t - 1
    acfg = JM.attn_cfg(cfg, "attn", index=0)
    tacfg = TM.attn_cfg(tcfg, "attn", index=0)
    nb = JL.paged_num_blocks(acfg, 256, la)
    nbp = nb + 1
    b, page = 4, JL.PAGE_SIZE
    rng = np.random.RandomState(seed)
    shape = (b * nbp, acfg.num_kv_heads, page, acfg.head_dim)
    pk = rng.standard_normal(shape).astype(np.float32)
    pv = rng.standard_normal(shape).astype(np.float32)
    table = np.stack([np.arange(nb) + s * nbp for s in range(b)])
    table[1, 0] = table[0, 0]                       # shared pinned block
    table[2, :] = 2 * nbp + nb                      # parked on scratch
    table[3] = table[3][::-1]
    table = table.astype(np.int32)
    # rows 0 and 1 write block 1 only (ring rows 16..16+T-1); 2 and 3 wrap
    step = np.asarray([16, 16, 40, 57], np.int32)
    x = rng.standard_normal((b, t, cfg.d_model)).astype(np.float32)
    jparams = jax.tree.map(lambda a: np.asarray(a)[0],
                           jp["blocks"]["l0"]["mixer"])
    return dict(acfg=acfg, tacfg=tacfg, pk=pk, pv=pv, table=table,
                step=step, x=x, jparams=jparams,
                tparams=tp["blocks"][0]["l0"]["mixer"], lookahead=la)


def test_paged_gather_and_scatter_equal_jax(models):
    """The gathered view equals JAX's exactly; writing back a view whose
    private blocks changed gives JAX's pool exactly, duplicate entries
    (the shared block, the parked row's scratch block) included."""
    c = _layer_case(models, 1)
    pool, table = torch.from_numpy(c["pk"]), torch.from_numpy(c["table"])
    view = TL.paged_gather(pool, table)
    jview = np.asarray(JL.paged_gather(jnp.asarray(c["pk"]),
                                       jnp.asarray(c["table"])))
    assert view.is_contiguous()
    np.testing.assert_array_equal(view.numpy(), jview)
    rng = np.random.RandomState(1)
    new = view.clone()
    new[[0, 1, 3], :, 16:32] = torch.from_numpy(rng.standard_normal(
        (3, view.shape[1], 16, view.shape[3])).astype(np.float32))
    got = TL.paged_scatter(pool.clone(), table, new)
    want = np.asarray(JL.paged_scatter(jnp.asarray(c["pk"]),
                                       jnp.asarray(c["table"]),
                                       jnp.asarray(new.numpy())))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("t", [1, 3])
def test_paged_attention_decode_step_equals_jax(models, t):
    """One paged decode step (T=1, and T=3 on a lookahead ring) through
    the port's and the JAX `attention_decode`: outputs within fp32
    tolerance; the pools after the step changed in exactly the same
    elements, to values within fp32 tolerance (the step's K/V rows come
    from each package's own projection and rope), and equal everywhere
    else; steps advanced by T, the table untouched. Against the port's
    contiguous step on the gathered view the paged step is exact: the
    same output, and its pools are that step's rings scattered back."""
    c = _layer_case(models, t)
    jcache = {"pk": jnp.asarray(c["pk"]), "pv": jnp.asarray(c["pv"]),
              "table": jnp.asarray(c["table"]),
              "step": jnp.asarray(c["step"])}
    jout, jnew = JL.attention_decode(c["jparams"], c["acfg"],
                                     jnp.asarray(c["x"]), jcache,
                                     impl="ref", lookahead=c["lookahead"])
    table = torch.from_numpy(c["table"])
    cache = {"pk": torch.from_numpy(c["pk"].copy()),
             "pv": torch.from_numpy(c["pv"].copy()),
             "table": table, "step": torch.from_numpy(c["step"])}
    out, cache = TL.attention_decode(c["tparams"], c["tacfg"],
                                     torch.from_numpy(c["x"]), cache,
                                     lookahead=c["lookahead"])
    ring = {"k": TL.paged_gather(torch.from_numpy(c["pk"]), table),
            "v": TL.paged_gather(torch.from_numpy(c["pv"]), table),
            "step": torch.from_numpy(c["step"])}
    out_c, ring = TL.attention_decode(c["tparams"], c["tacfg"],
                                      torch.from_numpy(c["x"]), ring,
                                      lookahead=c["lookahead"])
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), **F32)
    assert torch.equal(out, out_c)
    for leaf, rkey in (("pk", "k"), ("pv", "v")):
        got, want = cache[leaf].numpy(), np.asarray(jnew[leaf])
        changed = got != c[leaf]
        assert changed.any()
        np.testing.assert_array_equal(changed, want != c[leaf])
        np.testing.assert_array_equal(got[~changed], want[~changed])
        np.testing.assert_allclose(got[changed], want[changed], **F32)
        exact = TL.paged_scatter(torch.from_numpy(c[leaf].copy()), table,
                                 ring[rkey])
        assert torch.equal(cache[leaf], exact)
    np.testing.assert_array_equal(cache["step"].numpy(), c["step"] + t)
    np.testing.assert_array_equal(cache["table"].numpy(), c["table"])


def test_paged_caches_convert_and_share_one_table(models):
    """`init_caches(paged=True)` matches the JAX `init_paged_caches`
    layout leaf for leaf; each layer position's table is one tensor shared
    by every super-block, in the port's caches and in caches converted from
    JAX, and converts back to JAX's stacked (identical-row) layout."""
    cfg, tcfg, _, _ = models["swat"]
    jc = jax.tree.map(np.asarray, JM.init_paged_caches(cfg, 3, 256,
                                                       lookahead=2))
    tc = TM.init_caches(tcfg, 3, 256, lookahead=2, paged=True, device="cpu")
    conv = interop.caches_from_jax(jc, tcfg, device="cpu")
    for caches in (tc, conv):
        assert len(caches) == cfg.num_super_blocks >= 2
        assert all(c["l0"]["table"] is caches[0]["l0"]["table"]
                   for c in caches)
        back = interop.caches_to_numpy(caches)
        assert back.keys() == jc.keys()
        for leaf, want in jc["l0"].items():
            np.testing.assert_array_equal(back["l0"][leaf], want)
    bad = jax.tree.map(np.copy, jc)
    bad["l0"]["table"][1, 0, 0] += 1
    with pytest.raises(ValueError):
        interop.caches_from_jax(bad, tcfg, device="cpu")


# -------------------------------------------------------------- engine ---
@pytest.fixture(scope="module")
def jax_paged(models):
    """One JAX paged engine run per config: (engine, tokens), greedy."""
    out = {}
    for name, kw in (("swat", {}), ("dense", {}),
                     ("swat_spec", {"speculative": 2})):
        cfg, _, jp, _ = models[name.split("_")[0]]
        out[name] = _jax_run(cfg, jp, _prompts(cfg, seed=3, n=5),
                             kv_layout="paged", **kw)
    return out


@pytest.mark.parametrize("name", ["swat", "dense", "swat_spec"])
def test_paged_engine_tokens_equal_contiguous_and_jax(models, jax_paged,
                                                      name):
    """Paged decode == contiguous decode == the JAX paged engine, greedy,
    with slot eviction and reuse (5 requests on 2 slots); the speculative
    case runs verify steps on the paged lookahead ring."""
    cfg, tcfg, _, tp = models[name.split("_")[0]]
    kw = {"speculative": 2} if name.endswith("spec") else {}
    prompts = _prompts(cfg, seed=3, n=5)
    _, base = _run(tcfg, tp, prompts, **kw)
    eng, paged = _run(tcfg, tp, prompts, kv_layout="paged", **kw)
    jeng, want = jax_paged[name]
    assert paged == base == want
    assert eng.paged_stats() == jeng.paged_stats()
    assert eng.stats["spec_steps"] == jeng.stats["spec_steps"]
    if kw:
        assert eng.stats["spec_steps"] > 0


def test_paged_engine_sampled_rows_equal_contiguous(models):
    """With a sampled row in the mix, the paged engine draws the same
    tokens as the contiguous one (same generator, same logits)."""
    cfg, tcfg, _, tp = models["swat"]
    temps = [0.0, 0.0, 0.9, 0.0]
    prompts = _prompts(cfg)
    _, a = _run(tcfg, tp, prompts, temps=temps)
    _, b = _run(tcfg, tp, prompts, temps=temps, kv_layout="paged")
    assert a == b


def test_paged_engine_state_matches_jax_mid_run(models):
    """After one admission and one decode block: block tables, slot
    steps and COW counters equal the JAX engine's exactly, the pools
    within fp32 tolerance (the two prefills round differently)."""
    cfg, tcfg, jp, tp = models["swat"]
    prompts = _prompts(cfg, seed=5, n=3)
    engines = (ServingEngine(tcfg, tp, batch_slots=3, max_len=256,
                             kv_layout="paged"),
               JEngine(cfg, jp, batch_slots=3, max_len=256,
                       kv_layout="paged"))
    for eng, req in zip(engines, (Request, JRequest)):
        pend = collections.deque(req(rid=i, prompt=p, max_new_tokens=12)
                                 for i, p in enumerate(prompts))
        eng._run_t0 = 0.0
        eng._admit(pend)
        eng._decode_block(5)
    port = interop.caches_to_numpy(engines[0].caches)
    jc = jax.tree.map(np.asarray, engines[1].caches)
    for leaf in ("table", "step"):
        np.testing.assert_array_equal(port["l0"][leaf], jc["l0"][leaf])
    for leaf in ("pk", "pv"):
        np.testing.assert_allclose(port["l0"][leaf], jc["l0"][leaf], **F32)
    np.testing.assert_array_equal(engines[0]._slot_pos,
                                  engines[1]._slot_pos)
    assert engines[0].stats["cow_moves"] == engines[1].stats["cow_moves"]


# ------------------------------------------------------ prefix sharing ---
PREFIX_CASES = {
    # (model, prompt seed, system prompt, max_len, new tokens): the JAX
    # test's shapes, and serve_bench.py's prefix_sharing section
    "swat": ("swat", 7, 96, 256, 6),
    "dense": ("dense", 7, 96, 256, 6),
    "bench": ("bench", 13, 96, 512, 16),
}


def _shared_prompts(cfg, seed, sys_len):
    rng = np.random.RandomState(seed)
    sys_p = rng.randint(0, cfg.vocab_size, (sys_len,)).astype(np.int32)
    return [np.concatenate(
        [sys_p, rng.randint(0, cfg.vocab_size, (16,)).astype(np.int32)])
        for _ in range(8)]


def _admit_then_run(eng, req, prompts, budget):
    """Admit the first batch, read the pool's blocks in use, serve the
    rest: (blocks at admission, tokens by rid)."""
    pend = collections.deque(req(rid=i, prompt=p, max_new_tokens=budget)
                             for i, p in enumerate(prompts))
    eng._run_t0 = 0.0
    eng._admit(pend)
    blocks = eng.paged_stats()["blocks_in_use"]
    eng._run_t0 = None
    res = eng.run(list(pend)) + eng.take_completed()
    return blocks, {r.rid: r.tokens for r in res}


@pytest.mark.parametrize("case", sorted(PREFIX_CASES))
def test_prefix_sharing_identical_cheaper_and_counted_as_jax(models, case):
    """8 requests behind one system prompt: sharing prefills the prefix
    once (< 0.5x the tokens of the unshared paged engine), its tokens
    equal the unshared engine's and the JAX sharing engine's, and the
    prefill-token and pool-block counts equal JAX's; at serve_bench.py's
    shapes they are the recorded BENCH_serve.json counts."""
    name, seed, sys_len, max_len, budget = PREFIX_CASES[case]
    cfg, tcfg, jp, tp = models[name]
    prompts = _shared_prompts(cfg, seed, sys_len)
    kw = dict(batch_slots=8, max_len=max_len, kv_layout="paged",
              prefill_chunk=32)
    off = ServingEngine(tcfg, tp, **kw)
    off_blocks, r_off = _admit_then_run(off, Request, prompts, budget)
    on = ServingEngine(tcfg, tp, share_prefix=True, **kw)
    on_blocks, r_on = _admit_then_run(on, Request, prompts, budget)
    jon = JEngine(cfg, jp, share_prefix=True, **kw)
    j_blocks, r_jax = _admit_then_run(jon, JRequest, prompts, budget)
    assert r_on == r_off == r_jax
    assert on.stats["prefill_prefix_shared"] >= 1
    for key in ("prefill_tokens_computed", "prefill_prefix_shared",
                "cow_moves"):
        assert on.stats[key] == jon.stats[key], key
    assert on_blocks == j_blocks
    ratio = (on.stats["prefill_tokens_computed"]
             / off.stats["prefill_tokens_computed"])
    assert ratio < 0.5, ratio
    if name == "dense":
        # dense layers map positions to pages 1:1: the prefix dedups
        assert on_blocks < on.paged_stats()["blocks_total"] // 2
    if case == "bench":
        rec = json.loads((ROOT / "BENCH_serve.json").read_text())[
            "prefix_sharing"]
        assert (on.stats["prefill_tokens_computed"],
                off.stats["prefill_tokens_computed"]) == (
            rec["prefill_tokens"]["sharing"],
            rec["prefill_tokens"]["baseline"])
        assert (on_blocks, off_blocks) == (
            rec["pool_blocks_at_admission"]["sharing"],
            rec["pool_blocks_at_admission"]["baseline"])


# --------------------------------------------------------------- layout ---
def test_gemma2_window_schedule_distinct_capacities():
    """gemma2-style local/global alternation with per-layer windows: the
    port's paged layout equals JAX's, with distinct per-layer capacities,
    and the paged engine decodes the contiguous engine's tokens."""
    cfg, tcfg = get_smoke_config("gemma2_2b"), t_smoke("gemma2_2b")
    assert tcfg.layer_pattern == ("local_attn", "attn")
    sched = tuple(8 if k == "local_attn" else 24 for k in cfg.layer_pattern)
    cfg2 = dataclasses.replace(cfg, window_schedule=sched)
    tcfg2 = dataclasses.replace(tcfg, window_schedule=sched)
    layout = TM.paged_layout(tcfg2, 256)
    assert layout == JM.paged_layout(cfg2, 256)
    assert [layout[i]["cap"] for i in sorted(layout)] == [9, 25]
    base = TM.paged_layout(tcfg, 256)
    assert base == JM.paged_layout(cfg, 256)
    assert [base[i]["cap"] for i in sorted(base)] == [17, 256]
    jp = JM.init_model(jax.random.PRNGKey(0), cfg2)
    tp = interop.params_from_jax(jax.tree.map(np.asarray, jp), tcfg2,
                                 device="cpu")
    prompts = _prompts(tcfg2, seed=9, n=2)
    _, a = _run(tcfg2, tp, prompts, budget=6)
    _, b = _run(tcfg2, tp, prompts, budget=6, kv_layout="paged")
    assert a == b


def test_paged_dense_needs_page_multiple(models):
    """Dense layers keep max_len rows unrounded; a max_len that PAGE_SIZE
    does not divide cannot page without changing the view width: both
    packages refuse it, and so does the paged engine."""
    cfg, tcfg, _, tp = models["dense"]
    with pytest.raises(ValueError):
        JM.paged_layout(cfg, 250)
    with pytest.raises(ValueError):
        TM.paged_layout(tcfg, 250)
    with pytest.raises(ValueError):
        ServingEngine(tcfg, tp, max_len=250, kv_layout="paged")
