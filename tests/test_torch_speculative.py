"""Speculative decoding and the ring lookahead in the port, against the JAX
package on the CPU (the mirror of tests/test_speculative.py).

Greedy speculative decode must give exactly the sequential engine's tokens
and the JAX speculative engine's tokens and counters (`spec_steps`,
`draft_proposed`, `draft_accepted`) on llama3.2-1b + SWAT, gemma2-2b and
dense llama3.2-1b smoke configs; the n-gram drafter must pick the JAX
drafter's drafts on random histories; rollback must leave the ring caches
of a sequential engine; the acceptance ladder must count as JAX's does;
`tokens_per_step` must leave tokens unchanged. Also the serve launcher's
new flags on the CPU. Inputs come from numpy seeds."""
import collections
import dataclasses
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.configs import get_smoke_config, with_swat
from repro.core import model as JM
from repro.serving import drafter as JD
from repro.serving.engine import Request as JRequest
from repro.serving.engine import ServingEngine as JEngine
from repro_torch import interop
from repro_torch.configs import get_smoke_config as t_smoke
from repro_torch.configs import with_swat as t_swat
from repro_torch.core import layers as TL
from repro_torch.core import model as TM
from repro_torch.serving.drafter import NGramDrafter, get_drafter
from repro_torch.serving.engine import Request, ServingEngine

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
F32 = dict(atol=2e-5, rtol=1e-4)


def _build(name, swat=False):
    cfg, tcfg = get_smoke_config(name), t_smoke(name)
    if swat:
        cfg = with_swat(cfg, window=16, num_global=4)
        tcfg = t_swat(tcfg, window=16, num_global=4)
    jp = JM.init_model(jax.random.PRNGKey(0), cfg)
    tp = interop.params_from_jax(jax.tree.map(np.asarray, jp), tcfg,
                                 device="cpu")
    return cfg, tcfg, jp, tp


@pytest.fixture(scope="module")
def models():
    """llama + SWAT (window + globals, GQA), gemma2 (local/global
    alternation and softcaps), dense llama."""
    return {"llama_swat": _build("llama3p2_1b", swat=True),
            "gemma2": _build("gemma2_2b"),
            "llama_dense": _build("llama3p2_1b")}


LENS = (12, 30, 7, 18, 25, 10)
BUDGETS = (6, 19, 1, 27, 5, 2)     # prefill-only and clamp-y budgets too


def _prompts(cfg, seed):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, cfg.vocab_size, (l,)).astype(np.int32)
            for l in LENS]


def _run(tcfg, tp, prompts, temps=None, budgets=BUDGETS, **kw):
    kw = {"batch_slots": 4, "max_len": 128, "scan_steps": 4, "seed": 11,
          **kw}
    eng = ServingEngine(tcfg, tp, **kw)
    temps = temps or [0.0] * len(prompts)
    res = eng.run([Request(rid=i, prompt=p, max_new_tokens=b,
                           temperature=t)
                   for i, (p, b, t) in enumerate(zip(prompts, budgets,
                                                     temps))])
    return eng, {r.rid: r.tokens for r in res}


def _jax_run(cfg, jp, prompts, budgets=BUDGETS, **kw):
    kw = {"batch_slots": 4, "max_len": 128, "scan_steps": 4, "seed": 11,
          **kw}
    eng = JEngine(cfg, jp, **kw)
    res = eng.run([JRequest(rid=i, prompt=p, max_new_tokens=b)
                   for i, (p, b) in enumerate(zip(prompts, budgets))])
    return eng, {r.rid: r.tokens for r in res}


COUNTERS = ("spec_steps", "draft_proposed", "draft_accepted")


# ------------------------------------------------------------- identity --
@pytest.mark.parametrize("name", ["llama_swat", "gemma2", "llama_dense"])
def test_greedy_identity_and_counters_equal_jax(models, name):
    """Greedy speculative (k=3) == the port's sequential engine == the JAX
    speculative engine, with equal spec counters: mixed prompt lengths,
    slot refill (6 requests on 4 slots), budgets that clamp drafts."""
    cfg, tcfg, jp, tp = models[name]
    prompts = _prompts(cfg, 3)
    _, base = _run(tcfg, tp, prompts)
    eng, spec = _run(tcfg, tp, prompts, speculative=3)
    jeng, want = _jax_run(cfg, jp, prompts, speculative=3)
    assert spec == base == want
    for c in COUNTERS:
        assert eng.stats[c] == jeng.stats[c], (c, eng.stats, jeng.stats)
    total = sum(len(t) for t in spec.values())
    assert eng.stats["tokens_emitted"] == total - len(prompts)
    assert 0 <= eng.stats["draft_accepted"] <= eng.stats["draft_proposed"]
    assert eng.acceptance_rate == pytest.approx(jeng.acceptance_rate)


@pytest.mark.parametrize("steps", [1, 4, 8])
def test_identity_across_scan_steps_and_k(models, steps):
    """scan_steps and the draft depth are speed knobs only."""
    _, tcfg, _, tp = models["llama_swat"]
    prompts = _prompts(models["llama_swat"][0], 5)
    _, want = _run(tcfg, tp, prompts)
    for k in (1, 2, 5):
        _, got = _run(tcfg, tp, prompts, scan_steps=steps, speculative=k)
        assert got == want, (steps, k)


def test_counters_equal_jax_at_k5_scan8(models):
    cfg, tcfg, jp, tp = models["llama_swat"]
    prompts = _prompts(cfg, 5)
    eng, got = _run(tcfg, tp, prompts, scan_steps=8, speculative=5)
    jeng, want = _jax_run(cfg, jp, prompts, scan_steps=8, speculative=5)
    assert got == want
    for c in COUNTERS:
        assert eng.stats[c] == jeng.stats[c], c


def test_greedy_rows_exact_under_mixed_temperatures(models):
    """Sampled slots beside greedy ones: greedy rows stay the sequential
    engine's, sampled rows serve their exact budget, and a fixed seed
    reproduces."""
    cfg, tcfg, _, tp = models["gemma2"]
    prompts = _prompts(cfg, 7)
    temps = [0.0, 1.5, 0.0, 2.5, 1.0, 0.0]
    _, base = _run(tcfg, tp, prompts, temps=temps)
    _, spec = _run(tcfg, tp, prompts, temps=temps, speculative=3)
    for i, t in enumerate(temps):
        assert len(spec[i]) == len(base[i])
        if t == 0.0:
            assert spec[i] == base[i], i
    _, again = _run(tcfg, tp, prompts, temps=temps, speculative=3)
    assert spec == again


def test_step_api_speculative(models):
    """`step()` runs one verify step: >= 1 token a live slot, budgets never
    overshoot, tokens equal the sequential run's."""
    cfg, tcfg, _, tp = models["llama_swat"]
    prompts = _prompts(cfg, 13)[:4]
    eng = ServingEngine(tcfg, tp, batch_slots=4, max_len=128,
                        speculative=3, seed=11)
    eng._admit(collections.deque(
        Request(rid=i, prompt=p, max_new_tokens=b)
        for i, (p, b) in enumerate(zip(prompts, BUDGETS))))
    done = list(eng._completed)
    while not all(eng.slot_free):
        done.extend(eng.step())
        assert all(b >= 0 for b in eng.slot_budget)
    _, want = _run(tcfg, tp, prompts, budgets=BUDGETS[:4])
    assert {r.rid: r.tokens for r in done} == want
    assert eng.step() == []


# ------------------------------------------------------------- rollback --
def test_rollback_leaves_sequential_ring_state(models):
    """4 requests on 4 slots (request i lives in slot i). After the run a
    slot that consumed its prompt (L) and emitted n tokens holds step ==
    L + n - 1 in every layer, and its ring rows equal those of a sequential
    engine with the same lookahead at the pinned globals and at every
    position the next query's window reaches: [step - window, step) (a
    verify step's rejected rows may overwrite only older ones). Rows are
    compared where the sequential engine, which keeps advancing a retired
    slot's pointer to the end of its block, has not yet overwritten that
    window: at least at the slot that finishes last."""
    cfg, tcfg, _, tp = models["llama_swat"]
    prompts = _prompts(cfg, 17)[:4]
    budgets = (6, 19, 4, 27)
    eng, out = _run(tcfg, tp, prompts, budgets=budgets, speculative=3)
    seq, ref = _run(tcfg, tp, prompts, budgets=budgets, tokens_per_step=4)
    assert out == ref
    acfg = TM.attn_cfg(tcfg, "attn", index=0)
    g, w = acfg.spec.num_global, acfg.spec.window
    ring = TL.cache_capacity(acfg, 128, lookahead=3) - g
    compared = set()
    for blk, sblk in zip(eng.caches, seq.caches):
        for name, c in blk.items():
            for s in range(4):
                want = len(prompts[s]) + len(out[s]) - 1
                assert int(c["step"][s]) == want, (name, s)
                have = int(sblk[name]["step"][s])
                if have - ring > want - w:
                    continue
                compared.add(s)
                pos = np.arange(max(g, want - w), want)
                rows = np.concatenate([np.arange(g),
                                       g + (pos - g) % ring])
                for leaf in ("k", "v"):
                    np.testing.assert_allclose(
                        c[leaf][s, :, rows].numpy(),
                        sblk[name][leaf][s, :, rows].numpy(), **F32)
    assert 3 in compared          # budget 27: the last slot to finish


def test_lookahead_rows_sized_for_drafts(models):
    _, tcfg, _, tp = models["llama_swat"]
    eng = ServingEngine(tcfg, tp, batch_slots=2, max_len=128, speculative=3)
    assert eng.tokens_per_step == 4 and eng.lookahead == 3
    acfg = TM.attn_cfg(tcfg, "attn")
    cap = TL.cache_capacity(acfg, 128, lookahead=3)
    assert cap == acfg.spec.window + 1 + 3 + acfg.spec.num_global
    want = TL.cache_allocation(acfg, 128, lookahead=3)
    assert eng.caches[0]["l0"]["k"].shape[2] == want


@pytest.mark.parametrize("chunk", [0, 8])
def test_tokens_per_step_token_identical(models, chunk):
    """tokens_per_step=4 widens every ring by 3 lookahead rows: tokens
    (greedy and sampled) equal the tokens_per_step=1 engine's, with and
    without chunked prefill."""
    cfg, tcfg, _, tp = models["llama_swat"]
    rng = np.random.RandomState(11)
    prompts = [rng.randint(0, cfg.vocab_size, (l,)).astype(np.int32)
               for l in (40, 9, 26)]
    kw = dict(batch_slots=2, max_len=256, seed=5, budgets=(6, 6, 6),
              temps=[0.0, 2.0, 0.0])
    _, base = _run(tcfg, tp, prompts, **kw)
    _, got = _run(tcfg, tp, prompts, tokens_per_step=4, prefill_chunk=chunk,
                  **kw)
    assert got == base


def test_speculative_on_a_wider_lookahead_ring(models):
    """tokens_per_step above speculative+1: verify steps rotate the ring at
    the engine's lookahead, the one prefill filled it at, so greedy tokens
    stay the sequential engine's. (The JAX engine verifies at lookahead k
    on such a ring and does not; this is where the port departs from it.)"""
    cfg, tcfg, _, tp = models["llama_swat"]
    prompts = _prompts(cfg, 3)
    _, want = _run(tcfg, tp, prompts)
    _, got = _run(tcfg, tp, prompts, speculative=2, tokens_per_step=8)
    assert got == want


# ---------------------------------------------------------------- ladder --
def test_acceptance_ladder_counts_equal_jax(models):
    """At spec_min_acceptance 0.95 random prompts trip the ladder off, and
    with spec_resume_acceptance 0.0 every probe turns it back on: the
    off/probe/on counts, spec counters and tokens equal the JAX engine's."""
    cfg, tcfg, jp, tp = models["llama_dense"]
    prompts = [np.random.RandomState(i).randint(0, cfg.vocab_size, (12,))
               .astype(np.int32) for i in range(2)]
    kw = dict(batch_slots=2, max_len=128, scan_steps=4, speculative=2,
              spec_min_acceptance=0.95, spec_acceptance_window=2,
              spec_retry_blocks=2, spec_resume_acceptance=0.0,
              budgets=(40, 40))
    eng, got = _run(tcfg, tp, prompts, **kw)
    jeng, want = _jax_run(cfg, jp, prompts, **kw)
    assert got == want
    assert eng.stats["spec_autodisable"] >= 1
    assert eng.stats["spec_resume"] >= 1
    for c in COUNTERS + ("spec_autodisable", "spec_resume"):
        assert eng.stats[c] == jeng.stats[c], c
    _, seq = _run(tcfg, tp, prompts, batch_slots=2, budgets=(40, 40))
    assert got == seq


def test_unsupported_config_is_rejected():
    """speculative= on a config without rollback-safe state (whisper's
    encoder memory, mamba) fails at construction."""
    whisper = t_smoke("whisper_tiny")
    params = TM.init_model(whisper, seed=0, device="cpu")
    with pytest.raises(ValueError, match="speculative"):
        ServingEngine(whisper, params, speculative=2)
    mamba_like = dataclasses.replace(t_smoke("llama3p2_1b"),
                                     layer_pattern=("mamba",))
    assert not TM.speculative_supported(mamba_like)
    with pytest.raises(ValueError):
        ServingEngine(mamba_like, params, speculative=2)


# --------------------------------------------------------------- drafter --
@settings(deadline=None, max_examples=25)
@given(b=st.integers(1, 4), h=st.integers(4, 24), ngram=st.integers(1, 4),
       k=st.integers(1, 6), vocab=st.integers(2, 6),
       seed=st.integers(0, 2 ** 31 - 1))
def test_drafter_matches_jax(b, h, ngram, k, vocab, seed):
    """propose / observe / sanitize / seed_row against the JAX drafter on
    random histories over a small vocab (so matches of every length
    occur), with random valid counts and ragged emission counts."""
    rng = np.random.RandomState(seed)
    hist = rng.randint(0, vocab, (b, h)).astype(np.int32)
    cnt = rng.randint(0, h + 1, (b,)).astype(np.int32)
    jd, td = JD.NGramDrafter(ngram, h), NGramDrafter(ngram, h)
    want = np.asarray(jd.propose(jnp.asarray(hist), jnp.asarray(cnt), k))
    got = td.propose(torch.from_numpy(hist), torch.from_numpy(cnt), k)
    np.testing.assert_array_equal(got.numpy(), want)
    toks = rng.randint(-3, vocab + 3, (b, k + 1)).astype(np.int32)
    e = rng.randint(0, k + 2, (b,)).astype(np.int32)
    wh, wc = jd.observe(jnp.asarray(hist), jnp.asarray(cnt),
                        jnp.asarray(toks), jnp.asarray(e))
    gh, gc = td.observe(torch.from_numpy(hist), torch.from_numpy(cnt),
                        torch.from_numpy(toks), torch.from_numpy(e))
    np.testing.assert_array_equal(gh.numpy(), np.asarray(wh))
    np.testing.assert_array_equal(gc.numpy(), np.asarray(wc))
    np.testing.assert_array_equal(
        td.sanitize(torch.from_numpy(toks), vocab).numpy(),
        np.asarray(jd.sanitize(jnp.asarray(toks), vocab)))
    seq = rng.randint(0, vocab, (rng.randint(0, 2 * h),))
    row, n = td.seed_row(seq)
    wrow, wn = jd.seed_row(seq)
    np.testing.assert_array_equal(row, wrow)
    assert n == wn


def test_drafter_prefers_recent_and_longer_matches():
    d = NGramDrafter(max_ngram=3, history=32)
    hist, cnt = d.init_state(3)
    rows = ([2, 3, 7, 7, 2, 3, 9, 9, 2, 3],     # recency: the later (2, 3)
            [5, 6, 7, 8, 1, 7, 2, 5, 6, 7],     # length beats recency
            [3, 9, 4, 11])                      # no match: repeat the last
    for s, seq in enumerate(rows):
        r, n = d.seed_row(np.array(seq))
        hist[s], cnt[s] = torch.from_numpy(r), int(n)
    out = d.propose(hist, cnt, 2)
    assert out.tolist() == [[9, 9], [8, 1], [11, 11]]


def test_get_drafter():
    assert get_drafter(None) == NGramDrafter()
    assert get_drafter(NGramDrafter(2, 8)) == NGramDrafter(2, 8)
    with pytest.raises(TypeError):
        get_drafter("not a drafter")


# -------------------------------------------------------------- launcher --
def _serve(*args):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    return subprocess.run([sys.executable, "-m", "repro_torch.launch.serve",
                           *args], capture_output=True, text=True, env=env,
                          timeout=300)


def test_serve_launcher_chunked_and_speculative_on_cpu():
    out = _serve("--arch", "llama3.2-1b", "--smoke", "--swat", "--window",
                 "16", "--requests", "3", "--slots", "2", "--prompt-len",
                 "40", "--new-tokens", "8", "--max-len", "128",
                 "--prefill-chunk", "8", "--speculative", "2",
                 "--device", "cpu")
    assert out.returncode == 0, out.stderr
    assert "3 requests / 24 tokens" in out.stdout
    assert "prefill_chunk=8, speculative=2 (acceptance" in out.stdout


@pytest.mark.parametrize("flag,item", [(["--chaos-poison-slot", "1"], 10),
                                       (["--mesh", "2x2"], 13),
                                       (["--deadline", "1.0"], 10)])
def test_serve_launcher_refuses_later_slice_flags(flag, item):
    """Every flag of a later slice now serves: the resilience flags (item
    10) report their outcome, and `--mesh 2x2` (item 13) serves on a 2x2
    single-process mesh and names it on the run line."""
    out = _serve("--arch", "llama3.2-1b", "--smoke", "--device", "cpu",
                 *flag)
    if item != 10:
        assert out.returncode == 0, out.stderr
        assert "2x2 mesh (tp)" in out.stdout
        assert "not ported" not in out.stderr
        return
    assert out.returncode == 0, out.stderr
    assert "not ported" not in out.stderr
    assert "[serve] statuses: " in out.stdout
