"""Chunked prefill in the port against the JAX package on the CPU.

The port's plain chunk attention (`kops.prefill_chunk_attention`, impl
"banded") against `repro.core.layers.attention_prefill_chunk`; the card
route's algorithm (ring tail gathered into token order, two banded passes
with offsets, LSE merge; `banded_plain` stands in for the kernel on CPU
tensors) against the plain version; `banded_plain` with offsets against the
Pallas forward in interpret mode; `model.prefill_chunk` against JAX's; and
the engine's greedy tokens with `prefill_chunk` against its single-shot run
and the JAX engine. Inputs come from numpy seeds; fp32 atol 2e-5 / rtol
1e-4, ring steps exactly."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config, with_swat
from repro.core import layers as JL
from repro.core import model as JM
from repro.core import patterns as JP
from repro.core.types import AttentionSpec as JSpec
from repro.kernels import swat_attention as JF
from repro.serving.engine import Request as JRequest
from repro.serving.engine import ServingEngine as JEngine
from repro_torch import interop
from repro_torch.configs import get_smoke_config as t_smoke
from repro_torch.configs import with_swat as t_swat
from repro_torch.core import layers as TL
from repro_torch.core import model as TM
from repro_torch.core.types import AttentionSpec as TSpec
from repro_torch.kernels import ops as kops
from repro_torch.kernels import swat_attention as TF
from repro_torch.serving.engine import Request, ServingEngine

torch.set_num_threads(1)

F32 = dict(atol=2e-5, rtol=1e-4)

# (spec fields, batch, chunk T, pos0, lengths, max_len, lookahead): window 16
# and 4 globals give a 21-row ring cache (17 ring rows) at max_len 64
SWAT = dict(kind="swat", window=16, num_global=4)
LAYER_CASES = {
    "first chunk": (SWAT, 2, 8, 0, (8, 5), 64, 0),
    "before wrap": (SWAT, 2, 8, 8, (20, 13), 64, 0),
    "after wrap": (SWAT, 2, 8, 40, (48, 45), 64, 0),
    "ragged row below pos0": (SWAT, 3, 8, 24, (31, 10, 29), 64, 0),
    "chunk below the globals": (SWAT, 2, 2, 2, (6, 3), 64, 0),
    "softcap": (dict(SWAT, softcap=5.0), 2, 8, 32, (40, 37), 64, 0),
    "lookahead ring": (SWAT, 2, 8, 32, (40, 36), 64, 3),
    "dense": (dict(kind="dense"), 2, 8, 16, (24, 19), 48, 0),
}


def _layer(case):
    fields, b, t, pos0, lens, max_len, la = LAYER_CASES[case]
    kw = dict(d_model=32, num_heads=4, num_kv_heads=2, head_dim=16)
    jcfg = JL.AttentionLayerCfg(spec=JSpec(**fields), **kw)
    tcfg = TL.AttentionLayerCfg(spec=TSpec(**fields), **kw)
    jp = JL.init_attention(jax.random.PRNGKey(1), jcfg, dtype=jnp.float32)
    tp = {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}
    phys = TL.cache_allocation(tcfg, max_len, la)
    assert phys == JL.cache_allocation(jcfg, max_len, la)
    rng = np.random.RandomState(len(case))
    x = rng.randn(b, t, 32).astype(np.float32)
    cache = {"k": rng.randn(b, 2, phys, 16).astype(np.float32),
             "v": rng.randn(b, 2, phys, 16).astype(np.float32),
             "step": np.full((b,), pos0, np.int32)}
    lens = np.asarray(lens, np.int32)
    valid = (pos0 + np.arange(t))[None, :] < lens[:, None]        # (B, T)
    return jcfg, tcfg, jp, tp, x, cache, lens, pos0, la, valid


def _tcache(cache):
    return {k: torch.from_numpy(v.copy()) for k, v in cache.items()}


@pytest.mark.parametrize("case", sorted(LAYER_CASES))
def test_plain_chunk_attention_matches_jax(case):
    """The plain version is the JAX function's expression: outputs equal at
    every position (pad positions included); the inserted (projected,
    roped) K/V rows within the tolerance, steps exactly."""
    jcfg, tcfg, jp, tp, x, cache, lens, pos0, la, _ = _layer(case)
    want, wc = JL.attention_prefill_chunk(
        jp, jcfg, jnp.asarray(x),
        {k: jnp.asarray(v) for k, v in cache.items()}, pos0,
        jnp.asarray(lens), lookahead=la)
    got, tc = TL.attention_prefill_chunk(
        tp, tcfg, torch.from_numpy(x), _tcache(cache), pos0,
        torch.from_numpy(lens), lookahead=la)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)
    np.testing.assert_array_equal(tc["step"].numpy(), np.asarray(wc["step"]))
    for leaf in ("k", "v"):
        np.testing.assert_allclose(tc[leaf].numpy(), np.asarray(wc[leaf]),
                                   **F32, err_msg=leaf)


@pytest.mark.parametrize("case", sorted(LAYER_CASES))
def test_route_matches_plain(case):
    """The card route's algorithm (impl "kernel": gather, banded passes with
    offsets, LSE merge; `banded_plain` on CPU tensors) equals the plain
    version at every real position; caches are the same insert."""
    _, tcfg, _, tp, x, cache, lens, pos0, la, valid = _layer(case)
    outs = {}
    for impl in ("kernel", "banded"):
        out, tc = TL.attention_prefill_chunk(
            tp, tcfg, torch.from_numpy(x), _tcache(cache), pos0,
            torch.from_numpy(lens), impl=impl, lookahead=la)
        outs[impl] = (out.numpy(), tc)
    got, want = outs["kernel"][0], outs["banded"][0]
    np.testing.assert_allclose(got[valid], want[valid], **F32)
    for leaf in ("k", "v", "step"):
        assert torch.equal(outs["kernel"][1][leaf], outs["banded"][1][leaf])


@pytest.mark.parametrize("pos0,causal", [(24, True), (40, True),
                                         (8, False)])
def test_banded_plain_offsets_match_pallas(pos0, causal):
    """`banded_plain` with non-zero q_offset / kv_offset / seq_kv_bound and
    its LSE against the JAX Pallas forward in interpret mode, at a chunk's
    shapes: 16 queries at pos0 against a kv slice [lo, pos0 + 16)."""
    fields = dict(kind="swat", window=16, num_global=4, causal=causal)
    rng = np.random.RandomState(pos0)
    t, lo = 16, max(4, pos0 - 17)
    lkv = pos0 + t - lo
    q = rng.randn(1, 4, t, 16).astype(np.float32)
    k = rng.randn(1, 2, lkv, 16).astype(np.float32)
    v = rng.randn(1, 2, lkv, 16).astype(np.float32)
    jpat = JP.build_block_pattern(JSpec(**fields), t, lkv, 16, 16,
                                  q_shift=pos0 - lo)
    want, wl = JF.swat_attention_fwd(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), JSpec(**fields),
        pattern=jpat, interpret=True, return_lse=True, q_offset=pos0,
        kv_offset=lo, seq_kv_bound=pos0 + t)
    tpat = kops.get_pattern(TSpec(**fields), t, lkv, 16, 16,
                            q_shift=pos0 - lo)
    got, gl = TF.banded_plain(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        TSpec(**fields), tpat, 16 ** -0.5, return_lse=True, q_offset=pos0,
        kv_offset=lo, seq_kv_bound=pos0 + t)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)
    np.testing.assert_allclose(gl.numpy(), np.asarray(wl)[..., :t], **F32)


def test_get_pattern_caches_by_q_shift():
    spec = TSpec(**SWAT)
    a = kops.get_pattern(spec, 8, 32, 16, 16, q_shift=24)
    assert a is kops.get_pattern(spec, 8, 32, 16, 16, q_shift=24)
    assert a is not kops.get_pattern(spec, 8, 32, 16, 16, q_shift=0)


def _configs(case):
    arch = "gemma2_2b" if case == "gemma2" else "llama3p2_1b"
    cfg, tcfg = get_smoke_config(arch), t_smoke(arch)
    if case == "swat":
        cfg = with_swat(cfg, window=16, num_global=4)
        tcfg = t_swat(tcfg, window=16, num_global=4)
    return cfg, tcfg


@pytest.fixture(scope="module", params=["swat", "gemma2", "dense"])
def model(request):
    cfg, tcfg = _configs(request.param)
    jp = JM.init_model(jax.random.PRNGKey(0), cfg)
    tp = interop.params_from_jax(jax.tree.map(np.asarray, jp), tcfg,
                                 device="cpu")
    return cfg, tcfg, jp, tp


def _chunks(cfg, lengths=(40, 27), chunk=8, l_pad=40):
    rng = np.random.RandomState(4)
    tok = rng.randint(0, cfg.vocab_size, (len(lengths), l_pad)
                      ).astype(np.int32)
    return tok, np.asarray(lengths, np.int32), chunk


def test_model_prefill_chunk_matches_jax(model):
    """Five chunks of 8 through the stack from fresh caches (the SWAT ring
    of 21 rows wraps twice; row 1 ends inside chunk 3): hidden states and
    caches after every chunk against JAX's `prefill_chunk`."""
    cfg, tcfg, jp, tp = model
    tok, lens, c = _chunks(cfg)
    jc = JM.init_caches(cfg, 2, 64)
    tc = TM.init_caches(tcfg, 2, 64, device="cpu")
    for p in range(0, tok.shape[1], c):
        jx, jc = JM.prefill_chunk(jp, cfg, {"tokens": jnp.asarray(
            tok[:, p:p + c])}, jc, p, jnp.asarray(lens))
        tx = TM.prefill_chunk(tp, tcfg, {"tokens": torch.from_numpy(
            tok[:, p:p + c])}, tc, p, torch.from_numpy(lens))
        np.testing.assert_allclose(tx.numpy(), np.asarray(jx), **F32)
        got = interop.caches_to_numpy(tc)
        for name, layer in jax.tree.map(np.asarray, jc).items():
            np.testing.assert_array_equal(got[name]["step"], layer["step"])
            for leaf in ("k", "v"):
                np.testing.assert_allclose(got[name][leaf], layer[leaf],
                                           **F32, err_msg=f"{p} {name}")


def test_model_prefill_chunk_route_matches_plain(model):
    """The whole stack with every layer's chunk attention on the card
    route's algorithm (impl "kernel") against the plain version: hidden
    states at real positions and caches."""
    cfg, tcfg, jp, tp = model
    tok, lens, c = _chunks(cfg)
    caches = {impl: TM.init_caches(tcfg, 2, 64, device="cpu")
              for impl in ("kernel", "banded")}
    valid_rows = [np.arange(c)[None, :] + p < lens[:, None]
                  for p in range(0, tok.shape[1], c)]
    for valid, p in zip(valid_rows, range(0, tok.shape[1], c)):
        xs = {impl: TM.prefill_chunk(
            tp, tcfg, {"tokens": torch.from_numpy(tok[:, p:p + c])},
            caches[impl], p, torch.from_numpy(lens), impl=impl).numpy()
            for impl in caches}
        np.testing.assert_allclose(xs["kernel"][valid], xs["banded"][valid],
                                   **F32)
    got = interop.caches_to_numpy(caches["kernel"])
    want = interop.caches_to_numpy(caches["banded"])
    for name in want:
        np.testing.assert_array_equal(got[name]["step"], want[name]["step"])
        for leaf in ("k", "v"):
            np.testing.assert_allclose(got[name][leaf], want[name][leaf],
                                       **F32)


def test_prefill_chunk_refuses_unchunkable_configs():
    cfg = t_smoke("whisper_tiny")
    assert not TM.prefill_chunkable(cfg)
    assert not TM.speculative_supported(cfg)
    assert TM.prefill_chunkable(t_smoke("llama3p2_1b"))
    with pytest.raises(ValueError):
        TM.prefill_chunk({}, cfg, {"tokens": torch.zeros((1, 4))}, [], 0,
                         torch.ones((1,)))


@pytest.fixture(scope="module")
def swat_engine_setup():
    cfg, tcfg = _configs("swat")
    jp = JM.init_model(jax.random.PRNGKey(0), cfg)
    tp = interop.params_from_jax(jax.tree.map(np.asarray, jp), tcfg,
                                 device="cpu")
    return cfg, tcfg, jp, tp


def test_chunked_prefill_equals_single_shot(swat_engine_setup):
    """Mirror of the JAX engine's test: prompts long enough to wrap the
    ring (window 16, capacity 21 < prompt 40), chunk 8. Greedy tokens equal
    the port's single-shot engine and the JAX chunked engine; the prefill
    token count is the same."""
    cfg, tcfg, jp, tp = swat_engine_setup
    rng = np.random.RandomState(5)
    prompts = [rng.randint(0, cfg.vocab_size, (l,)).astype(np.int32)
               for l in (40, 9, 33)]

    def port(**kw):
        eng = ServingEngine(tcfg, tp, batch_slots=2, max_len=256, **kw)
        res = eng.run([Request(rid=i, prompt=p, max_new_tokens=5)
                       for i, p in enumerate(prompts)])
        return eng, {r.rid: r.tokens for r in res}

    base_eng, base = port()
    eng, got = port(prefill_chunk=8)
    jeng = JEngine(cfg, jp, batch_slots=2, max_len=256, prefill_chunk=8)
    want = {r.rid: r.tokens for r in jeng.run(
        [JRequest(rid=i, prompt=p, max_new_tokens=5)
         for i, p in enumerate(prompts)])}
    assert got == base == want
    assert eng.prefill_chunk == 8
    assert (eng.stats["prefill_tokens_computed"]
            == base_eng.stats["prefill_tokens_computed"]
            == jeng.stats["prefill_tokens_computed"] == 82)


def test_chunk_falls_to_zero_for_unchunkable_configs(swat_engine_setup):
    _, tcfg, _, tp = swat_engine_setup
    sinusoidal = dataclasses.replace(tcfg, use_rope=False)
    eng = ServingEngine(sinusoidal, tp, batch_slots=2, max_len=64,
                        prefill_chunk=8)
    assert eng.prefill_chunk == 0
