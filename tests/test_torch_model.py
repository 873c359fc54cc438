"""The port's attention-only model against the JAX package on the CPU:
llama3.2-1b smoke, dense and with SWAT, and gemma2-2b smoke, params
converted from the JAX pytree. Prefill logits and caches, then six decode steps that carry every
row's ring across a wrap. fp32 tolerance atol 2e-5 / rtol 1e-4; ring steps
exactly."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config, with_swat
from repro.core import model as JM
from repro_torch import interop
from repro_torch.configs import get_smoke_config as t_smoke
from repro_torch.configs import with_swat as t_swat
from repro_torch.core import model as TM

torch.set_num_threads(1)

F32 = dict(atol=2e-5, rtol=1e-4)


def _configs(case: str):
    """llama3.2-1b smoke, dense or + SWAT (window 16, 4 globals); gemma2-2b
    smoke (local/global alternation, per-layer rings, attention and final
    softcaps, embedding scale)."""
    arch = "gemma2_2b" if case == "gemma2" else "llama3p2_1b"
    cfg, tcfg = get_smoke_config(arch), t_smoke(arch)
    if case == "swat":
        cfg = with_swat(cfg, window=16, num_global=4)
        tcfg = t_swat(tcfg, window=16, num_global=4)
    return cfg, tcfg


@pytest.fixture(scope="module", params=["dense", "swat", "gemma2"])
def setup(request):
    cfg, tcfg = _configs(request.param)
    jp = JM.init_model(jax.random.PRNGKey(0), cfg)
    tp = interop.params_from_jax(jax.tree.map(np.asarray, jp), tcfg,
                                 device="cpu")
    return cfg, tcfg, jp, tp


def _compare_caches(tc, jc):
    got = interop.caches_to_numpy(tc)
    want = jax.tree.map(np.asarray, jc)
    for name in want:
        np.testing.assert_array_equal(got[name]["step"], want[name]["step"])
        for leaf in ("k", "v"):
            assert got[name][leaf].shape == want[name][leaf].shape
            np.testing.assert_allclose(got[name][leaf], want[name][leaf],
                                       **F32, err_msg=f"{name}/{leaf}")


def test_forward_logits_match(setup):
    cfg, tcfg, jp, tp = setup
    tok = np.random.RandomState(0).randint(0, cfg.vocab_size, (2, 40))
    want, _ = JM.forward_logits(jp, cfg, {"tokens": jnp.asarray(tok)},
                                remat=False)
    got = TM.forward_logits(tp, tcfg, {"tokens": torch.from_numpy(tok)})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


def test_prefill_and_decode_across_ring_wrap(setup):
    """Padded batched prefill (ragged lengths), then six decode steps: the
    SWAT rows (ring capacity 21) cross their wrap point mid-way."""
    cfg, tcfg, jp, tp = setup
    rng = np.random.RandomState(1)
    max_len = 64
    tok = rng.randint(0, cfg.vocab_size, (2, 24)).astype(np.int32)
    lengths = np.asarray([18, 24], np.int32)
    jl, jc = JM.prefill(jp, cfg, {"tokens": jnp.asarray(tok)}, max_len,
                        lengths=jnp.asarray(lengths))
    tl, tc = TM.prefill(tp, tcfg, {"tokens": torch.from_numpy(tok)}, max_len,
                        lengths=torch.from_numpy(lengths))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **F32)
    _compare_caches(tc, jc)
    nxt = np.asarray(jl)[:, 0].argmax(-1).astype(np.int32)
    for _ in range(6):
        jl, jc = JM.decode_step(jp, cfg, {"tokens": jnp.asarray(nxt)[:, None]},
                                jc)
        tl, tc = TM.decode_step(tp, tcfg,
                                {"tokens": torch.from_numpy(nxt)[:, None]},
                                tc)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **F32)
        nxt = np.asarray(jl)[:, 0].argmax(-1).astype(np.int32)
    _compare_caches(tc, jc)


def test_decode_from_converted_jax_caches(setup):
    """JAX prefill caches converted by `interop.caches_from_jax` feed the
    port's decode_step: logits and updated caches match JAX's decode."""
    cfg, tcfg, jp, tp = setup
    rng = np.random.RandomState(3)
    tok = rng.randint(0, cfg.vocab_size, (2, 30)).astype(np.int32)
    nxt = rng.randint(0, cfg.vocab_size, (2, 1)).astype(np.int32)
    _, jc = JM.prefill(jp, cfg, {"tokens": jnp.asarray(tok)}, 64)
    tc = interop.caches_from_jax(jax.tree.map(np.asarray, jc), tcfg,
                                 device="cpu")
    _compare_caches(tc, jc)
    jl, jc = JM.decode_step(jp, cfg, {"tokens": jnp.asarray(nxt)}, jc)
    tl, tc = TM.decode_step(tp, tcfg, {"tokens": torch.from_numpy(nxt)}, tc)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **F32)
    _compare_caches(tc, jc)


def test_multi_token_decode_matches(setup):
    """T=3 decode_step on caches allocated with lookahead 2."""
    cfg, tcfg, jp, tp = setup
    rng = np.random.RandomState(2)
    tok = rng.randint(0, cfg.vocab_size, (2, 20)).astype(np.int32)
    nxt = rng.randint(0, cfg.vocab_size, (2, 3)).astype(np.int32)
    _, jc = JM.prefill(jp, cfg, {"tokens": jnp.asarray(tok)}, 64,
                       lookahead=2)
    _, tc = TM.prefill(tp, tcfg, {"tokens": torch.from_numpy(tok)}, 64,
                       lookahead=2)
    jl, jc = JM.decode_step(jp, cfg, {"tokens": jnp.asarray(nxt)}, jc,
                            lookahead=2)
    tl, tc = TM.decode_step(tp, tcfg, {"tokens": torch.from_numpy(nxt)}, tc,
                            lookahead=2)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **F32)
    _compare_caches(tc, jc)


def test_unported_layer_kinds_raise():
    """Every layer kind of the JAX package is ported: `_check_supported`
    refuses only a kind outside `_KINDS`, here a made-up one."""
    tcfg = dataclasses.replace(t_smoke("mamba2_1p3b"),
                               layer_pattern=("conv_lstm",))
    with pytest.raises(NotImplementedError, match="conv_lstm"):
        TM.init_model(tcfg, device="cpu")
    TM.init_model(t_smoke("mamba2_1p3b"), device="cpu")


def test_init_model_is_seeded():
    _, tcfg = _configs("swat")
    a = TM.init_model(tcfg, seed=3, device="cpu")
    b = TM.init_model(tcfg, seed=3, device="cpu")
    c = TM.init_model(tcfg, seed=4, device="cpu")
    wq = lambda p: p["blocks"][1]["l0"]["mixer"]["wq"]
    assert torch.equal(wq(a), wq(b)) and not torch.equal(wq(a), wq(c))
    assert float(wq(a).abs().max()) <= 2.0 * tcfg.d_model ** -0.5 + 1e-6
    assert len(a["blocks"]) == tcfg.num_super_blocks
