"""The port's whisper encoder-decoder against the JAX package on the CPU:
whisper-tiny smoke, dense and with SWAT, params converted from the JAX
pytree. The encoder, full-sequence logits and the loss value, prefill (last
logits, the decoder rings and the cross K/V "xk"/"xv"), then four decode
steps whose cross attention is a plain-mode decode over the encoder's K/V.
Also the internvl2 embeddings stub through the same `embed_tokens`. fp32
tolerance atol 2e-5 / rtol 1e-4; ring steps exactly."""
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
from repro_torch.serving.engine import ServingEngine

torch.set_num_threads(1)

F32 = dict(atol=2e-5, rtol=1e-4)
ENC_LEN = 40      # encoder frames: the SWAT band (window 8) is sparse there
PROMPT = 12       # decoder prompt: wraps the 11-row SWAT ring at prefill
MAX_LEN = 64


def _configs(case: str):
    """whisper-tiny smoke (2+2 layers, d_model 64, 4 heads, head dim 16),
    dense or + SWAT (window 8, 2 globals: the encoder's bidirectional band
    and the decoder's causal ring)."""
    cfg, tcfg = get_smoke_config("whisper_tiny"), t_smoke("whisper_tiny")
    if case == "swat":
        cfg = with_swat(cfg, window=8, num_global=2)
        tcfg = t_swat(tcfg, window=8, num_global=2)
    return cfg, tcfg


@pytest.fixture(scope="module", params=["dense", "swat"])
def setup(request):
    cfg, tcfg = _configs(request.param)
    jp = JM.init_model(jax.random.PRNGKey(0), cfg)
    tp = interop.params_from_jax(jax.tree.map(np.asarray, jp), tcfg,
                                 device="cpu")
    rng = np.random.RandomState(0)
    enc = rng.randn(2, ENC_LEN, cfg.d_model).astype(np.float32)
    tok = rng.randint(0, cfg.vocab_size, (2, PROMPT)).astype(np.int32)
    return cfg, tcfg, jp, tp, enc, tok


def _batches(enc, tok, labels=None):
    jb = {"enc_embeddings": jnp.asarray(enc), "tokens": jnp.asarray(tok)}
    tb = {"enc_embeddings": torch.from_numpy(enc),
          "tokens": torch.from_numpy(tok)}
    if labels is not None:
        jb["labels"] = jnp.asarray(labels)
        tb["labels"] = torch.from_numpy(labels)
    return jb, tb


def _compare_caches(tc, jc):
    got = interop.caches_to_numpy(tc)
    want = jax.tree.map(np.asarray, jc)
    for name in want:
        assert set(got[name]) == set(want[name]) == {"k", "v", "step", "xk",
                                                     "xv"}
        np.testing.assert_array_equal(got[name]["step"], want[name]["step"])
        for leaf in ("k", "v", "xk", "xv"):
            assert got[name][leaf].shape == want[name][leaf].shape, leaf
            np.testing.assert_allclose(got[name][leaf], want[name][leaf],
                                       **F32, err_msg=f"{name}/{leaf}")


def test_encode_matches(setup):
    cfg, tcfg, jp, tp, enc, tok = setup
    jb, tb = _batches(enc, tok)
    want = JM.encode(jp, cfg, jb)
    got = TM.encode(tp, tcfg, tb)
    assert got.shape == (2, ENC_LEN, cfg.d_model)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


def test_forward_logits_and_loss_match(setup):
    cfg, tcfg, jp, tp, enc, tok = setup
    labels = np.random.RandomState(1).randint(
        0, cfg.vocab_size, tok.shape).astype(np.int32)
    labels[0, :3] = -1
    jb, tb = _batches(enc, tok, labels)
    want, _ = JM.forward_logits(jp, cfg, jb, remat=False)
    got = TM.forward_logits(tp, tcfg, tb)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)
    jl, jm = JM.loss_fn(jp, cfg, jb, remat=False)
    tl, tm = TM.loss_fn(tp, tcfg, tb, remat=False)
    np.testing.assert_allclose(float(tl), float(jl), **F32)
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), **F32)
    assert float(tm["tokens"]) == float(jm["tokens"])


@pytest.mark.parametrize("impl", [None, "kernel"])
def test_prefill_and_decode_match(setup, impl):
    """Prefill (the encoder, then the decoder with its cross K/V cached),
    then four greedy decode steps. impl None runs the JAX ref routing of
    the cross decode (the valid-prefix mask); "kernel" runs the plain-mode
    kernel wrapper, whose CPU dispatch is its plain version (positional
    masks from pos = the encoder length)."""
    cfg, tcfg, jp, tp, enc, tok = setup
    jb, tb = _batches(enc, tok)
    jl, jc = JM.prefill(jp, cfg, jb, MAX_LEN)
    tl, tc = TM.prefill(tp, tcfg, tb, MAX_LEN, impl=impl)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **F32)
    _compare_caches(tc, jc)
    assert tc[0]["l0"]["xk"].shape == (2, cfg.num_kv_heads, ENC_LEN,
                                       cfg.resolved_head_dim)
    nxt = np.asarray(jl)[:, 0].argmax(-1).astype(np.int32)
    for _ in range(4):
        jl, jc = JM.decode_step(jp, cfg,
                                {"tokens": jnp.asarray(nxt)[:, None]}, jc)
        tl, tc = TM.decode_step(tp, tcfg,
                                {"tokens": torch.from_numpy(nxt)[:, None]},
                                tc, impl=impl)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **F32)
        assert np.array_equal(tl.numpy()[:, 0].argmax(-1),
                              np.asarray(jl)[:, 0].argmax(-1))
        nxt = np.asarray(jl)[:, 0].argmax(-1).astype(np.int32)
    _compare_caches(tc, jc)


def test_init_caches_holds_cross_kv():
    cfg, tcfg = _configs("swat")
    jc = JM.init_caches(cfg, 3, MAX_LEN, enc_len=ENC_LEN)
    tc = TM.init_caches(tcfg, 3, MAX_LEN, enc_len=ENC_LEN, device="cpu")
    got = interop.caches_to_numpy(tc)
    want = jax.tree.map(np.asarray, jc)
    for name in want:
        for leaf in want[name]:
            assert got[name][leaf].shape == want[name][leaf].shape, leaf
            assert not got[name][leaf].any()


def test_decode_from_converted_jax_caches(setup):
    """JAX prefill caches, cross K/V included, converted by
    `interop.caches_from_jax` feed the port's decode_step."""
    cfg, tcfg, jp, tp, enc, tok = setup
    jb, _ = _batches(enc, tok)
    _, jc = JM.prefill(jp, cfg, jb, MAX_LEN)
    tc = interop.caches_from_jax(jax.tree.map(np.asarray, jc), tcfg,
                                 device="cpu")
    _compare_caches(tc, jc)
    nxt = np.asarray([[3], [7]], np.int32)
    jl, jc = JM.decode_step(jp, cfg, {"tokens": jnp.asarray(nxt)}, jc)
    tl, tc = TM.decode_step(tp, tcfg, {"tokens": torch.from_numpy(nxt)}, tc)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **F32)
    _compare_caches(tc, jc)


def test_params_round_trip_with_encoder():
    cfg, tcfg = _configs("swat")
    jp = jax.tree.map(np.asarray, JM.init_model(jax.random.PRNGKey(1), cfg))
    back = interop.params_to_numpy(
        interop.params_from_jax(jp, tcfg, device="cpu"), tcfg)
    assert set(back) == set(jp) >= {"enc_blocks", "enc_norm"}
    for (pa, a), (pb, b) in zip(jax.tree_util.tree_leaves_with_path(jp),
                                jax.tree_util.tree_leaves_with_path(back)):
        assert pa == pb
        np.testing.assert_array_equal(np.asarray(a, np.float32), b)


def test_port_init_matches_jax_structure():
    cfg, tcfg = _configs("swat")
    jp = jax.tree.map(np.asarray, JM.init_model(jax.random.PRNGKey(0), cfg))
    tp = interop.params_to_numpy(TM.init_model(tcfg, device="cpu"), tcfg)
    jl = jax.tree_util.tree_leaves_with_path(jp)
    tl = jax.tree_util.tree_leaves_with_path(tp)
    assert [p for p, _ in jl] == [p for p, _ in tl]
    assert all(a.shape == b.shape for (_, a), (_, b) in zip(jl, tl))


def test_encoder_decoder_is_not_served_by_the_engine():
    """As in the JAX package: no padded prefill and no ServingEngine for
    encoder-decoder models."""
    _, tcfg = _configs("swat")
    tp = TM.init_model(tcfg, device="cpu")
    with pytest.raises(NotImplementedError):
        ServingEngine(tcfg, tp, batch_slots=2, max_len=MAX_LEN)
    batch = {"enc_embeddings": torch.zeros(2, ENC_LEN, tcfg.d_model),
             "tokens": torch.zeros(2, PROMPT, dtype=torch.int32)}
    with pytest.raises(ValueError):
        TM.prefill(tp, tcfg, batch, MAX_LEN,
                   lengths=torch.tensor([PROMPT, PROMPT - 2]))


def test_internvl2_embeddings_stub_matches():
    """The VLM frontend stub: precomputed patch embeddings bypass the token
    table (forward_logits), and decode embeds text tokens."""
    cfg, tcfg = get_smoke_config("internvl2_1b"), t_smoke("internvl2_1b")
    jp = JM.init_model(jax.random.PRNGKey(0), cfg)
    tp = interop.params_from_jax(jax.tree.map(np.asarray, jp), tcfg,
                                 device="cpu")
    emb = np.random.RandomState(2).randn(2, 24, cfg.d_model).astype(
        np.float32)
    want, _ = JM.forward_logits(jp, cfg, {"embeddings": jnp.asarray(emb)},
                                remat=False)
    got = TM.forward_logits(tp, tcfg, {"embeddings": torch.from_numpy(emb)})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)
