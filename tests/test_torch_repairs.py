"""Two faults of the port, each held by a test here.

F1: a train step left every param with requires_grad=True, so serving on
the trained params recorded autograd through the in-place cache updates
(and upcast the head on every decode step). After a train step no param
may require grad, and prefill, decode and the engine produce no grad_fn.

F2: the kernels took head dims 16..128 only, so gemma2-2b (head dim 256)
could not run on the card. Every kernel wrapper now takes D=256; here each
kernel's plain version is held against its Pallas kernel in interpret mode
at D=256 (gemma2's local window with softcap 50 and GQA group 2), at the
JAX package's tolerances (fp32 atol 2e-5 / rtol 1e-4; gradients atol 5e-5
/ rtol 1e-3; caches exactly). The kernels themselves run in
chip_smoke.py's gemma2 phase on the card."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import patterns as JP
from repro.core.types import AttentionSpec as JSpec
from repro.kernels import ops as JO
from repro.kernels.swat_attention import swat_attention_fwd as j_fwd
from repro.kernels.swat_backward import swat_attention_bwd as j_bwd
from repro.kernels.swat_decode import swat_decode as j_swat_decode
from repro_torch import tree
from repro_torch.configs import get_smoke_config, with_swat
from repro_torch.core import model as TM
from repro_torch.core import patterns as TP
from repro_torch.core.types import AttentionSpec as TSpec
from repro_torch.kernels import swat_attention as TA
from repro_torch.kernels import swat_backward as TB
from repro_torch.kernels import swat_decode as TD
from repro_torch.launch import steps as St
from repro_torch.optim import adamw
from repro_torch.serving.engine import Request, ServingEngine
from test_kernels import _fifo_ring_caches

torch.set_num_threads(1)

F32 = dict(atol=2e-5, rtol=1e-4)
GRAD = dict(atol=5e-5, rtol=1e-3)
D = 256
GEMMA_LOCAL = dict(kind="swat", window=24, num_global=0, causal=True,
                   softcap=50.0)


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


# ------------------------------------------------------------------ F1 ---

def _no_grad_anywhere(name, leaves):
    for i, t in enumerate(leaves):
        assert t.grad_fn is None, f"{name} leaf {i}: {t.grad_fn}"
        assert not t.requires_grad, f"{name} leaf {i} requires grad"


def test_serving_after_a_train_step_records_no_autograd():
    """One AdamW step, then prefill, three decode steps and an engine run
    on the same params: no param requires grad, and no logit or cache
    leaf carries a grad_fn."""
    cfg = with_swat(get_smoke_config("llama3.2-1b"), window=8, num_global=2)
    params = TM.init_model(cfg, seed=0, device="cpu")
    opt = adamw.init_opt_state(params)
    step = St.make_train_step(cfg, adamw.AdamWConfig(warmup_steps=1))
    rng = np.random.RandomState(0)
    tok = torch.from_numpy(rng.randint(0, cfg.vocab_size, (2, 16)))
    params, opt, metrics = step(params, opt, {"tokens": tok,
                                              "labels": tok.clone()})
    assert np.isfinite(float(metrics["loss"]))
    _no_grad_anywhere("params", tree.leaves(params))
    logits, caches = TM.prefill(params, cfg, {"tokens": tok}, 32)
    _no_grad_anywhere("prefill", [logits] + tree.leaves(caches))
    nxt = logits[:, 0].argmax(-1)
    for _ in range(3):
        logits, caches = TM.decode_step(params, cfg,
                                        {"tokens": nxt[:, None]}, caches)
        _no_grad_anywhere("decode", [logits] + tree.leaves(caches))
        nxt = logits[:, 0].argmax(-1)
    eng = ServingEngine(cfg, params, batch_slots=2, max_len=32,
                        scan_steps=2)
    res = eng.run([Request(rid=i, prompt=rng.randint(0, cfg.vocab_size, 10),
                           max_new_tokens=4) for i in range(3)])
    assert [r.status for r in res] == ["ok"] * 3
    _no_grad_anywhere("engine caches", tree.leaves(eng.caches))
    _no_grad_anywhere("params after serving", tree.leaves(params))


# ------------------------------------------------------------------ F2 ---

def test_every_wrapper_takes_head_dim_256():
    assert 256 in TA.HEAD_DIMS and 256 in TD.HEAD_DIMS
    spec = TSpec(**GEMMA_LOCAL)
    q, kv = torch.zeros(1, 4, 64, D), torch.zeros(1, 2, 64, D)
    pat = TP.build_block_pattern(spec, 64, 64, 32, 32)
    TA._check(q, kv, kv, pat)
    TB._check(q, kv, kv, q, torch.zeros(1, 4, 64), q, pat)
    pos = torch.full((1,), 40, dtype=torch.int32)
    q1, kv1 = torch.zeros(1, 4, 1, D), torch.zeros(1, 2, 1, D)
    TD._check_plain(q1, kv, kv, pos, 40, 0, True)
    TD._check(q1, kv, kv, kv1, kv1, pos, torch.ones(1, dtype=torch.int32),
              40, 0)
    with pytest.raises(ValueError, match="head dim"):
        TA._check(*(x[..., :192].contiguous() for x in (q, kv, kv)), pat)


@pytest.mark.parametrize("spec", [
    GEMMA_LOCAL, dict(kind="dense", causal=True, softcap=50.0)],
    ids=["local", "global"])
def test_forward_and_backward_at_d256_match_pallas(spec):
    """gemma2's local (window, softcap 50) and global (dense causal,
    softcap 50) layers at D=256, 4 q heads over 2 kv heads: the banded
    forward (O and LSE) and the dQ, dK/dV plain version against the JAX
    Pallas kernels in interpret mode."""
    jspec, tspec = JSpec(**spec), TSpec(**spec)
    rng = np.random.RandomState(1)
    l, blk = 96, 32
    q, do = (rng.randn(1, 4, l, D).astype(np.float32) for _ in range(2))
    k, v = (rng.randn(1, 2, l, D).astype(np.float32) for _ in range(2))
    jpat = JP.build_block_pattern(jspec, l, l, blk, blk)
    tpat = TP.build_block_pattern(tspec, l, l, blk, blk)
    jq, jk, jv = (jnp.asarray(x) for x in (q, k, v))
    o, lse = j_fwd(jq, jk, jv, jspec, pattern=jpat, interpret=True,
                   return_lse=True)
    got, got_lse = TA.swat_attention_fwd(_t(q), _t(k), _t(v), tspec,
                                         pattern=tpat, return_lse=True)
    np.testing.assert_allclose(got.numpy(), _np(o), **F32)
    np.testing.assert_allclose(got_lse.numpy(), _np(lse), **F32)
    want = j_bwd(jq, jk, jv, o, lse, jnp.asarray(do), jspec, pattern=jpat,
                 interpret=True)
    grads = TB.swat_attention_bwd(_t(q), _t(k), _t(v), _t(o), _t(lse),
                                  _t(do), tspec, pattern=tpat)
    for g, w, name in zip(grads, want, "qkv"):
        np.testing.assert_allclose(g.numpy(), _np(w), **GRAD,
                                   err_msg=f"d{name}")


@pytest.mark.parametrize("pack_gqa", [True, False])
def test_plain_decode_at_d256_matches_pallas(pack_gqa):
    rng = np.random.RandomState(2)
    cap = GEMMA_LOCAL["window"] + 1
    lens = [1, 10, cap, 3 * cap + 5]
    kc, vc = _fifo_ring_caches(rng, lens, 2, cap, 32, D)
    q = rng.randn(len(lens), 4, 1, D).astype(np.float32)
    want = j_swat_decode(jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc),
                         jnp.asarray(np.asarray(lens, np.int32)),
                         ring_cap=cap, window=GEMMA_LOCAL["window"],
                         softcap=50.0, pack_gqa=pack_gqa, interpret=True)
    got = TD.swat_decode_plain(_t(q), _t(kc), _t(vc),
                               torch.tensor(lens, dtype=torch.int32),
                               TSpec(**GEMMA_LOCAL), ring_cap=cap,
                               pack_gqa=pack_gqa)
    np.testing.assert_allclose(got.numpy(), _np(want), **F32)


def test_fused_decode_at_d256_matches_pallas():
    rng = np.random.RandomState(3)
    cap = GEMMA_LOCAL["window"] + 1
    lens = [0, 10, cap - 1, 3 * cap + 5]
    b = len(lens)
    kc, vc = _fifo_ring_caches(rng, lens, 2, cap, 32, D)
    q = rng.randn(b, 4, 1, D).astype(np.float32)
    nk, nv = (rng.randn(b, 2, 1, D).astype(np.float32) for _ in range(2))
    pos = np.asarray(lens, np.int32)
    jspec = JSpec(**GEMMA_LOCAL)
    o, kw, vw = JO.decode_attention(
        jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc), None, jspec,
        impl="pallas", interpret=True,
        new_kv=(jnp.asarray(nk), jnp.asarray(nv)), pos=jnp.asarray(pos),
        ring_cap=cap)
    tk, tv = _t(kc), _t(vc)
    got = TD.swat_decode_fused(_t(q), tk, tv, _t(nk), _t(nv),
                               torch.from_numpy(pos),
                               torch.ones(b, dtype=torch.int32),
                               TSpec(**dataclasses.asdict(jspec)),
                               ring_cap=cap)
    np.testing.assert_array_equal(tk.numpy(), _np(kw))
    np.testing.assert_array_equal(tv.numpy(), _np(vw))
    np.testing.assert_allclose(got.numpy(), _np(o), **F32)
