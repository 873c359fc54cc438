"""The port's training path against the JAX package, on the CPU: the fp32
unembed, loss_fn and every gradient leaf (kernel Function and banded impls,
remat on, off and "dots"), AdamW, int8 compression, the synthetic data, and
train steps by their loss and grad-norm trajectory. fp32 tolerance atol
2e-5 / rtol 1e-4 unless a test says otherwise."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config, with_swat
from repro.core import model as JM
from repro.data.pipeline import DataConfig as JDataConfig
from repro.data.pipeline import SyntheticLM as JSyntheticLM
from repro.launch import steps as JSt
from repro.optim import adamw as JA
from repro.optim import compress as JC
from repro_torch import interop
from repro_torch import tree
from repro_torch.configs import get_smoke_config as t_smoke
from repro_torch.configs import with_swat as t_swat
from repro_torch.core import model as TM
from repro_torch.data.pipeline import DataConfig, SyntheticLM
from repro_torch.launch import steps as TSt
from repro_torch.optim import adamw as TA
from repro_torch.optim import compress as TC

torch.set_num_threads(1)

F32 = dict(atol=2e-5, rtol=1e-4)


def _configs(case: str):
    cfg, tcfg = get_smoke_config("llama3p2_1b"), t_smoke("llama3p2_1b")
    if case == "swat":
        cfg = with_swat(cfg, window=16, num_global=4)
        tcfg = t_swat(tcfg, window=16, num_global=4)
    return cfg, tcfg


def _batch(cfg, seed=0, b=2, l=40):
    rng = np.random.RandomState(seed)
    tok = rng.randint(0, cfg.vocab_size, (b, l)).astype(np.int32)
    labels = tok.copy()
    labels[0, 7:11] = -1                      # masked positions
    return tok, labels


# ------------------------------------------------------------ unembed ------

def test_unembed_is_fp32_accumulated_like_jax():
    """bf16 activations and head: the port's logits are the fp32-accumulated
    product, as JAX's (preferred_element_type=float32), not a product
    rounded to bf16 (~4e-3 relative). The activations are +-1 so the final
    rmsnorm maps them to exactly +-1 in bf16 in both frameworks."""
    cfg = dataclasses.replace(get_smoke_config("llama3p2_1b"),
                              dtype="bfloat16")
    tcfg = dataclasses.replace(t_smoke("llama3p2_1b"), dtype="bfloat16")
    rng = np.random.RandomState(0)
    emb = (rng.randn(cfg.vocab_size, cfg.d_model) * 0.02).astype(np.float32)
    x = np.where(rng.rand(2, 5, cfg.d_model) < 0.5, -1.0, 1.0)
    scale = np.zeros((cfg.d_model,), np.float32)
    jp = {"embed": jnp.asarray(emb, jnp.bfloat16),
          "final_norm": {"scale": jnp.asarray(scale)}}
    want = np.asarray(JM._unembed(jp, cfg, jnp.asarray(x, jnp.bfloat16)))
    tp = {"embed": torch.from_numpy(emb).to(torch.bfloat16),
          "final_norm": {"scale": torch.from_numpy(scale)}}
    got = TM._unembed(tp, tcfg, torch.from_numpy(x).to(torch.bfloat16))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)


# ------------------------------------------------------ loss and grads -----

@pytest.fixture(scope="module", params=["dense", "swat"])
def model_case(request):
    """JAX loss, metrics and gradients (impl="xla") on converted params."""
    cfg, tcfg = _configs(request.param)
    jp = JM.init_model(jax.random.PRNGKey(0), cfg)
    tok, labels = _batch(cfg)
    jb = {"tokens": jnp.asarray(tok), "labels": jnp.asarray(labels)}
    (total, metrics), grads = jax.value_and_grad(
        lambda p: JM.loss_fn(p, cfg, jb, impl="xla"), has_aux=True)(jp)
    np_params = jax.tree.map(np.asarray, jp)
    want = dict(total=float(total),
                metrics={k: float(v) for k, v in metrics.items()},
                grads=jax.tree.map(np.asarray, grads))
    return cfg, tcfg, np_params, (tok, labels), want


def _port_value_and_grad(tcfg, np_params, batch, **kw):
    tp = interop.params_from_jax(np_params, tcfg, device="cpu")
    leaves = tree.leaves(tp)
    for p in leaves:
        p.requires_grad_(True)
    tok, labels = batch
    total, metrics = TM.loss_fn(tp, tcfg, {"tokens": torch.from_numpy(tok),
                                           "labels": torch.from_numpy(labels)},
                                **kw)
    grads = torch.autograd.grad(total, leaves)
    return total, metrics, tree.unflatten(tp, list(grads))


@pytest.mark.parametrize("impl", ["kernel", "banded"])
def test_loss_and_every_grad_leaf_match_jax(model_case, impl):
    cfg, tcfg, np_params, batch, want = model_case
    total, metrics, grads = _port_value_and_grad(tcfg, np_params, batch,
                                                 impl=impl)
    np.testing.assert_allclose(float(total.detach()), want["total"], **F32)
    assert set(metrics) == set(want["metrics"])
    for k, v in want["metrics"].items():
        np.testing.assert_allclose(float(metrics[k]), v, **F32, err_msg=k)
    got = interop.params_to_numpy(grads, tcfg)
    flat_w = dict(tree.flatten_with_paths(want["grads"]))
    flat_g = dict(tree.flatten_with_paths(got))
    assert flat_g.keys() == flat_w.keys()
    for path, w in flat_w.items():
        assert flat_g[path].shape == w.shape, path
        np.testing.assert_allclose(flat_g[path], w, **F32, err_msg=path)


def test_remat_policies_give_the_same_gradients(model_case):
    _, tcfg, np_params, batch, _ = model_case
    runs = [_port_value_and_grad(tcfg, np_params, batch, impl="kernel",
                                 remat=remat, remat_policy=policy)
            for remat, policy in ((False, "nothing"), (True, "nothing"),
                                  (True, "dots"))]
    ref = tree.leaves(runs[0][2])
    for total, _, grads in runs[1:]:
        assert float(total.detach()) == float(runs[0][0].detach())
        for a, b in zip(tree.leaves(grads), ref):
            np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-7,
                                       rtol=1e-6)


def test_params_to_numpy_inverts_params_from_jax():
    cfg, tcfg = _configs("swat")
    want = jax.tree.map(np.asarray, JM.init_model(jax.random.PRNGKey(1), cfg))
    got = interop.params_to_numpy(
        interop.params_from_jax(want, tcfg, device="cpu"), tcfg)
    flat_w = dict(tree.flatten_with_paths(want))
    flat_g = dict(tree.flatten_with_paths(got))
    assert flat_g.keys() == flat_w.keys()
    for path, w in flat_w.items():
        np.testing.assert_array_equal(flat_g[path], w, err_msg=path)


# ----------------------------------------------------------- optimizer -----

def _opt_tree(rng):
    return {"w": rng.randn(6, 8).astype(np.float32),
            "b": rng.randn(8).astype(np.float32),
            "blocks": [{"k": rng.randn(3, 4).astype(np.float32)}]}


def test_adamw_matches_jax():
    """Three steps on identical params and gradients (warmup, clipping on
    the first step, decay on the 2-D leaves only)."""
    cfg = TA.AdamWConfig(lr=1e-2, warmup_steps=2, total_steps=10,
                         grad_clip=1.0)
    jcfg = JA.AdamWConfig(**dataclasses.asdict(cfg))
    rng = np.random.RandomState(0)
    params = _opt_tree(rng)
    jparams = jax.tree.map(jnp.asarray, params)
    tparams = tree.tree_map(torch.from_numpy, params)
    jstate, tstate = JA.init_opt_state(jparams), TA.init_opt_state(tparams)
    for step in range(3):
        g = tree.tree_map(lambda a: rng.randn(*a.shape).astype(np.float32)
                          * (5.0 if step == 0 else 0.1), params)
        jparams, jstate, jm = JA.apply_updates(
            jparams, jax.tree.map(jnp.asarray, g), jstate, jcfg)
        tparams, tstate, tm = TA.apply_updates(
            tparams, tree.tree_map(torch.from_numpy, g), tstate, cfg)
        for k in ("grad_norm", "lr"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]),
                                       rtol=1e-6, err_msg=k)
        assert int(tstate.step) == int(jstate.step) == step + 1
        for got, want in ((tparams, jparams), (tstate.mu, jstate.mu),
                          (tstate.nu, jstate.nu)):
            for a, b in zip(tree.leaves(got), jax.tree.leaves(want)):
                np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                           rtol=1e-5, atol=1e-7)


def test_adamw_keeps_param_dtype_and_updates_in_place():
    p = {"w": torch.ones(4, 4, dtype=torch.bfloat16)}
    ptr = p["w"].data_ptr()
    state = TA.init_opt_state(p)
    p2, state, _ = TA.apply_updates(p, {"w": torch.full((4, 4), 0.5)},
                                    state, TA.AdamWConfig(lr=0.1,
                                                           warmup_steps=0))
    assert p2["w"].dtype == torch.bfloat16 and p2["w"].data_ptr() == ptr
    assert state.mu["w"].dtype == torch.float32
    assert float(p2["w"][0, 0]) < 1.0


def test_schedule_and_global_norm_match_jax():
    cfg = TA.AdamWConfig(lr=1.0, warmup_steps=10, total_steps=100,
                         min_lr_ratio=0.1)
    jcfg = JA.AdamWConfig(**dataclasses.asdict(cfg))
    for step in (0, 1, 5, 10, 11, 50, 99, 100, 150):
        np.testing.assert_allclose(float(TA.schedule(cfg, step)),
                                   float(JA.schedule(jcfg,
                                                     jnp.asarray(step))),
                                   rtol=1e-6, atol=1e-8, err_msg=str(step))
    g = _opt_tree(np.random.RandomState(1))
    np.testing.assert_allclose(
        float(TA.global_norm(tree.tree_map(torch.from_numpy, g))),
        float(JA.global_norm(jax.tree.map(jnp.asarray, g))), rtol=1e-6)


def test_compress_decompress_matches_jax():
    rng = np.random.RandomState(2)
    g = _opt_tree(rng)
    r = tree.tree_map(lambda a: (rng.randn(*a.shape) * 0.01)
                      .astype(np.float32), g)
    jg, jr = JC.compress_decompress(jax.tree.map(jnp.asarray, g),
                                    jax.tree.map(jnp.asarray, r))
    tg, tr = TC.compress_decompress(tree.tree_map(torch.from_numpy, g),
                                    tree.tree_map(torch.from_numpy, r))
    for got, want in ((tg, jg), (tr, jr)):
        for a, b in zip(tree.leaves(got), jax.tree.leaves(want)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                       atol=1e-8)
    zero = TC.init_residual(tree.tree_map(torch.from_numpy, g))
    assert all(float(z.abs().max()) == 0.0 for z in tree.leaves(zero))


# ---------------------------------------------------------------- data -----

@pytest.mark.parametrize("vocab,seq,batch,seed", [(97, 64, 8, 3),
                                                  (256, 200, 4, 1234)])
def test_synthetic_batches_are_bitwise_jax(vocab, seq, batch, seed):
    kw = dict(vocab_size=vocab, seq_len=seq, global_batch=batch, seed=seed)
    mine, ref = SyntheticLM(DataConfig(**kw)), JSyntheticLM(JDataConfig(**kw))
    for step in (0, 5, 1000):
        a, b = mine.global_batch(step), ref.global_batch(step)
        for k in ("tokens", "labels"):
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])


# --------------------------------------------------------- train steps -----

def test_train_step_trajectory_matches_jax():
    """Four train steps from the same params and batches: loss and grad
    norm per step within rtol 1e-4. Params are not compared elementwise
    after step 1: AdamW's first update is +-lr by each gradient's sign, so
    fp32 noise on near-zero gradients flips single elements."""
    cfg, tcfg = _configs("swat")
    opt = JA.AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=4)
    topt = TA.AdamWConfig(**dataclasses.asdict(opt))
    data = JSyntheticLM(JDataConfig(vocab_size=cfg.vocab_size, seq_len=32,
                                    global_batch=4, seed=7))
    jp = JM.init_model(jax.random.PRNGKey(0), cfg)
    tp = interop.params_from_jax(jax.tree.map(np.asarray, jp), tcfg,
                                 device="cpu")
    jstate, tstate = JA.init_opt_state(jp), TA.init_opt_state(tp)
    jstep = jax.jit(JSt.make_train_step(cfg, opt))
    tstep = TSt.make_train_step(tcfg, topt)
    for step in range(4):
        batch = data.global_batch(step)
        jp, jstate, jm = jstep(jp, jstate, {k: jnp.asarray(v)
                                            for k, v in batch.items()})
        tp, tstate, tm = tstep(tp, tstate, {k: torch.from_numpy(v)
                                            for k, v in batch.items()})
        for k in ("loss", "grad_norm", "lr"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]),
                                       rtol=1e-4, err_msg=f"{k} @ {step}")


def test_eval_step_reports_the_loss():
    _, tcfg = _configs("swat")
    tp = TM.init_model(tcfg, seed=0, device="cpu")
    tok, labels = _batch(tcfg)
    batch = {"tokens": torch.from_numpy(tok),
             "labels": torch.from_numpy(labels)}
    m = TSt.make_eval_step(tcfg)(tp, batch)
    total, want = TM.loss_fn(tp, tcfg, batch, remat=False)
    assert float(m["loss"]) == float(want["loss"])
    assert float(m["tokens"]) == float((torch.from_numpy(labels)[:, 1:]
                                        >= 0).sum())
