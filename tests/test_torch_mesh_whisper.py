"""The mesh gaps the dry-run's cells reach, against the JAX package's
single-device functions on the CPU: whisper on a mesh (the encoder on each
coordinate's rows, the cross K/V placed by the cache table, prefill,
decode steps and a train step's loss and every gradient leaf), internvl2's
`"embeddings"` input through the mesh embed, and the cp and fsdp train
profiles (`TrainPlan(profile=)`: one AdamW step against the JAX
`make_train_step`). Smoke configs, fp32, params from JAX `init_model`
through `interop`; atol 1e-5 / rtol 1e-4 (the params after an AdamW step:
atol 2e-5, as tests/test_torch_train_mesh.py holds them)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config, with_swat
from repro.core import model as JM
from repro.launch import steps as JSt
from repro.optim import adamw as JA
from repro_torch import interop, tree
from repro_torch.configs import get_smoke_config as t_smoke
from repro_torch.configs import with_swat as t_swat
from repro_torch.core import model as TM
from repro_torch.distributed import sharding as Sh
from repro_torch.distributed import tensor_parallel as TP
from repro_torch.distributed import train_parallel as TPL
from repro_torch.launch import mesh as ML
from repro_torch.launch import steps as TSt
from repro_torch.optim import adamw as TA

torch.set_num_threads(1)

TOL = dict(atol=1e-5, rtol=1e-4)
# params after an AdamW step: test_torch_train_mesh.py's tolerance for the
# same comparison (the step divides by sqrt(nu), which magnifies the
# gradient's summation order on small elements)
F32 = dict(atol=2e-5, rtol=1e-4)
B, PROMPT, ENC, MAX_LEN = 4, 12, 40, 64
SHAPES = ((1, 2), (2, 2))


def _pair(arch, swat=True):
    cfg, tcfg = get_smoke_config(arch), t_smoke(arch)
    if swat:
        cfg, tcfg = with_swat(cfg, 16, 4), t_swat(tcfg, 16, 4)
    return cfg, tcfg


def _mesh(shape):
    return ML.LocalMesh(shape, ("data", "model"))


@pytest.fixture(scope="module")
def whisper():
    """JAX whisper-tiny smoke + SWAT: params, inputs, prefill logits and
    caches, three greedy decode steps' logits, the loss and gradients."""
    cfg, tcfg = _pair("whisper_tiny")
    jp = JM.init_model(jax.random.PRNGKey(0), cfg)
    rng = np.random.RandomState(0)
    enc = rng.randn(B, ENC, cfg.d_model).astype(np.float32)
    tok = rng.randint(0, cfg.vocab_size, (B, PROMPT)).astype(np.int32)
    labels = tok.copy()
    labels[1, 3:6] = -1
    lg, caches = JM.prefill(jp, cfg, {"tokens": jnp.asarray(tok),
                                      "enc_embeddings": jnp.asarray(enc)},
                            MAX_LEN)
    steps, nxt = [], np.argmax(np.asarray(lg)[:, -1], -1)[:, None]
    for _ in range(3):
        steps.append(nxt.astype(np.int32))
        out, caches = JM.decode_step(jp, cfg, {"tokens": jnp.asarray(
            steps[-1])}, caches)
        steps[-1] = (steps[-1], np.asarray(out))
        nxt = np.argmax(np.asarray(out)[:, -1], -1)[:, None]
    jb = {"tokens": jnp.asarray(tok), "labels": jnp.asarray(labels),
          "enc_embeddings": jnp.asarray(enc)}
    (_, metrics), grads = jax.value_and_grad(
        lambda p: JM.loss_fn(p, cfg, jb, remat=False), has_aux=True)(jp)
    return dict(tcfg=tcfg, np=jax.tree.map(np.asarray, jp), enc=enc,
                tok=tok, labels=labels, prefill=np.asarray(lg), steps=steps,
                metrics={k: float(v) for k, v in metrics.items()},
                grads=jax.tree.map(np.asarray, grads))


def _rows(plan, n, x):
    """Each coordinate's rows of x as the plan's prefill splits them."""
    per = n // plan.groups if plan.splits(n) else n
    return [x[plan.group(c) * per:][:per] if plan.splits(n) else x
            for c in plan.coords]


@pytest.mark.parametrize("shape", SHAPES)
def test_whisper_prefill_and_decode_on_a_mesh(whisper, shape):
    """The encoder on each coordinate's rows, the decoder's Megatron heads,
    the cross K/V cut by the cache table: prefill logits and three decode
    steps' logits equal the JAX single-device functions'."""
    w = whisper
    tcfg = w["tcfg"]
    params = interop.params_from_jax(w["np"], tcfg, device="cpu")
    plan = TP.MeshPlan(tcfg, _mesh(shape), params, slots=B, max_len=MAX_LEN,
                       lookahead=0, paged=False, enc_len=ENC)
    assert plan.describe()["attention_tp"] == {0: True}
    ps = plan.place_params(params)
    batches = [{"tokens": torch.from_numpy(t).long(),
                "enc_embeddings": torch.from_numpy(e)}
               for t, e in zip(_rows(plan, B, w["tok"]),
                               _rows(plan, B, w["enc"]))]
    lgs, pcaches = TM.prefill(ps, tcfg, batches, MAX_LEN, plan=plan)
    np.testing.assert_allclose(plan.join_rows(lgs).numpy(), w["prefill"],
                               **TOL)
    caches = plan.caches_from_prefill(pcaches)
    # the cross K/V as the cache table places it (heads over 'model')
    full = torch.empty(B, tcfg.num_kv_heads, ENC, tcfg.resolved_head_dim)
    for c, coord in zip(caches, plan.coords):
        assert c[0]["l0"]["xk"].shape == Sh.shard_at(
            full, plan.cache_specs[0]["l0"]["xk"], plan.mesh, coord).shape
    assert caches[0][0]["l0"]["xk"].shape[1] == tcfg.num_kv_heads // shape[1]
    for tok, want in w["steps"]:
        rows = plan.local_rows(torch.from_numpy(tok).long(), 0)
        out, _ = TM.decode_step(ps, tcfg, [{"tokens": r} for r in rows],
                                caches, plan=plan)
        np.testing.assert_allclose(plan.join_rows(out).numpy(), want, **TOL)


def _grads(tcfg, plan, params, batch):
    leaves = TSt.unique_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    try:
        total, metrics = plan.train_loss(params, tcfg, batch, remat=True)
        grads = torch.autograd.grad(total, leaves)
    finally:
        for p in leaves:
            p.requires_grad_(False)
    by_id = {id(x): g for x, g in zip(leaves, grads)}
    return ({k: float(v) for k, v in metrics.items()},
            plan.gather_tree([tree.tree_map(lambda x: by_id[id(x)], t)
                              for t in params]))


def _check_grads(tcfg, got, want):
    got = dict(tree.flatten_with_paths(interop.params_to_numpy(got, tcfg)))
    flat = tree.flatten_with_paths(want)
    assert got.keys() == dict(flat).keys()
    for path, w in flat:
        np.testing.assert_allclose(got[path], w, **TOL, err_msg=path)


@pytest.mark.parametrize("shape", SHAPES)
def test_whisper_train_step_on_a_mesh(whisper, shape):
    """A mesh train step of whisper (tp + sequence parallelism): the loss,
    token count and every gradient leaf, encoder and cross attention
    included, equal JAX `loss_fn` / `jax.grad` on one device."""
    w = whisper
    tcfg = w["tcfg"]
    mesh = _mesh(shape)
    plan = TPL.TrainPlan(tcfg, mesh, Sh.activation_spec(mesh))
    batch = {"tokens": torch.from_numpy(w["tok"]).long(),
             "labels": torch.from_numpy(w["labels"]).long(),
             "enc_embeddings": torch.from_numpy(w["enc"])}
    metrics, grads = _grads(tcfg, plan, plan.place(interop.params_from_jax(
        w["np"], tcfg, device="cpu")), batch)
    for k in ("loss", "tokens"):
        np.testing.assert_allclose(metrics[k], w["metrics"][k], **TOL)
    _check_grads(tcfg, grads, w["grads"])


def test_internvl2_embeddings_on_a_mesh():
    """The VLM stub's `"embeddings"` through the mesh embed (no lookup),
    prefill on a serving plan and the loss and gradients on a train plan,
    on 2x2, against JAX."""
    cfg, tcfg = _pair("internvl2_1b", swat=False)
    jp = JM.init_model(jax.random.PRNGKey(0), cfg)
    rng = np.random.RandomState(1)
    emb = rng.randn(B, PROMPT, cfg.d_model).astype(np.float32)
    labels = rng.randint(0, cfg.vocab_size, (B, PROMPT)).astype(np.int32)
    want_lg, _ = JM.prefill(jp, cfg, {"embeddings": jnp.asarray(emb)},
                            MAX_LEN)
    jb = {"embeddings": jnp.asarray(emb), "labels": jnp.asarray(labels)}
    (_, want_m), want_g = jax.value_and_grad(
        lambda p: JM.loss_fn(p, cfg, jb, remat=False), has_aux=True)(jp)
    params = interop.params_from_jax(jax.tree.map(np.asarray, jp), tcfg,
                                     device="cpu")
    mesh = _mesh((2, 2))
    plan = TP.MeshPlan(tcfg, mesh, params, slots=B, max_len=MAX_LEN,
                       lookahead=0, paged=False)
    lgs, _ = TM.prefill(plan.place_params(params), tcfg,
                        [{"embeddings": torch.from_numpy(e)}
                         for e in _rows(plan, B, emb)], MAX_LEN, plan=plan)
    np.testing.assert_allclose(plan.join_rows(lgs).numpy(),
                               np.asarray(want_lg), **TOL)
    tplan = TPL.TrainPlan(tcfg, mesh, Sh.activation_spec(mesh))
    metrics, grads = _grads(tcfg, tplan, tplan.place(params),
                            {"embeddings": torch.from_numpy(emb),
                             "labels": torch.from_numpy(labels).long()})
    np.testing.assert_allclose(metrics["loss"], float(want_m["loss"]),
                               **TOL)
    _check_grads(tcfg, grads, jax.tree.map(np.asarray, want_g))


PROFILE_L = {"cp": 256, "fsdp": 32}


@pytest.mark.parametrize("arch,profile", [
    (a, p) for a in ("llama3p2_1b", "granite_moe_1b")
    for p in ("cp", "fsdp")])
def test_profile_adamw_step_matches_jax(arch, profile):
    """One AdamW step under the cp profile (2-D FSDP params, the sequence
    over 'model', the window layers' halo exchange) or the fsdp one (the
    batch over every axis) on 2x2: the clipping norm and every param equal
    the JAX single-device `make_train_step`'s. cp at 256 positions, so that
    each of the two 'model' shards holds the 128 rows context parallelism
    takes."""
    cfg, tcfg = _pair(arch)
    length = PROFILE_L[profile]
    rng = np.random.RandomState(2)
    tok = rng.randint(0, cfg.vocab_size, (B, length)).astype(np.int32)
    labels = tok.copy()
    labels[2, 7:19] = -1
    jp = JM.init_model(jax.random.PRNGKey(0), cfg)
    opt = JA.AdamWConfig(warmup_steps=1, total_steps=10)
    out = jax.jit(JSt.make_train_step(cfg, opt))(
        jp, JA.init_opt_state(jp), {"tokens": jnp.asarray(tok),
                                    "labels": jnp.asarray(labels)})
    want = jax.tree.map(np.asarray, out[0])
    params = interop.params_from_jax(jax.tree.map(np.asarray, jp), tcfg,
                                     device="cpu")
    mesh = _mesh((2, 2))
    step = TSt.make_train_step(
        tcfg, TA.AdamWConfig(warmup_steps=1, total_steps=10),
        act_sharding=Sh.NamedSharding(
            mesh, Sh.activation_spec(mesh, True, profile), profile))
    assert step.plan.profile == profile
    assert not any(step.plan.describe()["attention_tp"].values())
    placed = step.plan.place({"params": params,
                              "opt": TA.init_opt_state(params)})
    with mesh.recording() as record:
        res = step([s["params"] for s in placed], [s["opt"] for s in placed],
                   {"tokens": torch.from_numpy(tok).long(),
                    "labels": torch.from_numpy(labels).long()})
    kinds = {(k, a) for k, a, _ in record}
    # cp: the halo shifts over 'model'; fsdp: no p2p
    assert (("p2p", "model") in kinds) == (profile == "cp")
    np.testing.assert_allclose(float(res[2]["grad_norm"]),
                               float(out[2]["grad_norm"]), **TOL)
    got = dict(tree.flatten_with_paths(interop.params_to_numpy(
        step.plan.gather_tree(res[0]), tcfg)))
    for path, w in tree.flatten_with_paths(want):
        np.testing.assert_allclose(got[path], w, **F32, err_msg=path)


def test_fsdp_refuses_expert_parallelism():
    """The fsdp profile's 'model' members hold other rows: the "ep"
    dispatch is refused there, by name."""
    _, tcfg = _pair("granite_moe_1b")
    tcfg = dataclasses.replace(tcfg, moe=dataclasses.replace(
        tcfg.moe, dispatch="ep"))
    mesh = _mesh((2, 2))
    plan = TPL.TrainPlan(tcfg, mesh, Sh.activation_spec(mesh, True, "fsdp"),
                         profile="fsdp")
    params = TM.init_model(tcfg, device="cpu")
    tok = torch.zeros(B, 32, dtype=torch.long)
    from repro_torch.core import moe as M
    M.set_expert_parallel(mesh)
    try:
        with pytest.raises(NotImplementedError, match="fsdp"):
            plan.train_loss(plan.place(params), tcfg,
                            {"tokens": tok, "labels": tok})
    finally:
        M.set_expert_parallel(None)


def test_odd_vocabulary_stays_whole_on_a_mesh():
    """A vocabulary that 'model' does not divide (whisper's 51865,
    internvl2's 151655) keeps its table and head whole: the mesh embeds
    and unembeds with the whole table, and the prefill logits are the JAX
    package's, not the vocabulary twice over."""
    cfg, tcfg = (dataclasses.replace(c, vocab_size=255)
                 for c in _pair("llama3p2_1b"))
    jp = JM.init_model(jax.random.PRNGKey(0), cfg)
    tok = np.random.RandomState(3).randint(0, 255, (B, PROMPT)).astype(
        np.int32)
    want, _ = JM.prefill(jp, cfg, {"tokens": jnp.asarray(tok)}, MAX_LEN)
    params = interop.params_from_jax(jax.tree.map(np.asarray, jp), tcfg,
                                     device="cpu")
    plan = TP.MeshPlan(tcfg, _mesh((1, 2)), params, slots=B,
                       max_len=MAX_LEN, lookahead=0, paged=False)
    assert not plan.vocab_tp and not plan.head_tp
    lgs, _ = TM.prefill(plan.place_params(params), tcfg,
                        [{"tokens": torch.from_numpy(tok).long()}] * 2,
                        MAX_LEN, plan=plan)
    got = plan.join_rows(lgs).numpy()
    assert got.shape == np.asarray(want).shape
    np.testing.assert_allclose(got, np.asarray(want), **TOL)
