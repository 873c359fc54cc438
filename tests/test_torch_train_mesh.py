"""Training on a mesh (`repro_torch.distributed.train_parallel`) against the
JAX package's single-device training, on the CPU: the loss and every
gradient leaf of a mesh train step on 2x2, 4x1 and 1x4 LocalMeshes
(Megatron TP over 'model', FSDP over 'data', sequence parallelism) against
JAX `loss_fn` / `jax.grad`, for llama, granite-moe (the "sort" dispatch,
capacity drops included) and mamba2; granite-moe's "ep" dispatch on 1x4
and 2x2, its loss and aux loss against JAX `loss_fn` under the JAX
package's expert parallelism on 4 forced host devices (one module-scoped
subprocess) and every gradient leaf against the port's single-device
`loss_fn` on the same registered mesh (whose EP body
tests/test_torch_moe_ep.py holds against JAX's); the params after one AdamW step
against the JAX `make_train_step`, with and without int8 compression; the
replicas of every replicated leaf equal after two steps; and 2-rank gloo
ProcessMeshes against the LocalMesh. Smoke configs + with_swat(16, 4),
fp32, params from JAX `init_model` through `interop`; atol 2e-5 / rtol
1e-4 (the JAX mesh tests are in the reference's red set, so the oracle is
the single-device JAX step, as in tests/test_torch_pipeline.py)."""
import dataclasses
import os
import pathlib
import pickle
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config, with_swat
from repro.core import model as JM
from repro.launch import steps as JSt
from repro.optim import adamw as JA
from repro.optim import compress as JC
from repro_torch import interop, tree
from repro_torch.configs import get_smoke_config as t_smoke
from repro_torch.configs import with_swat as t_swat
from repro_torch.core import moe as TM
from repro_torch.distributed import sharding as Sh
from repro_torch.distributed import train_parallel as TPL
from repro_torch.launch import mesh as ML
from repro_torch.launch import steps as TSt
from repro_torch.optim import adamw as TA
from repro_torch.optim import compress as TC

from test_torch_pipeline import run_ranks

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
F32 = dict(atol=2e-5, rtol=1e-4)
ARCHS = ("llama3p2_1b", "granite_moe_1b", "mamba2_1p3b")
B, L = 4, 32


def _cfgs(arch):
    """(JAX config, port config): the smoke config + with_swat(16, 4); the
    smoke llama with 2 kv heads, so that 'model' = 2 splits its heads."""
    cfg, tcfg = (with_swat(get_smoke_config(arch), 16, 4),
                 t_swat(t_smoke(arch), 16, 4))
    if arch == "llama3p2_1b":
        cfg = dataclasses.replace(cfg, num_kv_heads=2)
        tcfg = dataclasses.replace(tcfg, num_kv_heads=2)
    return cfg, tcfg


def _tokens(cfg, seed=0):
    rng = np.random.RandomState(seed)
    tok = rng.randint(0, cfg.vocab_size, (B, L)).astype(np.int32)
    labels = tok.copy()
    labels[1, 5:9] = -1                      # masked positions
    return tok, labels


def _tbatch(tok, labels):
    return {"tokens": torch.from_numpy(tok.astype(np.int64)),
            "labels": torch.from_numpy(labels.astype(np.int64))}


@pytest.fixture(scope="module")
def jax_ref():
    """Per arch: JAX params, batch, loss, metrics and gradients."""
    out = {}
    for arch in ARCHS:
        cfg, _ = _cfgs(arch)
        tok, labels = _tokens(cfg)
        jp = JM.init_model(jax.random.PRNGKey(0), cfg)
        jb = {"tokens": jnp.asarray(tok), "labels": jnp.asarray(labels)}
        (_, metrics), grads = jax.value_and_grad(
            lambda p: JM.loss_fn(p, cfg, jb, remat=False), has_aux=True)(jp)
        out[arch] = (jax.tree.map(np.asarray, jp), (tok, labels),
                     {k: float(v) for k, v in metrics.items()},
                     jax.tree.map(np.asarray, grads))
    return out


def _ep(cfg):
    return dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe,
                                                            dispatch="ep"))


EP_SHAPES = ((1, 4), (2, 2))


@pytest.fixture(scope="module")
def jax_ep_ref(jax_ref, tmp_path_factory):
    """granite-moe's metrics from JAX `loss_fn` with dispatch "ep" under
    the JAX package's expert parallelism (`set_expert_parallel`) on each
    of EP_SHAPES, 4 forced host devices, one subprocess (jit on an
    Auto-typed mesh)."""
    d = tmp_path_factory.mktemp("jax_ep")
    np_params, (tok, labels), _, _ = jax_ref["granite_moe_1b"]
    with open(d / "in.pkl", "wb") as f:
        pickle.dump((np_params, tok, labels), f)
    code = f"""
    import dataclasses, pickle, jax, jax.numpy as jnp, numpy as np
    from repro.configs import get_smoke_config, with_swat
    from repro.core import model as JM, moe as JMoE
    cfg = with_swat(get_smoke_config("granite_moe_1b"), 16, 4)
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe,
                                                           dispatch="ep"))
    p, tok, labels = pickle.load(open("{d}/in.pkl", "rb"))
    p = jax.tree.map(jnp.asarray, p)
    b = {{"tokens": jnp.asarray(tok), "labels": jnp.asarray(labels)}}
    out = {{}}
    for shape in {EP_SHAPES}:
        mesh = jax.make_mesh(shape, ("data", "model"), axis_types=(
            jax.sharding.AxisType.Auto,) * 2)
        JMoE.set_expert_parallel(mesh)
        with mesh:
            _, m = jax.jit(lambda p, b: JM.loss_fn(p, cfg, b,
                                                   remat=False))(p, b)
        for k, v in m.items():
            out[f"{{shape[0]}}x{{shape[1]}}/{{k}}"] = float(v)
    np.savez("{d}/out.npz", **out)
    """
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               JAX_PLATFORMS="cpu", TF_CPP_MIN_LOG_LEVEL="2",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    res = subprocess.run([sys.executable, "-c", textwrap.dedent(code)],
                         capture_output=True, text=True, env=env,
                         timeout=300)
    assert res.returncode == 0, res.stderr
    return {k: float(v) for k, v in np.load(d / "out.npz").items()}


def _plan(tcfg, shape, sp=True):
    mesh = ML.LocalMesh(shape, ("data", "model"))
    return TPL.TrainPlan(tcfg, mesh, Sh.activation_spec(
        mesh, sequence_parallel=sp))


def _grads(tcfg, params, batch, plan=None):
    """(metrics, gradient tree) of one loss and backward: on one device,
    or on a plan's mesh (params placed, the gradient gathered)."""
    leaves = TSt.unique_leaves(params if plan else [params])
    for p in leaves:
        p.requires_grad_(True)
    try:
        if plan is None:
            total, metrics = TPL.Mod.loss_fn(params, tcfg, batch,
                                             remat=False)
        else:
            total, metrics = plan.train_loss(params, tcfg, batch)
        grads = torch.autograd.grad(total, leaves)
    finally:
        for p in leaves:
            p.requires_grad_(False)
    by_id = {id(x): g for x, g in zip(leaves, grads)}
    metrics = {k: float(v.detach()) for k, v in metrics.items()}
    if plan is None:
        return metrics, tree.tree_map(lambda x: by_id[id(x)], params)
    return metrics, plan.gather_tree([tree.tree_map(lambda x: by_id[id(x)],
                                                    t) for t in params])


@pytest.mark.parametrize("arch,shape,sp,dispatch", [
    (arch, shape, True, "spec") for arch in ARCHS
    for shape in ((2, 2), (4, 1), (1, 4))] + [
        ("llama3p2_1b", (2, 2), False, "spec")] + [
        ("granite_moe_1b", shape, True, "ep") for shape in EP_SHAPES])
def test_mesh_loss_and_every_grad_leaf_match_jax(jax_ref, jax_ep_ref,
                                                 monkeypatch, arch, shape,
                                                 sp, dispatch):
    """A mesh train step's loss, aux loss, token count and the gradient of
    every leaf, gathered from its shards, equal JAX's single-device ones.
    granite-moe's sort dispatch drops slots at its capacity factor, on the
    mesh as on one device (the global capacity). Its "ep" dispatch on the
    mesh registered by `set_expert_parallel` (each shard's sequence slice,
    slots ranked over the batch axes, the outputs gathered over 'model'):
    the metrics equal JAX `loss_fn` under the JAX package's expert
    parallelism on that mesh shape, drops included, and every gradient
    leaf the port's single-device one through `moe_ffn_ep` on the same
    mesh (JAX's EP gradient is in the reference's red set)."""
    np_params, (tok, labels), want_m, want_g = jax_ref[arch]
    _, tcfg = _cfgs(arch)
    plan = _plan(tcfg, shape, sp)
    dropped = []
    rank = TM.group_ranks
    buckets = plan.m if dispatch == "ep" else tcfg.moe.num_experts

    def counting(ids, cap, n):
        r, keep = rank(ids, cap, n)
        if n == buckets:
            dropped.append(int((~keep).sum()))
        return r, keep

    monkeypatch.setattr(TM, "group_ranks", counting)
    params = interop.params_from_jax(np_params, tcfg, device="cpu")
    batch = _tbatch(tok, labels)
    if dispatch == "ep":
        tcfg = _ep(tcfg)
        plan = _plan(tcfg, shape, sp)
        monkeypatch.setattr(TM, "_EP_MESH", plan.mesh)
        want_m = {k.split("/")[1]: v for k, v in jax_ep_ref.items()
                  if k.startswith("x".join(map(str, shape)) + "/")}
        one_m, want_g = _grads(tcfg, params, batch)
        want_g = interop.params_to_numpy(want_g, tcfg)
        for k, v in want_m.items():
            np.testing.assert_allclose(one_m[k], v, **F32, err_msg=k)
    metrics, grads = _grads(tcfg, plan.place(params), batch, plan)
    assert set(want_m) == {"loss", "aux_loss", "tokens"}
    for k, v in want_m.items():
        np.testing.assert_allclose(metrics[k], v, **F32, err_msg=k)
    got = dict(tree.flatten_with_paths(interop.params_to_numpy(grads, tcfg)))
    flat = tree.flatten_with_paths(want_g)
    assert got.keys() == dict(flat).keys()
    for path, w in flat:
        assert np.abs(w).max() > 10 * F32["atol"], path
        np.testing.assert_allclose(got[path], w, **F32, err_msg=path)
    if tcfg.moe.enabled:
        assert dropped and max(dropped) > 0, dropped


def test_mesh_forward_logits_match_jax(jax_ref):
    """`forward_logits(plan=)` on a 2x2 mesh with sequence parallelism:
    each coordinate's logits, its rows at every position, equal the JAX
    package's single-device logits."""
    np_params, (tok, labels), _, _ = jax_ref["llama3p2_1b"]
    cfg, tcfg = _cfgs("llama3p2_1b")
    want = np.asarray(JM.forward_logits(
        jax.tree.map(jnp.asarray, np_params), cfg,
        {"tokens": jnp.asarray(tok)}, remat=False)[0])
    plan = _plan(tcfg, (2, 2))
    placed = plan.place(interop.params_from_jax(np_params, tcfg,
                                                device="cpu"))
    got = TPL.Mod.forward_logits(placed, tcfg,
                                 plan.batch_rows(_tbatch(tok, labels)),
                                 plan=plan)
    for c, lg in zip(plan.coords, got):
        rows = slice(2 * c["data"], 2 * c["data"] + 2)
        np.testing.assert_allclose(lg.numpy(), want[rows], **F32)


def test_local_mesh_reduce_scatter_and_all_to_all_transposes():
    """On a 2x2 LocalMesh, per 'model' line: reduce_scatter gives each
    shard its block of the line's sum and its gradient is the all-gather
    of the cotangents; all_to_all trades chunks (JAX's tiled all_to_all)
    and its gradient is the all-to-all with the dims swapped."""
    mesh = ML.LocalMesh((2, 2), ("data", "model"))
    g = torch.Generator().manual_seed(0)
    xs = [torch.randn(4, 6, generator=g, requires_grad=True)
          for _ in range(4)]
    ws = [torch.randn(2, 6, generator=g) for _ in range(4)]
    ys = mesh.reduce_scatter(xs, "model", 0)
    grads = torch.autograd.grad(sum((y * w).sum() for y, w in zip(ys, ws)),
                                xs)
    for d in range(2):
        line = [2 * d, 2 * d + 1]
        total = xs[line[0]] + xs[line[1]]
        for m, k in enumerate(line):
            assert torch.equal(ys[k], total[2 * m:2 * m + 2])
            assert torch.equal(grads[k], torch.cat([ws[j] for j in line]))
    zs = mesh.all_to_all(xs, "model", 1, 0)           # (4, 6) -> (8, 3)
    grads = torch.autograd.grad(sum((z * z).sum() for z in zs), xs)
    for d in range(2):
        line = [2 * d, 2 * d + 1]
        for m, k in enumerate(line):
            assert torch.equal(zs[k], torch.cat(
                [xs[j][:, 3 * m:3 * m + 3] for j in line]))
            back = torch.cat([2 * zs[j][4 * m:4 * m + 4] for j in line], 1)
            assert torch.equal(grads[k], back)


def _jax_step(cfg, np_params, batch, compression):
    opt = JA.AdamWConfig(warmup_steps=1, total_steps=10)
    step = jax.jit(JSt.make_train_step(cfg, opt,
                                       grad_compression=compression))
    jp = jax.tree.map(jnp.asarray, np_params)
    args = (jp, JA.init_opt_state(jp), {k: jnp.asarray(v)
                                       for k, v in batch.items()})
    if compression:
        out = step(*args, JC.init_residual(jp))
    else:
        out = step(*args)
    return jax.tree.map(np.asarray, out[0]), float(out[2]["grad_norm"])


@pytest.mark.parametrize("arch,shape,compression", [
    ("llama3p2_1b", (2, 2), False), ("llama3p2_1b", (2, 2), True),
    ("granite_moe_1b", (1, 4), False), ("granite_moe_1b", (1, 4), True),
    ("granite_moe_1b", None, True)])
def test_adamw_step_matches_jax(jax_ref, arch, shape, compression):
    """One mesh train step (`steps.make_train_step(act_sharding=)`): the
    clipping norm and every param after the AdamW update equal the JAX
    single-device `make_train_step`'s, with and without int8 error
    feedback compression (whose scale is a whole JAX leaf's: every shard's
    and every super-block's); shape None: the single-device step."""
    np_params, (tok, labels), _, _ = jax_ref[arch]
    cfg, tcfg = _cfgs(arch)
    want, want_norm = _jax_step(cfg, np_params,
                                {"tokens": tok, "labels": labels},
                                compression)
    opt = TA.AdamWConfig(warmup_steps=1, total_steps=10)
    params = interop.params_from_jax(np_params, tcfg, device="cpu")
    state = {"params": params, "opt": TA.init_opt_state(params)}
    if compression:
        state["residual"] = TC.init_residual(params)
    if shape is None:
        step = TSt.make_train_step(tcfg, opt, grad_compression=compression)
        out = step(state["params"], state["opt"], _tbatch(tok, labels),
                   state.get("residual"))
        got, new_step = out[0], out[1].step
    else:
        mesh = ML.LocalMesh(shape, ("data", "model"))
        step = TSt.make_train_step(
            tcfg, opt,
            act_sharding=Sh.NamedSharding(mesh, Sh.activation_spec(mesh)),
            grad_compression=compression)
        placed = step.plan.place(state)
        args = [[s[k] for s in placed] for k in state]
        out = step(args[0], args[1], _tbatch(tok, labels), *args[2:])
        got, new_step = step.plan.gather_tree(out[0]), out[1][0].step
    np.testing.assert_allclose(float(out[2]["grad_norm"]), want_norm, **F32)
    got = dict(tree.flatten_with_paths(interop.params_to_numpy(got, tcfg)))
    for path, w in tree.flatten_with_paths(want):
        np.testing.assert_allclose(got[path], w, **F32, err_msg=path)
    assert int(new_step) == 1


def test_replicas_stay_bitwise_equal_after_two_steps():
    """On a 2x2 LocalMesh each shard's replicas (the coordinates whose
    block of a leaf is the same) are one tensor, params and moments, and
    after two steps every coordinate's copy of a replicated leaf equals
    every other's bitwise; the gathered params differ from the start."""
    _, tcfg = _cfgs("granite_moe_1b")
    mesh = ML.LocalMesh((2, 2), ("data", "model"))
    step = TSt.make_train_step(
        tcfg, TA.AdamWConfig(warmup_steps=1),
        act_sharding=Sh.NamedSharding(mesh, Sh.activation_spec(mesh)))
    params = TPL.Mod.init_model(tcfg, seed=0, device="cpu")
    start = [x.clone() for x in tree.leaves(params)]
    placed = step.plan.place({"params": params,
                              "opt": TA.init_opt_state(params)})
    ps, opts = [s["params"] for s in placed], [s["opt"] for s in placed]
    tok, labels = _tokens(tcfg)
    for seed in (0, 1):
        tok, labels = _tokens(tcfg, seed)
        ps, opts, _ = step(ps, opts, _tbatch(tok, labels))
    replicated = 0
    for path, _ in tree.flatten_with_paths(ps[0]):
        spec = step.plan.spec_of(path)
        blocks = {}
        for k, c in enumerate(mesh.coords()):
            key = Sh._block_key(spec, mesh, c)
            x = dict(tree.flatten_with_paths(ps[k]))[path]
            mu = dict(tree.flatten_with_paths(opts[k].mu))[path]
            if key in blocks:
                replicated += 1
                assert blocks[key][0] is x and blocks[key][1] is mu, path
                assert torch.equal(blocks[key][0], x), path
            blocks[key] = (x, mu)
    assert replicated > 10
    moved = [not torch.equal(a, b) for a, b in zip(
        start, tree.leaves(step.plan.gather_tree(ps)))]
    assert all(moved)


RANK = """
import sys, numpy as np, torch, torch.distributed as dist
from repro_torch import interop, tree
from repro_torch.configs import get_smoke_config, with_swat
import dataclasses
from repro_torch.distributed import sharding as Sh
from repro_torch.launch import mesh as ML, steps as St
from repro_torch.optim import adamw
rank, world, d = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
spec, policy = open(f"{d}/shape.txt").read().split()
shape = tuple(int(x) for x in spec.split("x"))
dist.init_process_group("gloo", init_method=f"file://{d}/rdv", rank=rank,
                        world_size=world)
torch.set_num_threads(1)
cfg = dataclasses.replace(with_swat(get_smoke_config("granite_moe_1b"), 16,
                                    4), num_kv_heads=4)
mesh = ML.make_debug_mesh(*shape, process=True, device_type="cpu")
step = St.make_train_step(cfg, adamw.AdamWConfig(warmup_steps=1),
                          act_sharding=Sh.NamedSharding(mesh,
                              Sh.activation_spec(mesh)),
                          grad_compression=True, remat_policy=policy)
params = torch.load(f"{d}/params.pt")
from repro_torch.optim import compress
[s] = step.plan.place({"params": params, "opt": adamw.init_opt_state(params),
                       "residual": compress.init_residual(params)})
ps, opts, res = [s["params"]], [s["opt"]], [s["residual"]]
z = np.load(f"{d}/batch.npz")
out = {}
for i in range(2):
    batch = {k: torch.from_numpy(z[f"{k}{i}"]) for k in ("tokens", "labels")}
    ps, opts, m, res = step(ps, opts, batch, res)
    out[f"loss{i}"] = float(m["loss"])
    out[f"gnorm{i}"] = float(m["grad_norm"])
out.update({f"p/{p}": x.numpy() for p, x in tree.flatten_with_paths(ps[0])})
np.savez(f"{d}/out{rank}.npz", calls=np.asarray([mesh.calls[k] for k in (
    "all_reduce", "all_gather", "reduce_scatter")]), wire=mesh.wire_ops,
    **out)
dist.destroy_process_group()
"""


@pytest.mark.parametrize("spec,policy", [("2x1", "nothing"),
                                         ("1x2", "dots")])
def test_process_mesh_over_gloo_matches_local_mesh(tmp_path, spec, policy):
    """Two gloo ranks, one shard each, two compressed AdamW steps of
    granite-moe (4 kv heads: Megatron over 'model'), remat recomputing
    everything or keeping the products ("dots"; either way every rank
    recomputes its collectives in the same order): every rank's losses,
    clipping norms and param shards equal the LocalMesh's at its
    coordinate; the all-gathers, their reduce-scatter transposes and the
    gradient all-reduces cross between the processes; the replicated
    leaves are bitwise equal on both ranks."""
    shape = tuple(int(x) for x in spec.split("x"))
    cfg = dataclasses.replace(t_swat(t_smoke("granite_moe_1b"), 16, 4),
                              num_kv_heads=4)
    params = TPL.Mod.init_model(cfg, seed=0, device="cpu")
    torch.save(params, tmp_path / "params.pt")
    batches = {}
    for i in range(2):
        tok, labels = _tokens(cfg, seed=i)
        batches[f"tokens{i}"] = tok.astype(np.int64)
        batches[f"labels{i}"] = labels.astype(np.int64)
    np.savez(tmp_path / "batch.npz", **batches)
    (tmp_path / "shape.txt").write_text(f"{spec} {policy}")
    run_ranks(RANK, 2, tmp_path)
    mesh = ML.LocalMesh(shape, ("data", "model"))
    step = TSt.make_train_step(
        cfg, TA.AdamWConfig(warmup_steps=1),
        act_sharding=Sh.NamedSharding(mesh, Sh.activation_spec(mesh)),
        grad_compression=True, remat_policy=policy)
    placed = step.plan.place({"params": params,
                              "opt": TA.init_opt_state(params),
                              "residual": TC.init_residual(params)})
    ps, opts, res = ([s[k] for s in placed]
                     for k in ("params", "opt", "residual"))
    want = {}
    for i in range(2):
        batch = {k: torch.from_numpy(batches[f"{k}{i}"])
                 for k in ("tokens", "labels")}
        ps, opts, m, res = step(ps, opts, batch, res)
        want[f"loss{i}"], want[f"gnorm{i}"] = (float(m["loss"]),
                                               float(m["grad_norm"]))
    got = [dict(np.load(tmp_path / f"out{r}.npz")) for r in range(2)]
    for r, c in enumerate(mesh.coords()):
        for k, v in want.items():
            np.testing.assert_allclose(got[r][k], v, **F32, err_msg=k)
        for path, x in tree.flatten_with_paths(ps[r]):
            np.testing.assert_allclose(got[r][f"p/{path}"], x.numpy(),
                                       **F32, err_msg=f"rank {r} {path}")
        calls = got[r]["calls"]
        assert all(calls > 0) and int(got[r]["wire"]) > 0, calls
    replicated = [p for p, _ in tree.flatten_with_paths(ps[0])
                  if Sh._block_key(step.plan.spec_of(p), mesh,
                                   mesh.coords()[0])
                  == Sh._block_key(step.plan.spec_of(p), mesh,
                                   mesh.coords()[1])]
    assert len(replicated) >= 4
    for path in replicated:
        assert np.array_equal(got[0][f"p/{path}"], got[1][f"p/{path}"]), path
