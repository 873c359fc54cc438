"""The port's GPipe pipeline (`distributed/pipeline.py`) against the JAX
package, on the CPU: the loss and every gradient leaf of the 4-layer smoke
llama in 2 stages of 4 microbatches against JAX `loss_fn` (as
tests/test_pipeline.py holds the JAX pipeline), a train step that moves
every param, and the process mesh over gloo (2 and 4 CPU processes: each
rank its stage's super-blocks) against the single-process mesh. Outputs and
gradients at fp32 atol 2e-5 / rtol 1e-4, each gradient leaf also within a
relative norm of 1e-4 of JAX's.
"""
import dataclasses
import os
import pathlib
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.configs import get_smoke_config
from repro.core import model as JM
from repro.distributed import pipeline as JPP
from repro_torch import interop, tree
from repro_torch.configs import get_smoke_config as t_smoke
from repro_torch.core import model as TM
from repro_torch.distributed import pipeline as PP
from repro_torch.launch import mesh as ML
from repro_torch.optim import adamw

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
F32 = dict(atol=2e-5, rtol=1e-4)
GRAD_REL_NORM = 1e-4


def _cfgs():
    # 4 super-blocks, so that 2 stages hold 2 each (tests/test_pipeline.py)
    return (dataclasses.replace(get_smoke_config("llama3p2_1b"),
                                num_layers=4),
            dataclasses.replace(t_smoke("llama3p2_1b"), num_layers=4))


def _tokens(vocab, seed=0):
    return np.random.RandomState(seed).randint(0, vocab, (8, 32)).astype(
        np.int32)


def _batch(tok):
    t = torch.from_numpy(tok.astype(np.int64))
    return {"tokens": t, "labels": t}


def _value_and_grad(loss, params, batch):
    leaves = tree.leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    try:
        total, metrics = loss(params, batch)
        grads = torch.autograd.grad(total, leaves)
    finally:
        for p in leaves:
            p.requires_grad_(False)
    return (float(total.detach()),
            {k: float(v.detach()) for k, v in metrics.items()},
            tree.unflatten(params, list(grads)))


@settings(deadline=None, max_examples=50)
@given(n=st.integers(1, 16), extra=st.integers(0, 64))
def test_bubble_fraction_matches_jax(n, extra):
    m = n + extra
    assert PP.bubble_fraction(PP.PipelineConfig(n, m)) == JPP.bubble_fraction(
        JPP.PipelineConfig(n, m))


def test_pipeline_config_refuses_fewer_microbatches_than_stages():
    assert PP.bubble_fraction(PP.PipelineConfig(4, 4)) == pytest.approx(3 / 7)
    with pytest.raises(ValueError):
        PP.PipelineConfig(num_stages=4, num_microbatches=2)
    cfg = _cfgs()[1]
    with pytest.raises(ValueError, match="stages on a pipe axis"):
        PP.make_pipeline_loss(cfg, PP.PipelineConfig(2, 4),
                              ML.make_debug_pp_mesh(4, 1))
    with pytest.raises(ValueError, match="not divisible"):
        PP.make_pipeline_loss(cfg, PP.PipelineConfig(3, 4),
                              ML.make_debug_pp_mesh(3, 1))


@pytest.fixture(scope="module")
def jax_reference():
    """JAX loss_fn's loss, metrics and gradients on the smoke llama (4
    layers), numpy params and tokens."""
    cfg, _ = _cfgs()
    tok = _tokens(cfg.vocab_size)
    jp = JM.init_model(jax.random.PRNGKey(0), cfg)
    jb = {"tokens": jnp.asarray(tok), "labels": jnp.asarray(tok)}
    (total, metrics), grads = jax.value_and_grad(
        lambda p: JM.loss_fn(p, cfg, jb, remat=False), has_aux=True)(jp)
    return (jax.tree.map(np.asarray, jp), tok, float(total),
            {k: float(v) for k, v in metrics.items()},
            jax.tree.map(np.asarray, grads))


@pytest.mark.parametrize("remat", [True, False])
def test_pipeline_loss_and_every_grad_leaf_match_jax(jax_reference, remat):
    """2 stages x 4 microbatches on the debug pp mesh (pipe 2 x data 2, one
    process): the loss equals the single-pass loss and every leaf's
    gradient, the stages' blocks and the pipe-replicated embed / head /
    norm alike, equals JAX's. Every reference leaf reaches well above the
    limit, so a zeroed leaf or one that lost a microbatch or a stage fails."""
    np_params, tok, want_total, want_metrics, want_grads = jax_reference
    _, tcfg = _cfgs()
    tp = interop.params_from_jax(np_params, tcfg, device="cpu")
    loss = PP.make_pipeline_loss(tcfg, PP.PipelineConfig(2, 4),
                                 ML.make_debug_pp_mesh(2, 2), remat=remat)
    total, metrics, grads = _value_and_grad(loss, tp, _batch(tok))
    np.testing.assert_allclose(total, want_total, **F32)
    assert metrics.keys() == want_metrics.keys()
    for k, v in want_metrics.items():
        np.testing.assert_allclose(metrics[k], v, **F32, err_msg=k)
    got = dict(tree.flatten_with_paths(interop.params_to_numpy(grads,
                                                               tcfg)))
    flat = tree.flatten_with_paths(want_grads)
    assert got.keys() == dict(flat).keys() and len(flat) >= 10
    for path, w in flat:
        assert np.abs(w).max() > 100 * F32["atol"], path
        np.testing.assert_allclose(got[path], w, **F32, err_msg=path)
        rel = np.linalg.norm(got[path] - w) / np.linalg.norm(w)
        assert rel <= GRAD_REL_NORM, (path, rel)


def test_pp_train_step_moves_every_param():
    _, tcfg = _cfgs()
    params = TM.init_model(tcfg, seed=0, device="cpu")
    before = [p.clone() for p in tree.leaves(params)]
    step = PP.make_pp_train_step(tcfg, adamw.AdamWConfig(warmup_steps=1),
                                 PP.PipelineConfig(2, 4),
                                 ML.make_debug_pp_mesh(2, 1))
    params, _, metrics = step(params, adamw.init_opt_state(params),
                              _batch(_tokens(tcfg.vocab_size)))
    assert np.isfinite(float(metrics["loss"]))
    assert float(metrics["grad_norm"]) > 0
    for path_p, b in zip(tree.flatten_with_paths(params), before):
        assert not torch.equal(path_p[1], b), path_p[0]
    assert not any(p.requires_grad for p in tree.leaves(params))


RANK = """
import dataclasses, datetime, sys, numpy as np, torch
import torch.distributed as dist
torch.set_num_threads(1)
rank, world, d = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
dist.init_process_group("gloo", init_method=f"file://{d}/pg", rank=rank,
                        world_size=world,
                        timeout=datetime.timedelta(seconds=60))
from repro_torch import tree
from repro_torch.configs import get_smoke_config
from repro_torch.core import model as Mod
from repro_torch.distributed import pipeline as PP
from repro_torch.launch import mesh as ML
from repro_torch.optim import adamw
cfg = dataclasses.replace(get_smoke_config("llama3p2_1b"), num_layers=4)
mesh = ML.make_debug_pp_mesh(world, 1, process=True, device_type="cpu")
pcfg = PP.PipelineConfig(world, 4)
stage = mesh.index("pipe")[0]
params = PP.stage_params(Mod.init_model(cfg, seed=0, device="cpu"), cfg,
                         pcfg, stage)
tok = torch.from_numpy(np.load(f"{d}/tok.npy"))
batch = {"tokens": tok, "labels": tok}
leaves = tree.leaves(params)
for p in leaves:
    p.requires_grad_(True)
total, _ = PP.make_pipeline_loss(cfg, pcfg, mesh)(params, batch)
grads = torch.autograd.grad(total, leaves)
for p in leaves:
    p.requires_grad_(False)
out = {f"g{i}": g.numpy() for i, g in enumerate(grads)}
step = PP.make_pp_train_step(cfg, adamw.AdamWConfig(warmup_steps=1), pcfg,
                             mesh)
params, _, m = step(params, adamw.init_opt_state(params), batch)
out.update({f"p{i}": p.numpy() for i, p in enumerate(tree.leaves(params))})
np.savez(f"{d}/out{rank}.npz", total=total.detach().numpy(),
         grad_norm=m["grad_norm"].numpy(), **out)
dist.destroy_process_group()
"""


def run_ranks(code: str, world: int, tmp_path, timeout: float = 240):
    """Run `code` as `world` CPU processes (argv: rank, world, tmp_path);
    kill them all if any fails or the time runs out."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    procs = [subprocess.Popen(
        [sys.executable, "-c", textwrap.dedent(code), str(r), str(world),
         str(tmp_path)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for r in range(world)]
    try:
        outs = [p.communicate(timeout=timeout) for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, (_, err) in zip(procs, outs):
        assert p.returncode == 0, err


@pytest.mark.parametrize("world", [2, 4])
def test_process_mesh_over_gloo_matches_single_process(tmp_path, world):
    """Each rank holds its stage's super-blocks; activations and their
    gradients travel by batch_isend_irecv, the replicated leaves'
    gradients and the loss by all_reduce. Every rank's loss, gradients,
    clipping norm and stepped params equal the single-process mesh's."""
    _, cfg = _cfgs()
    tok = _tokens(cfg.vocab_size, seed=1).astype(np.int64)
    np.save(tmp_path / "tok.npy", tok)
    run_ranks(RANK, world, tmp_path)
    pcfg = PP.PipelineConfig(world, 4)
    mesh = ML.make_debug_pp_mesh(world, 1)
    params = TM.init_model(cfg, seed=0, device="cpu")
    batch = _batch(tok)
    total, _, grads = _value_and_grad(PP.make_pipeline_loss(cfg, pcfg, mesh),
                                      params, batch)
    step = PP.make_pp_train_step(cfg, adamw.AdamWConfig(warmup_steps=1),
                                 pcfg, mesh)
    params, _, m = step(params, adamw.init_opt_state(params), batch)
    for r in range(world):
        got = np.load(tmp_path / f"out{r}.npz")
        np.testing.assert_allclose(got["total"], total, **F32)
        np.testing.assert_allclose(got["grad_norm"], float(m["grad_norm"]),
                                   **F32)
        for i, g in enumerate(tree.leaves(PP.stage_params(grads, cfg, pcfg,
                                                          r))):
            np.testing.assert_allclose(got[f"g{i}"], g.numpy(), atol=1e-6,
                                       rtol=1e-5, err_msg=f"rank {r} g{i}")
        for i, p in enumerate(tree.leaves(PP.stage_params(params, cfg, pcfg,
                                                          r))):
            np.testing.assert_allclose(got[f"p{i}"], p.numpy(), atol=1e-6,
                                       rtol=1e-5, err_msg=f"rank {r} p{i}")
