"""The port's expert parallelism (`repro_torch.core.moe_ep`) against the JAX
package's `core/moe_ep.py` on the CPU: `moe_ffn_ep` on a 4-shard LocalMesh
against the JAX shard_map on 4 forced host devices (one module-scoped
subprocess, as tests/test_moe_ep.py runs it), outputs and aux with drops
(cf 1.25) and without (cf 8.0); gradients against jax.grad of the JAX
dense reference plus the sort dispatch's aux (JAX's own oracle); the
analytic wire bytes; the "ep" dispatch through `moe_ffn` with and without
a registered mesh; the global-batch ranking on a 2x4 mesh; and the body on
a 2-rank gloo ProcessMesh (all-to-all, all-gather and their gradients)
against the LocalMesh. fp32 atol 2e-5 / rtol 1e-4."""
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

from repro.core import moe as JM
from repro.core import moe_ep as JEP
from repro.core.types import MoESpec as JSpec
from repro_torch import interop
from repro_torch.core import moe as TM
from repro_torch.core import moe_ep as EP
from repro_torch.core.types import MoESpec as TSpec
from repro_torch.launch import mesh as ML

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
F32 = dict(atol=2e-5, rtol=1e-4)
E, K, D, FF = 8, 2, 32, 64


def _inputs():
    jspec = JSpec(num_experts=E, top_k=K)
    jp = JM.init_moe(jax.random.PRNGKey(0), D, FF, jspec, dtype=jnp.float32)
    x = (np.random.RandomState(0).randn(2, 16, D) * 0.5).astype(np.float32)
    return jspec, {n: np.asarray(v) for n, v in jp.items()}, x


@pytest.fixture(scope="module")
def jax_ep(tmp_path_factory):
    """JAX moe_ffn_ep's output and aux at cf 1.25 and 8.0 on 4 forced host
    devices, from one subprocess."""
    d = tmp_path_factory.mktemp("ep")
    _, p, x = _inputs()
    np.savez(d / "in.npz", x=x, **p)
    code = f"""
    import jax, jax.numpy as jnp, numpy as np
    from repro.core import moe_ep as EP
    from repro.core.types import MoESpec
    z = np.load("{d}/in.npz")
    p = {{k: jnp.asarray(z[k]) for k in ("router", "w1", "w2", "w3")}}
    mesh = jax.make_mesh((4,), ("model",))
    out = {{}}
    with mesh:
        for cf in (1.25, 8.0):
            y, aux = EP.moe_ffn_ep(p, jnp.asarray(z["x"]),
                                   MoESpec(num_experts={E}, top_k={K}),
                                   mesh=mesh, axis="model",
                                   capacity_factor=cf)
            out[f"y{{cf}}"], out[f"aux{{cf}}"] = np.asarray(y), float(aux)
    np.savez("{d}/out.npz", **out)
    """
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               JAX_PLATFORMS="cpu", TF_CPP_MIN_LOG_LEVEL="2",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    res = subprocess.run([sys.executable, "-c", textwrap.dedent(code)],
                         capture_output=True, text=True, env=env,
                         timeout=300)
    assert res.returncode == 0, res.stderr
    return dict(np.load(d / "out.npz"))


def _port(p, x, cf, mesh=None):
    mesh = ML.LocalMesh((4,), ("model",)) if mesh is None else mesh
    tp = {n: interop.to_torch(v, "cpu") for n, v in p.items()}
    y, aux = EP.moe_ffn_ep(tp, torch.from_numpy(x),
                           TSpec(num_experts=E, top_k=K), mesh=mesh,
                           axis="model", capacity_factor=cf)
    return y.numpy(), float(aux)


@pytest.mark.parametrize("cf", [1.25, 8.0])
def test_ep_matches_jax_ep(jax_ep, cf):
    """Outputs and aux equal the JAX shard_map's; at cf 1.25 slots drop
    (the output leaves the dense oracle), at cf 8.0 none does."""
    jspec, p, x = _inputs()
    y, aux = _port(p, x, cf)
    np.testing.assert_allclose(y, jax_ep[f"y{cf}"], **F32)
    np.testing.assert_allclose(aux, jax_ep[f"aux{cf}"], **F32)
    dense = np.asarray(JM.moe_ffn_dense_ref(
        {n: jnp.asarray(v) for n, v in p.items()}, jnp.asarray(x), jspec))
    gap = np.abs(y - dense).max()
    if cf == 1.25:
        assert gap > 1e-2, gap
    else:
        assert gap < 1e-4, gap


def test_ep_gradients_match_dense_oracle():
    """cf 8.0 (no drops): the gradient of sum(y * w) + 0.01 aux through both
    all-to-alls equals jax.grad of the dense reference plus the sort
    dispatch's aux, for the router, the experts and the input."""
    jspec, p, x = _inputs()
    w = np.random.RandomState(1).randn(*x.shape).astype(np.float32)

    def jloss(jp, jx):
        y = JM.moe_ffn_dense_ref(jp, jx, jspec)
        _, aux = JM.moe_ffn(jp, jx, jspec, capacity_factor=8.0)
        return jnp.sum(y * w) + 0.01 * aux

    jp = {n: jnp.asarray(v) for n, v in p.items()}
    want_p, want_x = jax.grad(jloss, argnums=(0, 1))(jp, jnp.asarray(x))
    tp = {n: interop.to_torch(v, "cpu").requires_grad_(True)
          for n, v in p.items()}
    tx = torch.from_numpy(x).requires_grad_(True)
    y, aux = EP.moe_ffn_ep(tp, tx, TSpec(num_experts=E, top_k=K),
                           mesh=ML.LocalMesh((4,), ("model",)),
                           capacity_factor=8.0)
    loss = (y * torch.from_numpy(w)).sum() + 0.01 * aux
    got = torch.autograd.grad(loss, [*tp.values(), tx])
    for name, g in zip([*tp, "x"], got):
        want = np.asarray(want_x if name == "x" else want_p[name])
        assert np.abs(want).max() > 1e-3, name
        np.testing.assert_allclose(g.numpy(), want, **F32, err_msg=name)


@pytest.mark.parametrize("t_local,k,d,cf", [(4096, 8, 1024, 1.25),
                                            (8192, 2, 2048, 2.0),
                                            (17, 3, 64, 1.0)])
def test_wire_bytes_equal_jax(t_local, k, d, cf):
    assert EP.ep_wire_bytes_per_device(t_local, k, d, cf) == \
        JEP.ep_wire_bytes_per_device(t_local, k, d, cf)
    assert EP.ep_wire_bytes_per_device(t_local, k, d, cf, 4) == \
        JEP.ep_wire_bytes_per_device(t_local, k, d, cf, 4)


def test_ep_dispatch_runs_on_the_registered_mesh(jax_ep):
    """moe_ffn(dispatch="ep") runs moe_ffn_ep on a registered mesh whose
    'model' axis divides the experts, and the sort schedule otherwise (no
    mesh, or 3 shards of 8 experts), as the JAX package does."""
    jspec, p, x = _inputs()
    tp = {n: interop.to_torch(v, "cpu") for n, v in p.items()}
    tspec = TSpec(num_experts=E, top_k=K, dispatch="ep")
    sort = TM.moe_ffn(tp, torch.from_numpy(x), tspec, dispatch="sort")
    try:
        TM.set_expert_parallel(ML.LocalMesh((4,), ("model",)))
        y, aux = TM.moe_ffn(tp, torch.from_numpy(x), tspec)
        np.testing.assert_allclose(y.numpy(), jax_ep["y1.25"], **F32)
        np.testing.assert_allclose(float(aux), jax_ep["aux1.25"], **F32)
        TM.set_expert_parallel(ML.LocalMesh((3,), ("model",)))
        y3, _ = TM.moe_ffn(tp, torch.from_numpy(x), tspec)
        assert torch.equal(y3, sort[0])
    finally:
        TM.set_expert_parallel(None)
    assert torch.equal(TM.moe_ffn(tp, torch.from_numpy(x), tspec)[0],
                       sort[0])


def test_ep_body_ranks_over_the_global_batch():
    """On a 2x4 mesh whose 'data' axis splits the rows, the body with
    batch_axes=("data",) gives every row what the 1-D body gives it on the
    whole batch (the JAX shard_map's view: the batch axes stay automatic),
    drops included, and the same aux on every shard."""
    _, p, x = _inputs()
    spec = TSpec(num_experts=E, top_k=K)
    tp = {n: interop.to_torch(v, "cpu") for n, v in p.items()}
    want, want_aux = _port(p, x, 1.25)
    mesh = ML.LocalMesh((2, 4), ("data", "model"))
    xs, ps = [], []
    for c in mesh.coords():
        rows = torch.from_numpy(x)[c["data"]:c["data"] + 1]
        xs.append(rows[:, c["model"] * 4:(c["model"] + 1) * 4])
        ps.append({"router": tp["router"],
                   **{w: tp[w][2 * c["model"]:2 * c["model"] + 2]
                      for w in ("w1", "w2", "w3")}})
    outs, auxes = EP.moe_ffn_ep_local(ps, xs, spec, mesh=mesh, axis="model",
                                      batch_axes=("data",))
    for c, y, a in zip(mesh.coords(), outs, auxes):
        np.testing.assert_allclose(
            y.numpy(), want[c["data"]:c["data"] + 1,
                            c["model"] * 4:(c["model"] + 1) * 4], **F32)
        np.testing.assert_allclose(float(a), want_aux, **F32)


RANK = """
import sys, numpy as np, torch, torch.distributed as dist
from repro_torch import interop
from repro_torch.core import moe_ep as EP
from repro_torch.core.types import MoESpec
from repro_torch.launch import mesh as ML
rank, world, d = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
dist.init_process_group("gloo", init_method=f"file://{d}/rdv", rank=rank,
                        world_size=world)
torch.set_num_threads(1)
z = np.load(f"{d}/in.npz")
p = {k: interop.to_torch(z[k], "cpu").requires_grad_(True)
     for k in ("router", "w1", "w2", "w3")}
x = torch.from_numpy(z["x"]).requires_grad_(True)
mesh = ML.make_debug_mesh(1, world, process=True, device_type="cpu")
y, aux = EP.moe_ffn_ep(p, x, MoESpec(num_experts=8, top_k=2), mesh=mesh,
                       capacity_factor=1.25)
loss = (y * torch.from_numpy(z["w"])).sum() + 0.01 * aux
# every rank computes the whole loss; its gradient is 1/world of the
# objective summed over the ranks
grads = torch.autograd.grad(loss, [*p.values(), x])
# reduce_scatter and its all-gather transpose
r = (torch.arange(12.0).reshape(4, 3) * (rank + 1)).requires_grad_(True)
[rs] = mesh.reduce_scatter([r], "model", 0)
[rg] = torch.autograd.grad((rs * (rank + 2)).sum(), [r])
np.savez(f"{d}/out{rank}.npz", y=y.detach().numpy(), aux=float(aux),
         rs=rs.detach().numpy(), rg=rg.numpy(),
         calls=np.asarray([mesh.calls[k] for k in (
             "all_to_all", "all_gather", "reduce_scatter")]),
         wire=mesh.wire_ops,
         **{f"g{i}": g.numpy() for i, g in enumerate(grads)})
dist.destroy_process_group()
"""


def test_process_mesh_over_gloo_matches_local_mesh(tmp_path):
    """Two gloo ranks (one shard each): gloo runs the all-to-alls, the
    output all-gather and, in the backward pass, their transposes (the
    all-to-all back and a reduce-scatter); outputs, aux and gradients equal
    the 2-shard LocalMesh's; so do a reduce-scatter and its gradient (an
    all-gather)."""
    from test_torch_pipeline import run_ranks
    _, p, x = _inputs()
    w = np.random.RandomState(1).randn(*x.shape).astype(np.float32)
    np.savez(tmp_path / "in.npz", x=x, w=w, **p)
    run_ranks(RANK, 2, tmp_path)
    tp = {n: interop.to_torch(p[n], "cpu").requires_grad_(True)
          for n in ("router", "w1", "w2", "w3")}
    tx = torch.from_numpy(x).requires_grad_(True)
    y, aux = EP.moe_ffn_ep(tp, tx, TSpec(num_experts=E, top_k=K),
                           mesh=ML.make_debug_mesh(1, 2),
                           capacity_factor=1.25)
    loss = (y * torch.from_numpy(w)).sum() + 0.01 * aux
    want = torch.autograd.grad(loss, [*tp.values(), tx])
    total = [np.zeros_like(g.numpy()) for g in want]
    r = [(torch.arange(12.0).reshape(4, 3) * (k + 1)).requires_grad_(True)
         for k in range(2)]
    rs = ML.make_debug_mesh(1, 2).reduce_scatter(r, "model", 0)
    rg = torch.autograd.grad(sum((x * (k + 2)).sum()
                                 for k, x in enumerate(rs)), r)
    for r in range(2):
        got = np.load(tmp_path / f"out{r}.npz")
        np.testing.assert_array_equal(got["rs"], rs[r].detach().numpy())
        np.testing.assert_array_equal(got["rg"], rg[r].numpy())
        np.testing.assert_allclose(got["y"], y.detach().numpy(), **F32)
        np.testing.assert_allclose(got["aux"], float(aux), **F32)
        a2a, gather, scatter = got["calls"]
        assert a2a >= 4 and gather >= 1 and scatter >= 1, got["calls"]
        assert int(got["wire"]) > 0
        for i in range(len(want)):
            total[i] += got[f"g{i}"]
    for i, g in enumerate(want):
        np.testing.assert_allclose(total[i] / 2, g.numpy(), **F32,
                                   err_msg=f"g{i}")
