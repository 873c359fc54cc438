"""The port's meshes (`launch/mesh.py`) and halo-exchange context parallelism
(`distributed/context_parallel.py`, the `ops.set_context_parallel` hook)
against the JAX package, on the CPU.

The CP output and dQ/dK/dV on a 4-shard single-process mesh are held
against JAX `swat_attention` on the unsharded sequence (the cases of
tests/test_context_parallel.py), one case against JAX's own
`swat_attention_context_parallel` on 4 forced host devices, and the process
mesh over gloo (2 and 4 CPU processes) against the single-process mesh.
The plain backward's dLSE term is held against autograd. fp32 tolerance
atol 2e-5 / rtol 1e-4.
"""
import os
import pathlib
import subprocess
import sys
import textwrap
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.configs import get_smoke_config, with_swat
from repro.core import model as JM
from repro.core.types import AttentionSpec as JSpec
from repro.distributed import context_parallel as JCP
from repro.kernels import ops as JO
from repro_torch import interop, tree
from repro_torch.configs import get_smoke_config as t_smoke
from repro_torch.configs import with_swat as t_swat
from repro_torch.core import model as TM
from repro_torch.core.types import AttentionSpec
from repro_torch.distributed import context_parallel as CP
from repro_torch.kernels import ops
from repro_torch.kernels import swat_attention as SA
from repro_torch.kernels import swat_backward as SB
from repro_torch.launch import mesh as ML

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
F32 = dict(atol=2e-5, rtol=1e-4)
MESH4 = ML.LocalMesh((4,), ("seq",))

# the JAX tests' cases: (spec fields, heads q / kv)
CASES = {
    "causal": (dict(window=8, causal=True), 4, 2),
    "causal_global": (dict(window=8, num_global=4, causal=True), 4, 2),
    "bidirectional_global": (dict(window=8, num_global=4, causal=False),
                             4, 2),
    "multihop_causal": (dict(window=24, causal=True), 4, 2),
    "multihop_bidirectional": (dict(window=24, num_global=4, causal=False),
                               4, 2),
    "softcap_gqa": (dict(window=8, causal=True, softcap=30.0), 8, 2),
}


def _inputs(hq, hkv, seed=0, b=2, l=64, d=16):
    rng = np.random.RandomState(seed)
    q = rng.randn(b, hq, l, d).astype(np.float32) * 0.5
    k = rng.randn(b, hkv, l, d).astype(np.float32) * 0.5
    v = rng.randn(b, hkv, l, d).astype(np.float32) * 0.5
    t = rng.randn(b, hq, l, d).astype(np.float32)
    return q, k, v, t


def _port_cp(q, k, v, t, spec, mesh=MESH4, axis="seq"):
    """CP output and dQ/dK/dV of sum((o - t)^2) on a single-process mesh."""
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    o = CP.swat_attention_context_parallel(tq, tk, tv, spec, mesh=mesh,
                                           axis=axis, block_q=16,
                                           block_kv=16)
    ((o - torch.from_numpy(t)) ** 2).sum().backward()
    return [o.detach().numpy()] + [x.grad.numpy() for x in (tq, tk, tv)]


# ------------------------------------------------------------- meshes ------

def test_parse_and_debug_meshes_take_the_jax_shapes_and_axes():
    for spec, shape in (("4x1", {"data": 4, "model": 1}),
                        ("2×2", {"data": 2, "model": 2}),
                        ("2x2x2", {"pod": 2, "data": 2, "model": 2}),
                        ("8", {"data": 8})):
        m = ML.parse_mesh(spec)
        assert m.shape == shape and m.axis_names == tuple(shape)
        assert m.one_graph
    assert ML.make_debug_mesh().shape == {"data": 2, "model": 2}
    assert ML.make_debug_pp_mesh(4, 1).shape == {"pipe": 4, "data": 1}
    assert ML.batch_axes(ML.parse_mesh("2x2x2")) == ("pod", "data")
    assert ML.batch_axes(ML.make_debug_pp_mesh()) == ("data",)
    with pytest.raises(ValueError):
        ML.parse_mesh("2x0")


def test_production_meshes_need_their_world_size():
    with pytest.raises(RuntimeError, match="256 ranks"):
        ML.make_production_mesh()
    with pytest.raises(RuntimeError, match="512 ranks"):
        ML.make_production_mesh(multi_pod=True)
    with pytest.raises(RuntimeError, match="256 ranks"):
        ML.make_pp_mesh(num_stages=4)
    with pytest.raises(ValueError):
        ML.make_pp_mesh(num_stages=3)


def test_local_mesh_collectives_and_their_gradients():
    """shift moves shards along the axis with zeros at the edge, and its
    gradient is the opposite shift; psum / pmax reduce over the axis."""
    m = ML.LocalMesh((2, 3), ("data", "model"))
    assert m.index("model") == [0, 1, 2] and m.index("data") == [0, 1]
    xs = [torch.full((2,), float(i + 1), requires_grad=True)
          for i in range(3)]
    right = m.shift(xs, "model", +1)
    assert [r.tolist() for r in right] == [[0, 0], [1, 1], [2, 2]]
    left = m.shift(xs, "model", -1)
    assert [r.tolist() for r in left] == [[2, 2], [3, 3], [0, 0]]
    w = torch.tensor([10.0, 20.0, 30.0])
    sum(r.sum() * wi for r, wi in zip(right, w)).backward()
    # shard i's cotangent arrives from shard i + 1 (the opposite shift)
    assert [x.grad.tolist() for x in xs[:2]] == [[20, 20], [30, 30]]
    assert xs[2].grad is None        # the last shard's rows leave the axis
    assert [p.tolist() for p in m.psum(xs, "model")] == [[6, 6]] * 3
    assert [p.tolist() for p in m.pmax(xs, "model")] == [[3, 3]] * 3
    assert m.sum_out(xs, "model").tolist() == [6, 6]
    assert len(m.shard(torch.zeros(2, 6), "model", 1)) == 3


# -------------------------------------------------- analytic functions -----

@settings(deadline=None, max_examples=60)
@given(window=st.integers(1, 4096), local=st.integers(1, 4096),
       block=st.sampled_from([16, 64, 128]))
def test_halo_functions_match_jax(window, local, block):
    assert CP.halo_hops(window, local) == JCP.halo_hops(window, local)
    assert (CP.halo_rows(window, local, block)
            == JCP.halo_rows(window, local, block))


@settings(deadline=None, max_examples=60)
@given(shards=st.sampled_from([1, 2, 4, 8, 16]),
       lp=st.sampled_from([128, 256, 1024, 4096]),
       window=st.integers(1, 8192), heads=st.integers(1, 16),
       d=st.sampled_from([64, 128]), batch=st.integers(1, 4),
       causal=st.booleans())
def test_wire_bytes_match_jax(shards, lp, window, heads, d, batch, causal):
    args = (lp * shards, shards, window, heads, d)
    kw = dict(bytes_per_el=2, batch=batch, causal=causal)
    assert (CP.cp_wire_bytes_per_device(*args, **kw)
            == JCP.cp_wire_bytes_per_device(*args, **kw))


@settings(deadline=None, max_examples=40)
@given(l=st.sampled_from([64, 256, 512, 1000, 2048]),
       lkv=st.sampled_from([512, 2048]), n=st.sampled_from([1, 2, 4, 8]),
       g=st.sampled_from([0, 4, 128, 600]), sparse=st.booleans(),
       random=st.sampled_from([0, 2]))
def test_cp_eligibility_matches_jax(l, lkv, n, g, sparse, random):
    """The JAX predicate reads only mesh.shape[axis], so both run on the
    same LocalMesh."""
    kw = (dict(kind="swat", window=16, num_global=g, num_random=random)
          if sparse else dict(kind="dense"))
    mesh = ML.LocalMesh((n,), ("model",))
    ops.set_context_parallel(mesh, "model")
    JO.set_context_parallel(mesh, "model")
    try:
        assert (ops._cp_eligible(AttentionSpec(**kw), l, lkv)
                == JO._cp_eligible(JSpec(**kw), l, lkv))
    finally:
        ops.set_context_parallel(None)
        JO.set_context_parallel(None)
    assert not ops._cp_eligible(AttentionSpec(**kw), l, lkv)


# --------------------------------------------- CP against the JAX op -------

@pytest.mark.parametrize("case", sorted(CASES))
def test_cp_output_and_grads_match_jax_unsharded(case):
    fields, hq, hkv = CASES[case]
    q, k, v, t = _inputs(hq, hkv)
    js = JSpec(kind="swat", **fields)

    def loss(q_, k_, v_):
        o = JO.swat_attention(q_, k_, v_, js, impl="xla", block_q=16,
                              block_kv=16)
        return jnp.sum((o - t) ** 2), o

    (_, jo), jg = jax.value_and_grad(loss, argnums=(0, 1, 2), has_aux=True)(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    got = _port_cp(q, k, v, t, AttentionSpec(kind="swat", **fields))
    for name, a, b in zip(("o", "dq", "dk", "dv"), got, [jo, *jg]):
        np.testing.assert_allclose(a, np.asarray(b), **F32, err_msg=name)


def test_cp_refuses_random_blocks():
    q, k, v, _ = _inputs(4, 2)
    spec = AttentionSpec(kind="swat", window=8, num_global=4, num_random=2,
                         causal=False)
    with pytest.raises(ValueError, match="random blocks"):
        CP.swat_attention_context_parallel(
            *(torch.from_numpy(a) for a in (q, k, v)), spec, mesh=MESH4,
            axis="seq", block_q=16, block_kv=16)


JAX_CP = """
import numpy as np, jax, jax.numpy as jnp
from repro.core.types import AttentionSpec
from repro.distributed import context_parallel as CP
assert len(jax.devices()) == 4
# Auto axes: on an Explicit-typed mesh (make_mesh's default since jax 0.7)
# the function's eager slicing of a sharded array raises
mesh = jax.make_mesh((4,), ("seq",),
                     axis_types=(jax.sharding.AxisType.Auto,))
d = np.load({path!r})
spec = AttentionSpec(kind="swat", window=24, num_global=4, causal=True)
t = jnp.asarray(d["t"])
def fwd(q, k, v):
    with mesh:
        return CP.swat_attention_context_parallel(q, k, v, spec, mesh=mesh,
            axis="seq", block_q=16, block_kv=16)
def loss(q, k, v):
    return jnp.sum((fwd(q, k, v).astype(jnp.float32) - t) ** 2)
args = [jnp.asarray(d[n]) for n in "qkv"]
o = jax.jit(fwd)(*args)
g = jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(*args)
np.savez({out!r}, o=np.asarray(o), dq=np.asarray(g[0]), dk=np.asarray(g[1]),
         dv=np.asarray(g[2]))
"""


def test_cp_matches_jax_context_parallel_on_forced_devices(tmp_path):
    """A multi-hop causal case with globals against JAX's own CP function
    on 4 forced host devices (a subprocess)."""
    q, k, v, t = _inputs(4, 2, seed=3)
    np.savez(tmp_path / "in.npz", q=q, k=k, v=v, t=t)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               TF_CPP_MIN_LOG_LEVEL="2")
    code = JAX_CP.format(path=str(tmp_path / "in.npz"),
                         out=str(tmp_path / "out.npz"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=300)
    assert out.returncode == 0, out.stderr
    want = np.load(tmp_path / "out.npz")
    got = _port_cp(q, k, v, t, AttentionSpec(kind="swat", window=24,
                                             num_global=4, causal=True))
    for name, a in zip(("o", "dq", "dk", "dv"), got):
        np.testing.assert_allclose(a, want[name], **F32, err_msg=name)


# --------------------------------------------------- the process mesh ------

RANK = """
import datetime, sys, numpy as np, torch, torch.distributed as dist
torch.set_num_threads(1)
rank, world, d = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
dist.init_process_group("gloo", init_method=f"file://{d}/pg", rank=rank,
                        world_size=world,
                        timeout=datetime.timedelta(seconds=60))
from repro_torch.core.types import AttentionSpec
from repro_torch.distributed import context_parallel as CP
from repro_torch.launch import mesh as ML
mesh = ML.make_debug_mesh(1, world, process=True, device_type="cpu")
assert not mesh.one_graph and mesh.index("model") == [rank]
a = np.load(f"{d}/in.npz")
spec = AttentionSpec(kind="swat", window=int(a["w"]), num_global=4,
                     causal=bool(a["causal"]))
q, k, v, t = (mesh.shard(torch.from_numpy(a[n]), "model", 2)[0].clone()
              for n in "qkvt")
for x in (q, k, v):
    x.requires_grad_()
o = CP.swat_attention_context_parallel(q, k, v, spec, mesh=mesh,
                                       axis="model", block_q=16, block_kv=16)
((o - t) ** 2).sum().backward()
np.savez(f"{d}/out{rank}.npz", o=o.detach().numpy(), dq=q.grad.numpy(),
         dk=k.grad.numpy(), dv=v.grad.numpy())
dist.destroy_process_group()
"""


def run_ranks(code: str, world: int, tmp_path, timeout: float = 180):
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


@pytest.mark.parametrize("world,window,causal", [(2, 8, True),
                                                 (4, 24, False)])
def test_process_mesh_over_gloo_matches_single_process(tmp_path, world,
                                                       window, causal):
    """Each rank holds its (B, H, Lp, D) shard; the halo travels by
    batch_isend_irecv and the global rows by all_reduce, forward and
    backward. Outputs and gradients equal the single-process mesh's."""
    q, k, v, t = _inputs(4, 2, seed=1)
    np.savez(tmp_path / "in.npz", q=q, k=k, v=v, t=t, w=window,
             causal=causal)
    run_ranks(RANK, world, tmp_path)
    spec = AttentionSpec(kind="swat", window=window, num_global=4,
                         causal=causal)
    want = _port_cp(q, k, v, t, spec, mesh=ML.LocalMesh((world,), ("m",)),
                    axis="m")
    outs = [np.load(tmp_path / f"out{r}.npz") for r in range(world)]
    for name, w in zip(("o", "dq", "dk", "dv"), want):
        got = np.concatenate([o[name] for o in outs], axis=2)
        np.testing.assert_allclose(got, w, atol=1e-6, rtol=1e-6,
                                   err_msg=name)


# ------------------------------------------------ the band pass's LSE ------

@pytest.mark.parametrize("idx,causal", [(0, True), (1, True), (3, False)])
def test_plain_backward_dlse_matches_autograd(idx, causal):
    """A CP shard's band pass (offsets, k < 0 on shard 0, k >= L on the
    last shard of a bidirectional spec) with O and LSE both
    differentiated: swat_attention_bwd_plain with dlse against autograd of
    banded_plain, and the autograd Function (`ops.swat_attention_lse`)
    against both."""
    lp, w, n = 32, 24, 4
    spec = AttentionSpec(kind="swat", window=w, causal=causal)
    halo = CP.halo_rows(w, lp, 16)
    lkv = halo + lp + (0 if causal else halo)
    rng = np.random.RandomState(idx)
    q, k, v, do = (torch.from_numpy(rng.randn(2, h, r, 16).astype(
        np.float32)) for h, r in ((4, lp), (2, lkv), (2, lkv), (4, lp)))
    dlse = torch.from_numpy(rng.randn(2, 4, lp).astype(np.float32))
    pat = ops.get_pattern(spec, lp, lkv, 16, 16, q_shift=halo)
    kw = dict(q_offset=idx * lp, kv_offset=idx * lp - halo,
              seq_kv_bound=n * lp)
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    o, lse = SA.banded_plain(*leaves, spec, pat, 0.25, return_lse=True,
                             **kw)
    want = torch.autograd.grad((o * do).sum() + (lse * dlse).sum(), leaves)
    got = SB.swat_attention_bwd_plain(q, k, v, o.detach(), lse.detach(), do,
                                      spec, pat, 0.25, dlse=dlse, **kw)
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    o2, lse2 = ops.swat_attention_lse(*leaves, spec, pat, 0.25, **kw)
    via_fn = torch.autograd.grad((o2 * do).sum() + (lse2 * dlse).sum(),
                                 leaves)
    for name, a, b, c in zip(("dq", "dk", "dv"), got, want, via_fn):
        np.testing.assert_allclose(a.numpy(), b.numpy(), **F32, err_msg=name)
        np.testing.assert_allclose(c.numpy(), b.numpy(), **F32, err_msg=name)


# ---------------------------------------------------- the model's hook -----

@pytest.fixture(scope="module")
def swat_model():
    """JAX loss and grads of the smoke llama + SWAT at L=512 (no CP: the
    function CP computes), and the numpy params."""
    cfg = with_swat(get_smoke_config("llama3p2_1b"), window=64,
                    num_global=4)
    tcfg = t_swat(t_smoke("llama3p2_1b"), window=64, num_global=4)
    jp = JM.init_model(jax.random.PRNGKey(0), cfg)
    tok = np.random.RandomState(0).randint(0, cfg.vocab_size,
                                           (1, 512)).astype(np.int32)
    jb = {"tokens": jnp.asarray(tok), "labels": jnp.asarray(tok)}
    (total, _), grads = jax.value_and_grad(
        lambda p: JM.loss_fn(p, cfg, jb, impl="xla"), has_aux=True)(jp)
    return (tcfg, jax.tree.map(np.asarray, jp), tok, float(total),
            jax.tree.map(np.asarray, grads))


def test_model_loss_and_grads_with_cp_match_jax(swat_model, monkeypatch):
    """set_context_parallel on a 4-shard single-process mesh: every
    attention layer of loss_fn runs the halo exchange (Lp = 128), and the
    loss and every gradient leaf equal the JAX model's."""
    tcfg, np_params, tok, want_total, want_grads = swat_model
    tp = interop.params_from_jax(np_params, tcfg, device="cpu")
    leaves = tree.leaves(tp)
    for p in leaves:
        p.requires_grad_(True)
    batch = {"tokens": torch.from_numpy(tok), "labels": torch.from_numpy(tok)}
    calls = []
    real = CP.swat_attention_cp_local
    monkeypatch.setattr(CP, "swat_attention_cp_local",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    ops.set_context_parallel(ML.LocalMesh((4,), ("model",)), "model")
    try:
        total, _ = TM.loss_fn(tp, tcfg, batch, remat=False)
        grads = torch.autograd.grad(total, leaves)
    finally:
        ops.set_context_parallel(None)
    assert len(calls) == tcfg.num_layers
    np.testing.assert_allclose(float(total.detach()), want_total, **F32)
    got = dict(tree.flatten_with_paths(interop.params_to_numpy(
        tree.unflatten(tp, list(grads)), tcfg)))
    for path, w in tree.flatten_with_paths(want_grads):
        np.testing.assert_allclose(got[path], w, **F32, err_msg=path)


def test_set_context_parallel_refuses_a_process_mesh():
    with pytest.raises(TypeError, match="LocalMesh"):
        ops.set_context_parallel(types.SimpleNamespace(one_graph=False))
    assert ops._CP_CTX is None


def test_example_twin_runs_on_the_cpu():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, str(ROOT / "examples/context_parallel_torch.py"),
         "--cpu"], capture_output=True, text=True, env=env, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "CP(4 shards, cpu) vs O(N^2) oracle" in out.stdout
    assert "524,288" in out.stdout
