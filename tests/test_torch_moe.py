"""The port's MoE FFN (`repro_torch.core.moe`) against the JAX package's
`core/moe.py` on the CPU: each test of tests/test_moe.py held on the same
numpy inputs and the same params (converted through `interop`), plus the
"dense" and "ep" dispatches, top-k ties, padding invariance of "dense", the
sort dispatch's gather-only, repeatable backward, and the serving call's
freedom from host syncs. fp32 tolerance atol 2e-5 / rtol 1e-4 against JAX;
the JAX tests' own 1e-4 / 1e-3 against the dense oracle."""
import collections

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

try:
    from hypothesis import given, settings, strategies as st
except ImportError:  # bare env: deterministic seeded fallback
    from hypothesis_fallback import given, settings, strategies as st

from repro.core import moe as JM
from repro.core.types import MoESpec as JSpec
from repro_torch import interop
from repro_torch.core import moe as TM
from repro_torch.core.types import MoESpec as TSpec

torch.set_num_threads(1)

F32 = dict(atol=2e-5, rtol=1e-4)
ORACLE = dict(atol=1e-4, rtol=1e-3)       # tests/test_moe.py's tolerance


def make(rng, t=64, d=32, f=64, e=8, k=2, b=1):
    """(JAX spec, port spec, JAX params, port params, x numpy (b, t, d))."""
    jspec, tspec = JSpec(num_experts=e, top_k=k), TSpec(num_experts=e,
                                                        top_k=k)
    jp = JM.init_moe(jax.random.PRNGKey(0), d, f, jspec, dtype=jnp.float32)
    tp = {n: interop.to_torch(np.asarray(v), "cpu") for n, v in jp.items()}
    x = (rng.randn(b, t, d) * 0.5).astype(np.float32)
    return jspec, tspec, jp, tp, x


def both(jp, tp, x, jspec, tspec, **kw):
    """(JAX out, JAX aux, port out, port aux) as numpy / floats."""
    jo, ja = JM.moe_ffn(jp, jnp.asarray(x), jspec, **kw)
    to, ta = TM.moe_ffn(tp, torch.from_numpy(x), tspec, **kw)
    return np.asarray(jo), float(ja), to.numpy(), float(ta)


def test_dispatch_matches_dense_ref(rng):
    jspec, tspec, jp, tp, x = make(rng)
    jo, ja, to, ta = both(jp, tp, x, jspec, tspec, capacity_factor=8.0)
    want = TM.moe_ffn_dense_ref(tp, torch.from_numpy(x), tspec).numpy()
    np.testing.assert_allclose(to, want, **ORACLE)
    np.testing.assert_allclose(
        want, np.asarray(JM.moe_ffn_dense_ref(jp, jnp.asarray(x), jspec)),
        **F32)
    np.testing.assert_allclose(to, jo, **F32)
    np.testing.assert_allclose(ta, ja, **F32)
    assert ta > 0


@settings(max_examples=10, deadline=None)
@given(seed=st.integers(0, 50),
       e=st.sampled_from([4, 8]), k=st.sampled_from([1, 2, 4]))
def test_dispatch_matches_ref_property(seed, e, k):
    rng = np.random.RandomState(seed)
    jspec, tspec, jp, tp, x = make(rng, t=32, e=e, k=min(k, e))
    jo, ja, to, ta = both(jp, tp, x, jspec, tspec, capacity_factor=float(e))
    want = TM.moe_ffn_dense_ref(tp, torch.from_numpy(x), tspec).numpy()
    np.testing.assert_allclose(to, want, **ORACLE)
    np.testing.assert_allclose(to, jo, **F32)
    np.testing.assert_allclose(ta, ja, **F32)


def test_capacity_drops_bound_output(rng):
    """Tight capacity drops tokens: the output stays finite, dropped slots
    add nothing, and the port drops the same slots as the JAX package."""
    jspec, tspec, jp, tp, x = make(rng, t=128, e=4, k=2)
    jo, _, to, _ = both(jp, tp, x, jspec, tspec, capacity_factor=0.25)
    assert np.isfinite(to).all()
    ref = TM.moe_ffn_dense_ref(tp, torch.from_numpy(x), tspec).numpy()
    assert np.linalg.norm(to) <= np.linalg.norm(ref) * 1.5
    np.testing.assert_allclose(to, jo, **F32)
    # some rows lost mass against the no-drop oracle
    assert (np.abs(to - ref).max(-1) > 1e-3).any()


def test_gates_renormalized(rng):
    """Top-k gates sum to 1 a token, and equal JAX's, expert for expert."""
    jspec, tspec, jp, tp, x = make(rng)
    xf = x.reshape(-1, x.shape[-1])
    probs = jax.nn.softmax(jnp.asarray(xf) @ jp["router"], -1)
    gv, gi = jax.lax.top_k(probs, jspec.top_k)
    gv = gv / jnp.maximum(gv.sum(-1, keepdims=True), 1e-9)
    tprobs, tgv, tgi = TM._route(tp, torch.from_numpy(xf), tspec.top_k)
    np.testing.assert_allclose(tgv.sum(-1).numpy(), 1.0, atol=1e-6)
    np.testing.assert_array_equal(tgi.numpy(), np.asarray(gi))
    np.testing.assert_allclose(tgv.numpy(), np.asarray(gv), **F32)
    np.testing.assert_allclose(tprobs.numpy(), np.asarray(probs), **F32)


def test_aux_loss_uniform_router_is_one(rng):
    """The Switch aux loss is 1.0 for a uniform router, as in JAX."""
    jspec, tspec, jp, tp, x = make(rng, e=4, k=1)
    jp = dict(jp, router=jnp.zeros_like(jp["router"]))
    tp = dict(tp, router=torch.zeros_like(tp["router"]))
    _, ja, _, ta = both(jp, tp, x, jspec, tspec, capacity_factor=4.0)
    assert abs(ta - 1.0) < 0.05
    np.testing.assert_allclose(ta, ja, **F32)


@pytest.mark.parametrize("capacity_factor", [4.0, 0.5],
                         ids=["no-drops", "drops"])
def test_moe_grads_flow(rng, capacity_factor):
    """Autograd through the sort dispatch and the aux loss reaches the
    input, the router and every expert leaf, and equals jax.grad, with no
    slot dropped and with a large share of the slots dropped."""
    jspec, tspec, jp, tp, x = make(rng)

    def jloss(p, xj):
        y, aux = JM.moe_ffn(p, xj, jspec, capacity_factor=capacity_factor)
        return jnp.sum(y ** 2) + 0.01 * aux

    want, want_x = jax.grad(jloss, argnums=(0, 1))(jp, jnp.asarray(x))
    want = dict(want, x=want_x)
    leaves = {n: v.clone().requires_grad_(True) for n, v in tp.items()}
    xt = torch.from_numpy(x).requires_grad_(True)
    y, aux = TM.moe_ffn(leaves, xt, tspec, capacity_factor=capacity_factor)
    loss = torch.sum(y ** 2) + 0.01 * aux
    got = dict(zip([*leaves, "x"], torch.autograd.grad(
        loss, [*leaves.values(), xt])))
    for name in ("x", "router", "w1", "w2", "w3"):
        assert float(got[name].abs().max()) > 0, name
        np.testing.assert_allclose(got[name].numpy(), np.asarray(want[name]),
                                   **F32, err_msg=name)


def _graph_nodes(fn):
    """Every node of an autograd graph, from its root `fn`."""
    seen, todo = set(), [fn]
    while todo:
        node = todo.pop()
        if node is None or node in seen:
            continue
        seen.add(node)
        todo.extend(f for f, _ in node.next_functions)
    return seen


def test_sort_backward_gathers_only(rng):
    """With slots dropped, the sort dispatch's backward moves rows by
    gathers alone: its graph holds no index backward (a sort and a serial
    scatter-add over duplicate indices) and no accumulating index_put,
    and two backward passes give bitwise-equal gradients."""
    _, tspec, _, tp, x = make(rng, t=64, e=4, k=3)
    leaves = {n: v.clone().requires_grad_(True) for n, v in tp.items()}
    xt = torch.from_numpy(x).requires_grad_(True)
    t, k = 64, 3
    cap = TM.sort_capacity(t, k, 4, 0.5)
    _, _, ids = TM._route(tp, xt.detach().reshape(t, -1), k)
    _, keep = TM.group_ranks(ids.reshape(-1), cap, 4)
    assert 0 < int((~keep).sum()) < t * k            # some slots drop
    y, aux = TM.moe_ffn(leaves, xt, tspec, capacity_factor=0.5,
                        dispatch="sort")
    loss = torch.sum(y ** 2) + 0.01 * aux
    nodes = _graph_nodes(loss.grad_fn)
    names = {type(n).__name__ for n in nodes}
    assert "IndexBackward0" not in names, sorted(names)
    assert not any(n._saved_accumulate for n in nodes
                   if type(n).__name__ == "IndexPutBackward0")
    inputs = [*leaves.values(), xt]
    first = torch.autograd.grad(loss, inputs, retain_graph=True)
    second = torch.autograd.grad(loss, inputs)
    for name, a, b in zip([*leaves, "x"], first, second):
        assert torch.equal(a, b), name


@pytest.mark.parametrize("dispatch", ["sort", "dense", "ep"])
def test_dispatch_matches_jax_with_aux(rng, dispatch):
    """Each dispatch against the JAX function (no mesh: "ep" falls through
    to the sort schedule in both), outputs and aux, at two batch rows and
    the spec's dispatch overridden per call."""
    jspec, tspec, jp, tp, x = make(rng, t=24, e=8, k=2, b=2)
    jo, ja, to, ta = both(jp, tp, x, jspec, tspec, dispatch=dispatch)
    np.testing.assert_allclose(to, jo, **F32)
    np.testing.assert_allclose(ta, ja, **F32)
    out, none = TM.moe_ffn(tp, torch.from_numpy(x), tspec, dispatch=dispatch,
                           return_aux=False)
    assert none is None and torch.equal(out, torch.from_numpy(to))


def test_unknown_dispatch_raises(rng):
    _, tspec, _, tp, x = make(rng, t=8)
    with pytest.raises(ValueError):
        TM.moe_ffn(tp, torch.from_numpy(x), tspec, dispatch="alltoall")


@pytest.mark.parametrize("e,k", [(8, 3), (64, 6)])
def test_ties_select_the_jax_experts(rng, e, k):
    """A zero router and a zero input row give every expert the same
    probability: the port picks the JAX experts (the lowest indices), and
    the whole FFN agrees."""
    jspec, tspec, jp, tp, x = make(rng, t=6, e=e, k=k)
    x[0, 2] = 0.0                                 # a zero hidden row
    cases = {"zero row": (jp, tp),
             "zero router": (dict(jp, router=jnp.zeros_like(jp["router"])),
                             dict(tp, router=torch.zeros_like(tp["router"])))}
    for name, (jpp, tpp) in cases.items():
        xf = x.reshape(-1, x.shape[-1])
        probs = jax.nn.softmax(jnp.asarray(xf) @ jpp["router"], -1)
        _, want = jax.lax.top_k(probs, k)
        _, _, got = TM._route(tpp, torch.from_numpy(xf), k)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want),
                                      err_msg=name)
        np.testing.assert_array_equal(got.numpy()[2], np.arange(k))
        for dispatch in ("sort", "dense"):
            jo, _, to, _ = both(jpp, tpp, x, jspec, tspec, dispatch=dispatch)
            np.testing.assert_allclose(to, jo, **F32,
                                       err_msg=f"{name} {dispatch}")


def test_dense_is_padding_invariant(rng):
    """Under "dense" a row's output does not depend on its batch-mates:
    changing the other rows (as padding or another request would) leaves
    it bitwise equal; "sort" couples rows through the shared capacity."""
    _, tspec, _, tp, x = make(rng, t=16, e=4, k=2, b=3)
    other = x.copy()
    other[0] = 0.0
    other[2] = rng.randn(*x[2].shape).astype(np.float32) * 3.0
    outs = {d: [TM.moe_ffn(tp, torch.from_numpy(v), tspec, dispatch=d,
                           capacity_factor=0.5, return_aux=False)[0][1]
                for v in (x, other)] for d in ("dense", "sort")}
    assert torch.equal(*outs["dense"])
    assert not torch.equal(*outs["sort"])


class _OpLog(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops[str(func)] += 1
        return func(*args, **(kwargs or {}))


SYNCING = ("bincount", "nonzero", "_local_scalar_dense", "unique", "item")


@pytest.mark.parametrize("dispatch,return_aux",
                         [("dense", False), ("sort", True)],
                         ids=["serving", "training"])
def test_no_host_syncing_op(rng, dispatch, return_aux):
    """The serving call (dense, no aux) and the training call (sort, aux)
    issue no op that copies a value to the host: a decode block stays
    capturable as a CUDA graph and a train step never waits on the card."""
    _, tspec, _, tp, x = make(rng, t=16, e=8, k=2, b=2)
    with _OpLog() as log:
        TM.moe_ffn(tp, torch.from_numpy(x), tspec, dispatch=dispatch,
                   return_aux=return_aux)
    names = {op.split(".")[1] for op in log.ops}
    assert names and not names & set(SYNCING), sorted(names)
    if dispatch == "dense":
        assert "scatter_add" not in names          # the aux is not computed
