"""The port's Mamba2 SSD (`repro_torch.core.ssm`) against the JAX package's
`core/ssm.py` on the CPU: each test of tests/test_ssm.py mirrored on the
same numpy inputs, plus the conv's bf16 rounding points, the prefill cache's
states with and without `lengths`, the chunk-256 gradient (finite in the
port where the JAX formulation's is not) and an op log of `mamba_decode`
(no host sync, both cache leaves written in place). fp32 tolerance atol
2e-5 / rtol 1e-4."""
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

from repro.configs import get_smoke_config
from repro.core import model as JModel
from repro.core import ssm as JS
from repro.core.types import SSMSpec as JSpec
from repro_torch import interop
from repro_torch.configs import get_smoke_config as t_smoke
from repro_torch.core import model as TModel
from repro_torch.core import ssm as TS
from repro_torch.core.types import SSMSpec as TSpec

torch.set_num_threads(1)

F32 = dict(atol=2e-5, rtol=1e-4)
SPEC = dict(state_dim=8, head_dim=16, expand=2, conv_width=4, chunk_size=8,
            num_groups=1)


def rand_inputs(rng, b=2, l=96, h=4, p=16, g=2, sd=8):
    """tests/test_ssm.py's inputs, as numpy fp32."""
    x = rng.randn(b, l, h, p).astype(np.float32)
    dt = (np.abs(rng.randn(b, l, h)) * 0.1).astype(np.float32)
    a = (-(np.abs(rng.randn(h)) + 0.3)).astype(np.float32)
    bm = rng.randn(b, l, g, sd).astype(np.float32)
    cm = rng.randn(b, l, g, sd).astype(np.float32)
    d = rng.randn(h).astype(np.float32)
    return x, dt, a, bm, cm, d


def _both(fn_j, fn_t, args, **kw):
    want = np.asarray(fn_j(*map(jnp.asarray, args), **kw))
    got = fn_t(*map(torch.from_numpy, args), **kw).numpy()
    return got, want


@pytest.mark.parametrize("chunk", [8, 32, 128])
def test_chunked_matches_jax_and_scan(chunk, rng):
    args = rand_inputs(rng)
    got, want = _both(JS.ssd_chunked, TS.ssd_chunked, args, chunk=chunk)
    np.testing.assert_allclose(got, want, **F32)
    ref, _ = _both(JS.ssd_scan_ref, TS.ssd_scan_ref, args)
    np.testing.assert_allclose(got, ref, atol=2e-4, rtol=1e-3)


def test_scan_ref_matches_jax(rng):
    got, want = _both(JS.ssd_scan_ref, TS.ssd_scan_ref, rand_inputs(rng))
    np.testing.assert_allclose(got, want, **F32)


@settings(max_examples=10, deadline=None)
@given(seed=st.integers(0, 50), l=st.sampled_from([17, 64, 100]),
       chunk=st.sampled_from([16, 64]))
def test_chunked_matches_jax_property(seed, l, chunk):
    args = rand_inputs(np.random.RandomState(seed), l=l)
    got, want = _both(JS.ssd_chunked, TS.ssd_chunked, args, chunk=chunk)
    np.testing.assert_allclose(got, want, **F32)


def _mixer(dm=32, dtype=jnp.float32, seed=1):
    """JAX init_mamba params at SPEC, and the port's copy."""
    jspec, tspec = JSpec(**SPEC), TSpec(**SPEC)
    jp = JS.init_mamba(jax.random.PRNGKey(seed), dm, jspec, dtype=dtype)
    tp = {k: ({n: interop.to_torch(np.asarray(x), "cpu")
               for n, x in v.items()} if isinstance(v, dict)
              else interop.to_torch(np.asarray(v), "cpu"))
          for k, v in jp.items()}
    return jspec, tspec, jp, tp


def test_mamba_block_matches_jax_and_decode(rng):
    """mamba_block against the JAX block, and the port's mamba_decode token
    by token against both (tests/test_ssm.py's decode parity)."""
    jspec, tspec, jp, tp = _mixer()
    dm, l = 32, 20
    xs = (rng.randn(2, l, dm) * 0.3).astype(np.float32)
    want = np.asarray(JS.mamba_block(jp, jnp.asarray(xs), jspec, chunk=8))
    full = TS.mamba_block(tp, torch.from_numpy(xs), tspec, chunk=8)
    np.testing.assert_allclose(full.numpy(), want, **F32)
    jc = JS.init_mamba_cache(dm, jspec, 2, dtype=jnp.float32)
    tc = TS.init_mamba_cache(dm, tspec, 2, torch.float32, "cpu")
    jdecode = jax.jit(JS.mamba_decode, static_argnums=3)
    outs = []
    for t in range(l):
        jy, jc = jdecode(jp, jnp.asarray(xs[:, t:t + 1]), jc, jspec)
        ty, tc = TS.mamba_decode(tp, torch.from_numpy(xs[:, t:t + 1]), tc,
                                 tspec)
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **F32)
        outs.append(ty)
    for leaf in ("conv", "ssm"):
        np.testing.assert_allclose(tc[leaf].numpy(), np.asarray(jc[leaf]),
                                   **F32)
    np.testing.assert_allclose(torch.cat(outs, 1).numpy(), want, atol=1e-3,
                               rtol=1e-3)


def test_state_decay_contracts(rng):
    """|exp(dt*a)| < 1 on the port's ops: the recurrence is stable."""
    _, dt, a, *_ = rand_inputs(rng)
    decay = torch.exp(torch.from_numpy(dt) * torch.from_numpy(a))
    assert float(decay.max()) < 1.0 and float(decay.min()) > 0.0


def test_grads_flow_like_jax(rng):
    """The gradient of sum(ssd_chunked ** 2) in every input at the smoke
    chunk (16) against jax.grad."""
    args = rand_inputs(rng, b=1, l=32)
    jg = jax.grad(lambda *a: jnp.sum(JS.ssd_chunked(*a, chunk=16) ** 2),
                  argnums=tuple(range(6)))(*map(jnp.asarray, args))
    ts = [torch.from_numpy(a).requires_grad_(True) for a in args]
    (TS.ssd_chunked(*ts, chunk=16) ** 2).sum().backward()
    for t, w in zip(ts, jg):
        assert bool(torch.isfinite(t.grad).all())
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), atol=1e-4,
                                   rtol=1e-4)
    assert float(ts[0].grad.abs().max()) > 0


def _published_dt_case(rng, l=512, h=4):
    """L=512 at the published chunk 256: dt drawn from init_mamba's range
    [1e-3, 0.1] (log-uniform) and a in [-16, -1], where a chunk's decay sum
    passes 88 and exp overflows above the diagonal."""
    x = rng.randn(1, l, h, 8).astype(np.float32)
    dt = np.exp(rng.uniform(np.log(1e-3), np.log(0.1), (1, l, h))
                ).astype(np.float32)
    a = (-rng.uniform(1.0, 16.0, h)).astype(np.float32)
    bm = rng.randn(1, l, 1, 8).astype(np.float32)
    cm = rng.randn(1, l, 1, 8).astype(np.float32)
    return x, dt, a, bm, cm, np.ones(h, np.float32)


def test_chunk_256_forward_equal_and_dt_gradient_finite(rng):
    """The port's forward equals JAX's; JAX's dt-gradient is not finite
    (exp then select: 0 * inf in the backward), the port's is (mask, then
    exp) and agrees with autograd through the sequential oracle."""
    args = _published_dt_case(rng)
    got, want = _both(JS.ssd_chunked, TS.ssd_chunked, args, chunk=256)
    np.testing.assert_allclose(got, want, **F32)
    rest = [jnp.asarray(a) for a in args]
    jg = jax.grad(lambda dt: jnp.sum(JS.ssd_chunked(
        rest[0], dt, *rest[2:], chunk=256) ** 2))(rest[1])
    assert not bool(jnp.isfinite(jg).all())
    grads = []
    for fn in (lambda *a: TS.ssd_chunked(*a, chunk=256), TS.ssd_scan_ref):
        ts = [torch.from_numpy(a) for a in args]
        ts[1].requires_grad_(True)
        (fn(*ts) ** 2).sum().backward()
        grads.append(ts[1].grad)
    assert bool(torch.isfinite(grads[0]).all())
    scale = float(grads[1].abs().max())
    np.testing.assert_allclose(grads[0].numpy(), grads[1].numpy(),
                               atol=1e-4 * scale, rtol=1e-3)


def test_causal_conv_bf16_bitwise_jax(rng):
    """bf16 taps summed in order, each product and sum rounded, bias last:
    bitwise the JAX conv."""
    x = jnp.asarray(rng.randn(2, 20, 24), jnp.bfloat16)
    w = jnp.asarray(rng.randn(4, 24) * 0.5, jnp.bfloat16)
    b = jnp.asarray(rng.randn(24), jnp.bfloat16)
    want = np.asarray(JS._causal_conv(x, w, b).astype(jnp.float32))
    got = TS._causal_conv(*(interop.to_torch(np.asarray(a), "cpu")
                            for a in (x, w, b)))
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), want)


def test_init_mamba_layout_and_ranges():
    """init_mamba's leaves, shapes and dtypes are the JAX ones (bf16
    projections; fp32 a_log, d_skip, dt_bias, norm); a_log is exactly
    log(linspace(1, 16, H)) and softplus(dt_bias) lies in [1e-3, 0.1]."""
    jspec, tspec = JSpec(**SPEC), TSpec(**SPEC)
    want = jax.tree.map(np.asarray, JS.init_mamba(
        jax.random.PRNGKey(0), 32, jspec, dtype=jnp.bfloat16))
    gen = torch.Generator().manual_seed(0)
    got = TS.init_mamba(gen, 32, tspec, torch.bfloat16, "cpu")
    assert got.keys() == want.keys()
    for k, w in want.items():
        g = got[k]["scale"] if k == "norm" else got[k]
        w = w["scale"] if k == "norm" else w
        assert tuple(g.shape) == w.shape, k
        assert str(g.dtype).split(".")[-1] == w.dtype.name, k
    np.testing.assert_array_equal(got["a_log"].numpy(), want["a_log"])
    dt = torch.nn.functional.softplus(got["dt_bias"])
    assert float(dt.min()) >= 1e-3 * (1 - 1e-5)
    assert float(dt.max()) <= 0.1 * (1 + 1e-5)
    assert float(got["conv_w"].float().abs().max()) <= 1.0


@pytest.mark.parametrize("with_lengths", [False, True],
                         ids=["full", "lengths"])
def test_prefill_cache_states_match_jax(rng, with_lengths):
    """`_mamba_prefill_cache`'s conv window and SSM state against the JAX
    function's, on a right-padded batch (with lengths: row 0 stops at 2
    tokens, inside the first conv window, row 1 at 13) and on the full
    rows; the lengths states equal a full pass over each row's prefix."""
    cfg, tcfg = get_smoke_config("mamba2_1p3b"), t_smoke("mamba2_1p3b")
    jp = JModel.init_model(jax.random.PRNGKey(2), cfg)
    p = jax.tree.map(np.asarray, jp["blocks"]["l0"]["mixer"])
    p = jax.tree.map(lambda a: a[0], p)
    tp = {k: ({n: torch.from_numpy(np.array(x)) for n, x in v.items()}
              if isinstance(v, dict) else torch.from_numpy(np.array(v)))
          for k, v in p.items()}
    h = (rng.randn(2, 16, cfg.d_model) * 0.5).astype(np.float32)
    lens = np.asarray([2, 13], np.int32) if with_lengths else None
    want = JModel._mamba_prefill_cache(
        p, jnp.asarray(h), cfg,
        lengths=None if lens is None else jnp.asarray(lens))
    got = TModel._mamba_prefill_cache(
        tp, torch.from_numpy(h), tcfg,
        lengths=None if lens is None else torch.from_numpy(lens))
    for leaf in ("conv", "ssm"):
        np.testing.assert_allclose(got[leaf].numpy(), np.asarray(want[leaf]),
                                   **F32, err_msg=leaf)
    if with_lengths:
        for row, n in enumerate(lens):
            one = TModel._mamba_prefill_cache(
                tp, torch.from_numpy(h[row:row + 1, :n]), tcfg)
            for leaf in ("conv", "ssm"):
                np.testing.assert_allclose(got[leaf][row].numpy(),
                                           one[leaf][0].numpy(), **F32)


class _OpLog(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops[str(func)] += 1
        return func(*args, **(kwargs or {}))


SYNCING = ("item", "nonzero", "_local_scalar_dense")


def test_mamba_decode_no_host_sync_and_in_place(rng):
    """mamba_decode issues no op that copies a value to the host (a decode
    block stays capturable) and writes its two cache leaves in place: the
    dict keeps the same tensors and storage, and their contents change."""
    _, tspec, _, tp = _mixer()
    cache = TS.init_mamba_cache(32, tspec, 2, torch.float32, "cpu")
    ids = {k: (id(v), v.data_ptr()) for k, v in cache.items()}
    x = torch.from_numpy((rng.randn(2, 1, 32) * 0.3).astype(np.float32))
    with _OpLog() as log:
        TS.mamba_decode(tp, x, cache, tspec)
    assert not [op for op in log.ops
                if any(s in op for s in SYNCING)], log.ops
    assert {k: (id(v), v.data_ptr()) for k, v in cache.items()} == ids
    assert float(cache["ssm"].abs().max()) > 0
    assert float(cache["conv"][:, -1].abs().max()) > 0
    assert sum(n for op, n in log.ops.items() if "copy_" in op) == 2

