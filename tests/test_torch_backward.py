"""The port's attention backward against the JAX package, on the CPU.

On CPU tensors `swat_attention_bwd` runs its plain version, and the
autograd Function behind `ops.swat_attention(impl="kernel")` runs the plain
forward and backward, so these hold the plain backward and the Function's
glue against the JAX package's backward Pallas kernels in interpret mode
and against `jax.grad`. Tolerance: the JAX package's own gradient
tolerance, fp32 atol 5e-5 / rtol 1e-3."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import patterns as JP
from repro.core.types import AttentionSpec
from repro.kernels import ops as JO
from repro.kernels.swat_attention import swat_attention_fwd as j_fwd
from repro.kernels.swat_backward import swat_attention_bwd as j_bwd
from repro_torch.core import patterns as TP
from repro_torch.core.types import AttentionSpec as TSpec
from repro_torch.kernels import ops as TO
from repro_torch.kernels import swat_backward as TB

torch.set_num_threads(1)

GRAD = dict(atol=5e-5, rtol=1e-3)
SPECS = {   # tests/test_kernels.py:80-85, plus random blocks
    "w48": AttentionSpec(kind="swat", window=48, causal=True),
    "w32g16bi": AttentionSpec(kind="swat", window=32, num_global=16,
                              causal=False),
    "w48cap": AttentionSpec(kind="swat", window=48, causal=True,
                            softcap=25.0),
    "dense": AttentionSpec(kind="dense", causal=True),
    "random": AttentionSpec(kind="swat", window=32, num_global=4,
                            num_random=1, random_seed=3, causal=True),
}


def _tspec(spec):
    return TSpec(**dataclasses.asdict(spec))


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _inputs(seed, b, hq, hkv, lq, lkv, d):
    rng = np.random.RandomState(seed)
    return (rng.randn(b, hq, lq, d).astype(np.float32),
            rng.randn(b, hkv, lkv, d).astype(np.float32),
            rng.randn(b, hkv, lkv, d).astype(np.float32),
            rng.randn(b, hq, lq, d).astype(np.float32))


def _compare_bwd(spec, q, k, v, do, *, block=64, q_offset=0, kv_offset=0,
                 seq_kv_bound=None):
    lq, lkv = q.shape[2], k.shape[2]
    jpat = JP.build_block_pattern(spec, lq, lkv, block, block,
                                  q_shift=q_offset - kv_offset)
    tpat = TP.build_block_pattern(_tspec(spec), lq, lkv, block, block,
                                  q_shift=q_offset - kv_offset)
    off = dict(q_offset=q_offset, kv_offset=kv_offset,
               seq_kv_bound=seq_kv_bound)
    o, lse = j_fwd(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), spec,
                   pattern=jpat, interpret=True, return_lse=True, **off)
    want = j_bwd(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), o, lse,
                 jnp.asarray(do), spec, pattern=jpat, interpret=True, **off)
    got = TB.swat_attention_bwd(_t(q), _t(k), _t(v), _t(o), _t(lse), _t(do),
                                _tspec(spec), pattern=tpat, **off)
    for g, w, name in zip(got, want, "qkv"):
        assert g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **GRAD,
                                   err_msg=f"d{name}")


@pytest.mark.parametrize("name", sorted(SPECS))
def test_plain_backward_matches_jax(name):
    """Each spec at L=192 (q and kv blocks of 64, padded nowhere) and
    group 2, against the JAX backward kernels in interpret mode."""
    q, k, v, do = _inputs(0, 1, 4, 2, 192, 192, 32)
    _compare_bwd(SPECS[name], q, k, v, do)


@pytest.mark.parametrize("hq,hkv", [(4, 4), (4, 1)], ids=["group1",
                                                          "group4"])
def test_plain_backward_gqa_groups(hq, hkv):
    q, k, v, do = _inputs(1, 2, hq, hkv, 192, 192, 16)
    _compare_bwd(SPECS["w32g16bi"], q, k, v, do)


def test_plain_backward_padded_blocks():
    """L=192 in blocks of 128: the last q and kv blocks are half padding."""
    q, k, v, do = _inputs(2, 1, 4, 2, 192, 192, 16)
    _compare_bwd(SPECS["w48"], q, k, v, do, block=128)


def test_plain_backward_global_row_pass():
    """The dense global-row pass: 4 query rows against every key."""
    gspec = AttentionSpec(kind="dense", causal=True)
    q, k, v, do = _inputs(3, 1, 4, 2, 4, 192, 16)
    _compare_bwd(gspec, q, k, v, do)


@pytest.mark.parametrize("causal", [True, False])
def test_plain_backward_offsets(causal):
    """A context-parallel slice: rows [64, 128) of a 256-token sequence
    against kv rows [32, 160)."""
    spec = AttentionSpec(kind="swat", window=32, causal=causal)
    q, k, v, do = _inputs(4, 1, 2, 2, 64, 128, 16)
    _compare_bwd(spec, q, k, v, do, block=16, q_offset=64, kv_offset=32,
                 seq_kv_bound=256)


AUTOGRAD_SPECS = {
    "w32g16bi": SPECS["w32g16bi"],
    "w48g4cap": AttentionSpec(kind="swat", window=48, num_global=4,
                              causal=True, softcap=25.0),
    "dense": SPECS["dense"],
}


@pytest.fixture(scope="module")
def jax_grads():
    """jax.grad of sum(sin(out)) through the JAX swat_attention, per spec
    and impl (computed once: the pallas impl runs in interpret mode)."""
    q, k, v, _ = _inputs(5, 1, 4, 2, 192, 192, 32)
    out = {}
    for name, spec in AUTOGRAD_SPECS.items():
        for impl in ("pallas", "xla"):
            f = lambda q_, k_, v_: jnp.sum(jnp.sin(JO.swat_attention(
                q_, k_, v_, spec, block_q=64, block_kv=64, impl=impl)))
            out[name, impl] = jax.grad(f, argnums=(0, 1, 2))(
                jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    return (q, k, v), out


@pytest.mark.parametrize("name", sorted(AUTOGRAD_SPECS))
@pytest.mark.parametrize("impl,jimpl", [("kernel", "pallas"),
                                        ("banded", "xla")])
def test_autograd_matches_jax_grad(jax_grads, name, impl, jimpl):
    """torch.autograd.grad through the port's ops.swat_attention (impl
    "kernel": the autograd Function with the plain backward on CPU; impl
    "banded": autograd through plain ops) against jax.grad through the JAX
    pallas and xla impls, both attention passes included."""
    (q, k, v), want = jax_grads
    qkv = [_t(x).requires_grad_() for x in (q, k, v)]
    out = TO.swat_attention(*qkv, _tspec(AUTOGRAD_SPECS[name]), block_q=64,
                            block_kv=64, impl=impl)
    got = torch.autograd.grad(torch.sin(out).sum(), qkv)
    for g, w, n in zip(got, want[name, jimpl], "qkv"):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **GRAD,
                                   err_msg=f"d{n}")


def test_cpu_backward_launches_no_kernel():
    """On CPU tensors the wrapper runs the plain version: the launch
    counters count kernel launches only."""
    TB.DQ_LAUNCHES.reset()
    TB.DKV_LAUNCHES.reset()
    q, k, v, do = (_t(x) for x in _inputs(6, 1, 2, 1, 64, 64, 16))
    spec = _tspec(SPECS["w48"])
    pat = TO.get_pattern(spec, 64, 64, 32, 32)
    o, lse = TO.fwd_mod.swat_attention_fwd(q, k, v, spec, pattern=pat,
                                           return_lse=True)
    TB.swat_attention_bwd(q, k, v, o, lse, do, spec, pattern=pat)
    assert TB.DQ_LAUNCHES.n == 0 and TB.DKV_LAUNCHES.n == 0


def test_backward_refuses_other_devices():
    """A tensor that is neither on the CPU nor on a card gets no plain
    fallback: the wrapper raises."""
    spec = _tspec(SPECS["w48"])
    pat = TO.get_pattern(spec, 64, 64, 32, 32)
    m = lambda *s: torch.empty(*s, device="meta")
    q, k, v = m(1, 2, 64, 16), m(1, 1, 64, 16), m(1, 1, 64, 16)
    with pytest.raises(ValueError, match="no kernel"):
        TB.swat_attention_bwd(q, k, v, q, m(1, 2, 64), q, spec, pattern=pat)
