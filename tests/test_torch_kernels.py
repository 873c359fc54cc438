"""The port's kernel modules against the JAX package, on the CPU.

On CPU tensors the port's kernel wrappers run their plain versions, so
these hold the plain versions (and the wrappers' CPU dispatch) against the
JAX Pallas kernels in interpret mode and the JAX package's references.
Tolerances are the JAX package's own: fp32 atol 2e-5 / rtol 1e-4, bf16
atol 3e-2; ring caches exactly (inserts are copies)."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

try:
    from hypothesis import given, settings, strategies as st
except ImportError:
    from hypothesis_fallback import given, settings, strategies as st

from repro.kernels import ops as JO
from repro.kernels.swat_attention import swat_attention_fwd as j_fwd
from repro_torch.core.layers import _round_capacity
from repro_torch.core.types import AttentionSpec as TSpec
from repro_torch.kernels import ops as TO
from repro_torch.kernels import ref as TR
from repro_torch.kernels import swat_attention as TA
from repro_torch.kernels import swat_decode as TD
from test_kernels import SPEC_CASES, _fifo_ring_caches

torch.set_num_threads(1)

F32 = dict(atol=2e-5, rtol=1e-4)


def _tspec(spec):
    return TSpec(**dataclasses.asdict(spec))


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.array(a, np.float32)).to(dtype)


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


# ------------------------------------------------------- fused decode ------

@pytest.mark.parametrize("group", [1, 4, 8])
@pytest.mark.parametrize("t", [1, 4])
@pytest.mark.parametrize("dtype,atol", [("float32", 2e-5), ("bfloat16", 3e-2)])
def test_fused_decode_matches_jax(group, t, dtype, atol):
    """group {1,4,8} x T {1,4} x fp32/bf16, slots cold / partial / freshly
    wrapped / multiply wrapped, ragged num_new: the port's fused decode
    (CPU dispatch of the kernel wrapper) against the JAX fused Pallas
    kernel in interpret mode and against the JAX ref impl."""
    rng = np.random.RandomState(group * 10 + t)
    spec = dict(kind="swat", window=12, num_global=4, causal=True)
    hkv, d = 2, 32
    cap = 12 + 1 + (t - 1) + 4
    alloc = _round_capacity(cap)
    lens = [0, 3, cap - 1, cap, 4 * cap + 7]
    b = len(lens)
    kc, vc = _fifo_ring_caches(rng, lens, hkv, cap, alloc, d, num_global=4)
    q = rng.randn(b, group * hkv, t, d).astype(np.float32)
    nk = rng.randn(b, hkv, t, d).astype(np.float32)
    nv = rng.randn(b, hkv, t, d).astype(np.float32)
    nn = np.asarray([t, t, max(1, t - 1), t, t], np.int32)
    pos = np.asarray(lens, np.int32)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    jspec = SPEC_CASES[0].__class__(**spec)
    jargs = dict(new_kv=(jnp.asarray(nk, jdt), jnp.asarray(nv, jdt)),
                 num_new=jnp.asarray(nn), pos=jnp.asarray(pos), ring_cap=cap)
    jq, jk, jv = (jnp.asarray(x, jdt) for x in (q, kc, vc))
    o_pal, k_pal, v_pal = JO.decode_attention(jq, jk, jv, None, jspec,
                                              impl="pallas", interpret=True,
                                              **jargs)
    o_ref, k_ref, v_ref = JO.decode_attention(jq, jk, jv, None, jspec,
                                              impl="ref", **jargs)
    tk, tv = _t(kc, tdt), _t(vc, tdt)
    out = TD.swat_decode_fused(
        _t(q, tdt), tk, tv, _t(nk, tdt), _t(nv, tdt),
        torch.from_numpy(pos), torch.from_numpy(nn), TSpec(**spec),
        ring_cap=cap)
    for want_k, want_v in ((k_pal, v_pal), (k_ref, v_ref)):
        np.testing.assert_array_equal(tk.float().numpy(), _np(want_k))
        np.testing.assert_array_equal(tv.float().numpy(), _np(want_v))
    for want in (o_pal, o_ref):
        for i in range(b):
            real = int(nn[i])   # rows past num_new are garbage by contract
            np.testing.assert_allclose(
                out[i, :, :real].float().numpy(), _np(want)[i, :, :real],
                atol=atol, rtol=1e-4 if dtype == "float32" else 1e-2,
                err_msg=f"slot {i}")


def test_decode_attention_op_updates_caches_in_place():
    """ops.decode_attention (every impl) returns the caches it was given,
    updated in place, and the impls agree."""
    rng = np.random.RandomState(3)
    spec = TSpec(kind="swat", window=6, num_global=2, causal=True)
    cap, w = 9, 16
    k0 = _t(rng.randn(2, 1, w, 8))
    v0 = _t(rng.randn(2, 1, w, 8))
    q = _t(rng.randn(2, 2, 1, 8))
    new = (_t(rng.randn(2, 1, 1, 8)), _t(rng.randn(2, 1, 1, 8)))
    outs = []
    for impl in ("kernel", "banded", "ref"):
        k, v = k0.clone(), v0.clone()
        o, k2, v2 = TO.decode_attention(q, k, v, None, spec, impl=impl,
                                        new_kv=new, pos=[4, 11], ring_cap=cap)
        assert k2 is k and v2 is v
        outs.append((o, k, v))
    for o, k, v in outs[1:]:
        torch.testing.assert_close(o, outs[0][0], **F32)
        assert torch.equal(k, outs[0][1]) and torch.equal(v, outs[0][2])
    # plain mode: a clamped valid-prefix length on a cache wider than the
    # band loses the ring phase, so it is refused (as in the JAX package)
    with pytest.raises(ValueError, match="needs absolute"):
        TO.decode_attention(q, k0, v0, 5, spec)


def test_kernel_wrappers_launch_or_raise_off_the_cpu():
    """A tensor that is not on the CPU never reaches a plain version: on a
    device with no kernel the wrappers raise."""
    spec = TSpec(kind="swat", window=4, causal=True)
    meta = lambda *s: torch.empty(*s, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        TD.swat_decode_fused(meta(1, 1, 1, 16), meta(1, 1, 16, 16),
                             meta(1, 1, 16, 16), meta(1, 1, 1, 16),
                             meta(1, 1, 1, 16),
                             torch.zeros(1, dtype=torch.int32, device="meta"),
                             torch.ones(1, dtype=torch.int32, device="meta"),
                             spec, ring_cap=6)
    with pytest.raises(ValueError, match="no kernel"):
        TA.swat_attention_fwd(meta(1, 1, 8, 16), meta(1, 1, 8, 16),
                              meta(1, 1, 8, 16), spec)
    assert TD.LAUNCHES.n == 0 and TA.LAUNCHES.n == 0


# ----------------------------------------------------- banded forward ------

@pytest.mark.parametrize("spec", SPEC_CASES, ids=str)
def test_banded_forward_matches_jax(spec):
    """ops.swat_attention (plain banded version, global-row pass included)
    against the JAX Pallas path in interpret mode and the JAX xla path; the
    row LSE of the band pass against swat_attention_fwd(return_lse=True)."""
    rng = np.random.RandomState(0)
    b, hq, hkv, l, d = 1, 4, 2, 256, 32
    q, k, v = (rng.randn(b, h, l, d).astype(np.float32)
               for h in (hq, hkv, hkv))
    jq, jk, jv = (jnp.asarray(x) for x in (q, k, v))
    tq, tk, tv = _t(q), _t(k), _t(v)
    ts = _tspec(spec)
    got = TO.swat_attention(tq, tk, tv, ts, block_q=64, block_kv=64)
    for impl in ("pallas", "xla"):
        want = JO.swat_attention(jq, jk, jv, spec, block_q=64, block_kv=64,
                                 impl=impl, interpret=True)
        np.testing.assert_allclose(got.numpy(), _np(want), **F32,
                                   err_msg=impl)
    want_ref = JO.swat_attention(jq, jk, jv, spec, block_q=64, block_kv=64,
                                 impl="ref")
    got_ref = TO.swat_attention(tq, tk, tv, ts, block_q=64, block_kv=64,
                                impl="ref")
    np.testing.assert_allclose(got_ref.numpy(), _np(want_ref), **F32)
    pat = JO.get_pattern(spec, l, l, 64, 64)
    _, want_lse = j_fwd(jq, jk, jv, spec, pattern=pat, return_lse=True,
                        interpret=True)
    tpat = TO.get_pattern(ts, l, l, 64, 64)
    _, got_lse = TA.swat_attention_fwd(tq, tk, tv, ts, pattern=tpat,
                                       return_lse=True)
    np.testing.assert_allclose(got_lse.numpy(), _np(want_lse), **F32)


@pytest.mark.parametrize("q_offset,kv_offset,bound", [(64, 0, 192),
                                                      (128, 64, 160)])
def test_banded_offsets_match_jax_kernel(q_offset, kv_offset, bound):
    """The context-parallel coordinate hooks (q_offset / kv_offset /
    seq_kv_bound) of the plain banded version against the JAX fwd kernel."""
    rng = np.random.RandomState(1)
    spec = SPEC_CASES[3]
    q, k, v = (rng.randn(1, h, 128, 16).astype(np.float32)
               for h in (2, 1, 1))
    want, want_lse = j_fwd(*(jnp.asarray(x) for x in (q, k, v)), spec,
                           block_q=32, block_kv=32, return_lse=True,
                           interpret=True, q_offset=q_offset,
                           kv_offset=kv_offset, seq_kv_bound=bound)
    got, got_lse = TA.swat_attention_fwd(
        _t(q), _t(k), _t(v), _tspec(spec), block_q=32, block_kv=32,
        return_lse=True, q_offset=q_offset, kv_offset=kv_offset,
        seq_kv_bound=bound)
    np.testing.assert_allclose(got.numpy(), _np(want), **F32)
    np.testing.assert_allclose(got_lse.numpy(), _np(want_lse), **F32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_banded_bf16_matches_jax_xla(dtype):
    rng = np.random.RandomState(2)
    spec = SPEC_CASES[3]
    q, k, v = (rng.randn(2, h, 256, 64).astype(np.float32)
               for h in (4, 2, 2))
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    want = JO.swat_attention(*(jnp.asarray(x, jdt) for x in (q, k, v)), spec,
                             impl="xla")
    got = TO.swat_attention(*(_t(x, tdt) for x in (q, k, v)), _tspec(spec))
    assert got.dtype == tdt
    tol = F32 if dtype == "float32" else dict(atol=3e-2, rtol=1e-2)
    np.testing.assert_allclose(got.float().numpy(), _np(want), **tol)


# ------------------------------------------------------- ring property -----

@settings(deadline=None, max_examples=25, database=None)
@given(window=st.integers(1, 24), g=st.sampled_from([0, 1, 3, 4]),
       lookahead=st.integers(0, 5), t=st.integers(1, 4),
       seed=st.integers(0, 10_000))
def test_ring_insert_matches_fifo_simulation(window, g, lookahead, t, seed):
    """ring_insert_ref / ring_slot_positions == inserting tokens one by one
    into a FIFO with pinned globals, at random depths and ragged counts."""
    rng = np.random.RandomState(seed)
    cap = window + 1 + lookahead + g
    ring = cap - g
    t = min(t, ring)
    wcap = _round_capacity(cap)
    b = 3
    pos = rng.randint(0, 5 * cap, size=b)
    nn = rng.randint(1, t + 1, size=b)
    cache = np.zeros((b, 1, wcap, 1), np.float32)
    owner = np.full((b, wcap), -1)
    for i in range(b):
        for tok in range(pos[i] + nn[i]):
            slot = tok if tok < g else g + (tok - g) % ring
            owner[i, slot] = tok
            cache[i, 0, slot, 0] = tok if tok >= pos[i] else -1
    before = np.where(owner >= 0, -1.0, 0.0)[:, None, :, None]
    for i in range(b):   # the pre-insert cache: tokens < pos only
        for tok in range(pos[i]):
            slot = tok if tok < g else g + (tok - g) % ring
            before[i, 0, slot, 0] = -1
    new = np.broadcast_to(np.arange(t, dtype=np.float32)[None, None, :, None],
                          (b, 1, t, 1)) + pos[:, None, None, None]
    got = TR.ring_insert_ref(torch.from_numpy(before.astype(np.float32)),
                             torch.from_numpy(np.ascontiguousarray(new)),
                             torch.from_numpy(pos), torch.from_numpy(nn),
                             ring_cap=cap, num_global=g)
    np.testing.assert_array_equal(got.numpy(), cache)
    t_s, valid = TR.ring_slot_positions(torch.from_numpy(pos + nn), wcap,
                                        ring_cap=cap, num_global=g)
    np.testing.assert_array_equal(valid.numpy(), owner >= 0)
    np.testing.assert_array_equal(t_s.numpy()[owner >= 0], owner[owner >= 0])
