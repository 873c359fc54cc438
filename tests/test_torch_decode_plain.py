"""The port's plain-mode decode (kernel #3: attention of the cache's newest T
tokens over a pre-filled ring cache, nothing inserted) against the JAX
package, on the CPU.

On CPU tensors `swat_decode_plain` runs its plain version, so these hold
that plain version, and `ops.decode_attention`'s plain-mode routing, against
the JAX Pallas kernel in interpret mode (both GQA layouts) and against the
JAX ops at impl="ref". Tolerances are the JAX package's own: fp32 atol 2e-5
/ rtol 1e-4, bf16 atol 3e-2."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

try:
    from hypothesis import given, settings, strategies as st
except ImportError:
    from hypothesis_fallback import given, settings, strategies as st

from repro.core.types import AttentionSpec as JSpec
from repro.kernels import ops as JO
from repro.kernels.swat_decode import swat_decode as j_swat_decode
from repro_torch.core.types import AttentionSpec as TSpec
from repro_torch.kernels import ops as TO
from repro_torch.kernels import swat_decode as TD
from test_kernels import _fifo_ring_caches

torch.set_num_threads(1)

TOL = {"float32": dict(atol=2e-5, rtol=1e-4),
       "bfloat16": dict(atol=3e-2, rtol=1e-2)}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _no_kernel(*shape, dtype=torch.float32):
    """A tensor on a device with neither a kernel nor a plain version (a
    fake xpu tensor: its shape and device only)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode(allow_non_fake_inputs=True):
        return torch.empty(*shape, dtype=dtype, device="xpu")


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.array(a, np.float32)).to(dtype)


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


def _ring_case(seed, group, t, hkv=2, d=32, window=12, num_global=4,
               alloc=32):
    """Slots cold, partial, freshly wrapped and multiply wrapped; the T
    queries are each cache's newest tokens, so every slot holds >= T."""
    rng = np.random.RandomState(seed)
    cap = window + 1 + (t - 1) + num_global
    lens = [t, 9, cap, cap + 1, 5 * cap + 3]
    kc, vc = _fifo_ring_caches(rng, lens, hkv, cap, alloc, d,
                               num_global=num_global)
    q = rng.randn(len(lens), group * hkv, t, d).astype(np.float32)
    return q, kc, vc, np.asarray(lens, np.int32), cap


@pytest.mark.parametrize("pack_gqa", [True, False])
@pytest.mark.parametrize("t", [1, 4])
@pytest.mark.parametrize("group", [1, 4])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_decode_matches_pallas_interpret(pack_gqa, t, group, dtype):
    """Causal window 12 + 4 globals + softcap 30 over wrapped rings: the
    port's plain version (the wrapper's CPU dispatch) against the JAX
    plain-mode Pallas kernel in interpret mode, in the same GQA layout."""
    q, kc, vc, lens, cap = _ring_case(group * 10 + t, group, t)
    kw = dict(ring_cap=cap, num_global=4, window=12, causal=True,
              softcap=30.0)
    jdt, tdt = JDT[dtype], TDT[dtype]
    want = j_swat_decode(jnp.asarray(q, jdt), jnp.asarray(kc, jdt),
                         jnp.asarray(vc, jdt), jnp.asarray(lens),
                         pack_gqa=pack_gqa, interpret=True, **kw)
    spec = TSpec(kind="swat", window=12, num_global=4, causal=True,
                 softcap=30.0)
    got = TD.swat_decode_plain(_t(q, tdt), _t(kc, tdt), _t(vc, tdt),
                               torch.from_numpy(lens), spec, ring_cap=cap,
                               pack_gqa=pack_gqa)
    assert got.dtype == tdt and got.shape == q.shape
    np.testing.assert_allclose(got.float().numpy(), _np(want),
                               **TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("enc_len,alloc", [(40, 40), (37, 48)])
def test_dense_cross_decode_matches_jax(dtype, enc_len, alloc):
    """Whisper's cross attention: T=1 dense non-causal over the encoder's
    K/V (cache_len = the encoder length; an allocation wider than it
    masks the tail). The port's ops at its default impl (the JAX ref
    routing, valid-prefix mask) and at impl="kernel" (the plain-mode
    wrapper's plain version, positional masks) against the JAX ops at
    impl="ref" and the Pallas kernel in interpret mode."""
    rng = np.random.RandomState(enc_len)
    b, h, d = 3, 4, 16
    q = rng.randn(b, h, 1, d).astype(np.float32)
    kc = rng.randn(b, h, alloc, d).astype(np.float32)
    vc = rng.randn(b, h, alloc, d).astype(np.float32)
    jspec, tspec = (JSpec(kind="dense", causal=False),
                    TSpec(kind="dense", causal=False))
    jdt, tdt = JDT[dtype], TDT[dtype]
    jq, jk, jv = (jnp.asarray(x, jdt) for x in (q, kc, vc))
    cl = jnp.full((b, 1, 1, 1), enc_len, jnp.int32)
    want_ref = JO.decode_attention(jq, jk, jv, cl, jspec, impl="ref")
    want_pal = JO.decode_attention(jq, jk, jv, cl, jspec, impl="pallas",
                                   interpret=True)
    tq, tk, tv = _t(q, tdt), _t(kc, tdt), _t(vc, tdt)
    tcl = torch.full((b, 1, 1, 1), enc_len, dtype=torch.int32)
    for impl in (None, "kernel", "ref"):
        got = TO.decode_attention(tq, tk, tv, tcl, tspec, impl=impl)
        for want in (want_ref, want_pal):
            np.testing.assert_allclose(got.float().numpy(), _np(want),
                                       **TOL[dtype], err_msg=str(impl))


@pytest.mark.parametrize("impl", [None, "kernel"])
@pytest.mark.parametrize("t", [1, 3])
def test_decode_attention_plain_routing_matches_jax(impl, t):
    """ops.decode_attention without new_kv on a ring wider than the band
    (lookahead rows) with absolute `pos`, and a band-sized ring with a
    clamped cache_len: the port against the JAX ops at impl="ref" and
    "pallas" (interpret)."""
    rng = np.random.RandomState(7 + t)
    window, g = 6, 2
    cases = []
    cap = window + 1 + g + (t - 1) + 3
    lens = [t, 8, cap + 2, 4 * cap + 1]
    kc, vc = _fifo_ring_caches(rng, lens, 2, cap, 32, 16, num_global=g)
    cases.append((kc, vc, dict(pos=np.asarray(lens, np.int32)), cap))
    if t == 1:
        cap1 = window + 1 + g
        kc1, vc1 = _fifo_ring_caches(rng, [cap1, cap1, 5, cap1], 2, cap1,
                                     16, 16, num_global=g)
        cases.append((kc1, vc1, dict(cache_len=np.asarray(
            [cap1, cap1, 5, cap1], np.int32)), cap1))
    for kc, vc, kw, cap in cases:
        q = rng.randn(4, 4, t, 16).astype(np.float32)
        jkw = {k: jnp.asarray(v) for k, v in kw.items()}
        tkw = {k: torch.from_numpy(v) for k, v in kw.items()}
        jspec = JSpec(kind="swat", window=window, num_global=g, causal=True)
        tspec = TSpec(**dataclasses.asdict(jspec))
        cl = jkw.pop("cache_len", None)
        tcl = tkw.pop("cache_len", None)
        wants = [JO.decode_attention(
            jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc), cl, jspec,
            impl=ji, ring_cap=cap, **jkw,
            **({"interpret": True} if ji == "pallas" else {}))
            for ji in ("ref", "pallas")]
        got = TO.decode_attention(_t(q), _t(kc), _t(vc), tcl, tspec,
                                  impl=impl, ring_cap=cap, **tkw)
        for want in wants:
            np.testing.assert_allclose(got.numpy(), _np(want),
                                       **TOL["float32"])


def test_plain_decode_needs_a_length():
    spec = TSpec(kind="dense", causal=False)
    x = torch.zeros(1, 1, 1, 16)
    kc = torch.zeros(1, 1, 8, 16)
    with pytest.raises(ValueError, match="needs cache_len"):
        TO.decode_attention(x, kc, kc, None, spec)


@settings(deadline=None, max_examples=60)
@given(st.integers(1, 512), st.integers(1, 5000), st.integers(1, 264))
def test_plain_splits_cover_the_cache(n_heads, cap, sms):
    """The plain mode's cluster split: [0, cap) cut into contiguous chunks
    that cover it once, none empty, at most MAX_SPLITS (the portable
    cluster size), and no more CTAs than 1.5 an SM unless each cache has
    only one."""
    chunk, nsplit = TD.plain_splits(n_heads, cap, sms)
    assert 1 <= nsplit <= TD.MAX_SPLITS
    chunks = [(c * chunk, min((c + 1) * chunk, cap)) for c in range(nsplit)]
    assert all(lo < hi for lo, hi in chunks), "an empty chunk"
    assert [s for lo, hi in chunks for s in range(lo, hi)] == list(range(cap))
    assert n_heads * nsplit <= max(3 * sms // 2, n_heads)


def test_plain_split_at_the_main_shapes():
    """whisper's cross attention (8 clips x 6 heads, 1500 encoder rows) and
    gemma2's local layer (4 slots x 4 kv heads, 4097 rows) on an H100's
    132 SMs."""
    assert TD.plain_splits(48, 1500, 132) == (375, 4)
    assert TD.plain_splits(16, 4097, 132) == (513, 8)


def test_plain_wrapper_checks():
    """What the kernel does not take is refused before any launch."""
    spec = TSpec(kind="dense", causal=False)
    q = torch.zeros(2, 4, 1, 48)
    kc = torch.zeros(2, 2, 16, 48)
    pos = torch.full((2,), 16, dtype=torch.int32)
    with pytest.raises(ValueError, match="head dim"):
        TD._check_plain(q, kc, kc, pos, 16, 0, True)
    q, kc = torch.zeros(2, 4, 65, 16), torch.zeros(2, 2, 16, 16)
    with pytest.raises(ValueError, match="query rows"):
        TD._check_plain(q, kc, kc, pos, 16, 0, True)
    TD._check_plain(q, kc, kc, pos, 16, 0, False)    # 65 rows unpacked
    with pytest.raises(TypeError, match="int32"):
        TD._check_plain(q, kc, kc, pos.long(), 16, 0, False)
    with pytest.raises(ValueError, match="ring geometry"):
        TD._check_plain(q, kc, kc, pos, 17, 0, False)
    fake = (_no_kernel(1, 1, 1, 16), _no_kernel(1, 1, 16, 16),
            _no_kernel(1, 1, 16, 16), _no_kernel(1, dtype=torch.int32))
    with pytest.raises(ValueError, match="no kernel"):
        TD.swat_decode_plain(*fake, spec)
    # meta tensors (the dry-run's) run the plain version: shapes only
    meta = lambda *s, **kw: torch.empty(*s, device="meta", **kw)
    out = TD.swat_decode_plain(meta(1, 1, 1, 16), meta(1, 1, 16, 16),
                               meta(1, 1, 16, 16),
                               meta(1, dtype=torch.int32), spec)
    assert out.device.type == "meta" and out.shape == (1, 1, 1, 16)
    assert TD.PLAIN_LAUNCHES.n == 0
