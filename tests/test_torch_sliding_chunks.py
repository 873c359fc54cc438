"""The paper's baseline op and Eq. 1 in the port, against the JAX package.

`ops.swat_attention(impl="sliding_chunks")` and `ref.sliding_chunks_ref`
(the HuggingFace Longformer schedule the paper measures SWAT against)
against the JAX `sliding_chunks_ref` and `attention_ref`, causal and
bidirectional, GQA, softcap, fp32 and bf16; its gradient against
`impl="banded"`; `ref.fused_attention_ref` (paper Eq. 1) with both
`stabilize` values against the JAX one, overflow included. Tolerances are
tests/test_kernels.py's: fp32 atol 2e-5 / rtol 1e-4, bf16 atol 3e-2 /
rtol 1e-2, gradients atol 5e-5 / rtol 1e-3."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.types import AttentionSpec
from repro.kernels import ref as JR
from repro_torch.core.types import AttentionSpec as TSpec
from repro_torch.kernels import ops as TO
from repro_torch.kernels import ref as TR

torch.set_num_threads(1)

F32 = dict(atol=2e-5, rtol=1e-4)
BF16 = dict(atol=3e-2, rtol=1e-2)

CASES = {
    "causal": AttentionSpec(kind="swat", window=32, causal=True),
    "bidirectional": AttentionSpec(kind="swat", window=32, causal=False),
    "causal_softcap": AttentionSpec(kind="swat", window=32, causal=True,
                                    softcap=30.0),
    "bidirectional_softcap": AttentionSpec(kind="swat", window=16,
                                           causal=False, softcap=20.0),
    "kind_sliding_chunks": AttentionSpec(kind="sliding_chunks", window=32,
                                         causal=False),
}


def _qkv(seed, b, hq, hkv, l, d, dtype=jnp.float32, scale=1.0):
    """JAX arrays from a seeded numpy draw, and the same values as torch
    tensors (bf16 made by JAX, then carried over exactly through fp32)."""
    rng = np.random.RandomState(seed)
    js = [jnp.asarray(rng.randn(b, h, l, d) * scale, dtype)
          for h in (hq, hkv, hkv)]
    tdt = torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32
    ts = [torch.from_numpy(np.array(x.astype(jnp.float32))).to(tdt)
          for x in js]
    return js, ts


def _np(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x.astype(jnp.float32))


def _tspec(spec):
    return TSpec(**dataclasses.asdict(spec))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("group", [1, 2])
@pytest.mark.parametrize("case", list(CASES))
def test_sliding_chunks_equals_jax(case, group, dtype):
    """Both spellings of the port's op against the JAX baseline, and the
    fp32 output against the JAX band reference (same function, another
    schedule)."""
    spec = CASES[case]
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    (jq, jk, jv), (q, k, v) = _qkv(7, 2, 4, 4 // group, 256, 32, jdt)
    want = JR.sliding_chunks_ref(jq, jk, jv, spec)
    ref = TR.sliding_chunks_ref(q, k, v, _tspec(spec))
    op = TO.swat_attention(q, k, v, _tspec(spec), impl="sliding_chunks")
    tol = F32 if dtype == "float32" else BF16
    assert ref.dtype == op.dtype == q.dtype
    np.testing.assert_allclose(_np(ref), _np(want), **tol)
    np.testing.assert_allclose(_np(op), _np(want), **tol)
    if dtype == "float32":
        band = JR.attention_ref(jq, jk, jv, spec)
        np.testing.assert_allclose(_np(op), _np(band), **F32)


@pytest.mark.parametrize("causal", [True, False])
def test_end_chunks_mask_their_padded_neighbours(causal):
    """With two chunks, the first chunk's previous neighbour and the last
    chunk's next neighbour are zero padding: attending them with weight
    would pull every end row toward 0. The output equals the band
    reference on the first and the last chunk's rows."""
    spec = AttentionSpec(kind="swat", window=16, causal=causal)
    (jq, jk, jv), (q, k, v) = _qkv(3, 1, 2, 2, 64, 16, scale=3.0)
    got = TO.swat_attention(q, k, v, _tspec(spec), impl="sliding_chunks")
    want = JR.attention_ref(jq, jk, jv, spec)
    np.testing.assert_allclose(_np(got)[:, :, :32], _np(want)[:, :, :32],
                               **F32)
    np.testing.assert_allclose(_np(got)[:, :, 32:], _np(want)[:, :, 32:],
                               **F32)


@pytest.mark.parametrize("causal", [True, False])
def test_sliding_chunks_gradient_equals_banded(causal):
    """Differentiable like every impl: autograd through the chunked
    schedule gives the exact-band op's gradients."""
    spec = _tspec(AttentionSpec(kind="swat", window=32, causal=causal))
    _, (q, k, v) = _qkv(11, 1, 4, 2, 128, 32)
    g = torch.from_numpy(np.random.RandomState(12).randn(1, 4, 128, 32)
                         .astype(np.float32))
    grads = {}
    for impl in ("sliding_chunks", "banded"):
        xs = [t.clone().requires_grad_() for t in (q, k, v)]
        (TO.swat_attention(*xs, spec, impl=impl) * g).sum().backward()
        grads[impl] = [x.grad for x in xs]
    for a, b in zip(grads["sliding_chunks"], grads["banded"]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=5e-5,
                                   rtol=1e-3)


@pytest.mark.parametrize("length", [96, 100])
def test_sliding_chunks_needs_seq_divisible_by_2w(length):
    spec = _tspec(AttentionSpec(kind="swat", window=32, causal=True))
    q = torch.zeros(1, 1, length, 16)
    with pytest.raises(AssertionError, match="seq % 64"):
        TO.swat_attention(q, q, q, spec, impl="sliding_chunks")


def test_sliding_chunks_refuses_dense_specs():
    spec = _tspec(AttentionSpec(kind="dense", causal=True))
    q = torch.zeros(1, 1, 64, 16)
    with pytest.raises(AssertionError):
        TR.sliding_chunks_ref(q, q, q, spec)


@pytest.mark.parametrize("stabilize", [True, False])
@pytest.mark.parametrize("spec", [
    AttentionSpec(kind="swat", window=32, causal=True),
    AttentionSpec(kind="swat", window=16, num_global=8, causal=False),
    AttentionSpec(kind="swat", window=32, causal=True, softcap=30.0),
    AttentionSpec(kind="dense", causal=True)], ids=str)
def test_fused_attention_ref_equals_jax(spec, stabilize):
    """Paper Eq. 1 with the deferred denominator, GQA, the pattern mask
    and softcap: the port's equals the JAX one, and the three-step
    reference (the kernel-fusion claim)."""
    (jq, jk, jv), (q, k, v) = _qkv(5, 2, 4, 2, 128, 32)
    want = JR.fused_attention_ref(jq, jk, jv, spec, stabilize=stabilize)
    got = TR.fused_attention_ref(q, k, v, _tspec(spec), stabilize=stabilize)
    np.testing.assert_allclose(_np(got), _np(want), **F32)
    three = TR.attention_ref(q, k, v, _tspec(spec))
    np.testing.assert_allclose(_np(got), _np(three), atol=1e-4, rtol=1e-4)


def test_unstabilized_fusion_overflows_where_the_stable_one_does_not():
    """The JAX test's case (logits far beyond exp's range): the literal
    Eq. 1 overflows in both packages, the max-subtracted form stays
    finite and equal."""
    spec = AttentionSpec(kind="swat", window=16, causal=True)
    (jq, jk, jv), (q, k, v) = _qkv(0, 1, 1, 1, 64, 32)
    jq, q = jq * 40.0, q * 40.0
    raw = TR.fused_attention_ref(q, k, v, _tspec(spec), stabilize=False)
    stable = TR.fused_attention_ref(q, k, v, _tspec(spec), stabilize=True)
    jraw = JR.fused_attention_ref(jq, jk, jv, spec, stabilize=False)
    assert not torch.isfinite(raw).all()
    assert not bool(jnp.isfinite(jraw).all())
    np.testing.assert_array_equal(np.isfinite(_np(raw)),
                                  np.isfinite(_np(jraw)))
    assert torch.isfinite(stable).all()
    np.testing.assert_allclose(
        _np(stable), _np(JR.fused_attention_ref(jq, jk, jv, spec)), **F32)
