"""The tensor-core routes' host logic, on the CPU: which kernel each
(dtype, head dim) takes, the dK/dV chunk plan over the inverse block
pattern, the split reduction that the plan's combine performs, and the
tensor-core dQ kernel's rounding points.

The kernels themselves run only on the card (chip_smoke.py phases 2, 7
and 13). Here the split reduction is emulated with the plain backward:
dK and dV are linear in dO (delta is a row sum of dO * O), so zeroing dO
outside a chunk's q rows gives that chunk's partial exactly, and the
partials summed in plan order by `dkv_combine`'s plain version must give
the unsplit plain dK/dV. Tolerance: the JAX package's gradient tolerance,
fp32 atol 5e-5 / rtol 1e-3 (the sums run in another order). The dQ
kernel's arithmetic (bf16 products, S scaled in fp32 after the product,
dS entering the last product as bf16 hi + lo parts) is emulated and held
within chip_smoke.py's BWD_TOL (bf16 atol 1e-2 / rtol 1e-2) of the plain
backward's dQ. So is dK/dV's two-warpgroup layout at head dim 256 (P^T and
its softcap chain handed from one warpgroup to the other in fp32, P^T and
dS^T entering their products as bf16 hi + lo parts), also against the JAX
package's Pallas backward in interpret mode."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import patterns as JP
from repro.core.types import AttentionSpec as JSpec
from repro.kernels.swat_attention import swat_attention_fwd as j_fwd
from repro.kernels.swat_backward import swat_attention_bwd as j_bwd
from repro_torch.configs import get_config
from repro_torch.core import patterns
from repro_torch.core.types import AttentionSpec
from repro_torch.kernels import ops
from repro_torch.kernels import swat_attention as SA
from repro_torch.kernels import swat_backward as SB

torch.set_num_threads(1)

GRAD = dict(atol=5e-5, rtol=1e-3)

LLAMA = AttentionSpec(kind="swat", window=256, num_global=4, causal=True)
PLANS = {   # (spec, L): the patterns the tensor-core dK/dV kernel meets
    "llama train": (LLAMA, 2048),
    "whisper encoder band": (AttentionSpec(kind="swat", window=128,
                                           num_global=4, causal=False),
                             1500),
    "random blocks": (dataclasses.replace(LLAMA, num_random=2,
                                          random_seed=7), 2048),
    "longformer": (get_config("longformer-paper").attention, 2048),
}


@pytest.mark.parametrize("dtype,d,fwd,dkv", [
    (torch.bfloat16, 64, "tc", "tc"),
    (torch.bfloat16, 128, "tc", "tc"),
    (torch.bfloat16, 256, "tc", "tc"),
    (torch.bfloat16, 16, "simt", "simt"),
    (torch.bfloat16, 32, "simt", "simt"),
    (torch.float32, 16, "simt", "simt"),
    (torch.float32, 64, "simt", "simt"),
    (torch.float32, 128, "simt", "simt"),
    (torch.float32, 256, "simt", "simt"),
])
def test_route_table(dtype, d, fwd, dkv):
    assert SA.route(dtype, d) == fwd
    assert SB.dkv_route(dtype, d) == dkv


@pytest.mark.parametrize("dtype,d,dq", [
    (torch.bfloat16, 64, "tc"),
    (torch.bfloat16, 128, "tc"),
    (torch.bfloat16, 256, "tc"),    # 229 registers, no spill (ptxas)
    (torch.bfloat16, 16, "simt"),
    (torch.bfloat16, 32, "simt"),
    (torch.float32, 16, "simt"),
    (torch.float32, 64, "simt"),
    (torch.float32, 128, "simt"),
    (torch.float32, 256, "simt"),
])
def test_dq_route_table(dtype, d, dq):
    assert SB.dq_route(dtype, d) == dq


@pytest.mark.parametrize("dtype,d", [(torch.float16, 64),
                                     (torch.bfloat16, 48),
                                     (torch.float32, 512)])
def test_no_route_raises(dtype, d):
    with pytest.raises(ValueError, match="no kernel"):
        SA.route(dtype, d)
    with pytest.raises(ValueError, match="no kernel"):
        SB.dkv_route(dtype, d)
    with pytest.raises(ValueError, match="no kernel"):
        SB.dq_route(dtype, d)


@pytest.mark.parametrize("name", list(PLANS))
def test_chunk_plan_covers_the_inverse_once(name):
    spec, seq = PLANS[name]
    inv = ops.get_pattern(spec, seq, seq, 128, 128).inverse()
    plan = SB.dkv_plan(inv)
    live = inv.slot_kinds != patterns.PAD
    lengths = live.sum(axis=1)
    # every non-PAD slot of the inverse exactly once, chunks in order
    seen = {}
    for j, s0, s1, part in plan.chunks.tolist():
        assert 0 <= s0 <= s1 <= lengths[j]
        assert s1 - s0 <= plan.cap
        for s in range(s0, s1):
            assert live[j, s]
            seen[(j, s)] = seen.get((j, s), 0) + 1
    assert seen == {(j, s): 1 for j, s in zip(*np.nonzero(live))}
    assert [tuple(c[:2]) for c in plan.chunks.tolist()] == sorted(
        tuple(c[:2]) for c in plan.chunks.tolist())
    # every kv block has a chunk; a cut block's partials are consecutive
    # and listed once in `combine`, an uncut block writes directly
    assert sorted(set(plan.chunks[:, 0].tolist())) == list(
        range(len(lengths)))
    cut = {j: (p0, n) for j, p0, n in plan.combine.tolist()}
    for j in range(len(lengths)):
        parts = [c[3] for c in plan.chunks.tolist() if c[0] == j]
        if j in cut:
            p0, n = cut[j]
            assert parts == list(range(p0, p0 + n)) and n > 1
        else:
            assert parts == [-1]
    assert plan.n_parts == sum(n for _, n in cut.values())
    # the plan is a fixed function of the pattern
    again = SB.dkv_plan(inv)
    assert np.array_equal(again.chunks, plan.chunks)
    assert np.array_equal(again.combine, plan.combine)


def test_chunk_plan_balances_the_llama_shape():
    """Causal window 256 + 4 globals at L=2048, 128-row blocks: the inverse
    rows are [16, 3, ..., 3, 2, 1]; kv block 0 is cut into chunks of at
    most 3 q blocks and no other row is cut."""
    inv = ops.get_pattern(LLAMA, 2048, 2048, 128, 128).inverse()
    lengths = (inv.slot_kinds != patterns.PAD).sum(axis=1).tolist()
    assert lengths == [16] + [3] * 13 + [2, 1]
    plan = SB.dkv_plan(inv)
    assert plan.cap == 3
    assert plan.combine.tolist() == [[0, 0, 6]]
    assert plan.chunks[:6].tolist() == [[0, s, min(s + 3, 16), s // 3]
                                        for s in range(0, 16, 3)]
    assert max(c[2] - c[1] for c in plan.chunks.tolist()) == 3


def test_chunk_plan_without_globals_cuts_nothing():
    for spec in (AttentionSpec(kind="swat", window=256, causal=True),
                 AttentionSpec(kind="dense", causal=True),
                 AttentionSpec(kind="dense", causal=False)):
        plan = SB.dkv_plan(ops.get_pattern(spec, 1024, 1024, 128,
                                           128).inverse())
        assert plan.combine.shape == (0, 3)
        assert (plan.chunks[:, 3] == -1).all()


def _split_dkv(q, k, v, o, lse, do, spec, pat, scale):
    """dK/dV as the tensor-core route computes them: one plain backward per
    chunk with dO zeroed outside the chunk's q rows (its partial), the
    uncut kv blocks from the unsplit backward, and the cut ones summed by
    dkv_combine's plain version."""
    bq, bk = pat.block_q, pat.block_kv
    inv = pat.inverse()
    plan = SB.dkv_plan(inv)
    b, hkv, lkv, d = k.shape
    _, dk, dv = SB.swat_attention_bwd_plain(q, k, v, o, lse, do, spec, pat,
                                            scale)
    part_k = torch.zeros((plan.n_parts, b, hkv, bk, d))
    part_v = torch.zeros_like(part_k)
    for j, s0, s1, p in plan.chunks.tolist():
        if p < 0:
            continue
        keep = torch.zeros(q.shape[2], dtype=torch.bool)
        for s in range(s0, s1):
            i = int(inv.q_block_map[j, s])
            keep[i * bq:(i + 1) * bq] = True
        dchunk = torch.where(keep[None, None, :, None], do, 0.0)
        _, pk, pv = SB.swat_attention_bwd_plain(q, k, v, o, lse, dchunk,
                                                spec, pat, scale)
        rows = min(bk, lkv - j * bk)
        part_k[p, :, :, :rows] = pk[:, :, j * bk:j * bk + rows]
        part_v[p, :, :, :rows] = pv[:, :, j * bk:j * bk + rows]
    combine = torch.as_tensor(plan.combine)
    dk_s, dv_s = dk.clone(), dv.clone()
    for j, _, _ in plan.combine.tolist():      # forget the cut rows
        dk_s[:, :, j * bk:(j + 1) * bk] = float("nan")
        dv_s[:, :, j * bk:(j + 1) * bk] = float("nan")
    SB.dkv_combine(part_k, part_v, combine, dk_s, dv_s)
    return plan, (dk, dv), (dk_s, dv_s)


@pytest.mark.parametrize("spec,lq,lkv", [
    (AttentionSpec(kind="swat", window=16, num_global=4, causal=True),
     128, 128),
    (AttentionSpec(kind="swat", window=16, num_global=4, causal=False),
     118, 118),       # ragged: the last block is cut short
])
def test_split_reduction_matches_the_unsplit_plain(spec, lq, lkv):
    rng = np.random.RandomState(0)
    b, hq, hkv, d = 2, 4, 2, 16
    q, k, v, do = (torch.from_numpy(rng.randn(*s).astype(np.float32))
                   for s in ((b, hq, lq, d), (b, hkv, lkv, d),
                             (b, hkv, lkv, d), (b, hq, lq, d)))
    pat = ops.get_pattern(spec, lq, lkv, 16, 16)
    scale = d ** -0.5
    o, lse = SA.swat_attention_fwd(q, k, v, spec, pattern=pat, scale=scale,
                                   return_lse=True)
    plan, (dk, dv), (dk_s, dv_s) = _split_dkv(q, k, v, o, lse, do, spec,
                                              pat, scale)
    assert plan.combine.shape[0] >= 1 and plan.n_parts >= 3
    torch.testing.assert_close(dk_s, dk, **GRAD)
    torch.testing.assert_close(dv_s, dv, **GRAD)
    _, _, (dk_2, dv_2) = _split_dkv(q, k, v, o, lse, do, spec, pat, scale)
    assert torch.equal(dk_s, dk_2) and torch.equal(dv_s, dv_2)


def test_combine_wrapper_raises_off_the_cpu():
    meta = lambda *s, **kw: torch.empty(*s, device="meta", **kw)
    before = SB.COMBINE_LAUNCHES.n
    with pytest.raises(ValueError, match="no kernel"):
        SB.dkv_combine(meta(1, 1, 1, 16, 16), meta(1, 1, 1, 16, 16),
                       meta(1, 3, dtype=torch.int32),
                       meta(1, 1, 16, 16, dtype=torch.bfloat16),
                       meta(1, 1, 16, 16, dtype=torch.bfloat16))
    assert SB.COMBINE_LAUNCHES.n == before


# -------------------------------------------------- tensor-core dQ math ---

BWD_TOL = dict(atol=1e-2, rtol=1e-2)    # chip_smoke.py's bf16 BWD_TOL


def _element_mask(spec, pat, lq, lkv):
    """The band pass's (Lq, Lkv) visibility over the pattern's slots, as
    the kernels apply it (element_mask, swat_attention.py:39)."""
    flat, mask = SA.slot_mask(spec, pat, "cpu", bound=lkv)
    nq, bq = pat.num_q_blocks, pat.block_q
    mask = mask.expand(nq, bq, flat.shape[1])   # (nq, 1, S) where no band
    count = torch.zeros(nq * bq, pat.num_kv_blocks * pat.block_kv)
    rows = torch.arange(nq * bq).reshape(nq, bq, 1).expand(mask.shape)
    cols = flat[:, None, :].expand(mask.shape)
    # a PAD slot may repeat a kv block: sum the slots' votes, not assign
    count.index_put_((rows, cols), mask.float(), accumulate=True)
    return (count > 0)[:lq, :lkv]


def _emulate_dq_tc(q, k, v, o, lse, do, spec, pat, scale):
    """dQ with the tensor-core kernel's rounding points: S = Q K^T and
    dP = dO V^T as products of the bf16 inputs accumulated in fp32, S
    scaled in fp32 after the product, then the softcap chain, P =
    exp(S - lse) and dS = P (dP - delta) chain in fp32; dS enters
    dQ += dS K as two bf16 parts (the rounded value and the rest), the
    products accumulated in fp32, times scale, rounded to bf16 once."""
    b, hq, lq, d = q.shape
    hkv, lkv = k.shape[1], k.shape[2]
    mask = _element_mask(spec, pat, lq, lkv)
    kf = k.float().repeat_interleave(hq // hkv, dim=1)
    vf = v.float().repeat_interleave(hq // hkv, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), kf) * scale
    chain = torch.ones_like(s)
    if spec.softcap:
        t = torch.tanh(s / spec.softcap)
        s, chain = spec.softcap * t, 1.0 - t * t
    p = torch.where(mask, torch.exp(s - lse[..., None]), 0.0)
    dp = torch.einsum("bhqd,bhkd->bhqk", do.float(), vf)
    delta = (do.float() * o.float()).sum(-1, keepdim=True)
    ds = torch.where(mask, p * (dp - delta) * chain, 0.0)
    hi = ds.to(torch.bfloat16).float()
    lo = (ds - hi).to(torch.bfloat16).float()
    dq = (torch.einsum("bhqk,bhkd->bhqd", hi, kf)
          + torch.einsum("bhqk,bhkd->bhqd", lo, kf))
    return (dq * scale).to(torch.bfloat16)


@pytest.mark.parametrize("spec,lq,lkv", [
    (AttentionSpec(kind="swat", window=24, num_global=4, causal=True,
                   softcap=50.0), 96, 96),
    (AttentionSpec(kind="swat", window=16, num_global=4, causal=False),
     88, 88),                       # ragged bidirectional band
    (AttentionSpec(kind="dense", causal=False, softcap=30.0), 40, 150),
])
def test_dq_rounding_points_stay_within_the_backward_tolerance(spec, lq,
                                                               lkv):
    """bf16 inputs at a small GQA shape (4 q heads over 2 kv heads); the
    last case has Lq != Lkv (cross attention's shape)."""
    rng = np.random.RandomState(7)
    b, hq, hkv, d = 2, 4, 2, 32
    mk = lambda *s_: torch.from_numpy(
        rng.randn(*s_).astype(np.float32)).to(torch.bfloat16)
    q, k, v, do = (mk(b, hq, lq, d), mk(b, hkv, lkv, d), mk(b, hkv, lkv, d),
                   mk(b, hq, lq, d))
    pat = ops.get_pattern(spec, lq, lkv, 16, 16)
    scale = d ** -0.5
    o, lse = SA.swat_attention_fwd(q, k, v, spec, pattern=pat, scale=scale,
                                   return_lse=True)
    want, _, _ = SB.swat_attention_bwd_plain(q, k, v, o, lse, do, spec, pat,
                                             scale)
    got = _emulate_dq_tc(q, k, v, o, lse, do, spec, pat, scale)
    torch.testing.assert_close(got.float(), want.float(), **BWD_TOL)


# ------------------------------------- two-warpgroup dK/dV at D=256 ---

def _hi_lo(x):
    """x as the sum of two bf16 values: the rounded value and the rest."""
    hi = x.to(torch.bfloat16).float()
    return hi, (x - hi).to(torch.bfloat16).float()


def _emulate_dkv_tc_d256(q, k, v, o, lse, do, spec, pat, scale):
    """dK/dV as the two-warpgroup tensor-core kernel computes them: kv rows
    as M. Warpgroup 0: S^T = K Q^T (bf16 products, fp32 sums), scaled in
    fp32, the softcap chain, P^T = exp(S^T - lse), handed over in fp32
    with the chain factor. Warpgroup 1: dP^T = V dO^T, dS^T = P^T (dP^T -
    delta) chain. P^T enters dV += P^T dO and dS^T enters dK += dS^T Q as
    bf16 hi + lo parts, summed in fp32 over the GQA group; dK times scale;
    each rounded to bf16 once."""
    b, hq, lq, _ = q.shape
    hkv, lkv = k.shape[1], k.shape[2]
    group = hq // hkv
    mask = _element_mask(spec, pat, lq, lkv).T           # (Lkv, Lq)
    kf = k.float().repeat_interleave(group, dim=1)
    vf = v.float().repeat_interleave(group, dim=1)
    s_t = torch.einsum("bhkd,bhqd->bhkq", kf, q.float()) * scale
    chain = torch.ones_like(s_t)
    if spec.softcap:
        t = torch.tanh(s_t / spec.softcap)
        s_t, chain = spec.softcap * t, 1.0 - t * t
    p_t = torch.where(mask, torch.exp(s_t - lse[:, :, None, :]), 0.0)
    dp_t = torch.einsum("bhkd,bhqd->bhkq", vf, do.float())
    delta = (do.float() * o.float()).sum(-1)[:, :, None, :]
    ds_t = p_t * (dp_t - delta) * chain                  # 0 where p_t is
    dv = sum(torch.einsum("bhkq,bhqd->bhkd", x, do.float())
             for x in _hi_lo(p_t))
    dk = sum(torch.einsum("bhkq,bhqd->bhkd", x, q.float())
             for x in _hi_lo(ds_t)) * scale
    fold = lambda x: x.reshape(b, hkv, group, lkv, -1).sum(2)
    return fold(dk).to(torch.bfloat16), fold(dv).to(torch.bfloat16)


@pytest.mark.parametrize("spec", [
    dict(kind="swat", window=24, causal=True, softcap=50.0),
    dict(kind="swat", window=16, num_global=4, causal=True),
    dict(kind="dense", causal=True, softcap=50.0),
], ids=["local softcap", "globals", "global layer"])
def test_two_warpgroup_dkv_at_d256_stays_within_the_backward_tolerance(
        spec):
    """gemma2's layer kinds at head dim 256, cut to 4 q heads over 2 kv
    heads and 96 tokens, bf16 inputs: the emulation against the plain
    backward and against the JAX Pallas backward in interpret mode (fp32,
    on the same bf16 values), within BWD_TOL."""
    rng = np.random.RandomState(19)
    b, hq, hkv, l, d = 1, 4, 2, 96, 256
    mk = lambda *s_: torch.from_numpy(
        rng.randn(*s_).astype(np.float32)).to(torch.bfloat16)
    q, k, v, do = (mk(b, hq, l, d), mk(b, hkv, l, d), mk(b, hkv, l, d),
                   mk(b, hq, l, d))
    tspec = AttentionSpec(**spec)
    pat = ops.get_pattern(tspec, l, l, 32, 32)
    scale = d ** -0.5
    o, lse = SA.swat_attention_fwd(q, k, v, tspec, pattern=pat, scale=scale,
                                   return_lse=True)
    got = _emulate_dkv_tc_d256(q, k, v, o, lse, do, tspec, pat, scale)
    _, dk, dv = SB.swat_attention_bwd_plain(q, k, v, o, lse, do, tspec, pat,
                                            scale)
    for g, w in zip(got, (dk, dv)):
        torch.testing.assert_close(g.float(), w.float(), **BWD_TOL)
    jspec = JSpec(**spec)
    jpat = JP.build_block_pattern(jspec, l, l, 32, 32)
    jq, jk, jv, jdo = (jnp.asarray(x.float().numpy()) for x in (q, k, v, do))
    jo, jlse = j_fwd(jq, jk, jv, jspec, pattern=jpat, interpret=True,
                     return_lse=True)
    _, jdk, jdv = j_bwd(jq, jk, jv, jo, jlse, jdo, jspec, pattern=jpat,
                        interpret=True)
    for g, w in zip(got, (jdk, jdv)):
        torch.testing.assert_close(
            g.float(), torch.from_numpy(np.array(w, np.float32)),
            **BWD_TOL)
