"""The ring decode kernel's cluster split, on the CPU, in both its modes.

The kernel (csrc/swat_decode.cu) runs only on the card (chip_smoke.py
phases 2 and 12). Here its host-side split plans (`fused_splits`,
`plain_splits`) are checked, and its algorithm is emulated in plain
PyTorch: each (slot, head)'s cache cut into the plan's chunks, tiles that
skip slots no query row sees, an online-softmax state per key group of
each warp, merged inside the CTA (key groups, then warps) and then across
the cluster's CTAs in rank order. Fused, every row is read from the cache
as it was BEFORE the step except the slots the step writes, which read
their new row (the kernel's insert needs no ordering against any load),
and the insert is written by the chunk that holds the slot; plain, the
cache holds pos tokens, the queries are its newest T and nothing is
written. The emulation is held against the plain versions
(`swat_decode_fused_plain`, `swat_decode_plain_ref`) and against the JAX
package's Pallas kernel in interpret mode, fp32, atol 2e-5 / rtol 1e-4
(the JAX package's tolerance); caches bitwise."""
import numpy as np
import pytest
import jax.numpy as jnp
import torch

from repro.core.types import AttentionSpec as JSpec
from repro.kernels import ops as JO
from repro.kernels.swat_decode import swat_decode as j_swat_decode
from repro_torch.core.layers import _round_capacity
from repro_torch.core.types import AttentionSpec
from repro_torch.kernels import swat_decode as SD
from test_kernels import _fifo_ring_caches

torch.set_num_threads(1)

F32 = dict(atol=2e-5, rtol=1e-4)
NEG_INF = -1e30          # the kernel's empty-state max


# ------------------------------------------------------------ split plan ---

def _insert_slots(pos, nn, t, cap, g):
    ring = cap - g
    return [pj if pj < g else g + (pj - g) % ring
            for pj in range(pos, pos + min(nn, t))]


@pytest.mark.parametrize("n_heads,cap,sms", [
    (32, 261, 132), (32, 264, 132), (48, 133, 132), (16, 4097, 132),
    (16, 4097, 64), (256, 261, 132), (1, 5, 132), (3, 17, 132),
    (2, 20, 7), (7, 1000, 132)])
def test_split_plan_covers_the_ring_once(n_heads, cap, sms):
    chunk, nsplit = SD.fused_splits(n_heads, cap, sms)
    assert 1 <= nsplit <= SD.MAX_SPLITS
    chunks = [(c * chunk, min((c + 1) * chunk, cap)) for c in range(nsplit)]
    assert all(lo < hi for lo, hi in chunks), "an empty chunk"
    covered = [s for lo, hi in chunks for s in range(lo, hi)]
    assert covered == list(range(cap))
    # the grid fills the SMs at most about once (each ring at least one CTA)
    assert n_heads * nsplit <= max(sms, n_heads)
    # each insert slot of cold and wrapped rings, T = 1 and 4, lies in
    # exactly one chunk
    g = min(4, cap - 4) if cap > 8 else 0
    for t in (1, 4):
        if t > cap - g:
            continue
        for pos in (0, 3, cap - 1, cap, 4 * cap + 7):
            for s in _insert_slots(pos, t, t, cap, g):
                assert sum(lo <= s < hi for lo, hi in chunks) == 1


def test_split_plan_at_the_main_shapes():
    """llama serve (4 slots x 8 kv heads, 261-row ring), whisper (8 clips x
    6 heads, 133 rows) and gemma2's local layer (4 x 4, 4097 rows) on an
    H100's 132 SMs."""
    assert SD.fused_splits(32, 261, 132) == (66, 4)
    assert SD.fused_splits(48, 133, 132) == (67, 2)
    assert SD.fused_splits(16, 4097, 132) == (513, 8)


# ------------------------------------------------------------- emulation ---

def _slot_token(s, g, ring, total):
    """The token slot s holds (csrc/swat_decode.cu slot_token)."""
    if s < g:
        return s, s < total
    last = total - 1
    t = last - (last - s) % ring
    return t, t >= g


def _token_visible(t_s, held, pinned, qp, causal, window):
    vis = held
    if causal:
        vis = vis and t_s <= qp
    if window:
        vis = vis and (t_s >= qp - window or pinned)
    return vis


def _merge(states):
    """Softmax states (m, l, acc) of disjoint key sets merged in the given
    order: the common max, then the weighted sums."""
    mm = torch.stack([m for m, _, _ in states]).max(dim=0).values
    ll, aa = 0.0, 0.0
    for m, l, acc in states:
        f = torch.exp(m - mm)
        ll = ll + l * f
        aa = aa + acc * f[:, None]
    return mm, ll, aa


def emulate_cluster(q, kc, vc, pos, spec, cap, nsplit, chunk, *, new=None,
                    pack_gqa=True, kt=8, warps=2, kpw=2, uk=2):
    """The decode kernel's algorithm in fp32, in either mode. Fused (new =
    (new_k, new_v, num_new)): the step's tokens follow pos and are
    inserted; plain (new None): the cache holds pos tokens, the queries
    are its newest T, nothing is written. Per (slot, head) the cache is cut
    into the plan's chunks (cluster ranks); a chunk streams tiles of `kt`
    slots, skipping tiles no query row sees; inside a tile each of the
    warps x kpw key groups takes uk keys at once into its own online
    softmax state (key c of a tile: warp (c % KSTEP) // (kpw * uk), key
    group c % kpw); the key groups of a warp merge pairwise, then the warps,
    then the ranks in order. Returns (out, k', v')."""
    b, hq, t, d = q.shape
    hkv = kc.shape[1]
    group = hq // hkv
    heads, rows = (hkv, group * t) if pack_gqa else (hq, t)
    g = spec.num_global if spec.is_sparse else 0
    window = spec.window if spec.is_sparse else 0
    ring = cap - g
    kstep = warps * kpw * uk
    qf = q.float().reshape(b, heads, rows, d) * d ** -0.5
    out = torch.empty(b, heads, rows, d)
    k2, v2 = kc.clone(), vc.clone()
    for bi in range(b):
        if new is None:
            p, total, nins = int(pos[bi]) - t, int(pos[bi]), 0
        else:
            nk, nv, num_new = new
            p = int(pos[bi])
            total, nins = p + int(num_new[bi]), min(int(num_new[bi]), t)
        qp = [p + r % t for r in range(rows)]

        def new_row(s):   # the new row the step writes into slot s, or -1
            if s < g:
                j = s - p
            else:
                j = (s - p) % ring
                j = -1 if p + j < g else j
            return j if 0 <= j < nins else -1

        def seen(s):      # the tile skip's superset test
            ts, held = _slot_token(s, g, ring, total)
            return (_token_visible(ts, held, s < g, p + t - 1, spec.causal, 0)
                    and (not window or s < g or ts >= p - window))

        for h in range(heads):
            hk = h if pack_gqa else h // group
            ranks = []
            for c in range(nsplit):
                lo, hi = c * chunk, min((c + 1) * chunk, cap)
                lanes = {(w_, kg): (torch.full((rows,), NEG_INF),
                                    torch.zeros(rows), torch.zeros(rows, d))
                         for w_ in range(warps) for kg in range(kpw)}
                for base in range(lo, hi, kt):
                    slots = range(base, min(base + kt, hi))
                    if not any(seen(s) for s in slots):
                        continue
                    for (w_, kg), (m, l, acc) in lanes.items():
                        for c0 in range(w_ * kpw * uk, kt, kstep):
                            keys = [base + c0 + u * kpw + kg
                                    for u in range(uk)]
                            keys = [s for s in keys if s < hi]
                            if not keys:
                                continue
                            src = [(new_row(s), s) for s in keys]
                            kk = torch.stack([
                                nk[bi, hk, j] if j >= 0 else kc[bi, hk, s]
                                for j, s in src]).float()
                            vv = torch.stack([
                                nv[bi, hk, j] if j >= 0 else vc[bi, hk, s]
                                for j, s in src]).float()
                            sc = qf[bi, h] @ kk.T
                            if spec.softcap:
                                sc = spec.softcap * torch.tanh(
                                    sc / spec.softcap)
                            vis = torch.tensor([[_token_visible(
                                *_slot_token(s, g, ring, total), s < g,
                                qp[r], spec.causal, window) for s in keys]
                                for r in range(rows)])
                            sc = torch.where(vis, sc, float("-inf"))
                            mx = torch.maximum(m, sc.max(dim=1).values)
                            alpha = torch.exp(m - mx)
                            pm = torch.exp(sc - mx[:, None])
                            l = l * alpha + pm.sum(dim=1)
                            acc = acc * alpha[:, None] + pm @ vv
                            m = mx
                        lanes[(w_, kg)] = (m, l, acc)
                # in-CTA merge: each warp's key groups pairwise, then the
                # warps in order
                per_warp = []
                for w_ in range(warps):
                    st = [lanes[(w_, kg)] for kg in range(kpw)]
                    while len(st) > 1:
                        st = [_merge(st[i:i + 2]) for i in range(0, len(st),
                                                                 2)]
                    per_warp.append(st[0])
                ranks.append(_merge(per_warp))
                for j in range(nins):       # the insert, by the owner
                    pj = p + j
                    slot = pj if pj < g else g + (pj - g) % ring
                    if lo <= slot < hi:
                        k2[bi, hk, slot] = nk[bi, hk, j]
                        v2[bi, hk, slot] = nv[bi, hk, j]
            _, ll, aa = _merge(ranks)       # rank order
            out[bi, h] = aa / torch.clamp(ll, min=1e-30)[:, None]
    return out.reshape(b, hq, t, d).to(q.dtype), k2, v2


@pytest.mark.parametrize("group", [1, 4, 8])
@pytest.mark.parametrize("t,softcap", [(1, 0.0), (4, 30.0)])
def test_emulated_split_matches_plain_and_jax(group, t, softcap):
    """Slots cold (pos 0 and 3: most chunks see nothing), at the ring's
    edge, freshly wrapped and multiply wrapped, ragged num_new; the
    emulation at 1, 2, 3 and 5 chunks (the last at a chunk border for some
    insert slots) against the plain version and the JAX fused kernel."""
    rng = np.random.RandomState(100 + group * 10 + t)
    spec = dict(kind="swat", window=12, num_global=4, causal=True,
                softcap=softcap)
    hkv, d = 2, 16
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
    tq, tk, tv, tnk, tnv = (torch.from_numpy(x)
                            for x in (q, kc, vc, nk, nv))
    tpos, tnn = torch.from_numpy(pos), torch.from_numpy(nn)
    tspec = AttentionSpec(**spec)
    want, kw, vw = SD.swat_decode_fused_plain(tq, tk, tv, tnk, tnv, tpos,
                                              tnn, tspec, ring_cap=cap)
    o_pal, k_pal, v_pal = JO.decode_attention(
        jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc), None,
        JSpec(**spec), impl="pallas", interpret=True,
        new_kv=(jnp.asarray(nk), jnp.asarray(nv)), num_new=jnp.asarray(nn),
        pos=jnp.asarray(pos), ring_cap=cap)
    o_pal = torch.from_numpy(np.array(o_pal, np.float32))
    for split in (1, 2, 3, 5):
        chunk, nsplit = SD.fused_splits(b * hkv, cap, b * hkv * split)
        assert nsplit == split
        got, k2, v2 = emulate_cluster(tq, tk, tv, tpos, tspec, cap, nsplit,
                                      chunk, new=(tnk, tnv, tnn))
        assert torch.equal(k2, kw) and torch.equal(v2, vw)
        assert np.array_equal(k2.numpy(), np.asarray(k_pal, np.float32))
        assert np.array_equal(v2.numpy(), np.asarray(v_pal, np.float32))
        for i in range(b):
            real = int(nn[i])   # rows past num_new are garbage by contract
            torch.testing.assert_close(got[i, :, :real], want[i, :, :real],
                                       **F32)
            torch.testing.assert_close(got[i, :, :real], o_pal[i, :, :real],
                                       **F32)


@pytest.mark.parametrize("pack_gqa", [True, False])
@pytest.mark.parametrize("t", [1, 4])
@pytest.mark.parametrize("kind", ["dense", "ring"])
def test_emulated_plain_mode_matches_plain_and_jax(kind, t, pack_gqa):
    """Plain mode, 4 q heads over 2 kv heads (so the two GQA layouts
    differ): dense non-causal over a cache held up to pos (whisper's cross
    attention; slots past pos hold nothing), and a causal window 12 + 4
    globals + softcap 30 ring, cold, partial and wrapped. The emulation at
    1, 2, 3 and 5 chunks against swat_decode_plain_ref and the JAX
    swat_decode (fuse=False) in interpret mode, in the same layout."""
    rng = np.random.RandomState(200 + 10 * t + pack_gqa)
    hkv, group, d = 2, 2, 16
    if kind == "dense":
        spec = dict(kind="dense", causal=False)
        cap = alloc = 37
        lens = [37, 37, 20, t + 1]
        kc = rng.randn(len(lens), hkv, alloc, d).astype(np.float32)
        vc = rng.randn(len(lens), hkv, alloc, d).astype(np.float32)
        jkw = dict(num_global=0, window=0, causal=False)
    else:
        spec = dict(kind="swat", window=12, num_global=4, causal=True,
                    softcap=30.0)
        cap = 12 + 1 + (t - 1) + 4
        alloc = _round_capacity(cap)
        lens = [t, 9, cap, 4 * cap + 7]
        kc, vc = _fifo_ring_caches(rng, lens, hkv, cap, alloc, d,
                                   num_global=4)
        jkw = dict(num_global=4, window=12, causal=True, softcap=30.0)
    b = len(lens)
    q = rng.randn(b, group * hkv, t, d).astype(np.float32)
    pos = np.asarray(lens, np.int32)
    tq, tk, tv, tpos = (torch.from_numpy(x) for x in (q, kc, vc, pos))
    tspec = AttentionSpec(**spec)
    want = SD.swat_decode_plain_ref(tq, tk, tv, tpos, tspec, ring_cap=cap)
    o_pal = j_swat_decode(jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc),
                          jnp.asarray(pos), ring_cap=cap, pack_gqa=pack_gqa,
                          interpret=True, **jkw)
    o_pal = torch.from_numpy(np.array(o_pal, np.float32))
    heads = hkv if pack_gqa else group * hkv
    for split in (1, 2, 3, 5):
        chunk, nsplit = SD.plain_splits(b * heads, cap,
                                        -(-2 * b * heads * split // 3))
        assert nsplit == split
        got, k2, v2 = emulate_cluster(tq, tk, tv, tpos, tspec, cap, nsplit,
                                      chunk, pack_gqa=pack_gqa)
        assert torch.equal(k2, tk) and torch.equal(v2, tv)
        torch.testing.assert_close(got, want, **F32)
        torch.testing.assert_close(got, o_pal, **F32)


def test_tile_skip_never_hides_a_visible_slot():
    """The kernel skips a tile when no slot of it passes `seen`; every slot
    some query row sees must pass it (cold, partial and wrapped rings,
    T = 1 and 4, with and without a window)."""
    for t in (1, 4):
        for window in (0, 12):
            g, cap = 4, 12 + 1 + (t - 1) + 4
            ring = cap - g
            for p in (0, 1, 3, 5, cap - 1, cap, 3 * cap + 2):
                for nn in range(1, t + 1):
                    total = p + nn
                    for s in range(cap):
                        ts, held = _slot_token(s, g, ring, total)
                        vis = any(_token_visible(ts, held, s < g, p + r,
                                                 True, window)
                                  for r in range(t))
                        seen = (_token_visible(ts, held, s < g, p + t - 1,
                                               True, 0)
                                and (not window or s < g
                                     or ts >= p - window))
                        assert seen or not vis, (t, window, p, nn, s)
