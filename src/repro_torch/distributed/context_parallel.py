"""Context parallelism for window attention: halo exchange, not all-gather
(the port of the JAX package's `distributed/context_parallel.py`).

The band makes each row's working set local: row i needs only kv rows
[i-w, i+w]. A sequence-sharded shard therefore needs only a w-token halo
from its neighbour(s), O(w*D) wire bytes per shard instead of the O(L*D)
all-gather dense attention forces, independent of the sequence length.

Mechanics, over `axis` of a mesh (`launch/mesh.py`), n shards of local
length Lp; the body runs the mesh's local shards of the axis together (one
on a process mesh, all n on a single-process mesh):
  * left halo   : ceil(w/Lp) shifts bring the left neighbour's shard(s) in;
                  a shard with no left neighbour gets zeros, masked by the
                  kv bounds. One hop ships only the block-aligned w-row
                  edge; more hops ship whole shards.
  * right halo  : the same the other way (bidirectional specs only).
  * band pass   : `ops.swat_attention_lse` on [halo | local | halo], in
                  global token coordinates (q_offset = idx*Lp, kv_offset =
                  idx*Lp - halo, seq_kv_bound = L): the forward kernel (#2)
                  and the dQ and dK/dV kernels (#4, #5) on CUDA tensors,
                  masking k < 0 and k >= L, with the row LSE.
  * global cols : the first g kv rows (shard 0's) are psum-broadcast; every
                  row folds them in by merging (O, LSE) pairs. Columns
                  already inside the row's band are excluded.
  * global rows : q rows < g attend everything, so each shard computes its
                  local partial and a pmax/psum logsumexp merge combines
                  them: one (g, D)-sized collective, not a kv gather.

The global-column and global-row partials are small dense products in
plain PyTorch, as they are jnp in the JAX package. Random (BigBird) blocks
are refused: a random column set defeats the halo's locality.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import torch

from repro_torch.core.types import AttentionSpec
from repro_torch.kernels import dots
from repro_torch.kernels import ops as kops

NEG_INF = kops.NEG_INF


def halo_hops(window: int, local_len: int) -> int:
    """Shifts needed to cover a w-token halo with Lp-token shards."""
    return -(-window // local_len)


def halo_rows(window: int, local_len: int, block: int = 128) -> int:
    """Rows wired per side. When the window fits one shard only the
    (block-aligned) w-row edge travels, O(w) and independent of L; more
    hops (w > Lp) ship whole shards, fewer than w + Lp < 2w rows."""
    if window <= local_len:
        return min(local_len, -(-window // block) * block)
    return halo_hops(window, local_len) * local_len


def _shift_in(mesh, xs: List[torch.Tensor], axis: str, hops: int,
              direction: int, rows: int) -> List[torch.Tensor]:
    """The `rows`-deep halo of every local shard along the sequence (dim
    2), in sequence order. direction=+1: the left halo (shard i receives
    from i-1, ..., i-hops); -1: the right halo. Shards with no sender get
    zeros."""
    n = mesh.shape[axis]
    lp = xs[0].shape[2]
    if hops == 0 or n == 1:
        return [x[:, :, :0] for x in xs]
    if hops == 1 and rows < lp:
        # one hop: only the facing `rows`-deep edge of the shard travels
        edge = [(x[:, :, -rows:] if direction > 0 else x[:, :, :rows])
                .contiguous() for x in xs]
        return mesh.shift(edge, axis, direction)
    parts: List[List[torch.Tensor]] = [[] for _ in xs]
    cur = xs
    for _ in range(hops):
        cur = mesh.shift(cur, axis, direction)
        for p, c in zip(parts, cur):
            if direction > 0:
                p.insert(0, c)       # furthest shard first
            else:
                p.append(c)
    return [torch.cat(p, dim=2) for p in parts]


def _dense_partial(q, k, v, scale: float, softcap: float, mask):
    """Flash partial (acc, l, m) of a small dense pass: acc unnormalised
    fp32 (B, Hq, Lq, D), l and m fp32 (B, Hq, Lq); a row with no visible
    key has m = NEG_INF and l = 0. q: (B, Hq, Lq, D); k, v (B, Hkv, S, D);
    mask broadcastable to (B, Hq, Lq, S)."""
    b, hq, lq, d = q.shape
    hkv = k.shape[1]
    qb = q.reshape(b, hkv, hq // hkv, lq, d)
    s = dots.einsum_f32("bhgqd,bhkd->bhgqk",
                        qb * torch.tensor(scale, dtype=q.dtype), k)
    s = s.reshape(b, hq, lq, k.shape[2])
    if softcap:
        s = softcap * torch.tanh(s / softcap)
    s = torch.where(mask, s, NEG_INF)
    m = s.amax(dim=-1).detach()
    p = torch.where(mask, torch.exp(s - m[..., None]), 0.0)
    pb = p.reshape(b, hkv, hq // hkv, lq, -1)
    acc = dots.einsum_f32("bhgqk,bhkd->bhgqd", pb.to(v.dtype), v)
    return acc.reshape(b, hq, lq, d), p.sum(-1), m


def _merge(part: Tuple, dense: Tuple) -> torch.Tensor:
    """The band pass's (O, LSE) merged with a dense partial (acc, l, m):
    the softmax over both key sets, in fp32. An empty dense partial (LSE
    about NEG_INF) leaves O as it is."""
    out, lse = part
    acc, l, m = dense
    l = torch.clamp(l, min=1e-30)
    lse_d = m + torch.log(l)
    share = torch.sigmoid(lse - lse_d)[..., None]
    return torch.lerp(acc / l[..., None], out.float(), share)


def swat_attention_cp_local(qs, ks, vs, *, spec: AttentionSpec, mesh,
                            axis: str, seq_len: int, block_q: int = 128,
                            block_kv: int = 128,
                            scale: Optional[float] = None):
    """The per-shard body over the mesh's local shards of `axis`.

    qs, ks, vs: lists of LOCAL shards (B, H, Lp, D) of a (B, H, L, D)
    problem with the sequence sharded over `axis`, one per local shard in
    axis order, or one per local coordinate of the whole grid
    (`mesh.coords()` order: a train plan's lists, each line of the other
    axes its own problem). Returns the list of local output shards."""
    if not (spec.is_sparse and spec.window > 0):
        raise ValueError("context parallelism needs a window spec")
    if spec.num_random:
        raise ValueError("random blocks break the halo's locality: use data "
                         "or tensor parallelism for BigBird-style specs")
    b, hq, lp, d = qs[0].shape
    scale = float(d ** -0.5 if scale is None else scale)
    n = mesh.shape[axis]
    idxs = mesh.index(axis)
    if len(qs) != len(idxs):
        idxs = [c[axis] for c in mesh.coords()]
    if lp * n != seq_len:
        raise ValueError(f"shards of {lp} rows over {axis}={n} vs sequence "
                         f"{seq_len}")
    w, g = spec.window, spec.num_global
    dev = qs[0].device

    hops_l = halo_hops(w, lp)
    hops_r = 0 if spec.causal else hops_l
    halo = halo_rows(w, lp, block_kv)
    halo_r = 0 if spec.causal else halo
    kl = _shift_in(mesh, ks, axis, hops_l, +1, halo)
    vl = _shift_in(mesh, vs, axis, hops_l, +1, halo)
    kr = _shift_in(mesh, ks, axis, hops_r, -1, halo_r)
    vr = _shift_in(mesh, vs, axis, hops_r, -1, halo_r)

    band = dataclasses.replace(spec, num_global=0, num_random=0)
    pattern = kops.get_pattern(band, lp, halo + lp + halo_r, block_q,
                               block_kv, q_shift=halo)
    parts = []
    for j, idx in enumerate(idxs):
        k_ext = torch.cat([kl[j], ks[j], kr[j]], dim=2)
        v_ext = torch.cat([vl[j], vs[j], vr[j]], dim=2)
        parts.append(kops.swat_attention_lse(
            qs[j], k_ext, v_ext, band, pattern, scale, q_offset=idx * lp,
            kv_offset=idx * lp - halo, seq_kv_bound=seq_len))
    if not g:
        return [o for o, _ in parts]
    if g > lp:
        raise ValueError(f"num_global={g} must fit one shard (Lp={lp})")

    def bcast0(xs):
        """Shard 0's tensors on every shard: a psum, fp32 on the wire as in
        JAX (gloo reduces no bf16; the rows are few)."""
        return [x.to(xs[0].dtype) for x in mesh.psum(
            [x.float() if i == 0 else x.float() * 0
             for x, i in zip(xs, idxs)], axis)]

    # ---- global COLUMNS: shard 0's first g kv rows, for every row ----
    kg = bcast0([k[:, :, :g] for k in ks])
    vg = bcast0([v[:, :, :g] for v in vs])
    kcol = torch.arange(g, device=dev)[None, None, None, :]
    outs = []
    for j, idx in enumerate(idxs):
        qrow = (idx * lp + torch.arange(lp, device=dev))[None, None, :, None]
        colmask = kcol < qrow - w          # the band pass has [q-w, q(+w)]
        if spec.causal:
            colmask = colmask & (kcol <= qrow)
        outs.append(_merge(parts[j], _dense_partial(
            qs[j], kg[j], vg[j], scale, spec.softcap, colmask)))

    # ---- global ROWS: the first g q rows (shard 0's) attend ALL kv; every
    # shard contributes its local partial, merged with pmax/psum ----
    qg = bcast0([q[:, :, :g] for q in qs])
    gparts = []
    for j, idx in enumerate(idxs):
        krow = (idx * lp + torch.arange(lp, device=dev))[None, None, None, :]
        growmask = krow < seq_len
        if spec.causal:
            growmask = krow <= torch.arange(g, device=dev)[None, None, :,
                                                           None]
        gparts.append(_dense_partial(qg[j], ks[j], vs[j], scale,
                                     spec.softcap, growmask))
    m_star = mesh.pmax([m for _, _, m in gparts], axis)
    a = [torch.exp(m - ms) for (_, _, m), ms in zip(gparts, m_star)]
    acc = mesh.psum([p[0] * aj[..., None] for p, aj in zip(gparts, a)], axis)
    l = mesh.psum([p[1] * aj for p, aj in zip(gparts, a)], axis)
    result = []
    for j, idx in enumerate(idxs):
        g_out = acc[j] / torch.clamp(l[j], min=1e-30)[..., None]
        # rows with global q index < g (shard 0's only) take the global
        # rows' output
        is_global = ((idx * lp + torch.arange(lp, device=dev)) < g)[
            None, None, :, None]
        g_pad = torch.nn.functional.pad(g_out, (0, 0, 0, lp - g))
        result.append(torch.where(is_global, g_pad, outs[j]).to(
            qs[0].dtype))
    return result


def swat_attention_context_parallel(q, k, v, spec: AttentionSpec, *, mesh,
                                    axis: str = "model", block_q: int = 128,
                                    block_kv: int = 128,
                                    scale: Optional[float] = None):
    """Sequence-sharded window attention over `axis` of `mesh`.

    On a single-process mesh (`LocalMesh`) q, k, v are the global (B, H, L,
    D) tensors, as in the JAX function: the op shards L over the axis and
    returns the (B, H, L, D) output. On a process mesh they are this rank's
    (B, H, Lp, D) shards, and so is the output. Differentiable (the shift's
    gradient is the opposite shift)."""
    if mesh.one_graph:
        n = mesh.shape[axis]
        lq = q.shape[2]
        if lq % n:
            raise ValueError(f"seq {lq} must divide over {axis}={n}")
        outs = swat_attention_cp_local(
            mesh.shard(q, axis, 2), mesh.shard(k, axis, 2),
            mesh.shard(v, axis, 2), spec=spec, mesh=mesh, axis=axis,
            seq_len=lq, block_q=block_q, block_kv=block_kv, scale=scale)
        return torch.cat(outs, dim=2)
    n = mesh.shape[axis]
    return swat_attention_cp_local(
        [q], [k], [v], spec=spec, mesh=mesh, axis=axis,
        seq_len=q.shape[2] * n, block_q=block_q, block_kv=block_kv,
        scale=scale)[0]


def cp_wire_bytes_per_device(seq_len: int, n_shards: int, window: int,
                             num_heads: int, head_dim: int,
                             bytes_per_el: int = 2, batch: int = 1,
                             causal: bool = True) -> int:
    """Analytic halo traffic per shard and layer: K and V, halo_rows each
    way; O(w), independent of seq_len once the window fits one shard."""
    lp = seq_len // n_shards
    rows = halo_rows(window, lp)
    sides = 1 if causal else 2
    return 2 * sides * rows * num_heads * head_dim * bytes_per_el * batch
