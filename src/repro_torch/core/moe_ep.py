"""Expert parallelism with an explicit token exchange (the port of the JAX
package's `core/moe_ep.py`, whose body runs inside a shard_map manual over
the expert axis).

The body runs over lists of shards (`launch/mesh.py`): each shard

  1. routes its LOCAL tokens (router replicated, top-k),
  2. packs its routed slots into an (n, cap, D) send buffer by destination
     shard (the owner of the slot's expert),
  3. one all-to-all moves the tokens to their experts' shards,
  4. groups the received tokens by local expert (with 2x slack) and runs
     the batched SwiGLU experts,
  5. the reverse all-to-all returns the outputs, combined by gate in fp32.

Capacity: cap = ceil(t*k*cf / n) per (source, destination) pair, where t is
the body's token count; overflow drops. A received slot that carries no
token goes to a virtual bucket e_local, so it can never take a real
expert's capacity. The aux loss is the Switch loss of the body's tokens
with each FACTOR (the experts' routed share and mean probability) averaged
over the shards before their product, as the JAX package's pmeans do.

In the JAX package the body sees the whole batch (the shard_map is manual
over the expert axis only; the batch axes stay automatic), so t counts the
global batch's tokens of one sequence slice. A mesh whose batch axes split
the rows (`batch_axes`) keeps that: every slot is ranked within its bucket
in the global order of the rows, from the expert ids gathered over the
batch axes, and each shard fills and reads only its own slots of the
global buffers.

Wire bytes per device per layer = 2 x t_local * k * cf * D (there and
back): local tokens only, independent of the global batch.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.core import moe as M
from repro_torch.core.types import MoESpec

Params = Dict[str, Any]
Shards = List[torch.Tensor]


def _batch_offset(mesh, coord: Dict[str, int], batch_axes: Sequence[str]
                 ) -> int:
    """The coordinate's block index over the batch axes (the first one
    major): its rows' place in the global batch."""
    i = 0
    for a in batch_axes:
        i = i * mesh.shape[a] + coord[a]
    return i


def _gather_batch(mesh, xs: Shards, batch_axes: Sequence[str],
                 dim: int = 0) -> Shards:
    """All-gather over the batch axes, the minor one first: every
    coordinate receives the global rows in batch order."""
    for a in reversed(tuple(batch_axes)):
        xs = mesh.all_gather(xs, a, dim)
    return xs


def slot_ranks(mesh, ids: Shards, cap: int, n_dest: int,
               batch_axes: Sequence[str] = (), coords=None
               ) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """(rank, keep) of each shard's slots, ranked in the global order of
    the rows over `batch_axes` (each shard's slots in its block of the
    gathered ids); ranked among its own slots without batch axes."""
    if not batch_axes:
        return [M.group_ranks(x, cap, n_dest) for x in ids]
    full = _gather_batch(mesh, [x.contiguous() for x in ids], batch_axes)
    coords = mesh.coords() if coords is None else coords
    out = []
    for x, g, c in zip(ids, full, coords):
        rank, keep = M.group_ranks(g, cap, n_dest)
        lo = _batch_offset(mesh, c, batch_axes) * x.shape[0]
        out.append((rank[lo:lo + x.shape[0]], keep[lo:lo + x.shape[0]]))
    return out


def _psum_axes(mesh, xs: Shards, axes: Sequence[str]) -> Shards:
    for a in axes:
        xs = mesh.psum(xs, a)
    return xs


def ep_capacity(t: int, top_k: int, n: int, capacity_factor: float) -> int:
    """Slots per (source, destination) pair: ceil(t*k*cf / n), at least 1."""
    return int(max(1, -(-t * top_k * capacity_factor // n)))


def moe_ffn_ep_local(ps: List[Params], xs: Shards, spec: MoESpec, *,
                     mesh, axis: str,
                     capacity_factor: float = M.CAPACITY_FACTOR,
                     return_aux: bool = True,
                     batch_axes: Sequence[str] = (), coords=None
                     ) -> Tuple[Shards, Optional[Shards]]:
    """The per-shard body over lists of shards. xs: (B, L_local, D) each;
    ps[i]["w1"/"w3"/"w2"] hold shard i's LOCAL experts on dim 0 (E/n each)
    and ps[i]["router"] the whole (D, E) router. `batch_axes`: mesh axes
    that split the rows (the lists then cover the mesh's coordinates,
    `coords`, default `mesh.coords()`). Returns (outputs in x's dtype, aux
    losses: one fp32 scalar per shard, equal on every shard; None without
    `return_aux`)."""
    n = mesh.shape[axis]
    e, k = spec.num_experts, spec.top_k
    e_local = ps[0]["w1"].shape[0]
    if e_local * n != e:
        raise ValueError(f"{e_local} local experts x {n} shards != {e}")
    b, l, d = xs[0].shape
    t_local = b * l
    n_rows = 1
    for a in batch_axes:
        n_rows *= mesh.shape[a]
    t = t_local * n_rows                      # the body's tokens in JAX
    cap = ep_capacity(t, k, n, capacity_factor)

    # ---- 1. local routing; 2. ranks within each destination shard ----
    routed = [M._route(p, x.reshape(t_local, d), k) for p, x in zip(ps, xs)]
    flat_ids = [ids.reshape(-1) for _, _, ids in routed]      # (T*k,)
    dests = [f // e_local for f in flat_ids]
    ranks = slot_ranks(mesh, dests, cap, n, batch_axes, coords)

    sends, send_ids, maps = [], [], []
    for x, f, dst, (rank, keep) in zip(xs, flat_ids, dests, ranks):
        pos, slot = M.slot_maps(dst, rank, keep, n, cap)
        sends.append(M.dispatch_rows(x.reshape(t_local, d), pos, slot, k)
                     .view(n, cap, d))
        send_ids.append(M._pad(f % e_local, -1).index_select(0, slot)
                        .view(n, cap))
        maps.append((pos, slot))

    # ---- 3. exchange: tokens travel to their experts' shard ----
    recv = mesh.all_to_all(sends, axis, 0, 0)                 # (n, cap, D)
    recv_ids = mesh.all_to_all(send_ids, axis, 0, 0)          # (n, cap)

    # ---- 4. local experts: group the received slots by local expert ----
    rt = n * cap
    cap2 = int(max(1, -(-rt // max(e_local, 1))) * 2)   # 2x slack
    rids = [r.reshape(rt) for r in recv_ids]
    # the rows of every batch block share the buffers' positions: the
    # global view of a received slot is the one block that filled it
    seen = rids
    for a in batch_axes:
        seen = mesh.pmax(seen, a)
    buckets = [torch.where(s >= 0, s, e_local) for s in seen]
    ranks2 = slot_ranks(mesh, buckets, cap2, e_local + 1)
    ys = []
    for p, r, rid, bk, (rank2, keep2) in zip(ps, recv, rids, buckets,
                                             ranks2):
        mine = keep2 & (rid >= 0)
        y = M.run_slots(p, r.reshape(rt, d), bk, rank2, mine, cap2)
        ys.append(y.view(n, cap, d))           # zeros where not mine

    # ---- 5. return trip + gated fp32 combine ----
    backs = mesh.all_to_all(ys, axis, 0, 0)
    outs = [M.combine(M.collect_rows(back.reshape(rt, d), *mp), gates, keep)
            .to(x.dtype).reshape(b, l, d)
            for x, back, mp, (_, gates, _), (_, keep) in zip(
                xs, backs, maps, routed, ranks)]
    if not return_aux:
        return outs, None

    # frac and mean_p are means over the body's tokens (the batch axes'
    # rows summed in), each averaged over the shards before the product
    counts = _psum_axes(mesh, [M._expert_counts(f, e).float()
                               for f in flat_ids], batch_axes)
    counts = mesh.psum(counts, axis)
    sums = _psum_axes(mesh, [pr.sum(0) for pr, _, _ in routed], batch_axes)
    sums = mesh.psum(sums, axis)
    auxes = [e * torch.sum((c / (t * k) / n) * (s / t / n))
             for c, s in zip(counts, sums)]
    return outs, auxes


def moe_ffn_ep(params: Params, x: torch.Tensor, spec: MoESpec, *, mesh,
               axis: str = "model",
               capacity_factor: float = M.CAPACITY_FACTOR,
               return_aux: bool = True
               ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The JAX package's shard_map wrapper: x (B, L, D) whole, its sequence
    split over `axis`, the experts split on dim 0 over `axis`, the router
    replicated; the other axes do not split the body (the JAX package
    leaves them automatic). Returns (out (B, L, D), aux)."""
    n = mesh.shape[axis]
    if x.shape[1] % n:
        raise ValueError(f"expert parallelism over {axis}={n}: the sequence "
                         f"of {tuple(x.shape)} does not divide")
    if spec.num_experts % n:
        raise ValueError(f"{spec.num_experts} experts over {axis}={n}")
    xs = mesh.shard(x, axis, 1)
    experts = {w: mesh.shard(params[w], axis, 0) for w in ("w1", "w3", "w2")}
    ps = [{"router": params["router"], **{w: v[i] for w, v in
                                          experts.items()}}
          for i in range(len(xs))]
    outs, auxes = moe_ffn_ep_local(ps, xs, spec, mesh=mesh, axis=axis,
                                   capacity_factor=capacity_factor,
                                   return_aux=return_aux)
    out = mesh.all_gather(outs, axis, 1)[0]
    return out, (auxes[0] if return_aux else None)


def ep_wire_bytes_per_device(t_local: int, top_k: int, d_model: int,
                             capacity_factor: float = M.CAPACITY_FACTOR,
                             bytes_per_el: int = 2) -> int:
    """Analytic all-to-all traffic per layer: there and back, local tokens
    only, independent of the global batch."""
    return int(2 * t_local * top_k * capacity_factor * d_model * bytes_per_el)
