"""Mixture-of-Experts FFN with top-k routing (the port of the JAX package's
`core/moe.py`).

Three dispatches, as in the JAX package:
  sort  - each routed slot is ranked within its expert (a stable sort),
          dropped beyond capacity, gathered into an (E, C, D) buffer, run
          through batched SwiGLU experts and combined back, weighted by
          its gate, in fp32. Rows move between token order and the buffer
          through two index maps that are inverses of each other
          (`slot_maps`: each slot's position, each position's slot, both
          pointing at a zero pad row where there is none): the buffer is
          a gather of the tokens, each slot's output a gather of the
          buffer, and the backward of each is a gather through the other
          map, the k slots of a token summed in fp32. The combine sums the
          k slots of a token too, so neither pass sorts rows, writes a
          duplicate index or adds atomically: a train step on the card is
          deterministic. The pieces (`group_ranks`, `slot_maps`,
          `dispatch_rows`, `run_slots`, `collect_rows`, `combine`) also
          make up a mesh's sort dispatch and the expert parallel body.
  dense - tokens stationary: every expert runs on every token and the
          outputs are combined by the sparse gate matrix. No capacity, no
          drops, and a row's output does not depend on its batch-mates,
          which continuous batching needs: the serving sites call it.
  ep    - expert parallelism (`core/moe_ep.py`): tokens travel to their
          experts' shards by all-to-all over the 'model' axis of the mesh
          that `set_expert_parallel` registered, when the experts divide
          it; otherwise (no mesh, no 'model' axis, an indivisible expert
          count) the JAX package falls through to the sort schedule, and
          so does the port. Inside a mesh train step the plan runs it on
          its own shards (`distributed/train_parallel.py`).

Top-k selection breaks ties towards the lower expert index, as
`jax.lax.top_k` does (`torch.topk` does not promise an order), so a zero
router or a zero hidden row routes to the JAX package's experts.

Nothing here syncs the host with the card: expert counts are a
`scatter_add_` (not `bincount`), capacity follows from static shapes, and
`return_aux=False` skips the aux loss altogether, so the serving call can
be captured in a CUDA graph.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core.layers import _dense_init
from repro_torch.core.types import MoESpec

Params = Dict[str, Any]
DISPATCHES = ("sort", "dense", "ep")
# the sort and ep dispatches' capacity factor, as in the JAX package
CAPACITY_FACTOR = 1.25

_EP_MESH = None   # set by the caller (as ops.set_context_parallel)


def set_expert_parallel(mesh) -> None:
    """Register the mesh (a LocalMesh or ProcessMesh) whose 'model' axis
    the "ep" dispatch runs over; None unregisters it."""
    global _EP_MESH
    _EP_MESH = mesh


def expert_parallel_mesh(num_experts: int):
    """The registered mesh when it has a 'model' axis that divides the
    experts (the "ep" dispatch then runs there), else None."""
    mesh = _EP_MESH
    if (mesh is not None and "model" in mesh.axis_names
            and num_experts % mesh.shape["model"] == 0):
        return mesh
    return None


def init_moe(gen: torch.Generator, d_model: int, d_ff: int, spec: MoESpec,
             dtype=torch.bfloat16, device="cuda") -> Params:
    """Router (D, E) in fp32; experts w1 / w3 (E, D, F) and w2 (E, F, D) in
    `dtype`, each drawn as the JAX package draws it (truncated normal over
    the leading axis' fan-in)."""
    e = spec.num_experts
    return {
        "router": _dense_init(gen, (d_model, e), torch.float32, device),
        "w1": _dense_init(gen, (e, d_model, d_ff), dtype, device),
        "w3": _dense_init(gen, (e, d_model, d_ff), dtype, device),
        "w2": _dense_init(gen, (e, d_ff, d_model), dtype, device),
    }


def _route(params: Params, xf: torch.Tensor, k: int):
    """Router softmax in fp32 and the top-k experts of each token, ties to
    the lower expert index (a stable descending sort), gates renormalised
    to sum to 1. Returns (probs (T, E), gates (T, k), ids (T, k))."""
    probs = torch.softmax(xf.float() @ params["router"], dim=-1)
    vals, ids = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, ids = vals[:, :k], ids[:, :k]
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    return probs, gates, ids


def _expert_counts(ids: torch.Tensor, e: int) -> torch.Tensor:
    """Routed slots per expert (E,) int64, without a host sync."""
    flat = ids.reshape(-1)
    return torch.zeros(e, dtype=torch.long, device=ids.device).scatter_add_(
        0, flat, torch.ones_like(flat))


def _aux_loss(probs, ids, e: int, k: int) -> torch.Tensor:
    """Switch load-balance loss E * sum_e f_e * P_e: f_e the share of routed
    slots on expert e, P_e its mean router probability (fp32)."""
    frac = _expert_counts(ids, e).float() / (probs.shape[0] * k)
    return e * torch.sum(frac * probs.mean(dim=0))


def _experts(w: Params, x: torch.Tensor) -> torch.Tensor:
    """SwiGLU of every expert: x (E, N, D) or (N, D) (broadcast over the
    experts) -> (E, N, D). Batched products over the expert axis, so no
    expert weight is copied."""
    h = F.silu(torch.matmul(x, w["w1"])) * torch.matmul(x, w["w3"])
    return torch.matmul(h, w["w2"])


def sort_capacity(t: int, k: int, e: int, capacity_factor: float) -> int:
    """The sort dispatch's slots per expert for t tokens."""
    return int(max(k, min(t, round(t * k * capacity_factor / e))))


def group_ranks(ids: torch.Tensor, cap: int, n: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per slot of `ids` (S,) (its bucket in [0, n): an expert, or an expert
    parallel shard), its rank among the slots of that bucket in slot order
    (a stable sort, the JAX package's argsort) and whether it fits the
    capacity (rank < cap)."""
    order = torch.sort(ids, stable=True).indices
    counts = torch.zeros(n, dtype=torch.long, device=ids.device).scatter_add_(
        0, ids, torch.ones_like(ids))
    starts = torch.cumsum(counts, 0) - counts
    rank = torch.empty_like(order)
    rank[order] = torch.arange(ids.shape[0], device=ids.device) - starts[
        ids[order]]
    return rank, rank < cap


def slot_maps(bucket, rank, keep, n: int, cap: int
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The two index maps between S routed slots and the P = n * cap
    positions of the capacity buffer, inverses of each other: `pos` (S,)
    each slot's position bucket * cap + rank, P (the pad) where not kept,
    and `slot` (P,) the slot at each position, S (the pad) where none is.
    Integer work only."""
    s, p = bucket.shape[0], n * cap
    idx = torch.arange(s, device=bucket.device)
    pos = torch.where(keep, bucket * cap + rank, p)
    # a slot not kept writes a spare position of its own past P (cut off),
    # so no index repeats
    slot = torch.full((p + s,), s, dtype=torch.long, device=bucket.device)
    slot[torch.where(keep, pos, p + idx)] = idx
    return pos, slot[:p]


def _pad(x: torch.Tensor, value=0) -> torch.Tensor:
    """x (N, ...) with a row N of `value` appended: the pad row that an
    index map points at."""
    return torch.cat([x, x.new_full((1, *x.shape[1:]), value)])


class _MoveRows(torch.autograd.Function):
    """out[i] = pad(x)[idx[i]], whose backward is the gather of the output
    gradient through the inverse map: dx[j] = sum over r < k of
    pad(dout)[inv[j * k + r]], the k rows summed in fp32 in order. Both
    directions are gathers: no pass sorts, writes a duplicate index or
    adds atomically, so the backward is deterministic."""

    @staticmethod
    def forward(ctx, x, idx, inv, k):
        ctx.save_for_backward(inv)
        ctx.k = k
        return _pad(x).index_select(0, idx)

    @staticmethod
    def backward(ctx, dout):
        inv, = ctx.saved_tensors
        dx = _pad(dout).index_select(0, inv)
        if ctx.k > 1:
            dx = dx.view(-1, ctx.k, dx.shape[1]).sum(
                1, dtype=torch.float32).to(dout.dtype)
        return dx, None, None, None


def dispatch_rows(x: torch.Tensor, pos, slot, k: int = 1) -> torch.Tensor:
    """The capacity buffer (P, D) of tokens x (T, D) whose slot s carries
    token s // k (T * k slots): position p holds token slot[p] // k, zeros
    where no slot is."""
    return _MoveRows.apply(x, slot // k, pos, k)


def collect_rows(y: torch.Tensor, pos, slot) -> torch.Tensor:
    """Each slot's row (S, D) of the buffer y (P, D): row pos[s], zeros for
    a slot not kept."""
    return _MoveRows.apply(y, pos, slot, 1)


def run_slots(w: Params, rows, expert, rank, keep, cap: int,
              k: int = 1) -> torch.Tensor:
    """The capacity dispatch's expert pass over w's experts (E_local on dim
    0): the kept slots in an (E_local, cap, D) buffer by (expert, rank),
    slot s carrying row s // k of `rows` (T, D), the batched SwiGLU
    experts, and each slot's output read back (T * k, D), zeros for a slot
    not kept."""
    el, d = w["w1"].shape[0], rows.shape[1]
    pos, slot = slot_maps(expert, rank, keep, el, cap)
    buf = dispatch_rows(rows, pos, slot, k).view(el, cap, d)
    return collect_rows(_experts(w, buf).reshape(el * cap, d), pos, slot)


def combine(ys: torch.Tensor, gates: torch.Tensor, keep) -> torch.Tensor:
    """Each token's k slot outputs ys (T*k, D) weighted by their gates
    (T, k), 0 where not kept, summed in fp32: (T, D) fp32."""
    t, k = gates.shape
    w = torch.where(keep, gates.reshape(-1), 0.0)
    return (ys.float() * w[:, None]).reshape(t, k, -1).sum(1)


def sort_partial(w: Params, xf, gates, ids, rank, keep, cap: int,
                 lo: int = 0) -> torch.Tensor:
    """The sort dispatch's share of experts [lo, lo + E_local) (w's) for
    tokens xf (T, D) routed to `ids` (T, k), given each slot's rank within
    its expert and whether it fits the capacity: (T, D) fp32. One expert
    slice (lo = 0, every expert) gives the whole; the shares of every
    slice summed (a psum over a mesh axis that splits the experts) do
    too."""
    k = ids.shape[1]
    flat = ids.reshape(-1)
    mine = keep & (flat >= lo) & (flat < lo + w["w1"].shape[0])
    return combine(run_slots(w, xf, flat - lo, rank, mine, cap, k),
                   gates, mine)


def moe_ffn(params: Params, x: torch.Tensor, spec: MoESpec, *,
            capacity_factor: float = CAPACITY_FACTOR,
            return_aux: bool = True, dispatch: Optional[str] = None
            ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """x (B, L, D) -> (out (B, L, D) in x's dtype, aux loss: an fp32
    scalar, or None when `return_aux` is False: the JAX package computes
    a value there and discards it; the port does not compute it).
    `dispatch` overrides spec.dispatch per call site; the serving sites
    pass "dense" (see the module docstring)."""
    b, l, d = x.shape
    e, k = spec.num_experts, spec.top_k
    t = b * l
    dispatch = spec.dispatch if dispatch is None else dispatch
    if dispatch not in DISPATCHES:
        raise ValueError(f"unknown MoE dispatch {dispatch!r} "
                         f"(one of {DISPATCHES})")
    if dispatch == "ep" and expert_parallel_mesh(e) is not None:
        from repro_torch.core import moe_ep
        return moe_ep.moe_ffn_ep(params, x, spec,
                                 mesh=expert_parallel_mesh(e), axis="model",
                                 capacity_factor=capacity_factor,
                                 return_aux=return_aux)
    xf = x.reshape(t, d)
    probs, gates, ids = _route(params, xf, k)
    aux = _aux_loss(probs, ids, e, k) if return_aux else None
    if dispatch == "dense":
        out = dense_partial(params, xf, gates, ids, e).to(x.dtype)
        return out.reshape(b, l, d), aux
    # "sort" (and "ep" without a mesh): capacity dispatch
    cap = sort_capacity(t, k, e, capacity_factor)
    rank, keep = group_ranks(ids.reshape(-1), cap, e)
    out = sort_partial(params, xf, gates, ids, rank, keep, cap)
    return out.to(x.dtype).reshape(b, l, d), aux


def dense_partial(params: Params, xf, gates, ids, e: int,
                  lo: int = 0) -> torch.Tensor:
    """The "dense" dispatch: every expert on every token, combined by the
    (T, E) gate matrix, built in fp32, cast to the expert outputs' dtype
    and combined in it; the caller casts the (T, D) result to xf's dtype
    (the JAX package's rounding points). `params` may hold only experts
    [lo, lo + E_local) of the e (the router whole): the result is then
    their share, and the shares of every slice summed (one psum over a
    mesh axis that splits the experts) give the whole."""
    t = xf.shape[0]
    full_gates = torch.zeros((t, e), dtype=torch.float32,
                             device=xf.device).scatter(1, ids, gates)
    y = _experts(params, xf)                                    # (E, T, D)
    if y.shape[0] != e:
        full_gates = full_gates[:, lo:lo + y.shape[0]]
    return torch.bmm(full_gates.to(y.dtype)[:, None, :],
                     y.transpose(0, 1))[:, 0]


def moe_ffn_dense_ref(params: Params, x: torch.Tensor,
                      spec: MoESpec) -> torch.Tensor:
    """Oracle for tests (no capacity drops): every expert for every token,
    combined by the renormalised top-k gates in fp32."""
    b, l, d = x.shape
    xf = x.reshape(-1, d)
    probs, gates, ids = _route(params, xf, spec.top_k)
    full_gates = torch.zeros_like(probs).scatter(1, ids, gates)
    y = _experts(params, xf).float()                            # (E, T, D)
    out = torch.einsum("te,etd->td", full_gates, y)
    return out.to(x.dtype).reshape(b, l, d)
