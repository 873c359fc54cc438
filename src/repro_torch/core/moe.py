"""Mixture-of-Experts FFN with top-k routing (the port of the JAX package's
`core/moe.py`).

Three dispatches, as in the JAX package:
  sort  - tokens are sorted by expert id (a stable sort), ranked within
          their expert, dropped beyond capacity, written into an (E, C, D)
          buffer, run through batched SwiGLU experts and combined back,
          weighted by their gate, in fp32. The combine gathers each routed
          slot's expert output through the inverse of the sort and sums the
          k slots of a token, so no atomic add decides the sum's order: a
          train step on the card is deterministic.
  dense - tokens stationary: every expert runs on every token and the
          outputs are combined by the sparse gate matrix. No capacity, no
          drops, and a row's output does not depend on its batch-mates,
          which continuous batching needs: the serving sites call it.
  ep    - expert parallelism needs a mesh (ROADMAP item 13); without one the
          JAX package falls through to the sort schedule, and so does the
          port.

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


def moe_ffn(params: Params, x: torch.Tensor, spec: MoESpec, *,
            capacity_factor: float = 1.25, return_aux: bool = True,
            dispatch: Optional[str] = None
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
    xf = x.reshape(t, d)
    probs, gates, ids = _route(params, xf, k)
    aux = _aux_loss(probs, ids, e, k) if return_aux else None
    if dispatch == "dense":
        out = dense_partial(params, xf, gates, ids, e).to(x.dtype)
        return out.reshape(b, l, d), aux

    # "sort" (and "ep" without a mesh): capacity dispatch
    cap = int(max(k, min(t, round(t * k * capacity_factor / e))))
    flat_e = ids.reshape(-1)                                    # (T*k,)
    order = torch.sort(flat_e, stable=True).indices
    sorted_e = flat_e[order]
    counts = _expert_counts(ids, e)
    starts = torch.cumsum(counts, 0) - counts
    rank = torch.arange(t * k, device=x.device) - starts[sorted_e]
    keep = rank < cap
    row = sorted_e * cap + torch.where(keep, rank, 0)           # JAX's rank_c
    # each kept (expert, rank) slot is written by exactly one routed token;
    # dropped tokens all land on one spare row, which is cut off
    slot = torch.where(keep, row, e * cap)
    buf = torch.zeros((e * cap + 1, d), dtype=x.dtype, device=x.device)
    buf = buf.index_put((slot,), xf[order // k])
    y_buf = _experts(params, buf[:-1].reshape(e, cap, d))       # (E, C, D)

    # combine: back to token-major order through the inverse permutation,
    # then the fp32 sum over each token's k slots (a dropped slot reads its
    # expert's row 0 at weight 0, as in the JAX package)
    inv = torch.empty_like(order)
    inv[order] = torch.arange(t * k, device=x.device)
    w = torch.where(keep[inv], gates.reshape(-1), 0.0)
    picked = y_buf.reshape(e * cap, d)[row[inv]].float()
    out = (picked * w[:, None]).reshape(t, k, d).sum(1)
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
