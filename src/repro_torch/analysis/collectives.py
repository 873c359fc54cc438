"""Collective counts and budgets (the port of the JAX package's
`CollectiveStats`, `CollectiveBudget` and `check_budget`,
`distributed/hlo_analysis.py`).

The JAX package parses the collectives out of the partitioned HLO text,
where XLA put them. The port has no HLO; its collectives are issued by the
mesh (`launch/mesh.py`), which records each one it issues over an axis of
more than one shard while the tracer runs a body: (kind, axis, bytes of
one shard's result, as JAX charges per device). A LocalMesh's collectives
are `cat`s and sums on one device, which no op log can tell from any
other, so the record is what counts (`record_stats`). On a ProcessMesh the
same collectives also reach the process group as c10d ops, and the op log
must agree with the record (`disagreement`).

An op log is read too: an op in the `c10d`, `_c10d_functional` or
`c10d_functional` namespace that no mesh issued (a body on one device, or
on a LocalMesh, that calls torch.distributed itself) is one collective
(`collective_stats`). Its bytes are the bytes of the tensors it returns
(the result, as the JAX parser charges), or, when it returns none, of the
first tensor it was given (its output buffer).

Wire bytes weight each kind's bytes by the JAX parser's factors (ring
wire bytes per participating device): an all-reduce moves 2x its result
(a reduce-scatter and an all-gather phase); an all-gather, a
reduce-scatter, an all-to-all and a shift (p2p, JAX's
collective-permute) move 1x.
"""
from __future__ import annotations

import dataclasses
from collections import Counter
from typing import Dict, List, Optional, Sequence, Tuple

COLLECTIVE_NAMESPACES = ("c10d", "_c10d_functional", "c10d_functional")
# the mesh's kind of each c10d op a ProcessMesh issues
C10D_KINDS = {
    "allreduce_": "all_reduce", "all_reduce": "all_reduce",
    "allgather_": "all_gather", "_allgather_base_": "all_gather",
    "all_gather_into_tensor": "all_gather",
    "_reduce_scatter_base_": "reduce_scatter",
    "reduce_scatter_": "reduce_scatter",
    "reduce_scatter_tensor": "reduce_scatter",
    "alltoall_base_": "all_to_all", "alltoall_": "all_to_all",
    "all_to_all_single": "all_to_all",
    "send": "p2p", "recv_": "p2p"}


def is_collective(op_name: str) -> bool:
    """`op_name` ("namespace::name.overload") is a collective."""
    return op_name.split("::", 1)[0] in COLLECTIVE_NAMESPACES


def collective_kind(op_name: str) -> str:
    """The op's name without namespace and overload ("all_reduce")."""
    return op_name.split("::", 1)[-1].split(".", 1)[0]


# wire bytes per result byte, by the mesh's kind (JAX's `parse_collectives`)
WIRE_FACTORS = {"all_reduce": 2.0, "all_gather": 1.0, "reduce_scatter": 1.0,
                "all_to_all": 1.0, "p2p": 1.0}


def wire_factor(kind: str) -> float:
    """Wire bytes per result byte of a collective of this kind (a mesh kind
    or a c10d op's name)."""
    return WIRE_FACTORS.get(C10D_KINDS.get(kind, kind), 1.0)


def _wire(by_kind: Dict[str, int]) -> float:
    return float(sum(wire_factor(k) * b for k, b in by_kind.items()))


@dataclasses.dataclass
class CollectiveStats:
    counts: Dict[str, int]
    bytes_by_kind: Dict[str, int]
    wire_bytes: float


def _moves(kind: str) -> bool:
    """A functional collective's `wait_tensor` completes the transfer it
    follows, and the namespace's private helpers (`_wrap_tensor_autograd`)
    move nothing (c10d's own ops with a leading underscore do)."""
    return kind != "wait_tensor" and not (kind.startswith("_")
                                          and kind not in C10D_KINDS)


def _stats(items) -> CollectiveStats:
    counts: Dict[str, int] = {}
    by_kind: Dict[str, int] = {}
    for kind, nbytes in items:
        counts[kind] = counts.get(kind, 0) + 1
        by_kind[kind] = by_kind.get(kind, 0) + nbytes
    return CollectiveStats(counts=counts, bytes_by_kind=by_kind,
                           wire_bytes=_wire(by_kind))


def _op_bytes(op) -> int:
    return (sum(t.nbytes for t in op.outputs) if op.outputs
            else op.inputs[0].nbytes if op.inputs else 0)


def collective_stats(ops: Sequence) -> CollectiveStats:
    """Count each collective op of a traced op log (`tracer.OpRecord`s)
    once, by its op name's kind, and charge its bytes once."""
    return _stats((collective_kind(op.name), _op_bytes(op)) for op in ops
                  if is_collective(op.name)
                  and _moves(collective_kind(op.name)))


def record_stats(record: Sequence[Tuple[str, str, int]]) -> CollectiveStats:
    """The collectives a mesh recorded (`launch.mesh`'s `recording()`)."""
    return _stats((kind, nbytes) for kind, _, nbytes in record)


def merged(*stats: CollectiveStats) -> CollectiveStats:
    counts: Counter = Counter()
    by_kind: Counter = Counter()
    for st in stats:
        counts.update(st.counts)
        by_kind.update(st.bytes_by_kind)
    return CollectiveStats(counts=dict(counts), bytes_by_kind=dict(by_kind),
                           wire_bytes=_wire(by_kind))


def issued(ops: Sequence) -> List[Tuple[str, int]]:
    """(the mesh's kind, bytes) of each c10d op of the op log that a
    process group of more than one rank ran (the tracer keeps each op's
    `group_size`); a one-rank group moves nothing and is left out, as the
    mesh's record leaves out a size-1 axis."""
    out = []
    for op in ops:
        kind = collective_kind(op.name)
        if not is_collective(op.name) or not _moves(kind):
            continue
        size: Optional[int] = dict(op.scalars).get("group_size")
        if size is None or size > 1:
            out.append((C10D_KINDS.get(kind, kind), _op_bytes(op)))
    return out


def disagreement(ops: Sequence,
                 record: Sequence[Tuple[str, str, int]]) -> List[str]:
    """Where a ProcessMesh's c10d ops (`issued`) and its record differ,
    by kind: count and bytes ([] = they agree)."""
    log, rec = _stats(issued(ops)), record_stats(record)
    out = []
    # a shift is one batched send and receive: two ops, or one at an edge
    for kind in sorted((set(log.counts) | set(rec.counts)) - {"p2p"}):
        a = (log.counts.get(kind, 0), log.bytes_by_kind.get(kind, 0))
        b = (rec.counts.get(kind, 0), rec.bytes_by_kind.get(kind, 0))
        if a != b:
            out.append(f"{kind}: the op log holds {a[0]} op(s) of {a[1]} B, "
                       f"the mesh recorded {b[0]} of {b[1]} B")
    return out


@dataclasses.dataclass(frozen=True)
class CollectiveBudget:
    """Per-entry collective budget.

    allow:           max op count per collective kind. An empty dict is the
                     COLLECTIVE-FREE budget: every single-device entry, and
                     every decode hot-path entry.
    max_wire_bytes:  ceiling on factor-weighted wire bytes (0 = counts
                     only).
    """
    allow: Tuple[Tuple[str, int], ...] = ()
    max_wire_bytes: float = 0.0

    @classmethod
    def collective_free(cls) -> "CollectiveBudget":
        return cls(allow=(), max_wire_bytes=0.0)

    @classmethod
    def from_counts(cls, counts: Dict[str, int], wire_bytes: float,
                    headroom: float = 1.5) -> "CollectiveBudget":
        """Bless a measured profile as the budget (with byte headroom)."""
        return cls(allow=tuple(sorted(counts.items())),
                   max_wire_bytes=float(wire_bytes) * headroom)

    def to_dict(self) -> dict:
        return {"allow": dict(self.allow),
                "max_wire_bytes": self.max_wire_bytes}


def check_budget(stats: CollectiveStats,
                 budget: CollectiveBudget) -> List[str]:
    """Budget violations for one entry's op log ([] = ok)."""
    out: List[str] = []
    allow = dict(budget.allow)
    for kind, n in sorted(stats.counts.items()):
        cap = allow.get(kind, 0)
        if n > cap:
            what = ("collective-free entry emits" if not allow
                    else f"budget allows {cap}, the body dispatches")
            out.append(f"{kind}: {what} {n} op(s)")
    if budget.max_wire_bytes and stats.wire_bytes > budget.max_wire_bytes:
        out.append(f"wire bytes {stats.wire_bytes:.0f} exceed budget "
                   f"{budget.max_wire_bytes:.0f}")
    return out
