"""Collective counts and budgets over a traced op log (the port of the
JAX package's `CollectiveStats`, `CollectiveBudget` and `check_budget`,
`distributed/hlo_analysis.py`).

The JAX package parses the collectives out of the partitioned HLO text.
The port has no HLO: `analysis.tracer` records every aten op a body
dispatches, and an op in the `c10d`, `_c10d_functional` or
`c10d_functional` namespace is one collective. Its bytes are its wire
bytes: the bytes of the tensors it returns (the result, as the JAX parser
charges), or of the tensors it was given when it returns none. Parsing
XLA's HLO and the roofline terms wait for ROADMAP item 13, with the mesh.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Tuple

COLLECTIVE_NAMESPACES = ("c10d", "_c10d_functional", "c10d_functional")


def is_collective(op_name: str) -> bool:
    """`op_name` ("namespace::name.overload") is a collective."""
    return op_name.split("::", 1)[0] in COLLECTIVE_NAMESPACES


def collective_kind(op_name: str) -> str:
    """The op's name without namespace and overload ("all_reduce")."""
    return op_name.split("::", 1)[-1].split(".", 1)[0]


@dataclasses.dataclass
class CollectiveStats:
    counts: Dict[str, int]
    bytes_by_kind: Dict[str, int]
    wire_bytes: float


def collective_stats(ops: Sequence) -> CollectiveStats:
    """Count each collective op of a traced op log (`tracer.OpRecord`s)
    once and charge its bytes once. A functional collective's
    `wait_tensor` completes the transfer it follows, and the namespace's
    private helpers (`_wrap_tensor_autograd`) move nothing: neither is
    counted."""
    counts: Dict[str, int] = {}
    by_kind: Dict[str, int] = {}
    for op in ops:
        if not is_collective(op.name):
            continue
        kind = collective_kind(op.name)
        if kind == "wait_tensor" or kind.startswith("_"):
            continue
        tensors = op.outputs or op.inputs
        counts[kind] = counts.get(kind, 0) + 1
        by_kind[kind] = by_kind.get(kind, 0) + sum(t.nbytes for t in tensors)
    return CollectiveStats(counts=counts, bytes_by_kind=by_kind,
                           wire_bytes=float(sum(by_kind.values())))


@dataclasses.dataclass(frozen=True)
class CollectiveBudget:
    """Per-entry collective budget.

    allow:           max op count per collective kind. An empty dict is the
                     COLLECTIVE-FREE budget: every single-device entry, and
                     every decode hot-path entry.
    max_wire_bytes:  ceiling on wire bytes (0 = counts only).
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
