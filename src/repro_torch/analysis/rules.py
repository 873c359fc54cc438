"""swatlint rule families over traced entry points (the port of the JAX
package's `analysis/rules.py`; the same rule names, severities and
`DEFAULT_MIN_CARRY_BYTES`, so the two reports compare rule by rule).

Each family is a pure function `TracedEntry -> [Finding]` over the op log
of one run of the engine's body (plus the matrix-level recompile audit):

  donation          the JAX rule asks that every carry be donated and
                    aliased; the port's counterpart is IN PLACE. ERROR: a
                    declared carry was rebound (a graph replay would read
                    the stale storage). WARN: a non-in-place op built a
                    tensor of at least min_bytes with the shape and dtype of
                    the carry it was then copied into (the per-call silent
                    copy, the JAX rule's generic catch).
  host_sync         ops that wait for the device (`.item()`, `bool()`,
                    `nonzero`, `equal`, `masked_select`, `unique*`, tensor-
                    repeats `repeat_interleave` without output_size, bool-
                    mask indexing), device-to-host copies, and host-to-
                    device copies the host waits on (non_blocking=False,
                    which synchronizes the stream, as does a tensor
                    constructor's copy; or a pageable source): ERROR inside
                    a decode_hot_path entry, WARN elsewhere. Inside a body
                    the engine captures every host-to-device copy is an
                    ERROR: the capture refuses a blocking one, and a graph
                    would replay a non-blocking one from the same host
                    address. A non-blocking copy from pinned memory between
                    captured bodies waits for nothing, and is counted in
                    the report's `uploads`.
  collectives       per-entry `CollectiveBudget` over the collectives the
                    body issued (the mesh's record, and any c10d op no
                    mesh issued): single-device entries and slot-parallel
                    decode hot-path entries collective-free, every other
                    mesh entry held to its family's blessed budget. On a
                    ProcessMesh an op log that disagrees with the record is
                    an ERROR.
  dtype_promotion   a bf16 -> fp32 `_to_copy` / `copy_` taints its output
                    storage (views included); a matmul reading a tainted
                    operand is a WARN. `mm(out_dtype=float32)` on bf16
                    operands is fp32 accumulation, not an upcast.
  telemetry         "metrics" entries: every device counter (`mx.*` carry)
                    int32, kept in its storage, and read by no host sync
                    inside the body.
  recompile         distinct compile keys per family, capped by the
                    baseline; a graph key that holds a host position
                    rather than a shape (the JAX weak-type leak's
                    counterpart) is a WARN.

Severity contract: "error" fails `analyze --check` outright; "warn" fails
only when its count grows past the committed baseline.
"""
from __future__ import annotations

import dataclasses
from collections import defaultdict
from typing import Any, Dict, List, Optional, Sequence, Tuple

from repro_torch.analysis.collectives import (CollectiveBudget,
                                              CollectiveStats, check_budget,
                                              collective_stats, disagreement,
                                              merged, record_stats)
from repro_torch.analysis.tracer import (CONSTRUCTOR_OPS, COPY_OPS,
                                         INDEX_OPS, MATMUL_OPS, REPEAT_OPS,
                                         SYNC_OPS, OpRecord, TracedEntry,
                                         code_line, code_site)

ERROR = "error"
WARN = "warn"

# a carry copy at or above this size is a WARN (the JAX threshold); smaller
# ones are still counted in the report's `carry_copies`
DEFAULT_MIN_CARRY_BYTES = 128 * 1024


@dataclasses.dataclass
class Finding:
    rule: str
    severity: str
    entry: str
    message: str
    details: Dict[str, Any] = dataclasses.field(default_factory=dict)

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


def transfer(op: OpRecord) -> Optional[str]:
    """"d2h" or "h2d" for a copy op between host and device memory, and
    "h2d" for a tensor built from host data on a device."""
    if op.name in CONSTRUCTOR_OPS:
        return "h2d" if any(t.device != "cpu" for t in op.outputs) else None
    if op.name not in COPY_OPS:
        return None
    written = {t.storage for t in op.writes}
    src = {t.device for t in op.inputs if t.storage not in written}
    dst = {t.device for t in op.outputs} | {t.device for t in op.writes}
    if "cpu" in dst and src - {"cpu"}:
        return "d2h"
    if "cpu" in src and dst - {"cpu"}:
        return "h2d"
    return None


def blocking_upload(op: OpRecord) -> bool:
    """A host-to-device copy the host waits on: every one but a
    non_blocking copy from pinned memory (a constructor's copy is never
    non_blocking)."""
    s = dict(op.scalars)
    return transfer(op) == "h2d" and not (s.get("non_blocking")
                                          and s.get("src_pinned"))


def waits_for_device(op: OpRecord) -> bool:
    """The op cannot return before the device has computed its input (or,
    for a blocking upload, has run all the work queued before it)."""
    if (op.name in SYNC_OPS or transfer(op) == "d2h"
            or blocking_upload(op)):
        return True
    if op.name in REPEAT_OPS:
        return dict(op.scalars).get("output_size") is None
    if op.name in INDEX_OPS:
        return any(t.dtype == "bool" for t in op.inputs[1:])
    return False


def _grouped(rule: str, severity: str, entry: str,
             hits: Sequence[OpRecord], message) -> List[Finding]:
    """One finding per (op name, call site), with its count and its lines
    (`at`, for the printout); message(op name, count) words it."""
    by: Dict[Tuple[str, Optional[str]], List[OpRecord]] = defaultdict(list)
    for op in hits:
        by[(op.name, op.site)].append(op)
    return [Finding(rule, severity, entry, message(name, len(ops)),
                    {"op": name, "site": site, "count": len(ops),
                     "at": sorted({op.line for op in ops if op.line})})
            for (name, site), ops in sorted(by.items(), key=str)]


# ---------------------------------------------------------------- donation --

def carry_copies(tr: TracedEntry) -> List[Dict[str, Any]]:
    """Every `copy_` into a carry of a tensor a non-in-place op built in
    the body with the written tensor's shape and dtype: {carry, site, line,
    op, bytes}. (An in-place accumulate such as `add_` is not a copy.)"""
    fresh = set()
    out = []
    for op in tr.ops:
        if not op.writes:
            ins = {t.storage for t in op.inputs}
            fresh.update(t.storage for t in op.outputs
                         if t.storage not in ins)
            continue
        if op.name != "aten::copy_":
            continue
        for w in op.writes:
            carry = tr.carry_storages.get(w.storage)
            if carry is None:
                continue
            for s in op.inputs:
                if (s.storage != w.storage and s.storage in fresh
                        and (s.shape, s.dtype) == (w.shape, w.dtype)):
                    out.append({"carry": carry, "site": op.site,
                                "line": op.line, "op": op.name,
                                "bytes": s.nbytes})
                    break
    return out


def check_donation(tr: TracedEntry, *,
                   min_bytes: int = DEFAULT_MIN_CARRY_BYTES
                   ) -> List[Finding]:
    name = tr.point.name
    out = [Finding("donation", ERROR, name,
                   f"carry `{c}` was rebound: after the body the engine "
                   "holds another tensor or storage, so a replayed graph "
                   "would read and write the stale one",
                   {"carry": c}) for c in tr.rebound]
    by: Dict[Optional[str], List[dict]] = defaultdict(list)
    for c in carry_copies(tr):
        if c["bytes"] >= min_bytes:
            by[c["site"]].append(c)
    for site, cs in sorted(by.items(), key=str):
        nbytes = sum(c["bytes"] for c in cs)
        out.append(Finding(
            "donation", WARN, name,
            f"{len(cs)} carry write(s) at {site} copy a full-size tensor a "
            f"non-in-place op built ({nbytes} B a call): the carry is "
            "updated by a copy, not in place",
            {"site": site, "count": len(cs), "bytes": nbytes,
             "carries": sorted({c["carry"] for c in cs}),
             "at": sorted({c["line"] for c in cs if c["line"]})}))
    return out


# --------------------------------------------------------------- host sync --

def uploads(tr: TracedEntry) -> List[OpRecord]:
    """The body's host-to-device copies."""
    return [op for op in tr.ops if transfer(op) == "h2d"]


def check_host_sync(tr: TracedEntry) -> List[Finding]:
    name = tr.point.name
    hot = "decode_hot_path" in tr.point.tags
    captured = tr.point.graph_key is not None
    sev = ERROR if hot else WARN
    out = _grouped(
        "host_sync", sev, name,
        [op for op in tr.ops if waits_for_device(op)
         and not (captured and transfer(op) == "h2d")],
        lambda op, n: f"`{op}` waits for the device ({n}x a call)"
        + (" on the decode hot path" if hot else ""))
    if captured:
        out += _grouped(
            "host_sync", ERROR, name, uploads(tr),
            lambda op, n: f"`{op}` copies host memory to the device inside "
            f"a captured body ({n}x a call): a capture refuses a blocking "
            "copy, and a graph replays a non-blocking one from the same "
            "host address")
    return out


# -------------------------------------------------------------- collectives --

def entry_stats(tr: TracedEntry) -> CollectiveStats:
    """The collectives one traced run issued: the mesh's record, and the
    op log's c10d ops unless a ProcessMesh issued them (they are then the
    record's own, checked by `check_collectives`)."""
    mesh = tr.point.mesh
    ops = collective_stats(tr.ops)
    if mesh is None:
        return ops
    rec = record_stats(tr.record or ())
    return rec if not mesh.one_graph else merged(rec, ops)


def budget_for(tr: TracedEntry,
               baseline_budgets: Optional[Dict[str, dict]] = None
               ) -> Optional[CollectiveBudget]:
    """The collective budget of one entry point, as in JAX.

    Single-device entries are collective-free, and so are slot-parallel
    decode hot-path entries: decoding is embarrassingly parallel over the
    slots, so a collective there is a sharding leak. Every other mesh entry
    (admission, prefill, a TP layer's reductions) takes its family's
    blessed budget from the baseline; with none (bless mode) this returns
    None and the report records the measured profile as the budget."""
    tags = tr.point.tags
    if "single" in tags or ("decode_hot_path" in tags and "tp" not in tags):
        return CollectiveBudget.collective_free()
    b = (baseline_budgets or {}).get(tr.point.family)
    if b is None:
        return None
    return CollectiveBudget(allow=tuple(sorted(b.get("allow", {}).items())),
                            max_wire_bytes=float(b.get("max_wire_bytes",
                                                       0.0)))


def check_collectives(tr: TracedEntry,
                      budget: Optional[CollectiveBudget]) -> List[Finding]:
    stats = entry_stats(tr)
    details = {"counts": stats.counts, "wire_bytes": stats.wire_bytes}
    out = []
    mesh = tr.point.mesh
    if mesh is not None and not mesh.one_graph:
        out += [Finding("collectives", ERROR, tr.point.name,
                        f"the process group ran other collectives than the "
                        f"mesh issued: {v}", details)
                for v in disagreement(tr.ops, tr.record or ())]
    if budget is not None:
        out += [Finding("collectives", ERROR, tr.point.name, v, details)
                for v in check_budget(stats, budget)]
    return out


# --------------------------------------------------------- dtype promotion --

def check_dtype_promotion(tr: TracedEntry) -> List[Finding]:
    """Flag matmuls that read a bf16 -> fp32 upcast (its storage, so views
    of it too): the contraction runs at fp32 width in a bf16 path."""
    tainted = set()
    hits = []
    for op in tr.ops:
        if op.name == "aten::_to_copy":
            if (op.inputs[0].dtype == "bfloat16"
                    and op.outputs[0].dtype == "float32"):
                tainted.add(op.outputs[0].storage)
        elif op.name == "aten::copy_":
            dst, src = op.inputs[0], op.inputs[1]
            if dst.dtype == "float32" and src.dtype == "bfloat16":
                tainted.add(dst.storage)
        elif op.name in MATMUL_OPS and any(t.storage in tainted
                                           for t in op.inputs):
            hits.append(op)
    return _grouped(
        "dtype_promotion", WARN, tr.point.name, hits,
        lambda op, n: f"`{op}` reads a bf16->fp32 upcast operand ({n}x a "
        "call): the contraction runs at fp32 width in a bf16 path")


# --------------------------------------------------------------- telemetry --

def check_telemetry(tr: TracedEntry) -> List[Finding]:
    """Entries tagged "metrics": the device counters (`mx.*` carries) are
    int32, keep their storage, and no host sync inside the body reads one.
    host_sync and collectives run over the same instrumented bodies, so
    together they show that telemetry adds no host sync, no collective and
    no copy to the hot path."""
    if "metrics" not in tr.point.tags:
        return []
    name = tr.point.name
    leaves = [l for l in tr.carry_leaves if l.name.startswith("mx.")]
    if not leaves:
        return [Finding("telemetry", ERROR, name,
                        "entry tagged `metrics` but it carries no device "
                        "counter (`mx.*`)", {})]
    out = []
    wrong = [l.name for l in leaves if l.dtype != "int32"]
    if wrong:
        out.append(Finding("telemetry", ERROR, name,
                           f"{len(wrong)} counters are not int32: a dtype "
                           "promotion reached the metrics carry",
                           {"counters": wrong}))
    rebound = [c for c in tr.rebound if c.startswith("mx.")]
    if rebound:
        out.append(Finding("telemetry", ERROR, name,
                           f"{len(rebound)} counters were rebound: a replay "
                           "would accumulate into the stale storage",
                           {"counters": rebound}))
    mx = {s for s, c in tr.carry_storages.items() if c.startswith("mx.")}
    reads = [op for op in tr.ops if waits_for_device(op)
             and any(t.storage in mx for t in op.inputs)]
    out += _grouped("telemetry", ERROR, name, reads,
                    lambda op, n: f"`{op}` reads a device counter on the "
                    f"host inside the body ({n}x a call)")
    return out


# --------------------------------------------------------- recompile audit --

def audit_recompiles(traced: Sequence[TracedEntry], *,
                     max_per_family: Optional[Dict[str, int]] = None
                     ) -> List[Finding]:
    """Distinct compile keys per family, capped by the baseline (ERROR past
    the cap), and a WARN for each entry whose graph key holds a host
    position: every new value captures another graph."""
    out: List[Finding] = []
    by_family: Dict[str, set] = defaultdict(set)
    for tr in traced:
        by_family[tr.point.family].add(tr.compile_key)
        if tr.point.host_key:
            out.append(Finding(
                "recompile", WARN, tr.point.name,
                f"graph key {tr.point.graph_key} holds the host position(s) "
                f"{list(tr.point.host_key)} rather than a shape: every new "
                "value captures another graph",
                {"key": list(tr.point.graph_key or ()),
                 "host_fields": list(tr.point.host_key),
                 "site": code_site(tr.point.graph_body or tr.point.body),
                 "at": [code_line(tr.point.graph_body or tr.point.body)]}))
    for family, keys in sorted(by_family.items()):
        cap = (max_per_family or {}).get(family)
        if cap is not None and len(keys) > cap:
            out.append(Finding(
                "recompile", ERROR, family,
                f"family `{family}` has {len(keys)} distinct keys (baseline "
                f"allows {cap}): a shape or dtype leak is forking the graph "
                "cache", {"lowerings": len(keys), "baseline": cap}))
    return out


def lowering_counts(traced: Sequence[TracedEntry]) -> Dict[str, int]:
    by_family: Dict[str, set] = defaultdict(set)
    for tr in traced:
        by_family[tr.point.family].add(tr.compile_key)
    return {f: len(k) for f, k in sorted(by_family.items())}
