"""swatlint orchestration: trace an engine's matrix, run every rule and
assemble the report that becomes ANALYSIS_torch.json (the port of the JAX
package's `analysis/report.py`).

Report shape (one dict per analyzed engine, merged by the CLI):

  {"entries":   {name: {family, tags, compile_key, carry_bytes,
                        carries_in_place, ops, launches, collectives,
                        wire_bytes, uploads, upload_bytes, carry_copies
                        (every copy of a freshly built tensor into a carry,
                        by call site, whatever its size), captured,
                        shards, ...}},
   "lowerings": {family: distinct compile-key count},
   "budgets":   {family: blessed CollectiveBudget} (mesh engines: every
                 family whose entries may issue collectives; single-device
                 and slot-parallel decode entries are collective-free),
   "findings":  [Finding...],
   "summary":   {"errors": n, "warnings": n, "entries": n}}

A mesh engine's entry reports `carry_bytes` and `launches` per shard (the
totals over its local shards divided by `shards`), as the JAX report
counts per device; `collectives` and `wire_bytes` are one shard's, as the
mesh records them. Blessing (no baseline) records each family's budget:
the largest count of each kind over its entries, and its largest wire
bytes times 1.5 (`CollectiveBudget.from_counts`).

Call sites are "file:function", so an edit elsewhere in a file leaves the
report as it is; a finding's `at` holds its lines for the printout, and
`baselines.save` leaves them out of the file.

`launches` (the wrappers' launch-counter deltas, by counter name) stands
where the JAX entry has its HLO collectives: the port's kernels are called
through ctypes, and the counters are their only record. On the CPU every
wrapper runs its plain version, so `launches` is empty there.
"""
from __future__ import annotations

import collections
from typing import Any, Dict, List, Optional, Sequence

from repro_torch.analysis import rules as R
from repro_torch.analysis import tracer as T
from repro_torch.analysis.collectives import CollectiveBudget
from repro_torch.core import layers as L


def analyze_entry_points(points: Sequence[T.EntryPoint], *,
                         label: str = "",
                         capture: bool = True,
                         min_carry_bytes: int = R.DEFAULT_MIN_CARRY_BYTES,
                         baseline: Optional[dict] = None,
                         pad_events=None) -> Dict[str, Any]:
    """Trace and lint a set of entry points; returns the per-engine report.

    baseline: this engine's section of a committed ANALYSIS_torch.json;
    when present, the per-family lowering caps come from it (check mode).
    capture: on the card, capture and replay every graph key (a refused
    capture is an ERROR). pad_events: the kernels' fallback events, or a
    callable that drains them once every entry has run
    (`swat_decode.consume_pad_events`)."""
    base_lowerings = (baseline or {}).get("lowerings") or {}
    base_budgets = (baseline or {}).get("budgets") or {}

    traced: List[T.TracedEntry] = []
    findings: List[R.Finding] = []
    entries: Dict[str, Any] = {}
    blessed: Dict[str, dict] = {}

    for p in points:
        tr = T.trace(p, capture=capture)
        traced.append(tr)
        findings += R.check_donation(tr, min_bytes=min_carry_bytes)
        findings += R.check_host_sync(tr)
        findings += R.check_dtype_promotion(tr)
        findings += R.check_telemetry(tr)
        if tr.capture_error is not None:
            findings.append(R.Finding(
                "capture", R.ERROR, p.name,
                f"the card refused to capture {p.graph_key}: "
                f"{tr.capture_error}", {"key": list(p.graph_key)}))

        stats = R.entry_stats(tr)
        budget = R.budget_for(tr, base_budgets)
        findings += R.check_collectives(tr, budget)
        if budget is None and p.mesh is not None:
            _bless(blessed, p.family, stats)

        ups = R.uploads(tr)
        shards = 1 if p.mesh is None else len(p.mesh.coords())
        entries[p.name] = {
            "family": p.family,
            "tags": sorted(p.tags),
            "compile_key": tr.compile_key,
            "carry_bytes": _per_shard(tr.carry_bytes, shards),
            "carries_in_place": (not tr.rebound) if tr.carry_leaves
            else None,
            "ops": len(tr.ops),
            "launches": {k: _per_shard(n, shards)
                         for k, n in sorted(tr.launches.items())},
            "collectives": stats.counts,
            "wire_bytes": stats.wire_bytes,
            "uploads": len(ups),
            "upload_bytes": sum(t.nbytes for op in ups
                                for t in op.outputs),
            "carry_copies": dict(sorted(collections.Counter(
                c["site"] for c in R.carry_copies(tr)).items())),
            "host_reads_between_steps": p.host_reads,
            "captured": tr.captured,
        }
        if p.mesh is not None:
            entries[p.name]["shards"] = shards

    caps = {f: int(n) for f, n in base_lowerings.items()} or None
    findings += R.audit_recompiles(traced, max_per_family=caps)

    if callable(pad_events):
        pad_events = pad_events()
    # the port records only paged-gather events (#1 pads no cache)
    for ev in pad_events or ():
        findings.append(R.Finding(
            "paged_gather_fallback", R.WARN, label or "kernels",
            f"paged decode materializes a {ev.get('nb')}x"
            f"{ev.get('page')}-row gather-view outside the kernel "
            "(pool-sized copy per step; an in-kernel block gather would "
            "remove it)", {**ev, "site": T.code_site(L.paged_gather),
                           "at": [T.code_line(L.paged_gather)]}))

    errors = sum(1 for f in findings if f.severity == R.ERROR)
    warns = sum(1 for f in findings if f.severity == R.WARN)
    return {
        "entries": entries,
        "lowerings": R.lowering_counts(traced),
        "budgets": dict(sorted({**base_budgets, **blessed}.items())),
        "findings": [f.to_dict() for f in findings],
        "summary": {"errors": errors, "warnings": warns,
                    "entries": len(entries)},
    }


def _per_shard(n: int, shards: int):
    """n over the local shards: an int when they divide it."""
    return n // shards if n % shards == 0 else n / shards


def _bless(budgets: Dict[str, dict], family: str, stats) -> None:
    """Fold one entry's collectives into its family's budget: the largest
    count of each kind, and the largest wire bytes with headroom."""
    cand = CollectiveBudget.from_counts(stats.counts,
                                        stats.wire_bytes).to_dict()
    prev = budgets.get(family, {"allow": {}, "max_wire_bytes": 0.0})
    allow = dict(prev["allow"])
    for kind, n in cand["allow"].items():
        allow[kind] = max(allow.get(kind, 0), n)
    budgets[family] = {"allow": dict(sorted(allow.items())),
                       "max_wire_bytes": max(prev["max_wire_bytes"],
                                             cand["max_wire_bytes"])}


def analyze_engine(engine, *, label: str, baseline: Optional[dict] = None,
                   capture: bool = True, **entry_kw) -> Dict[str, Any]:
    """Full swatlint pass over one live ServingEngine. entry_kw goes to
    `tracer.engine_entry_points` (batch_sizes, scan_lens, prefill_len,
    chunk_len)."""
    from repro_torch.kernels import swat_decode

    swat_decode.consume_pad_events()          # drop stale events
    points = T.engine_entry_points(engine, **entry_kw)
    # running the paged decode bodies records the gather-view event
    return analyze_entry_points(
        points, label=label, capture=capture, baseline=baseline,
        pad_events=swat_decode.consume_pad_events)


def merge_reports(per_engine: Dict[str, dict], *, meta: dict) -> dict:
    """Combine per-engine reports into the ANALYSIS_torch.json document."""
    total_err = sum(r["summary"]["errors"] for r in per_engine.values())
    total_warn = sum(r["summary"]["warnings"] for r in per_engine.values())
    total_entries = sum(r["summary"]["entries"] for r in per_engine.values())
    return {
        "swatlint": 1,
        "meta": meta,
        "engines": per_engine,
        "summary": {"errors": total_err, "warnings": total_warn,
                    "entries": total_entries},
    }
