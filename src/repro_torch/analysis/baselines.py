"""ANALYSIS_torch.json baseline: load/save/diff and the artifact gate (the
port of the JAX package's `analysis/baselines.py`, with the same `diff`,
`is_stale` and `check_artifact` semantics).

The committed baseline is the same contract as BENCH_*.json: a fresh run on
a clean tree must reproduce it within its own headroom. `--check` fails on

  * any error-severity finding in the fresh report,
  * per-rule warning counts growing past the baseline,
  * per-family lowering counts growing past the baseline (a shape or
    host position leaking into the graph keys),
  * engines present in the baseline but missing from the fresh run.

A mesh entry over its family's blessed collective budget is an error
finding (`rules.check_collectives` with the baseline's `budgets`).

New engines/families (and budget families) in the fresh run are reported
but do NOT fail — they fail the separate "baseline is stale" check so the
author is told to bless (`analyze --write`) in the same PR that adds the
entry point.

The file names call sites by file and function only: `save` leaves out
the findings' lines (`at`), so an edit elsewhere in a file does not change
what `--write` writes.
"""
from __future__ import annotations

import json
import os
from collections import Counter
from typing import Dict, List, Optional

# the port's own baseline; ANALYSIS.json at the root is the JAX package's
DEFAULT_PATH = os.path.join(
    os.path.dirname(__file__), "..", "..", "..", "ANALYSIS_torch.json")


def resolve_path(path: Optional[str] = None) -> str:
    return os.path.abspath(path or DEFAULT_PATH)


def load(path: Optional[str] = None) -> Optional[dict]:
    p = resolve_path(path)
    if not os.path.exists(p):
        return None
    with open(p) as f:
        return json.load(f)


def _without_lines(report: dict) -> dict:
    engines = {}
    for label, eng in (report.get("engines") or {}).items():
        findings = [{**f, "details": {k: v for k, v in
                                      (f.get("details") or {}).items()
                                      if k != "at"}}
                    for f in eng.get("findings", ())]
        engines[label] = {**eng, "findings": findings}
    return {**report, "engines": engines}


def save(report: dict, path: Optional[str] = None) -> str:
    p = resolve_path(path)
    with open(p, "w") as f:
        json.dump(_without_lines(report), f, indent=2, sort_keys=True)
        f.write("\n")
    return p


def _warn_counts(report: dict) -> Counter:
    out: Counter = Counter()
    for label, eng in (report.get("engines") or {}).items():
        for f in eng.get("findings", ()):
            if f.get("severity") == "warn":
                out[f"{label}/{f.get('rule')}"] += 1
    return out


def diff(fresh: dict, baseline: Optional[dict]) -> List[str]:
    """Violations of the committed baseline ([] = clean)."""
    out: List[str] = []
    for label, eng in (fresh.get("engines") or {}).items():
        for f in eng.get("findings", ()):
            if f.get("severity") == "error":
                out.append(f"[{label}] {f.get('rule')}: {f.get('entry')}: "
                           f"{f.get('message')}")
    if baseline is None:
        out.append("no committed ANALYSIS_torch.json baseline: run "
                   "`python -m repro_torch.launch.analyze --device cpu "
                   "--write` and commit it")
        return out

    base_engines = baseline.get("engines") or {}
    fresh_engines = fresh.get("engines") or {}
    for label in sorted(set(base_engines) - set(fresh_engines)):
        out.append(f"engine `{label}` in baseline but missing from this "
                   "run — matrix shrank")

    for label, beng in sorted(base_engines.items()):
        feng = fresh_engines.get(label)
        if feng is None:
            continue
        blow: Dict[str, int] = beng.get("lowerings") or {}
        flow: Dict[str, int] = feng.get("lowerings") or {}
        for family, n in sorted(flow.items()):
            cap = blow.get(family)
            if cap is not None and n > cap:
                out.append(f"[{label}] lowerings for `{family}` grew "
                           f"{cap} -> {n} — bless with --write if "
                           "intentional")

    fwarn, bwarn = _warn_counts(fresh), _warn_counts(baseline)
    for key, n in sorted(fwarn.items()):
        cap = bwarn.get(key, 0)
        if n > cap:
            out.append(f"warning count for `{key}` grew {cap} -> {n}")
    return out


def is_stale(fresh: dict, baseline: Optional[dict]) -> List[str]:
    """Things in the fresh run the baseline does not know about yet."""
    if baseline is None:
        return ["no baseline committed"]
    out: List[str] = []
    base_engines = baseline.get("engines") or {}
    for label, feng in sorted((fresh.get("engines") or {}).items()):
        beng = base_engines.get(label)
        if beng is None:
            out.append(f"engine `{label}` not in baseline")
            continue
        for family in sorted(set(feng.get("lowerings") or {})
                             - set(beng.get("lowerings") or {})):
            out.append(f"[{label}] new entry family `{family}` not in "
                       "baseline")
        for family in sorted(set(feng.get("budgets") or {})
                             - set(beng.get("budgets") or {})):
            out.append(f"[{label}] new budget family `{family}` not in "
                       "baseline")
    return out


def check_artifact(path: Optional[str] = None) -> dict:
    """Light gate for other tools: the committed ANALYSIS_torch.json must
    exist and carry zero error findings."""
    report = load(path)
    if report is None:
        raise AssertionError(
            "ANALYSIS_torch.json missing: run `python -m "
            "repro_torch.launch.analyze --device cpu --write` and commit "
            "the artifact")
    errors = (report.get("summary") or {}).get("errors")
    if errors != 0:
        raise AssertionError(
            f"committed ANALYSIS_torch.json records {errors} hot-path "
            "error(s): fix them (and re-run `analyze --write` after "
            "fixing) before benchmarking")
    return report
