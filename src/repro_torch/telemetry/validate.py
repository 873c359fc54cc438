"""Schema validation for exported telemetry artifacts (a copy of the JAX
package's `telemetry/validate.py`). No jsonschema dependency: the schemas
are small enough to check by hand, and the point is actionable error
strings, not spec coverage.

  validate_chrome_trace(doc)   Chrome trace event format: traceEvents
                               list, every event carries name/ph/pid/tid,
                               duration events carry numeric ts/dur >= 0.
  validate_prometheus(text)    text exposition format 0.0.4: every
                               sample line is `name[{labels}] value`,
                               every # TYPE names a known metric type,
                               and at least one sample exists.

Both return a list of problem strings; empty means valid (`scope
validate` exits on that).
"""
from __future__ import annotations

import re
from typing import Any, List

_PH = set("BEXiIMPNODSTFsfbenC(")
_TYPES = {"counter", "gauge", "summary", "histogram", "untyped"}
_SAMPLE_RE = re.compile(
    r"^([a-zA-Z_:][a-zA-Z0-9_:]*)"          # metric name
    r"(\{[^}]*\})?"                          # optional labels
    r"\s+(-?[0-9.eE+-]+|NaN|[+-]Inf)"        # value
    r"(\s+-?\d+)?$")                         # optional timestamp


def validate_chrome_trace(doc: Any) -> List[str]:
    problems: List[str] = []
    if not isinstance(doc, dict):
        return [f"top level must be an object, got {type(doc).__name__}"]
    tev = doc.get("traceEvents")
    if not isinstance(tev, list):
        return ["missing/invalid traceEvents (must be a list)"]
    if not tev:
        problems.append("traceEvents is empty")
    for i, ev in enumerate(tev):
        where = f"traceEvents[{i}]"
        if not isinstance(ev, dict):
            problems.append(f"{where}: not an object")
            continue
        for k in ("name", "ph", "pid", "tid"):
            if k not in ev:
                problems.append(f"{where}: missing `{k}`")
        ph = ev.get("ph")
        if ph is not None and ph not in _PH:
            problems.append(f"{where}: unknown phase {ph!r}")
        if ph == "X":
            for k in ("ts", "dur"):
                v = ev.get(k)
                if not isinstance(v, (int, float)) or v < 0:
                    problems.append(
                        f"{where}: duration event needs numeric {k} >= 0, "
                        f"got {v!r}")
        elif ph in ("B", "E", "i", "I"):
            if not isinstance(ev.get("ts"), (int, float)):
                problems.append(f"{where}: needs numeric ts")
    return problems


def validate_prometheus(text: str) -> List[str]:
    problems: List[str] = []
    typed: dict = {}
    samples = 0
    for ln, line in enumerate(text.splitlines(), 1):
        if not line.strip():
            continue
        if line.startswith("# TYPE "):
            parts = line.split()
            if len(parts) != 4 or parts[3] not in _TYPES:
                problems.append(f"line {ln}: malformed TYPE comment")
            else:
                typed[parts[2]] = parts[3]
            continue
        if line.startswith("#"):
            if not line.startswith(("# HELP ", "# TYPE ", "# EOF")):
                problems.append(f"line {ln}: unknown comment form")
            continue
        m = _SAMPLE_RE.match(line)
        if m is None:
            problems.append(f"line {ln}: not a valid sample: {line!r}")
            continue
        samples += 1
        name = m.group(1)
        base = re.sub(r"_(count|sum|bucket)$", "", name)
        if name not in typed and base not in typed:
            problems.append(f"line {ln}: sample `{name}` has no # TYPE")
    if samples == 0:
        problems.append("no samples in exposition")
    return problems
