"""Arithmetic the readers of the program's phase spans share: the device's
idle time inside the engine's host spans, read off the traced window, and
the records of the program's span ring (`repro_torch.telemetry.tracer`:
each phase's counts, and device ms from CUDA events). A program without
those spans or that ring reads None, as does an untraced run or a trace
in which no operation ran on the device."""
from __future__ import annotations

from typing import Iterable, List, Optional, Tuple

from bench.harness import Reading

DECODE_HOST = tuple(f"engine.decode_block.{p}"
                    for p in ("stage", "launch", "hooks", "retire"))
DECODE_READ = ("engine.decode_block.read",)
PREFILL_PHASES = tuple(f"engine.prefill.{p}" for p in (
    "upload", "model", "insert", "read", "hooks", "retire"))


def merged(ranges: Iterable[Tuple[float, float]]
           ) -> List[Tuple[float, float]]:
    """Sorted, disjoint (start, end) ranges covering the same time."""
    out: List[List[float]] = []
    for s, e in sorted(ranges):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def overlap(a: List[Tuple[float, float]], b: List[Tuple[float, float]]
            ) -> float:
    """Length of the intersection of two `merged` lists."""
    total, i, j = 0.0, 0, 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        total += max(0.0, hi - lo)
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def idle_s(r: Reading, names: Iterable[str]) -> Optional[float]:
    """Seconds inside the union of the host ranges `names` during which no
    device operation ran."""
    if r.trace is None or not r.trace.ops:
        return None
    spans = merged(x for n in names for x in r.trace.spans.get(n, []))
    if not spans:
        return None
    busy = merged((s, e) for _, s, e in r.trace.ops)
    return sum(e - s for s, e in spans) - overlap(spans, busy)


def idle_ms_per_range(r: Reading, names: Iterable[str], parent: str
                      ) -> Optional[float]:
    """`idle_s` of `names` in ms over the count of `parent` ranges."""
    idle = idle_s(r, names)
    n = len(r.trace.spans.get(parent, [])) if idle is not None else 0
    return 1e3 * idle / n if n else None


def ring(name: str) -> Optional[List[dict]]:
    """The program's span-ring records named `name` (the ring records only
    while the profiler runs: the traced window); None for a program that
    has no ring."""
    try:
        from repro_torch.telemetry.tracer import peek_spans
    except ImportError:
        return None
    return [s for s in peek_spans() if s["name"] == name]


def device_ms(r: Reading, name: str) -> Optional[float]:
    """Mean device ms of the ring's `name` spans that timed the device."""
    if r.trace is None or not r.trace.ops:
        return None
    times = [s["device_ms"] for s in ring(name) or []
             if s["device_ms"] is not None]
    return sum(times) / len(times) if times else None
