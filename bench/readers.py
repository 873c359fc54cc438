"""Arithmetic the metric readers in `bench/metrics/` share. A reader
returns None where it finds nothing to read, and the metric is then left
out of the result line; it never returns 0 for a share of a roofline or
of a peak."""
from __future__ import annotations

from typing import List, Optional

import numpy as np

from bench.harness import Reading, is_copy, union


def percentile_ms(samples: List[float], q: float) -> Optional[float]:
    """The q-th percentile (linear between order statistics) in ms."""
    if not samples:
        return None
    return float(np.percentile(np.asarray(samples), q)) * 1e3


def per(r: Reading, num: float, steps: str, scale: float = 1.0
        ) -> Optional[float]:
    n = r.trace.work.get(steps, 0.0) if r.trace else 0.0
    return num * scale / n if n else None


def other_ms(r: Reading, steps: str, span: Optional[str] = None
             ) -> Optional[float]:
    """Device ms per step in kernels that are neither GEMMs nor SWAT
    kernels (inside `span` if given)."""
    if r.trace is None or not r.trace.ops:
        return None
    return per(r, device_s(r, "other", span), steps, 1e3)


def launches_per_step(r: Reading, span: str, steps: str
                      ) -> Optional[float]:
    """Device kernels (no copies or fills) per step inside `span`."""
    if r.trace is None or not r.trace.ops:
        return None
    kernels = [o for o in r.trace.ops_in(span) if not is_copy(o[0])]
    return per(r, len(kernels), steps)


def device_s(r: Reading, category: str, span: Optional[str] = None
             ) -> float:
    """Device seconds of the traced window in kernels of `category`
    (bench/kernels.json; "other": none of them), inside `span` if given."""
    ops = r.trace.ops_in(span) if span else r.trace.ops
    return sum(e - s for name, s, e in ops
               if r.trace.category(name) == category)


def roofline_pct(r: Reading, category: str) -> Optional[float]:
    """The least time of the category's calls in the traced window over
    their device time."""
    if r.trace is None:
        return None
    least = r.trace.work.get(f"least_s.{category}", 0.0)
    busy = device_s(r, category)
    return 100.0 * least / busy if least and busy else None


def mfu_pct(r: Reading) -> Optional[float]:
    """The least time of all the traced window's useful work over its
    length."""
    if r.trace is None or not r.trace.work.get("least_s"):
        return None
    return 100.0 * r.trace.work["least_s"] / r.trace.window_s


def idle_pct(r: Reading) -> Optional[float]:
    if r.trace is None or not r.trace.ops:
        return None
    return 100.0 * (1.0 - r.trace.busy_s / r.trace.window_s)


def span_share_pct(r: Reading, span: str) -> Optional[float]:
    if r.trace is None:
        return None
    return 100.0 * union(r.trace.spans.get(span, [])) / r.trace.window_s
