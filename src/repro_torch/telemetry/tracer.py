"""Host-side request tracing (a copy of the JAX package's
`telemetry/tracer.py`).

A `Tracer` records per-request lifecycle timestamps (submit -> admitted ->
first token -> decode blocks -> done/degraded), decode-block spans and the
degradation-event stream, all in bounded ring buffers
(`collections.deque(maxlen=capacity)`), so an engine under sustained load
holds O(capacity) trace memory.

Derived latencies per finished request:

  queue_delay  submit -> admission (the last attempt's admission for a
               retried request: stats are PER ATTEMPT, a retry restarts
               the prefill clock but never the submit clock)
  ttft         submit -> first sampled token of the attempt that
               finalized (time to first token as the client sees it)
  tpot         (finish - first token) / (tokens - 1): steady-state time
               per output token; its resolution is one decode block (the
               host-sync quantum: the tracer adds no sync)

Exports: `chrome_trace()` (chrome://tracing, Perfetto) and
`prometheus_text()` (text exposition). The clock is injectable for
deterministic tests.
"""
from __future__ import annotations

import collections
import dataclasses
import time
from typing import Any, Callable, Deque, Dict, List, Optional

import numpy as np


@dataclasses.dataclass
class RequestRecord:
    """One finished request's lifecycle timestamps (tracer clock)."""
    rid: int
    submit: float
    admit: Optional[float]          # None: rejected before admission
    first_token: Optional[float]
    finish: float
    tokens: int
    status: str
    attempts: int = 1               # admissions consumed (1 + retries)

    @property
    def queue_delay(self) -> Optional[float]:
        return None if self.admit is None else self.admit - self.submit

    @property
    def ttft(self) -> Optional[float]:
        return (None if self.first_token is None
                else self.first_token - self.submit)

    @property
    def tpot(self) -> Optional[float]:
        if self.first_token is None or self.tokens <= 1:
            return None
        return (self.finish - self.first_token) / (self.tokens - 1)


class Tracer:
    """Ring-buffered lifecycle tracer. All hooks are O(1) host Python —
    no device work, no syncs; the engine calls them strictly outside the
    captured and replayed block dispatch."""

    def __init__(self, capacity: int = 4096,
                 clock: Callable[[], float] = time.monotonic):
        assert capacity >= 1
        self.capacity = capacity
        self.clock = clock
        self.epoch = clock()
        self.records: Deque[RequestRecord] = collections.deque(
            maxlen=capacity)
        self.blocks: Deque[Dict[str, Any]] = collections.deque(
            maxlen=capacity)
        self.events: Deque[Dict[str, Any]] = collections.deque(
            maxlen=capacity)
        self._open: Dict[int, Dict[str, Any]] = {}
        self.dropped_requests = 0     # finalize seen without a submit

    # ------------------------------------------------------------ lifecycle
    def on_submit(self, rid: int) -> None:
        self._open[rid] = {"submit": self.clock(), "admit": None,
                           "first_token": None, "attempts": 0}

    def on_admit(self, rids) -> None:
        """One admission batch entered prefill. A rid admitted AGAIN is a
        retry: the attempt counter bumps and the first-token clock resets
        (per-attempt stats), while submit stays — the client queued once."""
        t = self.clock()
        for rid in rids:
            rec = self._open.get(rid)
            if rec is None:
                rec = self._open[rid] = {"submit": t, "admit": None,
                                         "first_token": None, "attempts": 0}
            rec["admit"] = t
            rec["first_token"] = None
            rec["attempts"] += 1

    def on_first_token(self, rids) -> None:
        t = self.clock()
        for rid in rids:
            rec = self._open.get(rid)
            if rec is not None and rec["first_token"] is None:
                rec["first_token"] = t

    def on_block(self, mode: str, n: int, t0: float, tokens: int) -> None:
        """One decode block span: t0 from `clock()` before dispatch, the
        span closes at the host sync draining the block's outputs."""
        self.blocks.append({"mode": mode, "n": n, "t0": t0,
                            "dur": self.clock() - t0, "tokens": tokens})

    def on_finish(self, rid: int, status: str, tokens: int) -> None:
        t = self.clock()
        rec = self._open.pop(rid, None)
        if rec is None:
            self.dropped_requests += 1
            rec = {"submit": t, "admit": None, "first_token": None,
                   "attempts": 0}
        self.records.append(RequestRecord(
            rid=rid, submit=rec["submit"], admit=rec["admit"],
            first_token=rec["first_token"], finish=t, tokens=tokens,
            status=status, attempts=max(1, rec["attempts"])))

    def on_bus_event(self, ev: dict) -> None:
        """EventBus subscription sink — stamps arrival time."""
        self.events.append({"ts": self.clock(), **ev})

    # ------------------------------------------------------------- summary
    def _samples(self, field: str) -> List[float]:
        return [v for r in self.records
                if (v := getattr(r, field)) is not None]

    @staticmethod
    def percentiles(samples: List[float]) -> Dict[str, float]:
        if not samples:
            return {"p50": 0.0, "p95": 0.0, "p99": 0.0, "count": 0}
        arr = np.asarray(samples, np.float64)
        return {"p50": float(np.percentile(arr, 50)),
                "p95": float(np.percentile(arr, 95)),
                "p99": float(np.percentile(arr, 99)),
                "count": int(arr.size)}

    def latency_summary(self) -> Dict[str, Dict[str, float]]:
        """p50/p95/p99 of the three derived latencies, in seconds, over
        the retained record window."""
        return {"ttft": self.percentiles(self._samples("ttft")),
                "tpot": self.percentiles(self._samples("tpot")),
                "queue_delay": self.percentiles(
                    self._samples("queue_delay"))}

    # ------------------------------------------------------------- exports
    def _us(self, t: float) -> float:
        return (t - self.epoch) * 1e6

    def chrome_trace(self, *, metadata: Optional[dict] = None) -> dict:
        """Chrome-trace JSON (chrome://tracing, Perfetto): request phases
        on pid 1 (one tid per rid), decode-block spans on pid 0 tid 0,
        degradation events as instants on pid 0 tid 1."""
        tev: List[dict] = [
            {"name": "process_name", "ph": "M", "pid": 0, "tid": 0,
             "args": {"name": "engine"}},
            {"name": "process_name", "ph": "M", "pid": 1, "tid": 0,
             "args": {"name": "requests"}},
        ]
        for b in self.blocks:
            tev.append({"name": f"{b['mode']}_block[n={b['n']}]",
                        "cat": "decode", "ph": "X", "pid": 0, "tid": 0,
                        "ts": self._us(b["t0"]), "dur": b["dur"] * 1e6,
                        "args": {"tokens": b["tokens"]}})
        for ev in self.events:
            args = {k: v for k, v in ev.items() if k not in ("ts", "kind")}
            tev.append({"name": ev.get("kind", "event"), "cat": "degrade",
                        "ph": "i", "pid": 0, "tid": 1, "s": "g",
                        "ts": self._us(ev["ts"]), "args": args})
        for r in self.records:
            tid = r.rid
            phases = []
            if r.admit is not None:
                phases.append(("queued", r.submit, r.admit))
                end_first = (r.first_token if r.first_token is not None
                             else r.finish)
                phases.append(("prefill", r.admit, end_first))
                if r.first_token is not None:
                    phases.append(("decode", r.first_token, r.finish))
            else:
                phases.append((r.status, r.submit, r.finish))
            for name, t0, t1 in phases:
                tev.append({"name": f"req{r.rid}:{name}", "cat": "request",
                            "ph": "X", "pid": 1, "tid": tid,
                            "ts": self._us(t0),
                            "dur": max(t1 - t0, 0.0) * 1e6,
                            "args": {"status": r.status,
                                     "tokens": r.tokens,
                                     "attempts": r.attempts}})
        return {"traceEvents": tev, "displayTimeUnit": "ms",
                "metadata": metadata or {}}


def prometheus_text(counters: Dict[str, Any],
                    latency: Optional[Dict[str, Dict[str, float]]] = None,
                    *, prefix: str = "swat",
                    doc: Optional[Dict[str, str]] = None) -> str:
    """Prometheus text exposition: integer/float `counters` become
    counters, `latency` summaries become quantile-labeled summary
    metrics. Plain text format 0.0.4 — parseable by `validate.py` and any
    Prometheus scraper."""
    lines: List[str] = []
    for name in sorted(counters):
        metric = f"{prefix}_{_sanitize(name)}"
        help_ = (doc or {}).get(name, name.replace("_", " "))
        lines.append(f"# HELP {metric} {help_}")
        lines.append(f"# TYPE {metric} counter")
        lines.append(f"{metric} {_fmt(counters[name])}")
    for name in sorted(latency or {}):
        q = latency[name]
        metric = f"{prefix}_{_sanitize(name)}_seconds"
        lines.append(f"# HELP {metric} {name} latency quantiles (seconds)")
        lines.append(f"# TYPE {metric} summary")
        for k, label in (("p50", "0.5"), ("p95", "0.95"), ("p99", "0.99")):
            lines.append(f'{metric}{{quantile="{label}"}} '
                         f'{_fmt(q.get(k, 0.0))}')
        lines.append(f"{metric}_count {int(q.get('count', 0))}")
    return "\n".join(lines) + "\n"


def _sanitize(name: str) -> str:
    return "".join(c if (c.isalnum() or c == "_") else "_" for c in name)


def _fmt(v) -> str:
    if isinstance(v, (bool, np.bool_)):
        return str(int(v))
    if isinstance(v, (int, np.integer)):
        return str(int(v))
    return repr(float(v))
