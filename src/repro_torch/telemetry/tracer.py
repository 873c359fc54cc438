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

Phase spans (`span()`): named host ranges inside the serving engine and
the train step, recorded only while a torch profiler is active. Each one
is a `record_function` range on the profiler's timeline and a record in
a bounded module-level ring (`peek_spans()` / `consume_spans()`) with its
counts and, where asked, the device time between two CUDA events. With
no profiler active a span is one boolean test. `Tracer.chrome_trace()`
(with the default clock) counts time on the profiler's base, Unix-epoch
us as kineto stamps its events, so its request and block spans lie over
the profiler's engine phases and kernels.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import time
from typing import Any, Callable, Deque, Dict, List, Optional

import numpy as np
import torch
from torch.autograd import profiler as _autograd_profiler


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
        # the time the last admission, first-token or block hook recorded:
        # the engine's stats take it, so each boundary is read once
        self.last: Optional[float] = None
        # chrome-trace us of the epoch: the default clock lies on the
        # profiler's base (Unix-epoch us); an injected one counts from it
        self._epoch_us = ((self.epoch * 1e9 + clock_offset_ns()) / 1e3
                          if clock is time.monotonic else 0.0)

    # ------------------------------------------------------------ lifecycle
    def on_submit(self, rid: int) -> None:
        self._open[rid] = {"submit": self.clock(), "admit": None,
                           "first_token": None, "attempts": 0}

    def on_admit(self, rids) -> None:
        """One admission batch entered prefill. A rid admitted AGAIN is a
        retry: the attempt counter bumps and the first-token clock resets
        (per-attempt stats), while submit stays — the client queued once."""
        t = self.last = self.clock()
        for rid in rids:
            rec = self._open.get(rid)
            if rec is None:
                rec = self._open[rid] = {"submit": t, "admit": None,
                                         "first_token": None, "attempts": 0}
            rec["admit"] = t
            rec["first_token"] = None
            rec["attempts"] += 1

    def on_first_token(self, rids) -> None:
        t = self.last = self.clock()
        for rid in rids:
            rec = self._open.get(rid)
            if rec is not None and rec["first_token"] is None:
                rec["first_token"] = t

    def on_block(self, mode: str, n: int, t0: float, tokens: int) -> None:
        """One decode block span: t0 from `clock()` before dispatch, the
        span closes here, after the host sync draining the block's
        outputs."""
        self.last = self.clock()
        self.blocks.append({"mode": mode, "n": n, "t0": t0,
                            "dur": self.last - t0, "tokens": tokens})

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
        return (t - self.epoch) * 1e6 + self._epoch_us

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


# ---------------------------------------------------------------- spans --
SPAN_CAPACITY = 1 << 16
_SPANS: Deque[Dict[str, Any]] = collections.deque(maxlen=SPAN_CAPACITY)
_OFFSET_NS: Optional[int] = None


def clock_offset_ns() -> int:
    """ns from time.monotonic's base to the profiler's (Unix-epoch ns, as
    kineto stamps its events), measured once."""
    global _OFFSET_NS
    if _OFFSET_NS is None:
        a, wall, b = time.monotonic_ns(), time.time_ns(), time.monotonic_ns()
        _OFFSET_NS = wall - (a + b) // 2
    return _OFFSET_NS


_OFF = contextlib.nullcontext()          # `span` with no profiler active


class _Span:
    __slots__ = ("name", "device", "counts", "_range", "_events")

    def __init__(self, name: str, device: bool, counts: Dict[str, int]):
        self.name, self.device, self.counts = name, device, counts
        self._events = None

    def __enter__(self) -> None:
        self._range = torch.profiler.record_function(self.name)
        self._range.__enter__()
        if self.device and not torch.cuda.is_current_stream_capturing():
            self._events = (torch.cuda.Event(enable_timing=True),
                            torch.cuda.Event(enable_timing=True))
            self._events[0].record()

    def __exit__(self, *exc) -> bool:
        if self._events is not None:
            self._events[1].record()
        self._range.__exit__(*exc)
        _SPANS.append({"name": self.name, "counts": self.counts,
                       "events": self._events, "device_ms": None})
        return False


def span(name: str, *, device: bool = False, **counts: int):
    """A phase of the engine or the train step: `with span(name, **counts)`.
    Records only while a torch profiler is active (as `record_function`
    does); otherwise it costs one boolean test. Recording, it opens a
    `record_function(name)` range (the profiler's timeline holds its host
    start, end and nesting) and, as it closes, appends the name and the
    counts to the ring; with `device` (the work runs on the card's current
    stream) and outside a graph capture, also a pair of timing CUDA events
    around the phase, which resolve to device ms when the ring is read.
    Never open one inside a captured body."""
    if not _autograd_profiler._is_profiler_enabled:
        return _OFF
    return _Span(name, device, counts)


def _export(rec: Dict[str, Any]) -> Dict[str, Any]:
    ev = rec["events"]
    if ev is not None:
        ev[1].synchronize()
        rec["device_ms"] = ev[0].elapsed_time(ev[1])
        rec["events"] = None
    return {"name": rec["name"], "counts": dict(rec["counts"]),
            "device_ms": rec["device_ms"]}


def peek_spans() -> List[Dict[str, Any]]:
    """The ring's spans in the order they closed: name, counts, device_ms
    (None without events)."""
    return [_export(r) for r in _SPANS]


def consume_spans() -> List[Dict[str, Any]]:
    """`peek_spans()`, then empty the ring."""
    out = peek_spans()
    _SPANS.clear()
    return out
