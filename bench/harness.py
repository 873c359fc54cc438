"""The benchmark's run of one cell: the files it is made of, the measured
window and its traced part, the reading of the profiler's trace, and the
result line.

Everything that belongs to one configuration, cell, driver or metric lives
in a file of its own, found by name:

  bench/configs/<config>.json   sizes, source, assumptions (the reference
                                reads them too)
  bench/cells/<workload>.json   driver, traffic, engine settings, the
                                correctness limits
  bench/drivers/<driver>.py     run(h) -> Outcome: set-up, window, check
  bench/metrics/<metric>.py     read(r) -> value or None, for every metric
                                that BENCHMARK.json gives the cell
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional, Tuple

ROOT = Path(__file__).resolve().parent.parent
# top-level module names that may not be loaded in a run: the JAX stack
# and the JAX package (the port, repro_torch, is another top-level name)
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
# spans that name what the host was doing in an idle gap of the device
HOST_SPANS = ("engine.prefill", "engine.decode_block", "bench.")


def clock() -> float:
    """The window's clock: the serving engine's tracer and deadlines read
    time.monotonic too."""
    return time.monotonic()


def process_age() -> float:
    """Seconds since this process started (Linux /proc, 10 ms steps)."""
    try:
        with open("/proc/self/stat") as f:
            start = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            up = float(f.read().split()[0])
        return max(0.0, up - start / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return clock() - _IMPORTED


_IMPORTED = time.monotonic()


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name (before the first dot), compared
    whole, is one of FORBIDDEN."""
    return sorted({m for m in list(sys.modules)
                   if m.split(".", 1)[0] in FORBIDDEN})


# ------------------------------------------------------------ the spec --
@dataclasses.dataclass
class Spec:
    """A workload of BENCHMARK.json with its files."""
    workload: dict
    cell: dict
    config: dict
    metrics: List[dict]          # the metrics this cell reports, in order

    @classmethod
    def load(cls, name: str, trace: bool, root: Path = ROOT) -> "Spec":
        bench = load_json(root / "BENCHMARK.json")
        work = next((w for w in bench["workloads"] if w["name"] == name),
                    None)
        if work is None:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json")
        cell = load_json(root / "bench" / "cells" / f"{name}.json")
        conf = next(c for c in bench["configs"] if c["name"] == work["config"])
        config = load_json(root / conf["file"])
        e2e = [m for m in bench["end_to_end"]
               if name in m.get("workloads", [name])]
        names = {m["name"] for m in e2e}
        layer = [m for m in bench["per_layer"]
                 if name in m.get("workloads", [name] if m["moves"] in names
                                  else [])]
        return cls(work, cell, config, layer if trace else e2e)


# ------------------------------------------------------------ the window --
class Window:
    """The measured window, and its traced part. A driver calls `open()`
    at a boundary of its work (a decode block's end, a burst's or a train
    step's), `add(...)` as each piece of work completes, and `boundary()`
    at each later boundary until it returns True: the window then closes
    there. With tracing, the profiler runs from `open()` to the first
    boundary `trace_seconds` on (or to the close), inside one
    `bench.traced` range."""

    def __init__(self, seconds: float, trace: bool, trace_seconds: float):
        self.seconds = seconds
        self.trace = trace
        self.trace_seconds = min(trace_seconds, seconds)
        self.t_open: Optional[float] = None
        self.t_close: Optional[float] = None
        self.setup_s: Optional[float] = None
        self.work: Dict[str, float] = {}
        self.traced_work: Dict[str, float] = {}
        self._prof = None
        self._range = None
        self.trace_events = None

    @property
    def is_open(self) -> bool:
        return self.t_open is not None and self.t_close is None

    @property
    def tracing(self) -> bool:
        return self._prof is not None

    def open(self) -> None:
        bad = forbidden_modules()
        if bad:
            raise RuntimeError(f"modules of the JAX stack or the JAX "
                               f"package loaded in set-up: {bad}")
        self.setup_s = process_age()
        if self.trace:
            self._start_trace()
        self.t_open = clock()

    def add(self, **counters: float) -> None:
        if not self.is_open:
            return
        for k, v in counters.items():
            self.work[k] = self.work.get(k, 0.0) + v
            if self.tracing:
                self.traced_work[k] = self.traced_work.get(k, 0.0) + v

    def boundary(self) -> bool:
        """At a boundary of the work: end the traced part once its time is
        up; close the window and return True once its time is up."""
        now = clock()
        done = now - self.t_open >= self.seconds
        if done:
            self.t_close = now
        if self.tracing and (done or now - self.t_open >= self.trace_seconds):
            # reading the trace takes seconds: the traced part of the
            # window has ended, and with tracing on the window's own
            # length is not reported
            self._stop_trace()
        return done

    @property
    def length(self) -> float:
        return self.t_close - self.t_open

    def _start_trace(self) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            torch.cuda.synchronize()
            acts.append(ProfilerActivity.CUDA)
        self._prof = profile(activities=acts)
        self._prof.start()
        self._range = torch.profiler.record_function("bench.traced")
        self._range.__enter__()

    def _stop_trace(self) -> None:
        import torch
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self._range.__exit__(None, None, None)
        self._prof.stop()
        self.trace_events = read_profile(self._prof)
        self._prof = self._range = None


# ------------------------------------------------------------- the trace --
@dataclasses.dataclass
class TraceData:
    """The traced window: device operations and host spans as (start, end)
    seconds from its start, the work that completed inside it."""
    window_s: float
    ops: List[Tuple[str, float, float]]        # device operations
    spans: Dict[str, List[Tuple[float, float]]]
    work: Dict[str, float]
    table: Dict[str, List[str]]

    def category(self, name: str) -> str:
        low = name.lower()
        for cat, keys in self.table.items():
            if any(k in low for k in keys):
                return cat
        return "other"

    def ops_in(self, span: str) -> List[Tuple[str, float, float]]:
        """Device operations that start inside one of the `span` ranges
        (a span ends in a host sync, so what it launched ran inside it)."""
        rs = sorted(self.spans.get(span, []))
        out, i = [], 0
        for op in sorted(self.ops, key=lambda o: o[1]):
            while i < len(rs) and rs[i][1] < op[1]:
                i += 1
            if i < len(rs) and rs[i][0] <= op[1] <= rs[i][1]:
                out.append(op)
        return out

    @property
    def busy_s(self) -> float:
        return union([(s, e) for _, s, e in self.ops])



def is_copy(name: str) -> bool:
    """A device copy or fill, not a kernel."""
    low = name.lower()
    return low.startswith("memcpy") or low.startswith("memset")


def union(ranges) -> float:
    """Length of the union of (start, end) ranges."""
    total, cur = 0.0, None
    for s, e in sorted(ranges):
        if cur is None or s > cur[1]:
            if cur is not None:
                total += cur[1] - cur[0]
            cur = [s, e]
        else:
            cur[1] = max(cur[1], e)
    return total + (cur[1] - cur[0] if cur else 0.0)


def read_profile(prof) -> dict:
    """The profiler's raw events: device operations (name, start ns, end
    ns) and host ranges by name, from kineto's records."""
    import torch
    cuda = torch.autograd.DeviceType.CUDA
    ops, spans = [], {}
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        s, end = _span_ns(e)
        if e.device_type() == cuda:
            # a record_function range also shows on the device's timeline
            ann = getattr(e, "is_user_annotation", None)
            if not (ann() if ann else name.startswith(HOST_SPANS)):
                ops.append((name, s, end))
        elif name == "bench.traced" or name.startswith(HOST_SPANS):
            spans.setdefault(name, []).append((s, end))
    return {"ops": ops, "spans": spans}


def _span_ns(e) -> Tuple[int, int]:
    """A kineto event's (start, end) in ns (older builds count in us)."""
    if hasattr(e, "start_ns"):
        s, d = e.start_ns(), e.duration_ns()
    else:
        s, d = e.start_us() * 1000, e.duration_us() * 1000
    return s, s + d


def trace_data(window: Window, table: Dict[str, List[str]]
               ) -> Optional[TraceData]:
    ev = window.trace_events
    if not ev or "bench.traced" not in ev["spans"]:
        return None
    t0, t1 = ev["spans"]["bench.traced"][0]

    def clip(s, e):
        s, e = max(s, t0), min(e, t1)
        return ((s - t0) / 1e9, (e - t0) / 1e9) if e > s else None

    ops = []
    for name, s, e in ev["ops"]:
        c = clip(s, e)
        if c:
            ops.append((name, *c))
    spans = {}
    for name, rs in ev["spans"].items():
        if name == "bench.traced":
            continue
        spans[name] = [c for c in (clip(s, e) for s, e in rs) if c]
    return TraceData((t1 - t0) / 1e9, ops, spans, dict(window.traced_work),
                     table)


def breakdown(td: TraceData) -> dict:
    """The device operations that took most time, and the idle gaps of the
    device summed by the innermost host span open at each gap's middle."""
    by_op: Dict[str, float] = {}
    for name, s, e in td.ops:
        by_op[name] = by_op.get(name, 0.0) + (e - s)
    gaps: Dict[str, float] = {}
    busy = sorted((s, e) for _, s, e in td.ops)
    cur = 0.0
    edges = []
    for s, e in busy:
        if s > cur:
            edges.append((cur, s))
        cur = max(cur, e)
    if td.window_s > cur:
        edges.append((cur, td.window_s))
    for a, b in edges:
        mid = (a + b) / 2
        open_ = [(s, name) for name, rs in td.spans.items()
                 for s, e in rs if s <= mid <= e]
        label = max(open_)[1] if open_ else "outside the spans"
        gaps[label] = gaps.get(label, 0.0) + (b - a)
    top = lambda d: [[k, v] for k, v in sorted(d.items(),
                                               key=lambda kv: -kv[1])[:10]]
    return {"device_ops": top(by_op), "idle_gaps": top(gaps)}


# ------------------------------------------------------------ the result --
@dataclasses.dataclass
class Outcome:
    """What a driver hands back: the window's records for the metric
    readers, the correctness numbers with their limits, and lines to
    print before the result."""
    window: Window
    records: dict                      # read by bench/metrics/*.py
    attempted: int
    failed: int
    checks: Dict[str, Tuple[float, float]]    # name -> (value, limit)
    notes: List[str] = dataclasses.field(default_factory=list)
    memory_peak_bytes: int = 0

    @property
    def correct(self) -> bool:
        return all(lim is not None and v == v and v <= lim
                   for v, lim in self.checks.values())


@dataclasses.dataclass
class Reading:
    """What a metric reader reads."""
    window_s: float
    setup_s: float
    work: Dict[str, float]
    records: dict
    trace: Optional[TraceData]


def read_metrics(spec: Spec, reading: Reading, root: Path = ROOT
                 ) -> Dict[str, dict]:
    out = {}
    for m in spec.metrics:
        mod = load_module(root / "bench" / "metrics" / f"{m['name']}.py",
                          "bench_metric_" + m["name"].replace(".", "_"))
        v = mod.read(reading)
        if v is not None:
            out[m["name"]] = {"value": float(v), "unit": m["unit"]}
    return out


def device_info(chips: int, peak: int) -> dict:
    import torch
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": chips, "memory_peak_bytes": int(peak)}


def run_driver(spec: Spec, seed: int, seconds: float, trace: bool,
               device: str = "cuda", root: Path = ROOT
               ) -> Tuple[Outcome, Reading]:
    """Load the cell's driver and run it; read its records."""
    driver = load_module(root / "bench" / "drivers"
                         / f"{spec.cell['driver']}.py",
                         "bench_driver_" + spec.cell["driver"])
    window = Window(seconds, trace, spec.cell.get("trace_seconds", seconds))
    h = Harness(spec=spec, seed=seed, window=window, device=device)
    out = driver.run(h)
    table = load_json(root / "bench" / "kernels.json")
    reading = Reading(window_s=window.length, setup_s=window.setup_s,
                      work=dict(window.work), records=out.records,
                      trace=trace_data(window, table) if trace else None)
    return out, reading


@dataclasses.dataclass
class Harness:
    """What a driver is given."""
    spec: Spec
    seed: int
    window: Window
    device: str = "cuda"

    @property
    def cell(self) -> dict:
        return self.spec.cell

    @property
    def config(self) -> dict:
        return self.spec.config
