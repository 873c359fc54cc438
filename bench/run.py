"""Run one cell of the port's benchmark on the card(s) of this machine.

    python3 bench/run.py --workload granite-8b-swat.decode-long \
        --seed 12345 --seconds 45 --trace 0

Prints, as the last line of standard output, one JSON object: correct,
attempted, failed, metrics (the cell's end-to-end metrics with --trace 0,
its per-layer metrics with --trace 1), device, with --trace 1 the
breakdown, and last the numbers compared for `correct` beside their
limits (also the last lines of standard error). Exits non-zero with no
result when there is no CUDA device, fewer than the cell asks for, or a
module of the JAX stack or the JAX package is loaded.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def _environment() -> None:
    """Caches inside the checkout at fixed paths; no library loads JAX."""
    cache = ROOT / ".bench_cache"
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TORCHINDUCTOR_CACHE_DIR", "inductor"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = str(cache / sub)
    os.environ["USE_FLAX"] = "0"
    for p in (str(ROOT / "src"), str(ROOT)):
        if p not in sys.path:
            sys.path.insert(0, p)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _environment()

    from bench import harness as H
    spec = H.Spec.load(args.workload, bool(args.trace))

    import torch
    chips = spec.workload["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"[bench] {args.workload} needs {chips} CUDA device(s), "
              f"this machine has {n}", file=sys.stderr)
        return 2

    out, reading = H.run_driver(spec, args.seed, args.seconds,
                                bool(args.trace))
    bad = H.forbidden_modules()
    if bad:
        print(f"[bench] loaded modules of the JAX stack or the JAX "
              f"package: {bad}", file=sys.stderr)
        return 3
    for line in out.notes:
        print(f"[bench] {line}", file=sys.stderr)
    result = {"correct": out.correct, "attempted": out.attempted,
              "failed": out.failed,
              "metrics": H.read_metrics(spec, reading),
              "device": H.device_info(chips, out.memory_peak_bytes)}
    if args.trace and reading.trace is not None:
        result["device"]["busy_s"] = reading.trace.busy_s
        result["device"]["window_s"] = reading.trace.window_s
        result["breakdown"] = H.breakdown(reading.trace)
    result["check"] = {k: {"value": v, "limit": lim}
                       for k, (v, lim) in out.checks.items()}
    for k, (v, lim) in out.checks.items():
        print(f"[bench] check {k} = {v!r} (limit {lim!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
