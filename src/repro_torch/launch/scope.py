"""swatscope command line for the port: validate, profile and census, with
the JAX package's `repro.launch.scope` subcommands and flags.

    # validate exported artifacts (host only)
    PYTHONPATH=src python -m repro_torch.launch.scope validate \
        --trace trace.json --metrics metrics.prom

    # per-shape fused-decode latency + roofline rows, with the H100 bound
    PYTHONPATH=src python -m repro_torch.launch.scope profile \
        --impl pallas --window 256 --cap 261 --batch 4 --heads-kv 8 \
        --group 4 --head-dim 64

    # dispatch census of a smoke serve (which decode shapes did the
    # engine dispatch?)
    PYTHONPATH=src python -m repro_torch.launch.scope census \
        --arch llama3.2-1b

`validate` exits non-zero listing every schema problem; `profile` prints
one row per shape (p50/p95 latency, FLOPs, HBM bytes, intensity, the H100
bound and, on the card, the share of it reached); `census` runs a small
instrumented serve and prints the deduped (shape -> dispatches) map plus
the engine snapshot. `--impl pallas` is the CUDA kernel, `ref` its plain
version. `profile` and `census` run on the card unless given `--device
cpu`; without a card they exit non-zero.
"""
import argparse
import json
import sys

# the JAX CLI's impl names -> the port's (as launch/serve.py --decode-impl)
_IMPLS = {"pallas": "kernel", "ref": "ref"}


def _cmd_validate(args):
    from repro_torch.telemetry import validate as V

    problems = []
    if args.trace:
        with open(args.trace) as f:
            doc = json.load(f)
        for p in V.validate_chrome_trace(doc):
            problems.append(f"{args.trace}: {p}")
        if not problems:
            n = len(doc.get("traceEvents", []))
            print(f"[scope] {args.trace}: valid chrome trace ({n} events)")
    if args.metrics:
        with open(args.metrics) as f:
            text = f.read()
        ms = V.validate_prometheus(text)
        for p in ms:
            problems.append(f"{args.metrics}: {p}")
        if not ms:
            n = sum(1 for ln in text.splitlines()
                    if ln.strip() and not ln.startswith("#"))
            print(f"[scope] {args.metrics}: valid prometheus exposition "
                  f"({n} samples)")
    if not args.trace and not args.metrics:
        print("[scope] nothing to validate (pass --trace and/or --metrics)")
        return 2
    for p in problems:
        print(f"[scope] INVALID: {p}")
    return 1 if problems else 0


def _device(args):
    """args.device, or None (after saying why) when it names the card and
    there is none."""
    import torch
    if args.device.startswith("cuda") and not torch.cuda.is_available():
        print(f"[scope] {args.cmd}: no CUDA device (pass --device cpu to "
              "run the plain versions on the CPU)", file=sys.stderr)
        return None
    return args.device


def _cmd_profile(args):
    from repro_torch.telemetry import kernelprof as KP

    device = _device(args)
    if device is None:
        return 2
    shape = {"b": args.batch, "h_kv": args.heads_kv, "group": args.group,
             "t": args.tokens, "d": args.head_dim, "window": args.window,
             "num_global": args.num_global, "cap": args.cap}
    try:
        rows = KP.profile_decode([shape], impl=_IMPLS[args.impl],
                                 device=device, iters=args.iters)
    except ValueError as e:
        print(f"[scope] {e}", file=sys.stderr)
        return 2
    for r in rows:
        share = ("" if r["bound_share"] is None
                 else f", {r['bound_share'] * 100:.1f}% of it")
        print(f"[scope] {args.impl} b={r['b']} h_kv={r['h_kv']} "
              f"g={r.get('group', 1)} t={r['t']} d={r['d']} "
              f"window={r['window']} cap={r['cap']} on {r['device']}: "
              f"p50={r['p50_us']:.2f}us p95={r['p95_us']:.2f}us "
              f"({r['flops'] / 1e6:.2f} MFLOP, "
              f"{r['hbm_bytes'] / 1e6:.2f} MB, "
              f"intensity={r['intensity']:.2f} flop/B, "
              f"band={r['band_rows']} rows, {r['achieved_gbps']:.1f} GB/s; "
              f"H100 bound {r['bound_ms'] * 1e3:.3f}us ({r['bound_by']})"
              f"{share})")
    if args.out:
        with open(args.out, "w") as f:
            json.dump(rows, f, indent=2)
        print(f"[scope] wrote {args.out}")
    return 0


def _cmd_census(args):
    import numpy as np

    from repro_torch.configs import get_smoke_config, with_swat
    from repro_torch.core import model as Mod
    from repro_torch.serving.engine import Request, ServingEngine
    from repro_torch.telemetry import kernelprof as KP

    device = _device(args)
    if device is None:
        return 2
    cfg = with_swat(get_smoke_config(args.arch), window=args.window,
                    num_global=4)
    params = Mod.init_model(cfg, seed=0, device=device)
    rng = np.random.RandomState(0)
    reqs = [Request(rid=i,
                    prompt=rng.randint(0, cfg.vocab_size, (16,)
                                       ).astype(np.int32),
                    max_new_tokens=8)
            for i in range(args.requests)]
    KP.enable_census(True)
    try:
        eng = ServingEngine(cfg, params, batch_slots=2, max_len=64,
                            scan_steps=4, decode_impl=args.impl,
                            metrics=True)
        eng.run(reqs)
    except ValueError as e:
        print(f"[scope] {e}", file=sys.stderr)
        return 2
    finally:
        KP.enable_census(False)
    census = KP.consume_census()
    print(f"[scope] dispatch census: {len(census)} distinct kernel shapes")
    for rec in census:
        traces = rec.pop("traces")
        print("[scope]   " + " ".join(f"{k}={v}"
                                      for k, v in sorted(rec.items()))
              + f"  (dispatched {traces}x in Python)")
    snap = eng.snapshot()
    print("[scope] engine snapshot: "
          + json.dumps(snap, sort_keys=True, default=str))
    return 0


def main(argv=None):
    ap = argparse.ArgumentParser(prog="scope")
    sub = ap.add_subparsers(dest="cmd", required=True)

    v = sub.add_parser("validate", help="schema-check exported artifacts")
    v.add_argument("--trace", default=None,
                   help="chrome-trace JSON (from serve --trace-out)")
    v.add_argument("--metrics", default=None,
                   help="prometheus text (from serve --metrics-out)")
    v.set_defaults(fn=_cmd_validate)

    p = sub.add_parser("profile", help="kernel latency + roofline rows")
    p.add_argument("--impl", choices=tuple(_IMPLS), default="ref")
    p.add_argument("--batch", type=int, default=2)
    p.add_argument("--heads-kv", type=int, default=2)
    p.add_argument("--group", type=int, default=2,
                   help="query heads per kv head (GQA group)")
    p.add_argument("--tokens", type=int, default=1)
    p.add_argument("--head-dim", type=int, default=64)
    p.add_argument("--window", type=int, default=16)
    p.add_argument("--num-global", type=int, default=4)
    p.add_argument("--cap", type=int, default=64,
                   help="physical ring rows (>= window+globals+tokens)")
    p.add_argument("--iters", type=int, default=20)
    p.add_argument("--out", default=None, help="write rows as JSON")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.set_defaults(fn=_cmd_profile)

    c = sub.add_parser("census", help="dispatch census of a smoke serve")
    c.add_argument("--arch", default="llama3.2-1b")
    c.add_argument("--impl", choices=tuple(_IMPLS), default="ref")
    c.add_argument("--window", type=int, default=16)
    c.add_argument("--requests", type=int, default=4)
    c.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    c.set_defaults(fn=_cmd_census)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
