"""The readings that the correctness limits are set from, on the card at
a cell's own size, all seeds of a cell in one process.

    python3 bench/controls.py --workload granite-8b-swat.decode-long \
        --seeds 12 --controls 3 --seconds 20 --out chiprun_out/x.jsonl

For each seed: the program's reading of every number the cell compares
(a served cell's run with a short window at the cell's own load, a
training cell's checked steps). On the first `--controls` seeds also:
- the control, the reference computed in fp8 (e4m3) put in the program's
  place: for a served cell, at each position of the same prompts and
  served tokens, the gap of the token that fp8 puts first; for a training
  cell, fp8 training from the same weights on the same batches;
- a training cell's planted fault "half of the batch left out, the mean
  taken over the rest", in the reference put in the program's place (the
  fault "a step that returns its state unchanged" reads 1 on the change
  by the measure itself and needs no run).
One JSON line per seed; last, the lower reading (the largest the program
gives), the upper (the smallest a control or fault gives) and their ratio.
"""
from __future__ import annotations

import argparse
import gc
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--controls", type=int, default=3)
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--first-seed", type=int, default=2**31 + 7)
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    for p in (str(ROOT / "src"), str(ROOT)):
        if p not in sys.path:
            sys.path.insert(0, p)
    import torch
    from bench import harness as H
    if not torch.cuda.is_available():
        print("[controls] no CUDA device", file=sys.stderr)
        return 2
    spec = H.Spec.load(args.workload, False)
    rows = []
    for i in range(args.seeds):
        seed = args.first_seed + 7919 * i
        row = readings(spec, seed, args.seconds, i < args.controls)
        rows.append(row)
        line = json.dumps(row)
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
        gc.collect()
        torch.cuda.empty_cache()
    summary = summarise(rows)
    print(json.dumps(summary), flush=True)
    if args.out:
        with open(args.out, "a") as f:
            f.write(json.dumps(summary) + "\n")
    return 0


def readings(spec, seed: int, seconds: float, control: bool) -> dict:
    if spec.cell["driver"] == "train":
        return train_readings(spec, seed, control)
    return served_readings(spec, seed, seconds, control)


def served_readings(spec, seed: int, seconds: float, control: bool) -> dict:
    """Run the driver with a short window; at its check, read the
    program's gaps and (control) the fp8 reference's."""
    from bench import harness as H
    from bench import serving as S
    from bench.reference import lm
    from bench.traffic import generate
    got = {}
    plain = S.check_served

    def check(h, params, prompts, served, population, k):
        out = plain(h, params, prompts, served, population, k)
        got["program"] = {"max_logit_gap": out["max_logit_gap"],
                          "tokens": out["tokens"]}
        if control:
            longest = max(population,
                          key=lambda r: len(prompts[r]) + len(served[r]))
            rids = generate.sample(h.seed, population, k, [longest])
            gaps = S.served_gaps(
                lm.Model.from_config(h.config), params,
                [prompts[r] for r in rids], [served[r] for r in rids],
                h.device, control=lm.Model.from_config(h.config, "fp8"))
            got["control_fp8"] = {"max_logit_gap":
                                  max(float(g.max()) for g in gaps)}
        return out

    S.check_served = check
    try:
        H.run_driver(spec, seed, seconds, False)
    finally:
        S.check_served = plain
    return {"seed": seed, **got}


def train_readings(spec, seed: int, control: bool) -> dict:
    import torch
    from bench import harness as H
    from bench import serving as S
    from bench import weights as Wt
    from bench.reference import compare
    from bench.traffic import generate
    from bench.work import Shape
    drv = H.load_module(H.ROOT / "bench" / "drivers" / "train.py",
                        "bench_driver_train")
    h = H.Harness(spec=spec, seed=seed, window=None)
    shape = Shape.from_config(spec.config)
    cfg = S.port_config(spec.config)
    batch_fn = generate.train_batches(spec.cell["traffic"], seed,
                                      shape.vocab)
    params = Wt.make(shape, seed, "cuda")
    step_fn, params, opt, got = drv.program_steps(h, shape, cfg, params,
                                                  batch_fn)
    del step_fn, params, opt
    torch.cuda.empty_cache()
    ref = drv.reference(h, shape, batch_fn)
    row = {"seed": seed, "program": compare.train_gaps(got, ref),
           "loss_program": got["loss"], "loss_reference": ref["loss"]}
    if control:
        row["control_fp8"] = compare.train_gaps(
            drv.reference(h, shape, batch_fn, prec="fp8"), ref)
        row["fault_half_batch"] = compare.train_gaps(
            drv.reference(h, shape, batch_fn, half_batch=True), ref)
    return row


def summarise(rows) -> dict:
    names = sorted({k for r in rows for k in r["program"]
                    if k != "tokens"})
    out = {}
    for n in names:
        lower = max(r["program"][n] for r in rows)
        uppers = [r[c][n] for r in rows for c in ("control_fp8",
                                                  "fault_half_batch")
                  if c in r and n in r[c]]
        upper = min(uppers) if uppers else None
        out[n] = {"lower": lower, "upper": upper,
                  "ratio": upper / lower if upper and lower else None,
                  "program": [r["program"][n] for r in rows],
                  "control": uppers}
    return {"summary": out}


if __name__ == "__main__":
    sys.exit(main())
