"""swatlint launcher for the port: analyze the serving matrix and gate on the
committed ANALYSIS_torch.json baseline (the port of the JAX package's
`launch/analyze.py`).

    PYTHONPATH=src python -m repro_torch.launch.analyze --check   # card
    PYTHONPATH=src python -m repro_torch.launch.analyze --device cpu --check
    PYTHONPATH=src python -m repro_torch.launch.analyze --device cpu --write

The matrix is the JAX analyzer's nine labels, in its order, with its
engine arguments: dense smoke llama (`single`), its SWAT twin on the
decode kernel (`swat_pallas`: on the card the fused #1 and, for chunks,
#2), speculative decoding (`spec_k2`), the slot-parallel 4x1 and the
tensor-parallel 2x2 meshes (`slot_parallel_4x1`, `tp_2x2`), the fault plan
on the 4x1 (`chaos_4x1`), the paged layout on one device and on the 4x1
(`paged_single`, `paged_slot_parallel_4x1`), and the device counters on
the 4x1 (`metrics_on`). A mesh label runs on a single-process `LocalMesh`
of its shape (`parse_mesh`), every shard on the one device; the JAX
launcher forces `--device-count` host devices for them, and this one
refuses a label whose mesh has more shards than `--device-count`.

Each engine's bodies run on seeded inputs (`analysis.tracer`), from params
made with seed 0; on the card every graph key is also captured and
replayed. The mesh collectives are what the mesh records (`launch/mesh.py`):
single-device entries and slot-parallel decode entries must issue none (an
ERROR otherwise), and every other mesh entry is held to its family's
blessed budget. The baseline is blessed on the CPU (`--device cpu
--write`); `--check` on the card holds the kernel path to it: zero errors,
and no warning count, lowering count or budget above the baseline's.
`--engines` restricts the matrix and the baseline it is checked against.
Each mesh family's collectives print beside the JAX package's committed
ANALYSIS.json (read as data): the port's explicit plan gathers otherwise
than XLA chooses to, so the counts differ; which families are
collective-free does not.

Runs on the card unless `--device cpu` is given; with no card it exits
non-zero. Exit codes: 0 clean, 1 baseline violations (errors, warning
growth, lowering growth), 2 stale baseline (new engines or families: bless
with --write in the same change that adds them).
"""
import argparse
import json
import os
import sys
from typing import Dict, List, Optional, Sequence, Tuple

# the JAX analyzer's matrix, in its order
MATRIX = ("single", "swat_pallas", "spec_k2", "slot_parallel_4x1", "tp_2x2",
          "chaos_4x1", "paged_single", "paged_slot_parallel_4x1",
          "metrics_on")
# the mesh of each mesh label
MESHES = {"slot_parallel_4x1": "4x1", "tp_2x2": "2x2", "chaos_4x1": "4x1",
          "paged_slot_parallel_4x1": "4x1", "metrics_on": "4x1"}
MESH_LABELS = tuple(label for label in MATRIX if label in MESHES)
JAX_BASELINE = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                            "ANALYSIS.json")


def shards(label: str) -> int:
    """The shards of a label's mesh (1 on one device)."""
    n = 1
    for d in MESHES.get(label, "1").split("x"):
        n *= int(d)
    return n


def check_label(label: str, device_count: int = 4) -> None:
    """Exit, as the JAX launcher does, on a label outside the matrix, and
    on a mesh of more shards than `device_count`."""
    if label not in MATRIX:
        raise SystemExit(f"unknown engine label: {label}")
    if shards(label) > device_count:
        raise SystemExit(f"{label}: its {MESHES[label]} mesh needs "
                         f"{shards(label)} devices, --device-count is "
                         f"{device_count}")


def build(label: str, device: str, params: Optional[Dict] = None):
    """The engine of a matrix label (the JAX matrix's arguments). `params`
    caches each config's params across calls."""
    from repro_torch.configs import get_smoke_config, with_swat
    from repro_torch.core import model as Mod
    from repro_torch.launch.mesh import parse_mesh
    from repro_torch.serving.engine import ServingEngine
    from repro_torch.serving.faults import FaultPlan

    check_label(label)
    params = {} if params is None else params
    dense = get_smoke_config("llama3p2_1b")
    swat = with_swat(dense, window=16, num_global=4)
    cfg = swat if label in ("swat_pallas", "paged_single") else dense
    if cfg.name not in params:
        params[cfg.name] = Mod.init_model(cfg, seed=0, device=device)
    p = params[cfg.name]
    kw = dict(batch_slots=2, max_len=128, scan_steps=4)
    if label in MESHES:
        kw["mesh"] = parse_mesh(MESHES[label])
        if MESHES[label] == "4x1":
            kw["batch_slots"] = 4
    if label == "swat_pallas":
        kw["scan_steps"] = 2
        if device == "cpu":
            # the kernel route, whose wrappers run their plain versions on
            # CPU tensors ("pallas" itself asks for the card)
            eng = ServingEngine(cfg, p, **kw)
            eng.decode_impl, eng._impl = "pallas", "kernel"
            return eng
        kw["decode_impl"] = "pallas"
    elif label == "spec_k2":
        kw["speculative"] = 2
    elif label in ("paged_single", "paged_slot_parallel_4x1"):
        kw["kv_layout"] = "paged"
    elif label == "metrics_on":
        kw["metrics"] = True
    elif label == "chaos_4x1":
        kw["faults"] = FaultPlan(poison_logits=((0, 3, "nan"),))
    return ServingEngine(cfg, p, **kw)


def jax_families(label: str) -> Dict[str, Tuple[Dict[str, int], float]]:
    """{family: (the largest count of each collective kind over its
    entries, the largest wire bytes)} in the JAX package's committed
    ANALYSIS.json, read as data ({} without the file or the label)."""
    path = os.path.abspath(JAX_BASELINE)
    if not os.path.exists(path):
        return {}
    with open(path) as f:
        eng = (json.load(f).get("engines") or {}).get(label) or {}
    return family_collectives(eng)


def family_collectives(eng: dict) -> Dict[str, Tuple[Dict[str, int], float]]:
    """{family: (largest count of each kind, largest wire bytes)} over a
    report section's entries."""
    out: Dict[str, Tuple[Dict[str, int], float]] = {}
    for e in (eng.get("entries") or {}).values():
        counts, wire = out.get(e["family"], ({}, 0.0))
        for kind, n in (e.get("collectives") or {}).items():
            counts[kind] = max(counts.get(kind, 0), n)
        out[e["family"]] = (counts, max(wire, e.get("wire_bytes", 0.0)))
    return out


def beside_jax(label: str, eng: dict) -> List[str]:
    """One line per family of a mesh label: the port's collectives and
    wire bytes beside the JAX package's."""
    theirs = jax_families(label)
    lines = []
    for fam, (counts, wire) in sorted(family_collectives(eng).items()):
        jc, jw = theirs.get(fam, ({}, 0.0))
        lines.append(f"[analyze] {label} {fam}: port {counts or 'none'} "
                     f"{wire:.0f} B; jax {jc or 'none'} {jw:.0f} B")
    return lines


def analyze_matrix(labels: Sequence[str], device: str,
                   baseline: Optional[dict] = None, write: bool = False,
                   log=print) -> Tuple[dict, Dict[str, object]]:
    """Build and analyze each engine of `labels` on `device`. Returns (the
    merged report, {label: engine})."""
    import torch
    from repro_torch.analysis import report as Rep

    base_engines = (baseline or {}).get("engines") or {}
    params: Dict = {}
    engines, per_engine = {}, {}
    for label in labels:
        log(f"[analyze] {label}: tracing...")
        eng = engines[label] = build(label, device, params)
        per_engine[label] = Rep.analyze_engine(
            eng, label=label,
            baseline=None if write else base_engines.get(label))
        s = per_engine[label]["summary"]
        log(f"[analyze] {label}: {s['entries']} entries, {s['errors']} "
            f"errors, {s['warnings']} warnings")
        if label in MESHES:
            for line in beside_jax(label, per_engine[label]):
                log(line)
    kind = (torch.cuda.get_device_name(0) if device.startswith("cuda")
            else "cpu")
    return Rep.merge_reports(per_engine, meta={
        "torch": torch.__version__, "device": kind,
        "matrix": list(labels)}), engines


def restrict(baseline: Optional[dict], labels: Sequence[str]
             ) -> Optional[dict]:
    """The baseline's sections for `labels` only."""
    if baseline is None:
        return None
    engines = baseline.get("engines") or {}
    return {**baseline, "engines": {k: v for k, v in engines.items()
                                    if k in labels}}


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--check", action="store_true",
                    help="diff against the committed ANALYSIS_torch.json and "
                         "exit nonzero on violations")
    ap.add_argument("--write", action="store_true",
                    help="bless this run as the new baseline")
    ap.add_argument("--baseline", default=None,
                    help="baseline path (default: repo-root "
                         "ANALYSIS_torch.json)")
    ap.add_argument("--engines", default=None,
                    help="comma list to restrict the matrix, e.g. "
                         "'single,paged_single'")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="cuda (default) or cpu (the kernels' plain "
                         "versions)")
    ap.add_argument("--device-count", type=int, default=4,
                    help="the most shards a mesh label may have (the JAX "
                         "launcher's forced host devices)")
    args = ap.parse_args(argv)

    import torch

    from repro_torch.analysis import baselines

    labels = list(MATRIX)
    if args.engines:
        labels = [x.strip() for x in args.engines.split(",") if x.strip()]
    for label in labels:           # refuse before building anything
        check_label(label, args.device_count)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("[analyze] no CUDA device: the port analyzes on "
                         "the card (pass --device cpu to analyze the plain "
                         "versions on the CPU)")

    baseline = restrict(baselines.load(args.baseline), labels)
    fresh, _ = analyze_matrix(labels, args.device, baseline,
                              write=args.write,
                              log=lambda m: print(m, flush=True))
    for label, eng in fresh["engines"].items():
        for f in eng["findings"]:
            d = f["details"]
            at = ", ".join(d.get("at") or ()) or d.get("site")
            print(f"[analyze] {label} {f['severity']} {f['rule']} "
                  f"{f['entry']} at {at}: {f['message']}")

    if args.write:
        path = baselines.save(fresh, args.baseline)
        print(f"[analyze] wrote baseline: {path}")
        print(json.dumps(fresh["summary"]))
        return 0

    violations = baselines.diff(fresh, baseline)
    stale = baselines.is_stale(fresh, baseline)
    for v in violations:
        print(f"[analyze] VIOLATION: {v}")
    for s in stale:
        print(f"[analyze] STALE BASELINE: {s}")
    if not violations and not stale:
        print(f"[analyze] clean: {json.dumps(fresh['summary'])}")
    if args.check:
        return 1 if violations else (2 if stale else 0)
    return 0


if __name__ == "__main__":
    sys.exit(main())
