"""swatlint on a mesh (the five mesh labels of the JAX analyzer's matrix)
on the CPU, held against the JAX package's committed ANALYSIS.json (its
mesh engines need a forced 4-device XLA, so the committed file is the
oracle):

  * each label's entry names and tags equal the JAX file's, and every
    entry the JAX file records collective-free is collective-free in the
    port: every decode hot-path entry of the slot-parallel engines above
    all;
  * zero errors, the fresh run within the committed ANALYSIS_torch.json
    and its budgets, and `--write` reproduces each mesh section;
  * an all-gather over the slot axis in a 4x1 decode body is a
    `collectives` ERROR (the twin of the JAX package's
    `test_slot_axis_allgather_caught_under_mesh`);
  * the analyzed mesh engines serve the single-device engine's tokens
    (the 4x1 labels) or an unanalyzed twin's (tp_2x2);
  * the mesh's record against the c10d ops of a two-process gloo
    ProcessMesh: psum, all_gather, reduce_scatter and all_to_all agree,
    size-1 axes not counted, and a LocalMesh records the same program
    alike.
"""
import dataclasses
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.analysis import baselines
from repro_torch.analysis import collectives as C
from repro_torch.analysis import report as Rep
from repro_torch.analysis import rules as R
from repro_torch.analysis import tracer as T
from repro_torch.configs import get_smoke_config
from repro_torch.core import model as Mod
from repro_torch.launch import analyze as A
from repro_torch.launch.mesh import LocalMesh
from repro_torch.serving.engine import Request, ServingEngine
from repro_torch.serving.faults import FaultPlan

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
MESH = A.MESH_LABELS
SLOT_PARALLEL = tuple(label for label in MESH if A.MESHES[label] == "4x1")


@pytest.fixture(scope="module")
def fresh():
    """The five mesh labels analyzed once on the CPU against the committed
    baseline: (report, engines)."""
    base = A.restrict(baselines.load(), MESH)
    return A.analyze_matrix(MESH, "cpu", base, log=lambda m: None)


@pytest.fixture(scope="module")
def jax_base():
    return json.loads((ROOT / "ANALYSIS.json").read_text())


def test_matrix_is_the_jax_one(jax_base):
    assert list(A.MATRIX) == jax_base["meta"]["matrix"]
    assert set(MESH) == {"slot_parallel_4x1", "tp_2x2", "chaos_4x1",
                         "paged_slot_parallel_4x1", "metrics_on"}


@pytest.mark.parametrize("label", MESH)
def test_entry_names_and_tags_equal_jax(fresh, jax_base, label):
    report, engines = fresh
    theirs = jax_base["engines"][label]["entries"]
    ours = report["engines"][label]["entries"]
    # the JAX file keeps its entries sorted by name
    assert sorted(p.name for p in T.engine_entry_points(engines[label])) \
        == sorted(theirs)
    assert {k: e["tags"] for k, e in ours.items()} == \
        {k: e["tags"] for k, e in theirs.items()}
    assert {k: e["family"] for k, e in ours.items()} == \
        {k: e["family"] for k, e in theirs.items()}


@pytest.mark.parametrize("label", MESH)
def test_jax_collective_free_entries_are_collective_free(fresh, jax_base,
                                                         label):
    """What must equal JAX is which entries issue no collective over an
    axis of more than one shard, not the counts (the port's plan gathers
    where XLA chooses otherwise); slot-parallel decode issues none."""
    ours = fresh[0]["engines"][label]["entries"]
    free = [k for k, e in jax_base["engines"][label]["entries"].items()
            if not e["collectives"]]
    assert free
    for k in free:
        assert ours[k]["collectives"] == {} and ours[k]["wire_bytes"] == 0, k
    if label in SLOT_PARALLEL:
        hot = [k for k, e in ours.items() if "decode_hot_path" in e["tags"]]
        assert hot and set(hot) <= set(free)


def test_zero_errors_within_the_committed_baseline(fresh):
    report, _ = fresh
    base = A.restrict(baselines.load(), MESH)
    assert report["summary"]["errors"] == 0
    assert baselines.diff(report, base) == []
    assert baselines.is_stale(report, base) == []
    for label in MESH:
        eng = report["engines"][label]
        assert eng["budgets"] == base["engines"][label]["budgets"]
        # every family whose entries may issue collectives has a budget
        nonhot = {e["family"] for e in eng["entries"].values()
                  if "tp" in e["tags"] or "decode_hot_path" not in e["tags"]}
        assert set(eng["budgets"]) == nonhot, label
        for e in eng["entries"].values():
            assert e["shards"] == 4 and e["carries_in_place"] in (True, None)


def test_tp_entries_take_their_blessed_budgets(fresh):
    """The 2x2 decode reduces over 'model' (a TP layer's psums and the
    gathered ring) within the budget blessed for its family."""
    eng = fresh[0]["engines"]["tp_2x2"]
    scan = eng["entries"]["scan[n=4,slots=2]"]
    assert scan["collectives"].get("all_reduce") and \
        scan["collectives"].get("all_gather")
    allow = eng["budgets"]["scan"]["allow"]
    assert all(n <= allow[k] for k, n in scan["collectives"].items())


def test_mesh_entry_over_its_blessed_budget_is_an_error(fresh):
    """A tp entry takes no budget in bless mode, passes its blessed one,
    and one collective fewer allowed of each kind gives ERRORs; a budget
    family the baseline lacks makes it stale."""
    report, engines = fresh
    point = [p for p in T.engine_entry_points(engines["tp_2x2"])
             if p.name == "scan[n=4,slots=2]"][0]
    tr = T.trace(point)
    blessed = report["engines"]["tp_2x2"]["budgets"]
    assert R.budget_for(tr) is None
    assert R.check_collectives(tr, R.budget_for(tr, blessed)) == []
    tight = {"scan": {**blessed["scan"], "allow": {
        k: n - 1 for k, n in blessed["scan"]["allow"].items()}}}
    f = R.check_collectives(tr, R.budget_for(tr, tight))
    assert len(f) == len(tight["scan"]["allow"])
    assert {(x.rule, x.severity) for x in f} == {("collectives", "error")}
    base = json.loads(json.dumps(A.restrict(baselines.load(), MESH)))
    del base["engines"]["tp_2x2"]["budgets"]["scan"]
    assert baselines.is_stale(report, base) == [
        "[tp_2x2] new budget family `scan` not in baseline"]


def test_live_warnings_are_the_chunk_keys_and_the_paged_gather(fresh):
    for label, eng in fresh[0]["engines"].items():
        rules = sorted({(f["rule"], f["severity"]) for f in eng["findings"]})
        want = [("recompile", "warn")]
        if label == "paged_slot_parallel_4x1":
            want.append(("paged_gather_fallback", "warn"))
        assert rules == sorted(want), label


def test_metrics_engine_scans_are_telemetry_clean(fresh):
    report, _ = fresh
    scans = {k: e for k, e in report["engines"]["metrics_on"]["entries"]
             .items() if k.startswith("scan")}
    assert scans and all("metrics" in e["tags"] for e in scans.values())
    assert not [f for f in report["engines"]["metrics_on"]["findings"]
                if f["rule"] == "telemetry"]


def test_launcher_write_reproduces_the_mesh_sections(tmp_path):
    p = tmp_path / "A.json"
    assert A.main(["--device", "cpu", "--engines", ",".join(MESH),
                   "--baseline", str(p), "--write"]) == 0
    committed = baselines.load()
    written = json.loads(p.read_text())
    for label in MESH:
        assert written["engines"][label] == committed["engines"][label], \
            label


def test_slot_axis_allgather_is_caught(fresh):
    """A 4x1 decode body that all-gathers a slot vector over 'data' gives
    a collectives ERROR; the same body without it is clean."""
    _, engines = fresh
    eng = engines["slot_parallel_4x1"]
    scan = [p for p in T.engine_entry_points(eng) if p.family == "scan"][-1]
    mp = eng._mp

    def leaky():
        scan.body()
        mp.gather_slots(mp.local_rows(eng._dev["tok"], eng._lo))
    for body, want in ((scan.body, []), (leaky, [("collectives", "error")])):
        tr = T.trace(dataclasses.replace(scan, body=body))
        f = R.check_collectives(tr, R.budget_for(tr))
        assert [(x.rule, x.severity) for x in f] == want
    assert tr.record == [("all_gather", "data", 16)]
    assert "collective-free entry emits 1" in f[0].message


def _twin(label, params):
    """The single-device engine of a 4x1 label's arguments."""
    kw = dict(batch_slots=4, max_len=128, scan_steps=4)
    kw.update({"slot_parallel_4x1": {},
               "paged_slot_parallel_4x1": dict(kv_layout="paged"),
               "metrics_on": dict(metrics=True),
               "chaos_4x1": dict(faults=FaultPlan(
                   poison_logits=((0, 3, "nan"),)))}[label])
    return ServingEngine(get_smoke_config("llama3p2_1b"), params, **kw)


@pytest.mark.parametrize("label", MESH)
def test_analyzed_mesh_engine_serves_the_same_tokens(label):
    """Analyzed between runs (every shard's caches, tables and counters
    live), a mesh engine serves what the single-device engine serves
    (slot-parallel is bitwise), or, at 2x2, what an unanalyzed twin
    serves; statuses and counters too."""
    rng = np.random.RandomState(1)
    prompts = [rng.randint(0, 256, (n,)).astype(np.int32)
               for n in (9, 20, 33, 14, 5)]

    def serve(eng):
        return [(r.tokens, r.status) for r in eng.run(
            [Request(rid=i, prompt=p, max_new_tokens=10)
             for i, p in enumerate(prompts)])]
    params = {}
    analyzed = A.build(label, "cpu", params)
    plain = (A.build(label, "cpu", params) if label == "tp_2x2"
             else _twin(label, next(iter(params.values()))))
    first = serve(plain)
    assert serve(analyzed) == first
    Rep.analyze_engine(analyzed, label=label)
    assert serve(analyzed) == serve(plain)
    assert analyzed.device_metrics() == plain.device_metrics()
    if label == "chaos_4x1":
        assert first[0][1] == "poisoned" and len(first[0][0]) == 3


RANK = """
import datetime, json, sys, torch
import torch.distributed as dist
torch.set_num_threads(1)
rank, d = int(sys.argv[1]), sys.argv[2]
dist.init_process_group("gloo", init_method=f"file://{d}/pg", rank=rank,
                        world_size=2,
                        timeout=datetime.timedelta(seconds=60))
from repro_torch.analysis import collectives as C
from repro_torch.analysis import tracer as T
from repro_torch.launch.mesh import parse_mesh
mesh = parse_mesh("2x1", process=True, device_type="cpu")
x = torch.arange(24.0).reshape(4, 6) + rank
rec = T._Recorder()
with torch.no_grad(), mesh.recording() as record, rec:
    for axis in ("data", "model"):
        mesh.psum([x], axis)
        mesh.all_gather([x], axis, 0)
        mesh.reduce_scatter([x], axis, 0)
        mesh.all_to_all([x], axis, 0, 1)
        mesh.pmax([x], axis)
sizes = [dict(op.scalars).get("group_size") for op in rec.ops
         if C.is_collective(op.name)]
json.dump({"record": record, "issued": C.issued(rec.ops),
           "sizes": sizes, "disagree": C.disagreement(rec.ops, record),
           "calls": mesh.calls, "wire": mesh.wire_ops},
          open(f"{d}/out{rank}.json", "w"))
dist.destroy_process_group()
"""


def test_process_mesh_record_agrees_with_its_c10d_ops(tmp_path):
    """Two gloo ranks on a 2x1 mesh issue each collective over 'data' (2
    ranks) and 'model' (1 rank): the c10d ops of both axes reach the op
    log, the one-rank ones are left out of `issued` as the record leaves
    them out, and record and op log agree kind by kind in count and
    bytes. A 2x1 LocalMesh running the same program on both shards
    records the same entries."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               GLOO_SOCKET_IFNAME="lo")
    procs = [subprocess.Popen(
        [sys.executable, "-c", textwrap.dedent(RANK), str(r),
         str(tmp_path)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for r in range(2)]
    try:
        outs = [p.communicate(timeout=120) for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, (_, err) in zip(procs, outs):
        assert p.returncode == 0, err
    want = [["all_reduce", "data", 96], ["all_gather", "data", 192],
            ["reduce_scatter", "data", 48], ["all_to_all", "data", 96],
            ["all_reduce", "data", 96]]
    for r in range(2):
        got = json.loads((tmp_path / f"out{r}.json").read_text())
        assert got["record"] == want
        assert got["disagree"] == []
        assert sorted(got["sizes"]) == [1] * 5 + [2] * 5
        assert [k for k, _ in got["issued"]] == [k for k, _, _ in want]
        assert got["calls"] == {"all_reduce": 4, "all_gather": 2,
                                "reduce_scatter": 2, "all_to_all": 2,
                                "p2p": 0} and got["wire"] == 5

    local = LocalMesh((2, 1), ("data", "model"))
    xs = [torch.arange(24.0).reshape(4, 6) + r for r in range(2)]
    with local.recording() as record:
        for axis in ("data", "model"):
            local.psum(xs, axis)
            local.all_gather(xs, axis, 0)
            local.reduce_scatter(xs, axis, 0)
            local.all_to_all(xs, axis, 0, 1)
            local.pmax(xs, axis)
    assert [list(e) for e in record] == want
    assert C.record_stats(record).counts == {
        "all_reduce": 2, "all_gather": 1, "reduce_scatter": 1,
        "all_to_all": 1}


def test_one_shard_meshes_are_collective_free():
    """A 1x1 LocalMesh records nothing, so its decode is collective-free
    by the same rule as a one-rank process group's."""
    cfg = get_smoke_config("llama3p2_1b")
    eng = ServingEngine(cfg, Mod.init_model(cfg, seed=0, device="cpu"),
                        batch_slots=2, max_len=128, scan_steps=2,
                        mesh=LocalMesh((1, 1), ("data", "model")))
    assert T.engine_tags(eng) == frozenset({"slot_parallel"})
    rep = Rep.analyze_engine(eng, label="one")
    assert rep["summary"]["errors"] == 0
    assert all(not e["collectives"] for e in rep["entries"].values())
