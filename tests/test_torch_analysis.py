"""The port's swatlint (`repro_torch.analysis`, `launch/analyze.py`) on the
CPU, held against the JAX package's analyzer, on the matrix's four
single-device engines (the five mesh labels: tests/test_torch_analysis_mesh.py):

  * the port's entry names equal the JAX `engine_entry_points` names on a
    JAX engine built with the same arguments, and the port's errors per
    label equal the committed ANALYSIS.json's (zero);
  * each rule family fires on a deliberately broken toy body and stays
    quiet on its clean twin (the counterparts of tests/test_analysis.py);
  * tracing is repeatable and undone: twice gives the same op log, and an
    analyzed engine serves the tokens of an engine never analyzed;
  * the committed ANALYSIS_torch.json, the baseline gates and the
    launcher's exit codes.
"""
import json
import re
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.analysis import tracer as JT
from repro.configs import get_smoke_config as jax_smoke
from repro.configs import with_swat as jax_swat
from repro.core import model as JM
from repro.serving.engine import ServingEngine as JEngine
from repro_torch.analysis import baselines
from repro_torch.analysis import collectives as C
from repro_torch.analysis import report as Rep
from repro_torch.analysis import rules as R
from repro_torch.analysis import tracer as T
from repro_torch.core import model as Mod
from repro_torch.kernels import swat_decode
from repro_torch.launch import analyze as A
from repro_torch.serving.engine import Request

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
SHARED = ("single", "swat_pallas", "spec_k2", "paged_single")
BIG = (512, 512)                 # 1 MiB fp32: over the generic threshold


@pytest.fixture(scope="module")
def fresh():
    """The matrix's single-device engines, analyzed once on the CPU:
    (report, engines)."""
    return A.analyze_matrix(SHARED, "cpu", log=lambda m: None)


def point(body, carries=None, tags=frozenset(), name="toy", **kw):
    return T.EntryPoint(name=name, family=name, body=body,
                        carries=carries or dict, tags=tags, **kw)


# ---------------------------------------------------- against the JAX one --

def _jax_engine(label):
    """The JAX analyzer's engine of `label` (launch/analyze.py's build)."""
    dense = jax_smoke("llama3p2_1b")
    cfg = (jax_swat(dense, window=16, num_global=4)
           if label in ("swat_pallas", "paged_single") else dense)
    params = JM.init_model(jax.random.PRNGKey(0), cfg)
    kw = dict(batch_slots=2, max_len=128, scan_steps=4)
    kw.update({"single": {},
               "swat_pallas": dict(scan_steps=2, decode_impl="pallas"),
               "spec_k2": dict(speculative=2),
               "paged_single": dict(kv_layout="paged")}[label])
    return JEngine(cfg, params, **kw)


@pytest.mark.parametrize("label", SHARED)
def test_entry_names_equal_jax(fresh, label):
    _, engines = fresh
    ours = [p.name for p in T.engine_entry_points(engines[label])]
    theirs = [p.name for p in JT.engine_entry_points(_jax_engine(label))]
    assert ours == theirs
    assert sorted(fresh[0]["engines"][label]["entries"]) == sorted(theirs)


def test_errors_per_shared_label_equal_jax_baseline(fresh):
    jax_base = json.loads((ROOT / "ANALYSIS.json").read_text())
    for label in SHARED:
        want = jax_base["engines"][label]["summary"]["errors"]
        assert fresh[0]["engines"][label]["summary"]["errors"] == want == 0


def test_fresh_matrix_matches_committed_baseline(fresh):
    """Zero errors on the four engines, within the committed baseline, and
    every warning names its rule and the port's call site."""
    report, _ = fresh
    base = A.restrict(baselines.load(), SHARED)
    assert report["summary"]["errors"] == 0
    assert baselines.diff(report, base) == []
    assert baselines.is_stale(report, base) == []
    for eng in report["engines"].values():
        for f in eng["findings"]:
            assert f["details"]["site"].startswith("repro_torch/"), f
    hot = [e for eng in report["engines"].values()
           for e in eng["entries"].values()
           if "decode_hot_path" in e["tags"]]
    assert hot and all(e["carries_in_place"] and not e["collectives"]
                       for e in hot)


def test_live_warnings_are_the_chunk_keys_and_the_paged_gather(fresh):
    report, _ = fresh
    for label, eng in report["engines"].items():
        rules = sorted({(f["rule"], f["severity"]) for f in eng["findings"]})
        want = [("recompile", "warn")]
        if label == "paged_single":
            want.append(("paged_gather_fallback", "warn"))
        assert rules == sorted(want), label
        chunk = [k for k in eng["entries"] if k.startswith("prefill_chunk")]
        assert eng["summary"]["warnings"] == len(chunk) + (
            label == "paged_single")


# ---------------------------------------------------------------- donation --

def test_rebound_carry_is_caught():
    state = {"c": torch.zeros(BIG)}

    def body():
        state["c"] = state["c"] + 1.0
    tr = T.trace(point(body, lambda: {"c": state["c"]}))
    f = R.check_donation(tr)
    assert [(x.rule, x.severity) for x in f] == [("donation", "error")]
    assert tr.rebound == ["c"]
    assert not R.check_host_sync(tr) and not R.check_dtype_promotion(tr)


def test_in_place_carry_is_clean():
    c = torch.zeros(BIG)
    tr = T.trace(point(lambda: c.add_(1.0), lambda: {"c": c}))
    assert R.check_donation(tr) == [] and R.carry_copies(tr) == []
    assert float(c.sum()) == 0.0               # the run was undone


@pytest.mark.parametrize("shape,warns", [(BIG, 1), ((8, 8), 0)])
def test_forgotten_full_size_copy_gives_the_generic_warn(shape, warns):
    """A carry written by a copy of a tensor built out of place: WARN at or
    above the JAX threshold, recorded in carry_copies below it."""
    c = torch.ones(shape)
    tr = T.trace(point(lambda: c.copy_(c * 2.0), lambda: {"c": c}))
    f = R.check_donation(tr)
    assert [(x.rule, x.severity) for x in f] == [("donation", "warn")] * warns
    copies = R.carry_copies(tr)
    assert len(copies) == 1 and copies[0]["carry"] == "c"
    assert copies[0]["site"].startswith("test_torch_analysis.py:")


# --------------------------------------------------------------- host sync --

@pytest.mark.parametrize("tags,severity", [
    (frozenset({"decode_hot_path"}), "error"), (frozenset(), "warn")])
def test_item_is_error_on_the_hot_path_and_warn_elsewhere(tags, severity):
    x = torch.arange(8.0)
    tr = T.trace(point(lambda: x.sum().item(), tags=tags))
    f = R.check_host_sync(tr)
    assert [(x.rule, x.severity) for x in f] == [("host_sync", severity)]
    assert f[0].details["op"] == "aten::_local_scalar_dense"


def test_clean_decode_body_has_no_host_sync(fresh):
    """No hot-path entry of the matrix (scan, spec_scan, the paged fixup)
    holds an op that waits for the device."""
    report, _ = fresh
    for label in ("single", "spec_k2", "paged_single"):
        eng = report["engines"][label]
        hot = [n for n, e in eng["entries"].items()
               if "decode_hot_path" in e["tags"]]
        assert hot, label
        assert not [f for f in eng["findings"] if f["rule"] == "host_sync"
                    and f["entry"] in hot], label


def test_upload_is_an_error_only_inside_a_captured_body():
    """A blocking host-to-device copy (here to the meta device, which
    stands in for the card) is an ERROR inside a captured body (a capture
    refuses it) and on the hot path, and a WARN between the bodies of any
    other entry; the report counts its bytes once."""
    x = torch.arange(8.0)
    for key, tags, severity in ((("decode", 1), frozenset(), "error"),
                                (None, frozenset({"decode_hot_path"}),
                                 "error"),
                                (None, frozenset(), "warn")):
        tr = T.trace(point(lambda: x.to("meta"), graph_key=key, tags=tags))
        assert len(R.uploads(tr)) == 1
        f = R.check_host_sync(tr)
        assert [(x.severity, x.details["op"]) for x in f] == [
            (severity, "aten::_to_copy")]
    y = torch.empty(8, device="meta")
    rep = Rep.analyze_entry_points([point(lambda: y.copy_(x))])
    entry = rep["entries"]["toy"]
    assert (entry["uploads"], entry["upload_bytes"]) == (1, 32)


def test_device_to_host_copy_waits_for_the_device():
    dev = T.OpTensor((4,), "float32", "cuda", 1, 16)
    host = T.OpTensor((4,), "float32", "cpu", 2, 16)
    d2h = T.OpRecord("aten::_to_copy", (dev,), (host,), ())
    h2d = T.OpRecord("aten::copy_", (dev, host), (dev,), (dev,))
    assert R.transfer(d2h) == "d2h" and R.waits_for_device(d2h)
    assert R.transfer(h2d) == "h2d" and R.waits_for_device(h2d)


_DEV = T.OpTensor((4,), "int64", "cuda", 1, 32)
_HOST = T.OpTensor((4,), "int64", "cpu", 2, 32)


@pytest.mark.parametrize("op,waits", [
    # copy_ and .to() with non_blocking=False synchronize the stream
    (T.OpRecord("aten::copy_", (_DEV, _HOST), (_DEV,), (_DEV,),
                (("non_blocking", False), ("src_pinned", True))), True),
    # a pageable source makes even a non_blocking copy wait
    (T.OpRecord("aten::_to_copy", (_HOST,), (_DEV,), (),
                (("non_blocking", True), ("src_pinned", False))), True),
    # from pinned memory with non_blocking: the host goes on at once
    (T.OpRecord("aten::_to_copy", (_HOST,), (_DEV,), (),
                (("non_blocking", True), ("src_pinned", True))), False),
    # `torch.as_tensor(list, device=...)`: the constructor's copy
    (T.OpRecord("aten::lift_fresh", (_DEV,), (_DEV,), ()), True),
    (T.OpRecord("aten::lift_fresh", (_HOST,), (_HOST,), ()), False)])
def test_blocking_uploads_wait_for_the_device(op, waits):
    assert R.waits_for_device(op) is waits
    hot = T.TracedEntry(point(lambda: None,
                              tags=frozenset({"decode_hot_path"})),
                        [op], [], {}, [], {}, "k")
    f = R.check_host_sync(hot)
    assert [(x.rule, x.severity) for x in f] == [("host_sync",
                                                  "error")] * waits


def test_repeat_interleave_and_bool_indexing_wait_for_the_device():
    x, r = torch.arange(4.0), torch.tensor([1, 2, 1, 1])
    mask = x > 1.0

    def body():
        torch.repeat_interleave(x, r)
        torch.repeat_interleave(x, r, output_size=5)
        x[mask]
    tr = T.trace(point(body, tags=frozenset({"decode_hot_path"})))
    ops = sorted(f.details["op"] for f in R.check_host_sync(tr))
    assert "aten::repeat_interleave.Tensor" in ops
    assert "aten::index.Tensor" in ops
    rep = [op for op in tr.ops if op.name == "aten::repeat_interleave.Tensor"]
    assert [R.waits_for_device(op) for op in rep] == [True, False]


# --------------------------------------------------------- dtype promotion --

def test_bf16_upcast_feeding_mm_is_caught():
    a = torch.randn(16, 16).bfloat16()
    tr = T.trace(point(lambda: a.float() @ a.float()))
    f = R.check_dtype_promotion(tr)
    assert [(x.rule, x.severity) for x in f] == [("dtype_promotion", "warn")]
    assert f[0].details["op"] == "aten::mm"


def test_mm_with_out_dtype_float32_is_clean():
    """fp32 accumulation of bf16 operands (`aten::mm.dtype`, the card's
    unembed; it has no CPU kernel, so on meta tensors) is not an upcast."""
    a = torch.empty(16, 16, dtype=torch.bfloat16, device="meta")
    tr = T.trace(point(lambda: torch.mm(a, a, out_dtype=torch.float32)))
    assert [op.name for op in tr.ops] == ["aten::mm.dtype"]
    assert R.check_dtype_promotion(tr) == []


def test_head_product_under_autograd_on_bf16_is_caught():
    """The 7b fp32 head copy: under autograd `_head_product` upcasts both
    operands, and the rule names its line."""
    x = torch.randn(4, 32).bfloat16().requires_grad_()
    head = torch.randn(32, 64).bfloat16().requires_grad_()

    def body():
        with torch.enable_grad():
            Mod._head_product(x, head).sum().backward()
    tr = T.trace(point(body))
    sites = [x.details["site"] for x in R.check_dtype_promotion(tr)]
    # the forward's product at its line; the backward's products run in
    # the autograd engine, under the test's `backward()` call
    assert any(s.startswith("repro_torch/core/model.py:") for s in sites)


# -------------------------------------------------------------- collectives --

def test_collective_budget_check():
    t = T.OpTensor((128,), "float32", "cpu", 1, 512)
    ops = [T.OpRecord("_c10d_functional::all_reduce", (t,), (t,), ()),
           T.OpRecord("_c10d_functional::wait_tensor", (t,), (t,), ()),
           T.OpRecord("c10d::allgather_", (t,), (), ()),
           T.OpRecord("aten::add.Tensor", (t, t), (t,), ())]
    st = C.collective_stats(ops)
    assert st.counts == {"all_reduce": 1, "allgather_": 1}
    # the JAX parser's factors: an all-reduce 2x its bytes, a gather 1x
    assert st.wire_bytes == 2 * 512 + 512
    viol = C.check_budget(st, C.CollectiveBudget.collective_free())
    assert len(viol) == 2 and all("collective-free" in v for v in viol)
    blessed = C.CollectiveBudget.from_counts(st.counts, st.wire_bytes)
    assert C.check_budget(st, blessed) == []
    tight = C.CollectiveBudget(allow=(("all_reduce", 1),), max_wire_bytes=1.0)
    viol = C.check_budget(st, tight)
    assert any("wire bytes" in v for v in viol)
    assert any("budget allows 0" in v or "allgather_" in v for v in viol)


def test_traced_collective_breaks_the_single_device_budget(tmp_path,
                                                          monkeypatch):
    """A real functional all-reduce (gloo, one rank on the loopback
    interface, a file store) in a single-device body is one collective,
    and an ERROR."""
    import torch.distributed as dist
    import torch.distributed._functional_collectives as fc
    monkeypatch.setenv("GLOO_SOCKET_IFNAME", "lo")
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            world_size=1, rank=0)
    try:
        x = torch.ones(32)
        tr = T.trace(point(lambda: fc.all_reduce(x, "sum", dist.group.WORLD)
                           .wait(), tags=frozenset({"single"})))
    finally:
        dist.destroy_process_group()
    st = C.collective_stats(tr.ops)
    assert st.counts == {"all_reduce": 1} and st.wire_bytes == 2 * 128
    f = R.check_collectives(tr, R.budget_for(tr))
    assert [(x.rule, x.severity) for x in f] == [("collectives", "error")]


# --------------------------------------------------------------- telemetry --

def _mx_point(body, mx, tags=frozenset({"metrics", "decode_hot_path"})):
    return point(body, lambda: {f"mx.{k}": v for k, v in mx.items()},
                 tags=tags)


def test_telemetry_clean_on_int32_counters_updated_in_place():
    mx = {"tokens": torch.zeros(4, dtype=torch.int32)}
    tr = T.trace(_mx_point(lambda: mx["tokens"].add_(1), mx))
    assert R.check_telemetry(tr) == []


def test_telemetry_catches_a_non_int32_counter():
    mx = {"tokens": torch.zeros(4, dtype=torch.float32)}
    tr = T.trace(_mx_point(lambda: mx["tokens"].add_(1), mx))
    assert [(x.rule, x.severity) for x in R.check_telemetry(tr)] == [
        ("telemetry", "error")]


def test_telemetry_catches_a_rebound_counter():
    mx = {"tokens": torch.zeros(4, dtype=torch.int32)}

    def body():
        mx["tokens"] = mx["tokens"] + 1
    f = R.check_telemetry(T.trace(_mx_point(body, mx)))
    assert [(x.rule, x.severity) for x in f] == [("telemetry", "error")]
    assert f[0].details["counters"] == ["mx.tokens"]


def test_telemetry_catches_a_host_read_of_a_counter():
    mx = {"tokens": torch.zeros(4, dtype=torch.int32)}
    f = R.check_telemetry(T.trace(_mx_point(
        lambda: mx["tokens"].max().item(), mx)))
    assert f == []       # reads a new tensor: the reduction's, not the carry
    f = R.check_telemetry(T.trace(_mx_point(
        lambda: mx["tokens"][0].item(), mx)))
    assert [(x.rule, x.severity) for x in f] == [("telemetry", "error")]


# --------------------------------------------------------------- recompile --

def test_lowering_cap_and_the_pos0_key_warn():
    x = torch.zeros(4)
    a = T.trace(point(lambda: x + 1, name="fam", graph_key=("k", 1)))
    b = T.trace(point(lambda: x + 1, name="fam", graph_key=("k", 2)))
    assert a.compile_key != b.compile_key
    f = R.audit_recompiles([a, b], max_per_family={"fam": 1})
    assert [(x.rule, x.severity) for x in f] == [("recompile", "error")]
    assert R.audit_recompiles([a, b], max_per_family={"fam": 2}) == []
    chunk = T.trace(point(lambda: x + 1, name="fam",
                          graph_key=("chunk", 1, 32, 32), host_key=("pos0",)))
    f = R.audit_recompiles([chunk], max_per_family={"fam": 1})
    assert [(x.rule, x.severity) for x in f] == [("recompile", "warn")]
    assert f[0].details["site"].startswith("test_torch_analysis.py:")


def test_eager_compile_keys_follow_the_input_signature():
    x, y = torch.zeros(4), torch.zeros(8)
    keys = {T.trace(point(lambda: None, inputs=(("x", t),))).compile_key
            for t in (x, x.clone(), y)}
    assert len(keys) == 2


# ----------------------------------------------------------- paged gather --

def test_paged_gather_event_becomes_a_warn():
    swat_decode.consume_pad_events()
    swat_decode.record_paged_fallback(nb=4, page=16, reason="table outside")
    swat_decode.record_paged_fallback(nb=4, page=16, reason="table outside")
    events = swat_decode.consume_pad_events()
    assert [e["kind"] for e in events] == ["paged_gather"]
    assert swat_decode.consume_pad_events() == []          # drained
    rep = Rep.analyze_entry_points([], pad_events=events, label="kern")
    assert rep["summary"]["warnings"] == 1
    f = rep["findings"][0]
    assert f["rule"] == "paged_gather_fallback"
    assert f["details"]["site"].startswith("repro_torch/core/layers.py:")


# ---------------------------------------------------- repeatable, undone --

def test_tracing_twice_gives_the_same_op_log(fresh):
    _, engines = fresh
    for label in ("spec_k2", "paged_single"):
        for p in T.engine_entry_points(engines[label]):
            assert T.trace(p).canonical() == T.trace(p).canonical(), p.name


@pytest.mark.parametrize("label", ["spec_k2", "paged_single",
                                   "metrics_on"])
def test_analyzed_engine_serves_the_same_tokens(label):
    """Analyzed between runs (caches, tables and counters live), an engine
    serves the tokens (and counts) of an engine never analyzed."""
    rng = np.random.RandomState(1)
    prompts = [rng.randint(0, 256, (n,)).astype(np.int32)
               for n in (9, 20, 33, 14, 5)]

    def serve(eng):
        return [r.tokens for r in eng.run(
            [Request(rid=i, prompt=p, max_new_tokens=10)
             for i, p in enumerate(prompts)])]
    plain, analyzed = A.build(label, "cpu"), A.build(label, "cpu")
    assert serve(analyzed) == serve(plain)
    Rep.analyze_engine(analyzed, label=label)
    assert serve(analyzed) == serve(plain)
    assert analyzed.stats == plain.stats | {
        k: analyzed.stats[k] for k in ("prefill_s", "decode_s")}
    assert analyzed.device_metrics() == plain.device_metrics()


# ------------------------------------------------------- baselines, CLI --

def _fake_report(errors=0, warns=0, lowerings=None):
    findings = ([{"rule": "donation", "severity": "error", "entry": "e",
                  "message": "m", "details": {}}] * errors
                + [{"rule": "host_sync", "severity": "warn", "entry": "e",
                    "message": "m", "details": {}}] * warns)
    return {"swatlint": 1, "meta": {},
            "engines": {"single": {"entries": {},
                                   "lowerings": lowerings or {"scan": 1},
                                   "budgets": {}, "findings": findings,
                                   "summary": {"errors": errors,
                                               "warnings": warns,
                                               "entries": 0}}},
            "summary": {"errors": errors, "warnings": warns, "entries": 0}}


def test_baseline_diff_and_stale_gates():
    base = _fake_report()
    assert baselines.diff(_fake_report(), base) == []
    assert any("donation" in v for v in
               baselines.diff(_fake_report(errors=1), base))
    assert any("warning count" in v for v in
               baselines.diff(_fake_report(warns=1), base))
    assert any("lowerings" in v for v in
               baselines.diff(_fake_report(lowerings={"scan": 2}), base))
    assert baselines.diff(_fake_report(), _fake_report(warns=3)) == []
    assert baselines.is_stale(_fake_report(), base) == []
    assert baselines.is_stale(_fake_report(lowerings={"scan": 1, "x": 1}),
                              base)
    assert baselines.is_stale(_fake_report(), None)
    assert any("no committed" in v for v in
               baselines.diff(_fake_report(), None))


def test_check_artifact_gate(tmp_path):
    p = tmp_path / "A.json"
    with pytest.raises(AssertionError):
        baselines.check_artifact(str(p))
    baselines.save(_fake_report(), str(p))
    assert baselines.check_artifact(str(p))["summary"]["errors"] == 0
    baselines.save(_fake_report(errors=2), str(p))
    with pytest.raises(AssertionError):
        baselines.check_artifact(str(p))


def test_committed_baseline_is_clean():
    rep = baselines.check_artifact()          # ANALYSIS_torch.json
    assert Path(baselines.resolve_path()).name == "ANALYSIS_torch.json"
    assert rep["swatlint"] == 1
    assert sorted(rep["engines"]) == sorted(A.MATRIX)
    for label in SHARED:
        assert rep["engines"][label]["summary"]["errors"] == 0


def test_launcher_check_exits_0_on_the_committed_baseline(capsys):
    assert A.main(["--device", "cpu", "--check", "--engines",
                   "single,paged_single"]) == 0
    assert "[analyze] clean" in capsys.readouterr().out


def test_launcher_write_reproduces_its_baseline(tmp_path):
    """`--write` gives the committed section of an engine exactly, and the
    committed file names no line (call sites are file:function)."""
    p = tmp_path / "A.json"
    args = ["--device", "cpu", "--engines", "spec_k2", "--baseline", str(p)]
    assert A.main(args + ["--write"]) == 0
    committed = baselines.load()
    assert json.loads(p.read_text())["engines"]["spec_k2"] == \
        committed["engines"]["spec_k2"]
    assert not re.search(r"\.py:\d", json.dumps(committed))


@pytest.mark.parametrize("label,message", [
    ("nope", "unknown engine label: nope"),
    ("tp_2x2", "tp_2x2: its 2x2 mesh needs 4 devices, --device-count is 2"),
    ("slot_parallel_4x1", "its 4x1 mesh needs 4 devices"),
    ("metrics_on", "needs 4 devices, --device-count is 2")])
def test_launcher_refuses_unknown_and_mesh_labels(label, message):
    """An unknown label, and a mesh label whose mesh has more shards than
    --device-count, exit before anything is built."""
    with pytest.raises(SystemExit) as e:
        A.main(["--device", "cpu", "--engines", label, "--device-count",
                "2"])
    assert message in str(e.value)


def test_launcher_needs_a_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        return
    with pytest.raises(SystemExit) as e:
        A.main(["--check"])
    assert "no CUDA device" in str(e.value)
