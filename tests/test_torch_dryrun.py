"""The dry-run's cost model against the JAX package's, on the CPU
(`repro_torch.launch.{analytic,specs,dryrun}`, `distributed/roofline.py`,
`analysis/collectives.py`'s wire factors).

The analytic FLOP and byte model, the param counts and the input specs
equal the JAX functions' exactly for every config of `ARCH_IDS +
PAPER_IDS`, faithful and + SWAT, at every shape of `ALL_SHAPES`; the
roofline terms times the port's rates equal JAX's terms times its rates;
the mesh's record of an all-reduce, an all-gather and a shift weighs its
wire bytes as the JAX parser weighs the same ops in HLO text. Then the
dry-run itself, on meta tensors on small LocalMeshes (smoke configs): the
twin of the JAX package's `test_dryrun_cell_on_debug_mesh`, the meta trace
against the same step on CPU tensors, per-device FLOPs over a 4x1 mesh,
an uncounted product, the launcher's record keys, and the cells the mesh
gaps reach (whisper, internvl2's embeddings, granite-moe's "ep" dispatch,
the cp and fsdp train profiles).
"""
import json
import pathlib
import re

import pytest
import torch

from repro.configs import get_config as jax_config
from repro.configs import with_swat as jax_swat
from repro.core.types import ALL_SHAPES as JAX_SHAPES
from repro.distributed import hlo_analysis as H
from repro.launch import analytic as JAn
from repro.launch import specs as JSp
from repro_torch import tree
from repro_torch.analysis.collectives import record_stats
from repro_torch.configs import ARCH_IDS, PAPER_IDS, get_config
from repro_torch.configs import get_smoke_config, with_swat
from repro_torch.core.types import ALL_SHAPES, ShapeConfig
from repro_torch.distributed import roofline as R
from repro_torch.launch import analytic as An
from repro_torch.launch import dryrun as D
from repro_torch.launch import mesh as ML
from repro_torch.launch import specs as Sp

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
ARCHS = ARCH_IDS + PAPER_IDS
SMALL = (ShapeConfig("t", 64, 8, "train"), ShapeConfig("p", 64, 8, "prefill"),
         ShapeConfig("d", 64, 8, "decode"))


def _pair(arch, swat):
    cfg, jcfg = get_config(arch), jax_config(arch)
    if swat:
        cfg, jcfg = with_swat(cfg), jax_swat(jcfg)
    return cfg, jcfg


def _cases():
    return [(a, s) for a in ARCHS for s in (False, True)]


def _jax_shape(shape):
    return next(s for s in JAX_SHAPES if s.name == shape.name)


# ------------------------------------------------------ the cost model --

@pytest.mark.parametrize("arch,swat", _cases())
def test_analytic_equals_jax(arch, swat):
    """`_attn_cols`, `layer_flops_fwd` of every layer kind, `step_flops`
    and `step_param_bytes` equal the JAX functions' exactly."""
    cfg, jcfg = _pair(arch, swat)
    n = Sp.param_count(cfg)
    for shape in ALL_SHAPES:
        js = _jax_shape(shape)
        assert An.step_flops(cfg, shape) == JAn.step_flops(jcfg, js)
        assert (An.step_param_bytes(cfg, n, shape)
                == JAn.step_param_bytes(jcfg, n, js))
        seq = 1 if shape.mode == "decode" else shape.seq_len
        for kind in set(cfg.layer_pattern):
            assert (An.layer_flops_fwd(cfg, kind, seq)
                    == JAn.layer_flops_fwd(jcfg, kind, seq)), kind
        for spec, jspec in ((cfg.attention, jcfg.attention),
                            (cfg.local_attention, jcfg.local_attention)):
            if spec is not None:
                assert (An._attn_cols(spec, seq)
                        == JAn._attn_cols(jspec, seq))


@pytest.mark.parametrize("arch,swat", _cases())
def test_specs_and_counts_equal_jax(arch, swat):
    """`param_count`, `active_param_count` (a moe/ leaf ending in w1, w2 or
    w3 counts top_k/num_experts of its size) and every input spec's shape
    and dtype equal the JAX package's; the param and cache specs are meta
    tensors."""
    cfg, jcfg = _pair(arch, swat)
    assert Sp.param_count(cfg) == JSp.param_count(jcfg)
    assert Sp.active_param_count(cfg) == JSp.active_param_count(jcfg)
    for shape in ALL_SHAPES:
        got = Sp.input_specs(cfg, shape)
        want = JSp.input_specs(jcfg, _jax_shape(shape))
        assert got.keys() == want.keys()
        for k, v in got.items():
            assert v.device.type == "meta"
            assert tuple(v.shape) == tuple(want[k].shape), k
            assert str(v.dtype).replace("torch.", "") == str(want[k].dtype)
    assert all(x.device.type == "meta"
               for x in tree.leaves(Sp.param_specs(cfg)))


def _jax_model_flops(jcfg, shape, n):
    """The JAX dry-run's `model_flops_per_device`, whose module cannot be
    imported here (it sets the process's host device count at import): its
    body, on the JAX package's own active param count."""
    src = (ROOT / "src/repro/launch/dryrun.py").read_text()
    body = src[src.index("def model_flops_per_device"):
               src.index("def _memory_dict")]
    scope = {"Sp": JSp, "ModelConfig": object, "ShapeConfig": object}
    exec(body, scope)
    return scope["model_flops_per_device"](jcfg, shape, n)


@pytest.mark.parametrize("arch", ARCHS)
def test_model_flops_per_device_equals_jax(arch):
    cfg, jcfg = _pair(arch, False)
    for shape in ALL_SHAPES:
        for n in (256, 512):
            assert (D.model_flops_per_device(cfg, shape, n)
                    == _jax_model_flops(jcfg, _jax_shape(shape), n))


def test_roofline_terms_times_rates_equal_jax():
    """The same flops, bytes and wire bytes give the same work: each term
    times its rate equals JAX's term times its rate, and the record's keys
    and properties are JAX's."""
    cost = {"flops": 3.7e15, "bytes accessed": 2.1e12}
    coll = record_stats([("all_reduce", "model", 1 << 20),
                         ("all_gather", "data", 3 << 18)])
    jcoll = H.CollectiveStats(counts=coll.counts,
                              bytes_by_kind=coll.bytes_by_kind,
                              wire_bytes=coll.wire_bytes)
    got = R.roofline_terms(cost, coll, 1.2e15)
    want = H.roofline_terms(cost, jcoll, 1.2e15)
    assert got.compute_s * R.PEAK_FLOPS_BF16 == pytest.approx(
        want.compute_s * H.PEAK_FLOPS_BF16, rel=1e-12)
    assert got.memory_s * R.HBM_BW == pytest.approx(
        want.memory_s * H.HBM_BW, rel=1e-12)
    assert got.collective_s * R.NVLINK_BW == pytest.approx(
        want.collective_s * H.ICI_BW, rel=1e-12)
    assert got.to_dict().keys() == want.to_dict().keys()
    assert got.useful_flops_ratio == want.useful_flops_ratio
    assert got.dominant in ("compute", "memory", "collective")
    # the H100's rates are kernelprof's data-sheet constants
    from repro_torch.telemetry.kernelprof import H100
    assert (R.PEAK_FLOPS_BF16, R.HBM_BW) == (H100["bfloat16"],
                                             H100["hbm_bytes_per_s"])


def test_axis_link_nvlink_inside_a_node():
    """A collective's axis rides NVLink when it and the axes minor to it
    span at most 8 GPUs, else InfiniBand."""
    single, multi = D.make_mesh("single"), D.make_mesh("multi")
    assert R.axis_bandwidth(single, "model") == R.IB_BW
    assert R.axis_bandwidth(multi, "pod") == R.IB_BW
    small = ML.LocalMesh((2, 4), ("data", "model"))
    assert R.axis_bandwidth(small, "model") == R.NVLINK_BW
    assert R.axis_bandwidth(small, "data") == R.NVLINK_BW
    wide = ML.LocalMesh((4, 4), ("data", "model"))
    assert R.axis_bandwidth(wide, "model") == R.NVLINK_BW
    assert R.axis_bandwidth(wide, "data") == R.IB_BW
    rec = [("all_reduce", "model", 100), ("p2p", "data", 50)]
    assert R.collective_seconds(rec, wide) == pytest.approx(
        200 / R.NVLINK_BW + 50 / R.IB_BW)


def test_record_wire_bytes_equal_hlo_parse():
    """F7: the record of an all-reduce, an all-gather and a shift (p2p)
    weighs wire bytes as `parse_collectives` weighs the same ops written
    as HLO lines (all-reduce 2x its result, the others 1x): counts, bytes
    and wire bytes."""
    hlo = "\n".join([
        "  %ar = f32[4,8]{1,0} all-reduce(f32[4,8]{1,0} %x), to_apply=%add",
        "  %ag = f32[4,8]{1,0} all-gather(f32[2,8]{1,0} %y), dimensions={0}",
        "  %cp = bf16[2,16]{1,0} collective-permute(bf16[2,16]{1,0} %z), "
        "source_target_pairs={{0,1}}"])
    want = H.parse_collectives(hlo)
    got = record_stats([("all_reduce", "model", 128),
                        ("all_gather", "model", 128),
                        ("p2p", "model", 64)])
    names = {"all-reduce": "all_reduce", "all-gather": "all_gather",
             "collective-permute": "p2p"}
    assert got.counts == {names[k]: v for k, v in want.counts.items()}
    assert got.bytes_by_kind == {names[k]: v
                                 for k, v in want.bytes_by_kind.items()}
    assert got.wire_bytes == want.wire_bytes == 2 * 128 + 128 + 64


# ------------------------------------------------------------ the trace --

def test_dryrun_cell_on_debug_mesh():
    """The twin of the JAX package's test: smoke gemma2 on a 2x2 mesh,
    train, prefill and decode, traced and priced end to end."""
    cfg = get_smoke_config("gemma2_2b")
    mesh = ML.LocalMesh((2, 2), ("data", "model"))
    for shape in SMALL:
        tr = D.trace_cell(cfg, shape, mesh)
        roof = R.roofline_terms(tr.cost, record_stats(tr.record), 1e9,
                                R.collective_seconds(tr.record, mesh))
        assert roof.flops > 0 and roof.bytes_accessed > 0
        assert roof.dominant in ("compute", "memory", "collective")
        assert tr.memory["argument_size_in_bytes"] > 0
        assert tr.memory["temp_size_in_bytes"] > 0


def _counted(cell):
    counter = R.CostCounter()
    counter.arguments(cell.args)
    with cell.plan.mesh.recording() as record, counter:
        cell.run()
    return counter.flops, counter.by_op, list(record)


def test_meta_trace_equals_the_step_on_cpu_tensors():
    """A smoke llama train step on 2x2, traced on meta tensors and run on
    CPU tensors: the same collective record (kind, axis, bytes, in order)
    and the same FLOP count."""
    cfg = with_swat(get_smoke_config("llama3p2_1b"), 16, 4)
    shape = SMALL[0]
    meta = D.build_cell(cfg, shape, ML.LocalMesh((2, 2), ("data", "model")))
    cpu = D.build_cell(cfg, shape, ML.LocalMesh((2, 2), ("data", "model")),
                       device="cpu")
    got, want = _counted(meta), _counted(cpu)
    assert got[0] == want[0] > 0
    assert got[1] == want[1]
    assert got[2] == want[2] and got[2]


def test_flops_per_device_split_over_a_data_axis():
    """The flops per device of a 4x1 train cell are a quarter of the 1x1
    cell's (the batch splits, nothing is computed twice). Without remat:
    a remat region's recompute stops early after the last tensor its
    backward needs, which on a LocalMesh is the last coordinate's, so the
    others recompute the super-block's tail (see `distributed/roofline.py`)."""
    cfg = get_smoke_config("llama3p2_1b")
    one, four = (D.trace_cell(cfg, SMALL[0], ML.LocalMesh(
        shape, ("data", "model")), remat_policy="off")
        for shape in ((1, 1), (4, 1)))
    assert four.cost["flops"] * 4 == one.cost["flops"] > 0


def test_a_product_without_a_formula_raises():
    with pytest.raises(R.UncountedProduct, match="aten::mv"):
        with R.CostCounter():
            torch.mv(torch.empty(3, 4, device="meta"),
                     torch.empty(4, device="meta"))
    with pytest.raises(R.UncountedProduct, match="aten::dot"):
        with R.CostCounter():
            torch.dot(torch.ones(4), torch.ones(4))
    with R.CostCounter() as c:
        torch.bmm(torch.ones(2, 3, 4), torch.ones(2, 4, 5))
    assert c.flops == 2 * 2 * 3 * 4 * 5


def _jax_record_keys():
    src = (ROOT / "src/repro/launch/dryrun.py").read_text()
    block = src[src.index("    rec = {"):src.index("    if verbose:")]
    return set(re.findall(r'"(\w+)":', block))


def _smoke(monkeypatch):
    monkeypatch.setattr(D, "get_config", get_smoke_config)
    monkeypatch.setattr(D, "make_mesh", lambda kind: ML.LocalMesh(
        (2, 2), ("data", "model")))


def test_launcher_writes_jax_record_keys(tmp_path, monkeypatch):
    """`main` takes the JAX launcher's flags and writes its record (keys
    and all; `trace_s` for `compile_s`) into --out-dir, skips a cached
    cell, and a cell it cannot trace lands in FAILURES with exit 1."""
    _smoke(monkeypatch)
    D.main(["--arch", "llama3.2-1b", "--swat-variant", "--shape",
            "decode_32k", "--mesh", "single", "--impl", "pallas",
            "--out-dir", str(tmp_path)])
    path = tmp_path / "llama3p2_1b+swat__decode_32k__single.json"
    rec = json.loads(path.read_text())
    assert set(rec) == (_jax_record_keys() - {"compile_s"}) | {"trace_s"}
    assert rec["unrolled"] is True and rec["impl"] == "pallas"
    assert set(rec["memory"]) == {"argument_size_in_bytes",
                                  "output_size_in_bytes",
                                  "alias_size_in_bytes",
                                  "temp_size_in_bytes"}
    assert rec["memory"]["alias_size_in_bytes"] > 0      # the caches
    assert rec["roofline"]["flops_per_device"] > 0
    D.main(["--arch", "llama3.2-1b", "--swat-variant", "--shape",
            "decode_32k", "--out-dir", str(tmp_path)])      # cached
    with pytest.raises(SystemExit) as e:
        D.main(["--arch", "granite-moe-1b-a400m", "--shape", "train_4k",
                "--profile", "fsdp", "--moe-dispatch", "ep", "--out-dir",
                str(tmp_path)])
    assert e.value.code == 1


@pytest.mark.parametrize("arch,shape,kw", [
    ("whisper_tiny", SMALL[0], {}), ("whisper_tiny", SMALL[1], {}),
    ("whisper_tiny", SMALL[2], {}),
    ("internvl2_1b", SMALL[0], {}), ("internvl2_1b", SMALL[1], {}),
    ("granite_moe_1b", SMALL[0], {"moe_dispatch": "ep"}),
    ("llama3p2_1b", ShapeConfig("t", 512, 8, "train"), {"profile": "cp"}),
    ("llama3p2_1b", SMALL[0], {"profile": "fsdp"}),
    ("granite_moe_1b", ShapeConfig("t", 512, 8, "train"), {"profile": "cp"}),
    ("granite_moe_1b", SMALL[0], {"profile": "fsdp"})])
def test_mesh_gap_cells_trace(monkeypatch, arch, shape, kw):
    """The cells the three mesh gaps reach trace on a 2x2 mesh: whisper's
    three modes, internvl2's embeddings, granite-moe's "ep" dispatch (its
    all-to-alls recorded), the cp train profile (its halo shifts recorded)
    and the fsdp one (no collective over 'model' but the gathers and the
    reductions)."""
    _smoke(monkeypatch)
    rec = D.run_cell(arch, shape, "2x2", verbose=False,
                     swat_variant=arch not in ("whisper_tiny",
                                               "internvl2_1b"), **kw)
    counts = rec["roofline"]["collective_counts"]
    assert rec["roofline"]["flops_per_device"] > 0
    assert rec["profile"] == kw.get("profile", "tp")
    if kw.get("moe_dispatch") == "ep":
        assert counts.get("all_to_all", 0) > 0
    if kw.get("profile") == "cp":
        assert counts.get("p2p", 0) > 0
    else:
        assert "p2p" not in counts
