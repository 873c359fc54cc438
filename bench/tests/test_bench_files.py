"""BENCHMARK.json and the files it names: every cell, configuration,
driver and metric reader is found by name, names and units keep to the
contract's characters, and the configurations' sizes are the port's."""
import json
import re
import shutil

import pytest

from bench import harness as H
from bench import serving as S
from conftest import CELLS, ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())


def test_names_and_units_keep_to_their_characters():
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    names += [w["name"] for w in BENCH["workloads"]]
    names += [c["name"] for c in BENCH["configs"]]
    names += [w["traffic"] for w in BENCH["workloads"]]
    names += [k for c in BENCH["configs"] for k in c["reduced"]]
    assert all(NAME.match(n) for n in names), names
    for group in (BENCH["end_to_end"] + BENCH["per_layer"],
                  BENCH["workloads"], BENCH["configs"]):
        assert len({x["name"] for x in group}) == len(group)
    units = [m["unit"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert all(UNIT.match(u) for u in units), units


def _line(text):
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_the_entries_keep_to_their_keys_and_limits():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51 and len(BENCH["command"]) <= 32
    assert all(_line(w) for w in BENCH["command"])
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert _line(c["why"]) and _line(c["source"])
        assert c["file"].startswith("bench/") and (ROOT / c["file"]).exists()
        assert not any(k.endswith(("_dim", "_rank", "_size"))
                       for k in c["reduced"])
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and _line(w["why"])
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better",
                                          "bound", "source"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better",
                                          "source", "layer", "moves"}
        assert _line(m["layer"])
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert m["better"] in ("lower", "higher")


@pytest.mark.parametrize("cell", CELLS)
def test_each_cell_and_its_files_load(cell):
    for trace in (False, True):
        spec = H.Spec.load(cell, trace)
        assert spec.metrics
        assert (ROOT / "bench" / "drivers"
                / f"{spec.cell['driver']}.py").exists()
        for m in spec.metrics:
            assert (ROOT / "bench" / "metrics" / f"{m['name']}.py").exists()
    names = {m["name"] for m in H.Spec.load(cell, False).metrics}
    assert "setup_s" in names and len(names) >= 2


def test_every_per_layer_metric_moves_a_metric_its_cells_report():
    for m in BENCH["per_layer"]:
        for cell in m["workloads"]:
            e2e = {x["name"] for x in H.Spec.load(cell, False).metrics}
            assert m["moves"] in e2e, (m["name"], cell)


@pytest.mark.parametrize("name", [c["name"] for c in BENCH["configs"]])
def test_config_sizes_equal_the_ports(name):
    conf = next(c for c in BENCH["configs"] if c["name"] == name)
    c = H.load_json(ROOT / conf["file"])
    cfg = S.port_config(c, check=True)
    assert cfg.attention.kind == "swat"
    assert (cfg.attention.window, cfg.attention.num_global) == (2048, 128)


def test_a_dropped_in_cell_is_found_without_an_edit(tmp_path):
    for part in ("bench", "BENCHMARK.json"):
        src = ROOT / part
        (shutil.copytree if src.is_dir() else shutil.copy)(
            src, tmp_path / part)
    spec = json.loads((tmp_path / "BENCHMARK.json").read_text())
    spec["workloads"].append({"name": "granite-8b-swat.extra",
                              "config": "granite-8b-swat",
                              "traffic": "extra", "chips": 1, "why": "x"})
    spec["end_to_end"][0]["workloads"].append("granite-8b-swat.extra")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    cell = json.loads((ROOT / "bench" / "cells"
                       / f"{CELLS[0]}.json").read_text())
    cell["traffic"]["requests"] = 64
    (tmp_path / "bench" / "cells" / "granite-8b-swat.extra.json").write_text(
        json.dumps(cell))
    got = H.Spec.load("granite-8b-swat.extra", False, root=tmp_path)
    assert got.cell["traffic"]["requests"] == 64
    assert [m["name"] for m in got.metrics] == [
        BENCH["end_to_end"][0]["name"], "setup_s"]
