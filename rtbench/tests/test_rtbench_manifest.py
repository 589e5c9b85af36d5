"""BENCHMARK.json against the benchmark's contract, and every file it
names."""
import json
import re

import pytest

from rtbench import manifest

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
M = manifest.load()


def test_top_level_keys():
    assert set(M) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert M["command"][:2] == ["python3", "rtbench/run.py"]
    assert M["paths"] == ["rtbench"]
    assert isinstance(M["run_seconds"], int) and 1 <= M["run_seconds"] <= 51


@pytest.mark.parametrize("section", ["configs", "workloads", "end_to_end",
                                     "per_layer"])
def test_names_are_unique_and_well_formed(section):
    names = [e["name"] for e in M[section]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)


def test_entry_keys():
    for c in M["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("rtbench/")
        assert all(NAME.match(k) for k in c["reduced"])
    for w in M["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert len(w["why"]) <= 200 and "\n" not in w["why"]
    for m in M["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in M["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")


def test_units():
    for m in M["end_to_end"] + M["per_layer"]:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")


def test_one_chip_per_cell():
    assert all(w["chips"] == 1 for w in M["workloads"])


def test_each_config_used_and_each_pair_once():
    used = {w["config"] for w in M["workloads"]}
    assert used == {c["name"] for c in M["configs"]}
    pairs = [(w["config"], w["traffic"]) for w in M["workloads"]]
    assert len(pairs) == len(set(pairs))


def test_per_layer_moves_a_metric_each_cell_reports():
    cells = {w["name"] for w in M["workloads"]}
    for m in M["per_layer"]:
        e2e = manifest.by_name(M["end_to_end"], m["moves"], "end_to_end")
        for cell in m.get("workloads", cells):
            assert cell in cells
            assert manifest.reports(e2e, cell), (m["name"], cell)


def test_every_cell_reports_setup_another_and_a_layer():
    for w in M["workloads"]:
        cell = manifest.Cell(M, w["name"])
        names = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in names and len(names) >= 2
        assert cell.per_layer


def test_files_resolve_by_name():
    for w in M["workloads"]:
        cell = manifest.Cell(M, w["name"])
        assert cell.traffic["path"] in ("fused", "wavefront")
        assert cell.traffic["check"]["limits"]
        assert cell.config["precision"] == "float32"
        for m in cell.per_layer:
            assert hasattr(manifest.metric_reader(m["name"]), "read")


def test_roofline_names():
    for m in M["per_layer"]:
        if "roofline" in m["name"]:
            assert m["name"].endswith("_roofline") and m["unit"] == "%"


def test_manifest_is_small():
    assert len(json.dumps(M)) < 64 * 1024
