"""The benchmark's manifest: each cell, configuration, traffic mix, limit
file and per-layer reader found by its name, and ``BENCHMARK.json`` within
the shapes its readers take."""

from __future__ import annotations

import json
import re

import pytest

from ptbench import manifest
from ptbench_fixtures import ROOT

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["ptbench"]
    assert BENCH["command"] == ["python3", "-m", "ptbench.run"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) < 64 * 1024


def test_names_units_and_bounds():
    names = [c["name"] for c in BENCH["configs"]] + CELLS
    names += [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    names += [w["traffic"] for w in BENCH["workloads"]]
    assert all(NAME.match(n) for n in names), names
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
    assert "setup_s" in e2e


@pytest.mark.parametrize("name", CELLS)
def test_cell_found_by_name(name):
    cell = manifest.Manifest(ROOT / "BENCHMARK.json").cell(name)
    assert cell.chips == 1
    assert cell.traffic["kind"] in ("offline", "interactive")
    assert cell.config["scene"] and cell.config["render"]["samples_per_launch"] > 0
    assert set(cell.limits["numbers"]) == ({"rel_gap"} if cell.traffic["kind"] == "offline"
                                           else {"lsb_gap"})
    reported = {m.name for m in cell.end_to_end}
    assert "setup_s" in reported and len(reported) >= 2
    assert cell.per_layer
    for m in cell.per_layer:  # every per-layer metric moves a metric the cell reports
        assert m.moves in reported
    assert set(manifest.readers(cell)) == {m.name for m in cell.per_layer}


def test_unknown_cell_raises():
    with pytest.raises(KeyError, match="no workload"):
        manifest.Manifest(ROOT / "BENCHMARK.json").cell("nope.offline")


def test_config_files_lie_under_paths_and_keep_the_published_scene():
    for c in BENCH["configs"]:
        assert c["file"].startswith("ptbench/configs/")
        config = json.loads((ROOT / c["file"]).read_text())
        assert config["name"] == c["name"] and c["reduced"] == []
        assert set(config["work_per_sample"]) >= {"isect", "scatter"}
    cornell = json.loads((ROOT / "ptbench/configs/cornell.json").read_text())
    assert "\n".join(cornell["scene"]) == (ROOT / "scenes/cornell.txt").read_text().rstrip("\n")
