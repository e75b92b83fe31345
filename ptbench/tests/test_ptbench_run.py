"""The run's contract: its result as the last line of standard output and
the compared numbers as the last lines of standard error, no result
without a card, and neither JAX nor the JAX package loaded by a run."""

from __future__ import annotations

import json
import subprocess
import sys
import tempfile

import pytest
import torch

from ptbench import drive, run
from ptbench_fixtures import ROOT, small_cell

CELLS = ("cornell.offline", "env4k.offline", "cornell.interactive", "env4k.interactive")


def test_no_card_no_result():
    proc = subprocess.run(
        [sys.executable, "-m", "ptbench.run", "--workload", "cornell.offline", "--seed",
         str(2 ** 31 + 5), "--seconds", "1", "--trace", "0"],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, timeout=300,
        env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": "", "HOME": str(ROOT)})
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    assert proc.returncode != 0
    assert proc.stdout == ""


@pytest.mark.parametrize("name", ["cornell.offline", "env4k.interactive"])
def test_last_lines(name, monkeypatch, capsys, tmp_path):
    run_cell = drive.run_cell
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(drive, "run_cell", lambda cell, seed, seconds, trace, device, t_start:
                        run_cell(small_cell(cell.name), seed, seconds, trace, "cpu", t_start))
    monkeypatch.chdir(ROOT)
    assert run.main(["--workload", name, "--seed", str(2 ** 31 + 3), "--seconds", "0.2",
                     "--trace", "0"]) == 0
    out, err = capsys.readouterr()
    lines = out.strip().split("\n")
    noise = json.loads(lines[-2])
    assert "noise" in noise and "setup" in noise["noise"]
    result = json.loads(lines[-1])
    assert list(result)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(result)[-1] == "checks" and result["correct"] is True
    cell = small_cell(name)
    assert set(result["metrics"]) == {m.name for m in cell.end_to_end}
    for m in result["metrics"].values():
        assert m["value"] > 0 and m["unit"]
    assert set(result["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    tail = err.strip().split("\n")[-len(result["checks"]):]
    assert all(t.startswith("check ") and "limit" in t for t in tail)


def test_a_run_loads_neither_jax_nor_the_jax_package():
    code = (
        "import sys, torch; sys.path.insert(0, 'ptbench/tests');"
        "torch.set_num_threads(2);"
        "from ptbench_fixtures import small_cell; from ptbench import drive, run, calibrate;"
        "r, _ = drive.run_cell(small_cell('env4k.interactive'), 9, 0.1, False, device='cpu');"
        "assert r['correct'];"
        "print(run.forbidden_modules(), sorted({m.split('.')[0] for m in sys.modules}))"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, stdout=subprocess.PIPE,
                          stderr=subprocess.PIPE, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-2000:]
    found, loaded = proc.stdout.strip().split("] ", 1)
    assert found == "["
    assert "cosc_4397_pathtracing_raytracing_project_tpu_torch" in loaded
    for name in run.FORBIDDEN:
        assert f"'{name}'" not in loaded


def test_forbidden_names_compare_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "jaxtyping_like_mod", sys)
    monkeypatch.setitem(sys.modules, "cosc_4397_pathtracing_raytracing_project_tpu_torch_x", sys)
    assert "jax" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert run.forbidden_modules() == ["jax"]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_cell_runs_correct_on_the_card(name, cuda):
    proc = subprocess.run(
        [sys.executable, "-m", "ptbench.run", "--workload", name, "--seed", str(2 ** 31 + 11),
         "--seconds", "2", "--trace", "0"],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, timeout=1200)
    assert proc.returncode == 0, proc.stderr[-2000:]
    result = json.loads(proc.stdout.strip().split("\n")[-1])
    assert result["correct"] and result["device"]["platform"] == "gpu"
