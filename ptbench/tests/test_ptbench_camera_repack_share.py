"""The reader of ``camera_repack_share.interactive``: the program's
``repack.camera`` counts over ``repack.camera`` + ``repack.full`` in the
interactive window, on windows worked out by hand and on both small
interactive cells run on the CPU with the tracer on; nothing to read
without a repack in the window, in an offline cell or from a program
without the tracer."""

from __future__ import annotations

import itertools
from types import SimpleNamespace

import pytest
import torch

from cosc_4397_pathtracing_raytracing_project_tpu_torch.render import profiling
from cosc_4397_pathtracing_raytracing_project_tpu_torch.render.profiling import Count, Span
from ptbench import drive, load, manifest, program_spans
from ptbench.devtrace import WINDOW, DeviceTrace, Spans
from ptbench_fixtures import small_cell

NAME = "camera_repack_share.interactive"
READ = manifest.reader(NAME)
S = 1_000_000_000  # ns


def _ctx(kind="interactive"):
    """A window from 10 s to 11 s on the host's clock."""
    spans = Spans()
    spans.records = [("frame", 10.1, 10.2), (WINDOW, 10.0, 11.0)]
    return SimpleNamespace(cell=SimpleNamespace(traffic={"kind": kind}), spans=spans,
                           trace=DeviceTrace([], [], 1.0))


def _repacks(*marks):
    """A step span and the (name, seconds past 10 s) repack counts."""
    return [Span("engine.step", 10 * S + S // 20, 10 * S + S // 10, -1)] + [
        Count(name, round((10 + t) * S), 1) for name, t in marks]


@pytest.fixture
def program(monkeypatch):
    state = {"records": []}
    monkeypatch.setattr(profiling, "records", lambda: list(state["records"]))
    monkeypatch.setattr(profiling, "counters", lambda: {"dropped": 0})
    return state


@pytest.mark.parametrize("marks, share", [
    ([("repack.camera", 0.2), ("repack.camera", 0.4), ("repack.camera", 0.6)], 100.0),
    ([("repack.full", -5.0), ("repack.camera", 0.2), ("repack.camera", 0.4),
      ("repack.full", 0.5), ("repack.camera", 0.6), ("repack.full", 1.5)], 75.0),
    ([("repack.full", 0.3)], 0.0),
])
def test_share_on_a_window_worked_out_by_hand(program, marks, share):
    program["records"] = _repacks(*marks)
    assert READ(_ctx()) == pytest.approx(share)


def test_nothing_to_read_without_a_repack_in_the_window(program):
    program["records"] = _repacks(("repack.camera", -1.0), ("repack.full", 2.0))
    assert READ(_ctx()) is None  # as under a program that counts no repack


def test_nothing_to_read_offline_or_without_the_tracer(program, monkeypatch):
    program["records"] = _repacks(("repack.camera", 0.2))
    assert READ(_ctx("offline")) is None
    monkeypatch.delattr(profiling, "records")
    assert READ(_ctx()) is None


@pytest.mark.parametrize("name", ["cornell.interactive", "env4k.interactive"])
def test_every_drag_of_a_cpu_run_keeps_the_packed_scene(name, monkeypatch):
    """One cycle of the small cell's traffic (3 drag frames, 2 still
    frames) after its warm-up, which packs the scene in full: each drag's
    move re-reads only the camera."""
    torch.set_num_threads(2)
    cell = small_cell(name)
    endless = load.frames
    monkeypatch.setattr(load, "frames", lambda traffic, seed: itertools.islice(
        endless(traffic, seed), 5))
    spans = Spans()
    it = drive.Interactive(cell, 7, torch.device("cpu"), spans)
    it.warm_up()
    profiling.enable(True)
    try:
        with spans(WINDOW):
            measured = it.window(600.0)
    finally:
        profiling.enable(False)
    assert len(it.drags) == 3
    ctx = SimpleNamespace(cell=cell, spans=spans, trace=DeviceTrace([], [], measured["window_s"]))
    assert READ(ctx) == 100.0
    counts = [c for c in profiling.records() if isinstance(c, Count)
              and c.name.startswith("repack.") and c.t_ns * 1e-9 >= program_spans.window(ctx)[0]]
    assert [c.name for c in counts] == ["repack.camera"] * 3
