"""The readers of the program's own spans and counter: ``repack_ms``,
``readback_ms``, ``host_syncs`` and ``program_idle_ms`` of the interactive
cells, on a window worked out by hand (a drag frame and a still frame) and
on the small cells run on the CPU with the tracer on; they fail on dropped
records and an empty window, and read nothing from a program without the
tracer or in an offline cell."""

from __future__ import annotations

import itertools
from types import SimpleNamespace

import pytest
import torch

from cosc_4397_pathtracing_raytracing_project_tpu_torch.render import profiling
from cosc_4397_pathtracing_raytracing_project_tpu_torch.render.profiling import Count, Span
from ptbench import drive, load, manifest
from ptbench.devtrace import WINDOW, DeviceTrace, Spans
from ptbench_fixtures import small_cell

NAMES = ("repack_ms.interactive", "readback_ms.interactive", "host_syncs.interactive",
         "program_idle_ms.interactive")
READ = {name: manifest.reader(name) for name in NAMES + ("move_ms.interactive",
                                                         "display_ms.interactive")}
MS = 1_000_000  # ns


def _ns(ms_after_10s):
    return 10_000 * MS + round(ms_after_10s * MS)


def _span(name, t0, t1, parent=-1):
    return Span(name, _ns(t0), _ns(t1), parent)


# a drag frame (records 1-11) and a still frame (12-17) in a window that
# opens at 10 s on the host's clock and lasts 30 ms; times in ms past 10 s
RECORDS = [
    _span("viewer.camera", -1000.0, -999.0),  # 0: before the window
    _span("viewer.camera", 1.0, 2.0),
    Count("host_syncs", _ns(1.5), 7),
    _span("engine.set_camera", 2.0, 2.5),
    _span("engine.step", 2.5, 6.0),
    _span("engine.repack", 3.0, 5.0, parent=4),
    Count("host_syncs", _ns(4.0), 21),
    _span("engine.sync", 6.0, 10.0),
    Count("host_syncs", _ns(6.1), 1),
    _span("engine.display", 10.0, 12.0),
    _span("engine.readback", 11.0, 11.5, parent=9),
    Count("host_syncs", _ns(11.0), 3),
    _span("engine.step", 12.0, 13.0),
    _span("engine.sync", 13.0, 20.0),
    Count("host_syncs", _ns(13.0), 1),
    _span("engine.display", 20.0, 21.0),
    _span("engine.readback", 20.3, 20.6, parent=15),
    Count("host_syncs", _ns(20.3), 3),
    _span("engine.step", 31.0, 32.0),  # after the window
]
# the device's operations, in seconds from the window's start
OPS = [(0.0, 1.5), (3.5, 4.5), (6.5, 9.5), (10.5, 10.8), (13.1, 19.5), (20.5, 20.7),
       (25.0, 28.0)]


def _ctx(kind="interactive"):
    spans = Spans()
    spans.records = [("frame", 9.0, 9.01), ("frame", 10.0, 10.012), ("frame", 10.012, 10.024),
                     (WINDOW, 10.0, 10.030)]
    trace = DeviceTrace([("k", s * 1e-3, e * 1e-3) for s, e in OPS], [], 0.030)
    return SimpleNamespace(cell=SimpleNamespace(traffic={"kind": kind}), spans=spans,
                           trace=trace)


@pytest.fixture
def program(monkeypatch):
    """The program's tracer holding RECORDS, ``dropped`` as given."""
    state = {"records": RECORDS, "dropped": 0}
    monkeypatch.setattr(profiling, "records", lambda: list(state["records"]))
    monkeypatch.setattr(profiling, "counters", lambda: {"dropped": state["dropped"]})
    return state


def test_readers_on_a_window_worked_out_by_hand(program):
    got = {name: READ[name](_ctx()) for name in NAMES}
    assert got["repack_ms.interactive"] == pytest.approx(2.0)
    assert got["readback_ms.interactive"] == pytest.approx((0.5 + 0.3) / 2)
    assert got["host_syncs.interactive"] == pytest.approx((7 + 21 + 1 + 3 + 1 + 3) / 2)
    # the top-level spans cover 1-21 ms; the idle gaps there, cut exactly:
    # 1.5-3.5, 4.5-6.5, 9.5-10.5, 10.8-13.1, 19.5-20.5 and 20.7-21 (of 20.7-25)
    inside = 2.0 + 2.0 + 1.0 + 2.3 + 1.0 + 0.3
    assert got["program_idle_ms.interactive"] == pytest.approx(inside / 2)
    idle_per_frame = 1e3 * sum(e - s for s, e in _ctx().trace.gaps()) / 2
    assert got["program_idle_ms.interactive"] < idle_per_frame == pytest.approx(7.3)


def test_readers_fail_on_dropped_records_in_the_window(program):
    program["dropped"] = 5
    # the oldest record kept lies before the window: nothing of it was lost
    assert READ["repack_ms.interactive"](_ctx()) == pytest.approx(2.0)
    program["records"] = RECORDS[1:]
    for name in NAMES:
        with pytest.raises(RuntimeError, match="dropped"):
            READ[name](_ctx())


def test_readers_fail_on_an_empty_window(program):
    program["records"] = [RECORDS[0], RECORDS[-1]]
    for name in NAMES:
        with pytest.raises(RuntimeError, match="no record in the window"):
            READ[name](_ctx())


def test_readers_read_nothing_without_the_tracer_or_offline(program, monkeypatch):
    for name in NAMES:
        assert READ[name](_ctx("offline")) is None
    monkeypatch.delattr(profiling, "records")  # a program from before the tracer
    for name in NAMES:
        assert READ[name](_ctx()) is None


@pytest.mark.parametrize("name, drag_syncs", [("cornell.interactive", 12),
                                              ("env4k.interactive", 12)])
def test_readers_agree_with_the_benchmarks_spans_on_a_cpu_run(name, drag_syncs, monkeypatch):
    """The small cell's window on the CPU with the tracer on, one cycle of
    its traffic (3 drag frames, 2 still frames): a drag frame passes 7
    camera writes, the camera-only repack's one read, the sync and the
    display's 3; a still frame 4. The repack lies inside the move, the
    read-back inside the display, and the program's idle inside the
    window's; ``move_ms`` and ``display_ms`` average the window's moves and
    displays, not the warm-up's."""
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
            measured = it.window(600.0)  # the cycle's 5 frames
    finally:
        profiling.enable(False)
    assert len(it.times) == 5 and len(it.drags) == 3
    ctx = SimpleNamespace(cell=cell, spans=spans,
                          trace=DeviceTrace([], [], measured["window_s"]))
    got = {n: READ[n](ctx) for n in NAMES}
    assert got["host_syncs.interactive"] == pytest.approx((3 * drag_syncs + 2 * 4) / 5)
    assert len(spans.durations("move")) == 4  # the warm-up's drag, then the window's 3
    move = 1e3 * sum(spans.durations("move")[1:]) / 3
    display = 1e3 * sum(spans.durations("display")[2:]) / 5
    assert READ["move_ms.interactive"](ctx) == pytest.approx(move)
    assert READ["display_ms.interactive"](ctx) == pytest.approx(display)
    assert 0 < got["repack_ms.interactive"] < move
    assert 0 < got["readback_ms.interactive"] < display
    assert 0 < got["program_idle_ms.interactive"] <= 1e3 * measured["window_s"] / 5
