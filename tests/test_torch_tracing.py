"""PyTorch port, the tracer of ``render/profiling.py`` on the CPU: spans off
cost no clock and no profiler record; under ``torch.profiler`` a viewer's
drag frame and still frame record the interactive path's spans, the repack
inside the step; the ring's bound and its drops; ``host_syncs`` at the
sites on the step, move and display path (a move re-reads only the camera,
a new table repacks every table); and ``Renderer.sync``'s wait in the
metrics' render time.
"""

import dataclasses
import time

import pytest
import torch

from cosc_4397_pathtracing_raytracing_project_tpu_torch import RenderConfig, Renderer, parse_scene
from cosc_4397_pathtracing_raytracing_project_tpu_torch.render import profiling
from cosc_4397_pathtracing_raytracing_project_tpu_torch.viewer import OrbitCameraController

from test_render import CORNELL_SMALL

torch.set_num_threads(2)

# the host_syncs sites a frame of CORNELL_SMALL (6 cubes, a sphere) passes
CAMERA_WRITES = 7  # OrbitCameraController.camera: position, view, up, right,
#                    pixel_length, aperture, focal
REPACK_READS = 1  # a camera-only repack: the camera vector, read in one copy
FULL_REPACK_READS = 15  # pack_scene: 2 tables of each batch, 2 material-id
#                         tables, 6 material columns, the camera vector, 2
#                         geom-kind tables
DISPLAY = 3  # the tonemap's two host scalars, then the frame's read-back
DRAG_SYNCS = CAMERA_WRITES + REPACK_READS + 1 + DISPLAY
STILL_SYNCS = 1 + DISPLAY

DRAG_SPANS = ["viewer.camera", "engine.set_camera", "engine.step", "engine.repack",
              "engine.sync", "engine.display", "engine.readback"]
STILL_SPANS = ["engine.step", "engine.sync", "engine.display", "engine.readback"]


def _viewer():
    r = Renderer(parse_scene(CORNELL_SMALL), RenderConfig(trace_depth=2), device="cpu")
    r.step(1)  # the first step packs the scene
    return r, OrbitCameraController.from_camera(r.scene.camera, lookat=(0.0, 5.0, 0.0))


def _frame(r, ctl, drag):
    if drag:
        ctl.orbit(3.0, 1.0)
        r.set_camera(ctl.camera())
    r.step(1, sync=False)
    r.sync()
    return r.display_image()


def _since(index):
    """The records from record ``index`` on (no span open)."""
    return profiling.records()[index - profiling.TRACER.dropped:]


def _raise(*args, **kwargs):
    raise AssertionError("called with the tracer off")


def test_spans_off_read_no_clock_and_make_no_record(monkeypatch):
    r, ctl = _viewer()
    monkeypatch.setattr(profiling, "_clock", _raise)
    monkeypatch.setattr(profiling, "_record_function", _raise)
    monkeypatch.setattr(torch.profiler, "record_function", _raise)
    assert not profiling.TRACER.forced
    before = profiling.TRACER._next
    for drag in (True, False):
        _frame(r, ctl, drag)
    assert profiling.TRACER._next == before


def test_profiler_records_the_repack_inside_the_step():
    r, ctl = _viewer()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        first = profiling.TRACER._next
        _frame(r, ctl, drag=True)
        middle = profiling.TRACER._next
        _frame(r, ctl, drag=False)
    drag = [x for x in _since(first)[:middle - first] if isinstance(x, profiling.Span)]
    still = [x for x in _since(middle) if isinstance(x, profiling.Span)]
    assert [s.name for s in drag] == DRAG_SPANS  # in the order they were entered
    assert [s.name for s in still] == STILL_SPANS
    by_index = dict(zip(range(first, middle), _since(first)))
    repack = drag[DRAG_SPANS.index("engine.repack")]
    assert by_index[repack.parent].name == "engine.step"
    readback = drag[DRAG_SPANS.index("engine.readback")]
    assert by_index[readback.parent].name == "engine.display"
    top = [s.name for s in drag if s.parent == -1]
    assert top == ["viewer.camera", "engine.set_camera", "engine.step", "engine.sync",
                   "engine.display"]
    for s in drag + still:
        assert s.start_ns <= s.end_ns
    step = drag[DRAG_SPANS.index("engine.step")]
    assert step.start_ns <= repack.start_ns and repack.end_ns <= step.end_ns


def test_trace_shows_the_engine_spans(tmp_path):
    r, _ = _viewer()
    with profiling.trace(str(tmp_path / "trace")):
        r.step(1)
    text = (tmp_path / "trace" / "trace.json").read_bytes()
    assert b'"engine.step"' in text and b'"engine.sync"' in text


def test_the_ring_drops_past_its_bound_and_counts_the_drops():
    t = profiling.Tracer(capacity=8)
    t.forced = True
    with t.span("outer"):  # record 0
        for k in range(3):
            with t.span(f"inner{k}"):  # records 1, 3 and 5
                t.count("n", 2)  # records 2, 4 and 6
    assert t.dropped == 0 and t.totals == {"n": 6}
    recs = t.records()
    assert [x.name for x in recs] == ["outer", "inner0", "n", "inner1", "n", "inner2", "n"]
    assert all(x.parent == 0 for x in recs if x.name.startswith("inner"))
    assert recs[0].parent == -1
    for _ in range(5):
        t.count("m")
    assert t.dropped == 4 and t.counters()["dropped"] == 4
    recs = t.records()
    assert len(recs) == 8 and [x.name for x in recs[:3]] == ["n", "inner2", "n"]
    with t.span("long"):  # record 12, overwritten before it ends
        for _ in range(8):
            t.count("m")
    assert t.dropped == 13 and all(x.name == "m" for x in t.records())
    assert t.totals == {"n": 6, "m": 13}
    t.forced = False
    with t.span("off"):
        t.count("m")
    assert t.dropped == 13 and t.totals["m"] == 14


def test_enable_keeps_the_tracer_on_without_a_profiler():
    r, ctl = _viewer()
    profiling.enable(True)
    try:
        first = profiling.TRACER._next
        _frame(r, ctl, drag=False)
        names = [x.name for x in _since(first) if isinstance(x, profiling.Span)]
    finally:
        profiling.enable(False)
    assert names == STILL_SPANS


def test_host_syncs_count_the_sites_of_a_drag_and_a_still_frame():
    r, ctl = _viewer()
    syncs = lambda: profiling.counters().get("host_syncs", 0)  # noqa: E731
    counts = []
    for drag in (True, False, True):
        before = syncs()
        _frame(r, ctl, drag)
        counts.append(syncs() - before)
    assert counts == [DRAG_SYNCS, STILL_SYNCS, DRAG_SYNCS] == [12, 4, 12]
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        first = profiling.TRACER._next
        _frame(r, ctl, drag=True)
    marks = [x for x in _since(first) if isinstance(x, profiling.Count)]
    assert sum(x.n for x in marks if x.name == "host_syncs") == DRAG_SYNCS


def test_host_syncs_count_a_full_repack_on_a_scene_change():
    """A frame after a new material table: the repack reads every table
    again, inside its span, and counts as ``repack.full``."""
    r, _ = _viewer()
    c = profiling.counters
    before = c()
    r.scene = r.scene.replace(materials=dataclasses.replace(r.scene.materials))
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        first = profiling.TRACER._next
        _frame(r, None, drag=False)
    after = c()
    assert after["host_syncs"] - before["host_syncs"] == FULL_REPACK_READS + 1 + DISPLAY == 19
    assert after["repack.full"] - before.get("repack.full", 0) == 1
    assert after.get("repack.camera", 0) == before.get("repack.camera", 0)
    recs = _since(first)
    repack = next(i for i, x in enumerate(recs) if x.name == "engine.repack")
    inside = [x for x in recs if isinstance(x, profiling.Count)
              and recs[repack].start_ns <= x.t_ns <= recs[repack].end_ns]
    assert {x.name: x.n for x in inside if x.name != "host_syncs"} == {"repack.full": 1}
    assert sum(x.n for x in inside if x.name == "host_syncs") == FULL_REPACK_READS


def test_counters_read_the_kernel_launch_counts():
    c = profiling.counters()
    assert {"dropped", "launches", "row_launches", "launches_by_variant"} <= set(c)


def test_sync_adds_its_wait_to_the_render_time(monkeypatch):
    """Under ``--metrics-every 0`` the CLI queues every step unsynced and
    syncs once: the summary's rate is over the host's time in the steps and
    the wait, here a stubbed device wait of 0.2 s."""
    r, _ = _viewer()
    r.reset()
    monkeypatch.setattr(r, "device", torch.device("cuda"))
    monkeypatch.setattr(torch.cuda, "synchronize", lambda device=None: time.sleep(0.2))
    for _ in range(2):
        r.step(1, sync=False)
    queued = r.metrics.total_render_time
    r.sync()
    m = r.metrics
    assert m.total_render_time >= queued + 0.2
    assert m.iterations == 2
    assert m.samples_per_second == pytest.approx(64 * 64 * 2 / m.total_render_time)
