"""The metrics' arithmetic: the rate over a window that ends at a job
boundary, the 95th percentile over every frame, the device trace's busy
time and idle gaps, and the frozen roofline count."""

from __future__ import annotations

from types import SimpleNamespace

import numpy as np
import pytest

from ptbench import drive, load, roofline
from ptbench.devtrace import WINDOW, DeviceTrace, short_name
from ptbench_fixtures import small_cell


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def test_offline_rate_runs_to_the_first_job_boundary_past_the_window(monkeypatch):
    clock = FakeClock()
    monkeypatch.setattr(drive.time, "perf_counter", clock)
    cell = small_cell("cornell.offline")
    cell.traffic["job_spp"] = 10  # steps of 4, 4 and 2 samples
    off = drive.Offline.__new__(drive.Offline)
    off.cell, off.seed, off.spans, off.step_spp = cell, 5, drive.Spans(), 4
    off.pixels, off.answers, off.times = 100, [], []
    off.pixel_table = np.zeros((1, 2), np.int64)
    queued = []

    def job(seed, steps):  # each job takes 0.4 s of the clock
        queued.append(steps)
        clock.t += 0.4
        return np.ones((10, 10, 3), np.float32)

    off._job = job
    out = off.window(1.0)
    assert len(off.answers) == 3  # 0.4, 0.8, then 1.2 ≥ 1.0 ends the window
    assert queued == [[4, 4, 2]] * 3
    assert off.answers[0].launches == [(1, 4), (5, 4), (9, 2)]
    assert out["window_s"] == pytest.approx(1.2)
    assert out["rays_per_s"] == pytest.approx(3 * 10 * 100 / 1.2)
    assert out["steps"] == {4: 6, 2: 3}


def test_frame_p95_over_every_frame(monkeypatch):
    clock = FakeClock()
    monkeypatch.setattr(drive.time, "perf_counter", clock)
    cell = small_cell("cornell.interactive")
    it = drive.Interactive.__new__(drive.Interactive)
    it.cell, it.seed, it.spans, it.spp = cell, 5, drive.Spans(), 2
    it.times, it.drags = [], []
    it.answers = drive.FrameLog(5, 2, np.zeros((4, 2), np.int64))
    it.controller = lambda: None
    durations = iter([0.001 * (k + 1) for k in range(100)])

    def frame(ctl, drag):
        clock.t += next(durations)
        return np.zeros((2, 2, 3), np.uint8)

    it._frame = frame
    out = it.window(1.0)
    n = len(it.times)
    assert n == 45  # 1 + 2 + ... + 45 ms = 1.035 s
    ms = np.arange(1, n + 1, dtype=np.float64)
    assert out["frame_ms_p95"] == pytest.approx(np.percentile(ms, 95))
    assert out["frames_per_s"] == pytest.approx(n / out["window_s"])
    # the log's accumulation restarts at each drag: 3 drags, then 2 still frames
    assert it.answers[3].launches == [(1, 2), (3, 2)]
    a = it.answers[4]
    assert a.orbit_steps == 3 and a.launches == [(1, 2), (3, 2), (5, 2)]
    assert it.answers[5].launches == [(1, 2)] and it.answers[5].orbit_steps == 4


def test_traffic_gives_every_seed_the_same_work():
    cell = small_cell("cornell.interactive")

    def first_drag(seed):
        fs = load.frames(cell.traffic, seed)
        return [next(fs).drag for _ in range(3)]

    a, b = first_drag(1), first_drag(2 ** 33 + 7)
    assert sorted(a) == sorted(b)
    jobs = load.jobs(small_cell("cornell.offline").traffic, 3)
    assert {next(jobs).spp for _ in range(5)} == {10}
    assert load.job_steps(4096, 200) == [200] * 20 + [96]
    assert load.job_steps(5000, 200) == [200] * 25


def test_drags_alternate_direction_and_keep_their_set():
    cell = small_cell("cornell.interactive")
    fs = load.frames(cell.traffic, 11)
    first = [next(fs) for _ in range(10)]
    steps = sorted(tuple(s) for s in cell.traffic["drag_px"])
    assert sorted(f.drag for f in first[:3]) == steps
    assert [f.drag for f in first[3:5]] == [(), ()]
    assert sorted((-dx, -dy) for dx, dy in (f.drag for f in first[5:8])) == steps


def _events():
    ms = 1_000_000
    return [
        (WINDOW, False, 0, 100 * ms),
        ("frame", False, 0, 50 * ms), ("move", False, 0, 20 * ms),
        ("display", False, 30 * ms, 50 * ms),
        ("void pt_megakernel<false, 0>(Args)", True, 20 * ms, 30 * ms),
        ("pt_env_rows(SceneTables)", True, 25 * ms, 35 * ms),
        ("Memcpy DtoH (Device -> Pageable)", True, 60 * ms, 70 * ms),
        ("pt_megakernel<false, 0>(Args)", True, 90 * ms, 130 * ms),  # clipped at the window
    ]


def test_device_trace_busy_gaps_and_breakdown():
    tr = DeviceTrace.from_events(_events())
    assert tr.window_s == pytest.approx(0.1)
    assert tr.busy_s == pytest.approx(0.015 + 0.010 + 0.010)
    assert tr.kernel_seconds() == pytest.approx(0.010 + 0.010 + 0.010)
    idle = tr.idle_by_span()
    assert idle["move"] == pytest.approx(0.020)
    assert idle["display"] == pytest.approx(0.025)
    assert idle["other"] == pytest.approx(0.020)
    bd = tr.breakdown()
    assert bd["device_ops"][0] == ["pt_megakernel<false, 0>", pytest.approx(0.020)]
    assert {n for n, _ in bd["device_ops"]} == {"pt_megakernel<false, 0>", "pt_env_rows",
                                                "Memcpy DtoH"}
    assert short_name("void at::native::(anonymous namespace)::k<1>(int)") == "at::native::k<1>"


def test_idle_share_reader_fails_without_the_megakernel():
    from ptbench.manifest import reader

    events = [e for e in _events() if "pt_" not in e[0]]
    ctx = SimpleNamespace(cell=small_cell("cornell.interactive"),
                          trace=DeviceTrace.from_events(events))
    with pytest.raises(RuntimeError, match="no kernel"):
        reader("idle_share.interactive")(ctx)
    ctx.trace = DeviceTrace.from_events(_events())
    assert reader("idle_share.interactive")(ctx) == pytest.approx(65.0)
    assert reader("idle_share.offline")(ctx) is None


def test_frozen_roofline_count_at_a_small_size():
    # two axis-aligned cubes and a general sphere
    geoms = [(True, True), (True, True), (False, False)]
    isect = 11 + 2 * (6 + 3 + 29) + (18 + 15 + 52)
    assert roofline.flops_isect(geoms) == isect
    work = {"isect": 2.0, "scatter": 3.0}
    per_sample = 2.0 * isect + 3.0 * 70
    assert roofline.flops_per_sample(geoms, work) == per_sample
    flops = 10 * (4 * per_sample + isect)
    assert roofline.launch_bound_s(geoms, work, 10, 4, 8) == pytest.approx(
        max(flops / 67e12, 10 * 12 / 3.35e12))
    # under env NEE: the map's texels with their pdf, and the rows' kernel
    env = {"env_shadow": 0.5, "env_lookup": 1.0, "env_pdf": 0.25}
    occl = 2 * (6 + 26 - 3) + (18 + 28 - 6)
    per_env = 0.5 * (27 + occl) + 96 + 0.25 * 2
    assert roofline.flops_per_sample(geoms, env) == per_env
    row = 29 + 14 + 30 - 2 + 2 * (3 + 3) + (15 + 6)
    assert roofline.flops_per_row(geoms, 1 << 16) == row
    got = roofline.launch_bound_s(geoms, env, 1000, 50, 8, texels=1 << 16, env_nee=True)
    flops = 1000 * (50 * per_env + isect) + 50 * 8 * row
    bytes_ = 1000 * 12 + (1 << 16) * 16
    assert got == pytest.approx(max(flops / 67e12, bytes_ / 3.35e12))
    assert roofline.share(1.0, 4.0) == 25.0
