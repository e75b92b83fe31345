"""One run of a cell: set-up, the measured window, the check, the metrics.

The system under test is the port's ``Renderer`` on the pipeline its
configuration names (``"pipeline"``, by default ``"pallas"``:
``render/engine.py`` → ``ops/cuda/megakernel.py`` →
``csrc/megakernel.cu``); a configuration that resolves to another fails
the run. The harness drives it as its users do:

- offline: per job ``reset`` and a fresh render state on the job's seed,
  ``step(samples_per_step, sync=False)`` until the job's samples are
  queued, one ``sync``, one ``linear_image`` read-back;
- interactive: per drag frame an orbit step of the viewer's controller,
  ``set_camera`` and ``step(frame_spp, sync=False)``; per still frame
  ``step(frame_spp, sync=False)``; then ``display_image``, the uint8
  preview frame on the host.

Set-up (``setup_s``) runs from the process's start to the window's: the
imports, the scene text's parse (with a mesh's OBJ files), the map's
generation, the ``Renderer``'s construction (``scene_build`` span: the
scene's device tables, a mesh's BVH, the map's alias table), the kernels'
build or load and one warm-up of every shape the window uses.
"""

from __future__ import annotations

import gc
import json
import time
from pathlib import Path
from types import SimpleNamespace
from typing import Optional

import numpy as np
import torch

from . import check, load, noise
from .devtrace import WINDOW, DeviceTrace, Spans
from .manifest import ROOT, Cell, readers, setting
from .meadow import meadow

SPAN_NAMES = ("scene_build", "job", "step", "sync", "readback", "frame", "move", "display")


def scene_desc(config: dict):
    """The program's scene description of a configuration: its scene text,
    its ``FILE`` lines read from the checkout's root, and the generated map
    under an environment configuration."""
    from cosc_4397_pathtracing_raytracing_project_tpu_torch.scene.parser import parse_scene

    desc = parse_scene("\n".join(config["scene"]), base_dir=str(ROOT))
    if "envmap" in config:
        desc.env_image = meadow(config["envmap"]["height"])
        desc.env_strength = float(config["envmap"]["strength"])
    return desc


def build_renderer(config: dict, seed: int, device, spans: Spans):
    from cosc_4397_pathtracing_raytracing_project_tpu_torch.render.engine import (
        RenderConfig, Renderer)

    desc = scene_desc(config)
    with spans("scene_build"):
        r = Renderer(desc, RenderConfig(**config["render"]), seed=seed, device=device)
        r.sync()
    expected = setting(config, "pipeline")
    if r.pipeline != expected:
        raise RuntimeError(f"the configuration resolved to pipeline {r.pipeline!r}, "
                           f"not {expected!r}")
    return r, desc


class Offline:
    """Closed-loop render jobs."""

    kind = "offline"

    def __init__(self, cell: Cell, seed: int, device, spans: Spans):
        from cosc_4397_pathtracing_raytracing_project_tpu_torch.render.state import RenderState

        self.cell, self.seed, self.spans = cell, seed, spans
        self.step_spp = int(cell.config["render"]["samples_per_launch"])
        self.r, _ = build_renderer(cell.config, seed, device, spans)
        self.pixels = self.r.scene.camera.pixel_count
        self.new_state = lambda s: RenderState.create(self.pixels, s, self.r.device)
        self.pixel_table = check.pixel_table(seed, int(cell.limits["pixels"]), self.pixels)
        self.answers = []
        self.times = []

    def _job(self, job_seed: int, steps: list):
        r, spans = self.r, self.spans
        with spans("job"):
            r.reset()
            r.state = self.new_state(job_seed)
            for n in steps:
                with spans("step"):
                    r.step(n, sync=False)
            with spans("sync"):
                r.sync()
            with spans("readback"):
                return r.linear_image()

    def warm_up(self) -> None:
        self._job(0, sorted(set(load.job_steps(self.cell.traffic["job_spp"], self.step_spp))))

    def window(self, seconds: float) -> dict:
        step_counts: dict = {}
        t0 = time.perf_counter()
        for job in load.jobs(self.cell.traffic, self.seed):
            steps = load.job_steps(job.spp, self.step_spp)
            s = time.perf_counter()
            img = self._job(job.seed, steps)
            self.times.append(time.perf_counter() - s)
            for n in steps:
                step_counts[n] = step_counts.get(n, 0) + 1
            px = self.pixel_table[job.index % len(self.pixel_table)]
            first = np.cumsum([1] + steps[:-1]).tolist()
            self.answers.append(check.Answer(
                index=job.index, seed=job.seed, launches=list(zip(first, steps)),
                orbit_steps=0, pixels=px, values=img.reshape(-1, 3)[px].copy()))
            if time.perf_counter() - t0 >= seconds:
                break
        window_s = time.perf_counter() - t0
        samples = sum(n * c for n, c in step_counts.items()) * self.pixels
        return {"window_s": window_s, "rays_per_s": samples / window_s, "steps": step_counts}

    def release(self) -> None:
        del self.r

    def record(self) -> dict:
        return {"job_s": self.times}


class FrameLog:
    """The window's frames as answers, kept in a few arrays (no object per
    frame): each frame's drag count, its steps since the last reset and its
    drawn pixels' values; ``log[i]`` is frame i's :class:`check.Answer`."""

    BLOCK = 4096

    def __init__(self, seed: int, spp: int, pixel_table: np.ndarray):
        self.seed, self.spp, self.pixel_table = seed, spp, pixel_table
        self.blocks = []
        self.meta = []  # per block: int64 [BLOCK, 2] (drags so far, steps since reset)
        self.n = 0

    def add(self, drags: int, steps: int, img: np.ndarray) -> None:
        b, i = divmod(self.n, self.BLOCK)
        if b == len(self.blocks):
            self.blocks.append(np.empty((self.BLOCK,) + self.pixel_table.shape[1:] + (3,),
                                        np.uint8))
            self.meta.append(np.empty((self.BLOCK, 2), np.int64))
        self.blocks[b][i] = img.reshape(-1, 3)[self.pixel_table[self.n % len(self.pixel_table)]]
        self.meta[b][i] = (drags, steps)
        self.n += 1

    def __len__(self) -> int:
        return self.n

    def __getitem__(self, k: int) -> check.Answer:
        b, i = divmod(k, self.BLOCK)
        drags, steps = (int(v) for v in self.meta[b][i])
        return check.Answer(index=k, seed=self.seed,
                            launches=[(1 + self.spp * j, self.spp) for j in range(steps)],
                            orbit_steps=drags, pixels=self.pixel_table[k % len(self.pixel_table)],
                            values=self.blocks[b][i])


class Interactive:
    """One viewer's closed loop of frames."""

    kind = "interactive"

    def __init__(self, cell: Cell, seed: int, device, spans: Spans):
        self.cell, self.seed, self.spans = cell, seed, spans
        self.r, self.desc = build_renderer(cell.config, seed, device, spans)
        self.first_camera = self.r.scene.camera
        self.pixels = self.r.scene.camera.pixel_count
        self.spp = int(cell.traffic["frame_spp"])
        self.answers = FrameLog(seed, self.spp, check.pixel_table(
            seed, int(cell.limits["pixels"]), self.pixels))
        self.times = []
        self.drags = []

    def controller(self):
        from cosc_4397_pathtracing_raytracing_project_tpu_torch.viewer.controls import (
            OrbitCameraController)

        return OrbitCameraController.from_camera(self.first_camera,
                                                 lookat=self.desc.camera.lookat)

    def _frame(self, ctl, drag):
        r, spans = self.r, self.spans
        with spans("frame"):
            if drag:
                ctl.orbit(*drag)
                camera = ctl.camera()
                with spans("move"):
                    r.set_camera(camera)
                    r.step(self.spp, sync=False)
            else:
                with spans("step"):
                    r.step(self.spp, sync=False)
            with spans("sync"):
                r.sync()
            with spans("display"):
                return r.display_image()

    def warm_up(self) -> None:
        ctl = self.controller()
        self._frame(ctl, (1.0, 0.0))
        self._frame(ctl, ())

    def window(self, seconds: float) -> dict:
        ctl = self.controller()
        steps = 0
        t0 = time.perf_counter()
        for f in load.frames(self.cell.traffic, self.seed):
            s = time.perf_counter()
            img = self._frame(ctl, f.drag)
            self.times.append(time.perf_counter() - s)
            if f.drag:  # every cycle opens with a drag, which resets the accumulation
                self.drags.append(f.drag)
                steps = 0
            steps += 1
            self.answers.add(len(self.drags), steps, img)
            if time.perf_counter() - t0 >= seconds:
                break
        window_s = time.perf_counter() - t0
        ms = np.asarray(self.times) * 1e3
        return {"window_s": window_s, "frames_per_s": len(self.times) / window_s,
                "frame_ms_p95": float(np.percentile(ms, 95)),
                "steps": {self.spp: len(self.times)}}

    def release(self) -> None:
        del self.r

    def record(self) -> dict:
        return {"frame_s": self.times}


DRIVERS = {"offline": Offline, "interactive": Interactive}


def _device_info(device) -> dict:
    if device.type == "cuda":
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
                "count": 1, "memory_peak_bytes": int(torch.cuda.max_memory_allocated(device))}
    return {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device="cuda",
             t_start: Optional[float] = None):
    """One run: (the result line's object, the noise record). ``t_start`` is
    the process's start on ``time.perf_counter``'s clock."""
    t_start = time.perf_counter() if t_start is None else t_start
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    spans = Spans(traced=trace)
    phases = {"imports_s": time.perf_counter() - t_start}
    driver = DRIVERS[cell.traffic["kind"]](cell, seed, device, spans)
    phases["built_s"] = time.perf_counter() - t_start
    driver.warm_up()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    phases["warm_s"] = time.perf_counter() - t_start
    prof = None
    if trace:
        prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                  torch.profiler.ProfilerActivity.CUDA])
        prof.__enter__()
    setup_s = time.perf_counter() - t_start
    sampler = noise.CardSampler() if device.type == "cuda" else None
    with spans(WINDOW):
        measured = driver.window(seconds)
    card = sampler.stop() if sampler is not None else []
    dtrace = None
    if prof is not None:
        prof.__exit__(None, None, None)
        dtrace = DeviceTrace.from_profiler(prof, SPAN_NAMES)
        del prof
    dev_info = _device_info(device)
    record = {"card": card, **driver.record(), "window_s": measured["window_s"],
              "setup": phases}
    answers, drags = driver.answers, getattr(driver, "drags", [])
    driver.release()
    del driver
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    t_check = time.perf_counter()
    est = check.estimator(cell.config, device=device)
    numbers, failed, checked = check.judge(est, cell.traffic["kind"], answers, cell.limits, seed,
                                           drags, device)
    del est
    record["check_s"] = time.perf_counter() - t_check
    correct = checked > 0 and failed == 0 and all(
        v <= cell.limits["numbers"][k] for k, v in numbers.items())

    result = {"correct": correct, "attempted": len(answers), "failed": failed}
    if trace:
        ctx = SimpleNamespace(cell=cell, trace=dtrace, spans=spans, measured=measured,
                              device=device)
        metrics = {}
        read = readers(cell)
        for m in cell.per_layer:
            value = read[m.name](ctx)
            if value is not None:
                metrics[m.name] = {"value": value, "unit": m.unit}
        result["metrics"] = metrics
        dev_info["busy_s"] = dtrace.busy_s
        dev_info["window_s"] = dtrace.window_s
        result["device"] = dev_info
        result["breakdown"] = dtrace.breakdown()
    else:
        values = {"setup_s": setup_s, **measured}
        result["metrics"] = {m.name: {"value": values[m.name], "unit": m.unit}
                             for m in cell.end_to_end}
        result["device"] = dev_info
    result["checks"] = {k: {"value": v, "limit": cell.limits["numbers"][k]}
                        for k, v in numbers.items()}
    result["checks"]["answers_checked"] = {"value": checked, "limit": "> 0"}
    record["summary"] = {"card": noise.summary(card), "setup": phases,
                         "check_s": record["check_s"], **_time_summary(record)}
    return result, record


def _time_summary(record: dict) -> dict:
    out = {}
    for key in ("job_s", "frame_s"):
        if record.get(key):
            v = np.asarray(record[key])
            out[key] = {"n": int(v.size), "min": float(v.min()), "median": float(np.median(v)),
                        "p95": float(np.percentile(v, 95)), "max": float(v.max())}
    return out


def write_record(record: dict, workload: str, seed: int, trace: bool) -> Path:
    """The noise record, under the run's ``TMPDIR``."""
    import tempfile

    path = Path(tempfile.gettempdir()) / f"ptbench-{workload}-{seed}-trace{int(trace)}.json"
    path.write_text(json.dumps(record))
    return path

