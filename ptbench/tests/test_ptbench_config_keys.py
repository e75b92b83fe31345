"""A configuration names its pipeline, its kernels and its reference
(``"pipeline"``, ``"kernels"``, ``"reference"``), so a configuration on
another pipeline is new files only.

A small triangle-mesh scene on ``fast_mesh`` (an OBJ under the checkout's
root, a cube light, 12×10 pixels) runs to ``correct`` offline and
interactive from another working directory, judged by a reference module
that the test registers; a reference on the wrong streams makes it not
correct; a pipeline the scene does not resolve to fails the run;
``Manifest.cell`` refuses misused keys; the accepted cells keep the
megakernel's defaults; the idle share finds a configuration's own kernels
in a trace and fails without them."""

from __future__ import annotations

import copy
import dataclasses
import json
import sys
import types

import numpy as np
import pytest
import torch

from cosc_4397_pathtracing_raytracing_project_tpu_torch.render.engine import (
    RenderConfig, Renderer)
from cosc_4397_pathtracing_raytracing_project_tpu_torch.viewer.controls import (
    OrbitCameraController)
from ptbench import check, drive, manifest
from ptbench.devtrace import MEGAKERNEL_NAMES, WINDOW, DeviceTrace
from ptbench.reference.scene import Orbit
from ptbench_fixtures import ROOT, small_cell

STAND_IN = "mesh_stand_in"  # registered by these tests, not a file of ptbench/reference/
MESH_SCENE = [
    "MATERIAL 0", "RGB         1 1 1", "SPECEX      0", "SPECRGB     0 0 0", "REFL        0",
    "REFR        0", "REFRIOR     0", "EMITTANCE   5", "",
    "MATERIAL 1", "RGB         .85 .81 .78", "SPECEX      0", "SPECRGB     0 0 0",
    "REFL        0", "REFR        0", "REFRIOR     0", "EMITTANCE   0", "",
    "MATERIAL 2", "RGB         .4 .6 .9", "SPECEX      0", "SPECRGB     .9 .9 .9",
    "REFL        .6", "REFR        .7", "REFRIOR     0", "EMITTANCE   0", "",
    "CAMERA", "RES         12 10", "FOVY        35", "ITERATIONS  8", "DEPTH       8",
    "FILE        mesh_small", "EYE         0 2 6", "LOOKAT      0 1 0", "UP          0 1 0", "",
    "OBJECT 0", "cube", "material 0", "TRANS       0 5 0", "ROTAT       0 0 0",
    "SCALE       3 .3 3", "",
    "OBJECT 1", "mesh", "material 2", "FILE ptbench/tests/icosphere.obj",
    "TRANS       0 1 0", "ROTAT       0 20 0", "SCALE       1 1 1", "",
    "OBJECT 2", "cube", "material 1", "TRANS       0 0 0", "ROTAT       0 0 0",
    "SCALE       10 .01 10",
]


def mesh_config(nee: bool, **keys) -> dict:
    return {"name": "mesh_small", "scene": list(MESH_SCENE),
            "render": {"samples_per_launch": 4, "sky_strength": 1.0, "nee": nee},
            "pipeline": "fast_mesh", "kernels": ["pt_mesh_intersect"],
            "reference": STAND_IN, "precision": "float32", **keys}


@dataclasses.dataclass
class View:
    """What the check reads of a reference's scene: its size and orbit."""

    width: int
    height: int
    orbit: Orbit

    def with_orbit(self, orbit: Orbit) -> "View":
        return dataclasses.replace(self, orbit=orbit)


class StandIn:
    """Stands in for a reference of triangles, which these tests do not
    have: the program's own plain version renders the answer again from the
    same inputs (the configuration, the render seed, the orbit, the
    launches). It tests the harness's plumbing, not the program.
    ``seed_offset`` plants a reference on the wrong streams."""

    def __init__(self, config: dict, seed_offset: int = 0):
        self.config, self.seed_offset = config, seed_offset
        self.desc = drive.scene_desc(config)
        cam = self.desc.camera
        offset = np.asarray(cam.eye, np.float64) - np.asarray(cam.lookat, np.float64)
        zoom = float(np.linalg.norm(offset))
        self.scene = View(*cam.resolution, Orbit(
            zoom=zoom, phi=float(np.arctan2(offset[0], offset[2])),
            theta=float(np.arccos(offset[1] / zoom)), lookat=np.asarray(cam.lookat, np.float64)))
        start = check.viewer_orbit(self.scene)
        self.start = (start.zoom, start.phi, start.theta)

    def with_scene(self, scene: View) -> "StandIn":
        other = copy.copy(self)
        other.scene = scene
        return other

    def accumulate(self, render_seed: int, pixel_ids: torch.Tensor, launches):
        r = Renderer(self.desc, RenderConfig(**self.config["render"]),
                     seed=render_seed + self.seed_offset, device="cpu")
        orbit = self.scene.orbit
        if (orbit.zoom, orbit.phi, orbit.theta) != self.start:  # a frame after a drag
            ctl = OrbitCameraController.from_camera(r.scene.camera, lookat=self.desc.camera.lookat)
            ctl.zoom, ctl.phi, ctl.theta = orbit.zoom, orbit.phi, orbit.theta
            r.set_camera(ctl.camera())
        for _first, samples in launches:
            r.step(samples, sync=False)
        return r.state.accum[pixel_ids]


def register(monkeypatch, seed_offset: int = 0) -> None:
    module = types.ModuleType(f"ptbench.reference.{STAND_IN}")
    module.estimator = lambda config, dtype, device: StandIn(config, seed_offset)
    monkeypatch.setitem(sys.modules, module.__name__, module)


def mesh_cell(kind: str, nee: bool, **keys):
    cell = small_cell(f"cornell.{kind}")
    return dataclasses.replace(cell, name=f"mesh_small.{kind}", config=mesh_config(nee, **keys))


@pytest.fixture(autouse=True)
def _few_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 4))
    yield
    torch.set_num_threads(threads)


KINDS = [("offline", False), ("interactive", True)]


@pytest.mark.parametrize("kind, nee", KINDS)
def test_a_mesh_configuration_runs_correct(kind, nee, monkeypatch, tmp_path):
    register(monkeypatch)
    monkeypatch.chdir(tmp_path)  # the OBJ is read from the checkout's root, not from here
    cell = mesh_cell(kind, nee)
    result, _ = drive.run_cell(cell, 2 ** 31 + 21, 0.2, False, device="cpu")
    assert result["correct"] and result["failed"] == 0
    assert result["checks"]["answers_checked"]["value"] == min(result["attempted"], 3)
    gap = "rel_gap" if kind == "offline" else "lsb_gap"
    assert result["checks"][gap]["value"] == 0.0


@pytest.mark.parametrize("kind, nee", KINDS)
def test_a_reference_on_the_wrong_streams_is_not_correct(kind, nee, monkeypatch):
    register(monkeypatch, seed_offset=1)
    result, _ = drive.run_cell(mesh_cell(kind, nee), 2 ** 31 + 21, 0.2, False, device="cpu")
    assert not result["correct"] and result["failed"] > 0


@pytest.mark.parametrize("config, resolved, named", [
    (dict(small_cell("cornell.offline").config, pipeline="fast_mesh"), "pallas", "fast_mesh"),
    (mesh_config(False, pipeline="pallas"), "fast_mesh", "pallas"),
])
def test_a_pipeline_the_scene_does_not_resolve_to_fails(config, resolved, named):
    with pytest.raises(RuntimeError, match=f"pipeline '{resolved}', not '{named}'"):
        drive.build_renderer(config, 3, torch.device("cpu"), drive.Spans())


def _manifest(tmp_path, config: dict) -> manifest.Manifest:
    """``BENCHMARK.json`` with ``cornell``'s file replaced by ``config``."""
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    (tmp_path / "cornell.json").write_text(json.dumps(config))
    for c in bench["configs"]:
        if c["name"] == "cornell":
            c["file"] = "cornell.json"
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    return manifest.Manifest(tmp_path / "BENCHMARK.json")


@pytest.mark.parametrize("key, value", [
    ("reference", "nope"), ("reference", "../drive"), ("reference", "ptbench.drive"),
    ("reference", "/abs/trace"), ("reference", "__init__"), ("reference", 1),
    ("reference", "rng"), ("reference", "scene"), ("reference", "envmap"),
    ("kernels", []), ("kernels", "pt_megakernel"), ("kernels", [""]),
    ("pipeline", 3), ("pipeline", ""),
])
def test_the_manifest_refuses_misused_keys(key, value, tmp_path):
    config = dict(small_cell("cornell.offline").config, **{key: value})
    with pytest.raises(ValueError, match=f"configuration key '{key}'"):
        _manifest(tmp_path, config).cell("cornell.offline")


def test_the_manifest_takes_a_mesh_configuration(tmp_path):
    cell = _manifest(tmp_path, mesh_config(True, reference="trace")).cell("cornell.offline")
    assert [manifest.setting(cell.config, k) for k in ("pipeline", "kernels", "reference")] == [
        "fast_mesh", ["pt_mesh_intersect"], "trace"]


@pytest.mark.parametrize("name", ["cornell.offline", "env4k.offline", "cornell.interactive",
                                  "env4k.interactive"])
def test_the_accepted_cells_keep_the_megakernels_defaults(name):
    config = manifest.Manifest(ROOT / "BENCHMARK.json").cell(name).config
    assert not {"pipeline", "kernels", "reference"} & set(config)
    assert manifest.setting(config, "pipeline") == "pallas"
    assert manifest.setting(config, "kernels") == list(MEGAKERNEL_NAMES)
    assert manifest.setting(config, "reference") == "trace"
    from ptbench.reference import trace

    assert manifest.reference_module(config) is trace


def test_the_idle_share_reads_a_configurations_own_kernels():
    ms = 1_000_000
    events = [(WINDOW, False, 0, 100 * ms),
              ("void pt_mesh_intersect<true>(float const*)", True, 10 * ms, 30 * ms),
              ("void pt_mesh_intersect<false>(float const*)", True, 40 * ms, 45 * ms),
              ("at::native::vectorized_elementwise_kernel<4>", True, 50 * ms, 60 * ms)]
    trace = DeviceTrace.from_events(events)
    assert trace.kernel_seconds(["pt_mesh_intersect"]) == pytest.approx(0.025)
    assert trace.kernel_seconds() is None  # the megakernel's names find nothing here
    for kind, nee in KINDS:
        cell = mesh_cell(kind, nee)
        read = manifest.reader(f"idle_share.{kind}")
        assert read(types.SimpleNamespace(cell=cell, trace=trace)) == pytest.approx(65.0)
        bare = DeviceTrace.from_events(e for e in events if "pt_mesh" not in e[0])
        with pytest.raises(RuntimeError, match="pt_mesh_intersect"):
            read(types.SimpleNamespace(cell=cell, trace=bare))
        megakernel = dataclasses.replace(cell, config=mesh_config(nee, kernels=["pt_megakernel"]))
        with pytest.raises(RuntimeError, match="no kernel"):
            read(types.SimpleNamespace(cell=megakernel, trace=trace))
