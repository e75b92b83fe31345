"""PyTorch port, the megakernel step's repack on a camera move (CPU, the
plain megakernel): a scene that differs from the packed one only in its
camera keeps the packed tables and re-reads only the camera
(``megakernel.with_camera``, counted as ``repack.camera``), and renders bit
for bit what a renderer built on the moved camera renders, on Cornell, an
exact map under env NEE, and split mode with the background composited
outside the kernel and inside it (antialiasing); a move keeps the texel
table, the geometry and material tables and the light table, the same
objects, and rebuilds neither the texel table nor the light table; a new
geometry, material or map table, a new resolution or a new configuration
packs in full (``repack.full``); ``pack_camera`` is the seven camera
tensors read one by one, in one wait.
"""

import dataclasses

import numpy as np
import pytest
import torch

from cosc_4397_pathtracing_raytracing_project_tpu_torch import RenderConfig, Renderer, parse_scene
from cosc_4397_pathtracing_raytracing_project_tpu_torch.ops.cuda import megakernel
from cosc_4397_pathtracing_raytracing_project_tpu_torch.render import profiling
from cosc_4397_pathtracing_raytracing_project_tpu_torch.render.engine import make_pallas_step
from cosc_4397_pathtracing_raytracing_project_tpu_torch.render.state import RenderState
from cosc_4397_pathtracing_raytracing_project_tpu_torch.scene import Scene
from cosc_4397_pathtracing_raytracing_project_tpu_torch.viewer import OrbitCameraController

from test_render import CORNELL_SMALL
from test_torch_cuda import env_scene_text, write_env_map

torch.set_num_threads(2)

RES = 24
# case: (the map, or None for CORNELL_SMALL; the configuration)
CASES = {
    "cornell": (None, dict(trace_depth=3)),
    "env-nee": ("sun", dict(trace_depth=3, nee=True)),
    "split-composite": ("sun", dict(trace_depth=3, env_mode="split")),
    "split-antialias": ("sun", dict(trace_depth=3, env_mode="split", antialias=True)),
}


def _case(case, tmp_path, **overrides):
    """(scene, config, lookat) of a case on the CPU."""
    env, cfg = CASES[case]
    config = RenderConfig(**{**cfg, **overrides})
    if env is None:
        desc = parse_scene(CORNELL_SMALL)
    else:
        desc = parse_scene(env_scene_text(write_env_map(tmp_path, env), res=RES),
                           base_dir=str(tmp_path))
    return Scene.from_desc(desc, "cpu"), config, desc.camera.lookat


def _moved(camera, lookat):
    ctl = OrbitCameraController.from_camera(camera, lookat=lookat)
    ctl.orbit(3.0, 1.0)
    return ctl.camera()


def _repacks():
    c = profiling.counters()
    return c.get("repack.full", 0), c.get("repack.camera", 0)


@pytest.fixture
def packs(monkeypatch):
    """The packed scene of each launch of the plain megakernel."""
    seen = []
    render = megakernel.render_samples

    def spy(*args, packed=None, **kw):
        seen.append(packed)
        return render(*args, packed=packed, **kw)

    monkeypatch.setattr(megakernel, "render_samples", spy)
    return seen


@pytest.mark.parametrize("case", list(CASES))
def test_a_moved_camera_renders_as_a_renderer_built_on_it(case, tmp_path):
    scene, config, lookat = _case(case, tmp_path)
    r = Renderer(scene, config, seed=5, device="cpu")
    assert r.pipeline == "pallas"
    r.step(2)
    before = r.state.accum.clone()
    moved = _moved(r.scene.camera, lookat)
    full, camera = _repacks()
    r.set_camera(moved)
    r.step(2)
    assert _repacks() == (full, camera + 1)
    fresh = Renderer(scene.replace(camera=moved), config, seed=5, device="cpu")
    fresh.step(2)
    assert torch.equal(r.state.accum, fresh.state.accum)
    assert not torch.equal(r.state.accum, before)  # the move shows in the image


@pytest.mark.parametrize("case, overrides", [("cornell", dict(nee=True)), ("env-nee", {}),
                                             ("split-composite", {})])
def test_a_move_keeps_the_packed_tables(case, overrides, tmp_path, packs, monkeypatch):
    scene, config, lookat = _case(case, tmp_path, **overrides)
    r = Renderer(scene, config, device="cpu")
    r.step(1)
    first = packs[-1]
    calls = {"texel_table": 0, "static_light_table": 0}
    for name in calls:
        def counted(*args, _name=name, _f=getattr(megakernel, name), **kw):
            calls[_name] += 1
            return _f(*args, **kw)

        monkeypatch.setattr(megakernel, name, counted)
    camera = _moved(r.scene.camera, lookat)
    syncs = profiling.counters().get("host_syncs", 0)
    r.set_camera(camera)
    r.step(1, sync=False)
    moved = packs[-1]
    assert calls == {"texel_table": 0, "static_light_table": 0}
    assert profiling.counters()["host_syncs"] - syncs == 1  # the camera's one read
    for name in ("geo", "gmat", "mats", "perm", "lights"):
        assert getattr(moved, name) is getattr(first, name)
    assert not np.array_equal(moved.cam, first.cam)
    assert moved.cam.tobytes() == megakernel.pack_camera(r.scene.camera).tobytes()
    if case == "cornell":
        assert moved.lights is not None and moved.env is None
    elif case == "env-nee":
        assert moved.env is first.env and moved.env.tex is first.env.tex
    else:  # the composited background follows the camera; the suns and SH stay
        assert moved.env.suns is first.env.suns and moved.env.sh is first.env.sh
        want = megakernel.pack_scene(r.scene, config=r.config).env
        assert torch.equal(moved.env.bg, want.bg) and torch.equal(moved.env.bg_miss, want.bg_miss)
        assert not torch.equal(moved.env.bg_miss, first.env.bg_miss)


def _changed(change, scene, config, tmp_path):
    if change == "materials":
        m = scene.materials
        return scene.replace(materials=dataclasses.replace(m, color=m.color * 0.5)), config
    if change == "geometry":
        return scene.replace(spheres=dataclasses.replace(scene.spheres)), config
    if change == "map":
        desc = parse_scene(env_scene_text(write_env_map(tmp_path, "const"), res=RES),
                           base_dir=str(tmp_path))
        return scene.replace(envmap=Scene.from_desc(desc, "cpu").envmap), config
    if change == "config":
        return scene, dataclasses.replace(config, trace_depth=2)
    camera = dataclasses.replace(scene.camera, resolution=(RES, RES + 8))  # "resolution"
    return scene.replace(camera=camera), config


@pytest.mark.parametrize("change", ["materials", "geometry", "map", "config", "resolution"])
def test_a_changed_table_or_config_packs_in_full(change, tmp_path):
    scene, config, _ = _case("env-nee" if change == "map" else "cornell", tmp_path)
    step = make_pallas_step()
    create = lambda s: RenderState.create(s.camera.pixel_count, 3, s.device)  # noqa: E731
    step(scene, create(scene), config, 1)
    full, camera = _repacks()
    step(scene, create(scene), config, 1)  # the same scene: no repack
    assert _repacks() == (full, camera)
    scene2, config2 = _changed(change, scene, config, tmp_path)
    got = step(scene2, create(scene2), config2, 2).accum
    assert _repacks() == (full + 1, camera)
    want = make_pallas_step()(scene2, create(scene2), config2, 2).accum
    assert torch.equal(got, want)


def test_pack_camera_is_the_seven_tensors_read_one_by_one():
    scene = Scene.from_desc(parse_scene(CORNELL_SMALL), "cpu")
    cam = _moved(scene.camera, (0.0, 5.0, 0.0))
    want = np.concatenate(
        [t.numpy().reshape(-1) for t in (cam.position, cam.view, cam.right, cam.up,
                                         cam.pixel_length, cam.aperture, cam.focal)]
    ).astype(np.float32)
    syncs = profiling.counters().get("host_syncs", 0)
    got = megakernel.pack_camera(cam)
    assert profiling.counters()["host_syncs"] - syncs == 1
    assert got.dtype == np.float32 and got.shape == (16,) and got.flags.c_contiguous
    assert got.tobytes() == want.tobytes()
    assert megakernel.pack_scene(scene.replace(camera=cam)).cam.tobytes() == want.tobytes()
