"""PyTorch port, render driver: the port's Renderer on the CPU against the
JAX package's megakernel step in interpret mode, the tonemaps, resets,
PNG naming, state hand-over and the routing of the options and scenes the
megakernel does not take.

Tolerances are those of test_torch_megakernel.py (same oracle, same
reasons, same check)."""

import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cosc_4397_pathtracing_raytracing_project_tpu import RenderConfig as JConfig
from cosc_4397_pathtracing_raytracing_project_tpu.ops import tonemap as jtonemap
from cosc_4397_pathtracing_raytracing_project_tpu.ops.pallas import megakernel as jmk
from cosc_4397_pathtracing_raytracing_project_tpu.render import engine as jengine
from cosc_4397_pathtracing_raytracing_project_tpu.render.engine import make_pallas_step
from cosc_4397_pathtracing_raytracing_project_tpu.render.state import RenderState as JState
from cosc_4397_pathtracing_raytracing_project_tpu.scene import Scene as JScene
from cosc_4397_pathtracing_raytracing_project_tpu.scene import parse_scene as jparse
from cosc_4397_pathtracing_raytracing_project_tpu_torch import RenderConfig, Renderer, Scene, parse_scene
from cosc_4397_pathtracing_raytracing_project_tpu_torch import convert
from cosc_4397_pathtracing_raytracing_project_tpu_torch.io.png import read_png
from cosc_4397_pathtracing_raytracing_project_tpu_torch.ops import tonemap
from cosc_4397_pathtracing_raytracing_project_tpu_torch.ops.cuda import megakernel as tmk
from cosc_4397_pathtracing_raytracing_project_tpu_torch.scene import derive_camera

from test_render import CORNELL_SMALL
from test_torch_cuda import assert_within_oracle_tolerance, many_cubes_text

torch.set_num_threads(2)

CFG = dict(trace_depth=3, samples_per_launch=2)


@pytest.fixture(scope="module")
def jax_states():
    """The JAX package's megakernel step (interpret mode, 4096-px tiles),
    seed 0, after 2 and after 4 iterations."""
    saved = jmk.TILE_ROWS, jmk.TILE
    jmk.TILE_ROWS, jmk.TILE = 32, 32 * 128
    jmk._render_samples_impl.clear_cache()
    try:
        scene = JScene.from_desc(jparse(CORNELL_SMALL))
        cfg = JConfig(**CFG)
        step = make_pallas_step(interpret=True, scene=scene, config=cfg)
        s0 = JState.create(scene.camera.pixel_count, 0)
        s2 = step(scene, s0, cfg, 2)
        s4 = step(scene, s2, cfg, 2)
        return s2, s4
    finally:
        jmk.TILE_ROWS, jmk.TILE = saved
        jmk._render_samples_impl.clear_cache()


@pytest.fixture
def port_tiles():
    saved = tmk.TILE
    tmk.TILE = 32 * 128
    yield
    tmk.TILE = saved


def _renderer(**overrides):
    return Renderer(parse_scene(CORNELL_SMALL), RenderConfig(**dict(CFG, **overrides)), seed=0, device="cpu")


def test_renderer_matches_jax_step(jax_states, port_tiles):
    _, s4 = jax_states
    r = _renderer()
    r.render(4)
    assert r.iteration == int(s4.iteration) == 4
    assert r.state.iteration == 4
    assert_within_oracle_tolerance(r.state.accum.numpy(), np.asarray(s4.accum))
    assert r.metrics.iterations == 4 and r.metrics.samples_per_second > 0


def test_render_continues_from_jax_state(jax_states, port_tiles):
    s2, s4 = jax_states
    state = convert.state_from_jax_arrays(
        np.asarray(s2.accum), int(s2.iteration), np.asarray(jax.random.key_data(s2.key)), "cpu"
    )
    assert state.seed == 0 and state.iteration == 2
    r = _renderer()
    r.state = state
    r._host_iteration = state.iteration
    r.render(4)
    assert r.iteration == 4
    assert_within_oracle_tolerance(r.state.accum.numpy(), np.asarray(s4.accum))


@pytest.mark.parametrize("iteration", [0, 1, 7])
def test_tonemaps_match_jax_exactly(iteration):
    rng = np.random.default_rng(11)
    accum = rng.gamma(0.7, 0.6, (48 * 40, 3)).astype(np.float32) * max(iteration, 1)
    accum[::97] = 0.0
    t = torch.from_numpy(accum)
    j = jnp.asarray(accum)
    np.testing.assert_array_equal(
        tonemap.mean_image(t, iteration).numpy(), np.asarray(jtonemap.mean_image(j, iteration))
    )
    np.testing.assert_array_equal(
        tonemap.display_image(t, iteration).numpy(),
        np.asarray(jtonemap.display_image(j, iteration)),
    )
    np.testing.assert_array_equal(
        tonemap.save_image(t, iteration, 48, 40).numpy(),
        np.asarray(jtonemap.save_image(j, iteration, 48, 40)),
    )


def test_renderer_images_and_save_png(tmp_path, monkeypatch):
    r = _renderer(trace_depth=2)
    r.render(2)
    lin = r.linear_image()
    assert lin.shape == (64, 64, 3) and lin.dtype == np.float32 and np.isfinite(lin).all()
    disp = r.display_image()
    assert disp.shape == (64, 64, 3) and disp.dtype == np.uint8
    monkeypatch.chdir(tmp_path)
    path = r.save_png()
    assert re.fullmatch(r"cornell_small\.\d{4}-\d\d-\d\d_\d\d-\d\d-\d\dz\.2samp\.png", path), path
    want = tonemap.save_image(r.state.accum, 2, 64, 64).numpy()
    np.testing.assert_array_equal(read_png(os.path.join(tmp_path, path)), want)


def test_reset_and_set_camera_zero_the_render():
    r = _renderer(trace_depth=1)
    r.render(2)
    assert r.state.accum.abs().sum() > 0
    r.reset()
    assert r.iteration == 0 and r.state.iteration == 0
    assert r.state.accum.abs().sum() == 0 and r.metrics.iterations == 0
    r.render(2)
    cam = parse_scene(CORNELL_SMALL).camera
    cam.eye = np.array([1.0, 5.0, 10.0], np.float32)
    r.set_camera(derive_camera(cam, "cpu"))
    assert r.iteration == 0 and r.state.iteration == 0
    assert r.state.accum.abs().sum() == 0
    r.render(1)  # the step repacks the new camera
    assert r.iteration == 1


def test_psnr_snapshot_splits_at_iteration_10():
    r = _renderer(trace_depth=2, samples_per_launch=8)
    r.psnr_snapshot = True
    r.render(16)
    assert r.metrics.snapshot_iteration == 10
    assert np.isfinite(r.metrics.update_psnr(r.state.accum, r.iteration))
    assert "PERFORMANCE METRICS SUMMARY" in r.metrics.summary()


def test_cuda_device_is_explicit():
    if torch.cuda.is_available():
        assert _renderer(trace_depth=1).device.type == "cpu"
        return
    with pytest.raises(RuntimeError, match="CUDA"):
        Renderer(parse_scene(CORNELL_SMALL), RenderConfig(), device="cuda")


def _jax_route(jscene, config, monkeypatch):
    """The JAX package's pipeline for ``config`` on its accelerator."""
    monkeypatch.setattr(jengine.jax, "devices", lambda: [type("D", (), {"platform": "tpu"})()])
    try:
        return config.resolve_pipeline(jscene)
    finally:
        monkeypatch.undo()


@pytest.mark.parametrize(
    "overrides",
    [dict(pipeline="fast"), dict(pipeline="reference"), dict(intersector="bvh"),
     dict(bvh_leaf_size=8)],
    ids=lambda d: next(iter(d)),
)
def test_unported_options_raise(overrides, monkeypatch):
    """The options that raised before the fast and reference pipelines were
    ported now resolve as the JAX package's accelerator branch resolves
    them (fast, reference, reference with the BVH, the megakernel), and
    render."""
    want = _jax_route(JScene.from_desc(jparse(CORNELL_SMALL)), JConfig(**overrides), monkeypatch)
    routes = {("pipeline", "fast"): "fast", ("pipeline", "reference"): "reference",
              ("intersector", "bvh"): "reference", ("bvh_leaf_size", 8): "pallas"}
    assert want == routes[next(iter(overrides.items()))]
    r = _renderer(trace_depth=1, **overrides)
    assert r.pipeline == want
    r.render(1)
    assert np.isfinite(r.linear_image()).all() and r.linear_image().mean() > 0


@pytest.mark.parametrize(
    "overrides",
    [dict(mesh_sort_cells=4), dict(mesh_ray_sort=False), dict(mesh_sort_every=2),
     dict(mesh_sort_fused=False)],
    ids=lambda d: next(iter(d)),
)
def test_mesh_fields_are_accepted(overrides):
    """The mesh pipeline's fields are accepted on analytic scenes, where (as
    in JAX) they change nothing: the megakernel never reads them."""
    r = _renderer(trace_depth=1, **overrides)
    assert r.pipeline == "pallas"
    r.render(1)
    base = _renderer(trace_depth=1)
    base.render(1)
    assert torch.equal(r.state.accum, base.state.accum)


def _cubes_text(n):
    """``many_cubes_text`` with ``n`` cubes; 0 keeps the materials and the
    camera, without objects."""
    return many_cubes_text(2).split("OBJECT 0")[0] if n == 0 else many_cubes_text(n)


@pytest.mark.parametrize("config", [dict(), dict(nee=True, sampler="sobol")],
                         ids=["default", "nee-sobol"])
def test_twenty_cubes_route_to_the_megakernel(config):
    """20 cubes over 40 materials (past the old 16-row tables) take the
    megakernel, as in JAX; the CUDA case of test_torch_cuda.py renders it."""
    text = _cubes_text(20)
    scene = Scene.from_desc(parse_scene(text), "cpu")
    assert tmk.supports(scene) and jmk.supports(JScene.from_desc(jparse(text)))
    assert RenderConfig(**config).resolve_pipeline(scene) == "pallas"
    r = Renderer(scene, RenderConfig(trace_depth=1, **config), device="cpu")
    assert r.pipeline == "pallas"
    r.render(1)
    assert np.isfinite(r.linear_image()).all() and r.linear_image().mean() > 0


@pytest.mark.parametrize("count", [0, 65])
def test_primitive_counts_outside_the_megakernel_raise(count, monkeypatch):
    """0 or more than 64 analytic primitives run on the reference pipeline,
    as in JAX (brute force for 0, the BVH past 64), and render."""
    text = _cubes_text(count)
    scene = Scene.from_desc(parse_scene(text), "cpu")
    assert scene.cubes.count + scene.spheres.count == count
    assert not tmk.supports(scene) and not jmk.supports(JScene.from_desc(jparse(text)))
    assert _jax_route(JScene.from_desc(jparse(text)), JConfig(), monkeypatch) == "reference"
    assert RenderConfig().resolve_pipeline(scene) == "reference"
    assert RenderConfig().resolve_intersector(scene) == ("bvh" if count else "bruteforce")
    r = Renderer(scene, RenderConfig(trace_depth=1), device="cpu")
    assert r.pipeline == "reference"
    r.render(1)
    img = r.linear_image()
    assert np.isfinite(img).all() and (img.mean() > 0) == (count > 0)


def test_unreferenced_materials_are_dropped_when_packing():
    """The 40-material file packs 20 materials, densely renumbered in id
    order, and the light's id follows its geom's."""
    scene = Scene.from_desc(parse_scene(_cubes_text(20)), "cpu")
    packed = tmk.pack_scene(scene, nee=True)
    ids = scene.cubes.material_id.numpy()
    used = np.unique(ids)
    assert packed.num_materials == used.size == 20 < scene.materials.color.shape[0]
    np.testing.assert_array_equal(packed.gmat, np.searchsorted(used, ids))
    np.testing.assert_array_equal(packed.mats.reshape(-1, 10)[:, :3],
                                  scene.materials.color.numpy()[used])
    assert packed.lights.mat.tolist() == [packed.gmat[-1]] == [19]


def test_many_materials_render_as_the_oracle(port_tiles):
    """A file of 40 materials (8 cubes) renders on the CPU as the JAX
    megakernel in interpret mode renders it, CORNELL_SMALL's size, depth 3.
    Measured: bit-identical (development host, jax 0.9.0, torch 2.13.0)."""
    text = _cubes_text(8)
    saved = jmk.TILE_ROWS, jmk.TILE
    jmk.TILE_ROWS, jmk.TILE = 32, 32 * 128
    jmk._render_samples_impl.clear_cache()
    try:
        want = np.asarray(jmk.render_samples(
            JScene.from_desc(jparse(text)), JConfig(trace_depth=3), jnp.int32(0), jnp.int32(1),
            2, interpret=True))
    finally:
        jmk.TILE_ROWS, jmk.TILE = saved
        jmk._render_samples_impl.clear_cache()
    scene = Scene.from_desc(parse_scene(text), "cpu")
    assert tmk.pack_scene(scene).num_materials == 8
    got = tmk.render_samples(scene, RenderConfig(trace_depth=3), 0, 1, 2)
    assert_within_oracle_tolerance(got.numpy(), want)


def test_config_fields_and_defaults_match_jax():
    import dataclasses

    want = {f.name: f.default for f in dataclasses.fields(JConfig)}
    got = {f.name: f.default for f in dataclasses.fields(RenderConfig)}
    assert got == want
