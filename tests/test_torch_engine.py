"""PyTorch port, render driver: the port's Renderer on the CPU against the
JAX package's megakernel step in interpret mode, the tonemaps, resets,
PNG naming, state hand-over and the options this slice does not carry.

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
from cosc_4397_pathtracing_raytracing_project_tpu.render.engine import make_pallas_step
from cosc_4397_pathtracing_raytracing_project_tpu.render.state import RenderState as JState
from cosc_4397_pathtracing_raytracing_project_tpu.scene import Scene as JScene
from cosc_4397_pathtracing_raytracing_project_tpu.scene import parse_scene as jparse
from cosc_4397_pathtracing_raytracing_project_tpu_torch import RenderConfig, Renderer, parse_scene
from cosc_4397_pathtracing_raytracing_project_tpu_torch import convert
from cosc_4397_pathtracing_raytracing_project_tpu_torch.io.png import read_png
from cosc_4397_pathtracing_raytracing_project_tpu_torch.ops import tonemap
from cosc_4397_pathtracing_raytracing_project_tpu_torch.ops.cuda import megakernel as tmk
from cosc_4397_pathtracing_raytracing_project_tpu_torch.scene import derive_camera

from test_render import CORNELL_SMALL
from test_torch_cuda import assert_within_oracle_tolerance

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


@pytest.mark.parametrize(
    "overrides",
    [dict(pipeline="fast"), dict(pipeline="reference"), dict(intersector="bvh"),
     dict(env_mode="split"), dict(mesh_sort_cells=4), dict(nee=True),
     dict(gather_mode="throughput"), dict(enable_refraction=True), dict(early_exit=True)],
    ids=lambda d: next(iter(d)),
)
def test_unported_options_raise(overrides):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        _renderer(**overrides)


def test_config_fields_and_defaults_match_jax():
    import dataclasses

    want = {f.name: f.default for f in dataclasses.fields(JConfig)}
    got = {f.name: f.default for f in dataclasses.fields(RenderConfig)}
    assert got == want
