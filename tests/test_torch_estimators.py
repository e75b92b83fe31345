"""PyTorch port, the megakernel's other estimator options (kernel K1b):
refraction, the thin-lens camera (its three random streams), the
throughput (legacy) estimator and early_exit, each alone and all with NEE
in one combined case: the plain version against the JAX Pallas kernel in
interpret mode (the oracle), on CORNELL_SMALL variants.

Tolerance: that of test_torch_megakernel.py (at most 0.5% of pixels with a
max-channel |Δ| above 1e-3, per-channel means within 0.5%), for the reason
it states. The throughput estimator adds one: every escaped path keeps the
sky's colour as its value, so the last-ulp difference of XLA's and torch's
rsqrt in the ray direction shows in the output instead of vanishing.
Measured on the development host (jax 0.9.0, torch 2.13.0 CPU), 2 spp,
with ``pytest -s``: refraction and the three lens streams bit-identical;
throughput 0.195% of pixels above 1e-3 (95% bit-identical); the combined
case 0.024% (48% bit-identical, the NEE reciprocals). early_exit is checked bit for bit
against early_exit off, as tests/test_megakernel.py does for the oracle.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cosc_4397_pathtracing_raytracing_project_tpu import RenderConfig as JConfig
from cosc_4397_pathtracing_raytracing_project_tpu.ops.pallas import megakernel as jmk
from cosc_4397_pathtracing_raytracing_project_tpu.scene import Scene as JScene
from cosc_4397_pathtracing_raytracing_project_tpu.scene import parse_scene as jparse
from cosc_4397_pathtracing_raytracing_project_tpu_torch import (
    RenderConfig,
    Renderer,
    Scene,
    parse_scene,
)
from cosc_4397_pathtracing_raytracing_project_tpu_torch.ops.cuda import megakernel as tmk

from test_render import CORNELL_SMALL
from test_torch_cuda import assert_within_oracle_tolerance

torch.set_num_threads(2)

N_SAMPLES = 2
SEED = 0

# the mirror sphere becomes glass (REFR 1, ior 1.5), as in cornell_glass.txt
GLASS = CORNELL_SMALL.replace("REFL 1\nREFR 0\nREFRIOR 0", "REFL 1\nREFR 1\nREFRIOR 1.5")
# ... seen through a thin lens of radius 0.3 focused on LOOKAT
LENS = GLASS.replace("LOOKAT 0 5 0", "APERTURE 0.3\nLOOKAT 0 5 0")

CASES = {
    # depth 2: into the glass sphere and out of it (both sides of Snell's law)
    "refraction": (GLASS, dict(trace_depth=2, enable_refraction=True)),
    "dof-lens-stream": (LENS, dict(trace_depth=2, dof=True)),
    "dof-after-jitter": (LENS, dict(trace_depth=2, dof=True, antialias=True)),
    "dof-sobol": (LENS, dict(trace_depth=2, dof=True, sampler="sobol")),
    "throughput": (CORNELL_SMALL, dict(trace_depth=2, gather_mode="throughput")),
    "combined": (
        LENS,
        dict(trace_depth=2, nee=True, enable_refraction=True, dof=True, sampler="sobol",
             antialias=True),
    ),
}


@pytest.fixture(autouse=True)
def oracle_tiles():
    """The JAX tests' interpret-mode tile (4096 px) on both sides; the
    jitted oracle bakes TILE in at trace time, so its cache is cleared."""
    saved = jmk.TILE_ROWS, jmk.TILE, tmk.TILE
    jmk.TILE_ROWS, jmk.TILE, tmk.TILE = 32, 32 * 128, 32 * 128
    jmk._render_samples_impl.clear_cache()
    yield
    jmk.TILE_ROWS, jmk.TILE, tmk.TILE = saved
    jmk._render_samples_impl.clear_cache()


def _oracle(scene_j, cfg):
    out = jmk.render_samples(
        scene_j, JConfig(**cfg), jnp.int32(SEED), jnp.int32(1), N_SAMPLES, interpret=True
    )
    return np.asarray(out)


def _port(scene, cfg):
    return tmk.render_samples(scene, RenderConfig(**cfg), SEED, 1, N_SAMPLES).numpy()


@pytest.mark.parametrize("case", list(CASES))
def test_plain_version_matches_oracle(case):
    text, cfg = CASES[case]
    want = _oracle(JScene.from_desc(jparse(text)), cfg)
    got = _port(Scene.from_desc(parse_scene(text), "cpu"), cfg)
    assert_within_oracle_tolerance(got, want)


def test_early_exit_is_bit_identical_on_an_open_scene():
    """sphere.txt at 32×32: most rays escape, so whole tiles die; the
    port's early_exit changes nothing, like the oracle's."""
    path = os.path.join(os.path.dirname(__file__), "..", "scenes", "sphere.txt")
    text = open(path).read().replace("RES         800 800", "RES         32 32")
    cfg = dict(trace_depth=4)
    scene = Scene.from_desc(parse_scene(text), "cpu")
    off = _port(scene, cfg)
    on = _port(scene, dict(cfg, early_exit=True))
    np.testing.assert_array_equal(on, off)
    want = _oracle(JScene.from_desc(jparse(text)), dict(cfg, early_exit=True))
    assert_within_oracle_tolerance(on, want)
    assert (off == 0).mean() > 0.5  # an open scene: most pixels see the dark sky


def test_renderer_resolves_dof_from_the_aperture():
    r = Renderer(parse_scene(LENS), RenderConfig(trace_depth=2, samples_per_launch=1),
                 device="cpu")
    assert r.config.dof is True
    r.render(1)
    assert np.isfinite(r.linear_image()).all()
    pin = Renderer(parse_scene(GLASS), RenderConfig(trace_depth=2), device="cpu")
    assert pin.config.dof is False
