"""PyTorch port, next-event estimation in the megakernel (kernel K2): the
light table against the JAX ``_static_light_table``, the plain version
against the JAX Pallas kernel in interpret mode (the oracle) with
``nee=True``, and the ``ValueError`` cases against the JAX package's.

Tolerance: that of test_torch_megakernel.py (at most 0.5% of pixels with a
max-channel |Δ| above 1e-3, per-channel means within 0.5%), for the reason
it states: the oracle's in-kernel reciprocal is an approximation plus one
Newton step and the port divides exactly. NEE adds seven such reciprocals
per vertex (light pdf, normal length, distance, MIS weights), so fewer
pixels are bit-identical than without NEE. Measured on the development host
(jax 0.9.0, torch 2.13.0 CPU), CORNELL_SMALL, depth 3, 2 spp, with
``pytest -s``: 0.098% / 0.195% / 0.073% of pixels above 1e-3 (independent,
sobol, two lights), 32-39% of pixels bit-identical, channel means within
0.04%.
"""

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

# the sphere becomes a second light, on its own material (sphere sampling
# and the light-pick draw; the same edit as test_megakernel.py's)
TWO_LIGHTS = CORNELL_SMALL.replace(
    "MATERIAL 4\nRGB .98 .98 .98", "MATERIAL 4\nRGB 1 .9 .7"
).replace(
    "SPECRGB .98 .98 .98\nREFL 1\nREFR 0\nREFRIOR 0\nEMITTANCE 0",
    "SPECRGB 0 0 0\nREFL 0\nREFR 0\nREFRIOR 0\nEMITTANCE 2",
)
# a second emitter sharing the ceiling light's material
SHARED_MATERIAL = CORNELL_SMALL + (
    "\nOBJECT 7\nsphere\nmaterial 0\nTRANS 2 2 0\nROTAT 0 0 0\nSCALE 1 1 1\n"
)
NO_LIGHTS = CORNELL_SMALL.replace("EMITTANCE 1.5", "EMITTANCE 0")

CASES = {
    "independent": (CORNELL_SMALL, dict(trace_depth=3, nee=True)),
    "sobol": (CORNELL_SMALL, dict(trace_depth=3, nee=True, sampler="sobol")),
    "two-lights": (TWO_LIGHTS, dict(trace_depth=3, nee=True)),
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


def _oracle(text, cfg):
    scene = JScene.from_desc(jparse(text))
    out = jmk.render_samples(
        scene, JConfig(**cfg), jnp.int32(SEED), jnp.int32(1), N_SAMPLES, interpret=True
    )
    return np.asarray(out)


def _port(text, cfg):
    scene = Scene.from_desc(parse_scene(text), "cpu")
    return tmk.render_samples(scene, RenderConfig(**cfg), SEED, 1, N_SAMPLES).numpy()


@pytest.mark.parametrize("text", [CORNELL_SMALL, TWO_LIGHTS], ids=["one-cube", "cube+sphere"])
def test_light_table_equals_jax(text):
    want_n, want_rows = jmk._static_light_table(JScene.from_desc(jparse(text)))
    got = tmk.static_light_table(Scene.from_desc(parse_scene(text), "cpu"))
    assert got.count == want_n
    for i, (kind, mat, a, tr, ait, det, le) in enumerate(want_rows):
        assert (int(got.kind[i]), int(got.mat[i])) == (kind, mat)
        np.testing.assert_array_equal(got.a[i], np.float32(a))
        np.testing.assert_array_equal(got.tr[i], np.float32(tr))
        np.testing.assert_array_equal(got.ait[i], np.float32(ait))
        assert got.det[i] == np.float32(det)
        np.testing.assert_array_equal(got.le[i], np.float32(le))
        pdf_obj = jmk._INV_PI if kind == 1 else 1.0 / 6.0
        assert got.pdf[i] == np.float32(pdf_obj / want_n)
    assert got.packed()[0].shape == (want_n * 26,)


@pytest.mark.parametrize("case", list(CASES))
def test_plain_version_matches_oracle(case):
    text, cfg = CASES[case]
    assert_within_oracle_tolerance(_port(text, cfg), _oracle(text, cfg))


@pytest.mark.parametrize(
    "text, cfg, match",
    [
        (CORNELL_SMALL, dict(nee=True, gather_mode="throughput"), "light_only"),
        (NO_LIGHTS, dict(nee=True), "no analytic"),
        (SHARED_MATERIAL, dict(nee=True), "material"),
    ],
    ids=["throughput", "no-emitters", "shared-material"],
)
def test_value_errors_match_jax(text, cfg, match):
    with pytest.raises(ValueError, match=match):
        jmk.render_samples(
            JScene.from_desc(jparse(text)), JConfig(**cfg), jnp.int32(0), jnp.int32(1), 1,
            interpret=True,
        )
    with pytest.raises(ValueError, match=match):
        tmk.render_samples(Scene.from_desc(parse_scene(text), "cpu"), RenderConfig(**cfg), 0, 1, 1)


def test_renderer_rejects_nee_with_throughput():
    with pytest.raises(ValueError, match="light_only"):
        Renderer(parse_scene(CORNELL_SMALL), RenderConfig(nee=True, gather_mode="throughput"),
                 device="cpu")
