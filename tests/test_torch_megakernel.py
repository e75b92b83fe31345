"""PyTorch port, the megakernel: the plain PyTorch version against the JAX
Pallas kernel in interpret mode (the oracle) on CORNELL_SMALL, 2 spp.
test_torch_cuda.py holds the CUDA kernel against the plain version.

Tolerance. The oracle's in-kernel reciprocal is an approximation plus one
Newton step (``megakernel._recip``), the port divides exactly, and XLA's and
torch's CPU sin/cos/rsqrt can differ in the last ulp, so a last-ulp change
can flip a discrete outcome (Russian roulette, the specular branch) for a
pixel. Past depth 1, two JAX pipelines flip about 0.2% of such outcomes
(``test_megakernel.py``). The bound is therefore: at most 0.5% of pixels
with a max-channel |Δ| above 1e-3, and per-channel image means within 0.5%.
Measured on the development host (jax 0.9.0, torch 2.13.0 CPU): 0 pixels
above 1e-3 in every case; cases (a)-(d) bit-identical, case (e) 98% of
pixels bit-identical with max |Δ| 9.5e-6.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cosc_4397_pathtracing_raytracing_project_tpu import RenderConfig as JConfig
from cosc_4397_pathtracing_raytracing_project_tpu.ops.pallas import megakernel as jmk
from cosc_4397_pathtracing_raytracing_project_tpu.scene import Scene as JScene
from cosc_4397_pathtracing_raytracing_project_tpu.scene import parse_scene as jparse
from cosc_4397_pathtracing_raytracing_project_tpu_torch import RenderConfig, Scene, parse_scene
from cosc_4397_pathtracing_raytracing_project_tpu_torch.ops.cuda import megakernel as tmk

from test_render import CORNELL_SMALL
from test_torch_cuda import assert_within_oracle_tolerance

torch.set_num_threads(2)

ROTATED = CORNELL_SMALL.replace("ROTAT 0 0 90", "ROTAT 20 45 10", 1)
N_SAMPLES = 2
SEED = 0

CASES = {
    "a-depth1-aa-sobol": (CORNELL_SMALL, dict(trace_depth=1, antialias=True, sampler="sobol")),
    "b-depth3-hoisted-sobol": (CORNELL_SMALL, dict(trace_depth=3, sampler="sobol", ld_depths=2)),
    "c-depth3-independent": (CORNELL_SMALL, dict(trace_depth=3, sampler="independent")),
    "d-rotated-depth2": (ROTATED, dict(trace_depth=2)),
}


@pytest.fixture(autouse=True)
def oracle_tiles():
    """The JAX tests' interpret-mode tile (32 rows × 128 lanes = 4096 px),
    on both sides. The jitted oracle bakes TILE in at trace time, so its
    cache is cleared on the way in and out."""
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


def _port(text, cfg, device="cpu"):
    scene = Scene.from_desc(parse_scene(text), device)
    return tmk.render_samples(scene, RenderConfig(**cfg), SEED, 1, N_SAMPLES)


@pytest.mark.parametrize("case", list(CASES))
def test_plain_version_matches_oracle(case):
    text, cfg = CASES[case]
    assert_within_oracle_tolerance(_port(text, cfg).numpy(), _oracle(text, cfg))


@pytest.mark.slow
def test_plain_version_matches_oracle_depth8():
    """(e) the main path's depth 8, with Russian roulette past depth 3."""
    cfg = dict(trace_depth=8, sampler="sobol", ld_depths=2)
    assert_within_oracle_tolerance(
        _port(CORNELL_SMALL, cfg).numpy(), _oracle(CORNELL_SMALL, cfg)
    )


def test_generic_transform_path_is_exercised():
    kinds = tmk.static_geom_kinds(Scene.from_desc(parse_scene(ROTATED), "cpu"))
    assert any(perm is None for _, perm in kinds)
    assert any(perm is not None for _, perm in kinds)


def test_sample_batches_accumulate_in_order():
    """Splitting a launch changes nothing but the float sum's grouping:
    the plain version's sample sub-batches must equal one batch exactly."""
    text, cfg = CASES["c-depth3-independent"]
    scene = Scene.from_desc(parse_scene(text), "cpu")
    packed = tmk.pack_scene(scene)
    opts = tmk.kernel_options(RenderConfig(**cfg))
    pix = torch.arange(scene.camera.pixel_count)
    whole = tmk.render_samples_reference(pix, packed, opts, SEED, 1, 3)
    saved = tmk._REFERENCE_BATCH
    tmk._REFERENCE_BATCH = pix.shape[0]  # one sample per batch
    try:
        split = tmk.render_samples_reference(pix, packed, opts, SEED, 1, 3)
    finally:
        tmk._REFERENCE_BATCH = saved
    torch.testing.assert_close(split, whole, rtol=0, atol=0)


@pytest.mark.parametrize(
    "field, value",
    [("nee", True), ("enable_refraction", True), ("dof", True),
     ("early_exit", True), ("gather_mode", "throughput")],
)
def test_unported_estimator_options_raise(field, value):
    scene = Scene.from_desc(parse_scene(CORNELL_SMALL), "cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tmk.render_samples(scene, RenderConfig(**{field: value}), SEED, 1, 1)
