"""PyTorch port, the megakernel's exact environment (kernel K3): the plain
version against the JAX Pallas kernel in interpret mode (the oracle)
through ``render_samples``, on the synthetic maps and on env_spheres'
meadow map with refraction and a thin lens. Env NEE (K4) is in
test_torch_env_nee.py, the split mode (K5) and the tile dispatch with the
exact environment in test_torch_env_split.py; the three files share this
one's fixture and scenes, split so that each runs well inside its time
alone (each oracle configuration compiles for 10-25 s).

Tolerance: that of test_torch_megakernel.py (at most 0.5% of pixels with a
max-channel |Δ| above 1e-3, per-channel means within 0.5%), for the reasons
it and ROADMAP Queue 3 state (the oracle's approximate reciprocal; XLA and
torch trigonometry differ in the last ulp). Two more reasons here: the
oracle's bilinear lookup is an f32 one-hot matrix product on XLA:CPU, which
may contract its two nonzero terms into a fused multiply-add where the port
rounds each product, and it weights the escape against env NEE with its
approximate reciprocal where the port takes an exact one. Near a map's
bright sun texel an ulp is large, so those pixels carry the differences.
Measured on the development host (jax 0.9.0, torch 2.13.0 CPU), 64×64,
depth 3, 2 spp, 4096-px tiles, with ``pytest -s``: 0.024% of pixels above
1e-3 (sun map, independent; one pixel, |Δ| 1.1e-2), 0% (constant map,
sobol, max |Δ| 1.2e-7), 0% (meadow, refraction + lens, max |Δ| 8.6e-4);
58-99% bit-identical; channel means within 4.6e-6.
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
from cosc_4397_pathtracing_raytracing_project_tpu_torch import RenderConfig, Scene, parse_scene
from cosc_4397_pathtracing_raytracing_project_tpu_torch.ops.cuda import megakernel as tmk

from test_torch_cuda import (
    assert_within_oracle_tolerance,
    env_scene_text,
    env_spheres_text,
    write_env_map,
)

torch.set_num_threads(2)

SCENES = os.path.join(os.path.dirname(__file__), "..", "scenes")
N_SAMPLES = 2
SEED = 0

# (map, lens aperture, config); maps: the synthetic 'sun' / 'const' of
# test_torch_cuda.write_env_map under env_scene_text, or env_spheres' meadow
CASES = {
    "exact-independent": ("sun", None, dict(trace_depth=3), "env_exact"),
    "exact-sobol": ("const", None, dict(trace_depth=3, sampler="sobol"), "env_exact"),
    "exact-refraction-dof-meadow": ("meadow", 0.2, dict(trace_depth=3, enable_refraction=True,
                                                        dof=True), "refraction+dof+env_exact"),
}


@pytest.fixture(autouse=True)
def oracle_tiles():
    """The JAX tests' interpret-mode tile (4096 px) on both sides; the
    jitted oracle bakes TILE in at trace time, so its cache is cleared."""
    saved = jmk.TILE_ROWS, jmk.TILE, tmk.TILE
    jmk.TILE_ROWS, jmk.TILE, tmk.TILE = 32, 32 * 128, 32 * 128
    jmk._render_samples_impl.clear_cache()
    jmk._render_tiles_impl.clear_cache()
    yield
    jmk.TILE_ROWS, jmk.TILE, tmk.TILE = saved
    jmk._render_samples_impl.clear_cache()
    jmk._render_tiles_impl.clear_cache()


def scene_pair(kind, tmp_path, aperture=None, light=False):
    """(JAX scene, port scene on the CPU) of one map."""
    if kind == "meadow":
        text, base = env_spheres_text(aperture=aperture), SCENES
    else:
        text, base = env_scene_text(write_env_map(tmp_path, kind), light=light), str(tmp_path)
    return (JScene.from_desc(jparse(text, base_dir=base)),
            Scene.from_desc(parse_scene(text, base_dir=base), "cpu"))


def check_case(kind, aperture, cfg, tmp_path, variant, light=False):
    """The plain version against the oracle on one scene and configuration,
    after checking that the configuration selects ``variant``."""
    jscene, scene = scene_pair(kind, tmp_path, aperture, light)
    config = RenderConfig(**cfg)
    assert tmk.variant_name(tmk.kernel_options(config, scene)) == variant
    want = np.asarray(jmk.render_samples(
        jscene, JConfig(**cfg), jnp.int32(SEED), jnp.int32(1), N_SAMPLES, interpret=True))
    got = tmk.render_samples(scene, config, SEED, 1, N_SAMPLES)
    assert_within_oracle_tolerance(got.numpy(), want)


@pytest.mark.parametrize("case", list(CASES))
def test_plain_version_matches_oracle(case, tmp_path):
    kind, aperture, cfg, variant = CASES[case]
    check_case(kind, aperture, cfg, tmp_path, variant)

