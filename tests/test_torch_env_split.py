"""PyTorch port, the megakernel's sun/sky split (kernel K5): delta suns,
the SH-9 residual sky and the exact background composited outside the
kernel; and the tile dispatch (K6) with the exact environment (K3). The
plain version against the JAX Pallas kernel in interpret mode (the
oracle), as test_torch_env_kernel.py does and with its tolerance and
reasons. The composite runs without antialiasing (primary rays
iteration-invariant); with it, depth-0 misses take the SH sky in the
kernel; with analytic emitters under ``nee``, the suns join NEE (K2).

Measured on the development host (jax 0.9.0, torch 2.13.0 CPU), 64×64,
depth 3, 2 spp, with ``pytest -s``: composite, antialiased and with NEE of
an emissive sphere 0% of pixels above 1e-3 (max |Δ| 7.4e-5), tile dispatch
0.016% (max |Δ| 1.1e-3); channel means within 5.4e-7.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cosc_4397_pathtracing_raytracing_project_tpu import RenderConfig as JConfig
from cosc_4397_pathtracing_raytracing_project_tpu.ops.pallas import megakernel as jmk
from cosc_4397_pathtracing_raytracing_project_tpu_torch import RenderConfig
from cosc_4397_pathtracing_raytracing_project_tpu_torch.ops.cuda import megakernel as tmk
from cosc_4397_pathtracing_raytracing_project_tpu_torch.render import adaptive as tad

from test_torch_cuda import assert_within_oracle_tolerance
from test_torch_env_kernel import N_SAMPLES, check_case, oracle_tiles, scene_pair  # noqa: F401

torch.set_num_threads(2)

CASES = {
    "composite": (False, dict(trace_depth=3, env_mode="split"), "env_split"),
    "antialias": (False, dict(trace_depth=3, env_mode="split", antialias=True), "env_split"),
    "analytic-nee": (True, dict(trace_depth=3, env_mode="split", nee=True), "nee+env_split"),
}


@pytest.mark.parametrize("case", list(CASES))
def test_plain_version_matches_oracle(case, tmp_path):
    light, cfg, variant = CASES[case]
    check_case("sun", None, cfg, tmp_path, variant, light=light)


def test_render_tiles_matches_oracle(tmp_path):
    """The tile dispatch with the exact environment (K6 + K3): three of the
    two 2048-px tiles, one repeated, with distinct 1-based iteration bases."""
    cfg = dict(trace_depth=3, sampler="sobol")
    jscene, scene = scene_pair("sun", tmp_path)
    tmk.TILE = 2048  # the default tile layout of the adaptive sampler, both sides
    jmk.TILE_ROWS, jmk.TILE = 16, 2048
    px, py, _, _ = tad.make_tile_layout(64, 64)
    ids = np.array([1, 0, 1], np.int32)
    bases = np.array([1, 4, 9], np.int32)
    tpx, tpy = px[ids].reshape(-1), py[ids].reshape(-1)
    want = np.asarray(jmk.render_tiles(
        jscene, JConfig(**cfg), jnp.int32(7), jnp.asarray(ids), jnp.asarray(bases),
        jnp.asarray(tpx).reshape(-1, jmk.LANES), jnp.asarray(tpy).reshape(-1, jmk.LANES),
        N_SAMPLES, interpret=True))
    got = tmk.render_tiles(scene, RenderConfig(**cfg), 7, torch.as_tensor(ids),
                           torch.as_tensor(bases), torch.as_tensor(tpx), torch.as_tensor(tpy),
                           N_SAMPLES)
    assert_within_oracle_tolerance(got.numpy(), want)
