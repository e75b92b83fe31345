"""PyTorch port on a CUDA card: the hand-written megakernel against its plain
PyTorch version, on the same small scenes as test_torch_megakernel.py.

This module imports neither jax nor the JAX package, so it also runs where
only the port is installed (``python -m pytest tests/test_torch_cuda.py
--noconftest``); without a CUDA device its kernel cases skip.

Two tolerances live here. ``assert_within_oracle_tolerance`` is the bound
of the port against the JAX interpret-mode oracle (test_torch_megakernel.py
and test_torch_engine.py state its reason). ``assert_matches_plain_version``
is the bound of the kernel against its plain version on the same card, where
both run the same IEEE operations in the same order (the kernel is built
without multiply-add contraction) and the same CUDA sinf/cosf: at most 1e-4
of pixels with a max-channel |Δ| above 1e-3, and per-channel image means
within 1e-4. Measured on an H100 at 800×800, depth 8: the kernel is
bit-identical to the plain version (max |Δ| 0), while a build with
contraction on (-fmad=true) differs in 1.25e-5 of pixels by more than 1e-3
with a mean gap of 2.5e-5 (scripts/torch_measure.py). The bound leaves room
for last-ulp noise of that size, while a fault on more than 64 of 640,000
pixels fails it.
"""

import os

import numpy as np
import pytest
import torch

from cosc_4397_pathtracing_raytracing_project_tpu_torch import RenderConfig, Scene, parse_scene
from cosc_4397_pathtracing_raytracing_project_tpu_torch.ops.cuda import megakernel as tmk

torch.set_num_threads(2)

_CORNELL = os.path.join(os.path.dirname(__file__), "..", "scenes", "cornell.txt")


def assert_within_oracle_tolerance(got, want):
    assert got.shape == want.shape and got.dtype == np.float32
    assert np.isfinite(got).all()
    diff = np.abs(got - want).max(axis=-1)
    frac = float((diff > 1e-3).mean())
    assert frac <= 0.005, f"{frac:.4%} of pixels differ by more than 1e-3"
    np.testing.assert_allclose(got.mean(axis=0), want.mean(axis=0), rtol=5e-3)


def assert_matches_plain_version(got, want):
    assert got.shape == want.shape and got.dtype == np.float32
    assert np.isfinite(got).all()
    diff = np.abs(got - want).max(axis=-1)
    frac = float((diff > 1e-3).mean())
    assert frac <= 1e-4, f"{frac:.4%} of pixels differ by more than 1e-3"
    np.testing.assert_allclose(got.mean(axis=0), want.mean(axis=0), rtol=1e-4)


def _small(rotated=False):
    text = open(_CORNELL).read().replace("RES         800 800", "RES         64 64")
    if rotated:
        text = text.replace("ROTAT       0 0 90", "ROTAT       20 45 10", 1)
    return parse_scene(text)


CASES = {
    "a-depth1-aa-sobol": (False, dict(trace_depth=1, antialias=True, sampler="sobol")),
    "b-depth3-hoisted-sobol": (False, dict(trace_depth=3, sampler="sobol")),
    "c-depth3-independent": (False, dict(trace_depth=3)),
    "d-rotated-depth2": (True, dict(trace_depth=2)),
    "e-depth8-sobol": (False, dict(trace_depth=8, sampler="sobol")),
    "f-depth8-aa-independent-sky": (
        False, dict(trace_depth=8, antialias=True, sky_strength=0.5)
    ),
}


def test_small_scene_is_the_cornell_box():
    desc = _small(rotated=True)
    assert desc.camera.resolution == (64, 64) and desc.num_geoms == 7
    kinds = tmk.static_geom_kinds(Scene.from_desc(desc, "cpu"))
    assert any(perm is None for _, perm in kinds)


@pytest.mark.skipif("not torch.cuda.is_available()", reason="needs a CUDA device")
@pytest.mark.parametrize("case", list(CASES))
def test_cuda_kernel_matches_plain_version(case):
    rotated, cfg = CASES[case]
    desc = _small(rotated)
    config = RenderConfig(**cfg)
    scene = Scene.from_desc(desc, "cuda")
    launches = tmk.KERNEL.launches
    got = tmk.render_samples(scene, config, 7, 1, 2)
    assert tmk.KERNEL.launches == launches + 1
    pix = torch.arange(scene.camera.pixel_count, device="cuda")
    want = tmk.render_samples_reference(
        pix, tmk.pack_scene(scene), tmk.kernel_options(config), 7, 1, 2
    )
    assert_matches_plain_version(got.cpu().numpy(), want.cpu().numpy())
