"""PyTorch port on a CUDA card: the hand-written megakernel against its plain
PyTorch version, on the same small scenes as test_torch_megakernel.py.

This module imports neither jax nor the JAX package, so it also runs where
only the port is installed (``python -m pytest tests/test_torch_cuda.py
--noconftest``); without a CUDA device its kernel cases (marked ``cuda``)
skip.

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

from cosc_4397_pathtracing_raytracing_project_tpu_torch import (
    AdaptiveRenderer,
    RenderConfig,
    Scene,
    parse_scene,
)
from cosc_4397_pathtracing_raytracing_project_tpu_torch.ops.cuda import megakernel as tmk

torch.set_num_threads(2)

_SCENES = os.path.join(os.path.dirname(__file__), "..", "scenes")


def assert_within_oracle_tolerance(got, want):
    assert got.shape == want.shape and got.dtype == np.float32
    assert np.isfinite(got).all()
    diff = np.abs(got - want).max(axis=-1)
    frac = float((diff > 1e-3).mean())
    gap = np.abs(got.mean(axis=0) / want.mean(axis=0) - 1.0).max()
    # the readings the test docstrings quote (shown with pytest -s)
    print(f"vs oracle: share |d|>1e-3 {frac:.5f}, bit-identical "
          f"{float((diff == 0).mean()):.4f}, max |d| {diff.max():.3e}, mean gap {gap:.2e}")
    assert frac <= 0.005, f"{frac:.4%} of pixels differ by more than 1e-3"
    np.testing.assert_allclose(got.mean(axis=0), want.mean(axis=0), rtol=5e-3)


def assert_matches_plain_version(got, want):
    assert got.shape == want.shape and got.dtype == np.float32
    assert np.isfinite(got).all()
    diff = np.abs(got - want).max(axis=-1)
    frac = float((diff > 1e-3).mean())
    assert frac <= 1e-4, f"{frac:.4%} of pixels differ by more than 1e-3"
    np.testing.assert_allclose(got.mean(axis=0), want.mean(axis=0), rtol=1e-4)


def _scene_text(name, res=64):
    text = open(os.path.join(_SCENES, name)).read()
    return text.replace("RES         800 800", f"RES         {res} {res}")


def two_light_golden(text):
    """cornell_golden with its sphere turned into a second light on its own
    material (covers sphere-light sampling and the light-pick draw)."""
    text = text.replace(
        "// Specular white\nMATERIAL 4\nRGB         .98 .98 .98\nSPECEX      0\n"
        "SPECRGB     .98 .98 .98\nREFL        1",
        "// Sphere light\nMATERIAL 4\nRGB         1 .9 .7\nSPECEX      0\n"
        "SPECRGB     0 0 0\nREFL        0",
    ).replace("REFRIOR     0\nEMITTANCE   0\n\n// Camera", "REFRIOR     0\nEMITTANCE   2\n\n// Camera")
    return text.replace("// Sphere\nOBJECT 6\nsphere\nmaterial 1", "// Sphere\nOBJECT 6\nsphere\nmaterial 4")


def with_aperture(text, aperture=0.3):
    """The camera with a thin lens, as the CLI's --aperture sets it
    (auto-focus on LOOKAT)."""
    return text.replace("LOOKAT", f"APERTURE    {aperture}\nLOOKAT", 1)


def _small(rotated=False):
    text = _scene_text("cornell.txt")
    if rotated:
        text = text.replace("ROTAT       0 0 90", "ROTAT       20 45 10", 1)
    return parse_scene(text)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


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

# the slice's options, one scene text each (64×64, depth 8)
OPTION_CASES = {
    "nee-aa-sobol": ("cornell_golden.txt", None, dict(nee=True, antialias=True, sampler="sobol")),
    "nee-two-lights": ("cornell_golden.txt", two_light_golden, dict(nee=True)),
    "glass-dof-nee-sobol": (
        "cornell_glass.txt", with_aperture,
        dict(enable_refraction=True, dof=True, nee=True, sampler="sobol"),
    ),
    "glass-dof-aa-independent": (
        "cornell_glass.txt", with_aperture,
        dict(enable_refraction=True, dof=True, antialias=True),
    ),
    "throughput": ("cornell.txt", None, dict(gather_mode="throughput")),
    "sphere-early-exit": ("sphere.txt", None, dict(early_exit=True)),
}


def _option_scene(case, device):
    name, edit, cfg = OPTION_CASES[case]
    text = _scene_text(name)
    if edit is not None:
        text = edit(text)
    return Scene.from_desc(parse_scene(text), device), RenderConfig(**cfg)


def test_small_scene_is_the_cornell_box():
    desc = _small(rotated=True)
    assert desc.camera.resolution == (64, 64) and desc.num_geoms == 7
    kinds = tmk.static_geom_kinds(Scene.from_desc(desc, "cpu"))
    assert any(perm is None for _, perm in kinds)


def test_option_scenes_carry_their_options():
    """The edited scene texts really hold what their cases exercise."""
    two, _ = _option_scene("nee-two-lights", "cpu")
    lights = tmk.static_light_table(two)
    assert lights.count == 2 and sorted(lights.kind.tolist()) == [0, 1]
    lens, _ = _option_scene("glass-dof-nee-sobol", "cpu")
    assert float(lens.camera.aperture) == pytest.approx(0.3)
    assert np.any(tmk.pack_scene(lens).mats.reshape(-1, 10)[:, 9] > 0)


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(CASES))
def test_cuda_kernel_matches_plain_version(case, cuda):
    rotated, cfg = CASES[case]
    desc = _small(rotated)
    config = RenderConfig(**cfg)
    scene = Scene.from_desc(desc, cuda)
    launches = tmk.KERNEL.launches
    got = tmk.render_samples(scene, config, 7, 1, 2)
    assert tmk.KERNEL.launches == launches + 1
    pix = torch.arange(scene.camera.pixel_count, device=cuda)
    want = tmk.render_samples_reference(
        pix, tmk.pack_scene(scene), tmk.kernel_options(config), 7, 1, 2
    )
    assert_matches_plain_version(got.cpu().numpy(), want.cpu().numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(OPTION_CASES))
def test_cuda_kernel_options_match_plain_version(case, cuda):
    scene, config = _option_scene(case, cuda)
    launches = tmk.KERNEL.launches
    got = tmk.render_samples(scene, config, 7, 1, 2)
    assert tmk.KERNEL.launches == launches + 1
    pix = torch.arange(scene.camera.pixel_count, device=cuda)
    opts = tmk.kernel_options(config)
    want = tmk.render_samples_reference(
        pix, tmk.pack_scene(scene, nee=opts.nee), opts, 7, 1, 2
    )
    assert_matches_plain_version(got.cpu().numpy(), want.cpu().numpy())


@pytest.mark.cuda
def test_cuda_early_exit_is_bit_identical(cuda):
    scene, config = _option_scene("sphere-early-exit", cuda)
    on = tmk.render_samples(scene, config, 7, 1, 2)
    off = tmk.render_samples(scene, RenderConfig(), 7, 1, 2)
    torch.testing.assert_close(on, off, rtol=0, atol=0)


@pytest.mark.cuda
def test_cuda_tile_dispatch_matches_plain_version(cuda):
    """K6: 4 chosen tiles (one repeated) with distinct iteration bases."""
    scene, _ = _option_scene("nee-aa-sobol", cuda)
    config = RenderConfig(nee=True, sampler="sobol")
    packed = tmk.pack_scene(scene, nee=True)
    ids = torch.tensor([1, 0, 1, 3], dtype=torch.int32, device=cuda)
    bases = torch.tensor([1, 5, 9, 3], dtype=torch.int32, device=cuda)
    n = scene.camera.pixel_count
    rng = np.random.default_rng(3)
    flat = torch.as_tensor(rng.integers(0, n, 4 * tmk.TILE), device=cuda)
    px = (flat % 64).to(torch.float32)
    py = (flat // 64).to(torch.float32)
    launches = tmk.KERNEL.launches
    got = tmk.render_tiles(scene, config, 7, ids, bases, px, py, 2, packed=packed)
    assert tmk.KERNEL.launches == launches + 1
    want = tmk.render_tiles_reference(
        px, py, ids, bases, packed, tmk.kernel_options(config), 7, 2
    )
    assert_matches_plain_version(got.cpu().numpy(), want.cpu().numpy())


@pytest.mark.cuda
def test_cuda_adaptive_renderer_runs_the_tile_kernel(cuda):
    text = _scene_text("cornell_golden.txt", res=128)
    r = AdaptiveRenderer(parse_scene(text), RenderConfig(nee=True, sampler="sobol"), device=cuda)
    launches = tmk.KERNEL.launches
    r.render(8, warmup_spp=4, round_spp=2, frac=0.5)
    assert tmk.KERNEL.launches > launches
    assert r.avg_spp >= 8.0 and r.spp_map().min() >= 4
    img = r.linear_image()
    assert img.shape == (128, 128, 3) and np.isfinite(img).all() and img.mean() > 0
