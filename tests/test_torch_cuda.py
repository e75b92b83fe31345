"""PyTorch port on a CUDA card: the hand-written megakernel against its plain
PyTorch version, on the same small scenes as test_torch_megakernel.py, the
option scenes of slice 2 and the environment scenes of slice 3 (the meadow
map of scenes/env_spheres.txt and small synthetic maps, whose helpers the
CPU environment tests share).

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
from cosc_4397_pathtracing_raytracing_project_tpu_torch.io.png import write_hdr
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


def write_env_map(directory, kind):
    """A small synthetic environment map as an HDR file in ``directory``:
    'const' is 8×16 texels of 0.7, 'sun' 16×32 texels of a dim 0.05 sky
    with one hard bright texel (the env-NEE stress case)."""
    if kind == "const":
        img = np.full((8, 16, 3), 0.7, np.float32)
    else:
        img = np.full((16, 32, 3), 0.05, np.float32)
        img[4, 7] = [120.0, 100.0, 80.0]
    return write_hdr(os.path.join(str(directory), f"{kind}.hdr"), img)


def env_scene_text(map_file, res=64, light=False):
    """A ground slab, a diffuse and a mirror sphere under the environment
    ``map_file``; with ``light``, also a small emissive sphere."""
    text = f"""MATERIAL 0
RGB         .7 .7 .7
SPECEX      0
SPECRGB     0 0 0
REFL        0
REFR        0
REFRIOR     0
EMITTANCE   0

MATERIAL 1
RGB         .9 .9 .9
SPECEX      0
SPECRGB     .9 .9 .9
REFL        1
REFR        0
REFRIOR     0
EMITTANCE   0

MATERIAL 2
RGB         1 .9 .8
SPECEX      0
SPECRGB     0 0 0
REFL        0
REFR        0
REFRIOR     0
EMITTANCE   4

ENVIRONMENT
FILE {os.path.basename(map_file)}
STRENGTH 1

CAMERA
RES         {res} {res}
FOVY        35
ITERATIONS  64
DEPTH       3
FILE        env
EYE         0 1.5 7
LOOKAT      0 0.5 0
UP          0 1 0

OBJECT 0
cube
material 0
TRANS       0 -0.5 0
ROTAT       0 0 0
SCALE       20 1 20

OBJECT 1
sphere
material 0
TRANS       0.6 1 0
ROTAT       0 0 0
SCALE       2 2 2

OBJECT 2
sphere
material 1
TRANS       -1.6 0.6 1
ROTAT       0 0 0
SCALE       1.2 1.2 1.2
"""
    if light:
        text += "\nOBJECT 3\nsphere\nmaterial 2\nTRANS 1.5 2.6 1\nROTAT 0 0 0\nSCALE .6 .6 .6\n"
    return text


def env_spheres_text(res=64, aperture=None):
    """scenes/env_spheres.txt (the meadow map) at ``res``², optionally with
    a thin lens."""
    text = _scene_text("env_spheres.txt", res)
    return with_aperture(text, aperture) if aperture is not None else text


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


# the environment variants (kernels K3-K5), 64×64, depth 8: (scene, config)
ENV_CASES = {
    "exact": ("meadow", None, dict()),
    "exact-sobol-aa": ("meadow", None, dict(sampler="sobol", antialias=True)),
    "exact-refraction-dof": ("meadow", 0.2, dict(enable_refraction=True, dof=True)),
    "env-nee": ("meadow", None, dict(nee=True)),
    "env-nee-refraction-sobol": ("meadow", None, dict(nee=True, enable_refraction=True,
                                                     sampler="sobol")),
    "split-composite": ("meadow", None, dict(env_mode="split")),
    "split-aa-refraction": ("meadow", None, dict(env_mode="split", antialias=True,
                                                 enable_refraction=True)),
    "split-nee": ("sun+light", None, dict(env_mode="split", nee=True)),
}


def _env_case(case, device, tmp_path):
    kind, aperture, cfg = ENV_CASES[case]
    if kind == "meadow":
        desc = parse_scene(env_spheres_text(aperture=aperture), base_dir=_SCENES)
    else:
        path = write_env_map(tmp_path, "sun")
        desc = parse_scene(env_scene_text(path, light=True), base_dir=str(tmp_path))
    return Scene.from_desc(desc, device), RenderConfig(**cfg)


@pytest.mark.parametrize("case", list(ENV_CASES))
def test_env_cases_carry_their_options(case, tmp_path):
    """Each environment case selects the variant it names, on the CPU."""
    scene, config = _env_case(case, "cpu", tmp_path)
    opts = tmk.kernel_options(config, scene)
    want = {"exact": "env_exact", "env": "env_nee", "split": "env_split"}[case.split("-")[0]]
    assert tmk.variant_name(opts).endswith(want)
    assert opts.nee == (case == "split-nee")
    assert opts.bg_external == (case in ("split-composite", "split-nee"))


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(ENV_CASES))
def test_cuda_env_kernel_matches_plain_version(case, cuda, tmp_path):
    scene, config = _env_case(case, cuda, tmp_path)
    opts = tmk.kernel_options(config, scene)
    packed = tmk.pack_scene(scene, nee=opts.nee, config=config)
    launches = tmk.KERNEL.launches_by_variant.get(tmk.variant_name(opts), 0)
    got = tmk.KERNEL(packed, opts, 7, 1, 2, cuda)
    assert tmk.KERNEL.launches_by_variant[tmk.variant_name(opts)] == launches + 1
    pix = torch.arange(scene.camera.pixel_count, device=cuda)
    want = tmk.render_samples_reference(pix, packed, opts, 7, 1, 2)
    assert_matches_plain_version(got.cpu().numpy(), want.cpu().numpy())


@pytest.mark.cuda
def test_cuda_env_tile_dispatch_matches_plain_version(cuda):
    """K6 with the exact environment (K3): 4 tiles with distinct bases."""
    scene = Scene.from_desc(parse_scene(env_spheres_text(), base_dir=_SCENES), cuda)
    config = RenderConfig(sampler="sobol")
    opts = tmk.kernel_options(config, scene)
    packed = tmk.pack_scene(scene, config=config)
    ids = torch.tensor([1, 0, 1, 3], dtype=torch.int32, device=cuda)
    bases = torch.tensor([1, 5, 9, 3], dtype=torch.int32, device=cuda)
    flat = torch.as_tensor(np.random.default_rng(3).integers(0, 64 * 64, 4 * tmk.TILE),
                           device=cuda)
    px = (flat % 64).to(torch.float32)
    py = (flat // 64).to(torch.float32)
    got = tmk.render_tiles(scene, config, 7, ids, bases, px, py, 2, packed=packed)
    want = tmk.render_tiles_reference(px, py, ids, bases, packed, opts, 7, 2)
    assert_matches_plain_version(got.cpu().numpy(), want.cpu().numpy())


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
