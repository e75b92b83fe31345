"""PyTorch port, the denoiser (``render/denoise.py``) on the CPU against the
JAX package's: the À-Trous filter on a noisy image with flat, two-plane and
rendered AOVs, the firefly clamp, the AOV pass on CORNELL_SMALL and on
mesh1080p at 48×48, the filter's own properties (tests/test_denoise.py's),
chunking, and ``denoised_image`` of both renderers.

Tolerances: the filter on the same inputs is held to the ROADMAP bound (at
most 0.5% of pixels with a max-channel |Δ| above 1e-3, channel means within
0.5%) and to max |Δ| ≤ 1e-4: XLA's ``pow``/``exp`` and torch's may round
differently in the last bits. Measured (``pytest -s``): max |Δ| 4.8e-7 to
5.0e-6, share 0.
The firefly clamp takes only max/min: bit for bit. The AOV pass: miss masks
identical, depth within 1e-5, albedo and normal within 1e-5 but on at most
0.5% of pixels (the ROADMAP's share), where JAX's pass, one jitted
computation, rounds the center ray otherwise and lands on the other face of
an edge or moves a sphere's normal by ~1e-5: there the same JAX functions
called one by one give the port's AOVs within 1e-5. Measured: 5 of
CORNELL_SMALL's 4096 pixels.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cosc_4397_pathtracing_raytracing_project_tpu import RenderConfig as JConfig
from cosc_4397_pathtracing_raytracing_project_tpu import Renderer as JRenderer
from cosc_4397_pathtracing_raytracing_project_tpu.ops import intersect as jintersect
from cosc_4397_pathtracing_raytracing_project_tpu.render import denoise as jd
from cosc_4397_pathtracing_raytracing_project_tpu.scene import Scene as JScene
from cosc_4397_pathtracing_raytracing_project_tpu.scene import load_scene_desc as jload
from cosc_4397_pathtracing_raytracing_project_tpu.scene import parse_scene as jparse
from cosc_4397_pathtracing_raytracing_project_tpu_torch import (
    AdaptiveRenderer,
    RenderConfig,
    Renderer,
    Scene,
    convert,
    load_scene_desc,
    parse_scene,
)
from cosc_4397_pathtracing_raytracing_project_tpu_torch.io.png import read_png
from cosc_4397_pathtracing_raytracing_project_tpu_torch.render import denoise as td

from test_render import CORNELL_SMALL

torch.set_num_threads(2)

MESH1080P = os.path.join(os.path.dirname(__file__), "..", "scenes", "mesh1080p.txt")


def _pair(albedo, normal, depth, miss):
    """The same AOVs for both packages."""
    arrays = [np.array(a) for a in (albedo, normal, depth, miss)]
    return (jd.Aovs(*[jnp.asarray(a) for a in arrays]),
            td.Aovs(*[torch.from_numpy(a) for a in arrays]))


def _flat(h, w, albedo=0.5):
    nrm = np.zeros((h, w, 3), np.float32)
    nrm[..., 2] = 1.0
    return (np.full((h, w, 3), albedo, np.float32), nrm,
            np.full((h, w), 5.0, np.float32), np.zeros((h, w), bool))


def _two_plane(h, w):
    """Left half faces +z, right half faces +x: a hard geometric edge."""
    nrm = np.zeros((h, w, 3), np.float32)
    nrm[:, : w // 2, 2] = 1.0
    nrm[:, w // 2:, 0] = 1.0
    return (np.full((h, w, 3), 0.6, np.float32), nrm,
            np.full((h, w), 5.0, np.float32), np.zeros((h, w), bool))


def _noisy(seed=7, h=64, w=64):
    rng = np.random.default_rng(seed)
    img = np.clip(0.4 + rng.normal(0, 0.15, (h, w, 3)), 0, None).astype(np.float32)
    img[:, w // 2:] *= 2.0  # an illumination step
    img[10, 10] = 40.0  # a firefly
    return img


@pytest.fixture(scope="module")
def cornell_aovs():
    """render_aovs of CORNELL_SMALL, JAX's and the port's."""
    return (jd.render_aovs(JScene.from_desc(jparse(CORNELL_SMALL))),
            td.render_aovs(Scene.from_desc(parse_scene(CORNELL_SMALL), "cpu")))


def _assert_filter_close(got, want):
    diff = np.abs(got - want).max(axis=-1)
    share = float((diff > 1e-3).mean())
    gap = float(np.abs(got.mean(axis=(0, 1)) / want.mean(axis=(0, 1)) - 1.0).max())
    print(f"filter vs JAX: share |d|>1e-3 {share:.5f}, max |d| {diff.max():.3e}, "
          f"mean gap {gap:.2e}")
    assert share <= 0.005 and gap <= 0.005
    assert diff.max() <= 1e-4


@pytest.mark.parametrize("kind", ["flat", "two-plane", "render_aovs"])
def test_filter_matches_jax(kind, cornell_aovs):
    if kind == "render_aovs":
        aovs = [np.asarray(a) for a in cornell_aovs[0]]
    else:
        aovs = (_flat if kind == "flat" else _two_plane)(64, 64)
    jaovs, taovs = _pair(*aovs)
    img = _noisy()
    want = np.asarray(jd.atrous_denoise(jnp.asarray(img), jaovs))
    got = td.atrous_denoise(torch.from_numpy(img), taovs).numpy()
    assert got.dtype == np.float32 and got.shape == img.shape
    _assert_filter_close(got, want)


def test_despeckle_is_bit_for_bit():
    img = _noisy(3)
    np.testing.assert_array_equal(td._despeckle(torch.from_numpy(img)).numpy(),
                                  np.asarray(jd._despeckle(jnp.asarray(img))))


def _assert_aovs_match(jscene, got, want):
    """Miss masks identical and depth within 1e-5; albedo and normal within
    1e-5 but on pixels where JAX's jitted pass rounds otherwise: there the
    JAX functions called one by one on the same pixel give the port's."""
    miss = np.asarray(want.miss)
    np.testing.assert_array_equal(got.miss.numpy(), miss)
    np.testing.assert_allclose(got.depth.numpy(), np.asarray(want.depth), rtol=1e-5, atol=1e-5)
    off = ((np.abs(got.albedo.numpy() - np.asarray(want.albedo)).max(-1) > 1e-5)
           | (np.abs(got.normal.numpy() - np.asarray(want.normal)).max(-1) > 1e-5))
    print(f"AOVs vs JAX: {int(off.sum())} of {off.size} pixels differ from the jitted pass")
    assert off.mean() <= 0.005  # the ROADMAP's share of pixels
    if off.any():
        ys, xs = np.nonzero(off)
        o, d = jd._center_rays(jscene.camera, jnp.asarray(ys * off.shape[1] + xs, jnp.int32))
        hit = jintersect.intersect_scene(jscene, o, d)
        albedo = np.asarray(jintersect.take_rows(jscene.materials.color, hit.material_id))
        np.testing.assert_allclose(got.albedo.numpy()[ys, xs], albedo, atol=1e-5)
        np.testing.assert_allclose(got.normal.numpy()[ys, xs], np.asarray(hit.normal), atol=1e-5)


def test_render_aovs_cornell_matches_jax(cornell_aovs):
    want, got = cornell_aovs
    assert got.albedo.shape == (64, 64, 3) and got.miss.dtype == torch.bool
    _assert_aovs_match(JScene.from_desc(jparse(CORNELL_SMALL)), got, want)


def test_render_aovs_mesh1080p_matches_jax():
    """The mesh scene at 48×48 (tests/test_denoise.py's): sky and terrain,
    the triangles through the same brute-force intersector. The port's
    chunk is set to 256 pixels to bound the [chunk, 38530] blocks here."""
    jdesc = jload(MESH1080P)
    jdesc.camera.resolution = (48, 48)
    desc = load_scene_desc(MESH1080P)
    desc.camera.resolution = (48, 48)
    scene = Scene.from_desc(desc, "cpu")
    jscene = JScene.from_desc(jdesc)
    want = jd.render_aovs(jscene)
    got = td.render_aovs(scene, chunk=256)
    assert got.miss.any() and (~got.miss).any()
    _assert_aovs_match(jscene, got, want)


def test_render_aovs_chunking_is_invariant():
    """Chunks of 500 pixels (a short last chunk) against one chunk: bit for
    bit, each pixel's ray is traced alone."""
    scene = Scene.from_desc(parse_scene(CORNELL_SMALL), "cpu")
    full = td.render_aovs(scene, chunk=64 * 64)
    chunked = td.render_aovs(scene, chunk=500)
    for x, y in zip(full, chunked):
        assert torch.equal(x, y)


class TestFilter:
    """tests/test_denoise.py's properties of the filter, on the port."""

    def test_constant_is_fixed_point(self):
        _, aovs = _pair(*_flat(64, 64))
        img = torch.full((64, 64, 3), 0.37)
        np.testing.assert_allclose(td.atrous_denoise(img, aovs).numpy(), img.numpy(), atol=1e-5)

    def test_normal_edge_not_smeared(self):
        h, w = 64, 64
        _, aovs = _pair(*_two_plane(h, w))
        img = np.full((h, w, 3), 0.2, np.float32)
        img[:, w // 2:] = 0.8
        noisy = np.clip(img + np.random.default_rng(1).normal(0, 0.05, img.shape), 0, None)
        out = td.atrous_denoise(torch.from_numpy(noisy.astype(np.float32)), aovs).numpy()
        left, right = out[:, : w // 2 - 1].mean(), out[:, w // 2 + 1:].mean()
        assert abs(left - 0.2) < 0.02 and abs(right - 0.8) < 0.02
        assert right - left > 0.55

    def test_miss_boundary_not_smeared(self):
        h, w = 64, 64
        miss = np.zeros((h, w), bool)
        miss[:, : w // 2] = True
        albedo, nrm, _, _ = _flat(h, w, albedo=1.0)
        _, aovs = _pair(albedo, nrm, np.where(miss, 0.0, 5.0).astype(np.float32), miss)
        img = np.where(miss[..., None], 1.0, 0.1).astype(np.float32).repeat(3, -1)
        out = td.atrous_denoise(torch.from_numpy(img), aovs).numpy()
        np.testing.assert_allclose(out, img, atol=1e-4)


@pytest.fixture(scope="module")
def jax_render():
    """A JAX render of CORNELL_SMALL, depth 2, 1 spp."""
    r = JRenderer(jparse(CORNELL_SMALL), JConfig(trace_depth=2, samples_per_launch=1))
    r.render(1)
    return r


def test_renderer_denoised_image_matches_jax(jax_render, tmp_path):
    """The JAX render's state carried over (convert.state_from_jax_arrays):
    the port's denoised_image against JAX's denoise_image, and
    save_png(denoise=True)'s transform (clip, ×255, mirror, truncate)."""
    want = jd.denoise_image(jax_render)
    r = Renderer(parse_scene(CORNELL_SMALL), RenderConfig(trace_depth=2), device="cpu")
    s = jax_render.state
    r.state = convert.state_from_jax_arrays(
        np.asarray(s.accum), int(s.iteration), np.asarray(jax.random.key_data(s.key)), "cpu")
    r._host_iteration = r.state.iteration
    got = r.denoised_image()
    _assert_filter_close(got, want)
    path = r.save_png(str(tmp_path / "dn.png"), denoise=True)
    np.testing.assert_array_equal(
        read_png(path), (np.clip(got, 0.0, 1.0) * 255.0)[:, ::-1, :].astype(np.uint8))


def test_adaptive_denoised_image(tmp_path):
    """AdaptiveRenderer.denoised_image is the filter of its own count-aware
    mean over its scene's AOVs."""
    r = AdaptiveRenderer(parse_scene(CORNELL_SMALL), RenderConfig(trace_depth=3), device="cpu")
    r.render(8, round_spp=4)
    got = r.denoised_image()
    want = td.atrous_denoise(torch.from_numpy(r.linear_image()), td.render_aovs(r.scene))
    np.testing.assert_array_equal(got, want.numpy())
    assert np.isfinite(got).all() and got.max() > 0
    path = r.save_png(str(tmp_path / "a.png"), denoise=True)
    assert read_png(path).shape == (64, 64, 3)
