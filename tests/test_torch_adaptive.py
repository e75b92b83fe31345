"""PyTorch port, adaptive sampling (``render/adaptive.py``) and the tile
dispatch of the megakernel (kernel K6), against the JAX package on the CPU:
the tile layout, the two-buffer noise estimate, ``render_tiles`` against
the JAX ``render_tiles`` in interpret mode (the oracle), and a port
``AdaptiveRenderer`` against a JAX one through warm-up and a refine round,
also when the port continues the JAX render from its state.

Both sides run the default 2048-pixel tile (32×64 blocks), so the 64×64
CORNELL_SMALL frame has two tiles and a refine round of frac 0.5 picks one.

Tolerances: tile layouts exactly equal; the noise estimate within 1e-6
relative (the per-tile sum over 2048 lanes runs in another order in XLA and
torch); renders (the two half-buffers' sum, which the image divides by the
counts) within the oracle bound of test_torch_megakernel.py (at most 0.5%
of pixels with a max-channel |Δ| above 1e-3, channel means within 0.5%),
for the reason it states; selected tiles and sample counts exactly equal.
Measured on the development host (jax 0.9.0, torch 2.13.0 CPU), 2 spp per
buffer, with ``pytest -s``: depth 2 one pixel in 4096 above 1e-3 (a flipped
discrete outcome, |Δ| 1.28, which alone moves the 64×64 image's mean by
0.35%), NEE + sobol 0.146%; continued from the JAX state, depth 2 is
bit-identical and NEE + sobol 0.024%; render_tiles 0.081%.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cosc_4397_pathtracing_raytracing_project_tpu import RenderConfig as JConfig
from cosc_4397_pathtracing_raytracing_project_tpu.ops.pallas import megakernel as jmk
from cosc_4397_pathtracing_raytracing_project_tpu.render import adaptive as jad
from cosc_4397_pathtracing_raytracing_project_tpu.scene import Scene as JScene
from cosc_4397_pathtracing_raytracing_project_tpu.scene import parse_scene as jparse
from cosc_4397_pathtracing_raytracing_project_tpu_torch import (
    AdaptiveRenderer,
    RenderConfig,
    Scene,
    convert,
    parse_scene,
)
from cosc_4397_pathtracing_raytracing_project_tpu_torch.ops.cuda import megakernel as tmk
from cosc_4397_pathtracing_raytracing_project_tpu_torch.render import adaptive as tad

from test_render import CORNELL_SMALL
from test_torch_cuda import assert_within_oracle_tolerance

torch.set_num_threads(2)

CONFIGS = {
    "depth2": dict(trace_depth=2),
    "nee-sobol": dict(trace_depth=2, nee=True, sampler="sobol"),
}


@pytest.fixture(scope="module", params=list(CONFIGS))
def jax_run(request):
    """A JAX AdaptiveRenderer (interpret mode): its state after warmup(2)
    as the port's tensors, then its selection and state after one
    refine(spp=2, frac=0.5)."""
    cfg = CONFIGS[request.param]
    r = jad.AdaptiveRenderer(JScene.from_desc(jparse(CORNELL_SMALL)), JConfig(**cfg),
                             interpret=True)
    r.warmup(2)
    warm = convert.adaptive_state_from_jax(r, "cpu")
    sel = np.asarray(r.refine(spp=2, frac=0.5))
    return cfg, warm, sel, r


def _port(cfg):
    return AdaptiveRenderer(parse_scene(CORNELL_SMALL), RenderConfig(**cfg), device="cpu")


def _assert_same_render(port, jax_r, sel_port, sel_jax):
    np.testing.assert_array_equal(sel_port.numpy(), sel_jax)
    np.testing.assert_array_equal(port._counts.numpy(), np.asarray(jax_r._counts))
    n = port._n
    got = (port._acc_a + port._acc_b)[:n].numpy()  # what linear_image() divides
    want = (np.asarray(jax_r._acc_a) + np.asarray(jax_r._acc_b))[:n]
    assert_within_oracle_tolerance(got, want)


@pytest.mark.parametrize("w, h", [(64, 64), (100, 70), (800, 800)])
def test_tile_layout_is_identical(w, h):
    got = tad.make_tile_layout(w, h)
    want = jad.make_tile_layout(w, h)
    for g, x in zip(got, want):
        assert g.dtype == x.dtype
        np.testing.assert_array_equal(g, x)


def test_tile_errors_match_jax():
    rng = np.random.default_rng(5)
    px, py, idx, valid = tad.make_tile_layout(100, 70)
    n = 100 * 70
    idx = np.concatenate([idx, np.full((1, idx.shape[1]), n, np.int32)])
    valid = np.concatenate([valid, np.zeros(1, np.int32)])
    acc_a = rng.gamma(0.8, 0.7, (n + 1, 3)).astype(np.float32)
    acc_b = rng.gamma(0.8, 0.7, (n + 1, 3)).astype(np.float32)
    counts = rng.integers(0, 9, idx.shape[0]).astype(np.int32)
    want = np.asarray(jad._tile_errors(*(jnp.asarray(a) for a in (acc_a, acc_b, counts, idx, valid))))
    got = tad._tile_errors(*(torch.as_tensor(a) for a in (acc_a, acc_b, counts, idx.astype(np.int64), valid)))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)


def test_render_tiles_matches_oracle():
    """Three tiles, one repeated, with distinct 1-based iteration bases."""
    cfg = dict(trace_depth=2, nee=True, sampler="sobol")
    px, py, _, _ = tad.make_tile_layout(64, 64)
    ids = np.array([1, 0, 1], np.int32)
    bases = np.array([1, 4, 9], np.int32)
    tpx, tpy = px[ids].reshape(-1), py[ids].reshape(-1)
    want = np.asarray(
        jmk.render_tiles(
            JScene.from_desc(jparse(CORNELL_SMALL)), JConfig(**cfg), jnp.int32(7),
            jnp.asarray(ids), jnp.asarray(bases),
            jnp.asarray(tpx).reshape(-1, jmk.LANES), jnp.asarray(tpy).reshape(-1, jmk.LANES),
            2, interpret=True,
        )
    )
    got = tmk.render_tiles(
        Scene.from_desc(parse_scene(CORNELL_SMALL), "cpu"), RenderConfig(**cfg), 7,
        torch.as_tensor(ids), torch.as_tensor(bases), torch.as_tensor(tpx),
        torch.as_tensor(tpy), 2,
    )
    assert_within_oracle_tolerance(got.numpy(), want)


def test_adaptive_renderer_matches_jax(jax_run):
    cfg, _, sel_jax, jax_r = jax_run
    r = _port(cfg)
    r.warmup(2)
    assert r.avg_spp == pytest.approx(2.0)
    sel = r.refine(spp=2, frac=0.5)
    _assert_same_render(r, jax_r, sel, sel_jax)
    assert r.avg_spp == pytest.approx(jax_r.avg_spp)
    np.testing.assert_array_equal(r.spp_map(), jax_r.spp_map())


def test_adaptive_renderer_continues_a_jax_render(jax_run):
    cfg, warm, sel_jax, jax_r = jax_run
    r = _port(cfg).load_state(warm)
    sel = r.refine(spp=2, frac=0.5)
    _assert_same_render(r, jax_r, sel, sel_jax)


def test_render_budget_loop():
    r = _port(dict(trace_depth=2))
    r.render(avg_spp=8, warmup_spp=4, round_spp=2, frac=0.5)
    assert r.avg_spp >= 8.0
    spp = r.spp_map()
    assert spp.min() >= 4  # warmup floor
    assert spp.max() > spp.min()  # refinement concentrated work
    img = r.linear_image()
    assert img.shape == (64, 64, 3) and np.isfinite(img).all() and img.max() > 0.5
    assert r.samples_per_second > 0


def _checkpoint_loads(r, tmp_path):
    path = r.save_checkpoint(str(tmp_path / "x"))
    return torch.equal(_port(dict(trace_depth=1)).load_checkpoint(path)._counts, r._counts)


@pytest.mark.parametrize(
    "call",
    [
        lambda r, tmp: np.load(r.save_checkpoint(str(tmp / "x.npz")))["acc_a"].shape == (4097, 3),
        _checkpoint_loads,
        lambda r, tmp: np.isfinite(r.denoised_image()).all(),
        lambda r, tmp: os.path.exists(r.save_png(str(tmp / "x.png"), denoise=True)),
    ],
    ids=["save_checkpoint", "load_checkpoint", "denoised_image", "save_png-denoise"],
)
def test_unported_adaptive_options_raise(call, tmp_path):
    """These raised NotImplementedError naming ROADMAP Queue 1 items 14 and
    16 until the checkpoints and the denoiser were ported; each now works
    (tests/test_torch_checkpoint.py and test_torch_denoise.py hold them to
    the JAX package)."""
    r = _port(dict(trace_depth=1))
    r.warmup(2)
    assert call(r, tmp_path)


@pytest.mark.parametrize(
    "overrides", [dict(pipeline="fast"), dict(intersector="bvh"), dict(bvh_leaf_size=8)],
    ids=lambda d: next(iter(d)),
)
def test_pipeline_fields_render_through_the_tile_kernel(overrides):
    """The JAX AdaptiveRenderer never reads pipeline, intersector or
    bvh_leaf_size, and neither does the port's: the image is the one the
    defaults give."""
    jad.AdaptiveRenderer(JScene.from_desc(jparse(CORNELL_SMALL)),
                         JConfig(trace_depth=1, **overrides), interpret=True)
    images = []
    for extra in (overrides, {}):
        r = _port(dict(trace_depth=1, **extra))
        r.warmup(2)
        images.append(r.linear_image())
    np.testing.assert_array_equal(images[0], images[1])
    assert images[0].mean() > 0


def test_mesh_argument_raises():
    """``mesh=`` raised NotImplementedError naming ROADMAP Queue 1 item 15
    until multi-device rendering was ported (tests/test_torch_parallel.py
    holds the sharded renderer bit for bit to the unsharded one); now a
    mesh that is not a DeviceMesh raises."""
    with pytest.raises(TypeError, match="DeviceMesh"):
        AdaptiveRenderer(parse_scene(CORNELL_SMALL), RenderConfig(), device="cpu", mesh=object())
