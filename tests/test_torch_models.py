"""PyTorch port, the model registry and the wavefront model on the CPU: the
registry lists the JAX package's models, every model renders, compaction
keeps the image (tests/test_models.py's bound, 1e-5), and the wavefront
model against the JAX package's ``render_chunk_wavefront`` (the ROADMAP
bound: at most 0.5% of pixels with a max-channel |Δ| above 1e-3, channel
means within 0.5%). CORNELL_SMALL (64×64), depth 3, 2 spp. Measured
(``pytest -s``): the wavefront renders bit-identical to JAX's in every
compaction mode."""

import numpy as np
import pytest
import torch

from cosc_4397_pathtracing_raytracing_project_tpu import RenderConfig as JConfig
from cosc_4397_pathtracing_raytracing_project_tpu import models as jmodels
from cosc_4397_pathtracing_raytracing_project_tpu.render.state import RenderState as JState
from cosc_4397_pathtracing_raytracing_project_tpu.scene import Scene as JScene
from cosc_4397_pathtracing_raytracing_project_tpu.scene import parse_scene as jparse
from cosc_4397_pathtracing_raytracing_project_tpu_torch import RenderConfig, parse_scene
from cosc_4397_pathtracing_raytracing_project_tpu_torch import models
from cosc_4397_pathtracing_raytracing_project_tpu_torch.render.state import RenderState

from test_render import CORNELL_SMALL
from test_torch_cuda import assert_within_oracle_tolerance

torch.set_num_threads(2)

CFG = dict(trace_depth=3, samples_per_launch=2)
SEED = 3


def _render(model, compaction="none", **overrides):
    r = models.make_renderer(model, parse_scene(CORNELL_SMALL), RenderConfig(**dict(CFG, **overrides)),
                             seed=SEED, compaction=compaction, device="cpu")
    r.render(2)
    return r


def test_registry_lists_the_jax_models():
    assert models.available_models() == jmodels.available_models()
    for name in models.available_models():
        assert models.get(name).config_overrides == jmodels.get(name).config_overrides
    with pytest.raises(KeyError, match="unknown model"):
        models.get("nope")


@pytest.mark.parametrize("model", ["naive", "shared", "bvh", "megakernel", "wavefront"])
def test_models_render(model):
    r = _render(model)
    want = {"naive": "reference", "shared": "fast", "bvh": "reference", "megakernel": "pallas",
            "wavefront": "reference"}[model]
    assert r.pipeline == want
    img = r.linear_image()
    assert img.shape == (64, 64, 3) and np.isfinite(img).all() and img.max() > 0.05


@pytest.mark.parametrize("compaction", ["sort_alive", "sort_material"])
def test_compaction_preserves_image(compaction):
    """The random rows are keyed by pixel and the final gather scatters by
    pixel, so reordering paths between bounces keeps the image."""
    base = _render("wavefront").state.accum.numpy()
    got = _render("wavefront", compaction).state.accum.numpy()
    np.testing.assert_allclose(got, base, rtol=1e-5, atol=1e-5)


def test_wavefront_matches_the_plain_pipeline():
    np.testing.assert_allclose(_render("wavefront").state.accum.numpy(),
                               _render("naive").state.accum.numpy(), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("compaction", ["none", "sort_material"])
@pytest.mark.parametrize("sampler", ["independent", "sobol"])
def test_wavefront_matches_jax(compaction, sampler):
    cfg = dict(CFG, sampler=sampler, antialias=sampler == "sobol")
    jscene = JScene.from_desc(jparse(CORNELL_SMALL))
    want = jmodels.render_chunk_wavefront(
        jscene, JState.create(jscene.camera.pixel_count, SEED), JConfig(**cfg), 2, compaction)
    r = _render("wavefront", compaction, sampler=sampler, antialias=sampler == "sobol")
    got = models.render_chunk_wavefront(
        r.scene, RenderState.create(r.scene.camera.pixel_count, SEED, "cpu"),
        RenderConfig(**cfg), 2, compaction)
    assert got.iteration == int(want.iteration) == 2
    assert_within_oracle_tolerance(got.accum.numpy(), np.asarray(want.accum))
    assert_within_oracle_tolerance(r.state.accum.numpy(), np.asarray(want.accum))


def test_wavefront_model_rejects_nee_and_unknown_compaction():
    with pytest.raises(ValueError, match="nee is not supported"):
        jmodels.make_renderer("wavefront", jparse(CORNELL_SMALL), JConfig(nee=True))
    with pytest.raises(ValueError, match="nee is not supported"):
        models.make_renderer("wavefront", parse_scene(CORNELL_SMALL), RenderConfig(nee=True),
                             device="cpu")
    r = models.make_renderer("wavefront", parse_scene(CORNELL_SMALL), RenderConfig(**CFG),
                             compaction="nope", device="cpu")
    with pytest.raises(ValueError, match="unknown compaction"):
        r.render(1)
