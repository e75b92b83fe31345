"""PyTorch port, ``ops/lights.py``: the light table, ``sample`` and
``area_pdf_at`` against the JAX package's ``LightSampler`` on the same
numpy-seeded uniforms, for one emissive slab (tests/test_fast_mesh.py's
tri_scene) and for a cube and a sphere light (cornell_golden with its sphere
made a light). Tolerance: rtol 1e-6 and atol 1e-6 (the JAX module forms
its matrix-vector products with einsum and gathers rows with one-hot
products, which XLA:CPU may round differently in the last ulp); the light
picks and the sampled flags are equal."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cosc_4397_pathtracing_raytracing_project_tpu.ops import lights as jlights
from cosc_4397_pathtracing_raytracing_project_tpu.scene import Scene as JScene
from cosc_4397_pathtracing_raytracing_project_tpu.scene import parse_scene as jparse
from cosc_4397_pathtracing_raytracing_project_tpu_torch import Scene, parse_scene
from cosc_4397_pathtracing_raytracing_project_tpu_torch.ops import lights as tlights

from test_torch_cuda import tri_scene_desc, two_light_golden

torch.set_num_threads(2)

_SCENES = os.path.join(os.path.dirname(__file__), "..", "scenes")


def _two_lights():
    text = two_light_golden(open(os.path.join(_SCENES, "cornell_golden.txt")).read())
    return Scene.from_desc(parse_scene(text), "cpu"), JScene.from_desc(jparse(text))


def _slab():
    desc = tri_scene_desc()
    return Scene.from_desc(desc, "cpu"), JScene.from_desc(desc)


SCENES = {"slab+triangles": _slab, "cube+sphere": _two_lights}


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("name", list(SCENES))
def test_light_table_equals_jax(name):
    port, oracle = SCENES[name]()
    got, want = tlights.make_light_sampler(port), jlights.make_light_sampler(oracle)
    assert got.num_lights == want.num_lights == (1 if name.startswith("slab") else 2)
    for f in ("kind", "transform", "inv_transpose", "radiance", "geom_index"):
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(want, f)))


@pytest.mark.parametrize("name", list(SCENES))
def test_sample_matches_jax(name):
    port, oracle = SCENES[name]()
    u = np.random.default_rng(3).uniform(0, 1, (4096, 3)).astype(np.float32)
    got = tlights.make_light_sampler(port).sample(torch.from_numpy(u))
    want = jlights.make_light_sampler(oracle).sample(jnp.asarray(u))
    for g, w in zip(got, want):
        _close(g, w)
    assert np.all(got[2].numpy() > 0)


@pytest.mark.parametrize("name", list(SCENES))
def test_area_pdf_at_matches_jax(name):
    port, oracle = SCENES[name]()
    sampler, jsampler = tlights.make_light_sampler(port), jlights.make_light_sampler(oracle)
    rng = np.random.default_rng(4)
    ids = np.concatenate([sampler.geom_index.numpy(), [-1, 99]])
    geom = rng.choice(ids, 2048).astype(np.int32)
    normal = rng.normal(size=(2048, 3)).astype(np.float32)
    normal /= np.linalg.norm(normal, axis=1, keepdims=True)
    got = sampler.area_pdf_at(torch.from_numpy(geom), torch.from_numpy(normal))
    want = jsampler.area_pdf_at(jnp.asarray(geom), jnp.asarray(normal))
    _close(got[0], want[0])
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    assert got[1].numpy().any() and not got[1].numpy().all()
    assert np.all(got[0].numpy()[~got[1].numpy()] == 0)


def test_no_emitter_and_emissive_triangles():
    desc = tri_scene_desc()
    desc.emittance = np.array([0.0, 0.0], np.float32)
    assert tlights.make_light_sampler(Scene.from_desc(desc, "cpu")) is None
    desc.emittance = np.array([5.0, 2.0], np.float32)
    with pytest.raises(ValueError, match="emissive triangles"):
        tlights.make_light_sampler(Scene.from_desc(desc, "cpu"))
