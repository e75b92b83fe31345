"""PyTorch port, the auxiliary modules on the CPU: profiling
(tests/test_aux.py's keys), the radiance health check against the JAX
package's, the NaN check of ``Renderer.step``, ``load_scene`` and
``desc_world_aabbs`` against the JAX package's, the trace writer and
``__version__``.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cosc_4397_pathtracing_raytracing_project_tpu as jpkg
from cosc_4397_pathtracing_raytracing_project_tpu.scene import desc_world_aabbs as jaabbs
from cosc_4397_pathtracing_raytracing_project_tpu.scene import load_scene_desc as jload_desc
from cosc_4397_pathtracing_raytracing_project_tpu.utils.debug import (
    validate_radiance as jvalidate,
)
import cosc_4397_pathtracing_raytracing_project_tpu_torch as tpkg
from cosc_4397_pathtracing_raytracing_project_tpu_torch import (
    RenderConfig,
    Renderer,
    Scene,
    parse_scene,
)
from cosc_4397_pathtracing_raytracing_project_tpu_torch.render import profiling
from cosc_4397_pathtracing_raytracing_project_tpu_torch.scene import (
    desc_world_aabbs,
    load_scene_desc,
)
from cosc_4397_pathtracing_raytracing_project_tpu_torch.utils import debug

from test_render import CORNELL_SMALL

torch.set_num_threads(2)

SCENES = os.path.join(os.path.dirname(__file__), "..", "scenes")


def _scene():
    return Scene.from_desc(parse_scene(CORNELL_SMALL), "cpu")


@pytest.mark.parametrize("pipeline", ["auto", "fast", "reference"])
def test_profile_pipeline(pipeline):
    stats = profiling.profile_pipeline(_scene(), RenderConfig(trace_depth=4, pipeline=pipeline),
                                       reps=1)
    assert stats["pipeline"] == ("pallas" if pipeline == "auto" else pipeline)
    assert stats["depth"] == 4
    for k in ("total_ms", "bounce1_ms", "per_bounce_ms", "fixed_ms"):
        assert stats[k] >= 0


def test_trace_writes_a_chrome_trace(tmp_path):
    with profiling.trace(str(tmp_path / "trace")):
        with profiling.span("raygen"):
            Renderer(parse_scene(CORNELL_SMALL), RenderConfig(trace_depth=2),
                     device="cpu").step(1)
    assert b"raygen" in (tmp_path / "trace" / "trace.json").read_bytes()


@pytest.mark.parametrize("poison", [None, "nan", "inf"])
def test_validate_radiance_matches_jax(poison):
    good = np.ones((16, 3), np.float32)
    if poison:
        good[0, 0] = np.nan
        good[1, 1] = np.inf if poison == "inf" else np.nan
    got = debug.validate_radiance(torch.from_numpy(good), 4)
    want = jvalidate(jnp.asarray(good), 4)
    assert got.keys() == want.keys()
    for k in ("nan_count", "inf_count", "healthy"):
        assert got[k] == want[k], k
    for k in ("mean_radiance", "peak_radiance"):
        assert got[k] == pytest.approx(want[k], rel=1e-6), k
    assert debug.validate_radiance(good, 4) == got  # an array is taken too


def test_nan_checks_raise_on_a_poisoned_step():
    r = Renderer(parse_scene(CORNELL_SMALL), RenderConfig(trace_depth=2), device="cpu")
    r.step(1)
    r.state.accum[5, 1] = float("nan")
    assert not debug.nan_checks_enabled()
    r.step(1)  # off by default: no check
    debug.enable_nan_checks()
    try:
        with pytest.raises(FloatingPointError, match="NaN"):
            r.step(1)
    finally:
        debug.disable_nan_checks()
    r.reset()
    r.step(1)


@pytest.mark.parametrize("name", ["cornell.txt", "mesh1080p.txt"])
def test_load_scene_and_aabbs_match_jax(name):
    path = os.path.join(SCENES, name)
    got, want = tpkg.load_scene(path, "cpu"), jpkg.load_scene(path)
    for f in ("position", "view", "up", "right", "pixel_length", "aperture", "focal"):
        np.testing.assert_array_equal(getattr(got.camera, f).numpy(),
                                      np.asarray(getattr(want.camera, f)), f)
    for batch in ("cubes", "spheres"):
        for f in ("transform", "inv_transform", "material_id"):
            np.testing.assert_array_equal(getattr(getattr(got, batch), f).numpy(),
                                          np.asarray(getattr(getattr(want, batch), f)))
    assert got.num_triangles == int(want.triangles.count)
    if got.num_triangles:
        np.testing.assert_array_equal(got.triangles.v0.numpy(), np.asarray(want.triangles.v0))
    for g, w in zip(desc_world_aabbs(load_scene_desc(path)), jaabbs(jload_desc(path))):
        assert g.dtype == np.float32
        np.testing.assert_array_equal(g, w)


def test_version():
    assert tpkg.__version__ == jpkg.__version__ == "0.1.0"
