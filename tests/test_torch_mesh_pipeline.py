"""PyTorch port, the mesh pipeline on the CPU: ``ops.fast.trace_sample_mesh``
against the JAX package's on tests/test_fast_mesh.py's tri_scene (32×32, 72
floor triangles, an emissive slab), one sample at depth 3-4, with the plain
versions of K7/K8 against the interpret-mode kernel; and the port's
``Renderer`` through ``pipeline="fast_mesh"``.

The JAX side runs eagerly, as tests/test_fast_mesh.py does. Most cases set
``mesh_sort_every`` to the trace depth: the wavefront is then sorted before
bounce 1 only (or never, unsorted), and the JAX function unrolls every
bounce instead of running its ``lax.scan`` (an eager scan recompiles its
body, interpret-mode kernel included, on every call: ~12 s a render). One
case keeps the per-bounce sort of the default configuration through the
scan.

Tolerance: the ROADMAP bound against the JAX package, at most 0.5% of pixels
with a max-channel |Δ| above 1e-3 and channel means within 0.5%. Measured
(printed with ``pytest -s``): no pixel above 1e-3 in any case, max |Δ| under
1e-6; 76-99% of pixels bit-identical (the rest differ in the last ulps of
library sin/cos and rsqrt).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cosc_4397_pathtracing_raytracing_project_tpu import RenderConfig as JConfig
from cosc_4397_pathtracing_raytracing_project_tpu.ops import fast as jfast
from cosc_4397_pathtracing_raytracing_project_tpu.ops.lights import (
    make_light_sampler as jax_make_light_sampler,
)
from cosc_4397_pathtracing_raytracing_project_tpu.render.engine import (
    make_mesh_intersector as jax_make_mesh_intersector,
)
from cosc_4397_pathtracing_raytracing_project_tpu.scene import Scene as JScene
from cosc_4397_pathtracing_raytracing_project_tpu_torch import RenderConfig, Renderer, Scene
from cosc_4397_pathtracing_raytracing_project_tpu_torch.ops import fast
from cosc_4397_pathtracing_raytracing_project_tpu_torch.ops.cuda import mesh_kernel as tmesh
from cosc_4397_pathtracing_raytracing_project_tpu_torch.ops.lights import make_light_sampler
from cosc_4397_pathtracing_raytracing_project_tpu_torch.render.engine import (
    make_mesh_intersector,
)
from cosc_4397_pathtracing_raytracing_project_tpu_torch.scene import derive_camera

from test_torch_cuda import assert_within_oracle_tolerance, tri_scene_desc

torch.set_num_threads(2)

SEED = 7

# RenderConfig overrides per case (both packages take the same fields)
CASES = {
    "independent-sorted": dict(trace_depth=4, sky_strength=0.5, mesh_sort_every=4),
    "independent-unsorted": dict(trace_depth=4, sky_strength=0.5, mesh_ray_sort=False,
                                 mesh_sort_every=4),
    "sobol-aa-sorted": dict(trace_depth=4, sky_strength=0.5, sampler="sobol",
                            antialias=True, mesh_sort_every=4),
    "sobol-unfused": dict(trace_depth=4, sampler="sobol", mesh_sort_fused=False,
                          mesh_sort_every=4, mesh_sort_cells=4),
    "dof-aa": dict(trace_depth=3, dof=True, antialias=True, mesh_sort_every=3),
    "nee": dict(trace_depth=4, nee=True, mesh_sort_every=4),
    "nee-sobol-aa": dict(trace_depth=4, nee=True, sampler="sobol", antialias=True,
                         mesh_sort_every=4),
    "throughput": dict(trace_depth=3, gather_mode="throughput", mesh_sort_every=3),
    "sorted-every-bounce": dict(trace_depth=4, sky_strength=0.5),
}


@pytest.fixture(scope="module")
def scenes():
    """(port scene, JAX scene, port intersector, JAX intersector), with a
    thin lens on both cameras (the dof case reads it, the others ignore it)."""
    desc = tri_scene_desc()
    desc.camera.aperture, desc.camera.focal = 0.8, 6.0
    port = Scene.from_desc(desc, "cpu")
    oracle = JScene.from_desc(desc)
    return (port, oracle, make_mesh_intersector(port),
            jax_make_mesh_intersector(oracle, interpret=True))


def _render_pair(scenes, overrides):
    port, oracle, isect, jisect = scenes
    nee = overrides.get("nee", False)
    want = jfast.trace_sample_mesh(
        oracle, JConfig(**overrides), jax.random.PRNGKey(SEED), jnp.int32(1), jisect,
        light_sampler=jax_make_light_sampler(oracle) if nee else None,
    )
    got = fast.trace_sample_mesh(
        port, RenderConfig(**overrides), SEED, 1, isect,
        light_sampler=make_light_sampler(port) if nee else None,
    )
    return got.numpy(), np.asarray(want)


@pytest.mark.parametrize("case", list(CASES))
def test_trace_sample_mesh_matches_jax(scenes, case):
    got, want = _render_pair(scenes, CASES[case])
    assert got.shape == (32 * 32, 3) and want.mean() > 0
    assert_within_oracle_tolerance(got, want)


def test_sort_is_image_invariant(scenes):
    """The port's own per-bounce sort (the default cadence, fused and not)
    against no sort, with NEE: pixel-keyed streams and a strict nearest hit
    keep the image, to the JAX test's bound (tests/test_fast_mesh.py)."""
    port, _, isect, _ = scenes
    sampler = make_light_sampler(port)
    base = RenderConfig(trace_depth=4, nee=True)
    images = [
        fast.trace_sample_mesh(port, dataclasses.replace(base, **kw), SEED, 1, isect,
                               light_sampler=sampler).numpy()
        for kw in (dict(), dict(mesh_ray_sort=False), dict(mesh_sort_fused=False),
                   dict(mesh_sort_cells=8))
    ]
    for other in images[1:]:
        np.testing.assert_allclose(images[0], other, rtol=1e-6, atol=1e-7)


class _LiveShadows:
    """The intersector with the shadow-ray mask the JAX package passes: every
    live ray of the bounce (its nearest-hit call's mask), not only those whose
    light sample can count. Keeps each (narrow, live) pair of masks."""

    def __init__(self, inner):
        self.inner, self.tables, self.live, self.masks = inner, inner.tables, None, []

    def call_soa(self, *rays, active=None, walk="warp"):
        self.live = active
        return self.inner.call_soa(*rays, active=active, walk=walk)

    def call_t(self, *rays, active=None):
        self.masks.append((active, self.live))
        return self.inner.call_t(*rays, active=self.live)


@pytest.mark.parametrize("case", ["nee", "nee-sobol-aa"])
def test_narrow_shadow_mask_keeps_the_image(scenes, case):
    """K8 traces only the shadow rays whose sample can count: the image is
    bit-identical to tracing every live ray's, with fewer rays traced."""
    port, _, isect, _ = scenes
    cfg = RenderConfig(**dict(CASES[case], mesh_sort_every=1))
    sampler = make_light_sampler(port)
    live = _LiveShadows(isect)
    want = fast.trace_sample_mesh(port, cfg, SEED, 1, live, light_sampler=sampler)
    got = fast.trace_sample_mesh(port, cfg, SEED, 1, isect, light_sampler=sampler)
    assert torch.equal(got, want) and want.mean() > 0
    assert len(live.masks) == cfg.trace_depth
    for narrow, alive in live.masks:
        assert not bool((narrow & ~alive).any())
    assert sum(int(m.sum()) for m, _ in live.masks) < sum(int(a.sum()) for _, a in live.masks)


@pytest.mark.parametrize("case", ["independent-sorted", "nee"])
def test_primary_rays_take_the_lane_walk(scenes, case):
    """The pipeline asks the kernel for its lane walk on the primary rays
    (all live, coherent) and for its warp walk on every later bounce; the
    image does not depend on it."""
    port, _, isect, _ = scenes
    cfg = RenderConfig(**CASES[case])
    sampler = make_light_sampler(port) if cfg.nee else None
    rec = tmesh.RayRecorder(isect)
    got = fast.trace_sample_mesh(port, cfg, SEED, 1, rec, light_sampler=sampler)
    assert rec.walks == ["lane"] + ["warp"] * (cfg.trace_depth - 1)
    assert bool((rec.soa[0][6] > 0.5).all())
    want = fast.trace_sample_mesh(port, cfg, SEED, 1, isect, light_sampler=sampler)
    assert torch.equal(got, want)


def test_renderer_runs_fast_mesh_on_the_cpu(scenes):
    """Renderer(tri_scene desc, device='cpu') takes the mesh pipeline and
    accumulates one trace_sample_mesh per sample; set_camera keeps its
    intersector and resets the render."""
    desc = tri_scene_desc()
    r = Renderer(desc, RenderConfig(trace_depth=3, samples_per_launch=2, sky_strength=0.5),
                 seed=SEED, device="cpu")
    assert r.pipeline == "fast_mesh"
    cluster = r._step.cluster
    r.render(3)
    assert r.iteration == 3 and r.state.iteration == 3
    want = sum(
        fast.trace_sample_mesh(r.scene, r.config, SEED, i, cluster) for i in (1, 2, 3)
    )
    np.testing.assert_allclose(r.state.accum.numpy(), want.numpy(), rtol=1e-6, atol=1e-7)
    img = r.linear_image()
    assert img.shape == (32, 32, 3) and np.isfinite(img).all() and img.mean() > 0
    cam = tri_scene_desc().camera
    cam.eye = np.array([1.0, 3.0, 8.0])
    r.set_camera(derive_camera(cam, "cpu"))
    assert r.iteration == 0 and r.state.accum.abs().sum() == 0
    r.render(1)
    assert r._step.cluster is cluster and r.linear_image().mean() > 0


def test_renderer_nee_needs_an_analytic_emitter():
    desc = tri_scene_desc()
    desc.emittance = np.array([0.0, 0.0], np.float32)
    with pytest.raises(ValueError, match="analytic"):
        Renderer(desc, RenderConfig(nee=True), device="cpu")
    desc = tri_scene_desc()
    desc.emittance = np.array([5.0, 1.0], np.float32)  # the floor emits
    with pytest.raises(ValueError, match="emissive triangles"):
        Renderer(desc, RenderConfig(nee=True), device="cpu")
