"""PyTorch port, the reference pipeline on the CPU against the JAX package:
``ops/sampling.py`` and ``shade_step`` (every estimator option) on the same
random inputs and hits, ``intersect_scene`` with triangles (an equal-t tie
included), ``BVHIntersector`` against the JAX one with ``tri_method="while"``
on a 65-primitive analytic scene and on tests/test_fast_mesh.py's
tri_scene, and the Renderer on ``pipeline="reference"`` with brute force
and with the BVH, with and without NEE, on a scene of no primitive under an
environment map, on 65 cubes, and on tri_scene under a map.

Tolerances: sampling and shading per element within 1e-5 (library
sin/cos/acos ulps; a lane whose branch a last-ulp change flips would
exceed it: none does); intersections' distances within 1e-6 relative and
their indices equal; images within the ROADMAP bound against the JAX
package, at most 0.5% of pixels with a max-channel |Δ| above 1e-3 and
channel means within 0.5%. Measured (``pytest -s``): the renders are
bit-identical or differ in at most one pixel of 1024 (a NEE shadow ray on
a last-ulp tie).
"""

import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cosc_4397_pathtracing_raytracing_project_tpu import RenderConfig as JConfig
from cosc_4397_pathtracing_raytracing_project_tpu import Renderer as JRenderer
from cosc_4397_pathtracing_raytracing_project_tpu.ops import bvh as jbvh
from cosc_4397_pathtracing_raytracing_project_tpu.ops import envmap as jenvmap
from cosc_4397_pathtracing_raytracing_project_tpu.ops import intersect as jintersect
from cosc_4397_pathtracing_raytracing_project_tpu.ops import lights as jlights
from cosc_4397_pathtracing_raytracing_project_tpu.ops import sampling as jsampling
from cosc_4397_pathtracing_raytracing_project_tpu.ops import shade as jshade
from cosc_4397_pathtracing_raytracing_project_tpu.scene import Scene as JScene
from cosc_4397_pathtracing_raytracing_project_tpu.scene import parse_scene as jparse
from cosc_4397_pathtracing_raytracing_project_tpu_torch import RenderConfig, Renderer, Scene, parse_scene
from cosc_4397_pathtracing_raytracing_project_tpu_torch.io.png import read_hdr
from cosc_4397_pathtracing_raytracing_project_tpu_torch.ops import bvh as tbvh
from cosc_4397_pathtracing_raytracing_project_tpu_torch.ops import envmap as tenvmap
from cosc_4397_pathtracing_raytracing_project_tpu_torch.ops import intersect as tintersect
from cosc_4397_pathtracing_raytracing_project_tpu_torch.ops import lights as tlights
from cosc_4397_pathtracing_raytracing_project_tpu_torch.ops import sampling as tsampling
from cosc_4397_pathtracing_raytracing_project_tpu_torch.ops import shade as tshade

from test_render import CORNELL_SMALL
from test_torch_cuda import (
    assert_within_oracle_tolerance,
    env_scene_text,
    env_spheres_text,
    many_cubes_text,
    tri_scene_desc,
    write_env_map,
)

torch.set_num_threads(2)

SCENES = os.path.join(os.path.dirname(__file__), "..", "scenes")
SEED = 5
N = 512
TOL = dict(rtol=1e-5, atol=1e-5)


def _rays(seed, n=N, lo=-6.0, hi=11.0):
    rng = np.random.default_rng(seed)
    o = rng.uniform(lo, hi, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o, d


def _pair(o, d):
    return (jnp.asarray(o), jnp.asarray(d)), (torch.as_tensor(o), torch.as_tensor(d))


def test_sampling_matches_jax():
    rng = np.random.default_rng(1)
    _, n = _rays(2)
    u = rng.uniform(0, 1, (5, N)).astype(np.float32)
    inc = _rays(3)[1]
    rough = rng.uniform(0, 1, N).astype(np.float32)
    jn, tn = jnp.asarray(n), torch.as_tensor(n)
    ju, tu = jnp.asarray(u), torch.as_tensor(u)
    for want, got in zip(jsampling.local_coordinate_system(jn),
                         tsampling.local_coordinate_system(tn)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(
        tsampling.cosine_weighted_hemisphere(tu[0], tu[1], tn).numpy(),
        np.asarray(jsampling.cosine_weighted_hemisphere(ju[0], ju[1], jn)), **TOL)
    np.testing.assert_allclose(
        tsampling.perturbed_specular(torch.as_tensor(inc), tn, torch.as_tensor(rough), tu[2],
                                     tu[3]).numpy(),
        np.asarray(jsampling.perturbed_specular(jnp.asarray(inc), jn, jnp.asarray(rough), ju[2],
                                                ju[3])), **TOL)
    np.testing.assert_array_equal(tsampling.sky_color(tn).numpy(),
                                  np.asarray(jsampling.sky_color(jn)))
    n2 = 1.0 + u[4]
    np.testing.assert_allclose(
        tsampling.schlick_fresnel(tu[0], 1.0, torch.as_tensor(n2)).numpy(),
        np.asarray(jsampling.schlick_fresnel(ju[0], 1.0, jnp.asarray(n2))), **TOL)


@pytest.fixture(scope="module")
def env_pair(tmp_path_factory):
    """The small environment scene's (port, JAX) scenes, 32×32, with an
    emissive sphere, and the directory of its map."""
    d = tmp_path_factory.mktemp("env")
    path = write_env_map(d, "sun")
    text = env_scene_text(path, res=32, light=True)
    return (Scene.from_desc(parse_scene(text, base_dir=str(d)), "cpu"),
            JScene.from_desc(jparse(text, base_dir=str(d))), str(d))


def _hits(scene_port, scene_jax, seed):
    """The scene's own nearest hits of random rays (both packages' records
    of the same hits), with a fifth of the rays' remaining bounces at 0."""
    o, d = _rays(seed)
    (jo, jd), (to, td) = _pair(o, d)
    jhit = jintersect.intersect_scene(scene_jax, jo, jd)
    thit = tintersect.Hit(**{f.name: torch.as_tensor(np.array(getattr(jhit, f.name)))
                             for f in dataclasses.fields(tintersect.Hit)})
    rng = np.random.default_rng(seed + 1)
    color = rng.uniform(0.2, 1.0, (N, 3)).astype(np.float32)
    bounces = rng.integers(0, 4, N).astype(np.int32)
    jpaths = jshade.PathState(origin=jo, direction=jd, color=jnp.asarray(color),
                              bounces=jnp.asarray(bounces))
    tpaths = tshade.PathState(origin=to, direction=td, color=torch.as_tensor(color),
                              bounces=torch.as_tensor(bounces))
    u = rng.uniform(0, 1, (N, 5)).astype(np.float32)
    extra = rng.uniform(0, 1, (N, 5)).astype(np.float32)
    prev = np.where(rng.uniform(0, 1, N) < 0.3, -1.0,
                    rng.uniform(0.01, 0.3, N)).astype(np.float32)
    return (jpaths, jhit), (tpaths, thit), u, extra, prev


SHADE_CASES = {
    "throughput": ("cornell", dict(gather_mode="throughput")),
    "light_only-sky": ("cornell", dict(gather_mode="light_only", sky_strength=0.5)),
    "refraction": ("glass", dict(gather_mode="light_only", enable_refraction=True,
                                 sky_strength=0.5)),
    "nee": ("cornell", dict(gather_mode="light_only", nee=True)),
    "env": ("env", dict(gather_mode="light_only", env=True)),
    "env-nee": ("env", dict(gather_mode="light_only", env=True, env_nee=True)),
    "env-and-area-nee": ("env", dict(gather_mode="light_only", env=True, env_nee=True, nee=True)),
}


@pytest.mark.parametrize("case", list(SHADE_CASES))
def test_shade_step_matches_jax(case, env_pair):
    kind, opts = SHADE_CASES[case]
    if kind == "env":
        port, oracle = env_pair[:2]
    else:
        text = CORNELL_SMALL if kind == "cornell" else env_spheres_text(32)
        port = Scene.from_desc(parse_scene(text, base_dir=SCENES), "cpu")
        oracle = JScene.from_desc(jparse(text, base_dir=SCENES))
    (jpaths, jhit), (tpaths, thit), u, extra, prev = _hits(port, oracle, 11)
    jargs = dict(gather_mode=opts["gather_mode"], sky_strength=opts.get("sky_strength", 0.0),
                 enable_refraction=opts.get("enable_refraction", False))
    targs = dict(jargs)
    carry = opts.get("nee") or opts.get("env_nee")
    if opts.get("env"):
        jargs["env"], targs["env"] = oracle.envmap, port.envmap
    if opts.get("nee"):
        jargs["nee"] = jlights.NEEInputs(
            sampler=jlights.make_light_sampler(oracle),
            shadow_isect=lambda o, d: jintersect.intersect_scene(oracle, o, d),
            uniforms=jnp.asarray(extra[:, :3]))
        targs["nee"] = tlights.NEEInputs(
            sampler=tlights.make_light_sampler(port),
            shadow_isect=lambda o, d: tintersect.intersect_scene(port, o, d),
            uniforms=torch.as_tensor(extra[:, :3]))
    if opts.get("env_nee"):
        jargs["env_nee"] = jenvmap.EnvNEEInputs(
            env=oracle.envmap, shadow_isect=lambda o, d: jintersect.intersect_scene(oracle, o, d),
            uniforms=jnp.asarray(extra[:, 3:]))
        targs["env_nee"] = tenvmap.EnvNEEInputs(
            env=port.envmap, shadow_isect=lambda o, d: tintersect.intersect_scene(port, o, d),
            uniforms=torch.as_tensor(extra[:, 3:]))
    if carry:
        jargs["prev_pdf"], targs["prev_pdf"] = jnp.asarray(prev), torch.as_tensor(prev)
    for depth in (1, 4):
        want = jshade.shade_step(jpaths, jhit, oracle.materials, jnp.asarray(u), depth, 3, **jargs)
        got = tshade.shade_step(tpaths, thit, port.materials, torch.as_tensor(u), depth, 3,
                                **targs)
        assert len(got) == len(want) == (3 if carry else 2)
        for f in ("origin", "direction", "color"):
            np.testing.assert_allclose(getattr(got[0], f).numpy(),
                                       np.asarray(getattr(want[0], f)), **TOL)
        np.testing.assert_array_equal(got[0].bounces.numpy(), np.asarray(want[0].bounces))
        for g, w in zip(got[1:], want[1:]):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)
        assert float(got[1].abs().sum()) > 0.0 or opts["gather_mode"] == "throughput"


def _tie_scene():
    """tri_scene with its first floor triangle doubled at index 0 on the
    emitter's material: rays through it meet two triangles at equal t."""
    desc = tri_scene_desc()
    tri = np.concatenate([desc.tri_vertices[:1], desc.tri_vertices])
    mats = np.concatenate([[0], desc.tri_material_id]).astype(np.int32)
    return dataclasses.replace(desc, tri_vertices=tri, tri_material_id=mats)


def test_intersect_scene_with_triangles_matches_jax():
    """Triangles and the slab: every Hit field as JAX's (distances within
    1e-6 relative); at the doubled triangle, the first index wins in both
    (``min`` keeps the first minimum, as ``argmin`` does)."""
    desc = _tie_scene()
    port, oracle = Scene.from_desc(desc, "cpu"), JScene.from_desc(desc)
    o, d = _rays(7, lo=-4.0, hi=6.0)
    # the last 64 rays fall straight onto the doubled triangle's centroid
    centroid = desc.tri_vertices[0].mean(axis=0)
    o[-64:] = centroid + np.array([0.0, 3.0, 0.0], np.float32) + np.random.default_rng(0).uniform(
        -0.05, 0.05, (64, 3)).astype(np.float32) * np.array([1, 0, 1], np.float32)
    d[-64:] = np.array([0.0, -1.0, 0.0], np.float32)
    (jo, jd), (to, td) = _pair(o, d)
    want = jintersect.intersect_scene(oracle, jo, jd)
    got = tintersect.intersect_scene(port, to, td)
    _assert_hits_equal(got, want)
    tie_geom = got.geom_index[-64:].numpy()
    assert (tie_geom == desc.num_geoms).all()  # triangle 0, not its double
    assert (got.material_id[-64:].numpy() == 0).all()


def _assert_hits_equal(got, want, index_share=1.0):
    miss = np.asarray(want.miss)
    np.testing.assert_array_equal(got.miss.numpy(), miss)
    np.testing.assert_allclose(got.t.numpy(), np.asarray(want.t), rtol=1e-6)
    same = got.geom_index.numpy() == np.asarray(want.geom_index)
    assert same.mean() >= index_share
    for f in ("material_id", "outside"):
        np.testing.assert_array_equal(getattr(got, f).numpy()[same],
                                      np.asarray(getattr(want, f))[same])
    for f in ("point", "normal"):
        np.testing.assert_allclose(getattr(got, f).numpy()[same & ~miss],
                                   np.asarray(getattr(want, f))[same & ~miss],
                                   rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("kind", ["65-cubes", "tri_scene"])
def test_bvh_intersector_matches_jax(kind):
    """The threaded BVH walk over the same tree (analytic primitives, and
    triangles with tri_method='while') against the JAX BVHIntersector."""
    if kind == "tri_scene":
        desc = tri_scene_desc()
        port, oracle = Scene.from_desc(desc, "cpu"), JScene.from_desc(desc)
    else:
        text = many_cubes_text(65)
        port, oracle = Scene.from_desc(parse_scene(text), "cpu"), JScene.from_desc(jparse(text))
    o, d = _rays(8, lo=-6.0, hi=12.0)
    (jo, jd), (to, td) = _pair(o, d)
    want = jbvh.BVHIntersector(oracle, leaf_size=4, tri_method="while")(oracle, jo, jd)
    isect = tbvh.BVHIntersector(port, leaf_size=4, tri_method="while")
    assert isect.tri_method == "while"
    got = isect(port, to, td)
    _assert_hits_equal(got, want)
    assert (~got.miss).sum() > N // 32
    # the CPU's auto is the walk too
    assert tbvh.BVHIntersector(port, leaf_size=4).tri_method == "while"


@pytest.fixture(scope="module")
def render_scenes(tmp_path_factory):
    """(port desc or text, JAX scene) per render case: no primitive under a
    map, 65 cubes, tri_scene under a map (all 32×32)."""
    d = tmp_path_factory.mktemp("maps")
    path = write_env_map(d, "sun")
    empty = env_scene_text(path, res=32).split("OBJECT 0")[0]
    cubes = many_cubes_text(65, res=32)
    mesh = dataclasses.replace(tri_scene_desc(), env_image=read_hdr(path))
    return {
        "empty-env": (parse_scene(empty, base_dir=str(d)),
                      JScene.from_desc(jparse(empty, base_dir=str(d)))),
        "65-cubes": (parse_scene(cubes), JScene.from_desc(jparse(cubes))),
        "mesh-env": (mesh, JScene.from_desc(mesh)),
    }


@pytest.mark.parametrize("nee", [False, True], ids=["plain", "nee"])
@pytest.mark.parametrize("intersector", ["bruteforce", "bvh"])
@pytest.mark.parametrize("kind", ["empty-env", "65-cubes", "mesh-env"])
def test_renderer_reference_matches_jax(kind, intersector, nee, render_scenes):
    desc, oracle = render_scenes[kind]
    cfg = dict(trace_depth=2, samples_per_launch=1, pipeline="reference",
               intersector=intersector, nee=nee)
    want = JRenderer(oracle, JConfig(**cfg), seed=SEED)
    want.render(1)
    got = Renderer(Scene.from_desc(desc, "cpu"), RenderConfig(**cfg), seed=SEED, device="cpu")
    assert got.pipeline == "reference"
    got.render(1)
    assert_within_oracle_tolerance(got.state.accum.numpy(), np.asarray(want.state.accum))


@pytest.mark.parametrize("kind", ["empty-env", "65-cubes", "mesh-env"])
def test_auto_routes_to_the_reference_pipeline(kind, render_scenes, monkeypatch):
    """Each render scene takes the reference pipeline under 'auto' on the
    JAX package's accelerator and in the port, with the BVH past 64
    primitives."""
    from cosc_4397_pathtracing_raytracing_project_tpu.render import engine as jengine

    desc, oracle = render_scenes[kind]
    port = Scene.from_desc(desc, "cpu")
    for cfg in (dict(), dict(nee=True)):
        monkeypatch.setattr(jengine.jax, "devices",
                            lambda: [type("D", (), {"platform": "tpu"})()])
        want = JConfig(**cfg).resolve_pipeline(oracle)
        monkeypatch.undo()
        assert RenderConfig(**cfg).resolve_pipeline(port) == want == "reference"
        assert (RenderConfig(**cfg).resolve_intersector(port)
                == JConfig(**cfg).resolve_intersector(oracle))
