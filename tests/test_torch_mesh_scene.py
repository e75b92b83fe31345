"""PyTorch port, the mesh pipeline's host side: the scene's triangles, the BVH
build and the cluster kernel's packing against the JAX package's, exactly,
on scenes/mesh1080p.txt (38.5k triangles) and on random boxes; the triangle
hand-over of ``convert.scene_from_jax_arrays``; and the routing of mesh
scenes (``resolve_pipeline``, the megakernel's ``supports``)."""

import os

import numpy as np
import pytest
import torch

from cosc_4397_pathtracing_raytracing_project_tpu.ops import bvh as jbvh
from cosc_4397_pathtracing_raytracing_project_tpu.ops.pallas import mesh_kernel as jmk
from cosc_4397_pathtracing_raytracing_project_tpu.scene import Scene as JScene
from cosc_4397_pathtracing_raytracing_project_tpu.scene import load_scene_desc as jload
from cosc_4397_pathtracing_raytracing_project_tpu_torch import RenderConfig, convert
from cosc_4397_pathtracing_raytracing_project_tpu_torch.ops import bvh as tbvh
from cosc_4397_pathtracing_raytracing_project_tpu_torch.ops import fast
from cosc_4397_pathtracing_raytracing_project_tpu_torch.ops.cuda import megakernel as tmk
from cosc_4397_pathtracing_raytracing_project_tpu_torch.ops.cuda import mesh_kernel as tmesh
from cosc_4397_pathtracing_raytracing_project_tpu_torch.scene import Scene, load_scene_desc

from test_torch_cuda import tri_scene_desc

torch.set_num_threads(2)

MESH = os.path.join(os.path.dirname(__file__), "..", "scenes", "mesh1080p.txt")
TRI_FIELDS = ("v0", "e1", "e2", "normal", "material_id", "geom_index")


@pytest.fixture(scope="module")
def mesh_pair():
    """mesh1080p as the port's and the JAX package's scenes."""
    return Scene.from_desc(load_scene_desc(MESH), "cpu"), JScene.from_desc(jload(MESH))


@pytest.fixture(scope="module")
def mesh_boxes(mesh_pair):
    """The triangles' AABBs, as make_mesh_intersector builds its BVH."""
    tri = mesh_pair[0].triangles
    v0, e1, e2 = (getattr(tri, f).numpy() for f in ("v0", "e1", "e2"))
    tmin = np.minimum(np.minimum(v0, v0 + e1), v0 + e2)
    tmax = np.maximum(np.maximum(v0, v0 + e1), v0 + e2)
    return tmin, tmax


def test_mesh1080p_triangles_equal_jax(mesh_pair):
    port, oracle = mesh_pair
    assert port.num_triangles == oracle.triangles.count == 38530
    for f in TRI_FIELDS:
        got, want = getattr(port.triangles, f).numpy(), np.asarray(getattr(oracle.triangles, f))
        assert got.dtype == want.dtype, f
        np.testing.assert_array_equal(got, want, err_msg=f)
    assert (port.cubes.count, port.spheres.count) == (1, 0)


def _assert_bvh_equal(got, want):
    for f in ("bounds_min", "bounds_max", "miss_link", "leaf_start", "leaf_count", "order"):
        g, w = getattr(got, f), getattr(want, f)
        assert g.dtype == w.dtype, f
        np.testing.assert_array_equal(g, w, err_msg=f)


def test_build_bvh_equals_jax_on_mesh1080p(mesh_boxes):
    tmin, tmax = mesh_boxes
    got, want = tbvh.build_bvh(tmin, tmax, leaf_size=8), jbvh.build_bvh(tmin, tmax, leaf_size=8)
    assert got.num_nodes == want.num_nodes
    _assert_bvh_equal(got, want)


@pytest.mark.parametrize("leaf", [1, 4, 8])
def test_build_bvh_equals_jax_on_random_boxes(leaf):
    rng = np.random.default_rng(leaf)
    mins = rng.uniform(-10, 10, (257, 3)).astype(np.float32)
    maxs = mins + rng.uniform(0.1, 3, (257, 3)).astype(np.float32)
    _assert_bvh_equal(tbvh.build_bvh(mins, maxs, leaf), jbvh.build_bvh(mins, maxs, leaf))
    with pytest.raises(ValueError, match="zero primitives"):
        tbvh.build_bvh(mins[:0], maxs[:0])


@pytest.mark.parametrize("cluster_size", [64, 16])
def test_packing_equals_jax_on_mesh1080p(mesh_pair, mesh_boxes, cluster_size):
    """treelet_cut, pack_clusters and build_visit_tables over mesh1080p's
    BVH (leaf 8) give the JAX package's arrays."""
    tri = mesh_pair[0].triangles
    bvh = tbvh.build_bvh(*mesh_boxes, leaf_size=8)
    clusters, membership = tmesh.treelet_cut(bvh, cluster_size)
    assert (clusters, membership) == jmk.treelet_cut(bvh, cluster_size)
    o = bvh.order
    v0, e1, e2 = (getattr(tri, f).numpy()[o] for f in ("v0", "e1", "e2"))
    mat = tri.material_id.numpy()[o].astype(np.float32)
    rows, aabbs = tmesh.pack_clusters(v0, e1, e2, mat, clusters, cluster_size)
    jrows, jaabbs = jmk.pack_clusters(v0, e1, e2, mat, clusters, cluster_size)
    np.testing.assert_array_equal(rows, jrows)
    np.testing.assert_array_equal(aabbs, jaabbs)
    got = tmesh.build_visit_tables(aabbs, membership)
    want = jmk.build_visit_tables(jaabbs, membership)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert got[2] == want[2]
    if cluster_size == 64:
        # the size chip_smoke.py and PERF.md quote
        assert (len(clusters), got[2]) == (1024, 64)


def test_scene_from_jax_arrays_carries_triangles():
    desc = tri_scene_desc()
    jscene = JScene.from_desc(desc)

    def leaves(obj, fields):
        return {f: np.asarray(getattr(obj, f)) for f in fields}

    batch_fields = ("material_id", "geom_index", "transform", "inv_transform", "inv_transpose")
    d = {
        "cubes": leaves(jscene.cubes, batch_fields),
        "spheres": leaves(jscene.spheres, batch_fields),
        "triangles": leaves(jscene.triangles, TRI_FIELDS),
        "materials": leaves(jscene.materials, (
            "color", "specular_color", "specular_exponent", "reflectivity",
            "refractive", "ior", "emittance")),
        "camera": dict(
            leaves(jscene.camera, ("position", "view", "up", "right",
                                   "pixel_length", "aperture", "focal")),
            resolution=jscene.camera.resolution,
        ),
        "envmap": None,
    }
    got = convert.scene_from_jax_arrays(d, "cpu")
    want = Scene.from_desc(desc, "cpu")
    assert got.num_triangles == 72
    for f in TRI_FIELDS:
        assert torch.equal(getattr(got.triangles, f), getattr(want.triangles, f)), f


def test_mesh_scenes_route_to_fast_mesh(mesh_pair):
    port, _ = mesh_pair
    assert fast.supports_mesh(port) and not tmk.supports(port)
    assert RenderConfig().resolve_pipeline(port) == "fast_mesh"
    assert RenderConfig(pipeline="fast_mesh", nee=True).resolve_pipeline(port) == "fast_mesh"
    with pytest.raises(ValueError, match="analytic"):
        RenderConfig(pipeline="pallas").resolve_pipeline(port)
    analytic = Scene.from_desc(load_scene_desc(
        os.path.join(os.path.dirname(MESH), "cornell.txt")), "cpu")
    assert analytic.num_triangles == 0 and not fast.supports_mesh(analytic)
    with pytest.raises(ValueError, match="triangles"):
        RenderConfig(pipeline="fast_mesh").resolve_pipeline(analytic)
