"""PyTorch port, the mesh kernels' plain version on the CPU: the cluster-culled
intersector's ``call_soa`` (K7) and ``call_t`` (K8) against the JAX package's
kernel in interpret mode, and against a brute-force Möller–Trumbore pass.

Inputs are made from numpy seeds: the tri_scene fixture of
tests/test_fast_mesh.py (72 floor triangles in BVH treelet clusters, through
both packages' ``make_mesh_intersector``) and a soup of 300 random
triangles in consecutive clusters (tests/test_megakernel.py's case), with
every fifth ray inactive and one axis-parallel ray whose origin lies on a
cluster's box plane. Outputs are compared on active rays only: the TPU kernel
tests every ray of an entered tile, so an inactive ray's output depends on
its neighbours, while the port writes a miss for it.

Tolerances: ``t`` within 1e-6 relative (both sides round the same float32
operations; 1e-6 leaves room for the oracle's XLA:CPU fusion), indices
equal except at ties, rays where two triangles give the same distance and
the two visit orders keep different ones; normals within 1e-6 (rsqrt against
1/sqrt) and materials equal wherever the index agrees. Measured on these
inputs: no tie, and the brute-force pass agrees with the plain version on
every ray (no hit lost to the clusters' padded boxes).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cosc_4397_pathtracing_raytracing_project_tpu.ops.pallas import mesh_kernel as jmk
from cosc_4397_pathtracing_raytracing_project_tpu.render.engine import (
    make_mesh_intersector as jax_make_mesh_intersector,
)
from cosc_4397_pathtracing_raytracing_project_tpu.scene import Scene as JScene
from cosc_4397_pathtracing_raytracing_project_tpu_torch.ops.cuda import mesh_kernel as tmesh
from cosc_4397_pathtracing_raytracing_project_tpu_torch.render.engine import (
    make_mesh_intersector,
)
from cosc_4397_pathtracing_raytracing_project_tpu_torch.scene import Scene

from test_torch_cuda import (
    brute_force_mt,
    octant_walk,
    soup_rays,
    tri_scene_desc,
    triangle_soup,
)

torch.set_num_threads(2)

N = 512


def _tri_scene_rays():
    """Camera-like rays at the floor from above plus random ones, every
    fifth inactive, and (last) one ray along +x whose origin lies exactly on
    the lower y plane of the first cluster's box: (lo_y - o_y)·(1/0) = NaN
    in its slab test."""
    rng = np.random.default_rng(17)
    o = np.tile(np.array([[0.0, 2.5, 9.0]], np.float32), (N, 1))
    o[N // 2:] = rng.uniform(-6, 6, (N - N // 2, 3)).astype(np.float32)
    target = np.stack(
        [rng.uniform(-5, 5, N), rng.uniform(-0.5, 0.5, N), rng.uniform(-5, 5, N)], axis=1
    ).astype(np.float32)
    d = target - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    active = np.ones(N, np.float32)
    active[::5] = 0.0
    return o, d.astype(np.float32), active


@pytest.fixture(scope="module")
def tri_pair():
    desc = tri_scene_desc()
    port = make_mesh_intersector(Scene.from_desc(desc, "cpu"))
    oracle = jax_make_mesh_intersector(JScene.from_desc(desc), interpret=True)
    o, d, active = _tri_scene_rays()
    box = port.tables.aabbs[0]
    o[-1] = [box[0] - 1.0, box[1], 0.5 * (box[2] + box[5])]
    d[-1] = [1.0, 0.0, 0.0]
    active[-1] = 1.0
    return port, oracle, (*o.T, *d.T, active)


@pytest.fixture(scope="module")
def soup_pair():
    v0, e1, e2, mat = triangle_soup(5)
    port = tmesh.ClusterMeshIntersector(v0, e1, e2, mat)
    oracle = jmk.ClusterMeshIntersector(v0, e1, e2, mat, interpret=True)
    return port, oracle, soup_rays(9), (v0, e1, e2)


def _run_port(port, rays, full=True):
    t = [torch.from_numpy(np.ascontiguousarray(r)) for r in rays]
    out = port.call_soa(*t) if full else (port.call_t(*t),)
    return [o.numpy() for o in out]


def _run_oracle(oracle, rays, full=True):
    j = [jnp.asarray(r) for r in rays]
    out = oracle.call_soa(*j) if full else (oracle.call_t(*j),)
    return [np.asarray(o) for o in out]


def _compare(got, want, active):
    """Assert the module's tolerances on active rays; returns the tie count."""
    a = active > 0.5
    np.testing.assert_allclose(got[0][a], want[0][a], rtol=1e-6, atol=0)
    if len(got) == 1:
        return 0
    same = a & (got[1] == want[1])
    ties = int((a & ~same).sum())
    print(f"active {int(a.sum())}, hits {int((a & (want[1] >= 0)).sum())}, ties {ties}")
    for k in (2, 3, 4):
        np.testing.assert_allclose(got[k][same], want[k][same], rtol=0, atol=1e-6)
    np.testing.assert_array_equal(got[5][same], want[5][same])
    return ties


@pytest.mark.parametrize("full", [True, False], ids=["call_soa", "call_t"])
def test_tri_scene_plain_matches_oracle(tri_pair, full):
    port, oracle, rays = tri_pair
    got, want = _run_port(port, rays, full), _run_oracle(oracle, rays, full)
    assert _compare(got, want, rays[6]) == 0
    hits = (got[0] < tmesh._MISS) & (rays[6] > 0.5)
    assert hits.sum() > N // 3  # the rays do reach the floor
    assert np.all(got[0][rays[6] < 0.5] == tmesh._MISS)  # inactive: a miss
    if full:
        assert np.all(got[1][rays[6] < 0.5] == -1)


@pytest.mark.parametrize("full", [True, False], ids=["call_soa", "call_t"])
def test_soup_plain_matches_oracle(soup_pair, full):
    port, oracle, rays, _ = soup_pair
    got, want = _run_port(port, rays, full), _run_oracle(oracle, rays, full)
    assert _compare(got, want, rays[6]) == 0


def test_soup_plain_matches_brute_force(soup_pair):
    """Cluster culling loses no hit: the plain version equals a brute-force
    float32 Möller–Trumbore pass over all 300 triangles on every active
    ray (same t bit for bit, same index: these inputs hold no tie)."""
    port, _, rays, (v0, e1, e2) = soup_pair
    t, idx = _run_port(port, rays)[:2]
    bt, bi = brute_force_mt(v0, e1, e2, rays)
    a = rays[6] > 0.5
    lost = int((a & (bi >= 0) & (idx < 0)).sum())
    print(f"brute force: {int((a & (bi >= 0)).sum())} hits, {lost} lost to culling")
    assert lost == 0
    np.testing.assert_array_equal(t[a], bt[a])
    np.testing.assert_array_equal(idx[a], bi[a])


def test_nan_slab_ray_is_culled_as_in_the_oracle(tri_pair):
    """The axis-parallel ray on a box plane: its y slab is NaN, which the
    NaN-propagating min/max of the plain version (and of the CUDA kernel)
    turn into a cull, as jnp.minimum/maximum do in the oracle's _slab."""
    port, _, rays = tri_pair
    box = port.tables.aabbs[0]
    o = [torch.tensor([r[-1]]) for r in rays[:3]]
    inv = [1.0 / torch.tensor([r[-1]]) for r in rays[3:6]]
    assert torch.isnan(inv[1] * (float(box[1]) - o[1])).all()
    best = torch.tensor([tmesh._MISS])
    assert not bool(tmesh._slab(box.tolist(), *o, *inv, best))
    jbox = jnp.asarray(box[None, :])
    want = jmk._slab(jbox, *(jnp.asarray(v.numpy()) for v in o + inv),
                     jnp.float32(tmesh._MISS), jnp.ones((1,), bool))
    assert not bool(want[0])
    stats = {}
    single = [np.ascontiguousarray(r[-1:]) for r in rays]
    tmesh.intersect_reference(port.tables, *(torch.from_numpy(r) for r in single), stats=stats)
    assert stats["tri"] == 0  # no cluster entered


def test_tables_match_oracle(tri_pair, soup_pair):
    """Both packages pack the same rows: treelet clusters from the BVH of
    make_mesh_intersector, consecutive clusters without one."""
    for port, oracle in (tri_pair[:2], soup_pair[:2]):
        np.testing.assert_array_equal(port.tables.tri_rows.numpy(), np.asarray(oracle.tri_rows))
        np.testing.assert_array_equal(port.tables.sc_rows.numpy(), np.asarray(oracle.sc_rows))
        np.testing.assert_array_equal(port.tables.cl_rows.numpy(), np.asarray(oracle.cl_rows))
        assert port.num_super == oracle.num_super
        assert port.num_clusters == oracle.num_clusters


def test_reference_counts_its_work(soup_pair):
    """``stats`` counts one slab test per active ray and cluster, and 64
    triangle tests per entered (ray, cluster) pair."""
    port, _, rays, _ = soup_pair
    stats = {}
    tmesh.intersect_reference(port.tables, *(torch.from_numpy(r) for r in rays), stats=stats)
    n_active = int((rays[6] > 0.5).sum())
    assert stats["slab"] == n_active * port.num_clusters
    assert 0 < stats["tri"] <= stats["slab"] * tmesh.CLUSTER
    assert stats["tri"] % tmesh.CLUSTER == 0


def test_kernel_wrapper_needs_a_cuda_device(soup_pair):
    port = soup_pair[0]
    rays = [torch.zeros(4) for _ in range(7)]
    with pytest.raises(ValueError, match="CUDA"):
        tmesh.KERNEL(port.tables, *rays)
    assert tmesh.KERNEL.launches == 0


def test_work_counters_only_with_the_counting_build(soup_pair):
    """Only the -DPT_MESH_COUNT build takes work counters; both builds
    need a CUDA device."""
    port = soup_pair[0]
    rays = [torch.zeros(4) for _ in range(7)]
    work = torch.zeros(3, dtype=torch.int64)
    with pytest.raises(ValueError, match="work counters"):
        tmesh.KERNEL(port.tables, *rays, work=work)
    with pytest.raises(ValueError, match="work counters"):
        tmesh.COUNTING(port.tables, *rays)
    with pytest.raises(ValueError, match="CUDA"):
        tmesh.kernel_work(port.tables, *rays)
    assert tmesh.KERNEL.launches == tmesh.COUNTING.launches == 0


@pytest.mark.parametrize("case", ["tri_scene", "soup"])
def test_octant_walk_matches_plain_version(tri_pair, soup_pair, case):
    """The numpy emulation of the CUDA kernel's walk (per-ray octant order,
    superclusters then clusters, against the running best t), whose work
    counts the CUDA tests hold the kernel's counting build to, finds the
    plain version's hits: the same t bit for bit and the same index on every
    active ray (no tie on these inputs). It slab-tests every supercluster of
    the octant and enters only part of the clusters."""
    port, _, rays = tri_pair if case == "tri_scene" else soup_pair[:3]
    t, idx, work = octant_walk(port.tables, rays)
    stats = {}
    want = tmesh.intersect_reference(
        port.tables, *(torch.from_numpy(np.ascontiguousarray(r)) for r in rays), stats=stats)
    a = rays[6] > 0.5
    np.testing.assert_array_equal(t[a], want[0].numpy()[a])
    np.testing.assert_array_equal(idx[a], want[1].numpy()[a])
    print(f"walk {work}, plain version {stats}")
    assert work["sc_slab"] == int(a.sum()) * port.num_super
    assert work["cl_slab"] % tmesh.SUPER == 0 and work["tri"] % tmesh.CLUSTER == 0
    assert 0 < work["tri"] < int(a.sum()) * port.num_clusters * tmesh.CLUSTER


@pytest.mark.parametrize("case", ["tri_scene", "soup"])
def test_octant_walk_counts_warp_iterations(tri_pair, soup_pair, case):
    """The emulation's warp iterations, which the CUDA tests hold the
    counting build to, in each of the kernel's walks: the tests are the same
    in both. The lane walk steps a warp with an active ray through every
    supercluster, 16 cluster slabs side by side and cluster_size rows per
    cluster index; the warp walk runs 32 superclusters a step, 16 lanes on a
    ray's clusters and 32 on its rows."""
    port, _, rays = tri_pair if case == "tri_scene" else soup_pair[:3]
    a = rays[6] > 0.5
    s_count = port.num_super
    lane, warp = (octant_walk(port.tables, rays, walk)[2] for walk in ("lane", "warp"))
    tests = ("sc_slab", "cl_slab", "tri")
    assert {k: lane[k] for k in tests} == {k: warp[k] for k in tests}
    warps_active = int(np.add.reduceat(a, np.arange(0, a.size, 32)).astype(bool).sum())
    assert lane["sc_warp"] == s_count * warps_active
    assert lane["cl_warp"] % tmesh.SUPER == 0 and lane["tri_warp"] % tmesh.CLUSTER == 0
    assert 32 * lane["tri_warp"] >= lane["tri"] > 0
    assert warp["sc_warp"] == int(a.sum()) * -(-s_count // 32)
    assert tmesh.SUPER * warp["cl_warp"] == warp["cl_slab"]
    assert 32 * warp["tri_warp"] == warp["tri"]


def test_tables_hold_the_triangles_bounds(tri_pair):
    """``tables.bounds``: the triangles' bounding-box minimum and its extent
    clamped at 1e-3, as the mesh pipeline's ray sort computed them from the
    scene's triangles on every sample before."""
    port = tri_pair[0]
    tri = Scene.from_desc(tri_scene_desc(), "cpu").triangles
    v1, v2 = tri.v0 + tri.e1, tri.v0 + tri.e2
    lo = torch.minimum(tri.v0.amin(dim=0), torch.minimum(v1.amin(dim=0), v2.amin(dim=0)))
    hi = torch.maximum(tri.v0.amax(dim=0), torch.maximum(v1.amax(dim=0), v2.amax(dim=0)))
    assert torch.equal(port.tables.bounds[0], lo)
    assert torch.equal(port.tables.bounds[1], torch.clamp_min(hi - lo, 1e-3))
