"""BVH construction (host) and the stackless device traversal.

Port of the JAX package's ``ops/bvh.py``. The host build (``FlatBVH``,
``build_bvh``) replicates the reference exactly (`src/pathtrace.cu:23-111`):
a recursive median split on the longest axis of the *centroid* bounding
box, primitives sorted by centroid (`buildBVHRecursive`, `:52-99`), nodes
emitted in preorder so the left child is always ``index + 1``, each node
threaded with a ``miss_link`` (the preorder successor of its subtree). The
mesh pipeline cuts this tree into the cluster kernel's treelets
(``ops/cuda/mesh_kernel.treelet_cut``). Every tree the package renders
with comes from the native C++ builder (:func:`try_native_build`, the host
runtime ``native/``); the NumPy :func:`build_bvh` is its plain version,
which the tests hold it equal to, node for node and bit for bit.

:class:`BVHIntersector` (``intersector='bvh'``) walks the threaded tree
with one forward-moving pointer per ray, ``next = hit_box ? (leaf ? miss :
index+1) : miss``, for all rays at once until none is left (:func:`_traverse`;
in eager torch one host sync a step), with the reference's slab test
(``intersectAABB``, `:113-128`). Analytic primitives share one tree;
triangles get their own, and on a CUDA device they go to the cluster
kernel K7 instead (``ops/cuda/mesh_kernel.py``), as the JAX package sends
them to its Pallas kernel on its accelerator.
"""

from __future__ import annotations

import dataclasses
import sys
from typing import Callable, Tuple

import numpy as np
import torch

from ..native import runtime
from ..scene.transforms import unit_cube_world_aabb
from . import linalg
from .intersect import _BACKOFF, _MISS, Hit, cube_hit_detail, sphere_hit_detail

_FMAX = float(np.float32(3.402823466e38))


@dataclasses.dataclass
class FlatBVH:
    """Flattened, threaded BVH (NumPy, host)."""

    bounds_min: np.ndarray  # (K, 3) f32
    bounds_max: np.ndarray  # (K, 3) f32
    miss_link: np.ndarray  # (K,) i32 — preorder successor of the subtree
    leaf_start: np.ndarray  # (K,) i32 — index into `order`, -1 for internal
    leaf_count: np.ndarray  # (K,) i32
    order: np.ndarray  # (P,) i32 — primitive ids in leaf-contiguous order

    @property
    def num_nodes(self) -> int:
        return int(self.bounds_min.shape[0])


def build_bvh(mins: np.ndarray, maxs: np.ndarray, leaf_size: int = 1) -> FlatBVH:
    """Median-split build (reference algorithm, generalized leaf size) over
    the primitives' axis-aligned boxes ``mins``/``maxs`` [P, 3]."""
    n = mins.shape[0]
    if n == 0:
        raise ValueError("cannot build a BVH over zero primitives")
    mins = np.asarray(mins, np.float32)
    maxs = np.asarray(maxs, np.float32)
    centroids = (mins + maxs) * 0.5

    bmin, bmax, lstart, lcount = [], [], [], []
    order: list = []

    # Preorder recursion; parents union their children's bounds after both
    # subtrees are emitted (`pathtrace.cu:95-98`).
    def rec(indices: np.ndarray) -> int:
        node = len(bmin)
        bmin.append(None)
        bmax.append(None)
        lstart.append(-1)
        lcount.append(0)
        if len(indices) <= leaf_size:
            bmin[node] = mins[indices].min(axis=0)
            bmax[node] = maxs[indices].max(axis=0)
            lstart[node] = len(order)
            lcount[node] = len(indices)
            order.extend(int(i) for i in indices)
            return node
        cent = centroids[indices]
        extent = cent.max(axis=0) - cent.min(axis=0)
        # axis pick per `pathtrace.cu:79-80`
        if extent[0] > extent[1] and extent[0] > extent[2]:
            axis = 0
        elif extent[1] > extent[2]:
            axis = 1
        else:
            axis = 2
        indices = indices[np.argsort(cent[:, axis], kind="stable")]
        mid = len(indices) // 2
        left = rec(indices[:mid])
        right = rec(indices[mid:])
        bmin[node] = np.minimum(bmin[left], bmin[right])
        bmax[node] = np.maximum(bmax[left], bmax[right])
        return node

    old_limit = sys.getrecursionlimit()
    sys.setrecursionlimit(max(old_limit, 4 * n + 100))
    try:
        rec(np.arange(n))
        k = len(bmin)
        leaf_start = np.asarray(lstart, np.int32)
        # miss link of a node = end of its preorder subtree (next node to
        # visit when the node's box is missed, or after a leaf is tested)
        subtree_end = np.zeros(k, np.int32)

        def mark_ends(node: int) -> int:
            if leaf_start[node] >= 0:
                subtree_end[node] = node + 1
                return node + 1
            left_end = mark_ends(node + 1)
            right_end = mark_ends(left_end)
            subtree_end[node] = right_end
            return right_end

        mark_ends(0)
    finally:
        sys.setrecursionlimit(old_limit)

    return FlatBVH(
        bounds_min=np.stack(bmin).astype(np.float32),
        bounds_max=np.stack(bmax).astype(np.float32),
        miss_link=subtree_end.astype(np.int32),
        leaf_start=leaf_start,
        leaf_count=np.asarray(lcount, np.int32),
        order=np.asarray(order, np.int32),
    )


def try_native_build(mins: np.ndarray, maxs: np.ndarray, leaf_size: int) -> FlatBVH:
    """:func:`build_bvh` by the native C++ builder (``native.runtime``):
    the same tree, its preorder subtree ends as ``miss_link``. Returns the
    tree or raises: ``RuntimeError`` when the runtime does not build,
    ``ValueError`` for no primitives. (The JAX function of this name
    returns ``None`` instead, and its callers fall back to NumPy.)"""
    bmin, bmax, _left, subtree_end, start, count, order = runtime.build_bvh(
        mins, maxs, leaf_size)
    return FlatBVH(
        bounds_min=bmin,
        bounds_max=bmax,
        miss_link=subtree_end,
        leaf_start=start,
        leaf_count=count,
        order=order,
    )


# ─────────────────────────── scene packing ───────────────────────────


def scene_analytic_aabbs(scene) -> Tuple[np.ndarray, np.ndarray]:
    """8-corner world AABBs for the analytic prims (cubes then spheres)."""
    transforms = np.concatenate(
        [scene.cubes.transform.cpu().numpy(), scene.spheres.transform.cpu().numpy()], axis=0
    )
    mins = np.zeros((transforms.shape[0], 3), np.float32)
    maxs = np.zeros_like(mins)
    for i in range(transforms.shape[0]):
        mins[i], maxs[i] = unit_cube_world_aabb(transforms[i])
    return mins, maxs


TRI_METHODS = ("auto", "cluster", "while")


class BVHIntersector:
    """Callable nearest-hit query, ``isect(scene, origins, directions) ->
    Hit``, by threaded-BVH traversal (the JAX ``BVHIntersector``).

    Analytic primitives (cubes + spheres) share one BVH; triangles get
    their own, with leaf size ``leaf_size``. ``tri_method`` picks how
    triangles are tested: ``"while"`` walks their tree with
    :func:`_traverse`; ``"cluster"`` hands them to a
    :class:`~.cuda.mesh_kernel.ClusterMeshIntersector` over the tree's leaf
    order (K7 on a CUDA device, its plain version on the CPU);
    ``"auto"`` takes ``"cluster"`` on a CUDA device and ``"while"``
    elsewhere, as the JAX package takes its Pallas kernel on its
    accelerator. A K7 build or launch failure raises."""

    def __init__(self, scene, leaf_size: int = 4, tri_method: str = "auto"):
        if tri_method not in TRI_METHODS:
            raise ValueError(f"tri_method must be one of {TRI_METHODS}, got {tri_method!r}")
        dev = scene.device
        if tri_method == "auto":
            tri_method = "cluster" if dev.type == "cuda" else "while"
        self.leaf_size = leaf_size
        self.tri_method = tri_method
        host = lambda t: t.detach().cpu().numpy()  # noqa: E731
        kc, ks = scene.cubes.count, scene.spheres.count
        self._has_analytic = (kc + ks) > 0
        if self._has_analytic:
            mins, maxs = scene_analytic_aabbs(scene)
            bvh = try_native_build(mins, maxs, leaf_size)
            self.analytic = _device_bvh(bvh, dev)
            order = torch.as_tensor(bvh.order, dtype=torch.int64, device=dev)
            # primitive tables in BVH leaf order
            both = lambda f: torch.cat([f(scene.cubes), f(scene.spheres)])[order]  # noqa: E731
            self.prim_inv = both(lambda b: b.inv_transform)
            self.prim_tf = both(lambda b: b.transform)
            self.prim_invt = both(lambda b: b.inv_transpose)
            self.prim_mat = both(lambda b: b.material_id)
            self.prim_geo = both(lambda b: b.geom_index)
            self.prim_is_sphere = (order >= kc).to(torch.int32)

        self._has_tris = scene.num_triangles > 0
        if self._has_tris:
            tri = scene.triangles
            v0, e1, e2 = host(tri.v0), host(tri.e1), host(tri.e2)
            tmin = np.minimum(np.minimum(v0, v0 + e1), v0 + e2) - 1e-5
            tmax = np.maximum(np.maximum(v0, v0 + e1), v0 + e2) + 1e-5
            tbvh = try_native_build(tmin, tmax, leaf_size)
            self.tri_bvh = _device_bvh(tbvh, dev)
            torder = tbvh.order
            to = lambda a: torch.as_tensor(a, device=dev)  # noqa: E731
            self.tri_v0 = to(v0[torder])
            self.tri_e1 = to(e1[torder])
            self.tri_e2 = to(e2[torder])
            self.tri_n = to(host(tri.normal)[torder])
            self.tri_mat = to(host(tri.material_id)[torder])
            self.tri_geo = to(host(tri.geom_index)[torder])
            if self.tri_method == "cluster":
                from .cuda.mesh_kernel import ClusterMeshIntersector

                # consecutive clusters over the tree's leaf order, as the
                # JAX package builds its kernel's tables here
                self._cluster = ClusterMeshIntersector(
                    v0[torder], e1[torder], e2[torder], device=dev
                )

    # the engine calls intersectors as f(scene, origins, directions)
    def __call__(self, scene, origins: torch.Tensor, directions: torch.Tensor) -> Hit:
        n = origins.shape[0]
        dev = origins.device
        best_t = torch.full((n,), _MISS, dtype=torch.float32, device=dev)
        best_p = torch.full((n,), -1, dtype=torch.int64, device=dev)
        if self._has_analytic:
            best_t, best_p = _traverse(
                self.analytic, origins, directions,
                lambda pid, mask, o, d: _analytic_candidate_t(self, pid, mask, o, d),
                self.leaf_size, best_t, best_p,
            )
        tri_t = torch.full((n,), _MISS, dtype=torch.float32, device=dev)
        tri_p = torch.full((n,), -1, dtype=torch.int64, device=dev)
        if self._has_tris:
            if self.tri_method == "cluster":
                tri_t, tri_p = self._cluster(origins, directions)
                tri_p = tri_p.to(torch.int64)
                tri_t = torch.where(tri_p < 0, _MISS, tri_t)
            else:
                tri_t, tri_p = _traverse(
                    self.tri_bvh, origins, directions,
                    lambda pid, mask, o, d: _tri_candidate_t(self, pid, mask, o, d),
                    self.leaf_size, tri_t, tri_p,
                )
        return self._finalize(origins, directions, best_t, best_p, tri_t, tri_p)

    def _finalize(self, origins, directions, best_t, best_p, tri_t, tri_p) -> Hit:
        n = origins.shape[0]
        dev = origins.device
        point = torch.zeros((n, 3), dtype=torch.float32, device=dev)
        normal = torch.zeros((n, 3), dtype=torch.float32, device=dev)
        outside = torch.zeros((n,), dtype=torch.bool, device=dev)
        material_id = torch.zeros((n,), dtype=torch.int32, device=dev)
        geom_index = torch.full((n,), -1, dtype=torch.int32, device=dev)

        if self._has_analytic:
            pid = torch.clamp_min(best_p, 0)
            m_tf, m_in, m_it = self.prim_tf[pid], self.prim_inv[pid], self.prim_invt[pid]
            c_pt, c_n, c_out = cube_hit_detail(m_tf, m_in, m_it, origins, directions)
            s_pt, s_n, s_out = sphere_hit_detail(m_tf, m_in, m_it, origins, directions)
            is_sph = self.prim_is_sphere[pid] > 0
            point = torch.where(is_sph[:, None], s_pt, c_pt)
            normal = torch.where(is_sph[:, None], s_n, c_n)
            outside = torch.where(is_sph, s_out, c_out)
            material_id = self.prim_mat[pid]
            geom_index = self.prim_geo[pid]

        if self._has_tris:
            tpid = torch.clamp_min(tri_p, 0)
            t_n = self.tri_n[tpid]
            facing = linalg.dot(directions, t_n) < 0
            t_n = torch.where(facing[:, None], t_n, -t_n)
            t_pt = origins + (tri_t[:, None] - _BACKOFF) * directions
            # strict: an analytic hit at the same t keeps the ray
            tri_wins = tri_t < best_t
            point = torch.where(tri_wins[:, None], t_pt, point)
            normal = torch.where(tri_wins[:, None], t_n, normal)
            outside = torch.where(tri_wins, facing, outside)
            material_id = torch.where(tri_wins, self.tri_mat[tpid], material_id)
            geom_index = torch.where(tri_wins, self.tri_geo[tpid], geom_index)
            best_t = torch.minimum(best_t, tri_t)

        miss = best_t >= _MISS
        return Hit(
            t=best_t,
            point=point,
            normal=normal,
            material_id=torch.where(miss, 0, material_id),
            geom_index=torch.where(miss, -1, geom_index),
            outside=outside,
            miss=miss,
        )


@dataclasses.dataclass(frozen=True)
class _DeviceBVH:
    bounds_min: torch.Tensor
    bounds_max: torch.Tensor
    miss_link: torch.Tensor
    leaf_start: torch.Tensor
    leaf_count: torch.Tensor
    num_nodes: int


def _device_bvh(bvh: FlatBVH, device) -> _DeviceBVH:
    to = lambda a: torch.as_tensor(a, device=device)  # noqa: E731
    return _DeviceBVH(
        bounds_min=to(bvh.bounds_min),
        bounds_max=to(bvh.bounds_max),
        miss_link=to(bvh.miss_link).to(torch.int64),
        leaf_start=to(bvh.leaf_start).to(torch.int64),
        leaf_count=to(bvh.leaf_count).to(torch.int64),
        num_nodes=bvh.num_nodes,
    )


def _analytic_candidate_t(self: BVHIntersector, pid, mask, origins, directions):
    """World-space candidate distance for analytic prims ``pid`` ([N])."""
    inv = self.prim_inv[pid]
    q_o = linalg.transform_point(inv, origins)
    q_d_raw = linalg.transform_vector(inv, directions)
    nq2 = (q_d_raw * q_d_raw).sum(dim=-1)
    rinv = 1.0 / torch.sqrt(torch.clamp_min(nq2, 1e-30))

    # cube slabs (unnormalized direction; see ops.fast for the algebra)
    inv_d = 1.0 / q_d_raw
    t1 = (-0.5 - q_o) * inv_d
    t2 = (0.5 - q_o) * inv_d
    ta = torch.minimum(t1, t2)
    tb = torch.maximum(t1, t2)
    ta_eff = torch.where(ta > 0, ta, -_FMAX)
    tb_eff = torch.where(tb < _FMAX, tb, _FMAX)
    s_min = ta_eff.max(dim=-1).values
    s_max = tb_eff.min(dim=-1).values
    cube_hit = (s_max >= s_min) & (s_max > 0)
    cube_s = torch.where(s_min > 0, s_min, s_max)

    # sphere quadratic
    b = (q_o * q_d_raw).sum(dim=-1)
    c = (q_o * q_o).sum(dim=-1) - 0.25
    disc = b * b - nq2 * c
    sq = torch.sqrt(torch.clamp_min(disc, 0.0))
    s1 = (-b + sq) / nq2
    s2 = (-b - sq) / nq2
    both_neg = (s1 < 0) & (s2 < 0)
    both_pos = (s1 > 0) & (s2 > 0)
    sph_s = torch.where(both_pos, torch.minimum(s1, s2), torch.maximum(s1, s2))
    sph_hit = (disc >= 0) & ~both_neg

    is_sph = self.prim_is_sphere[pid] > 0
    hit = torch.where(is_sph, sph_hit, cube_hit)
    s = torch.where(is_sph, sph_s, cube_s)
    t_world = s - _BACKOFF * rinv
    return torch.where(hit & mask & (t_world > 0), t_world, _MISS)


def _tri_candidate_t(self: BVHIntersector, pid, mask, origins, directions):
    v0, e1, e2 = self.tri_v0[pid], self.tri_e1[pid], self.tri_e2[pid]
    eps = 1e-9
    pvec = linalg.cross(directions, e2)
    det = linalg.dot(e1, pvec)
    inv_det = torch.where(torch.abs(det) > eps, 1.0 / det, 0.0)
    tvec = origins - v0
    u = linalg.dot(tvec, pvec) * inv_det
    qvec = linalg.cross(tvec, e1)
    v = linalg.dot(directions, qvec) * inv_det
    t = linalg.dot(e2, qvec) * inv_det
    hit = (torch.abs(det) > eps) & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (t > _BACKOFF)
    return torch.where(hit & mask, t, _MISS)


def _traverse(bvh: _DeviceBVH, origins, directions, candidate_fn: Callable, leaf_size: int,
              best_t, best_p):
    """Threaded stackless traversal over all rays at once: every ray steps
    one node per iteration until every ray has left the tree (one host
    sync an iteration)."""
    n = origins.shape[0]
    k = bvh.num_nodes
    inv_d = 1.0 / directions  # IEEE inf for axis-parallel rays, as the reference
    idx = torch.zeros((n,), dtype=torch.int64, device=origins.device)
    while bool((idx < k).any()):
        node = torch.clamp_max(idx, k - 1)
        bmin = bvh.bounds_min[node]
        bmax = bvh.bounds_max[node]
        # intersectAABB (`pathtrace.cu:113-128`): tmin=0, tmax=FLT_MAX
        t0 = (bmin - origins) * inv_d
        t1 = (bmax - origins) * inv_d
        lo = torch.where(inv_d < 0, t1, t0)
        hi = torch.where(inv_d < 0, t0, t1)
        tmin = torch.clamp_min(lo.max(dim=-1).values, 0.0)
        tmax = torch.clamp_max(hi.min(dim=-1).values, _FMAX)
        box_hit = tmax > tmin

        start = bvh.leaf_start[node]
        count = bvh.leaf_count[node]
        is_leaf = start >= 0
        active = idx < k

        test_mask = active & box_hit & is_leaf
        for j in range(leaf_size):
            m = test_mask & (j < count)
            pid = torch.where(m, torch.clamp_min(start, 0) + j, 0)
            t = candidate_fn(pid, m, origins, directions)
            better = t < best_t
            best_t = torch.where(better, t, best_t)
            best_p = torch.where(better, pid, best_p)

        miss = bvh.miss_link[node]
        nxt = torch.where(box_hit & ~is_leaf, idx + 1, miss)
        idx = torch.where(active, nxt, k)
    return best_t, best_p


def make_bvh_intersector(scene, leaf_size: int = 4) -> BVHIntersector:
    return BVHIntersector(scene, leaf_size=leaf_size)
