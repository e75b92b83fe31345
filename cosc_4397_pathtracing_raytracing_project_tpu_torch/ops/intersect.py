"""Ray-primitive intersection (vectorized, two-phase): the reference
pipeline's brute-force intersector.

Port of the JAX package's ``ops/intersect.py``: rays are transformed into
the canonical frame (unit cube [-0.5,0.5]^3 / sphere r=0.5,
`src/intersections.h:48-144`), the object-space hit parameter backs off by
1e-4, and the returned ``t`` is the world-space distance to the backed-off
hit point. Phase 1 computes every candidate's distance as ``[N, K]``
tensors; phase 2 reconstructs the winner's point and normal. Triangles are
tested by Möller–Trumbore in world space, ``[N, T]`` at once. The
megakernel's split-mode background composite reads ``.miss`` from here.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from ..scene.structs import GeomBatch, Scene, TriangleBatch
from . import linalg

_BACKOFF = 1e-4  # getPointOnRay epsilon (`intersections.h:28`)
_FMAX = 3.402823466e38  # FLT_MAX, as in the reference slab test
_MISS = 1e30  # internal sentinel for "no hit" distances


@dataclasses.dataclass
class Hit:
    """SoA intersection record (`ShadeableIntersection`, `sceneStructs.h:75-83`).
    ``t`` is the world-space distance; misses carry ``t = _MISS``."""

    t: torch.Tensor  # (N,) f32
    point: torch.Tensor  # (N, 3) f32
    normal: torch.Tensor  # (N, 3) f32
    material_id: torch.Tensor  # (N,) i32
    geom_index: torch.Tensor  # (N,) i32 (scene OBJECT id; -1 on miss)
    outside: torch.Tensor  # (N,) bool: ray origin outside the primitive
    miss: torch.Tensor  # (N,) bool


def take_rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Rows ``idx`` ((N,) int) of a small table ((K, ...)) → (N, ...). The
    JAX package selects them with a one-hot matmul at HIGHEST precision,
    which maps onto the TPU's matrix unit and yields each row exactly; an
    index gather selects the same rows."""
    return table[idx.long()]


def _to_object_space(
    inv: torch.Tensor, origins: torch.Tensor, directions: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Rays in object space, directions renormalized as in
    `intersections.h:51-52,106-107`."""
    o = linalg.transform_point(inv, origins)
    d = linalg.normalize(linalg.transform_vector(inv, directions))
    return o, d


def _cube_slabs(q_o: torch.Tensor, q_d: torch.Tensor):
    """Slab test in canonical-cube space: (t_obj, hit, outside, normal_obj)
    with the reference's tie-breaking (`intersections.h:54-84`)."""
    t1 = (-0.5 - q_o) / q_d
    t2 = (0.5 - q_o) / q_d
    ta = torch.minimum(t1, t2)
    tb = torch.maximum(t1, t2)
    sign = torch.where(t2 < t1, 1.0, -1.0)
    ta_eff = torch.where(ta > 0, ta, -_FMAX)
    tmin, axis_min = ta_eff.max(dim=-1)
    tb_eff = torch.where(tb < _FMAX, tb, _FMAX)
    tmax, axis_max = tb_eff.min(dim=-1)
    # max/min over the 3 axes return the first extremal index, as argmax does
    hit = (tmax >= tmin) & (tmax > 0)
    outside = tmin > 0
    t_obj = torch.where(outside, tmin, tmax)
    axis = torch.where(outside, axis_min, axis_max)
    onehot = (torch.arange(3, device=axis.device) == axis[..., None]).to(torch.float32)
    normal_obj = onehot * torch.gather(sign, -1, axis[..., None])
    return t_obj, hit, outside, normal_obj


def _sphere_quadratic(q_o: torch.Tensor, q_d: torch.Tensor):
    """Canonical r=0.5 sphere quadratic (`intersections.h:113-133`)."""
    v_dot_d = linalg.dot(q_o, q_d)
    radicand = v_dot_d * v_dot_d - (linalg.dot(q_o, q_o) - 0.25)
    sq = torch.sqrt(torch.clamp_min(radicand, 0.0))
    t1 = -v_dot_d + sq
    t2 = -v_dot_d - sq
    both_neg = (t1 < 0) & (t2 < 0)
    both_pos = (t1 > 0) & (t2 > 0)
    t_obj = torch.where(both_pos, torch.minimum(t1, t2), torch.maximum(t1, t2))
    hit = (radicand >= 0) & ~both_neg
    return t_obj, hit, both_pos


def _candidate_t(batch: GeomBatch, origins, directions, slabs) -> torch.Tensor:
    """Phase 1: world-space hit distances vs every primitive of the batch,
    (N, K), misses at _MISS."""
    q_o, q_d = _to_object_space(
        batch.inv_transform[None, :], origins[:, None], directions[:, None]
    )
    t_obj, hit = slabs(q_o, q_d)[:2]
    p_obj = q_o + (t_obj[..., None] - _BACKOFF) * q_d
    p_world = linalg.transform_point(batch.transform[None, :], p_obj)
    t_world = linalg.norm(origins[:, None] - p_world)
    return torch.where(hit, t_world, _MISS)


def cube_candidate_t(batch: GeomBatch, origins, directions) -> torch.Tensor:
    return _candidate_t(batch, origins, directions, _cube_slabs)


def sphere_candidate_t(batch: GeomBatch, origins, directions) -> torch.Tensor:
    return _candidate_t(batch, origins, directions, _sphere_quadratic)


def cube_hit_detail(transform, inv_transform, inv_transpose, origins, directions):
    """Phase 2: (point, normal, outside) per ray for per-ray cube matrices."""
    q_o, q_d = _to_object_space(inv_transform, origins, directions)
    t_obj, _, outside, normal_obj = _cube_slabs(q_o, q_d)
    p_obj = q_o + (t_obj[..., None] - _BACKOFF) * q_d
    point = linalg.transform_point(transform, p_obj)
    normal = linalg.normalize(linalg.transform_vector(inv_transpose, normal_obj))
    return point, normal, outside


def sphere_hit_detail(transform, inv_transform, inv_transpose, origins, directions):
    q_o, q_d = _to_object_space(inv_transform, origins, directions)
    t_obj, _, outside = _sphere_quadratic(q_o, q_d)
    p_obj = q_o + (t_obj[..., None] - _BACKOFF) * q_d
    point = linalg.transform_point(transform, p_obj)
    normal = linalg.normalize(linalg.transform_vector(inv_transpose, p_obj))
    normal = torch.where(outside[..., None], normal, -normal)
    return point, normal, outside


def triangle_candidate_t(tris: TriangleBatch, origins: torch.Tensor,
                         directions: torch.Tensor) -> torch.Tensor:
    """Möller–Trumbore against every triangle, (N, T), misses at _MISS;
    world space throughout (the mesh extension; no reference counterpart)."""
    eps = 1e-9
    d = directions[:, None]  # (N,1,3)
    pvec = linalg.cross(d, tris.e2[None, :])
    det = linalg.dot(tris.e1[None, :], pvec)
    inv_det = torch.where(torch.abs(det) > eps, 1.0 / det, 0.0)
    tvec = origins[:, None] - tris.v0[None, :]
    u = linalg.dot(tvec, pvec) * inv_det
    qvec = linalg.cross(tvec, tris.e1[None, :])
    v = linalg.dot(d, qvec) * inv_det
    t = linalg.dot(tris.e2[None, :], qvec) * inv_det
    hit = (torch.abs(det) > eps) & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (t > _BACKOFF)
    return torch.where(hit, t, _MISS)


def intersect_scene(scene: Scene, origins: torch.Tensor, directions: torch.Tensor) -> Hit:
    """Nearest-hit query over every primitive (the computeIntersections
    kernel, `src/pathtrace.cu:288-333`, without BVH culling: see
    ``ops/bvh.py``). The winner's rows are taken with :func:`take_rows`;
    ``min(dim=1)`` keeps the first of equal distances, as ``jnp.argmin``
    does, so ties go to the lower primitive index and analytic primitives
    beat triangles at equal ``t``."""
    kc, ks = scene.cubes.count, scene.spheres.count
    n = origins.shape[0]
    dev = origins.device
    point = torch.zeros((n, 3), dtype=torch.float32, device=dev)
    normal = torch.zeros((n, 3), dtype=torch.float32, device=dev)
    outside = torch.zeros((n,), dtype=torch.bool, device=dev)
    best_t = torch.full((n,), _MISS, dtype=torch.float32, device=dev)
    material_id = torch.zeros((n,), dtype=torch.int32, device=dev)
    geom_index = torch.full((n,), -1, dtype=torch.int32, device=dev)
    if kc or ks:
        batches = [b for b in (scene.cubes, scene.spheres) if b.count]
        cand = []
        if kc:
            cand.append(cube_candidate_t(scene.cubes, origins, directions))
        if ks:
            cand.append(sphere_candidate_t(scene.spheres, origins, directions))
        best_t, best_idx = torch.cat(cand, dim=1).min(dim=1)
        m_t = take_rows(torch.cat([b.transform for b in batches]), best_idx)
        m_i = take_rows(torch.cat([b.inv_transform for b in batches]), best_idx)
        m_n = take_rows(torch.cat([b.inv_transpose for b in batches]), best_idx)
        if kc and ks:
            c_point, c_normal, c_outside = cube_hit_detail(m_t, m_i, m_n, origins, directions)
            s_point, s_normal, s_outside = sphere_hit_detail(m_t, m_i, m_n, origins, directions)
            is_sphere = best_idx >= kc
            point = torch.where(is_sphere[:, None], s_point, c_point)
            normal = torch.where(is_sphere[:, None], s_normal, c_normal)
            outside = torch.where(is_sphere, s_outside, c_outside)
        else:
            detail = cube_hit_detail if kc else sphere_hit_detail
            point, normal, outside = detail(m_t, m_i, m_n, origins, directions)
        material_id = take_rows(torch.cat([b.material_id for b in batches]), best_idx)
        geom_index = take_rows(torch.cat([b.geom_index for b in batches]), best_idx)
    if scene.num_triangles:
        tris = scene.triangles
        tri_best_t, tri_best_idx = triangle_candidate_t(tris, origins, directions).min(dim=1)
        tri_n = take_rows(tris.normal, tri_best_idx)
        facing = linalg.dot(directions, tri_n) < 0
        tri_n = torch.where(facing[:, None], tri_n, -tri_n)
        tri_point = origins + (tri_best_t[:, None] - _BACKOFF) * directions
        tri_wins = tri_best_t < best_t
        point = torch.where(tri_wins[:, None], tri_point, point)
        normal = torch.where(tri_wins[:, None], tri_n, normal)
        outside = torch.where(tri_wins, facing, outside)
        material_id = torch.where(tri_wins, take_rows(tris.material_id, tri_best_idx),
                                  material_id)
        geom_index = torch.where(tri_wins, take_rows(tris.geom_index, tri_best_idx), geom_index)
        best_t = torch.minimum(best_t, tri_best_t)
    miss = best_t >= _MISS
    geom_index = torch.where(miss, -1, geom_index)
    return Hit(
        t=best_t, point=point, normal=normal, material_id=material_id,
        geom_index=geom_index, outside=outside, miss=miss,
    )
