"""Host-side transform math (NumPy, float32).

Replicates the TRS matrix construction of the reference
(`src/utilities.cpp:65-72`): ``M = T · Rx · Ry · Rz · S`` with rotation
angles in degrees, and the derived inverse / inverse-transpose matrices
cached per geometry (`src/scene.cpp:82-85`).

All matrices are row-major NumPy arrays acting on column vectors
(``world = M @ [x, y, z, 1]``) — numerically identical to the reference's
GLM column-major matrices applied as ``M * v``.
"""

from __future__ import annotations

import numpy as np

_DEG2RAD = np.pi / 180.0


def translation_matrix(t) -> np.ndarray:
    m = np.eye(4, dtype=np.float32)
    m[:3, 3] = np.asarray(t, dtype=np.float32)
    return m


def scale_matrix(s) -> np.ndarray:
    m = np.eye(4, dtype=np.float32)
    m[0, 0], m[1, 1], m[2, 2] = np.asarray(s, dtype=np.float32)
    return m


def rotation_matrix_axis(angle_rad: float, axis: int) -> np.ndarray:
    """Rotation about a principal axis (0=x, 1=y, 2=z), right-handed."""
    c = np.float32(np.cos(angle_rad))
    s = np.float32(np.sin(angle_rad))
    m = np.eye(4, dtype=np.float32)
    if axis == 0:
        m[1, 1], m[1, 2], m[2, 1], m[2, 2] = c, -s, s, c
    elif axis == 1:
        m[0, 0], m[0, 2], m[2, 0], m[2, 2] = c, s, -s, c
    else:
        m[0, 0], m[0, 1], m[1, 0], m[1, 1] = c, -s, s, c
    return m


def build_transformation_matrix(translation, rotation_deg, scale) -> np.ndarray:
    """``T · Rx · Ry · Rz · S`` with degree angles (`utilities.cpp:65-72`)."""
    rot = np.asarray(rotation_deg, dtype=np.float64) * _DEG2RAD
    m = translation_matrix(translation)
    m = m @ rotation_matrix_axis(rot[0], 0)
    m = m @ rotation_matrix_axis(rot[1], 1)
    m = m @ rotation_matrix_axis(rot[2], 2)
    m = m @ scale_matrix(scale)
    return m.astype(np.float32)


def geom_matrices(translation, rotation_deg, scale):
    """Return (transform, inverse, inverse_transpose) as float32 mat4s.

    Mirrors `src/scene.cpp:82-85` (glm::inverse / glm::inverseTranspose).
    """
    m = build_transformation_matrix(translation, rotation_deg, scale)
    inv = np.linalg.inv(m.astype(np.float64)).astype(np.float32)
    inv_t = inv.T.copy()
    return m, inv, inv_t


def unit_cube_world_aabb(transform: np.ndarray):
    """World AABB of the canonical [-0.5, 0.5]^3 cube under `transform`.

    Matches the reference BVH bound computation (`src/pathtrace.cu:34-50`),
    which uses the same 8-corner bound for spheres as well (the unit sphere
    of radius 0.5 inscribes the unit cube, so this is a valid, if loose,
    bound for both primitive types).
    """
    corners = np.array(
        [
            [-0.5, -0.5, -0.5],
            [+0.5, -0.5, -0.5],
            [-0.5, +0.5, -0.5],
            [+0.5, +0.5, -0.5],
            [-0.5, -0.5, +0.5],
            [+0.5, -0.5, +0.5],
            [-0.5, +0.5, +0.5],
            [+0.5, +0.5, +0.5],
        ],
        dtype=np.float32,
    )
    world = corners @ transform[:3, :3].T + transform[:3, 3]
    return world.min(axis=0), world.max(axis=0)
