"""Small vectorized linear-algebra helpers shared by the ray ops.

Port of the JAX package's ``ops/linalg.py``. Points/directions are
``[..., 3]`` float32 tensors; mat4s are ``[..., 4, 4]``. The matrix-vector
products are written out as three products and two adds per row, in index
order, so every rounding is explicit.
"""

from __future__ import annotations

import torch


def dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def norm(v: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(dot(v, v))


def normalize(v: torch.Tensor, eps: float = 0.0) -> torch.Tensor:
    n = norm(v)[..., None]
    if eps:
        n = torch.clamp_min(n, eps)
    return v / n


def cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.stack(
        [
            a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
            a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
            a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0],
        ],
        dim=-1,
    )


def transform_vector(m: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """``vec3(M @ [v, 0])`` (the reference's multiplyMV with w=0).
    Broadcasts over leading dims."""
    return torch.stack(
        [
            m[..., i, 0] * v[..., 0] + m[..., i, 1] * v[..., 1] + m[..., i, 2] * v[..., 2]
            for i in range(3)
        ],
        dim=-1,
    )


def transform_point(m: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """``vec3(M @ [p, 1])`` (multiplyMV with w=1, `src/intersections.h:34-36`)."""
    return transform_vector(m, p) + m[..., :3, 3]


def reflect(incident: torch.Tensor, normal: torch.Tensor) -> torch.Tensor:
    """Mirror reflection (`src/pathtrace.cu:240-242`)."""
    return incident - 2.0 * dot(incident, normal)[..., None] * normal
