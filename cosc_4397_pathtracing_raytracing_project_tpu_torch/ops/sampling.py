"""BRDF direction sampling (`src/pathtrace.cu:209-248,398-436`), vectorized.

Port of the JAX package's ``ops/sampling.py``. Every sampler takes
pre-drawn uniforms (``ops/rng.py``), so a shade step is a pure function of
its state and its uniforms.
"""

from __future__ import annotations

import torch

from . import linalg

_PI = 3.14159265358979323846


def local_coordinate_system(normal: torch.Tensor):
    """createLocalCoordinateSystem (`pathtrace.cu:216-223`), branchless:
    tangent = |n.x|>|n.y| ? normalize(n.z,0,-n.x) : normalize(0,-n.z,n.y);
    bitangent = cross(n, tangent)."""
    nx, ny, nz = normal[..., 0], normal[..., 1], normal[..., 2]
    zeros = torch.zeros_like(nx)
    t_a = torch.stack([nz, zeros, -nx], dim=-1)
    t_b = torch.stack([zeros, -nz, ny], dim=-1)
    use_a = (torch.abs(nx) > torch.abs(ny))[..., None]
    tangent = linalg.normalize(torch.where(use_a, t_a, t_b), eps=1e-20)
    bitangent = linalg.cross(normal, tangent)
    return tangent, bitangent


def cosine_weighted_hemisphere(u1: torch.Tensor, u2: torch.Tensor, normal: torch.Tensor):
    """sampleCosineWeightedHemisphere (`pathtrace.cu:225-238`): frame axes are
    (tangent, normal, bitangent) with theta = acos(sqrt(1-u1))."""
    tangent, bitangent = local_coordinate_system(normal)
    theta = torch.acos(torch.sqrt(torch.clamp_min(1.0 - u1, 0.0)))
    phi = 2.0 * _PI * u2
    sin_t = torch.sin(theta)
    x = sin_t * torch.cos(phi)
    y = torch.cos(theta)
    z = sin_t * torch.sin(phi)
    return linalg.normalize(
        tangent * x[..., None] + normal * y[..., None] + bitangent * z[..., None]
    )


def perturbed_specular(incident, normal, roughness, u_angle, u_azimuth):
    """Mirror reflection with cone perturbation (`pathtrace.cu:404-414`):
    angle = roughness * u * pi/2 around the reflected direction; at
    roughness 0 it is the pure mirror direction, so it applies everywhere."""
    reflect_dir = linalg.reflect(incident, normal)
    tangent, bitangent = local_coordinate_system(reflect_dir)
    angle = roughness * u_angle * _PI * 0.5
    phi = 2.0 * _PI * u_azimuth
    sin_a = torch.sin(angle)
    x = sin_a * torch.cos(phi)
    y = torch.cos(angle)
    z = sin_a * torch.sin(phi)
    return linalg.normalize(
        tangent * x[..., None] + reflect_dir * y[..., None] + bitangent * z[..., None]
    )


def sky_color(directions: torch.Tensor) -> torch.Tensor:
    """Gradient environment light (`pathtrace.cu:358-362`):
    lerp(white, (0.5,0.7,1.0), 0.5*(dir.y+1)) * 0.5."""
    t = 0.5 * (directions[..., 1] + 1.0)
    horizon = torch.ones(3, dtype=torch.float32, device=directions.device)
    zenith = torch.tensor([0.5, 0.7, 1.0], dtype=torch.float32, device=directions.device)
    sky = (1.0 - t)[..., None] * horizon + t[..., None] * zenith
    return sky * 0.5


def schlick_fresnel(cos_theta, n1, n2):
    """Schlick's approximation (`pathtrace.cu:244-248`; defined but unused in
    the reference's shading, used by the refraction extension)."""
    r0 = ((n1 - n2) / (n1 + n2)) ** 2
    return r0 + (1.0 - r0) * (1.0 - cos_theta) ** 5
