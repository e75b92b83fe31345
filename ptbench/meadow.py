"""The procedural sky of the environment-map configurations, generated at
any size in NumPy: a sky gradient from a white horizon to a blue zenith, a
small sun disk at 35° elevation about 4000× the sky's radiance, a haze band
at the horizon and a dim brown ground. At height 128 it is the repository's
``scenes/meadow.hdr`` (as stored there, in RGBE).

Each texel's direction is computed in float32 from its centre's (u, v):
``θ = vπ``, ``φ = (u − ½)2π``, ``d = (sinθ sinφ, cosθ, −sinθ cosφ)``."""

from __future__ import annotations

import numpy as np

_SUN_RGB = np.array([3800.0, 3400.0, 2800.0], np.float32)


def meadow(height: int) -> np.ndarray:
    """[height, 2·height, 3] float32 linear radiance."""
    h, w = int(height), 2 * int(height)
    v = ((np.arange(h) + 0.5) / h).astype(np.float32)[:, None]
    u = ((np.arange(w) + 0.5) / w).astype(np.float32)[None, :]
    theta = v * np.float32(np.pi)
    phi = (u - np.float32(0.5)) * np.float32(2.0 * np.pi)
    st = np.sin(theta)
    dx = st * np.sin(phi)
    dy = np.broadcast_to(np.cos(theta), (h, w))
    dz = -st * np.cos(phi)
    t = np.clip(dy, 0.0, 1.0)[..., None]
    sky = (1.0 - t) * np.array([0.9, 0.9, 0.95]) + t * np.array([0.25, 0.45, 0.95])
    g = np.clip(-dy, 0.0, 1.0)[..., None]
    ground = (1.0 - g) * np.array([0.35, 0.3, 0.25]) + g * np.array([0.12, 0.09, 0.06])
    img = np.where(dy[..., None] >= 0, sky, ground).astype(np.float32)
    img += np.exp(-np.abs(dy) * 12.0)[..., None] * np.array([0.25, 0.22, 0.18], np.float32)
    sun = np.array([np.sin(0.6), np.sin(np.deg2rad(35)), -np.cos(0.6)])
    sun /= np.linalg.norm(sun)
    cosang = dx * sun[0] + dy * sun[1] + dz * sun[2]
    img[cosang > np.cos(np.deg2rad(1.8))] = _SUN_RGB
    return img
