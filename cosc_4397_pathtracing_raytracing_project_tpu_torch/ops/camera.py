"""Pinhole camera ray generation (`src/pathtrace.cu:270-286`) and the thin
lens.

Port of the JAX package's ``ops/camera.py``: rays come as flat ``[N, 3]``
tensors (pixel index ``idx = x + y*width``) on the camera's device, with
optional sub-pixel jitter and an optional thin lens.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..scene.structs import Camera
from . import linalg


def generate_rays(
    camera: Camera,
    jitter: Optional[torch.Tensor] = None,
    pixel_offset: int = 0,
    num_pixels: Optional[int] = None,
    lens: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(origins [N,3], directions [N,3]) for pixels [pixel_offset,
    pixel_offset + N) in row-major order:
    ``dir = normalize(view - right*plx*(x - w/2) - up*ply*(y - h/2))``.
    ``jitter`` [N,2] are sub-pixel offsets in [0,1); ``lens`` [N,2]
    lens-disk uniforms for the thin lens (:func:`thin_lens`)."""
    w, h = camera.resolution
    n = num_pixels if num_pixels is not None else w * h
    dev = camera.position.device
    idx = pixel_offset + torch.arange(n, dtype=torch.int64, device=dev)
    x = (idx % w).to(torch.float32)
    y = (idx // w).to(torch.float32)
    if jitter is not None:
        x = x + jitter[:, 0]
        y = y + jitter[:, 1]
    sx = camera.pixel_length[0] * (x - 0.5 * w)
    sy = camera.pixel_length[1] * (y - 0.5 * h)
    directions = (
        camera.view[None, :]
        - camera.right[None, :] * sx[:, None]
        - camera.up[None, :] * sy[:, None]
    )
    directions = linalg.normalize(directions)
    origins = camera.position[None, :].expand(n, 3)
    if lens is not None:
        origins, directions = thin_lens(camera, origins, directions, lens)
    return origins, directions


def thin_lens(
    camera: Camera,
    origins: torch.Tensor,
    directions: torch.Tensor,
    lens: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Thin-lens transform of pinhole rays: each unit direction is traced
    to the focal plane (perpendicular to ``view`` at ``camera.focal``), the
    origin moves to a lens-disk sample of radius ``camera.aperture`` in the
    (right, up) plane, and the direction re-aims at the focal point."""
    ct = (
        directions[:, 0] * camera.view[0]
        + directions[:, 1] * camera.view[1]
        + directions[:, 2] * camera.view[2]
    )
    ft = camera.focal / torch.clamp_min(ct, 1e-6)
    focus = origins + directions * ft[:, None]
    r = camera.aperture * torch.sqrt(lens[:, 0])
    theta = (2.0 * torch.pi) * lens[:, 1]
    lx = r * torch.cos(theta)
    ly = r * torch.sin(theta)
    origins = (
        origins + camera.right[None, :] * lx[:, None] + camera.up[None, :] * ly[:, None]
    )
    return origins, linalg.normalize(focus - origins)
