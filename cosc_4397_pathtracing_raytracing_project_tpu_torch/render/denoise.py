"""Feature-guided denoiser: AOV pass + edge-avoiding À-Trous wavelet filter.

Port of the JAX package's ``render/denoise.py`` (an extension: the reference
ships raw accumulator means only, `finalGather`, `src/pathtrace.cu:439-444`).
Plain functions on tensors on the scene's or the image's device; the JAX
package's XLA code reaches no Pallas kernel, so neither does this.

- The AOV pass traces ONE center primary ray per pixel (:func:`render_aovs`)
  and records first-hit albedo, shading normal and depth, through the
  readable brute-force intersector (``ops.intersect.intersect_scene``),
  one chunk of pixels at a time so the ``[chunk, primitives]`` candidate
  blocks stay bounded (JAX maps over padded chunks; here the last chunk is
  short).
- The noisy radiance is DEMODULATED by albedo before filtering, filtered in
  irradiance space, then re-modulated.
- Each À-Trous level doubles the tap spacing and filters with the 5×5
  B3-spline kernel, weighted per tap by normal alignment, relative depth,
  albedo and irradiance proximity (its sigma halves per level, Dammertz
  §4.2); sky/miss pixels form their own weight class. Taps read the image
  edge-clamped: each shifted view is a gather with the clamped row and
  column indices, the values of JAX's edge padding. The filter is ~125 taps
  of ~30 elementwise operations each, with no host sync.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..ops import linalg
from ..ops.intersect import intersect_scene, take_rows
from ..scene.structs import Scene

_MISS_DEPTH = 0.0  # miss pixels: depth 0 + synthetic normal, own weight class
_MISS_NORMAL = (0.0, 0.0, 1.0)


class Aovs(NamedTuple):
    """Per-pixel first-hit feature buffers, [H, W, ...] in image layout
    (row y=0 first, matching ``Renderer.linear_image``)."""

    albedo: torch.Tensor  # [H, W, 3] material diffuse color (1 on miss)
    normal: torch.Tensor  # [H, W, 3] unit shading normal ((0,0,1) on miss)
    depth: torch.Tensor  # [H, W] world-space hit distance (0 on miss)
    miss: torch.Tensor  # [H, W] bool


def _center_rays(camera, idx: torch.Tensor):
    """Center primary ray per pixel index (reference raygen at the pixel
    corner, `src/pathtrace.cu:270-286`, no jitter: AOVs must be
    noise-free). Elementwise operations only, so every device rounds them
    alike."""
    w, h = camera.resolution
    px = (idx % w).to(torch.float32)
    py = (idx // w).to(torch.float32)
    sx = camera.pixel_length[0] * (px - 0.5 * w)
    sy = camera.pixel_length[1] * (py - 0.5 * h)
    d = (
        camera.view[None, :]
        - camera.right[None, :] * sx[:, None]
        - camera.up[None, :] * sy[:, None]
    )
    # the norm as three products summed in order, not a reduction, whose
    # order may differ between devices
    d = linalg.normalize(d)
    o = camera.position[None, :].expand(d.shape)
    return o, d


def _aov_pass(scene: Scene, chunk: int) -> Aovs:
    cam = scene.camera
    w, h = cam.resolution
    n = cam.pixel_count
    dev = scene.device
    albedo = torch.empty((n, 3), dtype=torch.float32, device=dev)
    normal = torch.empty((n, 3), dtype=torch.float32, device=dev)
    depth = torch.empty((n,), dtype=torch.float32, device=dev)
    miss = torch.empty((n,), dtype=torch.bool, device=dev)
    miss_normal = torch.tensor(_MISS_NORMAL, dtype=torch.float32, device=dev)
    for start in range(0, n, chunk):
        stop = min(start + chunk, n)
        o, d = _center_rays(cam, torch.arange(start, stop, dtype=torch.int64, device=dev))
        hit = intersect_scene(scene, o, d)
        albedo[start:stop] = torch.where(
            hit.miss[:, None], 1.0, take_rows(scene.materials.color, hit.material_id)
        )
        normal[start:stop] = torch.where(hit.miss[:, None], miss_normal, hit.normal)
        depth[start:stop] = torch.where(hit.miss, _MISS_DEPTH, hit.t)
        miss[start:stop] = hit.miss
    return Aovs(
        albedo=albedo.reshape(h, w, 3),
        normal=normal.reshape(h, w, 3),
        depth=depth.reshape(h, w),
        miss=miss.reshape(h, w),
    )


def render_aovs(scene: Scene, chunk: int = 1 << 16) -> Aovs:
    """Trace the per-pixel feature buffers (one center primary ray each), on
    the scene's device.

    ``chunk`` bounds the pixels×primitives candidate blocks of the readable
    intersector; on triangle scenes it is additionally capped so a
    ``[chunk, T]`` Möller–Trumbore block stays ≤ ~0.5 GB (the JAX cap). The
    pass runs once per camera pose, not per sample."""
    t = scene.num_triangles
    if t > 0:
        chunk = min(chunk, max(256, (1 << 27) // t))
    return _aov_pass(scene, min(chunk, scene.camera.pixel_count))


# ── the filter ─────────────────────────────────────────────────────────────

# 1-D B3-spline mask; the 5×5 kernel is its outer product (Dammertz §3).
_B3 = (1.0 / 16.0, 1.0 / 4.0, 3.0 / 8.0, 1.0 / 4.0, 1.0 / 16.0)


def _luma(rgb: torch.Tensor) -> torch.Tensor:
    return 0.2126 * rgb[..., 0] + 0.7152 * rgb[..., 1] + 0.0722 * rgb[..., 2]


def _despeckle(irr: torch.Tensor) -> torch.Tensor:
    """Firefly clamp: limit each pixel to its brightest 8-neighborhood
    value (per channel, edge-clamped). An isolated outlier drops to its
    surroundings; a bright region ≥ 2 px wide keeps bright neighbors. Needed
    because the À-Trous color weight protects outliers."""
    h, w, _ = irr.shape
    rows = torch.arange(h, device=irr.device)
    cols = torch.arange(w, device=irr.device)
    neigh = None
    for dy in (-1, 0, 1):
        r = torch.clamp(rows + dy, 0, h - 1)
        for dx in (-1, 0, 1):
            if dy == 0 and dx == 0:
                continue
            s = irr[r][:, torch.clamp(cols + dx, 0, w - 1)]
            neigh = s if neigh is None else torch.maximum(neigh, s)
    return torch.minimum(irr, neigh)


def atrous_denoise(
    color: torch.Tensor,
    aovs: Aovs,
    *,
    levels: int = 5,
    sigma_color: float = 0.30,
    sigma_normal: float = 64.0,
    sigma_depth: float = 0.02,
    sigma_albedo: float = 0.15,
    defirefly: bool = True,
) -> torch.Tensor:
    """Edge-avoiding À-Trous filter over a linear [H, W, 3] radiance image,
    on the image's device (the AOVs' must be the same).

    sigma_color: irradiance-luminance tolerance at level 0 (halves per
    level); sigma_normal: cosine sharpness exponent; sigma_depth: relative
    depth tolerance (scaled by the center depth); sigma_albedo: rgb albedo
    tolerance. All weights are multiplied, the center tap has weight 1, and
    each output pixel renormalizes: a constant region is reproduced exactly
    and every output is a convex combination of inputs."""
    color = torch.as_tensor(color, dtype=torch.float32)
    dev = color.device
    alb = aovs.albedo.to(dev, torch.float32)
    nrm = aovs.normal.to(dev, torch.float32)
    dep = aovs.depth.to(dev, torch.float32)
    missf = aovs.miss.to(dev, torch.float32)

    # Demodulate: the AOV carries the texture detail noise-free; filtering
    # irradiance keeps it sharp, and the same divisor multiplies back.
    alb_safe = torch.clamp_min(alb, 1e-3)
    irr = color / alb_safe
    if defirefly:
        irr = _despeckle(irr)

    h, w, _ = color.shape
    f32 = np.float32
    # the JAX code's float32 constants, and 0-d tensors on the image's
    # device as divisors (a true quotient on every device)
    inv_sd = float(f32(1.0) / f32(sigma_depth))
    inv_sa2 = float(f32(1.0) / f32(sigma_albedo) ** 2)
    sigma_n = float(f32(sigma_normal))
    rows = torch.arange(h, device=dev)
    cols = torch.arange(w, device=dev)

    out = irr
    for level in range(levels):
        step = 1 << level
        sc2 = torch.tensor(f32(sigma_color / (1 << level)) ** 2, device=dev)
        lum_c = _luma(out)
        acc = torch.zeros_like(out)
        wacc = torch.zeros((h, w), dtype=torch.float32, device=dev)
        for iy, hy in enumerate(_B3):
            r = torch.clamp(rows + (iy - 2) * step, 0, h - 1)
            for ix, hx in enumerate(_B3):
                c = torch.clamp(cols + (ix - 2) * step, 0, w - 1)

                def shift(img):
                    """Edge-clamped shifted view img[y + dy*step, x + dx*step]."""
                    return img[r][:, c]

                if iy == 2 and ix == 2:
                    q_irr = out
                    wgt = torch.full((h, w), hy * hx, dtype=torch.float32, device=dev)
                else:
                    q_irr = shift(out)
                    q_n = shift(nrm)
                    q_d = shift(dep)
                    q_a = shift(alb)
                    q_m = shift(missf)
                    w_n = torch.clamp_min(torch.sum(nrm * q_n, dim=-1), 0.0) ** sigma_n
                    # relative depth: tolerance scales with the center
                    # depth; the +1 floor keeps near-plane pixels sane
                    w_z = torch.exp(-torch.abs(dep - q_d) * inv_sd / torch.clamp_min(dep, 1.0))
                    w_a = torch.exp(-torch.sum((alb - q_a) ** 2, dim=-1) * inv_sa2)
                    w_c = torch.exp(-((lum_c - _luma(q_irr)) ** 2) / sc2)
                    same_class = 1.0 - torch.abs(missf - q_m)
                    wgt = (hy * hx) * w_n * w_z * w_a * w_c * same_class
                acc = acc + q_irr * wgt[..., None]
                wacc = wacc + wgt
        out = acc / wacc[..., None]

    return out * alb_safe


def denoise_image(
    renderer,
    *,
    levels: int = 5,
    sigma_color: float = 0.30,
    sigma_normal: float = 64.0,
    sigma_depth: float = 0.02,
    sigma_albedo: float = 0.15,
) -> np.ndarray:
    """Denoised [H, W, 3] float32 linear image of a renderer's current
    accumulator (AOV pass + filter on the renderer's device). Takes any
    object with ``scene`` and ``linear_image()``: ``Renderer`` and
    ``AdaptiveRenderer``."""
    aovs = render_aovs(renderer.scene)
    img = torch.as_tensor(renderer.linear_image(), device=renderer.scene.device)
    return atrous_denoise(
        img,
        aovs,
        levels=levels,
        sigma_color=sigma_color,
        sigma_normal=sigma_normal,
        sigma_depth=sigma_depth,
        sigma_albedo=sigma_albedo,
    ).cpu().numpy()
