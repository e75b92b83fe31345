"""Image-based environment lighting (equirectangular HDR) with importance
sampling.

Port of the JAX package's ``ops/envmap.py``: the map and its Walker/Vose
alias table, the direction ↔ (u, v) convention, bilinear radiance and per-texel
pdf lookups, the alias-table sampler, and the sun/sky split of the
megakernel's ``env_mode='split'`` (delta suns + an SH-9 residual sky).

- Texel weights use the texel's exact solid angle (the cosθ₀ − cosθ₁ band
  integral) times a 3×3-tent-blurred luminance with a floor of 1e-3 of its
  mean, so the sampler's E[L/pdf] equals the map's Riemann sum.
- The tables are built on the host in float64, exactly as the JAX package
  builds them, and land on the map's device as float32 / int32 tensors.
- Radiance lookups are bilinear (wrap in azimuth, clamp at the poles); the
  pdf is piecewise-constant per texel.

Direction convention: ``v = θ/π`` with ``θ = acos(d.y)`` (image row 0 =
straight up), ``u = 0.5 + atan2(d.x, −d.z) / 2π`` (image center column =
the −Z horizon the reference camera faces).
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Callable

import numpy as np
import torch

from ..native import runtime

_TWO_PI = 6.283185307179586
_PI = 3.14159265358979323846


@dataclasses.dataclass
class EnvMap:
    """Environment map + sampling tables, tensors on one device."""

    img: torch.Tensor  # (H, W, 3) f32 linear radiance
    alias_prob: torch.Tensor  # (H*W,) f32 stay-probability per cell
    alias_idx: torch.Tensor  # (H*W,) i32 alias partner per cell
    pdf: torch.Tensor  # (H, W) f32 solid-angle pdf of each texel
    strength: torch.Tensor  # () f32 radiance multiplier

    @property
    def shape(self):
        return tuple(self.img.shape[:2])

    @property
    def device(self) -> torch.device:
        return self.img.device


def texel_distribution(image: np.ndarray):
    """The sampling distribution of an [H, W, 3] linear radiance array:
    ``(p, pdf)``, the float64 probability of each texel, flattened row-major
    (sums to 1), and the [H, W] float64 solid-angle pdf of each texel."""
    img = np.asarray(image, np.float32)
    if img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"envmap image must be [H, W, 3], got {img.shape}")
    h, w = img.shape[:2]
    lum = 0.2126 * img[..., 0] + 0.7152 * img[..., 1] + 0.0722 * img[..., 2]

    # blur the sampling luminance with the 3×3 tent of the bilinear lookup's
    # footprint (wrap in azimuth, clamp at the poles): a bright texel's
    # bilinear smear then has a pdf to match, which keeps MIS unbiased
    def tent(a, axis, wrap):
        lo = np.roll(a, 1, axis) if wrap else np.concatenate([a[:1], a[:-1]], axis=0)
        hi = np.roll(a, -1, axis) if wrap else np.concatenate([a[1:], a[-1:]], axis=0)
        return 0.25 * lo + 0.5 * a + 0.25 * hi

    lum = tent(tent(lum, 0, wrap=False), 1, wrap=True)
    lum = np.maximum(lum, 1e-3 * max(float(lum.mean()), 1e-12))
    # exact per-row texel solid angle: Δφ · ∫ sinθ dθ over the row's band
    theta_edges = np.linspace(0.0, _PI, h + 1)
    band = np.cos(theta_edges[:-1]) - np.cos(theta_edges[1:])
    omega = (band * (_TWO_PI / w)).astype(np.float64)
    weights = lum.astype(np.float64) * omega[:, None]
    total = weights.sum()
    if not np.isfinite(total) or total <= 0.0:
        raise ValueError("envmap has no positive finite luminance")
    return weights.ravel() / total, (weights / total) / omega[:, None]


def build_envmap(image: np.ndarray, strength: float = 1.0, device="cpu") -> EnvMap:
    """Table build on the host from an [H, W, 3] linear radiance array: the
    texel distribution (:func:`texel_distribution`) and its alias table,
    built by the native runtime (``native.runtime.build_alias``; the Python
    loop :func:`_build_alias` is its plain version)."""
    img = np.asarray(image, np.float32)
    p, pdf = texel_distribution(img)
    prob, alias = runtime.build_alias(p)
    device = torch.device(device)
    return EnvMap(
        img=torch.as_tensor(img, device=device),
        alias_prob=torch.as_tensor(prob.astype(np.float32), device=device),
        alias_idx=torch.as_tensor(alias.astype(np.int32), device=device),
        pdf=torch.as_tensor(pdf.astype(np.float32), device=device),
        strength=torch.tensor(float(strength), dtype=torch.float32, device=device),
    )


def _build_alias(p: np.ndarray):
    """Vose's O(n) alias-table construction for the discrete texel
    distribution ``p`` (sums to 1), with the JAX package's stack order, so
    the tables are equal: the plain version of the native build
    (``native.runtime.build_alias``), which keeps the same order. A Python
    loop: seconds for a 2048×4096 map's 8.4M texels."""
    n = p.size
    scaled = p.astype(np.float64) * n
    prob = np.ones(n, np.float64)
    alias = np.arange(n, dtype=np.int64)
    small = np.flatnonzero(scaled < 1.0)
    large = np.flatnonzero(scaled >= 1.0)
    stack = np.concatenate([small, large, np.zeros(1, np.int64)])
    n_small, n_large = small.size, large.size
    # small grows down from n_small, large grows down from the end
    small_top, large_top = n_small, n_small + n_large
    while small_top > 0 and large_top > n_small:
        small_top -= 1
        s = stack[small_top]
        large_top -= 1
        big = stack[large_top]
        prob[s] = scaled[s]
        alias[s] = big
        rest = (scaled[big] + scaled[s]) - 1.0
        scaled[big] = rest
        if rest < 1.0:
            stack[small_top] = big
            small_top += 1
        else:
            stack[large_top] = big
            large_top += 1
    # leftovers are 1.0 up to rounding
    return prob, alias


@dataclasses.dataclass
class EnvNEEInputs:
    """Per-bounce inputs for environment importance sampling in
    ``ops.shade.shade_step`` (the infinite-light twin of
    ``lights.NEEInputs``)."""

    env: EnvMap
    shadow_isect: Callable  # (origins, dirs) -> Hit; visibility = .miss
    uniforms: torch.Tensor  # [N, 2] (rng.env_uniforms)
    # [N, 2] alias-cell words (rng.env_cell_words), for maps past ENV_CELL_SPLIT
    cell_words: torch.Tensor | None = None


def dir_to_uv(d: torch.Tensor):
    """[..., 3] unit directions → (u, v) in [0, 1)²."""
    u = 0.5 + torch.atan2(d[..., 0], -d[..., 2]) * (1.0 / _TWO_PI)
    v = torch.acos(torch.clamp(d[..., 1], -1.0, 1.0)) * (1.0 / _PI)
    return u, v


def uv_to_dir(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """(u, v) → [..., 3] unit directions (the inverse of :func:`dir_to_uv`)."""
    theta = v * _PI
    phi = (u - 0.5) * _TWO_PI
    st = torch.sin(theta)
    return torch.stack([st * torch.sin(phi), torch.cos(theta), -st * torch.cos(phi)], dim=-1)


def env_radiance(env: EnvMap, d: torch.Tensor) -> torch.Tensor:
    """Bilinear radiance lookup, [..., 3]·strength. Wraps in azimuth,
    clamps at the poles."""
    h, w = env.shape
    u, v = dir_to_uv(d)
    fx = u * w - 0.5
    fy = v * h - 0.5
    x0 = torch.floor(fx)
    y0 = torch.floor(fy)
    tx = (fx - x0)[..., None]
    ty = (fy - y0)[..., None]
    x0i = torch.remainder(x0.to(torch.int64), w)
    x1i = torch.remainder(x0i + 1, w)
    y0i = torch.clamp(y0.to(torch.int64), 0, h - 1)
    y1i = torch.clamp(y0i + 1, 0, h - 1)
    flat = env.img.reshape(h * w, 3)
    c00 = flat[y0i * w + x0i]
    c01 = flat[y0i * w + x1i]
    c10 = flat[y1i * w + x0i]
    c11 = flat[y1i * w + x1i]
    top = c00 + (c01 - c00) * tx
    bot = c10 + (c11 - c10) * tx
    return (top + (bot - top) * ty) * env.strength


def env_pdf(env: EnvMap, d: torch.Tensor) -> torch.Tensor:
    """Solid-angle pdf with which :func:`sample_env` generates ``d``
    (piecewise-constant per texel): the BRDF side of the MIS pair."""
    h, w = env.shape
    u, v = dir_to_uv(d)
    x = torch.clamp((u * w).to(torch.int64), 0, w - 1)
    y = torch.clamp((v * h).to(torch.int64), 0, h - 1)
    return env.pdf.reshape(-1)[y * w + x]


# Past this many texels the alias cell comes from words of its own
# (:func:`alias_cell`); at and below it the draw is the JAX package's.
ENV_CELL_SPLIT = 1 << 15


def needs_cell_words(env: EnvMap) -> bool:
    """Whether :func:`sample_env` draws ``env``'s alias cells from words of
    their own (a map past :data:`ENV_CELL_SPLIT` texels)."""
    h, w = env.shape
    return h * w > ENV_CELL_SPLIT


def alias_cell(words: torch.Tensor, n_tex: int) -> torch.Tensor:
    """``floor(W·n_tex / 2^64)`` of the 64-bit word ``W`` whose high and low
    uint32 halves are ``words[..., 0]`` and ``words[..., 1]`` (int64): a cell
    in ``[0, n_tex)``, each cell's share of the 2^64 words within
    ``n_tex / 2^64`` of ``1 / n_tex``. Every product stays below 2^62 for
    ``n_tex < 2^30``."""
    hi, lo = words[..., 0], words[..., 1]
    return (hi * n_tex + ((lo * n_tex) >> 32)) >> 32


def sample_env(env: EnvMap, u1: torch.Tensor, u2: torch.Tensor,
               cell_words: torch.Tensor | None = None):
    """Draw environment directions ∝ luminance·solid-angle.

    Returns ``(directions [..., 3], radiance [..., 3] (nearest texel,
    ×strength), pdf [...])``. On a map of at most :data:`ENV_CELL_SPLIT`
    texels the draw is the JAX package's: the alias cell comes from the
    integer part of ``u1·n``, stay-or-alias from its fraction, whose
    leftover is reused as the within-texel azimuth offset. A 23-bit ``u1``
    leaves that fraction 23 − log2(n) bits, none at 2^23 texels, so past
    the split the cell comes from ``cell_words`` ([..., 2] uint32 words in
    int64, :func:`alias_cell`; ``rng.env_cell_words``) and all of ``u1`` is
    the fraction (a deliberate deviation from the JAX package, whose draw
    is biased there). The polar offset ``u2`` is uniform in solid angle
    within the texel's band, so the generation density is exactly the
    piecewise-constant table pdf."""
    h, w = env.shape
    n_tex = h * w
    if n_tex > ENV_CELL_SPLIT:
        if cell_words is None:
            raise ValueError(f"sample_env: a map of {n_tex} texels (past {ENV_CELL_SPLIT}) "
                             "draws its alias cells from cell_words (rng.env_cell_words)")
        cell = alias_cell(cell_words, n_tex)
        f = torch.clamp(u1, 0.0, 1.0 - 1e-7)
    else:
        scaled = u1 * n_tex
        cell = torch.clamp(scaled.to(torch.int64), 0, n_tex - 1)
        f = torch.clamp(scaled - cell.to(torch.float32), 0.0, 1.0 - 1e-7)
    p_stay = env.alias_prob[cell]
    take_alias = f >= p_stay
    idx = torch.where(take_alias, env.alias_idx[cell].to(torch.int64), cell)
    xfrac = torch.where(
        take_alias,
        (f - p_stay) / torch.clamp_min(1.0 - p_stay, 1e-12),
        f / torch.clamp_min(p_stay, 1e-12),
    )
    xfrac = torch.clamp(xfrac, 0.0, 1.0 - 1e-6)
    y = idx // w
    x = idx - y * w
    u = (x.to(torch.float32) + xfrac) / w
    yf = y.to(torch.float32)
    cos0 = torch.cos(yf * (_PI / h))
    cos1 = torch.cos((yf + 1.0) * (_PI / h))
    cos_t = cos0 + u2 * (cos1 - cos0)
    theta = torch.acos(torch.clamp(cos_t, -1.0, 1.0))
    phi = (u - 0.5) * _TWO_PI
    st = torch.sin(theta)
    d = torch.stack([st * torch.sin(phi), cos_t, -st * torch.cos(phi)], dim=-1)
    radiance = env.img.reshape(n_tex, 3)[idx] * env.strength
    pdf = env.pdf.reshape(-1)[idx]
    return d, radiance, pdf


# ────────────────────── sun/sky split (megakernel mode) ──────────────────────
#
# env_mode='split' decomposes the map: the top-K texels holding ≥ thresh×
# the mean luminance become delta directional lights (direction = texel
# center, irradiance E = L·Δω) sampled with one shadow ray each at every
# diffuse vertex; the residual map projects onto 9 real spherical harmonics
# per channel for the sky seen by indirect rays; the camera-visible
# background composites from the exact map outside the kernel.

_SH_C = (
    0.2820947917738781,  # Y00
    0.4886025119029199,  # Y1-1, Y10, Y11 (· y, z, x)
    1.0925484305920792,  # Y2-2, Y2-1, Y21 (· xy, yz, xz)
    0.31539156525252005,  # Y20 (· 3z²−1)
    0.5462742152960396,  # Y22 (· x²−y²)
)


def sh9_basis(d: torch.Tensor):
    """The 9 real SH basis values for unit direction(s) d[..., 3]."""
    x, y, z = d[..., 0], d[..., 1], d[..., 2]
    c = _SH_C
    return [
        torch.full_like(x, c[0]),
        c[1] * y, c[1] * z, c[1] * x,
        c[2] * x * y, c[2] * y * z,
        c[3] * (3.0 * z * z - 1.0),
        c[2] * x * z,
        c[4] * (x * x - y * y),
    ]


def split_envmap(img: np.ndarray, max_suns: int = 8, thresh: float = 32.0):
    """Host-side sun/sky decomposition of an [H, W, 3] map, in float64.

    Returns ``(suns, sh)``: ``suns`` a tuple of ``(dx, dy, dz, Er, Eg, Eb)``
    float tuples (delta-light irradiance E = L·Δω), ``sh`` a 3-tuple of
    9-coefficient tuples (per-channel projection of the residual). Warns
    when more than ``max_suns`` texels pass ``thresh``: the rest stay in
    the residual, which the SH-9 fit represents poorly."""
    img = np.asarray(img, np.float64)
    h, w = img.shape[:2]
    lum = 0.2126 * img[..., 0] + 0.7152 * img[..., 1] + 0.0722 * img[..., 2]
    theta_edges = np.linspace(0.0, _PI, h + 1)
    band = np.cos(theta_edges[:-1]) - np.cos(theta_edges[1:])
    omega = band[:, None] * (2 * np.pi / w)  # (H, 1) per-texel solid angle

    residual = img.copy()
    suns = []
    mean_lum = max(float(lum.mean()), 1e-12)
    candidates = np.argwhere(lum > thresh * mean_lum)
    if len(candidates) > max_suns:
        warnings.warn(
            f"split_envmap: {len(candidates)} texels exceed "
            f"{thresh}x mean luminance but only max_suns={max_suns} become "
            "delta lights; the rest fold into the SH-9 residual, degrading "
            "split-mode quality. Raise RenderConfig.env_split_suns or use "
            "env_mode='exact'.",
            stacklevel=2,
        )
    if len(candidates):
        energies = lum[candidates[:, 0], candidates[:, 1]] * omega[candidates[:, 0], 0]
        order = np.argsort(energies)[::-1][:max_suns]
        for yi, xi in candidates[order]:
            u = (xi + 0.5) / w
            v = (yi + 0.5) / h
            th = v * np.pi
            ph = (u - 0.5) * 2 * np.pi
            d = (np.sin(th) * np.sin(ph), np.cos(th), -np.sin(th) * np.cos(ph))
            e = img[yi, xi] * omega[yi, 0]
            suns.append(
                (float(d[0]), float(d[1]), float(d[2]),
                 float(e[0]), float(e[1]), float(e[2]))
            )
            residual[yi, xi] = 0.0

    # projection of the residual at texel centers: c_i = Σ L·Y_i·Δω
    ys = (np.arange(h) + 0.5) / h
    xs = (np.arange(w) + 0.5) / w
    th = ys * np.pi
    ph = (xs - 0.5) * 2 * np.pi
    st, ct = np.sin(th)[:, None], np.cos(th)[:, None]
    x = st * np.sin(ph)[None, :]
    y = np.broadcast_to(ct, (h, w))
    z = -st * np.cos(ph)[None, :]
    c = _SH_C
    basis = np.stack(
        [
            np.full((h, w), c[0]),
            c[1] * y, c[1] * z, c[1] * x,
            c[2] * x * y, c[2] * y * z,
            c[3] * (3.0 * z * z - 1.0),
            c[2] * x * z,
            c[4] * (x * x - y * y),
        ]
    )  # (9, H, W)
    weighted = residual * omega[..., None]  # (H, W, 3)
    coeffs = np.einsum("bhw,hwc->cb", basis, weighted)  # (3, 9)
    sh = tuple(tuple(float(v) for v in row) for row in coeffs)
    return tuple(suns), sh


def sh9_eval(sh, x, y, z):
    """The per-channel SH-9 fit at unit direction components: the shared
    basis, then 9 multiply-adds per channel, in the JAX kernel's order (the
    first term ``sh[c][0]·Y00`` is a product of two floats, rounded once
    where it meets the float32 tensors)."""
    c = _SH_C
    b = (
        c[0],
        c[1] * y, c[1] * z, c[1] * x,
        c[2] * x * y, c[2] * y * z,
        c[3] * (3.0 * z * z - 1.0),
        c[2] * x * z,
        c[4] * (x * x - y * y),
    )
    out = []
    for ch in sh:
        acc = ch[0] * b[0]
        for i in range(1, 9):
            acc = acc + ch[i] * b[i]
        out.append(acc)
    return out
