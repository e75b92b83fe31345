"""The environment map as the plain reference builds and samples it: the
texel distribution (a 3×3-tent-blurred luminance with a floor, times each
texel's exact solid angle) and its Walker/Vose alias table in float64, the
alias draw of a direction with its pdf, and the bilinear radiance lookup.

Direction convention: ``v = θ/π`` with ``θ = acos(d.y)`` (row 0 straight
up), ``u = 0.5 + atan2(d.x, −d.z) / 2π``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import rng

_TWO_PI = 6.283185307179586
_PI = 3.14159265358979323846
# past this many texels the alias cell comes from 64-bit words of its own
ENV_CELL_SPLIT = 1 << 15


@dataclasses.dataclass
class RefEnv:
    img: torch.Tensor  # (H, W, 3) f32
    alias_prob: torch.Tensor  # (H·W,) f32
    alias_idx: torch.Tensor  # (H·W,) int64
    pdf: torch.Tensor  # (H, W) f32 solid-angle pdf of each texel
    strength: torch.Tensor  # () f32

    @property
    def shape(self):
        return tuple(self.img.shape[:2])


def texel_distribution(image: np.ndarray):
    """(probability of each texel, row-major, float64; [H, W] solid-angle pdf)."""
    img = np.asarray(image, np.float32)
    h, w = img.shape[:2]
    lum = 0.2126 * img[..., 0] + 0.7152 * img[..., 1] + 0.0722 * img[..., 2]

    def tent(a, axis, wrap):
        lo = np.roll(a, 1, axis) if wrap else np.concatenate([a[:1], a[:-1]], axis=0)
        hi = np.roll(a, -1, axis) if wrap else np.concatenate([a[1:], a[-1:]], axis=0)
        return 0.25 * lo + 0.5 * a + 0.25 * hi

    lum = tent(tent(lum, 0, wrap=False), 1, wrap=True)
    lum = np.maximum(lum, 1e-3 * max(float(lum.mean()), 1e-12))
    theta_edges = np.linspace(0.0, _PI, h + 1)
    band = np.cos(theta_edges[:-1]) - np.cos(theta_edges[1:])
    omega = (band * (_TWO_PI / w)).astype(np.float64)
    weights = lum.astype(np.float64) * omega[:, None]
    total = weights.sum()
    return weights.ravel() / total, (weights / total) / omega[:, None]


def alias_table(p: np.ndarray):
    """Vose's alias table of ``p`` (sums to 1): the small cells popped from
    the top of their stack, each paired with the large cell on top of the
    other, in float64 (Python floats)."""
    n = p.size
    scaled = (p.astype(np.float64) * n).tolist()
    prob = [1.0] * n
    alias = list(range(n))
    small = [i for i, s in enumerate(scaled) if s < 1.0]
    large = [i for i, s in enumerate(scaled) if s >= 1.0]
    while small and large:
        s = small.pop()
        big = large.pop()
        prob[s] = scaled[s]
        alias[s] = big
        rest = (scaled[big] + scaled[s]) - 1.0
        scaled[big] = rest
        (small if rest < 1.0 else large).append(big)
    return np.asarray(prob, np.float64), np.asarray(alias, np.int64)


def build(image: np.ndarray, strength: float, device) -> RefEnv:
    img = np.asarray(image, np.float32)
    p, pdf = texel_distribution(img)
    prob, alias = alias_table(p)
    return RefEnv(
        img=torch.as_tensor(img, device=device),
        alias_prob=torch.as_tensor(prob.astype(np.float32), device=device),
        alias_idx=torch.as_tensor(alias, device=device),
        pdf=torch.as_tensor(pdf.astype(np.float32), device=device),
        strength=torch.tensor(float(strength), dtype=torch.float32, device=device),
    )


def _dir_to_uv(d: torch.Tensor):
    u = 0.5 + torch.atan2(d[..., 0], -d[..., 2]) * (1.0 / _TWO_PI)
    v = torch.acos(torch.clamp(d[..., 1], -1.0, 1.0)) * (1.0 / _PI)
    return u, v


def radiance(env: RefEnv, d: torch.Tensor) -> torch.Tensor:
    """Bilinear radiance × strength, [..., 3]: wrap in azimuth, clamp at the
    poles."""
    h, w = env.shape
    u, v = _dir_to_uv(d)
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
    c00, c01 = flat[y0i * w + x0i], flat[y0i * w + x1i]
    c10, c11 = flat[y1i * w + x0i], flat[y1i * w + x1i]
    top = c00 + (c01 - c00) * tx
    bot = c10 + (c11 - c10) * tx
    return (top + (bot - top) * ty) * env.strength


def sample(env: RefEnv, u1: torch.Tensor, u2: torch.Tensor, words=None):
    """(directions [..., 3], solid-angle pdf [...]) drawn ∝ luminance ·
    solid angle. Up to ENV_CELL_SPLIT texels the cell is the integer part of
    ``u1 · n`` and its fraction decides stay or alias; past it the cell is
    ``floor(W · n / 2^64)`` of the 64-bit word ``W`` in ``words`` and all of
    ``u1`` is the fraction. ``u2`` is uniform in solid angle within the band."""
    h, w = env.shape
    n_tex = h * w
    if n_tex > ENV_CELL_SPLIT:
        hi, lo = words[..., 0], words[..., 1]
        cell = (hi * n_tex + ((lo * n_tex) >> 32)) >> 32
        f = torch.clamp(u1, 0.0, 1.0 - 1e-7)
    else:
        scaled = u1 * n_tex
        cell = torch.clamp(scaled.to(torch.int64), 0, n_tex - 1)
        f = torch.clamp(scaled - cell.to(torch.float32), 0.0, 1.0 - 1e-7)
    p_stay = env.alias_prob[cell]
    take_alias = f >= p_stay
    idx = torch.where(take_alias, env.alias_idx[cell], cell)
    xfrac = torch.where(take_alias, (f - p_stay) / torch.clamp_min(1.0 - p_stay, 1e-12),
                        f / torch.clamp_min(p_stay, 1e-12))
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
    return d, env.pdf.reshape(-1)[idx]


def nee_rows(env: RefEnv, seed: int, iter_base: int, num_samples: int, depth: int):
    """[S·D, 8] shared rows of env NEE for iterations ``iter_base ..``: one
    draw per (iteration, depth), ``(dir xyz, bilinear radiance rgb, pdf, 0)``.
    Uniforms: the key of ``uint32(seed) ^ 0xE17B0075`` folded with the
    iteration, then ``uniform(k, (depth, 2))``; past ENV_CELL_SPLIT texels the
    cells' words ``cell_words(k, (depth,))``."""
    dev = env.img.device
    key = rng.prng_key(rng.u32(seed) ^ 0xE17B0075)
    iters = rng.u32(int(iter_base) + torch.arange(num_samples, dtype=torch.int64))
    keys = tuple(k.to(dev) for k in rng.fold_in(key, iters))
    u = rng.uniform(keys, (depth, 2)).reshape(-1, 2)
    h, w = env.shape
    words = rng.cell_words(keys, (depth,)).reshape(-1, 2) if h * w > ENV_CELL_SPLIT else None
    d, pdf = sample(env, u[:, 0], u[:, 1], words)
    le = radiance(env, d)
    return torch.cat([d, le, pdf[:, None], torch.zeros_like(pdf)[:, None]], dim=-1)
