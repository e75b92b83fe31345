"""The random streams the path tracer's estimator draws from, in plain
PyTorch: uint32 words held in int64 tensors, every add and multiply masked
back to 32 bits.

- the counter hash of a pixel's tile lane (:class:`HashPrng`, :func:`mix`);
- the per-pixel Owen-scrambled Sobol (0,2) lattice of the leading bounces
  (:func:`ld_rev_components`, :func:`ld_u01`, :func:`ld_shift`);
- threefry-2x32 with 20 rounds, as ``jax.random`` draws under
  ``jax_threefry_partitionable=True`` (:func:`uniform`, :func:`cell_words`),
  for the environment sampler's shared rows.
"""

from __future__ import annotations

import numpy as np
import torch

MASK32 = 0xFFFFFFFF
SOBOL_NBITS = 21
# the digital-shift tags of a bounce's (branch, direction u, direction v)
LD_BRANCH, LD_BSDF_U, LD_BSDF_V = 4, 5, 6
_LD_DEPTH_TAG_BASE = 10
_LD_DEPTH_STRIDE = 6
# the fold tag of the alias cells' words
ENV_CELL_TAG = 0xCE11
_THREEFRY_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def kernel_seed(seed: int) -> int:
    """The int32 word a render seed becomes: ``seed mod 2^32`` read as int32."""
    return ((int(seed) & MASK32) ^ 0x80000000) - 0x80000000


def u32(x) -> torch.Tensor:
    return torch.as_tensor(x).to(torch.int64) & MASK32


def mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """``x · c mod 2^32``, in two 16-bit halves of ``c`` so no product leaves
    the int64 range."""
    c &= MASK32
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & MASK32


def to_u01(bits24: torch.Tensor) -> torch.Tensor:
    return bits24.to(torch.float32) * (2.0 ** -24)


def bit_reverse32(x) -> torch.Tensor:
    x = u32(x)
    x = ((x & 0x55555555) << 1) | ((x >> 1) & 0x55555555)
    x = ((x & 0x33333333) << 2) | ((x >> 2) & 0x33333333)
    x = ((x & 0x0F0F0F0F) << 4) | ((x >> 4) & 0x0F0F0F0F)
    x = ((x & 0x00FF00FF) << 8) | ((x >> 8) & 0x00FF00FF)
    return ((x << 16) & MASK32) | (x >> 16)


def laine_karras(x, seed) -> torch.Tensor:
    """Laine-Karras hash permutation (Burley, JCGT 2020)."""
    x = (u32(x) + u32(seed)) & MASK32
    x = x ^ mul32(x, 0x6C50B47C)
    x = x ^ mul32(x, 0xB82F1E52)
    x = x ^ mul32(x, 0xC7AFE638)
    return x ^ mul32(x, 0x8D22F6E6)


def ld_bounce_tags(depth: int) -> tuple:
    if depth == 0:
        return (LD_BRANCH, LD_BSDF_U, LD_BSDF_V)
    b = _LD_DEPTH_TAG_BASE + (depth - 1) * _LD_DEPTH_STRIDE
    return (b, b + 1, b + 2)


def ld_shift(seed: int, pixel_ids, tag: int) -> torch.Tensor:
    """Per-(pixel, tag, seed) Owen-scramble seed lattice."""
    s = ((0x5D000000 + tag) & MASK32) ^ ((int(seed) & MASK32) * 0x9E3779B9 & MASK32)
    x = u32(pixel_ids) ^ s
    x = mul32(x ^ (x >> 16), 0x7FEB352D)
    x = mul32(x ^ (x >> 15), 0x846CA68B)
    return x ^ (x >> 16)


def _sobol_rev_pair(idx: torch.Tensor):
    """Bit-reversed (0,2) components of sample indices (low 21 bits)."""
    x0 = idx & ((1 << SOBOL_NBITS) - 1)
    x1 = torch.zeros_like(idx)
    m = 1
    for k in range(SOBOL_NBITS):
        x1 = x1 ^ (((idx >> k) & 1) * ((m << (31 - k)) & MASK32))
        m = (m << 1) ^ m
    return x0, bit_reverse32(x1)


def ld_rev_components(it, depth: int, seed: int, pid):
    """The sample's raw index at depth 0, its per-(pixel, depth) Owen-shuffled
    index past it."""
    if depth == 0:
        return _sobol_rev_pair(it)
    j = bit_reverse32(it) >> 11
    jp = laine_karras(j, ld_shift(seed, pid, 256 + depth)) & ((1 << SOBOL_NBITS) - 1)
    return _sobol_rev_pair(bit_reverse32(jp) >> 11)


def ld_u01(rev_bits, lattice) -> torch.Tensor:
    return to_u01(bit_reverse32(laine_karras(rev_bits, lattice)) >> 8)


def mix(*xs) -> torch.Tensor:
    """uint32 hash of int words (tensors or ints, broadcast)."""
    out = torch.zeros((), dtype=torch.int64)
    for i, x in enumerate(xs):
        out = out ^ mul32(u32(x), 0x9E3779B9 + 2 * i + 1)
        out = mul32(out, 0x85EBCA6B)
        out = out ^ (out >> 13)
    return out


class HashPrng:
    """Counter hash: a uniform is a function of (seed, draw counter, lane)."""

    def __init__(self, lane: torch.Tensor):
        self.lane = u32(lane)
        self.seed_mul = torch.zeros((), dtype=torch.int64, device=lane.device)
        self.counter = 0

    def reseed(self, seed: torch.Tensor) -> None:
        self.seed_mul = mul32(u32(seed), 0x9E3779B9)
        self.counter = 0

    def u01(self) -> torch.Tensor:
        self.counter += 1
        x = self.lane ^ self.seed_mul
        x = (x + ((self.counter * 0x85EBCA6B) & MASK32)) & MASK32
        x = mul32(x ^ (x >> 16), 0x7FEB352D)
        x = mul32(x ^ (x >> 15), 0x846CA68B)
        x = x ^ (x >> 16)
        return to_u01(x >> 8)


def _rotl32(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) & MASK32) | (x >> (32 - r))


def threefry2x32(key, x0, x1):
    k0, k1 = u32(key[0]), u32(key[1])
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (u32(x0) + ks[0]) & MASK32
    x1 = (u32(x1) + ks[1]) & MASK32
    for group in range(5):
        for r in _THREEFRY_ROTATIONS[group % 2]:
            x0 = (x0 + x1) & MASK32
            x1 = _rotl32(x1, r) ^ x0
        x0 = (x0 + ks[(group + 1) % 3]) & MASK32
        x1 = (x1 + ks[(group + 2) % 3] + group + 1) & MASK32
    return x0, x1


def prng_key(seed) -> tuple:
    return (torch.zeros((), dtype=torch.int64), u32(seed))


def fold_in(key, data) -> tuple:
    return threefry2x32(key, torch.zeros((), dtype=torch.int64), u32(data))


def random_bits(key, shape) -> torch.Tensor:
    """Bits of a (batch of) key(s): element i of the row-major shape hashes
    the 64-bit counter i, its bits the XOR of the two output words."""
    k0, k1 = u32(key[0]), u32(key[1])
    n = int(np.prod(shape))
    lo = torch.arange(n, dtype=torch.int64, device=k0.device).reshape(shape)
    batch = k0.shape
    if batch:
        lead = (...,) + (None,) * len(shape)
        k0, k1 = k0[lead], k1[lead]
    y0, y1 = threefry2x32((k0, k1), torch.zeros((), dtype=torch.int64), lo)
    return (y0 ^ y1).expand(batch + tuple(shape))


def uniform(key, shape) -> torch.Tensor:
    """float32 on [0, 1): the top 23 bits as the mantissa of [1, 2), minus 1."""
    bits = (random_bits(key, shape) >> 9) | 0x3F800000
    return (bits.to(torch.int32).view(torch.float32) - 1.0).clamp_min(0.0)


def cell_words(key, shape) -> torch.Tensor:
    """[*shape, 2] (high, low) words of 64-bit alias-cell draws."""
    return random_bits(fold_in(key, ENV_CELL_TAG), tuple(shape) + (2,))
