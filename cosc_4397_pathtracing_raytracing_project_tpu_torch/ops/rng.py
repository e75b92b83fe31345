"""Low-discrepancy sampler streams (``RenderConfig.sampler='sobol'``).

Port of the LD block of the JAX package's ``ops/rng.py``: per-pixel
Owen-scrambled Sobol (0,2)-sequences (Burley, "Practical Hash-based Owen
Scrambling", JCGT 2020) for the estimator's most variance-critical
dimensions. Every function is bit-exact with its JAX counterpart.

torch has no uint32 arithmetic, so uint32 values live in int64 tensors in
[0, 2^32). Every add and multiply is masked back to 32 bits, and multiplies
by a 32-bit constant are split into two 16-bit halves so no intermediate
product leaves the int64 range (signed overflow is undefined in the C++
kernels under torch). Shifts only ever see masked, non-negative values.

The render seed is a plain int: the JAX package derives its kernel seed as
``int32(key_data[-1])`` of ``jax.random.PRNGKey(seed)``, whose last word is
``seed mod 2^32`` (:func:`kernel_seed`).

The threefry streams of the JAX module (``bounce_uniforms``,
``nee_uniforms``, ``pixel_jitter``, ...) are not ported yet (ROADMAP Queue 1
item 9).
"""

from __future__ import annotations

import numpy as np
import torch

MASK32 = 0xFFFFFFFF

SOBOL_NBITS = 21  # supports 2^21 (~2M) sample indices before wrap

# Digital-shift dimension tags (each tag owns one per-pixel shift lattice).
LD_AA_X, LD_AA_Y = 0, 1
LD_LENS_U, LD_LENS_V = 2, 3
LD_BRANCH = 4
LD_BSDF_U, LD_BSDF_V = 5, 6
LD_PICK = 7
LD_NEE_U, LD_NEE_V = 8, 9
# Depths ≥ 1 reuse the same (0,2) pair under fresh shift lattices (padded
# Sobol, Kollig & Keller): 6 tags per extra depth, laid out after tag 9.
_LD_DEPTH_TAG_BASE = 10
_LD_DEPTH_STRIDE = 6
# Shuffle-seed tag space for ld_shuffled_index: disjoint from the per-lane
# scramble tags (those stay < 256 for any practical ld_depths).
_LD_SHUFFLE_TAG_BASE = 256


def kernel_seed(seed: int) -> int:
    """The int32 kernel seed of a render seed: ``int32(seed mod 2^32)``,
    the last word of ``jax.random.PRNGKey(seed)`` read as int32."""
    return ((int(seed) & MASK32) ^ 0x80000000) - 0x80000000


def u32(x) -> torch.Tensor:
    """int tensor (any sign, e.g. int32 seeds) → its uint32 value in int64."""
    return torch.as_tensor(x).to(torch.int64) & MASK32


def mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """``(x · c) mod 2^32`` for uint32 ``x`` (int64 tensor) and constant ``c``.

    Split into 16-bit halves of ``c`` so both partial products stay below
    2^49."""
    c &= MASK32
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & MASK32


def ld_bounce_tags(depth: int) -> tuple:
    """(branch, bsdf_u, bsdf_v) shift-lattice tags for one bounce depth."""
    if depth == 0:
        return (LD_BRANCH, LD_BSDF_U, LD_BSDF_V)
    b = _LD_DEPTH_TAG_BASE + (depth - 1) * _LD_DEPTH_STRIDE
    return (b, b + 1, b + 2)


def ld_nee_tags(depth: int) -> tuple:
    """(pick, nee_u, nee_v) shift-lattice tags for one bounce depth."""
    if depth == 0:
        return (LD_PICK, LD_NEE_U, LD_NEE_V)
    b = _LD_DEPTH_TAG_BASE + (depth - 1) * _LD_DEPTH_STRIDE
    return (b + 3, b + 4, b + 5)


def _sobol_directions(nbits: int = SOBOL_NBITS) -> np.ndarray:
    """``[2, nbits]`` uint32 direction numbers for Sobol dims 1-2.

    Dim 0 is the van der Corput identity (v_k = 2^(31-k)); dim 1 follows the
    primitive polynomial x+1 (s=1): m_k = 2·m_{k-1} XOR m_{k-1}."""
    v0 = [np.uint32(1) << (31 - k) for k in range(nbits)]
    m = [1]
    for k in range(1, nbits):
        prev = m[k - 1]
        m.append((prev << 1) ^ prev)
    v1 = [np.uint32(m[k]) << (31 - k) for k in range(nbits)]
    return np.array([v0, v1], dtype=np.uint32)


_SOBOL_DIR = _sobol_directions()


def sobol_pair(index) -> tuple:
    """The (0,2)-sequence point for sample index/indices, as two uint32
    (int64 tensors). Bits ≥ SOBOL_NBITS are ignored."""
    n = u32(index)
    x0 = torch.zeros_like(n)
    x1 = torch.zeros_like(n)
    for k in range(SOBOL_NBITS):
        bit = (n >> k) & 1
        x0 = x0 ^ (bit * int(_SOBOL_DIR[0, k]))
        x1 = x1 ^ (bit * int(_SOBOL_DIR[1, k]))
    return x0, x1


def ld_shift(seed: int, pixel_ids, tag: int) -> torch.Tensor:
    """Per-(pixel, dimension-tag, seed) uint32 Owen-scramble seed lattice."""
    s = ((0x5D000000 + tag) & MASK32) ^ ((seed & MASK32) * 0x9E3779B9 & MASK32)
    x = u32(pixel_ids) ^ s
    x = mul32(x ^ (x >> 16), 0x7FEB352D)
    x = mul32(x ^ (x >> 15), 0x846CA68B)
    return x ^ (x >> 16)


def bit_reverse32(x) -> torch.Tensor:
    """uint32 bit reversal (5 swap stages)."""
    x = u32(x)
    x = ((x & 0x55555555) << 1) | ((x >> 1) & 0x55555555)
    x = ((x & 0x33333333) << 2) | ((x >> 2) & 0x33333333)
    x = ((x & 0x0F0F0F0F) << 4) | ((x >> 4) & 0x0F0F0F0F)
    x = ((x & 0x00FF00FF) << 8) | ((x >> 8) & 0x00FF00FF)
    return ((x << 16) & MASK32) | (x >> 16)


def _lk_rounds(x: torch.Tensor) -> torch.Tensor:
    """The four Laine-Karras rounds on an already seeded uint32."""
    x = x ^ mul32(x, 0x6C50B47C)
    x = x ^ mul32(x, 0xB82F1E52)
    x = x ^ mul32(x, 0xC7AFE638)
    x = x ^ mul32(x, 0x8D22F6E6)
    return x


def laine_karras(x, seed) -> torch.Tensor:
    """Laine-Karras hash permutation (bit i depends only on bits ≤ i), so
    conjugating it with bit reversal implements nested uniform (Owen)
    scrambling. Constants from Burley, JCGT 2020."""
    return _lk_rounds((u32(x) + u32(seed)) & MASK32)


def to_u01(bits24: torch.Tensor) -> torch.Tensor:
    """24-bit integer → float32 in [0, 1) (exact)."""
    return bits24.to(torch.float32) * (2.0**-24)


def ld_u01(sobol_bits, seed) -> torch.Tensor:
    """Owen-scrambled Sobol bits → float32 in [0, 1)
    (bit-reverse → Laine-Karras → bit-reverse)."""
    x = bit_reverse32(sobol_bits)
    x = bit_reverse32(laine_karras(x, seed))
    return to_u01(x >> 8)


def ld_shuffled_index(index, shuffle_seed) -> torch.Tensor:
    """Owen-shuffled sample index over the 2^SOBOL_NBITS index domain
    (Burley's shuffled-scrambled Sobol: each pad walks the same (0,2)-
    sequence in an independently Owen-permuted order)."""
    nb = 32 - SOBOL_NBITS
    mask = (1 << SOBOL_NBITS) - 1
    j = bit_reverse32(index) >> nb
    jp = laine_karras(j, shuffle_seed) & mask
    return bit_reverse32(jp) >> nb
