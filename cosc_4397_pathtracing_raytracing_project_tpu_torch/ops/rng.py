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

The threefry-2x32 generator behind ``jax.random`` is here too
(:func:`threefry2x32`, :func:`prng_key`, :func:`fold_in`, :func:`uniform`),
bit-exact with ``jax.random`` under ``jax_threefry_partitionable=True``:
the environment-NEE rows of the megakernel draw from it, and so do the
full-frame jitter and lens streams of the mesh pipeline
(:func:`pixel_jitter`, :func:`lens_uniforms`).

The mesh pipeline's per-bounce streams are keyed by pixel id, so a sorted
wavefront draws the same numbers as an unsorted one: the counter hash
(:func:`hash_bounce_uniforms`, :func:`hash_nee_uniforms`) and the LD
lane-layout wrappers (:func:`ld_pixel_jitter`, :func:`ld_lens_uniforms`,
:func:`ld_bounce_uniforms`, :func:`ld_nee_bounce_uniforms`). Where the JAX
functions take a render key, these take ``seed``: either a key ``(k0, k1)``
(for example :func:`fold_in` of ``prng_key(s)``, the key of a pixel shard
in the multi-device step) or a plain int, the shorthand for
``prng_key(seed)``. The hash streams and the LD lattices read only the
key's last word (:func:`key_word`), the threefry streams fold from both
(:func:`as_key`).

The fast and reference pipelines never reorder their rays, so their
per-bounce streams are indexed by lane: :func:`bounce_uniforms` (``[n,
NUM_LANES]``), :func:`bounce_lane_uniforms` (the ``[NUM_LANES, n]`` draw the
fast pipeline makes from the same key: another layout of other bits),
:func:`nee_uniforms` and :func:`env_uniforms`, each a ``jax.random.uniform``
of a key folded from ``(seed, iteration, depth)``; :func:`env_cell_words`
adds the environment sampler's alias-cell words for maps past 2^15 texels
(``ops.envmap.sample_env``), the one stream the JAX package lacks.
"""

from __future__ import annotations

import numpy as np
import torch

MASK32 = 0xFFFFFFFF

# Uniform lanes drawn per path per bounce, by role (`pathtrace.cu:368-436`).
U_RR = 0  # Russian roulette keep/kill
U_BRANCH = 1  # specular-vs-diffuse branch
U_A = 2  # direction sample 1
U_B = 3  # direction sample 2
U_C = 4  # direction sample 3 (cone-perturb azimuth)
NUM_LANES = 5

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


def as_key(seed) -> tuple:
    """The render key of ``seed``: a key ``(k0, k1)`` as it is, a plain int
    as :func:`prng_key` of it."""
    if isinstance(seed, tuple):
        return (u32(seed[0]), u32(seed[1]))
    return prng_key(seed)


def render_key(seed) -> tuple:
    """The render key of a seed (``jax.random.PRNGKey(seed)`` in the JAX
    package): :func:`as_key` of it."""
    return as_key(seed)


def key_word(seed):
    """The last word of ``seed``'s render key (JAX's ``key_data(key)[-1]``),
    which the hash streams and the LD lattices read: ``k1`` of a key, ``seed
    mod 2^32`` of a plain seed (an int or an integer tensor)."""
    if isinstance(seed, tuple):
        return int(seed[1]) & MASK32
    return seed & MASK32


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
    s = ((0x5D000000 + tag) & MASK32) ^ (key_word(seed) * 0x9E3779B9 & MASK32)
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


_THREEFRY_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl32(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) & MASK32) | (x >> (32 - r))


def threefry2x32(key, x0, x1):
    """Threefry-2x32 with 20 rounds (Salmon et al. 2011; ``jax.random``'s
    ``threefry2x32_p``): key ``(k0, k1)`` and counter words ``x0``/``x1``
    (uint32 in int64 tensors, broadcast) → the two uint32 output words."""
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
    """``jax.random.PRNGKey(seed)`` for a 32-bit seed: the key words
    ``(0, seed mod 2^32)``."""
    return (torch.zeros((), dtype=torch.int64), u32(seed))


def fold_in(key, data) -> tuple:
    """``jax.random.fold_in(key, data)``: the key hashed with the counter
    ``(0, data mod 2^32)``. ``data`` may be a tensor of words; the result is
    then a batch of keys."""
    return threefry2x32(key, torch.zeros((), dtype=torch.int64), u32(data))


def random_bits(key, shape, device=None) -> torch.Tensor:
    """``jax.random.bits(key, shape)`` (uint32 in int64) under
    ``jax_threefry_partitionable=True``: element ``i`` of the row-major
    flattened shape hashes the 64-bit counter ``i`` split into (high, low)
    words, and its bits are the XOR of the two output words. The key words
    may carry leading batch dimensions (a batch of folded keys). The bits
    land on ``device`` (by default the key's): a single key may stay on
    the host, where the device's kernels read its words as scalars, with
    no copy and no wait for the device."""
    k0, k1 = u32(key[0]), u32(key[1])
    n = int(np.prod(shape))
    if n >= 1 << 32:
        raise ValueError(f"random_bits: {n} elements exceed a 32-bit counter")
    dev = k0.device if device is None else torch.device(device)
    lo = torch.arange(n, dtype=torch.int64, device=dev).reshape(shape)
    batch = k0.shape
    if batch:
        lead = (...,) + (None,) * len(shape)
        k0, k1 = k0[lead], k1[lead]
    y0, y1 = threefry2x32((k0, k1), torch.zeros((), dtype=torch.int64), lo)
    return (y0 ^ y1).expand(batch + tuple(shape))


def uniform(key, shape, device=None) -> torch.Tensor:
    """``jax.random.uniform(key, shape, float32)`` on [0, 1): the top 23
    bits of each word as the mantissa of a float in [1, 2), minus 1."""
    bits = (random_bits(key, shape, device) >> 9) | 0x3F800000
    return (bits.to(torch.int32).view(torch.float32) - 1.0).clamp_min(0.0)


def ld_shuffled_index(index, shuffle_seed) -> torch.Tensor:
    """Owen-shuffled sample index over the 2^SOBOL_NBITS index domain
    (Burley's shuffled-scrambled Sobol: each pad walks the same (0,2)-
    sequence in an independently Owen-permuted order)."""
    nb = 32 - SOBOL_NBITS
    mask = (1 << SOBOL_NBITS) - 1
    j = bit_reverse32(index) >> nb
    jp = laine_karras(j, shuffle_seed) & mask
    return bit_reverse32(jp) >> nb


# ───────────────────────── pixel-keyed streams ─────────────────────────


def _hash_seed(seed: int, iteration: int, depth: int) -> int:
    """uint32 seed of one (render seed, iteration, depth) triple: the
    injective counter ``iteration << 5 | depth & 31`` xored with the key
    word times phi, through the murmur3 fmix32 finalizer. A Python int, so
    the streams keyed by it take it as a scalar operand (no copy to the
    device)."""
    ctr = ((int(iteration) << 5) & MASK32) | (int(depth) & 31)
    x = ctr ^ (int(key_word(seed)) * 0x9E3779B9 & MASK32)
    x = ((x ^ (x >> 16)) * 0x85EBCA6B) & MASK32
    x = ((x ^ (x >> 13)) * 0xC2B2AE35) & MASK32
    return x ^ (x >> 16)


def _hash_u01(seed: int, p: torch.Tensor, lane: int) -> torch.Tensor:
    """One pixel-keyed u01 lane: avalanche of ``p ^ (seed + lane·phi)``."""
    x = p ^ ((seed + (lane * 0x9E3779B9 & MASK32)) & MASK32)
    x = mul32(x ^ (x >> 16), 0x7FEB352D)
    x = mul32(x ^ (x >> 15), 0x846CA68B)
    x = x ^ (x >> 16)
    return to_u01(x >> 8)


def hash_bounce_uniforms(seed: int, iteration, depth, pixel_ids) -> torch.Tensor:
    """``[NUM_LANES, n]`` f32 uniforms of one bounce from the counter hash,
    keyed by pixel id: ``u[l, i]`` is a function of (seed, iteration, depth,
    pixel_ids[i], l) alone."""
    h = _hash_seed(seed, iteration, depth)
    p = u32(pixel_ids)
    return torch.stack([_hash_u01(h, p, lane) for lane in range(NUM_LANES)])


def hash_nee_uniforms(seed: int, iteration, depth, pixel_ids) -> torch.Tensor:
    """``[n, 3]`` NEE uniforms (light pick, two surface coordinates) from the
    counter hash, keyed by pixel id, on lanes NUM_LANES..NUM_LANES+2
    (disjoint from the bounce draws)."""
    h = _hash_seed(seed, iteration, depth)
    p = u32(pixel_ids)
    return torch.stack(
        [_hash_u01(h, p, lane) for lane in range(NUM_LANES, NUM_LANES + 3)], dim=-1
    )


def bounce_key(seed: int, iteration, depth) -> tuple:
    """Key of one (sample iteration, bounce depth) pair, the JAX
    ``bounce_key``: ``fold_in(fold_in(PRNGKey(seed), iteration), depth)``,
    both folded as int32 words."""
    return fold_in(fold_in(as_key(seed), iteration), depth)


def bounce_uniforms(seed: int, iteration, depth, n: int, device="cpu") -> torch.Tensor:
    """``[n, NUM_LANES]`` f32 uniforms of one bounce, the JAX
    ``bounce_uniforms`` (the reference pipeline's layout)."""
    return uniform(bounce_key(seed, iteration, depth), (n, NUM_LANES), device)


def bounce_lane_uniforms(seed: int, iteration, depth, n: int, device="cpu") -> torch.Tensor:
    """``[NUM_LANES, n]`` f32 uniforms of one bounce from the same key as
    :func:`bounce_uniforms`: the draw ``trace_sample_fast`` makes,
    ``uniform(bounce_key(...), (NUM_LANES, n))``. Element ``(l, i)`` hashes
    the counter ``l·n + i``, so it is not the transpose of
    :func:`bounce_uniforms`."""
    return uniform(bounce_key(seed, iteration, depth), (NUM_LANES, n), device)


def nee_uniforms(seed: int, iteration, depth, n: int, device="cpu") -> torch.Tensor:
    """``[n, 3]`` uniforms for direct light sampling (light pick, two
    surface coordinates), the JAX ``nee_uniforms``: the bounce key folded
    with the tag 0x11EE."""
    return uniform(fold_in(bounce_key(seed, iteration, depth), 0x11EE), (n, 3), device)


def env_uniforms(seed: int, iteration, depth, n: int, device="cpu") -> torch.Tensor:
    """``[n, 2]`` uniforms for environment-map importance sampling, the JAX
    ``env_uniforms``: the bounce key folded with the tag 0xE271."""
    return uniform(fold_in(bounce_key(seed, iteration, depth), 0xE271), (n, 2), device)


# Fold tag of the alias cell's words (``ops.envmap.sample_env`` past
# ``ENV_CELL_SPLIT`` texels), folded into the key of the draw's uniforms:
# every existing stream keeps its bits.
ENV_CELL_TAG = 0xCE11


def cell_words(key, shape, device=None) -> torch.Tensor:
    """``[*shape, 2]`` uint32 words (in int64) of the alias cells of a draw
    whose uniforms come from ``key``: ``random_bits`` of the key folded with
    :data:`ENV_CELL_TAG`, each cell's (high, low) pair of a 64-bit word."""
    return random_bits(fold_in(key, ENV_CELL_TAG), tuple(shape) + (2,), device)


def env_cell_words(seed: int, iteration, depth, n: int, device="cpu") -> torch.Tensor:
    """``[n, 2]`` alias-cell words of the draw :func:`env_uniforms` keys
    (a port extension: the JAX package takes the cell from ``u1``)."""
    return cell_words(fold_in(bounce_key(seed, iteration, depth), 0xE271), (n,), device)


def _frame_uniforms(seed: int, iteration, tag: int, n: int, device) -> torch.Tensor:
    return uniform(fold_in(fold_in(as_key(seed), iteration), tag), (n, 2), device)


def pixel_jitter(seed: int, iteration, n: int, device="cpu") -> torch.Tensor:
    """``[n, 2]`` sub-pixel jitter of the frame's first n pixels, the JAX
    ``pixel_jitter``: ``uniform(fold_in(fold_in(PRNGKey(seed), iteration),
    0x7EA), (n, 2))``."""
    return _frame_uniforms(seed, iteration, 0x7EA, n, device)


def lens_uniforms(seed: int, iteration, n: int, device="cpu") -> torch.Tensor:
    """``[n, 2]`` lens-disk uniforms, keyed like :func:`pixel_jitter` on its
    own fold constant (0xD0F)."""
    return _frame_uniforms(seed, iteration, 0xD0F, n, device)


def ld_uniform_pair(seed: int, iteration, pixel_ids, tag_u: int, tag_v: int) -> tuple:
    """The per-pixel scrambled (0,2) pair of one dimension pair. (The pair
    of a scalar iteration stays a 0-d host tensor, which device ops take as
    a scalar.)"""
    s0, s1 = sobol_pair(iteration)
    return (
        ld_u01(s0, ld_shift(seed, pixel_ids, tag_u)),
        ld_u01(s1, ld_shift(seed, pixel_ids, tag_v)),
    )


def ld_pixel_jitter(seed: int, iteration, pixel_ids) -> torch.Tensor:
    """``[n, 2]`` LD sub-pixel jitter, keyed by pixel id."""
    u, v = ld_uniform_pair(seed, iteration, pixel_ids, LD_AA_X, LD_AA_Y)
    return torch.stack([u, v], dim=1)


def ld_lens_uniforms(seed: int, iteration, pixel_ids) -> torch.Tensor:
    """``[n, 2]`` LD lens-disk uniforms, keyed by pixel id."""
    u, v = ld_uniform_pair(seed, iteration, pixel_ids, LD_LENS_U, LD_LENS_V)
    return torch.stack([u, v], dim=1)


def _ld_depth_index(seed: int, iteration, pixel_ids, depth: int):
    """Sample index of one bounce depth: the raw iteration at depth 0, the
    per-(pixel, depth) Owen-shuffled index past it."""
    if depth == 0:
        return u32(iteration)
    return ld_shuffled_index(
        u32(iteration), ld_shift(seed, pixel_ids, _LD_SHUFFLE_TAG_BASE + depth)
    )


def ld_bounce_uniforms(seed: int, iteration, pixel_ids, depth: int = 0) -> torch.Tensor:
    """``[NUM_LANES, n]`` bounce uniforms for ``sampler='sobol'``: branch and
    the two direction draws from the LD lattice of ``depth`` (a Python int),
    Russian roulette and the cone azimuth from the counter hash."""
    h = _hash_seed(seed, iteration, depth)
    p = u32(pixel_ids)
    s0, s1 = sobol_pair(_ld_depth_index(seed, iteration, pixel_ids, depth))
    t_branch, t_u, t_v = ld_bounce_tags(depth)
    return torch.stack(
        [
            _hash_u01(h, p, U_RR),
            ld_u01(s0, ld_shift(seed, pixel_ids, t_branch)),
            ld_u01(s0, ld_shift(seed, pixel_ids, t_u)),
            ld_u01(s1, ld_shift(seed, pixel_ids, t_v)),
            _hash_u01(h, p, U_C),
        ]
    )


def ld_nee_bounce_uniforms(seed: int, iteration, pixel_ids, depth: int = 0) -> torch.Tensor:
    """``[n, 3]`` LD NEE uniforms for ``sampler='sobol'`` (light pick, the
    light-surface pair), the layout of :func:`hash_nee_uniforms`."""
    s0, s1 = sobol_pair(_ld_depth_index(seed, iteration, pixel_ids, depth))
    t_pick, t_u, t_v = ld_nee_tags(depth)
    return torch.stack(
        [
            ld_u01(s0, ld_shift(seed, pixel_ids, t_pick)),
            ld_u01(s0, ld_shift(seed, pixel_ids, t_u)),
            ld_u01(s1, ld_shift(seed, pixel_ids, t_v)),
        ],
        dim=-1,
    )


def ld_bounce0_uniforms(seed, iteration, pixel_ids) -> torch.Tensor:
    """Depth-0 :func:`ld_bounce_uniforms`."""
    return ld_bounce_uniforms(seed, iteration, pixel_ids, 0)


def ld_nee0_uniforms(seed, iteration, pixel_ids) -> torch.Tensor:
    """Depth-0 :func:`ld_nee_bounce_uniforms`."""
    return ld_nee_bounce_uniforms(seed, iteration, pixel_ids, 0)
