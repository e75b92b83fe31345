"""PyTorch port, integer random streams: the LD lattice, the counter hash
and the seed derivation, bit-exact against the JAX package on numpy-seeded
pixel ids and iterations (including iterations past 2^20 and past the 2^21
Sobol wrap)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cosc_4397_pathtracing_raytracing_project_tpu.ops import rng as jrng
from cosc_4397_pathtracing_raytracing_project_tpu.ops.pallas import megakernel as jmk
from cosc_4397_pathtracing_raytracing_project_tpu_torch.ops import rng as trng
from cosc_4397_pathtracing_raytracing_project_tpu_torch.ops.cuda import megakernel as tmk
from cosc_4397_pathtracing_raytracing_project_tpu_torch.render.state import kernel_seed

torch.set_num_threads(2)

SEEDS = [0, 1, 12345, 2**31 - 1, -1]


@pytest.fixture(scope="module")
def draws():
    rng = np.random.default_rng(2024)
    return {
        "pix": rng.integers(0, 800 * 800, 512).astype(np.uint32),
        "u32": rng.integers(0, 2**32, 512, dtype=np.uint64).astype(np.uint32),
        "iters": np.concatenate(
            [np.arange(1, 65), rng.integers(1, 2**31 - 1, 64), [2**20, 2**20 + 7, 2**21 + 3]]
        ).astype(np.uint32),
    }


def _t(a):
    return torch.as_tensor(np.asarray(a).astype(np.int64))


def _eq(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    if want.dtype == np.float32:
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_array_equal(got.astype(np.int64), want.astype(np.int64))


@pytest.mark.parametrize("seed", SEEDS)
def test_kernel_seed_matches_jax_key_derivation(seed):
    key = jax.random.PRNGKey(seed)
    want = int((key.reshape(-1)[-1].astype(jnp.uint32)).astype(jnp.int32))
    assert kernel_seed(seed) == want


def test_sobol_pair(draws):
    got = trng.sobol_pair(_t(draws["iters"]))
    want = jrng.sobol_pair(jnp.asarray(draws["iters"]))
    for g, w in zip(got, want):
        _eq(g, w)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("tag", [0, 1, 4, 16, 257])
def test_ld_shift(draws, seed, tag):
    got = trng.ld_shift(seed, _t(draws["pix"]), tag)
    want = jrng.ld_shift(jax.random.PRNGKey(seed), jnp.asarray(draws["pix"]), tag)
    _eq(got, want)


def test_bit_reverse_and_laine_karras(draws):
    x, s = draws["u32"], draws["u32"][::-1].copy()
    _eq(trng.bit_reverse32(_t(x)), jrng.bit_reverse32(jnp.asarray(x)))
    _eq(trng.laine_karras(_t(x), _t(s)), jrng.laine_karras(jnp.asarray(x), jnp.asarray(s)))


def test_ld_u01_and_shuffled_index(draws):
    x, s = draws["u32"], draws["u32"][::-1].copy()
    _eq(trng.ld_u01(_t(x), _t(s)), jrng.ld_u01(jnp.asarray(x), jnp.asarray(s)))
    it = np.resize(draws["iters"], x.shape)
    _eq(
        trng.ld_shuffled_index(_t(it), _t(s)),
        jrng.ld_shuffled_index(jnp.asarray(it), jnp.asarray(s)),
    )


def test_ld_tags():
    for d in range(6):
        assert trng.ld_bounce_tags(d) == jrng.ld_bounce_tags(d)
        assert trng.ld_nee_tags(d) == jrng.ld_nee_tags(d)
    np.testing.assert_array_equal(trng._SOBOL_DIR, jrng._SOBOL_DIR)


@pytest.mark.parametrize("depth", [0, 1, 2])
def test_kernel_ld_components_match_rng_lattice(draws, depth):
    """The kernel's reversed-domain (0,2) components: depth 0 reverses the
    raw sample index's Sobol pair, deeper depths the per-(pixel, depth)
    Owen-shuffled index's (ops.rng.ld_shuffled_index)."""
    seed = 12345
    it = np.resize(draws["iters"], draws["pix"].shape)
    key = jax.random.PRNGKey(seed)
    idx = jnp.asarray(it)
    if depth:
        idx = jrng.ld_shuffled_index(
            idx, jrng.ld_shift(key, jnp.asarray(draws["pix"]), 256 + depth)
        )
    w0, w1 = (jrng.bit_reverse32(c) for c in jrng.sobol_pair(idx))
    g0, g1 = tmk._ld_rev_components(_t(it), depth, seed, _t(draws["pix"]))
    _eq(g0, w0)
    _eq(g1, w1)


@pytest.mark.parametrize("seed", [0, -1, 2**31 - 1])
def test_mix(draws, seed):
    it = np.resize(draws["iters"], 64).astype(np.int64)
    tiles = np.arange(64) % 313
    for tag in (0, 3, 7, 0xAA):
        got = tmk.mix(seed, _t(it), tag, _t(tiles))
        want = jmk._mix(
            jnp.int32(seed), jnp.asarray(it.astype(np.uint32)), tag, jnp.asarray(tiles, jnp.int32)
        )
        _eq(got, want)


def test_hash_prng_draw_sequence(draws):
    """Same stream as the JAX interpret-mode PRNG over a (32, 128) tile,
    across several reseeds and draws per seed."""
    jp = jmk._HashPrng((32, 128))
    tp = tmk.HashPrng(torch.arange(32 * 128))
    for it, depth in ((1, 0), (2**20 + 5, 3), (777, 7)):
        jp.reseed(jmk._mix(jnp.int32(-7), jnp.int32(it), depth, jnp.int32(5)))
        tp.reseed(tmk.mix(-7, it, depth, 5))
        for _ in range(5):
            _eq(tp.u01(), np.asarray(jp.u01((32, 128))).reshape(-1))
