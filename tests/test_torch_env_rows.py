"""PyTorch port, env NEE's rows (K4's row table): the plain row build against
the JAX package's ``_build_env_nee_rows``, the per-geom table of the row
directions against the terms the plain version's ``_occluded_any`` computes,
and the combined layout ``[S·D, 8 + 6·num_geoms]`` that the row kernel
writes and K4 reads.

The rows of the meadow map are also held against JAX in
``tests/test_torch_envmap.py::test_env_nee_rows_match_jax``; here the same
comparison runs on the one-hot-texel stress map (a dim sky with one texel
2,400 times brighter), where the alias draw lands on the bright texel in
most rows (on it or on its tent-blurred neighbours). Tolerances: the
threefry words and uniforms are equal bit for bit (integer streams); the
drawn texels (the pdf column) are equal; the
directions within 1e-6 (torch's and XLA's acos/sin/cos differ in the last
ulp); the bilinear radiance within the oracle bound of the ground rules
(at most 0.5% of rows off by more than 1e-3 relative, column means within
0.5%): an ulp of the direction moves the blend between the bright texel and
the sky by up to ~1e-4 relative (measured on the development host, jax
0.9.0, torch 2.13.0 CPU: largest 5.6e-5 relative, no row above 1e-3). The
table is the plain version's own arithmetic, so it is held bit for bit.
"""


import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cosc_4397_pathtracing_raytracing_project_tpu.io.png import read_hdr
from cosc_4397_pathtracing_raytracing_project_tpu.ops import envmap as jenv
from cosc_4397_pathtracing_raytracing_project_tpu.ops.pallas import megakernel as jmk
from cosc_4397_pathtracing_raytracing_project_tpu_torch import RenderConfig, Scene, parse_scene
from cosc_4397_pathtracing_raytracing_project_tpu_torch.ops import envmap as tenv
from cosc_4397_pathtracing_raytracing_project_tpu_torch.ops import rng as trng
from cosc_4397_pathtracing_raytracing_project_tpu_torch.ops.cuda import megakernel as tmk

from test_torch_cuda import env_scene_text, write_env_map

torch.set_num_threads(2)

SEEDS = [(0, 1), (-7, 51), (2**31 - 5, 1001)]


def table_scene_text(map_file):
    """env_scene_text's slab and spheres (env NEE takes no analytic light),
    with the slab turned off the axes (a general transform), the second
    sphere turned about y and an axis-aligned cube turned by 90 degrees (a
    permuted column map)."""
    text = env_scene_text(map_file, res=16)
    text = text.replace("ROTAT       0 0 0\nSCALE       20 1 20",
                        "ROTAT       10 20 5\nSCALE       20 1 20", 1)
    text = text.replace("ROTAT       0 0 0\nSCALE       1.2 1.2 1.2",
                        "ROTAT       0 30 0\nSCALE       1.2 1.4 1.2", 1)
    return text + "\nOBJECT 3\ncube\nmaterial 0\nTRANS 2 0.5 -2\nROTAT 0 90 0\nSCALE 1 1 2\n"


@pytest.fixture(scope="module")
def env_packed(tmp_path_factory):
    """The table scene under the stress map, packed for env NEE on the CPU."""
    tmp = tmp_path_factory.mktemp("rows")
    path = write_env_map(tmp, "sun")
    scene = Scene.from_desc(parse_scene(table_scene_text(path), base_dir=str(tmp)), "cpu")
    config = RenderConfig(nee=True, trace_depth=3)
    opts = tmk.kernel_options(config, scene)
    return scene, opts, tmk.pack_scene(scene, config=config)


@pytest.mark.parametrize("seed, iter_base", SEEDS)
def test_env_nee_row_uniforms_equal_jax(seed, iter_base):
    """The rows' integer streams: the key, each iteration's folded key and
    the uniforms of jax.random.uniform(k, (D, 2)), bit for bit."""
    s, d = 6, 8
    jkey = jax.random.PRNGKey(jnp.asarray(seed, jnp.int32).astype(jnp.uint32)
                              ^ jnp.uint32(0xE17B0075))
    iters = jnp.asarray(iter_base, jnp.int32) + jnp.arange(s, dtype=jnp.int32)
    jkeys = jax.vmap(jax.random.fold_in, in_axes=(None, 0))(jkey, iters)
    ju = np.asarray(jax.vmap(lambda k: jax.random.uniform(k, (d, 2), jnp.float32))(jkeys))
    tkey = trng.prng_key(trng.u32(seed) ^ 0xE17B0075)
    tkeys = trng.fold_in(tkey, trng.u32(int(iter_base) + torch.arange(s, dtype=torch.int64)))
    np.testing.assert_array_equal(np.stack([k.numpy() for k in tkeys], axis=-1),
                                  np.asarray(jkeys).astype(np.int64))
    tu = trng.uniform(tkeys, (d, 2)).numpy()
    assert tu.dtype == ju.dtype == np.float32
    np.testing.assert_array_equal(tu.view(np.uint32), ju.view(np.uint32))


@pytest.mark.parametrize("seed, iter_base", SEEDS)
def test_env_nee_rows_match_jax_on_the_stress_map(seed, iter_base, tmp_path):
    img = read_hdr(write_env_map(tmp_path, "sun"))
    jmap, tmap = jenv.build_envmap(img, 1.5), tenv.build_envmap(img, 1.5, "cpu")
    want = np.asarray(jmk._build_env_nee_rows(jmap, jnp.int32(seed), jnp.int32(iter_base), 64, 8))
    got = tmk.build_env_nee_rows(tmap, seed, iter_base, 64, 8).numpy()
    assert got.shape == want.shape == (512, 8)
    # most draws land on the bright texel or its tent-blurred neighbours:
    # the stress case of the sampler
    assert (got[:, 6] > 100 * got[:, 6].min()).mean() > 0.5
    np.testing.assert_array_equal(got[:, 6:], want[:, 6:])
    np.testing.assert_allclose(got[:, :3], want[:, :3], atol=1e-6)
    rel = np.abs(got[:, 3:6] - want[:, 3:6]).max(axis=1) / np.abs(want[:, 3:6]).max(axis=1)
    assert (rel > 1e-3).mean() <= 0.005
    np.testing.assert_allclose(got[:, 3:6].mean(axis=0), want[:, 3:6].mean(axis=0), rtol=5e-3)


def test_row_table_is_what_occluded_any_computes(env_packed):
    """Per direction and geom, the table's entry equals bit for bit the
    direction terms of the plain version's test from any origin: the
    object-space direction, then a cube's three reciprocals or a sphere's
    |q_d|^2 and its reciprocal (and 0)."""
    _scene, _opts, packed = env_packed
    assert packed.num_cubes == 2 and packed.num_geoms == 4
    kinds = [perm is None for _k, _iv, _it, perm in tmk._geom_rows(packed)]
    assert True in kinds and False in kinds  # general and axis-aligned transforms
    rng = np.random.default_rng(5)
    d = rng.normal(size=(512, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    d[:3] = np.eye(3)  # zero components: infinite reciprocals
    dirs = torch.as_tensor(d.astype(np.float32))
    o = torch.as_tensor(rng.normal(scale=3.0, size=(512, 3)).astype(np.float32))
    table = tmk.env_row_table(packed, dirs)
    assert table.shape == (512, 4, 6) and table.dtype == torch.float32
    for k, iv, _it, perm in tmk._geom_rows(packed):
        q = tmk._object_ray(iv, perm, o[:, 0], o[:, 1], o[:, 2], dirs[:, 0], dirs[:, 1],
                            dirs[:, 2])
        qdx, qdy, qdz = q[3:]
        if k < packed.num_cubes:
            want = (qdx, qdy, qdz, 1.0 / qdx, 1.0 / qdy, 1.0 / qdz)
        else:
            nq2 = qdx * qdx + qdy * qdy + qdz * qdz
            want = (qdx, qdy, qdz, nq2, 1.0 / nq2, torch.zeros_like(nq2))
        assert torch.equal(table[:, k], torch.stack(want, dim=-1)), k


def test_combined_rows_hold_the_rows_then_the_table(env_packed):
    """The row kernel's plain version: build_env_nee_rows' eight columns,
    then the table of the row's own direction; keyed by absolute
    iteration, so a step's rows hold each launch's; on the CPU the
    wrapper is the plain version."""
    _scene, _opts, packed = env_packed
    rows = tmk.env_nee_rows_reference(packed, 9, 1, 12, 3)
    assert rows.shape == (36, 8 + 6 * 4)
    plain = tmk.build_env_nee_rows(packed.env.envmap, 9, 1, 12, 3)
    assert torch.equal(rows[:, :8], plain)
    assert torch.equal(rows[:, 8:], tmk.env_row_table(packed, plain[:, :3]).reshape(36, -1))
    assert torch.equal(tmk.env_nee_rows_reference(packed, 9, 5, 4, 3), rows[12:24])
    assert torch.equal(tmk.env_nee_rows(packed, 9, 1, 12, 3), rows)


def test_plain_version_reads_the_combined_rows(env_packed):
    """K4's plain version given the combined rows renders what it renders
    from its own eight-column rows, bit for bit."""
    scene, opts, packed = env_packed
    pix = torch.arange(scene.camera.pixel_count)
    own = tmk.render_samples_reference(pix, packed, opts, 3, 1, 2)
    rows = tmk.env_nee_rows_reference(packed, 3, 1, 2, opts.trace_depth)
    assert torch.equal(tmk.render_samples_reference(pix, packed, opts, 3, 1, 2, env_rows=rows),
                       own)


def test_row_wrapper_raises_without_exact_tables(env_packed):
    scene, _opts, _packed = env_packed
    split = tmk.pack_scene(scene, config=RenderConfig(env_mode="split"))
    with pytest.raises(ValueError, match="exact environment"):
        tmk.env_nee_rows(split, 0, 1, 2, 3)
    with pytest.raises(ValueError, match="CUDA device"):
        tmk.KERNEL.env_rows(_packed, 0, 1, 2, 3)
