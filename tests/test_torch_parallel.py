"""PyTorch port, multi-device rendering on the CPU: ``parallel/`` over
``torch.distributed`` (gloo), against the JAX package's ``parallel`` on an
equally shaped CPU mesh and against the port's own single-device renders.

One group of rank processes per world size (2 and 4) runs every case of
that size (``parallel.dryrun.run_cases``, a jax-free module: only this
parent process imports jax). CORNELL_SMALL and tests/test_fast_mesh.py's
``tri_scene`` at depth 3 or less and at most 4 spp. The bounds:

- the megakernel's plain version on a pixel slice against the JAX
  interpret-mode kernel on the same slice, and the sharded eager step
  against JAX ``render_chunk_sharded``: the oracle bound of
  test_torch_megakernel.py (at most 0.5% of pixels above 1e-3, channel means
  within 0.5%), while the folded keys and the integer streams drawn from
  them are bit-exact;
- the sharded megakernel step on a TILE-aligned frame against the port's
  single-device step: bit for bit with sp = 1; with sp = 2 within
  tests/test_parallel.py's rtol 1e-5, atol 1e-6 (the all-reduce adds the
  two half-sums, another float order);
- the sharded mesh pipeline against the single device: JAX's rtol 3e-7,
  atol 1e-7 (tests/test_parallel.py:224-226);
- ``AdaptiveRenderer(mesh=)`` bit for bit the unsharded renderer, trash-tile
  padding included (tests/test_adaptive.py's bound).

Measured on the development host (torch 2.13.0 CPU, jax 0.9.0): the slice
and the sharded eager step have no pixel above 1e-3; every bit-for-bit case
is; the sp = 2 megakernel step and the mesh steps are within their bounds.
"""

import time
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cosc_4397_pathtracing_raytracing_project_tpu import RenderConfig as JConfig
from cosc_4397_pathtracing_raytracing_project_tpu.ops import rng as jrng
from cosc_4397_pathtracing_raytracing_project_tpu.ops.pallas import megakernel as jmk
from cosc_4397_pathtracing_raytracing_project_tpu.parallel import make_mesh as jmake_mesh
from cosc_4397_pathtracing_raytracing_project_tpu.parallel import (
    render_chunk_sharded as jrender_chunk_sharded,
)
from cosc_4397_pathtracing_raytracing_project_tpu.render.state import RenderState as JState
from cosc_4397_pathtracing_raytracing_project_tpu.scene import Scene as JScene
from cosc_4397_pathtracing_raytracing_project_tpu.scene import parse_scene as jparse
from cosc_4397_pathtracing_raytracing_project_tpu_torch import (
    AdaptiveRenderer,
    RenderConfig,
    RenderState,
    Scene,
    parse_scene,
)
from cosc_4397_pathtracing_raytracing_project_tpu_torch.ops import fast
from cosc_4397_pathtracing_raytracing_project_tpu_torch.ops import rng as trng
from cosc_4397_pathtracing_raytracing_project_tpu_torch.ops.cuda import megakernel as tmk
from cosc_4397_pathtracing_raytracing_project_tpu_torch.parallel import (
    mesh as tmesh,
    shard as tshard,
    spawn_ranks,
    start_rank,
)
from cosc_4397_pathtracing_raytracing_project_tpu_torch.parallel.dryrun import (
    dryrun_multichip,
    run_cases,
    scene_desc,
)
from cosc_4397_pathtracing_raytracing_project_tpu_torch.render.engine import (
    make_mesh_intersector,
    make_pallas_step,
)

from test_render import CORNELL_SMALL
from test_torch_cuda import assert_within_oracle_tolerance, env_scene_text, tri_scene_desc

torch.set_num_threads(2)

SMALL = parse_scene(CORNELL_SMALL)
# 128×64 = 8192 px: TILE-aligned slices for dp = 2 (4096 px) and dp = 4 (2048)
ALIGNED = dict(scene=SMALL, resolution=(128, 64))
# 64×96: 3 adaptive tiles, so 4 ranks (quantum 2) pad with the trash tile
THREE_TILES = dict(scene=SMALL, resolution=(64, 96))
MESH_CFG = dict(trace_depth=3, sky_strength=0.5, antialias=True)


def _step(pipeline, scene, config, samples, sp, seed=0):
    return dict(kind="step", pipeline=pipeline, scene=scene, config=config, samples=samples,
                sp=sp, seed=seed)


# world 4
CASES4 = {
    "mesh": dict(kind="mesh", good=[1, 2, 4], bad=[3, 8], pixels=4096),
    "fast": _step("fast", SMALL, RenderConfig(trace_depth=3), 4, sp=2, seed=3),
    "pallas-sp1": _step("pallas", ALIGNED, RenderConfig(trace_depth=3, sampler="sobol"), 4, sp=1),
    "pallas-sp2": _step("pallas", ALIGNED, RenderConfig(trace_depth=3, sampler="sobol"), 4, sp=2),
    "misaligned-seed0": _step("pallas", SMALL, RenderConfig(trace_depth=2), 2, sp=1),
    "misaligned-seed123": _step("pallas", SMALL, RenderConfig(trace_depth=2), 2, sp=1, seed=123),
    "tri": _step("mesh", tri_scene_desc(), RenderConfig(**MESH_CFG), 2, sp=1),
    "tri-dof-nee": _step("mesh", dict(scene=tri_scene_desc(), aperture=0.5, focal=6.0),
                         RenderConfig(**MESH_CFG, dof=True, nee=True), 2, sp=1),
    "adaptive": dict(kind="adaptive", scene=THREE_TILES, config=RenderConfig(trace_depth=2),
                     warmup=4, rounds=[(2, 1.0)]),
}
# world 2
CASES2 = {
    "mesh": dict(kind="mesh", good=[1, 2], bad=[3], pixels=8192),
    "pallas-sp1": _step("pallas", ALIGNED, RenderConfig(trace_depth=3, sampler="sobol"), 4, sp=1),
    "adaptive": dict(kind="adaptive", scene=dict(scene=SMALL, resolution=(128, 64)),
                     config=RenderConfig(trace_depth=2), warmup=2,
                     rounds=[(2, 0.25), (2, 0.5)]),
}


def _group(world, sp, cases):
    t0 = time.perf_counter()
    ranks = spawn_ranks(run_cases, world, "gloo", "cpu", args=(sp, list(cases.values())),
                        timeout=300)
    print(f"world {world}: {time.perf_counter() - t0:.1f} s")
    return {name: [r[i] for r in ranks] for i, name in enumerate(cases)}


@pytest.fixture(scope="module")
def groups():
    """The world-2 and world-4 groups and the dry run's four ranks, started
    together (each rank's start is mostly its interpreter's and torch's
    import)."""
    with ThreadPoolExecutor(max_workers=3) as pool:
        runs = {"world2": pool.submit(_group, 2, 1, CASES2),
                "world4": pool.submit(_group, 4, 2, CASES4),
                "dryrun": pool.submit(dryrun_multichip, 4)}
        return {name: run.result() for name, run in runs.items()}


@pytest.fixture(scope="module")
def world4(groups):
    return groups["world4"]


@pytest.fixture(scope="module")
def world2(groups):
    return groups["world2"]


def _frame(results):
    """Rank 0's gathered frame, after checking that every rank gathered the
    same one."""
    assert len({r["digest"] for r in results}) == 1
    return results[0]["accum"]


def _single_pallas(spec, config, samples, seed=0):
    scene = Scene.from_desc(scene_desc(spec), "cpu")
    state = RenderState.create(scene.camera.pixel_count, seed, "cpu")
    return make_pallas_step()(scene, state, config, samples).accum


# ── (a) the mesh ──


@pytest.mark.parametrize("world", [2, 4])
def test_make_mesh_shapes_and_indivisible_configs_raise(world, world2, world4):
    """('sp', 'dp') meshes over every rank, each rank's coordinates and
    pixel slice; an sp that does not divide the world raises, as
    tests/test_parallel.py's test_indivisible_configs_raise."""
    results = (world2 if world == 2 else world4)["mesh"]
    case = (CASES2 if world == 2 else CASES4)["mesh"]
    for rank, res in enumerate(results):
        assert all(res["raised"])
        for sp, made in zip(case["good"], res["made"]):
            dp = world // sp
            assert made["sizes"] == (sp, dp) and tuple(made["names"]) == ("sp", "dp")
            assert made["coords"] == (rank // dp, rank % dp)
            local = case["pixels"] // dp
            assert made["slice"] == ((rank % dp) * local, local)


def test_indivisible_samples_raise():
    """3 samples over sp = 2 (tests/test_parallel.py's
    test_indivisible_configs_raise); checked before any collective."""

    class Mesh22:
        def size(self, dim=None):
            return 4 if dim is None else 2

    scene = Scene.from_desc(SMALL, "cpu")
    with pytest.raises(ValueError, match="not divisible by sp=2"):
        tshard._shard_extents(scene, 3, Mesh22())
    wide = Scene.from_desc(scene_desc(dict(scene=SMALL, resolution=(63, 63))), "cpu")
    with pytest.raises(ValueError, match="not divisible by dp=2"):
        tshard._shard_extents(wide, 4, Mesh22())


# ── (b) the megakernel on a pixel slice, against the JAX oracle ──


def test_slice_plain_version_matches_oracle():
    """A misaligned slice (pixels 1000 .. 2499, hash tiles from 3) of
    CORNELL_SMALL, depth 2, antialias + sobol (global LD keys and
    coordinates, the slice's own tile streams), against JAX
    ``render_samples(..., interpret=True, pixel_offset, num_pixels,
    tile_base)``."""
    cfg = dict(trace_depth=2, antialias=True, sampler="sobol")
    offset, n, tile_base = 1000, 1500, 3
    want = jmk.render_samples(JScene.from_desc(jparse(CORNELL_SMALL)), JConfig(**cfg),
                              jnp.int32(5), jnp.int32(1), 2, interpret=True,
                              pixel_offset=offset, num_pixels=n, tile_base=tile_base)
    got = tmk.render_samples(Scene.from_desc(SMALL, "cpu"), RenderConfig(**cfg), 5, 1, 2,
                             pixel_offset=offset, num_pixels=n, tile_base=tile_base)
    assert got.shape == (n, 3)
    assert_within_oracle_tolerance(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("case", ["main", "split"])
def test_aligned_slice_is_the_frame_rows(case, tmp_path):
    """A TILE-aligned slice with the default tile base renders the full
    frame's rows bit for bit: the same keys, lanes and tiles (split mode:
    the slice's own rows of the exact background composite)."""
    if case == "main":
        desc, cfg = SMALL, RenderConfig(trace_depth=3, sampler="sobol")
    else:
        from test_torch_cuda import write_env_map

        path = write_env_map(tmp_path, "sun")
        desc = parse_scene(env_scene_text(path), base_dir=str(tmp_path))
        cfg = RenderConfig(trace_depth=3, env_mode="split")
    scene = Scene.from_desc(desc, "cpu")
    full = tmk.render_samples(scene, cfg, 3, 1, 2)
    part = tmk.render_samples(scene, cfg, 3, 1, 2, pixel_offset=tmk.TILE, num_pixels=1024)
    assert tmk.kernel_options(cfg, scene).bg_external == (case == "split")
    assert torch.equal(part, full[tmk.TILE:tmk.TILE + 1024])


def test_slices_outside_the_frame_raise():
    scene = Scene.from_desc(SMALL, "cpu")
    for kw in (dict(pixel_offset=4000, num_pixels=200), dict(pixel_offset=-1),
               dict(num_pixels=10, tile_base=-2)):
        with pytest.raises(ValueError, match="not a slice"):
            tmk.render_samples(scene, RenderConfig(trace_depth=1), 0, 1, 1, **kw)


# ── (c) the sharded megakernel step ──


@pytest.mark.parametrize("world,case", [(2, "pallas-sp1"), (4, "pallas-sp1"), (4, "pallas-sp2")])
def test_sharded_megakernel_matches_single_device(world, case, world2, world4):
    """TILE-aligned slices (128×64 over dp = 2 or 4): sp = 1 bit for bit the
    single-device step, sp = 2 within rtol 1e-5, atol 1e-6; each rank keeps
    only its slice of the accumulator, rows [N/dp, 3]."""
    results = (world2 if world == 2 else world4)[case]
    spec = (CASES2 if world == 2 else CASES4)[case]
    single = _single_pallas(ALIGNED, spec["config"], spec["samples"])
    got = _frame(results)
    assert all(r["local_rows"] == 8192 * spec["sp"] // world for r in results)
    assert all(r["iteration"] == spec["samples"] for r in results)
    assert [r["tile_base"] for r in results] == [(r["offset"] // tmk.TILE) for r in results]
    if spec["sp"] == 1:
        assert torch.equal(got, single)
    else:
        np.testing.assert_allclose(got.numpy(), single.numpy(), rtol=1e-5, atol=1e-6)


def test_sharded_megakernel_misaligned_shards_decorrelate(world4):
    """dp shards smaller than one TILE (64×64 over dp = 4: 1024 px each) draw
    distinct tile bases, dp · ceil(local / TILE), and their images are not
    the single-device one; the noise of neighbouring shards (two seeds'
    difference) does not correlate (tests/test_parallel.py's bound)."""
    a, b = _frame(world4["misaligned-seed0"]), _frame(world4["misaligned-seed123"])
    assert [r["tile_base"] for r in world4["misaligned-seed0"]] == [0, 1, 2, 3]
    single = _single_pallas(SMALL, RenderConfig(trace_depth=2), 2)
    assert torch.isfinite(a).all() and a.max() > 0 and not torch.equal(a, single)
    noise = (a - b).numpy().reshape(4, -1)
    for s in range(3):
        ra, rb = noise[s], noise[s + 1]
        corr = float(ra @ rb / (np.linalg.norm(ra) * np.linalg.norm(rb)))
        assert abs(corr) < 0.5, f"shards {s},{s + 1} correlated: {corr}"


# ── (d) the sharded eager step against JAX render_chunk_sharded ──


@pytest.mark.parametrize("dp", [0, 1, 3])
@pytest.mark.parametrize("stream", ["bounce_uniforms", "nee_uniforms", "pixel_jitter",
                                    "hash_bounce_uniforms", "ld_bounce_uniforms"])
def test_folded_key_streams_are_bit_exact(stream, dp):
    """The key of dp rank ``dp``, ``fold_in(PRNGKey(3), dp)``, and every
    kind of stream drawn from it (threefry from both words, the counter hash
    and the LD lattice from the last word), bit for bit with jax.random."""
    jkey = jax.random.fold_in(jrng.render_key(3), dp)
    key = trng.fold_in(trng.prng_key(3), dp)
    assert [int(k) for k in key] == np.asarray(jax.random.key_data(jkey)).tolist()
    pix = np.arange(7, 71, dtype=np.int32)
    it, depth = 5, 2
    if stream in ("bounce_uniforms", "nee_uniforms"):
        want = getattr(jrng, stream)(jkey, jnp.int32(it), jnp.int32(depth), 64)
        got = getattr(trng, stream)(key, it, depth, 64)
    elif stream == "pixel_jitter":
        want, got = jrng.pixel_jitter(jkey, jnp.int32(it), 64), trng.pixel_jitter(key, it, 64)
    elif stream == "hash_bounce_uniforms":
        want = jrng.hash_bounce_uniforms(jkey, jnp.int32(it), jnp.int32(depth), jnp.asarray(pix))
        got = trng.hash_bounce_uniforms(key, it, depth, torch.from_numpy(pix))
    else:
        want = jrng.ld_bounce_uniforms(jkey, jnp.int32(it), jnp.asarray(pix), 1)
        got = trng.ld_bounce_uniforms(key, it, torch.from_numpy(pix), 1)
    np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                  np.asarray(want, np.float32).view(np.uint32))
    # the plain seed stays the shorthand for its key
    assert [int(k) for k in trng.as_key(3)] == [int(k) for k in trng.prng_key(3)]


def test_sharded_fast_step_matches_jax(world4):
    """make_sharded_step at sp = 2, dp = 2 (CORNELL_SMALL, depth 3, 4 spp,
    seed 3) against JAX render_chunk_sharded on a 4-device CPU mesh of the
    same shape."""
    spec = CASES4["fast"]
    jscene = JScene.from_desc(jparse(CORNELL_SMALL))
    jmesh = jmake_mesh(4, sample_parallel=2, devices=jax.devices()[:4])
    want = jrender_chunk_sharded(jscene, JState.create(jscene.camera.pixel_count, seed=3),
                                 JConfig(trace_depth=3), 4, jmesh)
    got = _frame(world4["fast"])
    assert all(r["iteration"] == spec["samples"] for r in world4["fast"])
    assert all(r["local_rows"] == 2048 for r in world4["fast"])
    assert_within_oracle_tolerance(got.numpy(), np.asarray(want.accum))


# ── (e) the sharded mesh pipeline ──


@pytest.mark.parametrize("case", ["tri", "tri-dof-nee"])
def test_sharded_mesh_step_matches_single_device(case, world4):
    """dp = 4 slices of tri_scene through trace_sample_mesh (antialias; with
    the lens and NEE) against the single-device render."""
    from cosc_4397_pathtracing_raytracing_project_tpu_torch.ops.lights import make_light_sampler

    spec = CASES4[case]
    config = spec["config"]
    scene = Scene.from_desc(scene_desc(spec["scene"]), "cpu")
    cluster = make_mesh_intersector(scene)
    sampler = make_light_sampler(scene) if config.nee else None
    single = sum(fast.trace_sample_mesh(scene, config, 0, 1 + i, cluster, light_sampler=sampler)
                 for i in range(spec["samples"]))
    got = _frame(world4[case])
    assert torch.isfinite(got).all() and got.max() > 0
    np.testing.assert_allclose(got.numpy(), single.numpy(), rtol=3e-7, atol=1e-7)


# ── (f) AdaptiveRenderer(mesh=) ──


@pytest.mark.parametrize("world", [2, 4])
def test_sharded_adaptive_is_bit_for_bit(world, world2, world4):
    """The tile dispatch split over the ranks against the unsharded
    renderer, the same calls: both half-buffers (but the trash slot), the
    counts and every selection bit for bit, on every rank. World 4 renders
    3 tiles with quantum 2, so the warm-up and the round pad with the trash
    tile; world 2 refines a quarter and then half of 4 tiles."""
    results = (world2 if world == 2 else world4)["adaptive"]
    spec = (CASES2 if world == 2 else CASES4)["adaptive"]
    assert len({tuple(r["digest"]) for r in results}) == 1
    ref = AdaptiveRenderer(scene_desc(spec["scene"]), spec["config"], device="cpu")
    ref.warmup(spec["warmup"])
    sels = [ref.refine(spp, frac) for spp, frac in spec["rounds"]]
    got = results[0]
    n = ref._n
    assert torch.equal(got["acc_a"][:n], ref._acc_a[:n])
    assert torch.equal(got["acc_b"][:n], ref._acc_b[:n])
    assert torch.equal(got["counts"], ref._counts)
    np.testing.assert_array_equal(got["image"], ref.linear_image())
    for r in results:
        assert [s.tolist() for s in r["selections"]] == [s.tolist() for s in sels]
    if world == 4:
        assert ref.num_tiles == 3
        # 4 tile slots a dispatch (one trash tile), twice
        assert got["lanes"] == 2 * (2 * 4 + 1 * 4) * tmk.TILE
    else:
        assert [len(s) for s in sels] == [1, 2]


# ── (g) the dry run, and no fallback ──


def test_dryrun_multichip(groups):
    """Four ranks, sp = 2, dp = 2: one step of each sharded path (the
    adaptive leg pads with the trash tile)."""
    out = groups["dryrun"]
    assert (out["sp"], out["dp"]) == (2, 2)
    assert set(out["means"]) == {"xla", "megakernel(sobol)", "mesh", "adaptive"}
    assert all(np.isfinite(v) and v > 0 for v in out["means"].values())


def test_a_failing_rank_fails_the_run():
    """Rank 1 raises while rank 0 waits for it in a collective: the run
    raises with rank 1's traceback at once and stops rank 0."""
    t0 = time.perf_counter()
    with pytest.raises(RuntimeError, match="rank 1 fails on purpose"):
        spawn_ranks(run_cases, 2, "gloo", "cpu", args=(1, [dict(kind="fail", rank=1)]),
                    timeout=120)
    assert time.perf_counter() - t0 < 60


def test_no_fallback_backend_or_device(tmp_path):
    """The backend and the device are the caller's: an unknown backend, NCCL
    without a card and a CUDA device that is not there raise, nothing
    falls back to gloo or to the CPU."""
    with pytest.raises(ValueError, match="backend"):
        spawn_ranks(run_cases, 2, "mpi", "cpu", args=(1, []))
    with pytest.raises(ValueError, match="nccl needs a CUDA device"):
        start_rank("nccl", 0, 1, str(tmp_path / "rdv"), "cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            start_rank("gloo", 0, 1, str(tmp_path / "rdv"), "cuda")
    assert not torch.distributed.is_initialized()
    with pytest.raises(RuntimeError, match="process group"):
        tmesh.make_mesh()
