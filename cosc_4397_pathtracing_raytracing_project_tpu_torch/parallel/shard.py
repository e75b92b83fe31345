"""Multi-device render steps over a ``('sp', 'dp')`` mesh, one process per rank.

Port of the JAX package's ``parallel/shard.py`` (``shard_map`` bodies become
the rank's own code). Each ``dp`` rank traces a contiguous slice of the flat
pixel array; each ``sp`` rank traces a disjoint subset of the sample
iterations for those pixels, and the ranks' partial sums are combined with
one all-reduce over ``sp``. The scene is replicated; each rank keeps its
accumulator slice ``[N/dp, 3]`` for the state's whole life, and
:func:`~.mesh.gather_pixels` assembles the frame when the caller asks for it.

- :func:`make_sharded_step`: the eager per-sample pipelines
  (:func:`render.engine.trace_sample`); a ``dp`` rank draws its threefry
  streams from the render key folded with its ``dp`` index, as the JAX step
  does (``fold_in(key, dp)``).
- :func:`make_sharded_pallas_step`: the megakernel on the rank's pixel slice;
  its hash tiles start at ``dp · ceil(local / TILE)``, so a TILE-aligned
  slice renders exactly the single-device frame's pixels.
- :func:`make_sharded_mesh_step`: the triangle-mesh pipeline, whose streams
  are keyed by global pixel id.
- :func:`render_tiles_sharded`: the adaptive sampler's tile dispatch over all
  ranks at once.

Each step closure derives what is static (the packed scene and its light,
sun and SH tables, the mesh intersector, the light sampler) once, from the
scene it was made for.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from ..ops.cuda import megakernel
from ..render.engine import PALLAS_CHUNK, RenderConfig, trace_sample
from ..render.state import RenderState
from ..scene.structs import Scene
from . import mesh as mesh_ops


def _resolve_dof(scene: Scene, config: RenderConfig) -> RenderConfig:
    """Resolve ``config.dof=None`` (auto) to a concrete bool, the rule the
    Renderer applies (on iff the camera's aperture > 0)."""
    if getattr(config, "dof", None) is None:
        config = dataclasses.replace(config, dof=bool(float(scene.camera.aperture) > 0.0))
    return config


def _shard_extents(scene: Scene, num_samples: int, mesh):
    """(local_pixels, local_samples) after validating divisibility."""
    n_total = scene.camera.pixel_count
    n_sp, n_dp = mesh.size(0), mesh.size(1)
    if n_total % n_dp != 0:
        raise ValueError(f"pixel count {n_total} not divisible by dp={n_dp}")
    if num_samples % n_sp != 0:
        raise ValueError(f"num_samples {num_samples} not divisible by sp={n_sp}")
    return n_total // n_dp, num_samples // n_sp


def _run_sharded(body: Callable, scene: Scene, state: RenderState, mesh,
                 num_samples: int) -> RenderState:
    """Common wiring: ``body(offset, local_pixels, iter_base, local_samples,
    dp)`` returns the rank's [local_pixels, 3] partial sum of its
    ``local_samples`` iterations from ``iter_base``; the ``sp`` ranks' sums
    are added and the result joins the rank's accumulator slice. A state
    whose accumulator holds the full frame is cut to the rank's slice first
    (as the JAX step reshards it)."""
    local_pixels, local_samples = _shard_extents(scene, num_samples, mesh)
    offset, _ = mesh_ops.pixel_sharding(mesh, scene.camera.pixel_count)
    sp, dp = mesh_ops.mesh_coords(mesh)
    accum = state.accum
    if accum.shape[0] == scene.camera.pixel_count:
        accum = accum[offset:offset + local_pixels]
    elif accum.shape[0] != local_pixels:
        raise ValueError(f"accumulator of {accum.shape[0]} pixels is neither the frame "
                         f"({scene.camera.pixel_count}) nor the rank's slice ({local_pixels})")
    iter_base = state.iteration + 1 + sp * local_samples
    partial = body(offset, local_pixels, iter_base, local_samples, dp)
    partial = mesh_ops.sum_over_samples(mesh, partial)
    return dataclasses.replace(state, accum=accum + partial,
                               iteration=state.iteration + num_samples)


def render_chunk_sharded(
    scene: Scene,
    state: RenderState,
    config: RenderConfig,
    num_samples: int,
    mesh,
    intersector: Optional[Callable] = None,
    light_sampler=None,
    pipeline: Optional[str] = None,
) -> RenderState:
    """Accumulate ``num_samples`` samples through the eager per-sample
    pipelines, sharded over the mesh: ``num_samples`` must divide by the sp
    extent and the pixel count by the dp extent. A dp rank's streams come
    from ``fold_in(PRNGKey(seed), dp)``, bit for bit the JAX step's."""
    from ..ops import rng

    if pipeline is None:
        pipeline = config.resolve_pipeline(scene)

    def body(offset, local_pixels, iter_base, local_samples, dp):
        tile_key = rng.fold_in(rng.as_key(state.seed), dp)
        acc = torch.zeros((local_pixels, 3), dtype=torch.float32, device=scene.device)
        for i in range(local_samples):
            acc = acc + trace_sample(
                scene, config, tile_key, iter_base + i, intersector,
                pixel_offset=offset, num_pixels=local_pixels,
                light_sampler=light_sampler, pipeline=pipeline,
            )
        return acc

    return _run_sharded(body, scene, state, mesh, num_samples)


def make_sharded_step(
    scene: Scene,
    config: RenderConfig,
    num_samples: int,
    mesh,
    intersector: Optional[Callable] = None,
):
    """``step(scene, state) -> state`` over :func:`render_chunk_sharded`,
    with the NEE light sampler and the pipeline derived here, once."""
    config = _resolve_dof(scene, config)
    light_sampler = None
    if getattr(config, "nee", False):
        from ..ops.lights import make_light_sampler

        light_sampler = make_light_sampler(scene)
        if light_sampler is None and scene.envmap is None:
            raise ValueError(
                "config.nee=True but the scene has no emissive analytic "
                "(cube/sphere) lights and no ENVIRONMENT map to sample"
            )
    pipeline = config.resolve_pipeline(scene)

    def step(scene: Scene, state: RenderState) -> RenderState:
        return render_chunk_sharded(scene, state, config, num_samples, mesh, intersector,
                                    light_sampler, pipeline)

    return step


def shard_tile_base(local_pixels: int, dp: int) -> int:
    """The first hash tile of dp rank ``dp``'s slice of ``local_pixels``
    pixels: ``dp · ceil(local_pixels / TILE)``. It must be unique per
    shard: ``offset // TILE`` collides when the slice is smaller than one
    TILE (two shards would then draw identical uniforms for different
    pixels); this is unique for any alignment and equals ``offset // TILE``
    when the slice is TILE-aligned."""
    return dp * -(-local_pixels // megakernel.TILE)


def render_chunk_sharded_pallas(
    scene: Scene,
    state: RenderState,
    config: RenderConfig,
    num_samples: int,
    mesh,
    packed: Optional[megakernel.PackedScene] = None,
) -> RenderState:
    """Multi-device megakernel step: each dp rank runs the megakernel on its
    contiguous pixel slice (one launch for every ``PALLAS_CHUNK`` of its
    samples, as the single-device step); sp ranks split the sample batch
    and add with one all-reduce. When the per-rank pixel count is
    TILE-aligned the result is bit for bit the single-device render's (with
    sp = 1; sp > 1 changes only the order of the float adds). Env NEE's rows
    are keyed by absolute iteration: a rank builds those of its own
    iterations. ``packed`` (``pack_scene`` of this scene) saves repacking."""
    opts = megakernel.kernel_options(config, scene, packed)
    if packed is None:
        packed = megakernel.pack_scene(scene, nee=opts.nee, config=config)
    seed = state.seed

    def body(offset, local_pixels, iter_base, local_samples, dp):
        depth = config.trace_depth
        rows = None
        if opts.env_nee:
            rows = megakernel.env_nee_rows(packed, seed, iter_base, local_samples, depth)
        acc = torch.zeros((local_pixels, 3), dtype=torch.float32, device=scene.device)
        done = 0
        while done < local_samples:
            k = min(PALLAS_CHUNK, local_samples - done)
            acc = acc + megakernel.render_samples(
                scene, config, seed, iter_base + done, k, packed=packed,
                env_rows=None if rows is None else rows[done * depth:(done + k) * depth],
                pixel_offset=offset, num_pixels=local_pixels,
                tile_base=shard_tile_base(local_pixels, dp),
            )
            done += k
        return acc

    return _run_sharded(body, scene, state, mesh, num_samples)


def make_sharded_pallas_step(scene: Scene, config: RenderConfig, num_samples: int, mesh):
    """``step(scene, state) -> state`` over
    :func:`render_chunk_sharded_pallas`; the scene's tables (and under NEE
    the light table, in split mode the suns, the SH sky and the composited
    background) are packed once, for the scene given here and every later
    call with the same scene object (another scene is packed anew)."""
    config = _resolve_dof(scene, config)
    nee = megakernel.kernel_options(config, scene).nee
    packed = (scene, megakernel.pack_scene(scene, nee=nee, config=config))

    def step(scene: Scene, state: RenderState) -> RenderState:
        nonlocal packed
        if packed[0] is not scene:
            packed = (scene, megakernel.pack_scene(scene, nee=nee, config=config))
        return render_chunk_sharded_pallas(scene, state, config, num_samples, mesh, packed[1])

    return step


def render_chunk_sharded_mesh(
    scene: Scene,
    state: RenderState,
    config: RenderConfig,
    num_samples: int,
    mesh,
    cluster_isect,
    light_sampler=None,
) -> RenderState:
    """Multi-device triangle-mesh step: each dp rank runs the sorted
    wavefront (``ops.fast.trace_sample_mesh`` over the cluster kernels) on
    its contiguous pixel slice; sp ranks split samples and add with one
    all-reduce. Every stream keys on the global pixel id, so every rank
    traces exactly the paths of the single-device render."""
    from ..ops import fast

    def body(offset, local_pixels, iter_base, local_samples, dp):
        acc = torch.zeros((local_pixels, 3), dtype=torch.float32, device=scene.device)
        for i in range(local_samples):
            acc = acc + fast.trace_sample_mesh(
                scene, config, state.seed, iter_base + i, cluster_isect,
                pixel_offset=offset, num_pixels=local_pixels, light_sampler=light_sampler,
            )
        return acc

    return _run_sharded(body, scene, state, mesh, num_samples)


def make_sharded_mesh_step(scene: Scene, config: RenderConfig, num_samples: int, mesh):
    """``step(scene, state) -> state`` over :func:`render_chunk_sharded_mesh`;
    the cluster intersector (triangle tables and visit order) and under NEE
    the light sampler are built here, once."""
    from ..render.engine import make_mesh_intersector

    config = _resolve_dof(scene, config)
    cluster = make_mesh_intersector(scene)
    light_sampler = None
    if getattr(config, "nee", False):
        from ..ops.lights import make_light_sampler

        light_sampler = make_light_sampler(scene)
        if light_sampler is None:
            raise ValueError(
                "config.nee=True but the scene has no emissive analytic "
                "(cube/sphere) lights to sample"
            )

    def step(scene: Scene, state: RenderState) -> RenderState:
        return render_chunk_sharded_mesh(scene, state, config, num_samples, mesh, cluster,
                                         light_sampler)

    return step


def render_tiles_sharded(
    scene: Scene,
    config: RenderConfig,
    seed: int,
    tile_ids: torch.Tensor,
    iter_bases: torch.Tensor,
    px: torch.Tensor,
    py: torch.Tensor,
    num_samples: int,
    mesh,
    packed: Optional[megakernel.PackedScene] = None,
) -> torch.Tensor:
    """The megakernel's tile dispatch (:func:`megakernel.render_tiles`,
    kernel K6) sharded over the selected-tile axis: rank ``r`` of the
    flattened ``('sp', 'dp')`` mesh runs the contiguous ``K / ranks`` tiles
    ``r·K/ranks ..`` (tiles are independent work items whose identity is
    data), then every rank gathers all tiles' radiance, [K·TILE, 3], so all
    ranks scatter the same data and keep the same accumulators (the JAX
    dispatch leaves its output sharded). Bit for bit the single-device
    dispatch: each tile sees the same (seed, tile id, iteration base, px,
    py). K must divide by the mesh's rank count (the adaptive driver rounds
    its selection up to guarantee this)."""
    n_dev = mesh.size()
    k = tile_ids.shape[0]
    if k % n_dev != 0:
        raise ValueError(f"selected tile count {k} not divisible by {n_dev} devices")
    per = k // n_dev
    sp, dp = mesh_ops.mesh_coords(mesh)
    pos = sp * mesh.size(1) + dp
    tiles = slice(pos * per, (pos + 1) * per)
    lanes = slice(pos * per * megakernel.TILE, (pos + 1) * per * megakernel.TILE)
    rad = megakernel.render_tiles(scene, config, seed, tile_ids[tiles], iter_bases[tiles],
                                  px[lanes], py[lanes], num_samples, packed=packed)
    return mesh_ops.gather_mesh(mesh, rad)
