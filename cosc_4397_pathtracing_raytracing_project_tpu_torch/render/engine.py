"""Render configuration, the step functions and the host-side Renderer.

Port of the JAX package's ``render/engine.py``. ``resolve_pipeline`` picks
what the JAX package picks on its accelerator:

- ``"pallas"``: :func:`make_pallas_step` launches the megakernel
  (``ops/cuda/megakernel.py``) once for every ``PALLAS_CHUNK`` samples and
  adds each ``[N, 3]`` radiance sum into the accumulator; it carries every
  estimator option of the megakernel (NEE, refraction, depth of field,
  early exit, throughput gathering, and the environment map in
  ``'exact'`` and ``'split'`` mode);
- ``"fast_mesh"``: :func:`make_mesh_step`, one ``ops/fast.trace_sample_mesh``
  wavefront per sample over the cluster-culled triangle kernels
  (``ops/cuda/mesh_kernel.py``);
- ``"fast"`` and ``"reference"``: :func:`render_chunk`, one
  :func:`trace_sample` per sample, which hands an analytic scene to the SoA
  wavefront (``ops/fast.trace_sample_fast``) or runs the readable pipeline
  (``ops/intersect.py`` or ``ops/bvh.py``, then ``ops/shade.py``). Both
  are eager torch, as the JAX package's are XLA code outside Pallas; the
  readable pipeline's BVH sends triangles to the kernel K7 on the card.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional

import numpy as np
import torch

from ..ops import camera as camera_ops
from ..ops import envmap as envmap_ops
from ..ops import fast, tonemap
from ..ops import rng as rng_ops
from ..ops.cuda import megakernel
from ..ops.envmap import EnvNEEInputs
from ..ops.intersect import intersect_scene
from ..ops.lights import NEEInputs
from ..ops.shade import init_paths, shade_step
from ..scene.parser import load_scene_desc
from ..scene.structs import Scene, SceneDesc
from ..utils import debug
from . import profiling
from .metrics import SNAPSHOT_ITER, MetricsTracker
from .state import RenderState


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """Render configuration: the same fields and defaults as the JAX
    package's ``RenderConfig`` (see that class for each field's meaning)."""

    trace_depth: int = 8
    antialias: bool = False  # reference has no sub-pixel jitter
    rr_start_depth: int = 3  # Russian roulette opens after this depth
    samples_per_launch: int = 10  # samples per Renderer.step
    intersector: str = "auto"  # 'bruteforce' | 'bvh' | 'auto'
    bvh_leaf_size: int = 4
    gather_mode: str = "light_only"  # 'light_only' | 'throughput' (legacy)
    sky_strength: float = 0.0  # environment strength in light_only mode
    enable_refraction: bool = False
    mesh_ray_sort: bool = True
    mesh_sort_every: int = 1
    mesh_sort_fused: bool = True
    mesh_sort_cells: int = 2
    nee: bool = False
    sampler: str = "independent"  # 'independent' | 'sobol'
    ld_depths: int = 2
    early_exit: bool = False
    dof: Optional[bool] = None  # None = auto (on iff the camera's aperture > 0)
    env_mode: str = "exact"
    env_split_suns: int = 8
    env_split_thresh: float = 32.0
    pipeline: str = "auto"

    def resolve_pipeline(self, scene: Scene) -> str:
        """The pipeline the JAX package picks on its accelerator
        (`engine.py:147-213`): ``"pallas"`` (the megakernel) for analytic
        scenes of 1 to ``megakernel.MAX_GEOMS`` (64) primitives, unless an
        environment map in ``'exact'`` mode is gathered under
        ``throughput`` or joined by analytic emitters under ``nee``: those
        take ``"fast"``. One deliberate deviation: an exact map of any size
        stays in the megakernel, where the JAX package sends maps past its
        kernel's VMEM cap of 256×512 texels to ``"fast"`` (the card reads
        the map from device memory; ``megakernel.MAX_ENV_TEXELS`` is the
        kernel's own limit, past which ``"pallas"`` raises); ``"fast_mesh"`` for scenes with
        triangles, no map and at most 64 analytic primitives (under
        ``nee`` only with ``light_only`` gathering); ``"reference"`` for
        everything else (0 or more than 64 analytic primitives, a mesh with
        a map, ``intersector='bvh'`` on an analytic scene). A pipeline asked
        for by name is taken when it can render the scene. ``ValueError``
        for unknown values, for a named pipeline that cannot render the
        scene, and where the JAX code raises one (``nee`` or
        ``env_mode='split'`` with the throughput estimator)."""
        if self.sampler not in ("independent", "sobol"):
            raise ValueError(f"unknown sampler {self.sampler!r}")
        if self.env_mode not in ("exact", "split"):
            raise ValueError(f"unknown env_mode {self.env_mode!r}")
        if self.gather_mode not in ("light_only", "throughput"):
            raise ValueError(f"unknown gather_mode {self.gather_mode!r}")
        if self.pipeline not in PIPELINES:
            raise ValueError(f"unknown pipeline {self.pipeline!r} (one of {PIPELINES})")
        if self.intersector not in ("auto", "bruteforce", "bvh"):
            raise ValueError(f"unknown intersector {self.intersector!r}")
        if self.nee and self.gather_mode != "light_only":
            raise ValueError("nee requires gather_mode='light_only'")
        pipeline = self.pipeline if self.pipeline != "auto" else self._auto_pipeline(scene)
        if pipeline == "pallas":
            if not fast.supports(scene):
                raise ValueError(
                    f"pipeline='pallas' renders analytic scenes of 1 to {megakernel.MAX_GEOMS} "
                    "primitives"
                )
            megakernel.kernel_options(self, scene)  # raises for invalid estimator options
        elif pipeline == "fast_mesh":
            if not scene.num_triangles:
                raise ValueError("pipeline='fast_mesh' needs a scene with triangles")
            if not fast.supports_mesh(scene):
                raise ValueError(
                    "pipeline='fast_mesh' renders mesh scenes without an environment map "
                    f"and with at most {fast.MAX_UNROLL} analytic primitives"
                )
        elif pipeline == "fast" and not fast.supports(scene):
            raise ValueError(
                f"pipeline='fast' renders analytic scenes of 1 to {fast.MAX_UNROLL} primitives"
            )
        return pipeline

    def _auto_pipeline(self, scene: Scene) -> str:
        """The JAX ``resolve_pipeline``'s choice for ``pipeline='auto'`` on
        its accelerator."""
        # an exact map of any size stays in the megakernel under light_only,
        # and, under nee, when the scene has no analytic emitter (whose
        # combined NEE with the map runs on the fast pipeline)
        env_ok_exact = False
        if (scene.envmap is not None and self.env_mode == "exact"
                and self.gather_mode == "light_only"):
            env_ok_exact = not self.nee or megakernel.static_light_table(scene) is None
        env_free = scene.envmap is None or self.env_mode == "split" or env_ok_exact
        if self.nee:
            if self.gather_mode == "light_only" and fast.supports(scene):
                return "pallas" if env_free else "fast"
            if self.gather_mode == "light_only" and fast.supports_mesh(scene):
                return "fast_mesh"
            return "reference"
        if self.intersector in ("auto", "bruteforce") and fast.supports(scene):
            return "pallas" if env_free else "fast"
        if fast.supports_mesh(scene):
            return "fast_mesh"
        return "reference"

    def resolve_intersector(self, scene: Scene) -> str:
        """The reference pipeline's intersector: brute force up to 64
        primitives (triangles included), the BVH past them."""
        if self.intersector != "auto":
            return self.intersector
        count = scene.cubes.count + scene.spheres.count + scene.num_triangles
        return "bruteforce" if count <= 64 else "bvh"


PIPELINES = ("auto", "pallas", "fast", "reference", "fast_mesh")


def make_intersector(scene: Scene, config: RenderConfig) -> Callable:
    """The reference pipeline's intersector, ``isect(scene, origins,
    directions) -> Hit``: ``ops.intersect.intersect_scene``, or a
    ``BVHIntersector`` with leaf size ``config.bvh_leaf_size``."""
    kind = config.resolve_intersector(scene)
    if kind == "bruteforce":
        return intersect_scene
    from ..ops import bvh as bvh_mod

    return bvh_mod.make_bvh_intersector(scene, leaf_size=config.bvh_leaf_size)


def trace_sample(
    scene: Scene,
    config: RenderConfig,
    seed,
    iteration: int,
    intersector: Optional[Callable] = None,
    pixel_offset: int = 0,
    num_pixels: Optional[int] = None,
    light_sampler=None,
    pipeline: Optional[str] = None,
) -> torch.Tensor:
    """One sample of pixels [pixel_offset, pixel_offset + N): the [N, 3]
    radiance (light_only) or terminal throughput (throughput mode). Without
    an ``intersector``, a scene that resolves to ``"fast"`` or ``"pallas"``
    takes the SoA wavefront (``ops.fast.trace_sample_fast``, the
    megakernel's per-sample twin); otherwise the readable pipeline runs:
    raygen, then per bounce ``intersector`` (``intersect_scene`` by
    default) and ``shade_step``, with area-light NEE when a
    ``light_sampler`` is given and environment NEE on a scene with a map,
    under ``config.nee``. ``seed`` is the JAX base key: a key ``(k0, k1)``
    (``ops.rng.fold_in`` of a render key, as the multi-device step folds in
    its pixel shard), or the render seed as the shorthand for
    ``PRNGKey(seed)``; ``iteration`` is the 1-based sample index.
    ``pipeline`` is ``config.resolve_pipeline(scene)``, resolved here when
    not given: under ``nee`` with an exact map that resolution reads the
    scene's light table back to the host, so a caller that renders many
    samples resolves it once and passes it."""
    if pipeline is None:
        pipeline = config.resolve_pipeline(scene)
    if config.nee and pipeline not in ("reference", "fast", "pallas"):
        raise ValueError(
            "nee at per-sample granularity needs the 'reference' or 'fast' "
            f"pipeline (resolved {pipeline!r})"
        )
    if intersector is None and pipeline in ("fast", "pallas"):
        return fast.trace_sample_fast(scene, config, seed, iteration, pixel_offset, num_pixels,
                                      light_sampler=light_sampler)

    cam = scene.camera
    n = num_pixels if num_pixels is not None else cam.pixel_count
    dev = cam.position.device
    isect = intersector if intersector is not None else intersect_scene
    env = scene.envmap
    use_area_nee = config.nee and light_sampler is not None
    use_env_nee = config.nee and env is not None
    use_nee = use_area_nee or use_env_nee
    if config.nee and not use_nee:
        raise ValueError(
            "config.nee=True needs a light_sampler (ops.lights.make_light_sampler "
            "on the scene; the Renderer builds one) or an ENVIRONMENT map"
        )

    # sampler='sobol': the first-vertex dimensions and the leading ld_depths
    # bounces draw from per-pixel LD lattices, keyed by global pixel id
    use_ld = config.sampler == "sobol"
    pix = pixel_offset + torch.arange(n, dtype=torch.int64, device=dev)
    jitter = lens = None
    if config.antialias:
        jitter = (rng_ops.ld_pixel_jitter(seed, iteration, pix) if use_ld
                  else rng_ops.pixel_jitter(seed, iteration, n, dev))
    if config.dof:
        lens = (rng_ops.ld_lens_uniforms(seed, iteration, pix) if use_ld
                else rng_ops.lens_uniforms(seed, iteration, n, dev))
    origins, directions = camera_ops.generate_rays(
        cam, jitter, pixel_offset=pixel_offset, num_pixels=n, lens=lens
    )
    paths = init_paths(origins, directions, config.trace_depth)
    shadow = lambda o, d: isect(scene, o, d)  # noqa: E731

    # the threefry draws of every depth at once (a batch of folded keys)
    n_ld = min(config.ld_depths, config.trace_depth) if use_ld else 0
    depths = torch.arange(config.trace_depth, device=dev)
    u_all = rng_ops.bounce_uniforms(seed, iteration, depths[n_ld:], n, dev)
    nee_all = (rng_ops.nee_uniforms(seed, iteration, depths[n_ld:], n, dev)
               if use_area_nee else None)
    env_all = rng_ops.env_uniforms(seed, iteration, depths, n, dev) if use_env_nee else None
    cells_all = (rng_ops.env_cell_words(seed, iteration, depths, n, dev)
                 if use_env_nee and envmap_ops.needs_cell_words(env) else None)
    options = dict(gather_mode=config.gather_mode, sky_strength=config.sky_strength,
                   enable_refraction=config.enable_refraction, env=env)
    radiance = torch.zeros((n, 3), dtype=torch.float32, device=dev)
    # primary rays carry the delta marker: the camera has no NEE competitor
    prev_pdf = torch.full((n,), -1.0, dtype=torch.float32, device=dev)
    for d in range(config.trace_depth):
        if d < n_ld:
            uniforms = rng_ops.ld_bounce_uniforms(seed, iteration, pix, d).T
            nee_u = (rng_ops.ld_nee_bounce_uniforms(seed, iteration, pix, d)
                     if use_area_nee else None)
        else:
            uniforms = u_all[d - n_ld]
            nee_u = None if nee_all is None else nee_all[d - n_ld]
        hit = isect(scene, paths.origin, paths.direction)
        if not use_nee:
            paths, contrib = shade_step(paths, hit, scene.materials, uniforms, d,
                                        config.rr_start_depth, **options)
        else:
            nee = env_nee = None
            if use_area_nee:
                nee = NEEInputs(sampler=light_sampler, shadow_isect=shadow, uniforms=nee_u)
            if use_env_nee:
                env_nee = EnvNEEInputs(env=env, shadow_isect=shadow, uniforms=env_all[d],
                                       cell_words=None if cells_all is None else cells_all[d])
            paths, contrib, prev_pdf = shade_step(
                paths, hit, scene.materials, uniforms, d, config.rr_start_depth,
                nee=nee, prev_pdf=prev_pdf, env_nee=env_nee, **options,
            )
        radiance = radiance + contrib
    if config.gather_mode == "throughput":
        # finalGather parity: every path adds its terminal throughput product
        return paths.color
    return radiance


def render_chunk(
    scene: Scene,
    state: RenderState,
    config: RenderConfig,
    num_samples: int,
    intersector: Optional[Callable] = None,
    light_sampler=None,
    pipeline: Optional[str] = None,
) -> RenderState:
    """Accumulate ``num_samples`` full-frame samples into the state, one
    :func:`trace_sample` each, iterations ``state.iteration + 1 + i``;
    ``pipeline`` as there, resolved once for all of them."""
    if pipeline is None:
        pipeline = config.resolve_pipeline(scene)
    accum = state.accum
    for i in range(num_samples):
        accum = accum + trace_sample(scene, config, state.seed, state.iteration + 1 + i,
                                     intersector, light_sampler=light_sampler,
                                     pipeline=pipeline)
    return dataclasses.replace(state, accum=accum, iteration=state.iteration + num_samples)


# Samples per megakernel launch.
PALLAS_CHUNK = 50


def make_pallas_step():
    """Step function driving the megakernel: ``step(scene, state, config,
    num_samples) -> state``. It launches the kernel once for every
    ``PALLAS_CHUNK`` samples (iterations are 1-based, as in the reference)
    and adds each radiance sum into a new accumulator. The scene's host
    tables (with the light table under analytic NEE, and the environment's
    tables: the texel table, the split mode's suns, SH and composited
    background) are packed in full once per geometry, materials, map,
    resolution and configuration, those objects compared by identity. A
    scene that shares all of them with the packed one and differs only in
    its camera (``set_camera`` swaps the camera alone) keeps the packed
    tables and re-reads only the camera (``megakernel.with_camera``). The
    ``repack.full`` and ``repack.camera`` counters count the two. Under env
    NEE the shared rows of all of a step's iterations, with their per-geom
    table, are built once, before its first launch (on the card by one
    launch of the row kernel, ``megakernel.env_nee_rows``), and each launch
    reads its slice."""
    key = packed_scene = packed = opts = None  # key: (resolution, config, table objects)

    def step(scene: Scene, state: RenderState, config: RenderConfig, num_samples: int):
        nonlocal key, packed_scene, packed, opts
        tables = (scene.cubes, scene.spheres, scene.materials, scene.envmap, scene.triangles)
        if (key is None or key[:2] != (scene.camera.resolution, config)
                or any(a is not b for a, b in zip(key[2], tables))):
            with profiling.span("engine.repack"):
                profiling.count("repack.full")
                opts = megakernel.kernel_options(config, scene)
                packed = megakernel.pack_scene(scene, nee=opts.nee, config=config)
            key, packed_scene = (scene.camera.resolution, config, tables), scene
        elif scene is not packed_scene:
            with profiling.span("engine.repack"):
                profiling.count("repack.camera")
                packed = megakernel.with_camera(packed, scene, opts)
            packed_scene = scene
        rows = None
        if opts.env_nee:
            rows = megakernel.env_nee_rows(
                packed, state.seed, state.iteration + 1, num_samples, config.trace_depth
            )
        accum = state.accum
        done = 0
        depth = config.trace_depth
        while done < num_samples:
            k = min(PALLAS_CHUNK, num_samples - done)
            accum = accum + megakernel.render_samples(
                scene,
                config,
                state.seed,
                state.iteration + 1 + done,
                k,
                packed=packed,
                env_rows=None if rows is None else rows[done * depth:(done + k) * depth],
            )
            done += k
        return dataclasses.replace(
            state, accum=accum, iteration=state.iteration + num_samples
        )

    return step


def make_mesh_intersector(scene: Scene):
    """Cluster-culled triangle intersector over a BVH treelet partition (the
    JAX ``make_mesh_intersector``): a BVH with leaf size 8 over the
    triangles' AABBs, the triangle arrays permuted into its leaf order, the
    clusters and superclusters cut as its subtrees. Its tables live on the
    scene's device and depend on the triangles only."""
    from ..ops.bvh import try_native_build
    from ..ops.cuda.mesh_kernel import ClusterMeshIntersector

    host = lambda t: t.detach().cpu().numpy()  # noqa: E731
    tri = scene.triangles
    v0, e1, e2, mat = host(tri.v0), host(tri.e1), host(tri.e2), host(tri.material_id)
    tmin = np.minimum(np.minimum(v0, v0 + e1), v0 + e2)
    tmax = np.maximum(np.maximum(v0, v0 + e1), v0 + e2)
    bvh = try_native_build(tmin, tmax, leaf_size=8)
    order = bvh.order
    return ClusterMeshIntersector(
        v0[order], e1[order], e2[order], mat[order], bvh=bvh, device=scene.device,
    )


def make_mesh_step(scene: Scene, light_sampler=None):
    """Step function of the mesh pipeline: ``step(scene, state, config,
    num_samples) -> state`` renders one ``trace_sample_mesh`` per sample,
    iterations ``state.iteration + 1 + i``, on the render seed ``state.seed``
    (the JAX step's base key is ``PRNGKey(seed)``), and adds each into the
    accumulator. The intersector, built here from the scene's triangles and
    kept as ``step.cluster``, serves every later scene of the same
    triangles, so a camera change reuses it. ``light_sampler`` enables NEE
    when the configuration asks for it."""
    cluster = make_mesh_intersector(scene)

    def step(scene: Scene, state: RenderState, config: RenderConfig, num_samples: int):
        accum = state.accum
        for i in range(num_samples):
            accum = accum + fast.trace_sample_mesh(
                scene, config, state.seed, state.iteration + 1 + i, cluster,
                light_sampler=light_sampler,
            )
        return dataclasses.replace(state, accum=accum, iteration=state.iteration + num_samples)

    step.cluster = cluster
    return step


def _check_device(device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device} requested but no CUDA device is available; "
            "pass device='cpu' to render with the plain PyTorch version"
        )
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device}")
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


class Renderer:
    """Host-side driver: owns the device scene, render state, and metrics.

    Same lifecycle and semantics as the JAX package's ``Renderer``: a camera
    change is a state reset plus a scene update. ``device`` is explicit: a
    CUDA device runs the CUDA kernels (the megakernel, the mesh kernels of
    a scene with triangles, K7 under the reference pipeline's BVH) and the
    eager pipelines there, ``"cpu"`` the kernels' plain PyTorch versions; a
    missing CUDA device raises. A mesh scene's intersector, and the
    reference pipeline's, are built once here; ``set_camera`` keeps them
    (their tables depend on the geometry only)."""

    def __init__(
        self,
        scene,
        config: Optional[RenderConfig] = None,
        seed: int = 0,
        device="cuda",
    ):
        self.device = _check_device(device)
        if isinstance(scene, str):
            scene = load_scene_desc(scene)
        if isinstance(scene, SceneDesc):
            self.desc: Optional[SceneDesc] = scene
            self.scene = Scene.from_desc(scene, self.device)
            if config is None:
                config = RenderConfig(trace_depth=scene.trace_depth)
            self.target_iterations = scene.iterations
            self.image_name = scene.image_name
        else:
            if scene.device != self.device:
                raise ValueError(
                    f"scene lives on {scene.device}, renderer on {self.device}"
                )
            self.desc = None
            self.scene = scene
            if config is None:
                config = RenderConfig()
            self.target_iterations = 0
            self.image_name = "render"

        if config.dof is None:
            # resolve the auto gate: DOF is on exactly when the camera has a
            # nonzero aperture
            config = dataclasses.replace(
                config, dof=bool(float(self.scene.camera.aperture) > 0.0)
            )
        self.config = config
        self.state = RenderState.create(self.scene.camera.pixel_count, seed, self.device)
        self.metrics = MetricsTracker(self.scene.camera.pixel_count)
        self._host_iteration = 0
        # opt-in reference-parity PSNR snapshot (see step())
        self.psnr_snapshot = False
        self.pipeline = config.resolve_pipeline(self.scene)
        # the readable pipeline's intersector; the others carry their own
        self._intersector = None
        if self.pipeline == "reference":
            self._intersector = make_intersector(self.scene, config)
        if self.pipeline == "pallas":
            self._step = make_pallas_step()
            return
        sampler = None
        if config.nee:
            from ..ops.lights import make_light_sampler

            sampler = make_light_sampler(self.scene)
            if sampler is None and (self.pipeline == "fast_mesh" or self.scene.envmap is None):
                # emissive triangles stay BRDF-sampled; NEE needs an analytic
                # (cube/sphere) emitter or a map to aim at
                raise ValueError(
                    "config.nee=True but the scene has no emissive analytic "
                    "(cube/sphere) lights and no ENVIRONMENT map to sample"
                )
        if self.pipeline == "fast_mesh":
            self._step = make_mesh_step(self.scene, light_sampler=sampler)
        else:
            isect, pipeline = self._intersector, self.pipeline

            def step(scene, state, config, num_samples):
                return render_chunk(scene, state, config, num_samples, isect,
                                    light_sampler=sampler, pipeline=pipeline)

            self._step = step

    @property
    def iteration(self) -> int:
        return self._host_iteration

    def reset(self) -> "Renderer":
        """Clear accumulation, the iteration count and the metrics."""
        self.state = self.state.reset()
        self._host_iteration = 0
        self.metrics = MetricsTracker(self.scene.camera.pixel_count)
        return self

    def step(self, num_samples: Optional[int] = None, sync: bool = True) -> int:
        """Run a batch of samples; returns the new iteration count.

        With sync=False the work is left queued on the device (used by
        render() to avoid a host round-trip per batch). The metrics count
        the host's time in the step, and the wait in :meth:`sync`."""
        if num_samples is None:
            num_samples = self.config.samples_per_launch
        t0 = time.perf_counter()
        with profiling.span("engine.step"):
            total = num_samples
            # psnr_snapshot: split the chunk that crosses SNAPSHOT_ITER so the
            # self-PSNR baseline is a true 10-spp frame (`pathtrace.cu:184-191`)
            if (
                self.psnr_snapshot
                and self.metrics.snapshot is None
                and self._host_iteration < SNAPSHOT_ITER
                and self._host_iteration + num_samples >= SNAPSHOT_ITER
            ):
                head = SNAPSHOT_ITER - self._host_iteration
                self.state = self._step(self.scene, self.state, self.config, head)
                self._host_iteration += head
                num_samples -= head
                self.metrics.capture_snapshot(self.state.accum, self._host_iteration)
            if num_samples:
                self.state = self._step(self.scene, self.state, self.config, num_samples)
                self._host_iteration += num_samples
            if debug.nan_checks_enabled():
                debug.check_nans(self.state.accum, self._host_iteration)
        self.metrics.record(total, time.perf_counter() - t0)
        if sync:
            self.sync()
        return self.iteration

    def sync(self) -> None:
        """Wait until every queued kernel of this renderer's device is done;
        the wait counts in the metrics' render time."""
        t0 = time.perf_counter()
        with profiling.span("engine.sync"):
            profiling.count("host_syncs")
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
        self.metrics.record(0, time.perf_counter() - t0)

    def render(self, iterations: Optional[int] = None, progress: bool = False):
        """Render to `iterations` total samples (scene-file ITERATIONS by
        default), batching samples_per_launch per step."""
        target = iterations if iterations is not None else self.target_iterations
        while self.iteration < target:
            n = min(self.config.samples_per_launch, target - self.iteration)
            last = self.iteration + n >= target
            self.step(n, sync=last or progress)
            if progress:
                m = self.metrics
                print(
                    f"iter {self.iteration}/{target}  "
                    f"{m.samples_per_second / 1e6:.1f} M rays/s  "
                    f"avg {m.avg_iteration_ms:.2f} ms/iter"
                )
        return self

    # ── outputs ──

    def linear_image(self) -> np.ndarray:
        """[H, W, 3] float32 linear mean radiance."""
        w, h = self.scene.camera.resolution
        img = tonemap.mean_image(self.state.accum, self.state.iteration)
        return _read_back(img).reshape(h, w, 3)

    def display_image(self) -> np.ndarray:
        """[H, W, 3] uint8 gamma-2.2 preview frame (PBO path parity)."""
        with profiling.span("engine.display"):
            w, h = self.scene.camera.resolution
            img = tonemap.display_image(self.state.accum, self.state.iteration)
            return _read_back(img).reshape(h, w, 3)

    def denoised_image(self, **filter_kwargs) -> np.ndarray:
        """[H, W, 3] float32 linear radiance after the feature-guided
        À-Trous denoiser (``render.denoise``); keyword arguments pass
        through to ``atrous_denoise``."""
        from .denoise import denoise_image

        return denoise_image(self, **filter_kwargs)

    def save_png(self, path: Optional[str] = None, denoise: bool = False) -> str:
        """Write the PNG exactly as the reference's saveImage: linear clamp,
        no gamma, horizontal mirror, ``<name>.<timestamp>.<N>samp.png``.
        With ``denoise=True`` the accumulator mean goes through the À-Trous
        denoiser first, then is clipped, scaled by 255, mirrored and
        truncated to uint8."""
        from ..io.png import write_png
        from ..utils.timing import current_time_string

        w, h = self.scene.camera.resolution
        if denoise:
            lin = self.denoised_image()
            img = (np.clip(lin, 0.0, 1.0) * 255.0)[:, ::-1, :].astype(np.uint8)
        else:
            img = tonemap.save_image(self.state.accum, self.state.iteration, w, h).cpu().numpy()
        if path is None:
            path = f"{self.image_name}.{current_time_string()}.{self.iteration}samp.png"
        write_png(path, img)
        return path

    # ── checkpoint / resume: the accumulator, the iteration count and the
    # seed are the whole render state ──

    def save_checkpoint(self, path: str) -> str:
        from .checkpoint import save_checkpoint

        meta = {
            "image_name": self.image_name,
            "resolution": list(self.scene.camera.resolution),
            "target_iterations": self.target_iterations,
        }
        return save_checkpoint(path, self.state, meta)

    def load_checkpoint(self, path: str) -> "Renderer":
        """Continue from a checkpoint of either package; its accumulator
        moves to this renderer's device."""
        from .checkpoint import load_checkpoint

        state, _ = load_checkpoint(path, self.device)
        if state.accum.shape != self.state.accum.shape:
            raise ValueError(
                f"checkpoint resolution {tuple(state.accum.shape)} does not match "
                f"renderer {tuple(self.state.accum.shape)}"
            )
        self.state = state
        self._host_iteration = state.iteration
        return self

    # ── camera interaction (accumulation reset, `main.cpp:110-136`) ──

    def set_camera(self, camera) -> None:
        with profiling.span("engine.set_camera"):
            self.scene = self.scene.replace(camera=camera)
            self.state = self.state.reset()
            self._host_iteration = 0
            self.metrics = MetricsTracker(self.scene.camera.pixel_count)


def _read_back(img: torch.Tensor) -> np.ndarray:
    """An image's copy to the host (a wait for the device)."""
    with profiling.span("engine.readback"):
        profiling.count("host_syncs")
        return img.cpu().numpy()
