"""Render configuration, the step functions and the host-side Renderer.

Port of the JAX package's ``render/engine.py`` for analytic and
triangle-mesh scenes. An analytic scene renders through
:func:`make_pallas_step`, which launches the megakernel
(``ops/cuda/megakernel.py``) once for every ``PALLAS_CHUNK`` samples and
adds each ``[N, 3]`` radiance sum into the accumulator; the pipeline keeps
its JAX name, ``"pallas"``, and carries every estimator option of the
megakernel (NEE, refraction, depth of field, early exit, throughput
gathering, and the environment map in ``'exact'`` and ``'split'`` mode). A
scene with triangles renders through :func:`make_mesh_step`, the
``"fast_mesh"`` pipeline: one ``ops/fast.trace_sample_mesh`` wavefront per
sample over the cluster-culled triangle kernels (``ops/cuda/mesh_kernel.py``).
Options the port does not carry yet raise ``NotImplementedError`` naming
their ROADMAP item.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from ..ops import fast, tonemap
from ..ops.cuda import megakernel
from ..scene.parser import load_scene_desc
from ..scene.structs import Scene, SceneDesc
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
        scenes of 1 to ``megakernel.MAX_GEOMS`` (64) primitives, and for
        scenes with an environment map in ``'split'`` mode,
        or in ``'exact'`` mode when the map fits ``MAX_ENV_EXACT_TEXELS``
        with ``light_only`` gathering and, under ``nee``, no analytic
        emitter; ``"fast_mesh"`` for scenes with triangles (``supports_mesh``),
        under ``nee`` only with ``light_only`` gathering.
        ``pipeline="fast_mesh"`` may be asked for on such a scene. Where the
        JAX package takes its fast or reference pipeline instead, raises
        ``NotImplementedError`` naming ROADMAP item 10 or 9; for every other
        option outside the port, ``NotImplementedError`` naming its item;
        ``ValueError`` where the JAX code raises one (``nee`` or
        ``env_mode='split'`` with the throughput estimator)."""
        if self.sampler not in ("independent", "sobol"):
            raise ValueError(f"unknown sampler {self.sampler!r}")
        if self.env_mode not in ("exact", "split"):
            raise ValueError(f"unknown env_mode {self.env_mode!r}")
        if self.gather_mode not in ("light_only", "throughput"):
            raise ValueError(f"unknown gather_mode {self.gather_mode!r}")
        if self.pipeline not in ("auto", "pallas", "fast_mesh"):
            raise NotImplementedError(
                f"pipeline={self.pipeline!r} is not ported yet (ROADMAP Queue 1 "
                "items 9 'reference', 10 'fast')"
            )
        if self.intersector == "bvh":
            raise NotImplementedError(
                "intersector='bvh' is not ported yet (ROADMAP Queue 1 item 9)"
            )
        if self.intersector not in ("auto", "bruteforce"):
            raise ValueError(f"unknown intersector {self.intersector!r}")
        if self.bvh_leaf_size != RenderConfig().bvh_leaf_size:
            raise NotImplementedError(
                "bvh_leaf_size is an option of intersector='bvh', not ported yet "
                "(ROADMAP Queue 1 item 9)"
            )
        if self.nee and self.gather_mode != "light_only":
            raise ValueError("nee requires gather_mode='light_only'")
        if scene.num_triangles:
            if self.pipeline == "pallas":
                raise ValueError("pipeline='pallas' renders analytic scenes only")
            if not fast.supports_mesh(scene):
                raise NotImplementedError(
                    "a mesh scene with an environment map or more than "
                    f"{fast.MAX_UNROLL} analytic primitives runs on "
                    "pipeline='reference', which is not ported yet (ROADMAP Queue 1 item 9)"
                )
            return "fast_mesh"
        if self.pipeline == "fast_mesh":
            raise ValueError("pipeline='fast_mesh' needs a scene with triangles")
        count = scene.cubes.count + scene.spheres.count
        if not 0 < count <= megakernel.MAX_GEOMS:
            raise NotImplementedError(
                f"an analytic scene of {count} primitives (the megakernel takes 1-"
                f"{megakernel.MAX_GEOMS}) runs on pipeline='reference', which is not "
                "ported yet (ROADMAP Queue 1 item 9)"
            )
        if scene.envmap is not None and self.env_mode == "exact":
            in_kernel = self.gather_mode == "light_only" and megakernel.supports(scene)
            if in_kernel and self.nee:
                in_kernel = megakernel.static_light_table(scene) is None
            if not in_kernel:
                raise NotImplementedError(
                    "this environment-map configuration runs on pipeline='fast' "
                    "(an exact map past MAX_ENV_EXACT_TEXELS, throughput gathering, "
                    "or nee with analytic emitters), which is not ported yet "
                    "(ROADMAP Queue 1 item 10)"
                )
        megakernel.kernel_options(self, scene)  # raises for invalid estimator options
        return "pallas"


# Samples per megakernel launch.
PALLAS_CHUNK = 50


def make_pallas_step():
    """Step function driving the megakernel: ``step(scene, state, config,
    num_samples) -> state``. It launches the kernel once for every
    ``PALLAS_CHUNK`` samples (iterations are 1-based, as in the reference)
    and adds each radiance sum into a new accumulator. The scene's host
    tables (with the light table under analytic NEE, and the environment's
    tables: the split mode's suns, SH and composited background) are
    derived once per scene object and configuration (``set_camera``
    replaces the scene, which repacks them). Under env NEE the shared rows
    of all of a step's iterations, with their per-geom table, are built
    once, before its first launch (on the card by one launch of the row
    kernel, ``megakernel.env_nee_rows``), and each launch reads its slice."""
    packed_key = packed = opts = None

    def step(scene: Scene, state: RenderState, config: RenderConfig, num_samples: int):
        nonlocal packed_key, packed, opts
        if packed_key is None or packed_key[0] is not scene or packed_key[1] != config:
            opts = megakernel.kernel_options(config, scene)
            packed_key = (scene, config)
            packed = megakernel.pack_scene(scene, nee=opts.nee, config=config)
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
    from ..ops.bvh import build_bvh
    from ..ops.cuda.mesh_kernel import ClusterMeshIntersector

    host = lambda t: t.detach().cpu().numpy()  # noqa: E731
    tri = scene.triangles
    v0, e1, e2, mat = host(tri.v0), host(tri.e1), host(tri.e2), host(tri.material_id)
    tmin = np.minimum(np.minimum(v0, v0 + e1), v0 + e2)
    tmax = np.maximum(np.maximum(v0, v0 + e1), v0 + e2)
    bvh = build_bvh(tmin, tmax, leaf_size=8)
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
    CUDA device runs the CUDA kernels (the megakernel, or the mesh kernels
    of a scene with triangles), ``"cpu"`` their plain PyTorch versions; a
    missing CUDA device raises. A mesh scene's intersector is built once
    here; ``set_camera`` keeps it (its tables depend on the triangles
    only)."""

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
        if self.pipeline == "fast_mesh":
            sampler = None
            if config.nee:
                from ..ops.lights import make_light_sampler

                sampler = make_light_sampler(self.scene)
                if sampler is None:
                    # emissive triangles stay BRDF-sampled; NEE needs at
                    # least one analytic (cube/sphere) emitter to aim at
                    raise ValueError(
                        "config.nee=True but the scene has no emissive "
                        "analytic (cube/sphere) lights to sample"
                    )
            self._step = make_mesh_step(self.scene, light_sampler=sampler)
        else:
            self._step = make_pallas_step()

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
        render() to avoid a host round-trip per batch)."""
        if num_samples is None:
            num_samples = self.config.samples_per_launch
        t0 = time.perf_counter()
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
        if sync:
            self.sync()
        self.metrics.record(total, time.perf_counter() - t0)
        return self.iteration

    def sync(self) -> None:
        """Wait until every queued kernel of this renderer's device is done."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

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
        return img.cpu().numpy().reshape(h, w, 3)

    def display_image(self) -> np.ndarray:
        """[H, W, 3] uint8 gamma-2.2 preview frame (PBO path parity)."""
        w, h = self.scene.camera.resolution
        img = tonemap.display_image(self.state.accum, self.state.iteration)
        return img.cpu().numpy().reshape(h, w, 3)

    def save_png(self, path: Optional[str] = None) -> str:
        """Write the PNG exactly as the reference's saveImage: linear clamp,
        no gamma, horizontal mirror, ``<name>.<timestamp>.<N>samp.png``."""
        from ..io.png import write_png
        from ..utils.timing import current_time_string

        w, h = self.scene.camera.resolution
        img = tonemap.save_image(self.state.accum, self.state.iteration, w, h)
        if path is None:
            path = f"{self.image_name}.{current_time_string()}.{self.iteration}samp.png"
        write_png(path, img.cpu().numpy())
        return path

    # ── camera interaction (accumulation reset, `main.cpp:110-136`) ──

    def set_camera(self, camera) -> None:
        self.scene = self.scene.replace(camera=camera)
        self.state = self.state.reset()
        self._host_iteration = 0
        self.metrics = MetricsTracker(self.scene.camera.pixel_count)
