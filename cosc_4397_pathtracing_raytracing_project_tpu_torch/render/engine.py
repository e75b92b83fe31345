"""Render configuration, the megakernel step and the host-side Renderer.

Port of the JAX package's ``render/engine.py`` for analytic scenes: a batch
of samples is rendered by :func:`make_pallas_step`, which launches the
megakernel (``ops/cuda/megakernel.py``) once for every ``PALLAS_CHUNK``
samples and adds each ``[N, 3]`` radiance sum into the accumulator. The
pipeline keeps its JAX name, ``"pallas"``, so configurations carry over
unchanged; it carries every estimator option of the megakernel (NEE,
refraction, depth of field, early exit, throughput gathering, and the
environment map in ``'exact'`` and ``'split'`` mode). Options the port does
not carry yet raise ``NotImplementedError`` naming their ROADMAP item.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from ..ops import tonemap
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
        """``"pallas"`` (the megakernel) where the JAX package picks it on
        its accelerator (`engine.py:161-210`): analytic scenes, and scenes
        with an environment map in ``'split'`` mode, or in ``'exact'`` mode
        when the map fits ``MAX_ENV_EXACT_TEXELS`` with ``light_only``
        gathering and, under ``nee``, no analytic emitter. Where the JAX
        package takes its fast pipeline instead, raises
        ``NotImplementedError`` naming ROADMAP item 10; for every other
        pipeline and option outside the port, ``NotImplementedError`` naming
        its item; ``ValueError`` where the JAX kernel raises one (``nee``
        or ``env_mode='split'`` with the throughput estimator)."""
        if self.sampler not in ("independent", "sobol"):
            raise ValueError(f"unknown sampler {self.sampler!r}")
        if self.env_mode not in ("exact", "split"):
            raise ValueError(f"unknown env_mode {self.env_mode!r}")
        if self.pipeline not in ("auto", "pallas"):
            raise NotImplementedError(
                f"pipeline={self.pipeline!r} is not ported yet (ROADMAP Queue 1 "
                "items 9 'reference', 10 'fast', 12 'fast_mesh')"
            )
        if self.intersector == "bvh":
            raise NotImplementedError(
                "intersector='bvh' is not ported yet (ROADMAP Queue 1 item 12)"
            )
        if self.intersector not in ("auto", "bruteforce"):
            raise ValueError(f"unknown intersector {self.intersector!r}")
        defaults = RenderConfig()
        for field in (
            "bvh_leaf_size", "mesh_ray_sort", "mesh_sort_every",
            "mesh_sort_fused", "mesh_sort_cells",
        ):
            if getattr(self, field) != getattr(defaults, field):
                raise NotImplementedError(
                    f"{field} is a mesh-pipeline option, not ported yet "
                    "(ROADMAP Queue 1 item 12)"
                )
        if self.nee and self.gather_mode != "light_only":
            raise ValueError("nee requires gather_mode='light_only'")
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
    of all of a step's iterations are built once, before its first launch,
    and each launch reads its slice."""
    packed_key = packed = opts = None

    def step(scene: Scene, state: RenderState, config: RenderConfig, num_samples: int):
        nonlocal packed_key, packed, opts
        if packed_key is None or packed_key[0] is not scene or packed_key[1] != config:
            opts = megakernel.kernel_options(config, scene)
            packed_key = (scene, config)
            packed = megakernel.pack_scene(scene, nee=opts.nee, config=config)
        rows = None
        if opts.env_nee:
            rows = megakernel.build_env_nee_rows(
                scene.envmap, state.seed, state.iteration + 1, num_samples, config.trace_depth
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
    CUDA device runs the CUDA megakernel, ``"cpu"`` its plain PyTorch
    version; a missing CUDA device raises."""

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
        config.resolve_pipeline(self.scene)
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
