"""Render configuration, the megakernel step and the host-side Renderer.

Port of the JAX package's ``render/engine.py`` for the main path: a batch of
samples is rendered by :func:`make_pallas_step`, which launches the
megakernel (``ops/cuda/megakernel.py``) once for every ``PALLAS_CHUNK``
samples and adds each ``[N, 3]`` radiance sum into the accumulator. The
pipeline keeps its JAX name, ``"pallas"``, so configurations carry over
unchanged. Options the port does not carry yet raise ``NotImplementedError``
naming their ROADMAP item.
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
    gather_mode: str = "light_only"  # 'throughput' is not ported yet
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
        """``"pallas"`` (the megakernel) for the analytic scenes this port
        renders. Raises ``NotImplementedError`` for every pipeline and
        option outside it, naming the ROADMAP item that brings it."""
        if self.sampler not in ("independent", "sobol"):
            raise ValueError(f"unknown sampler {self.sampler!r}")
        if self.env_mode not in ("exact", "split"):
            raise ValueError(f"unknown env_mode {self.env_mode!r}")
        if self.pipeline not in ("auto", "pallas"):
            raise NotImplementedError(
                f"pipeline={self.pipeline!r} is not ported yet (ROADMAP Queue 1 "
                "items 9 'reference', 10 'fast', 12 'fast_mesh')"
            )
        if self.env_mode != "exact":
            raise NotImplementedError(
                "env_mode='split' is not ported yet (ROADMAP Queue 1 item 11, "
                "kernel K5)"
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
        megakernel.kernel_options(self)  # raises for the estimator options
        return "pallas"


# Samples per megakernel launch.
PALLAS_CHUNK = 50


def make_pallas_step():
    """Step function driving the megakernel: ``step(scene, state, config,
    num_samples) -> state``. It launches the kernel once for every
    ``PALLAS_CHUNK`` samples (iterations are 1-based, as in the reference)
    and adds each radiance sum into a new accumulator. The scene's host
    tables are read once per scene object (``set_camera`` replaces the
    scene, which repacks them)."""
    packed_scene = packed = None

    def step(scene: Scene, state: RenderState, config: RenderConfig, num_samples: int):
        nonlocal packed_scene, packed
        if scene is not packed_scene:
            packed_scene, packed = scene, megakernel.pack_scene(scene)
        accum = state.accum
        done = 0
        while done < num_samples:
            k = min(PALLAS_CHUNK, num_samples - done)
            accum = accum + megakernel.render_samples(
                scene,
                config,
                state.seed,
                state.iteration + 1 + done,
                k,
                packed=packed,
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
            # nonzero aperture (and then raises: not ported yet)
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
