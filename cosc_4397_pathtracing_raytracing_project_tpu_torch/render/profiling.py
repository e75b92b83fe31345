"""Profiling & tracing utilities.

Port of the JAX package's ``render/profiling.py``. The reference brackets
each of its kernels with CUDA events and prints per-stage milliseconds
(`pathtrace.cu:539-547,632-646`). ``profile_stages`` times the readable
pipeline's stages one by one, ``profile_pipeline`` the production pipeline a
configuration resolves to, and ``trace`` records a ``torch.profiler`` trace.

The JAX version wraps each stage in ``jax.jit``; here each function is called
as it is (eager torch, or a CUDA kernel behind its wrapper). Times are host
clock around the calls, after a warm-up call, with the scene's device
synchronised before and after on a CUDA device (nothing to wait for on the
CPU).
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import time
from typing import Dict

import torch

from ..ops import camera as camera_ops
from ..ops import rng as rng_ops
from ..ops.intersect import intersect_scene
from ..ops.shade import init_paths, shade_step
from ..scene.structs import Scene


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _time(fn, *args, device: torch.device, reps: int = 10) -> float:
    """Milliseconds a call of ``fn(*args)``, the mean of ``reps`` after one
    warm-up call."""
    fn(*args)
    _sync(device)
    t0 = time.perf_counter()
    for _ in range(reps):
        fn(*args)
    _sync(device)
    return (time.perf_counter() - t0) / reps * 1e3


def profile_stages(scene: Scene, config, seed: int = 0, reps: int = 10) -> Dict[str, float]:
    """Per-stage milliseconds for one full-frame bounce of the readable
    pipeline, on the scene's device: the reference's raygen/intersect/shade
    breakdown (`pathtrace.cu:642-645`)."""
    dev = scene.device
    n = scene.camera.pixel_count

    def raygen():
        return camera_ops.generate_rays(scene.camera)

    def isect(o, d):
        return intersect_scene(scene, o, d)

    def rng_fn(it):
        return rng_ops.bounce_uniforms(seed, it, 0, n, dev)

    def shade(p, h, u):
        return shade_step(
            p, h, scene.materials, u, 1, config.rr_start_depth,
            gather_mode=config.gather_mode, sky_strength=config.sky_strength,
        )

    def gather(acc, c):
        return acc + c

    o, d = raygen()
    hit = isect(o, d)
    paths = init_paths(o, d, config.trace_depth)
    u = rng_fn(1)
    acc0 = torch.zeros((n, 3), dtype=torch.float32, device=dev)
    return {
        "raygen_ms": _time(raygen, device=dev, reps=reps),
        "rng_ms": _time(rng_fn, 1, device=dev, reps=reps),
        "intersect_ms": _time(isect, o, d, device=dev, reps=reps),
        "shade_ms": _time(shade, paths, hit, u, device=dev, reps=reps),
        "gather_ms": _time(gather, acc0, paths.color, device=dev, reps=reps),
    }


def profile_pipeline(scene: Scene, config, seed: int = 0, reps: int = 3) -> Dict[str, float]:
    """Bounce-granularity timing of the pipeline ``config`` resolves to
    (``"pallas"``: the megakernel, ``"fast_mesh"``: the mesh pipeline over
    the triangle kernels, ``"fast"`` or ``"reference"``), rendering one
    sample at increasing trace depths. Every bounce is the same work, so the
    depth slope separates the per-bounce cost from the fixed cost:

      fixed_ms          ≈ t(1) − per_bounce_ms
      per_bounce_ms     = (t(D) − t(2)) / (D − 2)

    Returns total/per-bounce/fixed milliseconds and the pipeline's name."""
    from ..ops import fast
    from ..ops.cuda import megakernel
    from .engine import make_mesh_intersector, trace_sample

    depth = max(int(config.trace_depth), 3)
    pipeline = config.resolve_pipeline(scene)
    dev = scene.device
    mesh_isect = make_mesh_intersector(scene) if pipeline == "fast_mesh" else None

    def runner(d: int):
        cfg = dataclasses.replace(config, trace_depth=d)
        if pipeline == "pallas":
            packed = megakernel.pack_scene(
                scene, nee=megakernel.kernel_options(cfg, scene).nee, config=cfg
            )
            return lambda: megakernel.render_samples(
                scene, cfg, rng_ops.kernel_seed(seed), 1, 1, packed=packed
            )
        if pipeline == "fast_mesh":
            return lambda: fast.trace_sample_mesh(scene, cfg, seed, 1, mesh_isect)
        if pipeline == "fast":
            return lambda: fast.trace_sample_fast(scene, cfg, seed, 1)
        return lambda: trace_sample(scene, cfg, seed, 1, pipeline=pipeline)

    t1 = _time(runner(1), device=dev, reps=reps)
    t2 = _time(runner(2), device=dev, reps=reps)
    td = _time(runner(depth), device=dev, reps=reps)
    # clamp: on a loaded host the deeper render can time faster than the
    # shallow one, which would report a negative marginal bounce cost
    per_bounce = max((td - t2) / max(depth - 2, 1), 0.0)
    return {
        "pipeline": pipeline,
        "depth": depth,
        "total_ms": round(td, 3),
        "bounce1_ms": round(t1, 3),
        "per_bounce_ms": round(per_bounce, 3),
        "fixed_ms": round(max(t1 - per_bounce, 0.0), 3),
    }


@contextlib.contextmanager
def trace(log_dir: str):
    """``torch.profiler`` trace of the CPU and, where there is one, the CUDA
    device, written into ``log_dir`` as a Chrome trace
    (``trace.json``, for chrome://tracing or Perfetto)."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def annotate(name: str):
    """Named region inside a trace (``torch.profiler.record_function``)."""
    return torch.profiler.record_function(name)
