#!/usr/bin/env python3
"""Measure the PyTorch/CUDA port's megakernel on one CUDA card.

    python3 scripts/torch_measure.py [--out build/torch_measure.json]

All at 800×800 on scenes/cornell.txt, depth 8, seed 0; times from CUDA
events, each kernel row 20 timed 50-sample launches after one warm-up:

- the kernel in the main configuration (sobol, no antialiasing, hoisted
  primary), antialiased (the golden leg's), and with the independent sampler;
- the same source built with multiply-add contraction (-fmad=true), main and
  antialiased: the control that shows how far last-ulp changes move the
  output, which the kernel-vs-plain bound of chip_smoke.py is set against;
- the plain PyTorch version's 50-sample launch, 3 runs;
- agreement at 2 spp, main and antialiased: the kernel against the plain
  version on the card, and the -fmad=true build against the default one
  (max |Δ|, share of pixels with max-channel |Δ| > 1e-3, share of
  bit-identical pixels, largest relative gap of the channel means);
- the main path: Renderer(samples_per_launch=200, sampler='sobol'), 5 laps of
  render(1000) after a warm-up step, rays/s of each;
- one render(1000) under torch.profiler: device time per kernel, and the
  device's idle share of the profiled wall;
- the card's name, power limit, SM clock and temperature after the run.

Prints the readings as one JSON object and writes it to --out.
"""

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from cosc_4397_pathtracing_raytracing_project_tpu_torch import (  # noqa: E402
    RenderConfig,
    Renderer,
    Scene,
    load_scene_desc,
)
from cosc_4397_pathtracing_raytracing_project_tpu_torch.ops.cuda import build  # noqa: E402
from cosc_4397_pathtracing_raytracing_project_tpu_torch.ops.cuda import megakernel as mk  # noqa: E402

CHUNK = 50
REPS = 20
SEED = 0
FMAD_FLAGS = tuple("-fmad=true" if f == "-fmad=false" else f for f in build.NVCC_FLAGS)


def stats(xs):
    q = np.percentile(np.asarray(xs, np.float64), [0, 25, 50, 75, 100])
    return dict(n=len(xs), min=q[0], q1=q[1], median=q[2], q3=q[3], max=q[4])


def time_launches(fn, reps):
    fn()  # warm-up
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop))
    return stats(times)


def agreement(got, want):
    diff = (got - want).abs().amax(dim=-1)
    mean_got, mean_want = got.mean(dim=0), want.mean(dim=0)
    return dict(
        max_abs=float(diff.max()),
        share_gt_1e3=float((diff > 1e-3).float().mean()),
        bit_identical=float((diff == 0).float().mean()),
        mean_rel=float(((mean_got - mean_want).abs() / mean_want.abs()).max()),
    )


def smi(query):
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=os.path.join(REPO, "build", "torch_measure.json"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_measure: no CUDA device available", file=sys.stderr)
        return 1
    device = torch.device("cuda", 0)
    out = {"card": smi("name,power.limit"), "torch": torch.__version__,
           "cuda": torch.version.cuda}

    scene = Scene.from_desc(load_scene_desc(os.path.join(REPO, "scenes", "cornell.txt")), device)
    packed = mk.pack_scene(scene)
    pix = torch.arange(packed.width * packed.height, device=device)
    configs = {
        "main": mk.kernel_options(RenderConfig(sampler="sobol")),
        "aa": mk.kernel_options(RenderConfig(sampler="sobol", antialias=True)),
        "independent": mk.kernel_options(RenderConfig()),
    }
    exact = mk.Megakernel()
    fmad = mk.Megakernel(FMAD_FLAGS)

    for name, opts in configs.items():
        out[f"kernel_{name}_ms"] = time_launches(
            lambda: exact(packed, opts, SEED, 1, CHUNK, device), REPS
        )
    for name in ("main", "aa"):
        opts = configs[name]
        out[f"kernel_{name}_fmad_ms"] = time_launches(
            lambda: fmad(packed, opts, SEED, 1, CHUNK, device), REPS
        )
        got = exact(packed, opts, SEED, 1, 2, device)
        out[f"kernel_vs_plain_{name}"] = agreement(
            got, mk.render_samples_reference(pix, packed, opts, SEED, 1, 2)
        )
        out[f"fmad_vs_exact_{name}"] = agreement(fmad(packed, opts, SEED, 1, 2, device), got)
    plain = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mk.render_samples_reference(pix, packed, configs["main"], SEED, 1, CHUNK)
        torch.cuda.synchronize()
        plain.append((time.perf_counter() - t0) * 1e3)
    out["plain_main_ms"] = stats(plain)

    renderer = Renderer(
        os.path.join(REPO, "scenes", "cornell.txt"),
        RenderConfig(samples_per_launch=200, sampler="sobol"),
        device=device,
    )
    renderer.step(200)
    walls = []
    for _ in range(5):
        renderer.reset()
        t0 = time.perf_counter()
        renderer.render(1000)
        walls.append(time.perf_counter() - t0)
    pixels = renderer.scene.camera.pixel_count
    out["main_wall_s"] = stats(walls)
    out["main_rays_per_s"] = stats([pixels * 1000 / w for w in walls])

    renderer.reset()
    torch.cuda.synchronize()
    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        t0 = time.perf_counter()
        renderer.render(1000)
        wall = time.perf_counter() - t0
    rows = [
        (e.key, e.device_time_total, e.count)
        for e in prof.key_averages()
        if e.device_type == torch.autograd.DeviceType.CUDA and e.device_time_total > 0
    ]
    busy_us = sum(r[1] for r in rows)
    out["profiled_wall_s"] = wall
    out["profiled_device_kernels"] = rows
    out["profiled_device_us"] = busy_us
    out["profiled_idle_share"] = 1.0 - busy_us * 1e-6 / wall
    out["smi_after"] = smi("clocks.current.sm,power.draw,power.limit,temperature.gpu")

    text = json.dumps(out, indent=1)
    print(text)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        f.write(text + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
