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
- the other kernel variants, 20 timed 50-sample launches each:
  cornell_golden.txt with NEE, sobol and antialiasing; cornell_glass.txt
  with a 0.3 lens (auto focus), refraction, NEE and sobol; cornell.txt with
  the throughput estimator; the tile dispatch over 16 of golden's 32×64
  tiles with NEE and sobol;
- the NEE quality leg (golden, NEE, sobol, antialias, render(1000)) and the
  adaptive leg (AdaptiveRenderer(golden, NEE + sobol).render(256)), each
  once under torch.profiler: device time per kernel and idle share;
- the environment variants on scenes/env_spheres.txt (800×800, depth 8, the
  meadow map), 20 timed 50-sample launches each: exact (independent, sobol,
  refraction), env NEE (on prebuilt rows; the build of one launch's rows
  is timed on its own), split with the background composited outside and
  with antialiasing, and the tile dispatch with the exact environment over
  16 tiles;
- the exact, env-NEE and split legs (Renderer(env_spheres).render(1000),
  samples_per_launch=200) once each under torch.profiler: device time per
  kernel, the share of device time outside the megakernel (env NEE's row
  build, the split composite's add) and the idle share;
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
    AdaptiveRenderer,
    RenderConfig,
    Renderer,
    Scene,
    load_scene_desc,
    parse_scene,
)
from cosc_4397_pathtracing_raytracing_project_tpu_torch.render.adaptive import (  # noqa: E402
    make_tile_layout,
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


def profile(fn):
    """Run ``fn`` once under torch.profiler: (device kernels [(name, device
    us, count)], profiled wall s, idle share of the wall)."""
    torch.cuda.synchronize()
    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = [
        (e.key, e.device_time_total, e.count)
        for e in prof.key_averages()
        if e.device_type == torch.autograd.DeviceType.CUDA and e.device_time_total > 0
    ]
    busy_us = sum(r[1] for r in rows)
    return rows, wall, 1.0 - busy_us * 1e-6 / wall


def outside_share(rows):
    """Share of the device time spent outside the megakernel's launches."""
    total = sum(r[1] for r in rows)
    kernel = sum(r[1] for r in rows if "pt_megakernel" in r[0])
    return 1.0 - kernel / total if total else 0.0


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
    rows, wall, idle = profile(lambda: renderer.render(1000))
    out["profiled_wall_s"] = wall
    out["profiled_device_kernels"] = rows
    out["profiled_device_us"] = sum(r[1] for r in rows)
    out["profiled_idle_share"] = idle

    def scene_text(name, aperture=None):
        text = open(os.path.join(REPO, "scenes", name)).read()
        if aperture is not None:  # as the CLI's --aperture: focal stays auto
            text = text.replace("LOOKAT", f"APERTURE    {aperture}\nLOOKAT", 1)
        return Scene.from_desc(parse_scene(text), device)

    golden = scene_text("cornell_golden.txt")
    variants = {
        "nee_aa": (golden, RenderConfig(nee=True, antialias=True, sampler="sobol")),
        "glass_dof_nee": (scene_text("cornell_glass.txt", 0.3), RenderConfig(
            enable_refraction=True, dof=True, nee=True, sampler="sobol")),
        "throughput": (scene, RenderConfig(gather_mode="throughput")),
    }
    for name, (sc, cfg) in variants.items():
        opts = mk.kernel_options(cfg)
        pk = mk.pack_scene(sc, nee=opts.nee)
        out[f"kernel_{name}_ms"] = time_launches(
            lambda: exact(pk, opts, SEED, 1, CHUNK, device), REPS
        )
    gpx, gpy, _, _ = make_tile_layout(800, 800)
    ids = torch.arange(0, 16 * 20, 20, dtype=torch.int32, device=device)
    bases = 1 + 7 * torch.arange(16, dtype=torch.int32, device=device)
    tiles = (
        torch.cat([ids, bases]),
        torch.as_tensor(gpx, device=device)[ids.long()].reshape(-1),
        torch.as_tensor(gpy, device=device)[ids.long()].reshape(-1),
    )
    opts = mk.kernel_options(RenderConfig(nee=True, sampler="sobol"))
    pk = mk.pack_scene(golden, nee=True)
    out["kernel_tiles16_ms"] = time_launches(
        lambda: exact(pk, opts, SEED, 0, CHUNK, device, tiles=tiles), REPS
    )

    golden_path = os.path.join(REPO, "scenes", "cornell_golden.txt")
    quality = Renderer(golden_path, RenderConfig(
        samples_per_launch=200, antialias=True, sampler="sobol", nee=True), device=device)
    quality.step(200)
    quality.reset()
    rows, wall, idle = profile(lambda: quality.render(1000))
    out["quality_profile"] = dict(wall_s=wall, device_kernels=rows, idle_share=idle)
    cfg_a = RenderConfig(samples_per_launch=256, sampler="sobol", nee=True)
    AdaptiveRenderer(golden_path, cfg_a, device=device).render(256)  # warm-up
    ada = AdaptiveRenderer(golden_path, cfg_a, device=device)
    rows, wall, idle = profile(lambda: ada.render(256))
    out["adaptive_profile"] = dict(wall_s=wall, device_kernels=rows, idle_share=idle)

    env_path = os.path.join(REPO, "scenes", "env_spheres.txt")
    env_scene = Scene.from_desc(load_scene_desc(env_path), device)
    env_variants = {
        "exact": RenderConfig(),
        "exact_sobol": RenderConfig(sampler="sobol"),
        "exact_refraction": RenderConfig(enable_refraction=True),
        "env_nee": RenderConfig(nee=True),
        "split": RenderConfig(env_mode="split"),
        "split_aa": RenderConfig(env_mode="split", antialias=True),
    }
    for name, cfg in env_variants.items():
        opts = mk.kernel_options(cfg, env_scene)
        pk = mk.pack_scene(env_scene, nee=opts.nee, config=cfg)
        rows = None
        if opts.env_nee:
            # the kernel alone on prebuilt rows, and the row build alone
            rows = mk.build_env_nee_rows(env_scene.envmap, SEED, 1, CHUNK, opts.trace_depth)
            out["env_nee_rows_ms"] = time_launches(
                lambda: mk.build_env_nee_rows(env_scene.envmap, SEED, 1, CHUNK,
                                              opts.trace_depth), REPS
            )
        out[f"kernel_env_{name}_ms"] = time_launches(
            lambda: exact(pk, opts, SEED, 1, CHUNK, device, env_rows=rows), REPS
        )
    opts = mk.kernel_options(RenderConfig(sampler="sobol"), env_scene)
    pk = mk.pack_scene(env_scene, config=RenderConfig(sampler="sobol"))
    out["kernel_env_tiles16_ms"] = time_launches(
        lambda: exact(pk, opts, SEED, 0, CHUNK, device, tiles=tiles), REPS
    )
    for name, cfg in (("exact", RenderConfig(samples_per_launch=200)),
                      ("env_nee", RenderConfig(samples_per_launch=200, nee=True)),
                      ("split", RenderConfig(samples_per_launch=200, env_mode="split"))):
        leg = Renderer(env_path, cfg, device=device)
        leg.step(200)
        leg.reset()
        rows, wall, idle = profile(lambda: leg.render(1000))
        out[f"env_{name}_profile"] = dict(
            wall_s=wall, device_kernels=rows, idle_share=idle,
            outside_kernel_share=outside_share(rows),
            rays_per_s=leg.scene.camera.pixel_count * 1000 / wall,
        )
    out["smi_after"] = smi("clocks.current.sm,power.draw,power.limit,temperature.gpu")

    text = json.dumps(out, indent=1)
    print(text)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        f.write(text + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
