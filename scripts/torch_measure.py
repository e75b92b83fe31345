#!/usr/bin/env python3
"""Measure the PyTorch/CUDA port's kernels on one CUDA card.

    python3 scripts/torch_measure.py [--out build/torch_measure.json]
        [--legs megakernel,ab,schedule,env,rows,envgate,mesh,mesh-kernels,mesh-host,fast,
                reference,maps]
        [--parent DIR [--diag DIR,...] [--diag-edits NAME,...] [--ab-flags="-DX;-DY"]
         [--rounds N]]
        [--cases REGEX]

With ``--parent DIR`` (a parent commit's checkout, e.g. unpacked with git
archive into a git-ignored directory), the megakernel leg, or ``--legs ab``
alone, first compares that checkout's package with this one in one process,
in turns (parent, change, change, parent): one launch of every timed
variant (K1 main, antialiased and independent, K1b glass + lens + NEE and
throughput, K2 antialiased and with the adaptive leg's options, K3-K5 and
K6 over 16 tiles, with and without the environment, 50 samples each; K6 at
the adaptive legs' warm-up and round dispatches, ADAPTIVE_DISPATCH; then
each other compile-time variant of the megakernel once; the median of 20
each), and K3, K4 and K6's environment round again under the meadow map
resampled to 512x1024 and 2048x4096 (ENV_MAP_REPEATS; a parent whose kernel
caps the map takes them with its cap lifted); whether the outputs are
bit-identical to the parent's and, for a variant that adds in another
order, their share of pixels off by more than 1e-3 and largest difference,
then the main path's rays/s (render(1000), two laps a turn) and whether the
two images are bit-identical; and a census of each side's NEE variant's
SASS. Each ``--diag`` checkout (a diagnostic
build: an edited copy of a package) and each ``--ab-flags`` set (this
checkout's kernel built with those nvcc flags) joins the variants' turns,
with its ptxas registers and spills.

The environment leg (``--legs env``, not in the default): the exact, env NEE
and split legs (Renderer(env_spheres.txt, samples_per_launch=200),
render(1000)) of this checkout and, with ``--parent``, of the parent's, in
turns: rays/s of each lap, and one profiled lap each (the megakernel's
device time, the other kernels' device time and launches, the idle share);
then env NEE's row build of one step (1,600 rows) and one launch (400):
device time, host time, kernels launched.

The rows leg (``--legs rows``, not in the default): env NEE's row kernel
(``pt_env_rows``) of one 200-sample step (1,600 rows) and one 50-sample
launch under env_spheres.txt's meadow map and the map's texels repeated
4 x 4 and 16 x 16 (512x1024, 2048x4096), of this checkout and, with
``--parent``, of the parent's, in turns (parent, change, change, parent,
``--rounds`` times): the median of 20 launches (CUDA events) a turn, and
whether the two sides' rows are bit-identical.

The envgate leg (``--legs envgate``, not in the default): chip_smoke.py's
env-NEE bracket (``env_nee_bracket``: env NEE's channel means against the
exact estimator's at depth 8 and 9) on env_spheres.txt under the meadow
map at 128x256, 512x1024 and 2048x4096 (texels repeated as phase 27
repeats them), at render(1000) for seeds 0-15, then at chip_smoke's
ENV_NEE_GATE_SPP for seed 0: each seed's gaps, their mean and spread.

``--cases REGEX`` restricts the ab and schedule legs to the cases it
matches; ``--diag-edits NAME,...`` makes each diagnostic copy of
DIAG_EDITS (under build/diag_NAME) and adds it to the A/B turns.

The schedule leg (``--legs schedule``, not in the default): the megakernel's
counting build (warp iterations of the bounce loop, active lane-iterations,
iterations that ran both draw branches; warp iterations carrying visibility
rays of each kind and their rays; the passes of the light rays' queue, their
rays, the exit passes and the late rays) against the plain version's ray
counts and against megakernel.warp_schedule's emulation on the plain
version's path lengths and visibility rays, for the main configuration,
glass + lens + NEE, golden + NEE (K2), and env_spheres.txt exact, with env
NEE (K4) and split (K5), one 50-sample launch at 800×800, and the adaptive
leg's round (K6 with NEE); then a census of the main and NEE variants' SASS
(cuobjdump -sass) by instruction class, for the function and each loop in
it, and nvcc's ptxas report.

The megakernel legs (``--legs megakernel``), all at 800×800 on
scenes/cornell.txt, depth 8, seed 0; times from CUDA events, each kernel row
20 timed 50-sample launches after one warm-up:

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
  tiles with NEE and sobol, and over the adaptive leg's round (162 tile
  slots, 16 samples);
- the NEE quality leg (golden, NEE, sobol, antialias, render(1000)) and the
  adaptive leg (AdaptiveRenderer(golden, NEE + sobol).render(256)), each
  once under torch.profiler: device time per kernel and idle share;
- the environment variants on scenes/env_spheres.txt (800×800, depth 8, the
  meadow map), 20 timed 50-sample launches each: exact (independent, sobol,
  refraction), env NEE (on prebuilt rows; the build of one launch's rows,
  by the row kernel and by the torch build it replaced, is timed on its
  own), split with the background composited outside and
  with antialiasing, and the tile dispatch with the exact environment over
  16 tiles;
- the exact, env-NEE and split legs (Renderer(env_spheres).render(1000),
  samples_per_launch=200) once each under torch.profiler: device time per
  kernel, the share of device time outside the megakernel (env NEE's row
  build, the split composite's add) and the idle share;

The mesh legs (``--legs mesh``), scenes/mesh1080p.txt at 1920×1080, depth 8,
sky_strength 1.0, without and with NEE:

- K7 (and K8 with NEE) on the rays of bounce 1 of a 1-spp render, 20 timed
  launches each;
- 3 laps of Renderer.render(4) after a warm-up sample: rays/s and ms/sample;
- one render(4) under torch.profiler: device time in K7, K8, the sort and
  gathers (the radix sort, the gathers of the payloads by its permutation,
  the final scatter by pixel id, and under NEE the light table's row
  gathers) and everything else (shading, the pixel-keyed streams, the
  analytic primitives), and the device's idle share of the wall;
- channel means of render(96) without NEE at depths 8 and 9 and with NEE at
  depth 8 (the NEE depth bracket of chip_smoke.py at three times its
  samples).

The mesh-kernel leg (``--legs mesh-kernels``, not in the default): K7 on the
rays of every bounce of a 1-spp NEE render of scenes/mesh1080p.txt (seed 0),
K8 on every bounce's shadow rays, and K8 on the same shadow rays with every
live ray of the bounce active (the mask the JAX package passes), each in
each of the kernel's walks (mesh_kernel.WALKS; a package without them has
one schedule) and, in the walk the pipeline takes, built without its launch
bounds (-DPT_MESH_BOUNDS=, with both builds' ptxas register and spill
lines): the active rays, the median of 20 timed launches after one warm-up,
and the counting build's work and SIMT efficiency; then per schedule, and
for the pipeline's walks, the sums over one sample's launches. Run with
another checkout's package (the script copied into that checkout's
scripts/), it times that checkout's kernel on the same rays.

The mesh host leg (``--legs mesh-host``, not in the default), for the mesh
cell without NEE, whose wall the host sets: 5 laps of Renderer.render(4)
after a warm-up sample (ms/sample of each), twice; then the host's
microseconds per launch, each the mean over 200
launches enqueued back to back, of K7 on the last bounce's rays and of a
one-element torch add, once with the card idle and once queued behind a
50 ms spin kernel (torch.cuda._sleep), so that no launch waits for the
card. Run in two checkouts by turns, it compares their host costs.

The eager pipelines' legs (``--legs fast`` and ``--legs reference``, not
in the default), chip_smoke.py's configurations of phases 20-23: for the
fast pipeline, env_spheres.txt under throughput gathering, with an emissive
sphere under nee, and with its map resampled to 512x1024 (named 'fast'),
the golden scene (antialias, sobol) and the 'shared' model on cornell.txt;
for the reference pipeline, the golden scene, the 'naive', 'bvh' and
'wavefront' models (each compaction) on cornell.txt, and mesh1080p.txt with
the meadow map without and with NEE (triangles through K7). Each: 3 laps of
render(4) after a warm-up sample (rays/s, ms/sample), then one render(4)
under torch.profiler: torch kernels a sample, the device's idle share,
device time by part (K7, K8, sort and gathers, the rest), the 12 kernels
that took the most device time, and K7's launches a sample.

The large-map leg (``--legs maps``, not in the default): chip_smoke.py's
phase 27 alone (K3, K4 and K6 against their plain versions under the
meadow resampled to 512x1024 and 2048x4096, their times and bounds, the
exact and env NEE legs through pipeline='auto' and the adaptive leg),
then the 2048x4096 legs' device idle share three times by each of two
methods in turns: torch.profiler, and CUDA events around each kernel's
ctypes call (a lower bound).

Each leg ends with the card's name, power limit, SM clock and temperature.
Prints the readings as one JSON object and writes it to --out.
"""

import argparse
import dataclasses
import importlib
import importlib.util
import json
import os
import re
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

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
from cosc_4397_pathtracing_raytracing_project_tpu_torch.ops.cuda import mesh_kernel as mesh  # noqa: E402
from cosc_4397_pathtracing_raytracing_project_tpu_torch.ops import fast  # noqa: E402
from cosc_4397_pathtracing_raytracing_project_tpu_torch.ops.lights import (  # noqa: E402
    make_light_sampler,
)

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


def mesh_groups(rows):
    """Device microseconds of a mesh render by part: K7, K8, the sort and
    gathers (radix sort kernels, gather and index kernels) and the rest."""
    groups = {"K7": 0.0, "K8": 0.0, "sort+gathers": 0.0, "other": 0.0}
    for name, us, _count in rows:
        if "pt_mesh_intersect" in name:
            groups["K7" if ("<true>" in name or "ILb1E" in name) else "K8"] += us
        elif any(k in name.lower() for k in ("sort", "radix", "gather", "index")):
            groups["sort+gathers"] += us
        else:
            groups["other"] += us
    return groups


def measure_mesh(device, out):
    path = os.path.join(REPO, "scenes", "mesh1080p.txt")
    for name, cfg in (("mesh", RenderConfig(sky_strength=1.0)),
                      ("mesh_nee", RenderConfig(sky_strength=1.0, nee=True))):
        r = Renderer(path, cfg, device=device)
        cluster = r._step.cluster
        sampler = make_light_sampler(r.scene) if cfg.nee else None
        rec = mesh.RayRecorder(cluster)
        fast.trace_sample_mesh(r.scene, cfg, SEED, 1, rec, light_sampler=sampler)
        rays = rec.soa[1]
        out[f"{name}_k7_bounce1_ms"] = time_launches(
            lambda: mesh.KERNEL(cluster.tables, *rays, full=True), REPS)
        if cfg.nee:
            shadow = rec.tmin[1]
            out[f"{name}_k8_bounce1_ms"] = time_launches(
                lambda: mesh.KERNEL(cluster.tables, *shadow, full=False), REPS)
        del rec, rays
        r.step(1)  # warm-up
        walls = []
        for _ in range(3):
            r.reset()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            r.render(4)
            walls.append(time.perf_counter() - t0)
        pixels = r.scene.camera.pixel_count
        out[f"{name}_rays_per_s"] = stats([pixels * 4 / w for w in walls])
        out[f"{name}_ms_per_sample"] = stats([w / 4 * 1e3 for w in walls])
        r.reset()
        rows, wall, idle = profile(lambda: r.render(4))
        out[f"{name}_profile"] = dict(wall_s=wall, idle_share=idle, device_us=mesh_groups(rows),
                                      device_kernels=rows)
    means = {}
    for name, cfg in (("depth8", RenderConfig(sky_strength=1.0)),
                      ("depth9", RenderConfig(sky_strength=1.0, trace_depth=9)),
                      ("nee_depth8", RenderConfig(sky_strength=1.0, nee=True))):
        r = Renderer(path, dataclasses.replace(cfg, samples_per_launch=96), device=device)
        r.render(96)
        means[name] = r.linear_image().reshape(-1, 3).mean(0).tolist()
    out["mesh_means_96spp"] = means


def eager_readings(r, spp=4, laps=3):
    """Laps of an eager pipeline's ``r.render(spp)`` after a warm-up sample
    (rays/s and ms/sample of each), then one more render(spp) under
    torch.profiler: torch kernels a sample, the device's idle share, device
    time by part (mesh_groups: K7, K8, the sort and gathers, the rest) and
    the kernels that took the most device time."""
    r.step(1)
    walls = []
    for _ in range(laps):
        r.reset()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r.render(spp)
        walls.append(time.perf_counter() - t0)
    pixels = r.scene.camera.pixel_count
    r.reset()
    mesh.KERNEL.reset_counts()
    rows, wall, idle = profile(lambda: r.render(spp))
    return dict(pipeline=r.pipeline, rays_per_s=stats([pixels * spp / w for w in walls]),
                ms_per_sample=stats([w / spp * 1e3 for w in walls]),
                kernels_per_sample=sum(r_[2] for r_ in rows) / spp, idle_share=idle,
                k7_launches_per_sample=mesh.KERNEL.launches_by_mode.get("full", 0) / spp,
                profiled_wall_s=wall, device_us=mesh_groups(rows),
                top_kernels=sorted(rows, key=lambda r_: -r_[1])[:12])


def measure_maps(device, out):
    """chip_smoke.py's phase 27 alone (env_spheres.txt under the meadow
    resampled to 512x1024 and 2048x4096 in the megakernel), then the
    2048x4096 exact and env NEE legs' device idle share of render(1000),
    three times by each method in turns: torch.profiler
    (chip_smoke._idle_share) and CUDA events around each kernel's ctypes
    call (chip_smoke._launch_idle_share, a lower bound)."""
    import chip_smoke

    scene_path = lambda name: os.path.join(REPO, "scenes", name)  # noqa: E731
    smi_line = smi("name,power.limit")
    phase = chip_smoke._big_map_phase(device, SEED, CHUNK, scene_path,
                                      chip_smoke.big_map_desc(scene_path, 16), smi_line)
    out["maps_phase27"] = {size: {k: dict(v, bound=list(v["bound"]),
                                          lookup_bound=list(v["lookup_bound"]))
                                  for k, v in got["kernels"].items()} | {"legs": got["legs"]}
                           for size, got in phase.items()}
    scene = Scene.from_desc(chip_smoke.big_map_desc(scene_path, 16), device)
    idle = {}
    for name, kw in (("exact", dict()), ("env NEE", dict(nee=True))):
        r = Renderer(scene, RenderConfig(samples_per_launch=200, **kw), seed=SEED,
                     device=device)
        r.step(200)
        runs = []
        for _ in range(3):
            for how, fn in (("profiler", chip_smoke._idle_share),
                            ("events", chip_smoke._launch_idle_share)):
                r.reset()
                runs.append((how, fn(lambda: r.render(1000))))
        idle[name] = runs
        print(f"maps idle 2048x4096 {name}: {runs}", flush=True)
    out["maps_idle_2048x4096"] = idle


def measure_eager(device, out, which):
    """The fast or the reference pipeline's legs (chip_smoke.py phases
    20-23): ``which`` 'fast': the three env_spheres configurations of phase
    20, the golden scene (antialias, sobol) and the 'shared' model on
    cornell.txt; 'reference': the golden scene, the 'naive', 'bvh' and
    'wavefront' models (each compaction) on cornell.txt, and mesh1080p with
    the meadow map without and with NEE."""
    import chip_smoke
    from cosc_4397_pathtracing_raytracing_project_tpu_torch.models import make_renderer

    scene_path = lambda name: os.path.join(REPO, "scenes", name)  # noqa: E731
    cornell, golden = scene_path("cornell.txt"), scene_path("cornell_golden.txt")
    legs = {}
    if which == "fast":
        for name, (desc, cfg) in chip_smoke.fast_legs_scenes(scene_path).items():
            legs[name] = lambda desc=desc, cfg=cfg: Renderer(desc, cfg, seed=SEED, device=device)
        models = [("shared", "none")]
    else:
        mesh_desc = parse_scene(chip_smoke.mesh_env_text(scene_path),
                                base_dir=os.path.join(REPO, "scenes"))
        for name, cfg in (("mesh + map", RenderConfig()),
                          ("mesh + map, nee", RenderConfig(nee=True))):
            legs[name] = lambda cfg=cfg: Renderer(mesh_desc, cfg, seed=SEED, device=device)
        models = [("naive", "none"), ("bvh", "none"), ("wavefront", "none"),
                  ("wavefront", "sort_alive"), ("wavefront", "sort_material")]
    legs["golden"] = lambda: Renderer(
        golden, RenderConfig(antialias=True, sampler="sobol", pipeline=which), seed=SEED,
        device=device)
    for model, compaction in models:
        legs[f"{model}[{compaction}]"] = lambda m=model, c=compaction: make_renderer(
            m, cornell, seed=SEED, compaction=c, device=device)
    readings = {}
    for name, make in legs.items():
        readings[name] = eager_readings(make())
        print(name, json.dumps({k: v for k, v in readings[name].items()
                                if k != "top_kernels"}), flush=True)
    out[f"{which}_legs"] = readings


# the same source without its launch bounds (ptxas may take more registers)
NO_BOUNDS = mesh.MeshKernel(build.NVCC_FLAGS + ("-DPT_MESH_BOUNDS=",))


def ptxas_lines_of(build_module, kernel):
    """nvcc's register and spill lines for ``kernel``'s build by
    ``build_module`` (this checkout's ops.cuda.build or a parent's)."""
    text = build_module.log_path(kernel.name, kernel.flags).read_text()
    return [line.strip() for line in text.splitlines()
            if "registers" in line or "spill" in line or "Compiling entry" in line]


def ptxas_lines(kernel):
    """nvcc's register and spill lines for ``kernel``'s build."""
    kernel._fn()
    return ptxas_lines_of(build, kernel)


def measure_mesh_kernels(device, out):
    path = os.path.join(REPO, "scenes", "mesh1080p.txt")
    cfg = RenderConfig(sky_strength=1.0, nee=True)
    r = Renderer(path, cfg, device=device)
    tables = r._step.cluster.tables
    rec = mesh.RayRecorder(r._step.cluster)
    fast.trace_sample_mesh(r.scene, cfg, SEED, 1, rec, light_sampler=make_light_sampler(r.scene))
    walks = getattr(rec, "walks", [None] * len(rec.soa))
    # (kernel, bounce, rays, the walk the pipeline takes for them)
    sets = [("K7", d, rays, w) for d, (rays, w) in enumerate(zip(rec.soa, walks))]
    sets += [("K8", d, rays, "warp") for d, rays in enumerate(rec.tmin)]
    sets += [("K8 live", d, rays[:6] + [rec.soa[d][6]], "warp")
             for d, rays in enumerate(rec.tmin)]
    # each walk, and the pipeline's without the launch bounds; a package
    # without walks has one schedule
    has_walks = hasattr(mesh, "WALKS")
    schedules = ["lane", "warp", "no bounds"] if has_walks else ["default"]
    if has_walks:
        out["mesh_ptxas"] = {"bounds": ptxas_lines(mesh.KERNEL),
                             "no bounds": ptxas_lines(NO_BOUNDS)}
        print(json.dumps(out["mesh_ptxas"], indent=1), flush=True)
    rows = []
    for kernel, depth, rays, shipped in sets:
        full = kernel == "K7"
        for name in schedules:
            launch, kw = mesh.KERNEL, {}
            if name == "no bounds":
                launch, kw = NO_BOUNDS, dict(walk=shipped)
            elif has_walks:
                kw = dict(walk=name)
            ms = time_launches(lambda: launch(tables, *rays, full=full, **kw), REPS)
            work = mesh.kernel_work(tables, *rays, full=full, **kw)
            eff = mesh.simt_efficiency(work) if hasattr(mesh, "simt_efficiency") else None
            rows.append(dict(kernel=kernel, bounce=depth, schedule=name, shipped=name == shipped,
                             active=int((rays[6] > 0.5).sum()), ms=ms["median"],
                             work=work, simt=eff))
            print(f"{kernel} bounce {depth} {name}: {rows[-1]['active']} active, "
                  f"{ms['median']:.4f} ms, SIMT {eff}", flush=True)
    out["mesh_kernels"] = rows
    sums = {}
    for kernel in ("K7", "K8", "K8 live"):
        mine = [x for x in rows if x["kernel"] == kernel]
        for name in schedules:
            sums[f"{kernel} / {name}"] = sum(x["ms"] for x in mine if x["schedule"] == name)
        if has_walks:
            sums[f"{kernel} / the pipeline's walks"] = sum(x["ms"] for x in mine if x["shipped"])
    out["mesh_kernels_ms_per_sample"] = sums
    print(json.dumps(sums, indent=1), flush=True)


def host_us_per_launch(fn, busy, reps=200):
    """Host microseconds per call of ``fn``, the mean over ``reps`` calls
    enqueued back to back; with ``busy``, behind a spin kernel that keeps the
    card busy past the last call's enqueue."""
    torch.cuda.synchronize()
    if busy:
        torch.cuda._sleep(int(50e-3 * SPIN_HZ))
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    host = (time.perf_counter() - t0) / reps * 1e6
    torch.cuda.synchronize()
    return host


# the spin kernel's clock, for a sleep of a given length (an H100 runs at up
# to 1.98 GHz; a longer spin only leaves the card busy longer)
SPIN_HZ = 2.0e9


def measure_mesh_host(device, out):
    path = os.path.join(REPO, "scenes", "mesh1080p.txt")
    cfg = RenderConfig(sky_strength=1.0)
    r = Renderer(path, cfg, device=device)
    r.step(1)  # warm-up
    laps = {}
    for name in ("first", "second"):
        walls = []
        for _ in range(5):
            r.reset()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            r.render(4)
            walls.append((time.perf_counter() - t0) / 4 * 1e3)
        laps[name] = walls
        print(f"mesh laps, {name}: ms/sample {[round(w, 3) for w in walls]}", flush=True)
    out["mesh_host_laps_ms_per_sample"] = laps
    rec = mesh.RayRecorder(r._step.cluster)
    fast.trace_sample_mesh(r.scene, cfg, SEED, 1, rec)
    rays = rec.soa[-1]
    tables = r._step.cluster.tables
    one = torch.zeros(1, device=device)
    host = {}
    for name, fn in (("K7 last bounce", lambda: mesh.KERNEL(tables, *rays, full=True)),
                     ("torch add", lambda: one.add_(1.0))):
        for busy in (False, True, False, True):
            key = f"{name}, {'busy' if busy else 'idle'}"
            host.setdefault(key, []).append(host_us_per_launch(fn, busy))
    out["mesh_host_us_per_launch"] = host
    print(json.dumps(host, indent=1), flush=True)


SASS_LINE = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P[T0-9]+\s+)?([A-Z][A-Z0-9_.]*)(.*?);")
SASS_CLASSES = (
    ("local", ("LDL", "STL")),
    ("global", ("LDG", "STG", "RED", "ATOM", "ATOMG")),
    ("ldc", ("LDC", "ULDC")),
    ("mufu", ("MUFU",)),
    ("fp32", ("FADD", "FMUL", "FFMA", "FMNMX", "FSETP", "FSEL", "FSET", "FCHK", "FRND", "FSWZADD")),
    ("convert", ("I2F", "F2I", "F2F", "I2FP", "F2IP")),
    ("control", ("BRA", "BRX", "JMP", "JMX", "CALL", "RET", "EXIT", "BSSY", "BSYNC", "BREAK",
                 "WARPSYNC", "BMOV", "NOP", "YIELD", "VOTE", "VOTEU")),
)


def sass_class(opcode):
    base = opcode.split(".")[0]
    for name, ops in SASS_CLASSES:
        if base in ops:
            return name
    if base.startswith("U"):
        return "uniform"
    if base in ("MOV", "SHFL", "S2R", "S2UR", "CS2R", "P2R", "R2P", "PLOP3", "SEL", "PRMT"):
        return "move"
    return "int"


def sass_census(lib_path, function_re):
    """Instruction classes of one function of a built library (cuobjdump
    -sass): the whole function, and each loop (a backward branch's range),
    with how many instructions read a constant-bank operand."""
    cuobjdump = os.path.join(os.path.dirname(build.nvcc_path()), "cuobjdump")
    text = subprocess.run([cuobjdump, "-sass", str(lib_path)], capture_output=True, text=True,
                          check=True).stdout
    body, inside = [], False
    for line in text.splitlines():
        if "Function :" in line:
            inside = re.search(function_re, line) is not None
            continue
        m = SASS_LINE.search(line) if inside else None
        if m:
            body.append((int(m.group(1), 16), m.group(2), m.group(3)))

    def census(rows):
        out = {"total": len(rows), "const_operand": sum("c[0x" in r[2] for r in rows)}
        for _, op, _ in rows:
            out[sass_class(op)] = out.get(sass_class(op), 0) + 1
        return out

    loops = []
    for addr, op, rest in body:
        t = re.search(r"0x([0-9a-f]+)", rest)
        if op.startswith("BRA") and t and int(t.group(1), 16) < addr:
            lo = int(t.group(1), 16)
            inside_loop = [r for r in body if lo <= r[0] <= addr]
            loops.append(dict(start=lo, end=addr, **census(inside_loop)))
    return dict(function=census(body), loops=loops)


def measure_schedule(device, out, cases_re=None):
    """The bounce loop's warp schedule: the counting build against
    warp_schedule on the plain version's path lengths, main, glass + lens +
    NEE and exact environment, one 50-sample launch at 800x800; the main
    variant's SASS census."""
    cornell = Scene.from_desc(load_scene_desc(os.path.join(REPO, "scenes", "cornell.txt")), device)
    text = open(os.path.join(REPO, "scenes", "cornell_glass.txt")).read()
    glass = Scene.from_desc(parse_scene(text.replace("LOOKAT", "APERTURE    0.3\nLOOKAT", 1)),
                            device)
    env = Scene.from_desc(load_scene_desc(os.path.join(REPO, "scenes", "env_spheres.txt")),
                          device)
    golden = Scene.from_desc(load_scene_desc(os.path.join(REPO, "scenes", "cornell_golden.txt")),
                             device)
    cases = {
        "main": (cornell, RenderConfig(sampler="sobol"), None),
        "glass_dof_nee": (glass, RenderConfig(enable_refraction=True, dof=True, nee=True,
                                              sampler="sobol"), None),
        "nee_aa": (golden, RenderConfig(nee=True, antialias=True, sampler="sobol"), None),
        "env_exact": (env, RenderConfig(), None),
        "env_exact_sobol": (env, RenderConfig(sampler="sobol"), None),
        "env_nee": (env, RenderConfig(nee=True), None),
        "split": (env, RenderConfig(env_mode="split"), None),
        "k6_round": (golden, RenderConfig(nee=True, sampler="sobol"),
                     adaptive_tiles(make_tile_layout, device, "round")),
    }
    for name, (sc, cfg, tl) in cases.items():
        if cases_re and not re.search(cases_re, name):
            continue
        opts = mk.kernel_options(cfg, sc)
        pk = mk.pack_scene(sc, nee=opts.nee, config=cfg)
        st = {}
        group = None
        if tl is None:
            pix = torch.arange(pk.width * pk.height, device=device)
            counted, owners = mk.kernel_warp_work(pk, opts, SEED, 1, CHUNK, device)
            mk.render_samples_reference(pix, pk, opts, SEED, 1, CHUNK, stats=st)
        else:
            (table, tpx, tpy), samples = tl
            k = table.shape[0] // 2
            group = mk.tile_group(tpx.numel(), samples, device)
            counted, owners = mk.kernel_warp_work(pk, opts, SEED, 0, samples, device,
                                                  tiles=tl[0], group=group)
            mk.render_tiles_reference(tpx, tpy, table[:k], table[k:], pk, opts, SEED, samples,
                                      stats=st)
        steps, draws = mk.path_lengths(st)
        vis = mk.path_visibility(st)
        row = dict(counted=counted, group=group, steps_per_path=float(steps.mean()),
                   one_step_paths=float((steps == 1).mean()),
                   plain_rays={k: int(st.get(k, 0)) for k in ("shadow", "env_shadow", "sun_shadow")})
        del st
        row["rays_equal_plain"] = [counted[k] for k in VIS_RAYS] == list(row["plain_rays"].values())
        for k, w in (("light", "light_warps"), ("env", "env_warps"), ("sun", "sun_warps")):
            lanes = counted["sun_lanes" if k == "sun" else f"{k}_rays"]
            row[f"{k}_simt"] = lanes / (32 * counted[w]) if counted[w] else None
        row["sun_rays_per_lane"] = (counted["sun_rays"] / counted["sun_lanes"]
                                    if counted["sun_lanes"] else None)
        # the light rays' queue: the SIMT efficiency of its passes
        row["light_pass_simt"] = (counted["light_pass_lanes"] / (32 * counted["light_passes"])
                                  if counted["light_passes"] else None)
        for sched, v in (("thread", None), (mk.SCHEDULE, None), ("vis", vis)):
            em = mk.warp_schedule(steps, draws, "thread" if sched == "thread" else mk.SCHEDULE,
                                  **mk.schedule_args(opts, tl is not None), vis=v,
                                  owners=None if sched == "thread" else owners,
                                  group=None if sched == "thread" else group,
                                  width=pk.width if tl is None else None)
            row[sched] = {k: em[k] for k in mk.WORK + ("efficiency", "settle_iters", "repeated",
                                                       "added", "spread", "spread_area")}
            # the launch's tail: each warp's iterations, the busiest against
            # the mean
            by_warp = em["warp_iters_by_warp"]
            row[sched]["warp_iters_mean_max"] = [float(by_warp.mean()), int(by_warp.max())]
        del vis
        row["counted_efficiency"] = counted["lane_iters"] / (32 * counted["warp_iters"])
        # the schedule without visibility rays (the loop counters of a kernel
        # that traces them at the vertex), and with them riding in the next trace
        row["equal_loop"] = all(counted[k] == row[mk.SCHEDULE][k] for k in mk.WORK[:3])
        row["equal"] = all(counted[k] == row["vis"][k] for k in mk.WORK)
        out[f"schedule_{name}"] = row
        print(name, json.dumps(row), flush=True)
    lib = build.build(mk.KERNEL.name, mk.KERNEL.flags)
    for variant, fn in SASS_VARIANTS.items():
        out[f"sass_{variant}"] = sass_census(lib, fn)
        print(f"sass {variant}", json.dumps(out[f"sass_{variant}"]), flush=True)
    out["ptxas"] = build.log_path(mk.KERNEL.name, mk.KERNEL.flags).read_text()


# the counting build's rays of each kind, in the order of the plain
# version's stats 'shadow', 'env_shadow', 'sun_shadow'
VIS_RAYS = ("light_rays", "env_rays", "sun_rays")
# the instantiations whose SASS the schedule and A/B legs take a census of:
# the main variant and NEE (K2), pt_megakernel<NEE, REFR, DOF, LEGACY, TILES,
# ENV, SAMPLES> (a checkout from before SAMPLES has six arguments)
SASS_VARIANTS = {"main": r"pt_megakernelILb0ELb0ELb0ELb0ELb0ELi0E(?:Lb0E)?E",
                 "nee": r"pt_megakernelILb1ELb0ELb0ELb0ELb0ELi0E(?:Lb0E)?E"}


def smi(query):
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=os.path.join(REPO, "build", "torch_measure.json"))
    ap.add_argument("--parent", default=None,
                    help="a parent checkout's root (git archive): the megakernel leg then "
                         "times its kernel and main path against this one's, in turns")
    ap.add_argument("--diag", default="",
                    help="with --parent: ','-separated checkouts whose packages join the A/B "
                         "turns (diagnostic builds)")
    ap.add_argument("--ab-flags", default="",
                    help="with --parent: ';'-separated sets of extra nvcc flags, each a further "
                         "build of this checkout's megakernel in the A/B turns")
    ap.add_argument("--diag-edits", default="",
                    help="with --parent: ','-separated names of DIAG_EDITS, each a copy of this "
                         "checkout's package under build/ with that edit, joining the turns as "
                         "--diag does")
    ap.add_argument("--rounds", type=int, default=1,
                    help="with --parent: the A/B's rounds of turns (parent, change, ..., then "
                         "back), each side timed twice a round")
    ap.add_argument("--cases", default=None,
                    help="a regular expression: the ab and schedule legs run only the cases "
                         "whose names it matches")
    ap.add_argument("--legs", default="megakernel,mesh",
                    help="comma-separated: megakernel, ab (the A/B alone, with --parent), "
                         "schedule, env, rows, envgate, mesh, mesh-kernels, mesh-host, fast, "
                         "reference, maps")
    args = ap.parse_args()
    legs = set(args.legs.split(","))
    if not legs or legs - {"megakernel", "ab", "schedule", "env", "rows", "envgate", "mesh",
                           "mesh-kernels",
                           "mesh-host", "fast", "reference", "maps"}:
        ap.error(f"unknown legs {args.legs!r}")
    if not torch.cuda.is_available():
        print("torch_measure: no CUDA device available", file=sys.stderr)
        return 1
    device = torch.device("cuda", 0)
    out = {"card": smi("name,power.limit"), "torch": torch.__version__,
           "cuda": torch.version.cuda}
    if "schedule" in legs:
        measure_schedule(device, out, args.cases)
    if "env" in legs:
        measure_env(device, out, args.parent)
    if "rows" in legs:
        measure_rows(device, out, args.parent, args.rounds)
    if "envgate" in legs:
        measure_env_gate(device, out)
    if ("megakernel" in legs or "ab" in legs) and args.parent:
        extra = [tuple(f.split()) for f in args.ab_flags.split(";") if f.strip()]
        diag = [d for d in args.diag.split(",") if d.strip()]
        diag += [make_diag(name) for name in args.diag_edits.split(",") if name.strip()]
        measure_ab(device, out, args.parent, extra, diag, args.cases, args.rounds)
    elif "ab" in legs:
        ap.error("the ab leg needs --parent")
    if "megakernel" in legs:
        measure_megakernel(device, out)
    if "mesh" in legs:
        measure_mesh(device, out)
    if "mesh-kernels" in legs:
        measure_mesh_kernels(device, out)
    if "mesh-host" in legs:
        measure_mesh_host(device, out)
    for which in ("fast", "reference"):
        if which in legs:
            measure_eager(device, out, which)
    if "maps" in legs:
        measure_maps(device, out)
    out["smi_after"] = smi("clocks.current.sm,power.draw,power.limit,temperature.gpu")

    text = json.dumps(out, indent=1)
    print(text)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        f.write(text + "\n")
    return 0


PACKAGE = "cosc_4397_pathtracing_raytracing_project_tpu_torch"


def load_package(root, alias):
    """The port's package from another checkout at ``root`` (a git archive
    of a parent commit), imported as ``alias`` beside this one; its kernels
    build from its own csrc/ into its own build/."""
    init = os.path.join(root, PACKAGE, "__init__.py")
    spec = importlib.util.spec_from_file_location(
        alias, init, submodule_search_locations=[os.path.dirname(init)])
    module = importlib.util.module_from_spec(spec)
    sys.modules[alias] = module
    spec.loader.exec_module(module)
    return module


# an emissive sphere added to env_spheres.txt (split + NEE needs an analytic
# light)
ENV_LIGHT = ("MATERIAL 4\nRGB 1 .9 .8\nSPECEX 0\nSPECRGB 0 0 0\nREFL 0\nREFR 0\nREFRIOR 0\n"
             "EMITTANCE 4\n\n", "\nOBJECT {n}\nsphere\nmaterial 4\nTRANS 1.5 2.6 1\nROTAT 0 0 0\n"
             "SCALE .6 .6 .6\n")


# the adaptive legs' dispatches at 800x800 (AdaptiveRenderer.render(256):
# 325 tiles of 32x64, a 64-spp warm-up, then rounds of 32 spp on a quarter of
# the tiles), each launch rendering buffers A and B of its tiles: (tiles,
# samples a launch, iteration bases of buffer A and B). The round is the
# first after the warm-up (every tile at 32 samples a buffer), on the 81
# tiles a round takes (a quarter of 325), here every fourth: the tiles a
# round picks by their noise vary by render.
ADAPTIVE_TILES = 325
ADAPTIVE_DISPATCH = {
    "warmup": (tuple(range(ADAPTIVE_TILES)), 32, 1, 33),
    "round": (tuple(range(0, 4 * 81, 4)), 16, 65, 81),
}
# the A/B's larger maps: the meadow (128x256) with each texel repeated 4 x 4
# (512x1024, 6.3 MB of radiance, inside the 50 MB L2) and 16 x 16
# (2048x4096, a production-size HDR: 100.7 MB of radiance, past the L2)
ENV_MAP_REPEATS = (4, 16)


def adaptive_tiles(layout, device, which):
    """((table, px, py), samples) of one of the adaptive legs' dispatches
    (ADAPTIVE_DISPATCH) on the 800x800 layout, as AdaptiveRenderer builds it."""
    ids, samples, base_a, base_b = ADAPTIVE_DISPATCH[which]
    gpx, gpy, _, _ = layout(800, 800)
    if gpx.shape[0] != ADAPTIVE_TILES:
        raise AssertionError(f"the 800x800 layout has {gpx.shape[0]} tiles, not {ADAPTIVE_TILES}")
    ids2 = torch.tensor(ids + ids, dtype=torch.int32, device=device)
    bases = torch.tensor([base_a] * len(ids) + [base_b] * len(ids), dtype=torch.int32,
                         device=device)
    rows = ids2.long()
    return (torch.cat([ids2, bases]),
            torch.as_tensor(gpx, device=device)[rows].reshape(-1).contiguous(),
            torch.as_tensor(gpy, device=device)[rows].reshape(-1).contiguous()), samples


def variant_launchers(pkg, device, kernel=None, cases_re=None):
    """One launch of each timed kernel variant, built with the package
    ``pkg`` (this checkout's or a parent's) or with its ``kernel`` binding,
    keyed by name: the named cases of the K1-K6 rows, then each other
    compile-time variant once ('v <variant>': sobol, no antialiasing;
    cornell_golden.txt without an environment, env_spheres.txt with one and,
    for split + NEE, an emissive sphere in it; a 0.3 lens for dof; 16
    tiles). A launch renders 50 samples of the frame or of 16 tiles, except
    the adaptive legs' dispatches (ADAPTIVE_DISPATCH: 'K6 round', 'K6
    warmup' on golden with NEE, 'K6 env_round', 'K6 env_warmup' on
    env_spheres with the exact environment)."""
    kmod = importlib.import_module(pkg.__name__ + ".ops.cuda.megakernel")
    kernel = kernel or kmod.KERNEL
    layout = importlib.import_module(pkg.__name__ + ".render.adaptive").make_tile_layout

    def scene(name, aperture=None):
        text = open(os.path.join(REPO, "scenes", name)).read()
        if aperture is not None:  # as the CLI's --aperture: focal stays auto
            text = text.replace("LOOKAT", f"APERTURE    {aperture}\nLOOKAT", 1)
        return pkg.Scene.from_desc(pkg.parse_scene(text, base_dir=os.path.join(REPO, "scenes")),
                                   device)

    cornell, golden = scene("cornell.txt"), scene("cornell_golden.txt")
    env = scene("env_spheres.txt")
    cfg = pkg.RenderConfig
    gpx, gpy, _, _ = layout(800, 800)
    ids = torch.arange(0, 16 * 20, 20, dtype=torch.int32, device=device)
    bases = 1 + 7 * torch.arange(16, dtype=torch.int32, device=device)
    # (tile tables, samples) of a launch over 16 tiles
    tiles16 = ((torch.cat([ids, bases]),
                torch.as_tensor(gpx, device=device)[ids.long()].reshape(-1).contiguous(),
                torch.as_tensor(gpy, device=device)[ids.long()].reshape(-1).contiguous()), CHUNK)
    cases = {
        "K1 main": (cornell, cfg(sampler="sobol"), None),
        "K1 aa": (cornell, cfg(sampler="sobol", antialias=True), None),
        "K1 independent": (cornell, cfg(), None),
        "K1b glass_dof_nee": (scene("cornell_glass.txt", 0.3), cfg(
            enable_refraction=True, dof=True, nee=True, sampler="sobol"), None),
        "K1b throughput": (cornell, cfg(gather_mode="throughput"), None),
        "K2 nee_aa": (golden, cfg(nee=True, antialias=True, sampler="sobol"), None),
        # the adaptive leg's options over the full frame
        "K2 nee_sobol": (golden, cfg(nee=True, sampler="sobol"), None),
        "K3 exact": (env, cfg(), None),
        "K3 exact_sobol": (env, cfg(sampler="sobol"), None),
        "K3 exact_refraction": (env, cfg(enable_refraction=True), None),
        "K4 env_nee": (env, cfg(nee=True), None),
        # K4 as the leg runs it: each launch after its rows' build
        "K4 env_nee_rows": (env, cfg(nee=True), None),
        "K5 split": (env, cfg(env_mode="split"), None),
        "K5 split_aa": (env, cfg(env_mode="split", antialias=True), None),
        "K6 tiles16": (golden, cfg(nee=True, sampler="sobol"), tiles16),
        "K6 env_tiles16": (env, cfg(sampler="sobol"), tiles16),
    }
    for which in ADAPTIVE_DISPATCH:
        cases[f"K6 {which}"] = (golden, cfg(nee=True, sampler="sobol"),
                                adaptive_tiles(layout, device, which))
        cases[f"K6 env_{which}"] = (env, cfg(sampler="sobol"),
                                    adaptive_tiles(layout, device, which))
    # K3, K4 and K6's round under the meadow map with each texel repeated
    # r x r (ENV_MAP_REPEATS); a parent package whose kernel caps the map
    # takes it with the cap lifted, its kernel unchanged
    if hasattr(kmod, "MAX_ENV_EXACT_TEXELS"):
        kmod.MAX_ENV_EXACT_TEXELS = 1 << 40
    env_desc = pkg.parse_scene(open(os.path.join(REPO, "scenes", "env_spheres.txt")).read(),
                               base_dir=os.path.join(REPO, "scenes"))
    for r in ENV_MAP_REPEATS:
        big = dataclasses.replace(env_desc, env_image=np.repeat(np.repeat(
            env_desc.env_image, r, 0), r, 1))
        size = "x".join(str(n) for n in big.env_image.shape[:2])
        sc_big = pkg.Scene.from_desc(big, device)
        cases[f"K3 exact@{size}"] = (sc_big, cfg(), None)
        cases[f"K4 env_nee@{size}"] = (sc_big, cfg(nee=True), None)
        cases[f"K6 env_round@{size}"] = (sc_big, cfg(sampler="sobol"),
                                         adaptive_tiles(layout, device, "round"))
    env_text = open(os.path.join(REPO, "scenes", "env_spheres.txt")).read()
    n_env = env_text.count("\nOBJECT ")
    env_light = (env_text.replace("\nENVIRONMENT\n", "\n" + ENV_LIGHT[0] + "ENVIRONMENT\n", 1)
                 + ENV_LIGHT[1].format(n=n_env))
    scenes = {}

    def variant_scene(env_mode, nee, dof):
        key = (env_mode, nee, dof)
        if key not in scenes:
            if env_mode == "none":
                text = open(os.path.join(REPO, "scenes", "cornell_golden.txt")).read()
            else:
                text = env_light if (env_mode == "split" and nee) else env_text
            if dof:
                text = text.replace("LOOKAT", "APERTURE    0.3\nLOOKAT", 1)
            scenes[key] = pkg.Scene.from_desc(
                pkg.parse_scene(text, base_dir=os.path.join(REPO, "scenes")), device)
        return scenes[key]

    named = {kmod.variant_name(kmod.kernel_options(c, sc), tl is not None)
             for sc, c, tl in cases.values()}
    for flags in range(128):
        nee, refr, dof, legacy, tl = (bool(flags >> b & 1) for b in range(5))
        env = flags >> 5
        if (nee and legacy) or (env and legacy) or (nee and env in (1, 2)) or (tl and env >= 2):
            continue
        env_mode = ("none", "exact", "exact", "split")[env]
        config = cfg(nee=nee or env == 2, enable_refraction=refr, dof=dof, sampler="sobol",
                     gather_mode="throughput" if legacy else "light_only",
                     env_mode="split" if env == 3 else "exact")
        sc = variant_scene(env_mode, nee, dof)
        name = kmod.variant_name(kmod.kernel_options(config, sc), tl)
        if name not in named:
            cases[f"v {name}"] = (sc, config, tiles16 if tl else None)
            named.add(name)
    launchers = {}
    for name, (sc, config, tl) in cases.items():
        if cases_re and not re.search(cases_re, name):
            continue
        opts = kmod.kernel_options(config, sc)
        pk = kmod.pack_scene(sc, nee=opts.nee, config=config)
        rows = None
        if opts.env_nee and name != "K4 env_nee_rows":
            # the row kernel's rows with their table where the package has
            # one, else the torch row build's
            rows = (kmod.env_nee_rows(pk, SEED, 1, CHUNK, opts.trace_depth)
                    if hasattr(kmod, "env_nee_rows")
                    else kmod.build_env_nee_rows(sc.envmap, SEED, 1, CHUNK, opts.trace_depth))
        if tl is None:
            launchers[name] = (lambda pk=pk, opts=opts, rows=rows: kernel(
                pk, opts, SEED, 1, CHUNK, device, env_rows=rows))
        else:
            launchers[name] = (lambda pk=pk, opts=opts, tl=tl: kernel(
                pk, opts, SEED, 0, tl[1], device, tiles=tl[0]))
    return launchers


def measure_ab(device, out, parent_root, extra_flags=(), diag_roots=(), cases_re=None,
               rounds=1):
    """The kernel variants and the main path, this checkout against the
    parent's package at ``parent_root``, in turns (parent, change, change,
    parent): each variant's 50-sample launch (median of 20) and bit identity
    of the two outputs; the main path's rays/s (render(1000) after a warm-up
    step, two laps a turn). Each of ``extra_flags`` (a tuple of nvcc flags)
    adds a build of this checkout's kernel with those flags to the variants'
    turns (parent, change, extra builds, then back in reverse order), with
    its ptxas registers and spills. Each of ``diag_roots`` (another
    checkout, such as a diagnostic build) joins the turns the same way.
    ``rounds`` repeats the turns (each side two medians a round)."""
    pkgs = {"parent": load_package(parent_root, "parent_pkg"),
            "change": sys.modules[PACKAGE]}
    for i, root in enumerate(diag_roots):
        pkgs[os.path.basename(os.path.normpath(root))] = load_package(root, f"diag{i}_pkg")
    kernels = {side: importlib.import_module(pkg.__name__ + ".ops.cuda.megakernel").KERNEL
               for side, pkg in pkgs.items()}
    for flags in extra_flags:
        kernels[" ".join(flags)] = mk.Megakernel(build.NVCC_FLAGS + tuple(flags))
    build_modules = {side: importlib.import_module(pkg.__name__ + ".ops.cuda.build")
                     for side, pkg in pkgs.items() if side != "change"}
    with ThreadPoolExecutor(max_workers=len(kernels)) as pool:  # one nvcc each, together
        builds = [pool.submit(build_modules.get(side, build).build, k.name, k.flags)
                  for side, k in kernels.items()]
        for b in builds:
            b.result()
    out["ab_ptxas"] = {side: [line for line in ptxas_lines_of(build_modules.get(side, build), k)
                              if "registers" in line or "spill" in line]
                       for side, k in kernels.items()}
    launchers = {side: variant_launchers(pkgs.get(side, pkgs["change"]), device, k, cases_re)
                 for side, k in kernels.items()}
    sides = list(kernels)
    turns = (sides + sides[::-1]) * rounds
    out["ab_sass_nee"] = {
        side: sass_census(build_modules.get(side, build).library_path(k.name, k.flags),
                          SASS_VARIANTS["nee"])
        for side, k in kernels.items()}
    print("ab sass nee", json.dumps(out["ab_sass_nee"]), flush=True)
    rows = {}
    for name in launchers["change"]:
        want = launchers["parent"][name]()
        got = {side: launchers[side][name]() for side in sides[1:]}
        same = {side: torch.equal(want, g) for side, g in got.items()}
        # against the parent's output (bit for bit its plain version's): the
        # kernel-vs-plain readings of a variant that adds in another order
        gate = {side: agreement(g, want) for side, g in got.items()}
        del got
        times = {side: [] for side in sides}
        for side in turns:
            times[side].append(time_launches(launchers[side][name], REPS)["median"])
        rows[name] = dict(ms=times, bit_identical=same, vs_parent=gate)
        print(f"ab {name}: " + "; ".join(f"{side} {times[side]}" for side in sides)
              + f" ms; bit-identical {same}; vs parent "
              + "; ".join(f"{side} share {g['share_gt_1e3']:.3e} max {g['max_abs']:.3e}"
                          for side, g in gate.items()), flush=True)
    out["ab_variants"] = rows
    # this checkout's tile dispatch at the adaptive dispatches with a
    # pixel's samples in one item (as before the split) against its own
    # choice, in turns
    layout = importlib.import_module(PACKAGE + ".render.adaptive").make_tile_layout
    golden = Scene.from_desc(load_scene_desc(os.path.join(REPO, "scenes", "cornell_golden.txt")),
                             device)
    env = Scene.from_desc(load_scene_desc(os.path.join(REPO, "scenes", "env_spheres.txt")),
                          device)
    split_rows = {}
    for sc, cfg, tag in ((golden, RenderConfig(nee=True, sampler="sobol"), ""),
                         (env, RenderConfig(sampler="sobol"), "env_")):
        opts = mk.kernel_options(cfg, sc)
        pk = mk.pack_scene(sc, nee=opts.nee, config=cfg)
        for which in ADAPTIVE_DISPATCH:
            tl, samples = adaptive_tiles(layout, device, which)
            chosen = mk.tile_group(tl[1].numel(), samples, device)
            runs = {g: (lambda g=g: mk.KERNEL(pk, opts, SEED, 0, samples, device, tiles=tl,
                                              group=g)) for g in sorted({samples, chosen})}
            times = {g: [] for g in runs}
            for g in list(runs) + list(runs)[::-1]:
                times[g].append(time_launches(runs[g], REPS)["median"])
            split_rows[f"K6 {tag}{which}"] = dict(chosen=chosen, ms=times)
            print(f"ab split K6 {tag}{which}: samples an item {chosen} (of {samples}); ms "
                  f"{times}", flush=True)
    out["ab_tile_items"] = split_rows
    renderers = {
        side: pkgs[side].Renderer(os.path.join(REPO, "scenes", "cornell.txt"),
                                  pkgs[side].RenderConfig(samples_per_launch=200,
                                                          sampler="sobol"),
                                  device=device)
        for side in ("parent", "change")
    }
    for r in renderers.values():
        r.step(200)
    laps = {side: [] for side in renderers}
    for side in ("parent", "change", "change", "parent") * (2 * rounds):
        r = renderers[side]
        r.reset()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r.render(1000)
        laps[side].append(r.scene.camera.pixel_count * 1000 / (time.perf_counter() - t0))
    same = bool(np.array_equal(renderers["parent"].linear_image(),
                               renderers["change"].linear_image()))
    out["ab_main_rays_per_s"] = dict(laps, bit_identical=same)
    print(f"ab main path rays/s: {json.dumps(laps)}; images bit-identical {same}", flush=True)


# Diagnostic edits of csrc/megakernel.cu (--diag-edits): each is a list of
# (text, replacement) pairs, every text found exactly once.
DIAG_EDITS = {
    # the exact environment's escape lookups (K3, K4) replaced by constants
    "esc_const": [
        ("env_lookup<ENV == 2>(env, dx, dy, dz, le, &pe);",
         "le[0] = 0.5f; le[1] = 0.5f; le[2] = 0.5f; pe = 0.25f;"),
    ],
    # K4's env ray taken as unoccluded, its test skipped
    "no_env_ray": [
        ("!occluded_row(sc, hx, hy, hz, row + 8, 1e7f)", "true"),
    ],
    # a warp takes its next chunk of 32 pixels only once every lane is done
    # with the last one: a strip of 32 neighbours at a time, no mixing
    "strip32": [
        ("      if (q_next == q_end) {\n",
         "      if (q_next == q_end) {\n        if (need != kFull) break;\n"),
    ],
}


def diag_source(text, name):
    """The megakernel source ``text`` with the edit DIAG_EDITS[name]
    applied; raises unless each of its texts is found exactly once."""
    for old, new in DIAG_EDITS[name]:
        if text.count(old) != 1:
            raise AssertionError(f"diagnostic edit {name}: {old!r} found {text.count(old)} times")
        text = text.replace(old, new)
    return text


def make_diag(name):
    """A copy of this checkout's package under build/diag_<name> with the
    edit DIAG_EDITS[name] applied to its megakernel source; returns the
    copy's root, for load_package."""
    import shutil
    root = os.path.join(REPO, "build", f"diag_{name}")
    shutil.rmtree(root, ignore_errors=True)
    shutil.copytree(os.path.join(REPO, PACKAGE), os.path.join(root, PACKAGE),
                    ignore=shutil.ignore_patterns("__pycache__"))
    src = os.path.join(root, mk.SOURCE)
    with open(src) as f:
        text = diag_source(f.read(), name)
    with open(src, "w") as f:
        f.write(text)
    return root


def measure_env(device, out, parent_root=None):
    """The environment legs (env_spheres.txt, Renderer(samples_per_launch=200),
    render(1000)) of this checkout and, with ``parent_root``, of the parent's
    package, in turns (parent, change, change, parent): rays/s of each lap;
    then one profiled render(1000) of each: the megakernel's device time,
    the device time and launches of every other kernel (env NEE's row build,
    the accumulator's adds), the idle share of the wall. Then env NEE's row
    build alone, for one step (200 samples, 1,600 rows) and one launch (50
    samples, 400 rows): device time (CUDA events) and the host's time to
    enqueue it, medians of 20."""
    pkgs = {"change": sys.modules[PACKAGE]}
    if parent_root:
        pkgs = {"parent": load_package(parent_root, "parent_pkg"), **pkgs}
    env_path = os.path.join(REPO, "scenes", "env_spheres.txt")
    legs = {"exact": dict(), "env_nee": dict(nee=True), "split": dict(env_mode="split")}
    result = {}
    for leg, kw in legs.items():
        rs = {side: pkg.Renderer(env_path, pkg.RenderConfig(samples_per_launch=200, **kw),
                                 device=device) for side, pkg in pkgs.items()}
        for r in rs.values():
            r.step(200)
        laps = {side: [] for side in rs}
        for side in list(rs) + list(rs)[::-1]:
            r = rs[side]
            r.reset()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            r.render(1000)
            laps[side].append(r.scene.camera.pixel_count * 1000 / (time.perf_counter() - t0))
        for side, r in rs.items():
            r.reset()
            rows, wall, idle = profile(lambda: r.render(1000))
            mega = [x for x in rows if "pt_megakernel" in x[0]]
            rest = [x for x in rows if "pt_megakernel" not in x[0]]
            result[f"{leg} {side}"] = dict(
                rays_per_s=laps[side], profiled_wall_s=wall, idle_share=idle,
                profiled_rays_per_s=r.scene.camera.pixel_count * 1000 / wall,
                megakernel_us=sum(x[1] for x in mega), megakernel_launches=sum(x[2] for x in mega),
                other_us=sum(x[1] for x in rest), other_launches=sum(x[2] for x in rest),
                other_kernels=sorted(rest, key=lambda x: -x[1])[:12])
            print(f"env {leg} {side}: " + json.dumps(result[f"{leg} {side}"]), flush=True)
    scenes = {side: pkg.Scene.from_desc(pkg.load_scene_desc(env_path), device)
              for side, pkg in pkgs.items()}
    for side, pkg in pkgs.items():
        kmod = importlib.import_module(pkg.__name__ + ".ops.cuda.megakernel")
        sc = scenes[side]
        cfg = pkg.RenderConfig(nee=True)
        opts = kmod.kernel_options(cfg, sc)
        pk = kmod.pack_scene(sc, nee=opts.nee, config=cfg)
        # the row kernel where the package has one, else the torch row build
        how = "kernel" if hasattr(kmod, "env_nee_rows") else "torch"
        for samples in (200, CHUNK):
            if how == "torch":
                build_rows = (lambda samples=samples: kmod.build_env_nee_rows(
                    sc.envmap, SEED, 1, samples, opts.trace_depth))
            else:
                build_rows = (lambda samples=samples: kmod.env_nee_rows(
                    pk, SEED, 1, samples, opts.trace_depth))
            dev = time_launches(build_rows, REPS)
            host = []
            for _ in range(REPS):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                build_rows()
                host.append((time.perf_counter() - t0) * 1e3)
            torch.cuda.synchronize()
            rows, _wall, _idle = profile(build_rows)
            result[f"rows {side} {samples}"] = dict(
                how=how, rows=samples * opts.trace_depth, device_ms=dev, host_ms=stats(host),
                kernels=sum(x[2] for x in rows), kernel_us=sum(x[1] for x in rows))
            print(f"env rows {side} {samples} samples: "
                  + json.dumps(result[f"rows {side} {samples}"]), flush=True)
    out["env_legs"] = result


def measure_rows(device, out, parent_root=None, rounds=1):
    """The rows leg (the module's docstring): env NEE's row kernel under the
    meadow map at 128x256, 512x1024 and 2048x4096, this checkout against
    ``parent_root``'s package in turns."""
    pkgs = {"change": sys.modules[PACKAGE]}
    if parent_root:
        pkgs = {"parent": load_package(parent_root, "parent_pkg"), **pkgs}
    env_path = os.path.join(REPO, "scenes", "env_spheres.txt")
    result = {}
    for repeat in (1,) + ENV_MAP_REPEATS:
        sides = {}
        for side, pkg in pkgs.items():
            kmod = importlib.import_module(pkg.__name__ + ".ops.cuda.megakernel")
            desc = pkg.load_scene_desc(env_path)
            desc.env_image = np.repeat(np.repeat(desc.env_image, repeat, 0), repeat, 1)
            sc = pkg.Scene.from_desc(desc, device)
            cfg = pkg.RenderConfig(nee=True)
            opts = kmod.kernel_options(cfg, sc)
            sides[side] = (kmod, kmod.pack_scene(sc, nee=opts.nee, config=cfg), opts.trace_depth)
        size = f"{128 * repeat}x{256 * repeat}"
        for samples in (200, CHUNK):
            laps = {side: [] for side in sides}
            for _ in range(rounds):
                for side in list(sides) + list(sides)[::-1]:
                    kmod, pk, depth = sides[side]
                    laps[side].append(time_launches(
                        lambda: kmod.env_nee_rows(pk, SEED, 1, samples, depth), REPS)["median"])
            rows = {side: kmod.env_nee_rows(pk, SEED, 1, samples, depth)
                    for side, (kmod, pk, depth) in sides.items()}
            result[f"{size} {samples}"] = dict(
                rows=samples * depth, median_ms=laps,
                bit_identical=(torch.equal(rows["parent"], rows["change"]) if parent_root
                               else None))
            print(f"rows {size} {samples} samples: " + json.dumps(result[f"{size} {samples}"]),
                  flush=True)
        del sides
    out["env_rows"] = result


def measure_env_gate(device, out, seeds=16):
    """The envgate leg (the module's docstring)."""
    import chip_smoke

    scene_path = lambda name: os.path.join(REPO, "scenes", name)  # noqa: E731
    result = {}
    for repeat in (1,) + ENV_MAP_REPEATS:
        size = f"{128 * repeat}x{256 * repeat}"
        scene = Scene.from_desc(chip_smoke.big_map_desc(scene_path, repeat), device)
        gaps = []
        for seed in range(seeds):
            *_, below, above = chip_smoke.env_nee_bracket(scene, seed, device, 1000)
            gaps.append((below, above))
        *_, below, above = chip_smoke.env_nee_bracket(scene, 0, device,
                                                      chip_smoke.ENV_NEE_GATE_SPP)
        g = np.asarray(gaps)
        result[size] = dict(
            below_depth8=g[:, 0].tolist(), above_depth9=g[:, 1].tolist(),
            mean=g.mean(0).tolist(), std=g.std(0, ddof=1).tolist(),
            seed0_gate_spp=dict(spp=chip_smoke.ENV_NEE_GATE_SPP, below_depth8=below,
                                above_depth9=above))
        print(f"envgate {size}: " + json.dumps(dict(
            mean=result[size]["mean"], std=result[size]["std"],
            seed0_gate_spp=result[size]["seed0_gate_spp"],
            max_above=float(g[:, 1].max()), max_below=float(g[:, 0].max()))), flush=True)
        del scene
    out["env_gate"] = result


def measure_megakernel(device, out):

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
    round_tiles, round_samples = adaptive_tiles(make_tile_layout, device, "round")
    out["kernel_k6_round_ms"] = time_launches(
        lambda: exact(pk, opts, SEED, 0, round_samples, device, tiles=round_tiles), REPS
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
            # the kernel alone on prebuilt rows, and the row build alone: the
            # row kernel and the torch build it replaced
            rows = mk.env_nee_rows(pk, SEED, 1, CHUNK, opts.trace_depth)
            out["env_nee_rows_ms"] = time_launches(
                lambda: mk.env_nee_rows(pk, SEED, 1, CHUNK, opts.trace_depth), REPS
            )
            out["env_nee_rows_torch_ms"] = time_launches(
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


if __name__ == "__main__":
    sys.exit(main())
