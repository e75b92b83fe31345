#!/usr/bin/env python3
"""Measure the PyTorch/CUDA port's kernels on one CUDA card.

    python3 scripts/torch_measure.py [--out build/torch_measure.json]
        [--legs megakernel,mesh,mesh-kernels,mesh-host]

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

Each leg ends with the card's name, power limit, SM clock and temperature.
Prints the readings as one JSON object and writes it to --out.
"""

import argparse
import dataclasses
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


# the same source without its launch bounds (ptxas may take more registers)
NO_BOUNDS = mesh.MeshKernel(build.NVCC_FLAGS + ("-DPT_MESH_BOUNDS=",))


def ptxas_lines(kernel):
    """nvcc's register and spill lines for ``kernel``'s build."""
    kernel._fn()
    text = build.log_path(kernel.name, kernel.flags).read_text()
    return [line.strip() for line in text.splitlines()
            if "registers" in line or "spill" in line or "Compiling entry" in line]


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


def smi(query):
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=os.path.join(REPO, "build", "torch_measure.json"))
    ap.add_argument("--legs", default="megakernel,mesh",
                    help="comma-separated: megakernel, mesh, mesh-kernels, mesh-host")
    args = ap.parse_args()
    legs = set(args.legs.split(","))
    if not legs or legs - {"megakernel", "mesh", "mesh-kernels", "mesh-host"}:
        ap.error(f"unknown legs {args.legs!r}")
    if not torch.cuda.is_available():
        print("torch_measure: no CUDA device available", file=sys.stderr)
        return 1
    device = torch.device("cuda", 0)
    out = {"card": smi("name,power.limit"), "torch": torch.__version__,
           "cuda": torch.version.cuda}
    if "megakernel" in legs:
        measure_megakernel(device, out)
    if "mesh" in legs:
        measure_mesh(device, out)
    if "mesh-kernels" in legs:
        measure_mesh_kernels(device, out)
    if "mesh-host" in legs:
        measure_mesh_host(device, out)
    out["smi_after"] = smi("clocks.current.sm,power.draw,power.limit,temperature.gpu")

    text = json.dumps(out, indent=1)
    print(text)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        f.write(text + "\n")
    return 0


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


if __name__ == "__main__":
    sys.exit(main())
