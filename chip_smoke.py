#!/usr/bin/env python3
"""Run the PyTorch/CUDA port's paths on one CUDA card and check them.

    python3 chip_smoke.py

Phases, in order; any failure raises and exits non-zero:

1. build: compile the port's CUDA source into build/torch_kernels/ and
   print ptxas' register and spill report for each compile-time variant of
   the megakernel;
2. kernel vs plain: the megakernel against its plain PyTorch version on the
   card, at the main path's shapes (scenes/cornell.txt, 800×800, depth 8,
   2 spp, and the golden leg's antialiased variant), within the stated
   tolerance; then the time of one 50-sample launch of each;
3. main path: Renderer(cornell.txt, samples_per_launch=200, sampler='sobol'),
   warm-up step, reset, best of 3 renders of 1000 spp; prints rays/s and
   ms/iteration and checks the kernel's launch count of that run;
4. golden leg: scenes/cornell_golden.txt with antialiasing, PSNR against
   tests/data/REFERENCE_cornell.5000samp.png at 1000 and 5000 spp;
5. the card's name and power limit, and the peak device memory so far;
6. the slice's options, kernel vs plain on the card at 800×800, depth 8,
   2 spp, same tolerance: (a) golden + NEE + sobol + antialias, (b) a
   two-light golden, (c) glass + DOF + NEE + sobol, (d) glass + DOF,
   independent, antialias, (e) sphere.txt with early_exit (also
   bit-identical to early_exit off), (f) throughput on cornell.txt, (g) the
   tile dispatch over 16 tiles with distinct iteration bases; one 50-sample
   launch of kernel and plain version for (a), (c) and (g);
7. quality leg: golden + NEE, 1000 spp: PSNR (floor 36.5 dB and above phase
   4's 1000-spp PSNR), rays/s, and channel means between phase 4's at
   depth 8 and the same leg's at depth 9, within 1%: NEE at the last
   vertex adds part of the light one bounce past the trace depth, which
   the BSDF-only estimator of the same depth never reaches;
8. glass + DOF leg (cornell_glass.txt, aperture 0.3, auto focus), open
   scene leg (sphere.txt, early_exit) and reference-parity leg (throughput
   on cornell.txt), 1000 / 200 / 200 spp: finite, not black, rays/s;
9. adaptive leg: AdaptiveRenderer(golden, sobol + NEE).render(256) against
   the uniform renderer at 256 spp (PSNR of both, K6 launches, wall);
10. one JSON line describing each ported kernel, the card, the result line.

Every leg sets the launch counts to 0 just before it and reads them just
after; a leg whose kernel variant was never launched fails. It needs a CUDA
device and the repository's files: without either it fails before printing
any result.
"""

import json
import math
import os
import re
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))

# kernel vs plain version on the card (same bound as tests/test_torch_cuda.py,
# which states its reason): measured bit-identical, while a -fmad=true build
# differs in 1.25e-5 of pixels by more than 1e-3 with a mean gap of 2.5e-5
MAX_SHARE_OVER_1E3 = 1e-4
MEAN_RTOL = 1e-4
# golden PSNR floors (the JAX reference scored 34.63 / 37.91 dB)
PSNR_FLOOR_1000 = 34.0
PSNR_FLOOR_5000 = 37.3
# NEE at 1000 spp: the JAX package's NEE estimator scored 37.13 dB (README);
# the floor leaves ~0.6 dB for Monte-Carlo noise, as the golden floors do
PSNR_FLOOR_NEE_1000 = 36.5
# NEE changes the variance, not the mean, of light that both estimators
# reach; its last vertex adds part of one more bounce (see phase 7)
NEE_MEAN_RTOL = 0.01
APERTURE = 0.3  # the glass leg's lens radius (--aperture 0.3, auto focus)

# The card's peaks for the bound (NVIDIA H100 SXM data sheet, 700 W): float32
# outside the tensor cores, and device memory.
PEAK_F32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12
# float operations (add, sub, mul, div, sqrt, min/max, sin/cos as one each;
# compares, selects and integer hashing not counted) per unit of work, read
# off csrc/megakernel.cu: the object-space ray of a geom (axis-aligned /
# general transform), a cube's slab test and a sphere's quadratic with their
# normals, the winner's normalize, one scatter (frame, direction, hit point,
# throughput), and NEE's light sample + MIS beside the shadow ray's
# per-geom tests.
FLOPS_RAY = {True: 9, False: 33}
FLOPS_CUBE = {True: 29, False: 46}
FLOPS_SPHERE = {True: 40, False: 52}
FLOPS_SHADOW_CUBE = 26
FLOPS_SHADOW_SPHERE = 28
FLOPS_NORMALIZE = 11
FLOPS_SCATTER = 70
FLOPS_NEE = 75

PTX_VARIANT = re.compile(r"pt_megakernelILb(\d)ELb(\d)ELb(\d)ELb(\d)ELb(\d)E")


def _check_close(got, want, what):
    import torch

    diff = (got - want).abs().amax(dim=-1)
    share = float((diff > 1e-3).float().mean())
    mean_got, mean_want = got.mean(dim=0), want.mean(dim=0)
    rel = float(((mean_got - mean_want).abs() / mean_want.abs().clamp_min(1e-12)).max())
    max_abs = float(diff.max())
    print(
        f"  {what}: max|d| {max_abs:.3e}, share |d|>1e-3 {share:.5f} "
        f"(bound {MAX_SHARE_OVER_1E3}), mean rel {rel:.2e} (bound {MEAN_RTOL}), "
        f"bit-identical pixels {float((diff == 0).float().mean()):.4f}"
    )
    if not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{what}: kernel output is not finite")
    if share > MAX_SHARE_OVER_1E3 or rel > MEAN_RTOL:
        raise AssertionError(f"{what}: kernel disagrees with the plain version")
    return max_abs


def _time_ms(fn, reps):
    import torch

    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    fn()  # warm-up
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def _golden_psnr(img, ref_img):
    import numpy as np

    mine = np.clip(img, 0, 1)[:, ::-1, :]
    return 10.0 * math.log10(1.0 / float(((mine - ref_img) ** 2).mean()))


def _bound(packed, opts, work, out_bytes, in_bytes):
    """(bound_ms, bound_by): the larger of this launch's float operations
    over the card's float32 peak and its bytes (each input read once, each
    output written once) over its memory rate. ``work`` holds the plain
    version's counts for the same inputs (megakernel._trace_batch)."""
    aligned = [int(packed.perm[3 * k]) >= 0 for k in range(packed.num_geoms)]
    isect = FLOPS_NORMALIZE + sum(
        FLOPS_RAY[a] + (FLOPS_CUBE[a] if k < packed.num_cubes else FLOPS_SPHERE[a])
        for k, a in enumerate(aligned)
    )
    shadow = FLOPS_NEE + sum(
        FLOPS_RAY[a] + (FLOPS_SHADOW_CUBE if k < packed.num_cubes else FLOPS_SHADOW_SPHERE)
        for k, a in enumerate(aligned)
    )
    flops = (
        int(work.get("isect", 0)) * isect
        + int(work.get("scatter", 0)) * FLOPS_SCATTER
        + int(work.get("shadow", 0)) * shadow
    )
    t_ops = flops / PEAK_F32_FLOPS * 1e3
    t_bytes = (out_bytes + in_bytes) / PEAK_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def _ptxas_report(log_text):
    """(variant name, registers, spill line) per kernel in nvcc's log."""
    names = ("nee", "refraction", "dof", "throughput", "tiles")
    rows, current, spill = [], None, ""
    for line in log_text.splitlines():
        m = PTX_VARIANT.search(line)
        if m:
            flags = [b == "1" for b in m.groups()]
            current = "+".join(n for n, f in zip(names, flags) if f) or "main"
            spill = ""
        elif current and "spill" in line:
            spill = line.strip()
        elif current and "registers" in line:
            rows.append((current, re.search(r"Used (\d+) registers", line).group(1), spill))
            current = None
    return rows


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    from cosc_4397_pathtracing_raytracing_project_tpu_torch import (
        AdaptiveRenderer,
        RenderConfig,
        Renderer,
        Scene,
        load_scene_desc,
        parse_scene,
    )
    from cosc_4397_pathtracing_raytracing_project_tpu_torch.io.png import read_png
    from cosc_4397_pathtracing_raytracing_project_tpu_torch.ops.cuda import build
    from cosc_4397_pathtracing_raytracing_project_tpu_torch.ops.cuda import megakernel as mk
    from cosc_4397_pathtracing_raytracing_project_tpu_torch.render.adaptive import (
        make_tile_layout,
    )

    device = torch.device("cuda", 0)
    t_start = time.perf_counter()
    scene_path = lambda name: os.path.join(REPO, "scenes", name)  # noqa: E731
    chunk = 50
    seed = 0

    # 1. build
    print(f"[1] build ({torch.cuda.get_device_name(0)}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda})")
    t0 = time.perf_counter()
    build.build(mk.KERNEL.name)
    print(f"  built in {time.perf_counter() - t0:.1f} s")
    report = _ptxas_report(build.log_path(mk.KERNEL.name).read_text())
    for variant, regs, spill in report:
        print(f"  ptxas: {variant}: {regs} registers; {spill}")
    if len(report) != 24:
        raise AssertionError(f"expected 24 kernel variants in ptxas' report, got {len(report)}")

    # 2. kernel vs plain version at the main path's shapes
    print("[2] kernel vs plain version, cornell.txt 800x800, depth 8, 2 spp")
    desc = load_scene_desc(scene_path("cornell.txt"))
    scene = Scene.from_desc(desc, device)
    packed = mk.pack_scene(scene)
    pix = torch.arange(packed.width * packed.height, device=device)
    max_abs_err = 0.0
    for what, cfg in (
        ("hoisted primary, sobol", RenderConfig(sampler="sobol")),
        ("antialias, sobol", RenderConfig(sampler="sobol", antialias=True)),
    ):
        opts = mk.kernel_options(cfg)
        got = mk.KERNEL(packed, opts, seed, 1, 2, device)
        want = mk.render_samples_reference(pix, packed, opts, seed, 1, 2)
        torch.cuda.synchronize()
        max_abs_err = max(max_abs_err, _check_close(got, want, what))
    opts = mk.kernel_options(RenderConfig(sampler="sobol"))
    ms = _time_ms(lambda: mk.KERNEL(packed, opts, seed, 1, chunk, device), reps=5)
    plain_ms = _time_ms(
        lambda: mk.render_samples_reference(pix, packed, opts, seed, 1, chunk), reps=1
    )
    work = {}
    mk.render_samples_reference(pix, packed, opts, seed, 1, chunk, stats=work)
    k1_bound = _bound(packed, opts, work, pix.numel() * 12, 0)
    print(f"  one {chunk}-sample launch at 800x800: kernel {ms:.3f} ms, "
          f"plain version {plain_ms:.1f} ms; bound {k1_bound[0]:.4f} ms ({k1_bound[1]})")

    # 3. main path
    print("[3] main path: cornell.txt, samples_per_launch=200, sampler='sobol', 3 x 1000 spp")
    iters, laps = 1000, 3
    renderer = Renderer(
        scene_path("cornell.txt"),
        RenderConfig(samples_per_launch=200, sampler="sobol"),
        device=device,
    )
    renderer.step(200)
    renderer.reset()
    mk.KERNEL.reset_counts()
    wall = float("inf")
    for _ in range(laps):
        renderer.reset()
        t0 = time.perf_counter()
        renderer.render(iters)
        wall = min(wall, time.perf_counter() - t0)
    main_launches = mk.KERNEL.launches
    pixels = renderer.scene.camera.pixel_count
    rays_per_sec = pixels * iters / wall
    img = renderer.linear_image()
    print(f"  {rays_per_sec:.6e} rays/s, {wall / iters * 1e3:.4f} ms/iteration "
          f"(best of {laps}: {wall:.4f} s for {iters} spp)")
    print(f"  megakernel launches in the main path: {main_launches} "
          f"{mk.KERNEL.launches_by_variant}")
    if mk.KERNEL.launches_by_variant.get("main", 0) <= 0:
        raise AssertionError("the main path never launched the megakernel")
    if img.shape != (800, 800, 3) or not bool(torch.isfinite(torch.from_numpy(img)).all()):
        raise AssertionError(f"main path image is malformed: {img.shape}")
    if not img.mean() > 0.0:
        raise AssertionError("main path image is black")

    # 4. golden leg
    print("[4] golden leg: cornell_golden.txt, antialias, sobol")
    ref_img = read_png(
        os.path.join(REPO, "tests", "data", "REFERENCE_cornell.5000samp.png")
    ).astype("float32") / 255.0
    mk.KERNEL.reset_counts()
    golden = Renderer(
        scene_path("cornell_golden.txt"),
        RenderConfig(samples_per_launch=200, antialias=True, sampler="sobol"),
        device=device,
    )
    golden.render(1000)
    golden_1000 = golden.linear_image()
    psnr_1000 = _golden_psnr(golden_1000, ref_img)
    golden.render(5000)
    psnr_5000 = _golden_psnr(golden.linear_image(), ref_img)
    golden_launches = mk.KERNEL.launches
    print(f"  PSNR vs golden: {psnr_1000:.4f} dB @ 1000 spp, {psnr_5000:.4f} dB @ 5000 spp "
          f"(floors {PSNR_FLOOR_1000} / {PSNR_FLOOR_5000}); launches {golden_launches}")
    if not (psnr_1000 >= PSNR_FLOOR_1000 and psnr_5000 >= PSNR_FLOOR_5000):
        raise AssertionError("golden PSNR below its floor")

    # 5. card
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(f"[5] card: {smi}; peak device memory {torch.cuda.max_memory_allocated(device)} bytes; "
          f"{time.perf_counter() - t_start:.1f} s so far")

    # 6. the slice's options: kernel vs plain version
    print("[6] slice options, kernel vs plain version, 800x800, depth 8, 2 spp")

    def scene_text(name, aperture=None, two_lights=False):
        text = open(scene_path(name)).read()
        if aperture is not None:
            text = text.replace("LOOKAT", f"APERTURE    {aperture}\nLOOKAT", 1)
        if two_lights:  # the golden sphere becomes a light on its own material
            text = text.replace(
                "// Specular white\nMATERIAL 4\nRGB         .98 .98 .98\nSPECEX      0\n"
                "SPECRGB     .98 .98 .98\nREFL        1",
                "// Sphere light\nMATERIAL 4\nRGB         1 .9 .7\nSPECEX      0\n"
                "SPECRGB     0 0 0\nREFL        0",
            ).replace("REFRIOR     0\nEMITTANCE   0\n\n// Camera",
                      "REFRIOR     0\nEMITTANCE   2\n\n// Camera").replace(
                "// Sphere\nOBJECT 6\nsphere\nmaterial 1", "// Sphere\nOBJECT 6\nsphere\nmaterial 4")
        return text

    golden_nee = RenderConfig(nee=True, antialias=True, sampler="sobol")
    glass_cfg = RenderConfig(enable_refraction=True, dof=True, nee=True, sampler="sobol")
    cases = {
        "a golden+nee+sobol+aa": (scene_text("cornell_golden.txt"), golden_nee),
        "b two lights+nee": (scene_text("cornell_golden.txt", two_lights=True),
                             RenderConfig(nee=True)),
        "c glass+dof+nee+sobol": (scene_text("cornell_glass.txt", APERTURE), glass_cfg),
        "d glass+dof+aa": (scene_text("cornell_glass.txt", APERTURE),
                           RenderConfig(enable_refraction=True, dof=True, antialias=True)),
        "e sphere early_exit": (scene_text("sphere.txt"), RenderConfig(early_exit=True)),
        "f throughput": (scene_text("cornell.txt"), RenderConfig(gather_mode="throughput")),
    }
    errs = {}
    timed = {}
    for what, (text, cfg) in cases.items():
        sc = Scene.from_desc(parse_scene(text), device)
        opts = mk.kernel_options(cfg)
        pk = mk.pack_scene(sc, nee=opts.nee)
        got = mk.KERNEL(pk, opts, seed, 1, 2, device)
        want = mk.render_samples_reference(pix, pk, opts, seed, 1, 2)
        torch.cuda.synchronize()
        errs[what[0]] = _check_close(got, want, what)
        if what[0] == "b" and pk.lights.count != 2:
            raise AssertionError("the two-light variant does not hold two lights")
        if what[0] == "e":
            off = mk.KERNEL(pk, mk.kernel_options(RenderConfig()), seed, 1, 2, device)
            if not torch.equal(got, off):
                raise AssertionError("early_exit changed the kernel's output")
            print("  e: early_exit on is bit-identical to off")
        if what[0] in "ac":
            timed[what[0]] = (pk, opts)
    # (g) the tile dispatch: 16 of the 800x800 frame's 32x64 tiles
    gpx, gpy, _gidx, _ = make_tile_layout(800, 800)
    sc_g = Scene.from_desc(parse_scene(scene_text("cornell_golden.txt")), device)
    cfg_g = RenderConfig(nee=True, sampler="sobol")
    opts_g = mk.kernel_options(cfg_g)
    pk_g = mk.pack_scene(sc_g, nee=True)
    ids = torch.arange(0, 16 * 20, 20, dtype=torch.int32, device=device)
    bases = 1 + 7 * torch.arange(16, dtype=torch.int32, device=device)
    tpx = torch.as_tensor(gpx, device=device)[ids.long()].reshape(-1)
    tpy = torch.as_tensor(gpy, device=device)[ids.long()].reshape(-1)
    table = torch.cat([ids, bases])

    def tiles_kernel(n):
        return mk.KERNEL(pk_g, opts_g, seed, 0, n, device, tiles=(table, tpx, tpy))

    def tiles_plain(n, stats=None):
        return mk.render_tiles_reference(tpx, tpy, ids, bases, pk_g, opts_g, seed, n, stats)

    errs["g"] = _check_close(tiles_kernel(2), tiles_plain(2), "g tile dispatch, 16 tiles")
    times = {}
    for key, (pk, opts) in timed.items():
        k_ms = _time_ms(lambda: mk.KERNEL(pk, opts, seed, 1, chunk, device), reps=3)
        p_ms = _time_ms(
            lambda: mk.render_samples_reference(pix, pk, opts, seed, 1, chunk), reps=1)
        w = {}
        mk.render_samples_reference(pix, pk, opts, seed, 1, chunk, stats=w)
        times[key] = (k_ms, p_ms, _bound(pk, opts, w, pix.numel() * 12, 0))
    k_ms = _time_ms(lambda: tiles_kernel(chunk), reps=3)
    p_ms = _time_ms(lambda: tiles_plain(chunk), reps=1)
    w = {}
    tiles_plain(chunk, w)
    times["g"] = (k_ms, p_ms, _bound(pk_g, opts_g, w, tpx.numel() * 12, tpx.numel() * 8 + 128))
    for key, (k_ms, p_ms, bnd) in times.items():
        print(f"  {key}: one {chunk}-sample launch: kernel {k_ms:.3f} ms, plain version "
              f"{p_ms:.1f} ms; bound {bnd[0]:.4f} ms ({bnd[1]})")

    # 7. quality leg
    print("[7] quality leg: cornell_golden.txt, NEE + sobol + antialias, 1000 spp")
    mk.KERNEL.reset_counts()
    quality = Renderer(
        scene_path("cornell_golden.txt"),
        RenderConfig(samples_per_launch=200, antialias=True, sampler="sobol", nee=True),
        device=device,
    )
    t0 = time.perf_counter()
    quality.render(1000)
    q_wall = time.perf_counter() - t0
    nee_launches = dict(mk.KERNEL.launches_by_variant)
    q_img = quality.linear_image()
    psnr_nee = _golden_psnr(q_img, ref_img)
    deeper = Renderer(
        scene_path("cornell_golden.txt"),
        RenderConfig(samples_per_launch=200, antialias=True, sampler="sobol", trace_depth=9),
        device=device,
    )
    deeper.render(1000)
    means_nee = q_img.reshape(-1, 3).mean(0)
    means_d8 = golden_1000.reshape(-1, 3).mean(0)
    means_d9 = deeper.linear_image().reshape(-1, 3).mean(0)
    below = float((1.0 - means_nee / means_d8).max())  # > 0: darker than depth 8
    above = float((means_nee / means_d9 - 1.0).max())  # > 0: brighter than depth 9
    print(f"  PSNR vs golden {psnr_nee:.4f} dB @ 1000 spp (floor {PSNR_FLOOR_NEE_1000}; "
          f"without NEE {psnr_1000:.4f} dB); {pixels * 1000 / q_wall:.6e} rays/s, "
          f"{q_wall / 1000 * 1e3:.4f} ms/iteration; launches {nee_launches}")
    print(f"  channel means: NEE depth 8 {means_nee.tolist()}, without NEE depth 8 "
          f"{means_d8.tolist()}, depth 9 {means_d9.tolist()}; below depth 8 by {below:.4e}, "
          f"above depth 9 by {above:.4e} (bound {NEE_MEAN_RTOL} each)")
    if nee_launches.get("nee", 0) <= 0:
        raise AssertionError("the quality leg never launched the NEE kernel")
    if not (psnr_nee >= PSNR_FLOOR_NEE_1000 and psnr_nee > psnr_1000):
        raise AssertionError("NEE PSNR below its floor or not above the non-NEE leg")
    if below > NEE_MEAN_RTOL or above > NEE_MEAN_RTOL:
        raise AssertionError("NEE's channel means leave the depth-8..9 bracket")

    # 8. glass + DOF, open scene, reference parity
    legs = {
        "glass+dof": (1000, "nee+refraction+dof", Scene.from_desc(
            parse_scene(scene_text("cornell_glass.txt", APERTURE)), device),
            RenderConfig(samples_per_launch=200, enable_refraction=True, nee=True,
                         sampler="sobol")),
        "open scene": (200, "main", scene_path("sphere.txt"),
                       RenderConfig(samples_per_launch=200, early_exit=True)),
        "reference parity": (200, "throughput", scene_path("cornell.txt"),
                             RenderConfig(samples_per_launch=200, gather_mode="throughput")),
    }
    leg_launches = {}
    for name, (spp, variant, sc, cfg) in legs.items():
        print(f"[8] {name} leg: {spp} spp")
        mk.KERNEL.reset_counts()
        r = Renderer(sc, cfg, device=device)
        t0 = time.perf_counter()
        r.render(spp)
        leg_wall = time.perf_counter() - t0
        leg_launches[name] = dict(mk.KERNEL.launches_by_variant)
        img = r.linear_image()
        print(f"  dof {r.config.dof}; mean {img.mean():.6f}; "
              f"{pixels * spp / leg_wall:.6e} rays/s; launches {leg_launches[name]}")
        if leg_launches[name].get(variant, 0) <= 0:
            raise AssertionError(f"the {name} leg never launched its kernel variant")
        if not (bool(torch.isfinite(torch.from_numpy(img)).all()) and img.mean() > 0.0):
            raise AssertionError(f"the {name} leg's image is not finite or black")

    # 9. adaptive leg
    print("[9] adaptive leg: cornell_golden.txt, NEE + sobol, AdaptiveRenderer.render(256)")
    cfg_a = RenderConfig(samples_per_launch=256, sampler="sobol", nee=True)
    mk.KERNEL.reset_counts()
    ada = AdaptiveRenderer(scene_path("cornell_golden.txt"), cfg_a, device=device)
    t0 = time.perf_counter()
    ada.render(256)
    ada_wall = time.perf_counter() - t0
    ada_launches = dict(mk.KERNEL.launches_by_variant)
    ada_img = ada.linear_image()
    uniform = Renderer(scene_path("cornell_golden.txt"), cfg_a, device=device)
    uniform.render(256)
    spp_map = ada.spp_map()
    print(f"  adaptive PSNR {_golden_psnr(ada_img, ref_img):.4f} dB (avg {ada.avg_spp:.2f} spp, "
          f"min {spp_map.min()} max {spp_map.max()}), uniform 256 spp PSNR "
          f"{_golden_psnr(uniform.linear_image(), ref_img):.4f} dB; K6 launches {ada_launches}; "
          f"wall {ada_wall:.4f} s, {ada.samples_per_second:.6e} samples/s")
    if ada_launches.get("nee+tiles", 0) <= 0:
        raise AssertionError("the adaptive leg never launched the tile kernel")
    if not (bool(torch.isfinite(torch.from_numpy(ada_img)).all()) and ada_img.mean() > 0.0):
        raise AssertionError("the adaptive image is not finite or black")
    if spp_map.min() < 64:  # the warm-up: a quarter of the budget on every tile
        raise AssertionError("a tile got less than the warm-up's samples")

    # 10. kernels, then the result
    print(f"[10] peak device memory {torch.cuda.max_memory_allocated(device)} bytes; "
          f"total {time.perf_counter() - t_start:.1f} s")
    src = "cosc_4397_pathtracing_raytracing_project_tpu/ops/pallas/megakernel.py"

    def entry(name, replaces, launches, err, timing):
        k_ms, p_ms, (b_ms, b_by) = timing
        return {
            "name": name, "route": "cuda", "source": mk.SOURCE, "replaces": f"{src}:{replaces}",
            "launches": launches, "max_abs_err": err, "ms": k_ms, "plain_ms": p_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
        }

    k1b_launches = sum(leg_launches["glass+dof"].values()) + sum(
        leg_launches["reference parity"].values())
    print(json.dumps({"kernels": [
        entry("K1 megakernel", 2393, main_launches, max_abs_err, (ms, plain_ms, k1_bound)),
        entry("K1b megakernel[refraction,dof,early_exit,throughput]", 1510, k1b_launches,
              max(errs[k] for k in "cdef"), times["c"]),
        entry("K2 megakernel[nee]", 1554, sum(nee_launches.values()),
              max(errs[k] for k in "ab"), times["a"]),
        entry("K6 megakernel[tiles]", 2173, sum(ada_launches.values()), errs["g"], times["g"]),
    ]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
