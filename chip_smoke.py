#!/usr/bin/env python3
"""Run the PyTorch/CUDA port's paths on one CUDA card and check them.

    python3 chip_smoke.py

Phases, in order; any failure raises and exits non-zero:

1. build: compile the port's CUDA sources (csrc/megakernel.cu and
   csrc/mesh_kernel.cu, each also as its work-counting build, one nvcc
   each, and the host runtime native/src/ptruntime.cc with g++, all started
   together) into build/torch_kernels/ and print ptxas'
   register and spill report for each compile-time variant of the
   megakernel and each instantiation of the mesh kernel, and the blocks an
   SM holds of the main and every NEE variant;
2. kernel vs plain: the megakernel against its plain PyTorch version on the
   card, at the main path's shapes (scenes/cornell.txt, 800×800, depth 8,
   2 spp, and the golden leg's antialiased variant), within the stated
   tolerance; then the time of one 50-sample launch of each, and the bounce
   loop's SIMT efficiency in a 10-sample launch: the megakernel's counting build
   against megakernel.warp_schedule's replay of the warps it recorded, on
   the plain version's path lengths (the counts must be equal), beside a
   thread per pixel's on the same paths;
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
   launch of kernel and plain version for (a), (c) and (g); for (a), K2's
   case, and (c) the visibility rays of a 10-sample launch: the counting build's
   light rays against the plain version's (equal, digit for digit), all its
   counters against the emulation (equal), the light rays' queue (passes,
   their SIMT efficiency, exit passes, rays tested after their pixel was
   written out), and the launch's bound with the rays traced alone beside
   the bound of the design (sun rays share the trace of the next ray from
   their vertex); then K6 at the adaptive leg's own dispatches (the
   warm-up's 650 tile slots x 32 samples and a round's 162 x 16), kernel
   vs plain version at that size, both times, the bound, and the round's
   counts against the emulation, and a pixel-sample of the round beside
   one of the full-frame NEE launch with the leg's options;
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
10. the environment variants (kernels K3-K5) on scenes/env_spheres.txt
   (800×800, depth 8, the 128×256 meadow map), kernel vs plain version at
   2 spp, same tolerance: exact (independent, sobol, refraction), env NEE,
   split with the background composited outside (no antialiasing) and
   without it (antialias), and the tile dispatch with exact env over 16
   tiles and at the environment adaptive leg's warm-up and round (kernel vs
   plain version, times and bounds at that size); then one 50-sample launch
   of kernel and plain version of each,
   and for env NEE (K4) and the split composite (K5) the visibility rays of
   a 10-sample launch as phase 6 reports K2's; then env NEE's row kernel (its rows
   and their per-geom table, part of K4) against its plain version at the
   env NEE leg's sizes (a 200-sample step's 1,600 rows and a launch's 400):
   bit for bit (the largest |Δ| of each column printed), the table the
   plain table of its directions, and its time beside the torch row
   build's;
11. environment legs: Renderer(env_spheres) render(1000) in exact, exact +
   nee (env NEE) and split mode, rays/s and launches each (the env NEE
   leg's row kernel launched once a step), then each leg once more under
   torch.profiler: its device idle share;
12. furnace on the card: a constant map c over a diffuse sphere of albedo
   0.6, exact and env NEE, 1000 spp: background equal to c within 1e-5,
   the body's centre within 2% of 0.6·c;
13. environment gates: the exact render's primary-miss pixels equal the
   split composite's within rtol 3e-4 (polynomial lookup vs library
   trigonometry); the split mean within 2% of the env-NEE mean at
   tests/test_envmap.py's 64×64, depth 4 (the 800×800 gap is printed: the
   split's specular bounces miss the suns' glints); the env-NEE mean
   between the exact means at depth 8 and depth 9, with the slack
   ENV_NEE_SLACK (NEE reaches one bounce further);
14. environment adaptive leg: AdaptiveRenderer(env_spheres, exact,
   sobol).render(256) through the tile dispatch with exact env;
15. peak device memory and the total time so far;
16. the mesh kernels K7/K8 on scenes/mesh1080p.txt (1920×1080, depth 8,
   38,530 triangles): the set-up's times (the native BVH build, packing,
   upload), then
   the kernels against their plain version on the real rays of a 1-spp NEE
   render (K7 on every bounce's rays, with dead rays inactive, K8 on every
   bounce's shadow rays): shares of active rays whose t (bound 0) or index
   (bound 1e-4) differ, tie rays, normals and materials equal on every
   other active ray, one launch's time (median of 20), the plain version's
   time and work, the kernel's own work and the warp iterations that ran it
   (its counting build: the SIMT efficiency of each level of the walk; the
   other walk must run the same tests), the bound from that work, and per
   sample the sums over the launches. Each set runs in the walk the
   pipeline asks for: the lane walk on primary rays, the warp walk on every
   later bounce and on shadow rays;
17. mesh leg: Renderer(mesh1080p, sky_strength=1.0), warm-up step, then
   render(64) (about 4 s on an H100): rays/s, ms/sample, K7 launches (8 a
   sample); kernel pipeline against plain pipeline at 1 spp on a 480x270
   frame of the same camera (share of pixels with max-channel |Δ| > 1e-3
   ≤ 1e-4, channel means within 1e-4); sort on against sort off at full
   size (rtol 1e-6, atol 1e-7);
18. mesh NEE leg: the same with nee=True (K7 and K8 launches, kernel
   against plain pipeline), and its channel means between the non-NEE
   depth-8 and depth-9 means, 1% slack each side;
19. K6's loss over the adaptive legs' launches (launches x (time - bound),
   the warm-up and the rounds each at its own size), the row kernel's line
   (part of K4's row);
20. the fast pipeline (eager torch, no kernel of its own) on
   scenes/env_spheres.txt (800x800, depth 8, meadow map) in three
   configurations: the two 'auto' routes to it, exact under throughput
   gathering and an emissive sphere added under nee (the combined area +
   env NEE), and, named pipeline='fast', the map resampled to 512x1024
   (which 'auto' renders in the megakernel, phase 27), each a warm-up
   sample then render(16): rays/s, ms a sample, torch
   kernels a sample and the device's idle share (one more sample under
   torch.profiler); then the card against the CPU, the same code at 1 spp
   on the second configuration at 200x200 (share of pixels with
   max-channel |d| > 1e-3 <= 0.5%, channel means within 0.5%);
21. golden through pipeline='fast' and pipeline='reference', 1000 spp
   each, each in a process of its own and both at once (chip_smoke.py
   --golden-eager <pipeline> <seed>): PSNR (floor 34.0 dB, the golden
   leg's) and rays/s beside the other process;
22. the registry's five models (and the wavefront model's two other
   compactions) on scenes/cornell.txt (800x800, depth 8), each a warm-up
   sample then render(8): rays/s, kernels a sample, idle share (the
   megakernel model's a lower bound, its ctypes calls timed by CUDA
   events, as in phase 27); bvh
   against naive (share of pixels > 1e-3 below 2%, means within 2%,
   tests/test_bvh.py's bound), each compaction and wavefront against naive
   (rtol = atol = 1e-5, tests/test_models.py's);
23. the reference pipeline on mesh1080p.txt with the meadow map, which
   'auto' routes to 'reference' with the BVH (triangles through K7), without
   and with nee, each a warm-up sample then render(4): rays/s, ms a
   sample, K7 launches a sample (at least one), idle share; then at 240x135,
   depth 3 and 1 spp, triangles through K7 against the threaded BVH walk on the
   card (tri_method='while'), tests/test_bvh.py's bound;
24. the command line on the card, each run a `python -m
   cosc_4397_pathtracing_raytracing_project_tpu_torch` subprocess with the
   default device (four at once, then the resumed one): (a) the golden at
   16 spp with antialias, sobol and NEE, with and without --denoise (and
   --hdr): the denoised PNG's PSNR at least the raw one's + 3 dB (the JAX
   package's contract, tests/test_denoise.py); (b) the denoised PNG within
   1 LSB of the library's Renderer.render(16) + save_png(denoise=True), the
   same seed and steps; (c) cornell.txt to 100 spp with --checkpoint, then
   --resume to 200 spp: the checkpoint's accumulator bit for bit an
   uninterrupted library render(200), in the JAX package's npz fields; (d)
   --adaptive --iterations 64 --denoise --checkpoint (K6) writes the
   adaptive fields; (e) the denoiser on the card against its CPU version:
   render_aovs on cornell.txt at 800x800 and mesh1080p.txt at 96x54 (miss
   masks identical, the rest within 1e-4 but on at most 0.5% of pixels,
   each reproduced on the CPU with the card's sqrt, or an exact tie) and
   atrous_denoise on the same inputs within 1e-4; (f) the card's times of
   render_aovs on cornell at 800x800 and of atrous_denoise at 800x800
   (median of 5 after a warm-up), of render_aovs on mesh1080p at 1920x1080
   (one pass, warmed by (e)), and profile_pipeline on cornell.txt; (g) the
   preview server on the card:
   two frames, an orbit that resets the iteration, the denoise toggle's
   frame; and the phase's time;
25. multi-device rendering (parallel/), every rank a process on this one
   card (gloo; NCCL refuses two ranks on one card), so no rays/s of the
   phase is a scaling number: (a) the megakernel on a slice of the frame
   (the second dp rank's half of 800x800, its hash tiles from 157) against
   its plain version for main, NEE, env exact, env NEE and split (bit for
   bit without NEE), and the counting build on the main slice against the
   emulation; (b) cornell.txt 800x800, depth 8, sobol, one 200-sample step
   through make_sharded_pallas_step at world 2 (sp=1, dp=2) and world 4
   (sp=2, dp=2), and golden at 1000 spp through the world-4 step (PSNR
   floor 34.0 dB); (c) cornell.txt at 1024x800 (TILE-aligned slices), 8
   spp: sp=1 bit for bit the single device, sp=2 within rtol 1e-5, atol
   1e-6; (d) mesh1080p at 1920x1080, 4 spp, dp=2, with and without NEE,
   against the single device (the kernel-vs-plain bound); (e) the fast step
   with env NEE on env_spheres.txt at sp=2, dp=2, 32 spp: mean within 5%,
   correlation above 0.95 against the single device; (f) golden NEE
   adaptive (warm-up and two rounds) at world 2 against the unsharded
   renderer (the kernel-vs-plain bound; selections printed); (g) (b)'s step
   over NCCL at world size torch.cuda.device_count(); (h) the dry run
   (parallel.dryrun.dryrun_multichip, four ranks). Each leg prints its
   backend, world size, time and rays/s, and every rank's launches of the
   leg's kernel in its timed run (counts set to 0 just before it), which
   must be above 0;
26. the native host runtime (native/, built by phase 1 from the checkout's
   native/src/ptruntime.cc with the host compiler, beside the nvcc builds)
   and the single-device entry point, host times on this machine's CPU:
   (a) the library's path, the compiler's version and flags, the build's
   seconds; (b) mesh1080p: each of its OBJ files loaded natively and by the
   plain loader (bit for bit), and the BVH over its triangle boxes at leaf
   8 as make_mesh_intersector builds it (order, miss links, leaf starts and
   counts equal, the bounds bit for bit), with the times of each; (c) a
   2048x4096 map (env_spheres' meadow with each texel repeated 16 x 16):
   its alias table native against the plain Python loop (bit for bit), both
   times, build_envmap's tables the native ones; then env_spheres.txt under
   that map on the fast pipeline (named: 'auto' takes the megakernel, phase
   27), exact and with env NEE, a warm-up sample then render(4): rays/s, a
   finite frame; (d) the golden image written by the native PNG writer
   reads back equal, and tests/data/REFERENCE_cornell.5000samp.png's rows
   through the native defilter equal the NumPy path's; (e) entry() (the
   fast pipeline: cornell.txt, sobol, one sample) at 200x200 on the card
   against the same call on the CPU (phase 20's bound), then at full size
   on the card: one call's seconds after a warm-up and a finite accumulator
   there;
27. exact maps past the JAX kernel's 256x512 VMEM cap in the megakernel:
   env_spheres.txt (800x800, depth 8) under phase 20's 512x1024 map and
   phase 26's 2048x4096 map (built once there), each: K3 and K4 against
   their plain versions at 2 spp (K3 bit for bit, K4 within the
   kernel-vs-plain bound), one 50-sample launch of each (kernel, plain
   version, the bound with the map's bytes once, 12 a texel and 16 with
   env NEE's pdf, and with its bytes counted per lookup, 48 a lookup and 4
   a pdf lookup), K6 at the environment
   adaptive leg's round against its plain version (bit for bit, times,
   both bounds); env NEE's row kernel against its plain version as in
   phase 10, bit for bit (past 2^15 texels the alias cell comes from a
   64-bit word of its own); the Renderer through pipeline='auto' (which
   must take 'pallas') in exact mode and with env NEE, render(1000) after
   a warm-up step: rays/s, launches, a lower bound on the device's idle
   share of one more render(1000) (1 - its kernels' ctypes calls, each
   timed by CUDA events, over its wall); phase 13's env-NEE gate: env
   NEE's channel means between the exact means at depth 8 and at depth 9,
   within ENV_NEE_SLACK, each a render of ENV_NEE_GATE_SPP samples (env
   NEE's rows are shared by a sample's pixels, so 1000 samples leave noise
   of the order of the slack); the AdaptiveRenderer in
   exact mode, render(256) (K6 launched, every tile at least 64 spp);
then one JSON
   line describing each ported kernel (K6's times and bound are the
   round's; K7's and K8's are the sums over one mesh pipeline sample's
   launches, whose count 'launches_per_sample' gives; K7's
   'reference_pipeline' holds phase 23's launches, their count a sample and
   K7's device ms a sample there, per leg; K3, K4 and K6 once more for each
   of phase 27's maps, '@<size>' in the name, with its legs' launches and
   'lookup_bound_ms', K4's with its row kernel's time a step and bit
   identity), the card, the result line.

Every leg sets the launch counts to 0 just before it and reads them just
after; a leg whose kernel variant was never launched fails. Phases 1-15 are
the megakernel's (kernels K1-K6), 16-18 the mesh pipeline's (K7, K8), 20-23
the eager pipelines' (K1 through the megakernel model, K7 through the
reference pipeline's BVH), 24 the command line's (K1, K2 and K6 through its
subprocesses; the launches of its library and server runs are read here),
25 the multi-device paths' (K1-K6 through the sharded megakernel step and
the tile-sharded adaptive dispatch, K7/K8 through the sharded mesh step;
each rank process reports its own launches), 26 the host runtime's (no
kernel: host C++ and the eager fast pipeline), 27 K3's, K4's and K6's at
the larger maps. It needs a CUDA device and the repository's files:
without either it fails before printing any result.
"""

import contextlib
import dataclasses
import json
import math
import os
import re
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

REPO = os.path.dirname(os.path.abspath(__file__))

# kernel vs plain version on the card (same bound as tests/test_torch_cuda.py,
# which states its reason): measured bit-identical without NEE and within
# 1e-6 with it (the light terms join the sum from the warp's queue), while a
# -fmad=true build differs in 1.25e-5 of pixels by more than 1e-3 with a
# mean gap of 2.5e-5
MAX_SHARE_OVER_1E3 = 1e-4
MEAN_RTOL = 1e-4
# samples of the full-frame launches whose counting build is held to
# megakernel.warp_schedule's emulation: the emulation steps the warps in
# Python, ~1 s a sample at 800x800 (phases 2, 6 and 10)
SCHEDULE_SPP = 10
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
# environment gates: the exact background against the library-trigonometry
# composite (the bound of tests/test_envmap.py's background rows), split vs
# env NEE (tests/test_envmap.py's split gate), the furnace
ENV_BG_RTOL = 3e-4
ENV_BG_ATOL = 1e-5
SPLIT_MEAN_RTOL = 0.02
FURNACE_BG_RTOL = 1e-5
FURNACE_BODY_RTOL = 0.02
# env NEE's channel means lie between the exact estimator's at depth 8 and
# depth 9 (NEE at the last vertex adds part of bounce 9); slack on each side
# for the Monte-Carlo noise of three 1000-spp renders under meadow's sun
ENV_NEE_SLACK = 0.01
# [27]'s env-NEE bracket renders this many samples a leg: env NEE's rows are
# shared by every pixel of a sample (one alias draw per iteration and depth),
# so the image mean of a render(1000) rests on 1000 draws a depth, whose
# noise is of the order of the slack under the meadow's sun (measured over
# seeds by scripts/torch_measure.py --legs envgate)
ENV_NEE_GATE_SPP = 16000

# The card's peaks for the bound (NVIDIA H100 SXM data sheet, 700 W): float32
# outside the tensor cores, and device memory.
PEAK_F32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12
# float operations (add, sub, mul, div, sqrt, min/max, sin/cos as one each;
# compares, selects and integer hashing not counted) per unit of work, read
# off csrc/megakernel.cu: the object-space origin and direction of a geom
# (axis-aligned / general transform), a cube's slab test and a sphere's
# quadratic with their normals (the slab offsets -0.5 - q_o, 0.5 - q_o and
# the sphere's c = |q_o|^2 - 0.25 included), the winner's normalize, one
# scatter (frame, direction, hit point, throughput), and NEE's light sample +
# MIS beside the shadow ray's per-geom tests. A sun ray rides in the trace of
# the ray that next leaves its vertex, so it shares that ray's origin
# transform, slab offsets and c (and takes them alone where its vertex was
# the path's last), and its direction and reciprocals (a sphere's |q_d|^2
# and its reciprocal) come from a table computed once per launch: its own
# work per geom is the rest of the test. A light ray is tested at its vertex,
# on its own, each geom in full: its origin and direction transform and the
# whole slab test or quadratic. An env NEE ray is tested at its vertex too,
# but its direction's object-space direction and reciprocals come from its
# row's table (the row kernel's work, counted once a row): per geom it
# transforms its origin and does the rest of the test.
FLOPS_ORIGIN = {True: 6, False: 18}
FLOPS_DIR = {True: 3, False: 15}
FLOPS_RAY = {a: FLOPS_ORIGIN[a] + FLOPS_DIR[a] for a in (True, False)}
FLOPS_CUBE = {True: 29, False: 46}
FLOPS_SPHERE = {True: 40, False: 52}
FLOPS_SHARED_CUBE = 6  # the slab offsets
FLOPS_SHARED_SPHERE = 6  # c
FLOPS_SHADOW_CUBE = 26  # with the shared offsets and 3 reciprocals
FLOPS_SHADOW_SPHERE = 28  # with c, |q_d|^2 and its reciprocal
FLOPS_SUN_TABLE = {"cube": 3, "sphere": 6}  # beyond the direction
FLOPS_NORMALIZE = 11
FLOPS_SCATTER = 70
FLOPS_NEE = 75
# environment work: one escape lookup (two polynomial atan2s, the bilinear
# blend), the nearest-texel pdf lookup (its texel coordinates: the kernel
# takes the direction's (u, v) from the escape lookup), one SH-9 sky
# evaluation, and the shading arithmetic of an env NEE / sun shadow ray
# beside its per-geom tests
FLOPS_ENV_LOOKUP = 96
FLOPS_ENV_PDF = 2
FLOPS_SH9 = 74
FLOPS_ENV_NEE = 27
FLOPS_SUN = 17
# env NEE's row kernel, per row (csrc/megakernel.cu pt_env_rows): the alias
# draw (scale, fraction, stay or alias and its offset, the azimuth, the two
# band cosines and the cosine between them, acos, sin, the direction: 29),
# the bilinear radiance (atan2, acos, u, v, the texel coordinates and
# weights: 14, then 10 a channel); per geom the direction's object-space
# direction and the table's reciprocals (FLOPS_DIR, FLOPS_SUN_TABLE). Its
# threefry draws are integer work, not counted. Past 2^15 texels the cell
# comes from integer words and the fraction is u1 itself: 2 fewer (the scale
# and the fraction).
FLOPS_ENV_ROW = 29 + 14 + 3 * 10
FLOPS_ENV_ROW_OWN_CELL = FLOPS_ENV_ROW - 2

# the mesh kernels (csrc/mesh_kernel.cu), per ray: the three reciprocals of
# the direction, per cluster or supercluster box one slab test (6 sub, 6 mul,
# 6 min/max per axis pair, 3 max and 2 min), per triangle one Möller–Trumbore
# test (46: the p/q crosses, det, its reciprocal, u, v, t, u + v), and K7's
# final normalize; the counts of boxes and triangles are the kernel's own
# (mesh_kernel.kernel_work)
FLOPS_MESH_RAY = 3
FLOPS_SLAB = 23
FLOPS_TRIANGLE = 46
FLOPS_MESH_NORMALIZE = 11
# mesh legs: kernel pipeline against plain pipeline (the kernel-vs-plain
# bounds above, per pixel), kernel against plain version per ray (share of
# active rays whose t or index differ: ties on shared edges and boxes missed
# by rounding), the sort-invariance bound of tests/test_fast_mesh.py, and the
# slack of the NEE depth bracket (phase 7's)
MESH_RAY_SHARE = 1e-4
MESH_SORT_RTOL = 1e-6
MESH_SORT_ATOL = 1e-7
# samples of each mesh leg: fixed, so the NEE bracket reads the same noise on
# any card (the non-NEE estimator's mean moves by up to 2% between blocks of
# 32 samples on mesh1080p: heavy-tailed BRDF-sampled hits of the light; the
# NEE means stay within 1e-5)
MESH_SPP = 64
# the mesh legs' kernel-against-plain pipeline sample: a 480x270 frame of
# the same camera (phase 16 holds K7/K8 to their plain version on every ray
# of a full-size sample; the plain pipeline takes ~20 s a sample there)
MESH_GATE_RES = (480, 270)

# the eager pipelines (phases 20-23). Card against CPU, the same port code:
# the ROADMAP's oracle bound (torch's CPU and CUDA math round differently);
# the BVH against brute force (tests/test_bvh.py's statistical bound: ties
# on overlapping surfaces reroute whole paths); wavefront compaction
# (tests/test_models.py's tolerance)
ORACLE_SHARE = 0.005
ORACLE_MEAN_RTOL = 0.005
BVH_SHARE = 0.02
BVH_MEAN_RTOL = 0.02
WAVEFRONT_TOL = 1e-5
# samples of the eager legs: each is host-bound at 75-1000 ms a sample on
# an H100, so they stay few and the script inside its time limit
FAST_SPP = 16
FAST_GATE_RES = 200
GOLDEN_EAGER_SPP = 1000
GOLDEN_EAGER_TIMEOUT = 600
MODEL_SPP = 8
MESH_ENV_SPP = 4
# phase 23's K7 against the threaded BVH walk: 'while' syncs the host at
# every step of its walk (17-19 s at depth 8 on an H100, at 480x270 as at
# 240x135), so the gate renders a smaller frame to depth 3
MESH_WHILE_RES = (240, 135)
MESH_WHILE_DEPTH = 3
# phase 20 (b): env_spheres with one emissive sphere
EMITTER_MATERIAL = """// emitter
MATERIAL 4
RGB         1 .9 .8
SPECEX      0
SPECRGB     0 0 0
REFL        0
REFR        0
REFRIOR     0
EMITTANCE   5

"""
EMITTER_OBJECT = """
// emissive sphere
OBJECT 4
sphere
material 4
TRANS       1.5 3.5 2
ROTAT       0 0 0
SCALE       .8 .8 .8
"""

# phase 24: the denoiser's gain at 16 spp on the golden with NEE (the JAX
# package's contract, tests/test_denoise.py), the denoiser on the card
# against the CPU (|d| 1e-4, the kernel-vs-plain bound, but on pixels where
# torch's sqrt rounds otherwise on the card, at most ORACLE_SHARE of them),
# the preview server's samples a pose, and the time a command line run may
# take
DENOISE_GAIN_DB = 3.0
AOV_TOL = 1e-4
# a mesh1080p AOV pass takes ~28 s on an H100 at 700 W, and five passed
# within 0.08% of each other: one keeps the script inside its time limit
MESH_AOV_REPS = 1
# the denoiser's mesh AOVs card against CPU (the CPU's pass ~4 ms a pixel)
MESH_AOV_GATE_RES = (96, 54)
SERVER_SPP = 64
CLI_TIMEOUT = 600

# the adaptive legs' dispatches at 800x800 (AdaptiveRenderer.render(256):
# 325 tiles of 32x64, a 64-spp warm-up, then 23 rounds of 32 spp on a
# quarter of the tiles), each launch rendering buffers A and B of its tiles:
# (tiles, samples a launch, iteration bases of buffer A and B). The round is
# the first after the warm-up (every tile at 32 samples a buffer), on the
# 81 tiles a round takes (a quarter of 325), here every fourth: the tiles a
# round picks by their noise vary by render.
# phase 25, multi-device rendering: ranks are processes that share the one
# card over gloo (NCCL refuses two ranks on one card) and, at the card count,
# over NCCL. The slice the kernel checks render: the second dp rank's half of
# 800x800 (no TILE boundary at 320,000) on a tile base of its own
MD_SLICE = (320000, 320000, 157)
MD_STEP_SPP = 200  # the main path's samples a step (samples_per_launch=200)
MD_ALIGNED_RES = (1024, 800)  # 819,200 px: 400 tiles, 200 a dp rank of two
MD_ALIGNED_SPP = 8
MD_MESH_SPP = 4
MD_FAST_SPP = 32
MD_GOLDEN_SPP = 1000
MD_ADAPTIVE = dict(warmup=16, rounds=[(16, 0.25), (16, 0.25)])
MD_TIMEOUT = 600
# the fast step (env NEE, as tests/test_parallel.py's env NEE case: without
# it the meadow sun's fireflies, ~0.1% of pixels at 200x the mean, decide
# the correlation) against the single device: that test's bounds (a dp
# rank's streams are folded from its own key: another noise realisation).
# The correlation measured 0.9969 at 96 spp on an H100 (0.86 at 16 spp on
# the CPU at 64x64); at 32 spp it should be about 0.99
MD_FAST_MEAN_RTOL = 0.05
MD_FAST_CORR = 0.95
# sp = 2 adds two half-sums: tests/test_parallel.py:140's bound
MD_SP_RTOL = 1e-5
MD_SP_ATOL = 1e-6

# phase 26, the host runtime and the single-device entry point: the map of
# (c), the meadow with each texel repeated 16 x 16 (2048x4096, 8.4M texels:
# a production-size HDR, 64 times the JAX kernel's cap), its renders'
# samples, and the size of entry()'s card-against-CPU gate (phase 20's)
HOST_MAP_REPEAT = 16
HOST_ENV_SPP = 4
ENTRY_GATE_RES = 200

ADAPTIVE_TILES = 325
ADAPTIVE_DISPATCH = {
    "warmup": (tuple(range(ADAPTIVE_TILES)), 32, 1, 33),
    "round": (tuple(range(0, 4 * 81, 4)), 16, 65, 81),
}
# K6 keeps a tile-specific loss if a pixel-sample of its round costs more
# than this factor times one of the full-frame NEE launch on the same scene
K6_TILE_LOSS = 1.15

PTX_VARIANT = re.compile(r"pt_megakernelILb(\d)ELb(\d)ELb(\d)ELb(\d)ELb(\d)ELi(\d)ELb(\d)E")
PTX_MESH = re.compile(r"pt_mesh_intersectILb(\d)E")


def _adaptive_tiles(device, which):
    """(tile ids, iteration bases, px, py, samples) of one of the adaptive
    legs' dispatches (ADAPTIVE_DISPATCH) on the 800x800 layout, as
    AdaptiveRenderer builds it."""
    import torch

    from cosc_4397_pathtracing_raytracing_project_tpu_torch.render.adaptive import (
        make_tile_layout,
    )

    ids, samples, base_a, base_b = ADAPTIVE_DISPATCH[which]
    gpx, gpy, _, _ = make_tile_layout(800, 800)
    if gpx.shape[0] != ADAPTIVE_TILES:
        raise AssertionError(f"the 800x800 layout has {gpx.shape[0]} tiles, not {ADAPTIVE_TILES}")
    ids2 = torch.tensor(ids + ids, dtype=torch.int32, device=device)
    bases = torch.tensor([base_a] * len(ids) + [base_b] * len(ids), dtype=torch.int32,
                         device=device)
    rows = ids2.long()
    return (ids2, bases, torch.as_tensor(gpx, device=device)[rows].reshape(-1).contiguous(),
            torch.as_tensor(gpy, device=device)[rows].reshape(-1).contiguous(), samples)


def _time_dispatch(what, pk, opts, device, seed, dispatch):
    """One launch of an adaptive dispatch (_adaptive_tiles) against the plain
    version: both outputs held to the kernel-vs-plain bound, the kernel's
    time (mean of 3), the plain version's (one run) and the bound from the
    plain version's work. Returns ((ms, plain_ms, bound), max |d|, the plain
    version's work)."""
    import torch

    from cosc_4397_pathtracing_raytracing_project_tpu_torch.ops.cuda import megakernel as mk

    ids, bases, tpx, tpy, samples = dispatch
    table = torch.cat([ids, bases])
    got = mk.KERNEL(pk, opts, seed, 0, samples, device, tiles=(table, tpx, tpy))
    w = {}
    want = mk.render_tiles_reference(tpx, tpy, ids, bases, pk, opts, seed, samples, stats=w)
    torch.cuda.synchronize()
    err = _check_close(got, want, f"{what}: {ids.numel()} tile slots x {samples} samples "
                                  f"[{mk.variant_name(opts, True)}]")
    del got, want
    k_ms = _time_ms(lambda: mk.KERNEL(pk, opts, seed, 0, samples, device,
                                      tiles=(table, tpx, tpy)), reps=3)
    p_ms = _time_ms(lambda: mk.render_tiles_reference(tpx, tpy, ids, bases, pk, opts, seed,
                                                      samples), reps=1)
    bnd = _bound(pk, opts, w, tpx.numel() * 12,
                 tpx.numel() * 8 + table.numel() * 4 + _map_bytes(pk, opts))
    print(f"  {what}: one {samples}-sample launch over {ids.numel()} tile slots "
          f"({tpx.numel()} lanes; queue items of "
          f"{mk.tile_group(tpx.numel(), samples, device)} samples): kernel {k_ms:.4f} ms, "
          f"plain version {p_ms:.1f} ms; bound "
          f"{bnd[0]:.4f} ms ({bnd[1]}); {k_ms * 1e6 / (tpx.numel() * samples):.4f} ns a "
          f"pixel-sample")
    return (k_ms, p_ms, bnd), err, w


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


def _map_bytes(packed, opts):
    """The exact map's bytes the launch must read once: 12 a texel (the
    strength-folded radiance), 16 where env NEE's MIS reads the sampler's
    pdf too (K4); none in other modes."""
    if opts.env != "exact":
        return 0
    return packed.env.height * packed.env.width * (16 if opts.env_nee else 12)


def _bound(packed, opts, work, out_bytes, in_bytes, shared=True, env_rows=0):
    """(bound_ms, bound_by): the larger of this launch's float operations
    over the card's float32 peak and its bytes (each input read once, each
    output written once) over its memory rate. ``work`` holds the plain
    version's counts for the same inputs (megakernel._trace_batch). With
    ``shared`` the sun rays count the work of the kernel's design (see
    FLOPS_ORIGIN), and so do the env NEE rays, whose direction terms come
    from their row's table; without it, a full origin and direction
    transform and test of their own at every geom (the rays traced alone).
    ``env_rows`` adds the row kernel's work for that many env NEE rows (with
    ``shared``, their per-geom table's too)."""
    import numpy as np

    from cosc_4397_pathtracing_raytracing_project_tpu_torch.ops import envmap
    from cosc_4397_pathtracing_raytracing_project_tpu_torch.ops.cuda import megakernel as mk

    geoms = [(int(packed.perm[3 * k]) >= 0, k < packed.num_cubes)
             for k in range(packed.num_geoms)]
    isect = FLOPS_NORMALIZE + sum(
        FLOPS_RAY[a] + (FLOPS_CUBE[a] if cube else FLOPS_SPHERE[a]) for a, cube in geoms)
    occlusion = sum(
        FLOPS_RAY[a] + (FLOPS_SHADOW_CUBE if cube else FLOPS_SHADOW_SPHERE) for a, cube in geoms)
    # one direction's table entries (a sun's, an env NEE row's), all geoms
    entry = sum(FLOPS_DIR[a] + FLOPS_SUN_TABLE["cube" if cube else "sphere"] for a, cube in geoms)
    sun_occlusion = env_occlusion = occlusion
    row_table = 0
    row_flops = FLOPS_ENV_ROW
    if env_rows and packed.env.height * packed.env.width > envmap.ENV_CELL_SPLIT:
        row_flops = FLOPS_ENV_ROW_OWN_CELL
    if shared and env_rows:
        env_occlusion = sum(FLOPS_ORIGIN[a] + (FLOPS_SHADOW_CUBE - 3 if cube else
                                               FLOPS_SHADOW_SPHERE - 6) for a, cube in geoms)
        row_table = entry
    extra = 0
    if shared and opts.env == "split":
        sun_occlusion = sum(FLOPS_SHADOW_CUBE - FLOPS_SHARED_CUBE - 3 if cube else
                            FLOPS_SHADOW_SPHERE - FLOPS_SHARED_SPHERE - 6 for _a, cube in geoms)
        extra = packed.env.num_suns * entry
        # the sun rays of a path's last vertex take an origin transform of
        # their own
        vis = mk.path_visibility(work)
        steps, _ = mk.path_lengths(work)
        last = int(((vis["sun"] >> np.maximum(steps - 1, 0)) & 1).sum())
        extra += last * sum(FLOPS_ORIGIN[a] + (FLOPS_SHARED_CUBE if cube else
                                               FLOPS_SHARED_SPHERE) for a, cube in geoms)
    flops = (
        int(work.get("isect", 0)) * isect
        + int(work.get("scatter", 0)) * FLOPS_SCATTER
        + int(work.get("shadow", 0)) * (FLOPS_NEE + occlusion)
        + int(work.get("env_shadow", 0)) * (FLOPS_ENV_NEE + env_occlusion)
        + int(work.get("sun_shadow", 0)) * (FLOPS_SUN + sun_occlusion)
        + int(work.get("env_lookup", 0)) * FLOPS_ENV_LOOKUP
        + int(work.get("env_pdf", 0)) * FLOPS_ENV_PDF
        + int(work.get("sh", 0)) * FLOPS_SH9
        + extra
        + env_rows * (row_flops + row_table)
    )
    t_ops = flops / PEAK_F32_FLOPS * 1e3
    t_bytes = (out_bytes + in_bytes) / PEAK_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def _visibility(what, pk, opts, device, seed, n, stats, old_bound, new_bound, tiles=None):
    """The visibility rays of one n-sample launch (iterations from 1, or
    over ``tiles`` = (table, px, py) at their own bases): the counting
    build's rays of each kind against the plain version's ``stats`` (equal,
    digit for digit) and its counters against warp_schedule's emulation on
    the plain version's paths (equal); prints them with the visibility
    loop's SIMT efficiency of each kind (lanes carrying a ray over 32 times
    the warp iterations carrying one; for light rays, tested from the warp's
    queue, lanes over 32 times the passes that test them), the queue's
    passes, exit passes and late rays, and the launch's bound with the rays
    traced alone beside the design's."""
    from cosc_4397_pathtracing_raytracing_project_tpu_torch.ops.cuda import megakernel as mk

    group = mk.tile_group(tiles[1].numel(), n, device) if tiles else None
    kw = dict(tiles=tiles, group=group) if tiles else {}
    counted, owners = mk.kernel_warp_work(pk, opts, seed, 0 if tiles else 1, n, device, **kw)
    plain = {"light_rays": int(stats.get("shadow", 0)), "env_rays": int(stats.get("env_shadow", 0)),
             "sun_rays": int(stats.get("sun_shadow", 0))}
    steps, draws = mk.path_lengths(stats)
    em = mk.warp_schedule(steps, draws, mk.SCHEDULE, **mk.schedule_args(opts, tiles is not None),
                          owners=owners, vis=mk.path_visibility(stats), group=group)
    simt = {kind: round((counted["sun_lanes"] if kind == "sun" else counted[f"{kind}_rays"])
                        / (32 * counted[f"{kind}_warps"]), 4)
            for kind in ("env", "sun") if counted[f"{kind}_warps"]}
    if counted["light_passes"]:
        simt["light"] = round(counted["light_pass_lanes"] / (32 * counted["light_passes"]), 4)
    print(f"  {what}: visibility rays of a {n}-sample launch, counting build "
          f"{[counted[k] for k in plain]} (light, env, "
          f"sun), plain version {list(plain.values())}; warp iterations carrying them "
          f"{[counted[k] for k in ('light_warps', 'env_warps', 'sun_warps')]}, SIMT efficiency "
          f"{simt}, sun rays a lane {counted['sun_rays'] / max(counted['sun_lanes'], 1):.3f}; "
          f"light queue: {counted['light_passes']} passes, {counted['light_exit_passes']} of them "
          f"at exit, {counted['light_late']} rays late (their term to out[p]); "
          f"steps added for the last vertex's rays {em['added']}; loop SIMT efficiency "
          f"{counted['lane_iters'] / (32 * counted['warp_iters']):.4f}; counting build = emulation "
          f"{counted == {k: em[k] for k in mk.WORK}}; the timed launch's bound {old_bound[0]:.4f} "
          f"ms as counted "
          f"with the rays traced alone, {new_bound[0]:.4f} ms with the design's shared work "
          f"({new_bound[1]})")
    if any(counted[k] != v for k, v in plain.items()):
        raise AssertionError(f"{what}: the counting build's visibility rays differ from the plain "
                             "version's")
    if counted != {k: em[k] for k in mk.WORK}:
        raise AssertionError(f"{what}: the counting build's counts differ from the emulation's")


def _ptxas_report(log_text):
    """(variant name, registers, spill line) per kernel in nvcc's log."""
    names = ("nee", "refraction", "dof", "throughput", "tiles")
    env_names = ("", "env_exact", "env_nee", "env_split")
    rows, current, spill = [], None, ""
    for line in log_text.splitlines():
        m = PTX_VARIANT.search(line)
        if m:
            flags = [b == "1" for b in m.groups()[:5]]
            parts = [n for n, f in zip(names, flags) if f] + [env_names[int(m.group(6))]]
            if m.group(7) == "1":  # the tile dispatch with sample-group items
                parts.append("sample_items")
            current = "+".join(p for p in parts if p) or "main"
            spill = ""
        elif current and "spill" in line:
            spill = line.strip()
        elif current and "registers" in line:
            rows.append((current, re.search(r"Used (\d+) registers", line).group(1), spill))
            current = None
    return rows


def _mesh_ptxas_report(log_text):
    """(kernel name, registers, spill line) per instantiation of the mesh
    kernel in nvcc's log."""
    rows, current, spill = [], None, ""
    for line in log_text.splitlines():
        m = PTX_MESH.search(line)
        if m:
            current, spill = ("K7 full" if m.group(1) == "1" else "K8 tmin"), ""
        elif current and "spill" in line:
            spill = line.strip()
        elif current and "registers" in line:
            rows.append((current, re.search(r"Used (\d+) registers", line).group(1), spill))
            current = None
    return rows


def _median_ms(fn, reps=20):
    """Median of ``reps`` launches, each timed with CUDA events."""
    import torch

    fn()  # warm-up
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop))
    return sorted(times)[len(times) // 2]


def _mesh_phases(device, seed, scene_path):
    """Phases 16-18: the mesh kernels K7/K8 on mesh1080p.txt and the mesh
    legs. Returns the kernels' errors, timings, launches and bounds."""
    import numpy as np
    import torch

    from cosc_4397_pathtracing_raytracing_project_tpu_torch import (
        RenderConfig,
        Renderer,
        Scene,
        load_scene_desc,
    )
    from cosc_4397_pathtracing_raytracing_project_tpu_torch.ops import fast
    from cosc_4397_pathtracing_raytracing_project_tpu_torch.ops.bvh import try_native_build
    from cosc_4397_pathtracing_raytracing_project_tpu_torch.ops.cuda import mesh_kernel as mesh
    from cosc_4397_pathtracing_raytracing_project_tpu_torch.ops.lights import make_light_sampler
    from cosc_4397_pathtracing_raytracing_project_tpu_torch.render.engine import (
        make_mesh_intersector,
    )

    mesh_path = scene_path("mesh1080p.txt")
    print("[16] mesh kernels K7/K8 vs plain version, mesh1080p.txt 1920x1080, depth 8")
    t0 = time.perf_counter()
    desc = load_scene_desc(mesh_path)
    scene = Scene.from_desc(desc, device)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    isect = make_mesh_intersector(scene)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    tables = isect.tables
    v0, e1, e2 = (t.cpu().numpy() for t in (scene.triangles.v0, scene.triangles.e1,
                                              scene.triangles.e2))
    t0 = time.perf_counter()
    try_native_build(np.minimum(np.minimum(v0, v0 + e1), v0 + e2),
                     np.maximum(np.maximum(v0, v0 + e1), v0 + e2), leaf_size=8)
    bvh_s = time.perf_counter() - t0
    print(f"  set-up: parse + scene {load_s:.3f} s; intersector {setup_s:.3f} s: native BVH build "
          f"{bvh_s:.3f} s ({scene.num_triangles} triangles, leaf 8), then packing "
          f"({tables.num_clusters} clusters, {tables.num_super} superclusters) and upload "
          f"({tables.nbytes} bytes) {setup_s - bvh_s:.3f} s")
    # the rays of a 1-spp NEE render, taken from the pipeline: the nearest-hit
    # rays of every bounce (K7; dead rays inactive) and every bounce's shadow
    # rays (K8)
    cfg_nee = RenderConfig(sky_strength=1.0, nee=True)
    sampler = make_light_sampler(scene)
    rec = mesh.RayRecorder(isect)
    fast.trace_sample_mesh(scene, cfg_nee, seed, 1, rec, light_sampler=sampler)
    # each in the walk the pipeline asked for (K8: the warp walk)
    sets = [(f"bounce {d}", rays, True, walk)
            for d, (rays, walk) in enumerate(zip(rec.soa, rec.walks))]
    sets += [(f"bounce {d} shadow", rays, False, "warp") for d, rays in enumerate(rec.tmin)]
    readings = {}
    for what, rays, full, walk in sets:
        got = mesh.KERNEL(tables, *rays, full=full, walk=walk)
        work = {}
        t0 = time.perf_counter()
        want = mesh.intersect_reference(tables, *rays, full=full, stats=work)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        a = rays[6] > 0.5
        n_act = int(a.sum())
        t_diff = a & (got[0] != want[0])
        share_t = float(t_diff.sum()) / max(n_act, 1)
        max_abs = float((got[0][a] - want[0][a]).abs().max()) if n_act else 0.0
        share_i, ties, other = 0.0, 0, 0
        if full:
            i_diff = a & (got[1] != want[1])
            share_i = float(i_diff.sum()) / max(n_act, 1)
            ties = int((i_diff & ~t_diff).sum())
            # normals and material on the active rays that are no tie
            same = a & ~i_diff
            other = sum(int((same & (g != w)).sum()) for g, w in zip(got[2:], want[2:]))
        hits = int((a & (want[0] < mesh._MISS)).sum())
        ms = _median_ms(lambda: mesh.KERNEL(tables, *rays, full=full, walk=walk))
        n = rays[0].numel()
        own = mesh.kernel_work(tables, *rays, full=full, walk=walk)
        eff = mesh.simt_efficiency(own)
        # the other walk must run the same tests
        other_walk = "lane" if walk == "warp" else "warp"
        other_work = mesh.kernel_work(tables, *rays, full=full, walk=other_walk)
        same_tests = all(own[k] == other_work[k] for k in ("sc_slab", "cl_slab", "tri"))
        flops = (n_act * (FLOPS_MESH_RAY + (FLOPS_MESH_NORMALIZE if full else 0))
                 + (own["sc_slab"] + own["cl_slab"]) * FLOPS_SLAB
                 + own["tri"] * FLOPS_TRIANGLE)
        t_ops = flops / PEAK_F32_FLOPS * 1e3
        # bytes: every slot's active flag and outputs, and an active ray's
        # origin and direction. The tables are left out: which of their rows
        # a launch must read is not counted, so the bound stays a floor
        t_bytes = (n * 4 + n_act * 24 + n * (24 if full else 4)) / PEAK_BYTES_PER_S * 1e3
        bound = (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")
        readings[what] = dict(err=max_abs, ms=ms, plain_ms=plain_ms, bound=bound, full=full)
        print(f"  {what} ({'K7' if full else 'K8'}, {walk} walk): {n} rays, {n_act} active, "
              f"{hits} hit; t differs on {share_t:.2e}, index on {share_i:.2e} of active "
              f"rays (bound {MESH_RAY_SHARE} each), {ties} tie rays, max|dt| {max_abs:.3e}, "
              f"{other} differing normal or material outputs on the other active rays; one launch "
              f"{ms:.3f} ms (median of 20), plain version {plain_ms:.1f} ms; kernel work "
              f"{own['sc_slab']} supercluster + {own['cl_slab']} cluster slab + {own['tri']} "
              f"triangle tests in {own['sc_warp']} + {own['cl_warp']} + {own['tri_warp']} warp "
              f"iterations, SIMT efficiency {eff['sc']:.4f} / {eff['cl']:.4f} / "
              f"{eff['tri']:.4f} (plain version {work['slab']} slab + {work['tri']} triangle "
              f"tests; the {other_walk} walk: the same tests {same_tests}, SIMT efficiency "
              f"{mesh.simt_efficiency(other_work)['tri']:.4f} at the triangle level); bound "
              f"{bound[0]:.4f} ms ({bound[1]})")
        if share_t > 0.0 or share_i > MESH_RAY_SHARE or other:
            raise AssertionError(f"mesh kernel ({what}) disagrees with the plain version")
        if not same_tests:
            raise AssertionError(f"mesh kernel ({what}): its two walks ran other tests")
        if not bool(torch.isfinite(got[0]).all()):
            raise AssertionError(f"mesh kernel ({what}) output is not finite")
    del rec, sets
    # per sample: the sum over its launches (one K7, and with NEE one K8, a
    # bounce) of the times, the bounds and the plain version's times
    per_sample = {}
    for name, full in (("K7", True), ("K8", False)):
        rd = [r for r in readings.values() if r["full"] == full]
        by_ops = sum(r["bound"][0] for r in rd if r["bound"][1] == "operations")
        bound = sum(r["bound"][0] for r in rd)
        per_sample[name] = dict(
            err=max(r["err"] for r in rd), ms=sum(r["ms"] for r in rd),
            plain_ms=sum(r["plain_ms"] for r in rd), launches=len(rd),
            bound=(bound, "operations" if 2 * by_ops >= bound else "bytes"))
        ps = per_sample[name]
        print(f"  {name} per sample: {ps['launches']} launches, {ps['ms']:.3f} ms against a bound "
              f"of {bound:.4f} ms ({ps['bound'][1]}), plain version {ps['plain_ms']:.1f} ms")

    legs = {}
    for phase, name, cfg in (("[17]", "mesh", RenderConfig(sky_strength=1.0)),
                             ("[18]", "mesh NEE", cfg_nee)):
        print(f"{phase} {name} leg: Renderer(mesh1080p.txt, {cfg.sky_strength=}, {cfg.nee=})")
        r = Renderer(mesh_path, cfg, device=device)
        t0 = time.perf_counter()
        r.step(1)  # warm-up
        warm = time.perf_counter() - t0
        spp = MESH_SPP
        r.reset()
        mesh.KERNEL.reset_counts()
        t0 = time.perf_counter()
        r.render(spp)
        wall = time.perf_counter() - t0
        launches = dict(mesh.KERNEL.launches_by_mode)
        img = r.linear_image()
        pixels = r.scene.camera.pixel_count
        print(f"  warm-up sample {warm:.3f} s; render({spp}): {pixels * spp / wall:.6e} rays/s, "
              f"{wall / spp * 1e3:.3f} ms/sample; launches {launches}; mean {img.mean():.6f}")
        want_launches = {"full": 8 * spp, **({"tmin": 8 * spp} if cfg.nee else {})}
        if launches != want_launches:
            raise AssertionError(f"the {name} leg launched {launches}, not {want_launches}")
        w, h = r.scene.camera.resolution
        if img.shape != (h, w, 3) or not np.isfinite(img).all() or not img.mean() > 0.0:
            raise AssertionError(f"the {name} leg's image is malformed")
        cluster = r._step.cluster
        ls = make_light_sampler(r.scene) if cfg.nee else None
        k_img = fast.trace_sample_mesh(r.scene, cfg, seed, 1, cluster, light_sampler=ls)
        # the plain pipeline on a smaller frame of the same camera and
        # triangles (the intersector's tables depend on the triangles only)
        gate = Scene.from_desc(dataclasses.replace(desc, camera=dataclasses.replace(
            desc.camera, resolution=MESH_GATE_RES)), device)
        _check_close(fast.trace_sample_mesh(gate, cfg, seed, 1, cluster, light_sampler=ls),
                     fast.trace_sample_mesh(gate, cfg, seed, 1, cluster.plain(), light_sampler=ls),
                     f"{name}: kernel pipeline vs plain pipeline, 1 spp at "
                     f"{MESH_GATE_RES[0]}x{MESH_GATE_RES[1]}")
        unsorted = fast.trace_sample_mesh(
            r.scene, dataclasses.replace(cfg, mesh_ray_sort=False), seed, 1, cluster,
            light_sampler=ls)
        sort_gap = float((k_img - unsorted).abs().max())
        print(f"  sort on vs off on the card: max |d| {sort_gap:.3e}")
        torch.testing.assert_close(k_img, unsorted, rtol=MESH_SORT_RTOL, atol=MESH_SORT_ATOL)
        legs[name] = dict(launches=launches, means=img.reshape(-1, 3).mean(0))

    spp = MESH_SPP
    deeper = Renderer(mesh_path, RenderConfig(sky_strength=1.0, trace_depth=9), device=device)
    deeper.render(spp)
    means_nee = legs["mesh NEE"]["means"]
    means_d8 = legs["mesh"]["means"]
    means_d9 = deeper.linear_image().reshape(-1, 3).mean(0)
    below = float((1.0 - means_nee / means_d8).max())
    above = float((means_nee / means_d9 - 1.0).max())
    print(f"  channel means at {spp} spp: NEE depth 8 {means_nee.tolist()}, without NEE depth 8 "
          f"{means_d8.tolist()}, depth 9 {means_d9.tolist()}; below depth 8 by {below:.4e}, "
          f"above depth 9 by {above:.4e} (slack {NEE_MEAN_RTOL} each)")
    if below > NEE_MEAN_RTOL or above > NEE_MEAN_RTOL:
        raise AssertionError("mesh NEE's channel means leave the depth-8..9 bracket")
    return {"per_sample": per_sample, "k7_launches": legs["mesh"]["launches"]["full"],
            "k8_launches": legs["mesh NEE"]["launches"]["tmin"]}


def _profile_kernels(fn, part=None):
    """One run of ``fn`` under torch.profiler: (the device's idle share of
    the wall, the device kernels launched, the device ms of the kernels
    whose name contains ``part``, 0 without one)."""
    import torch

    torch.cuda.synchronize()
    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA
            and e.device_time_total > 0]
    busy_us = sum(e.device_time_total for e in rows)
    part_us = sum(e.device_time_total for e in rows if part is not None and part in e.key)
    return 1.0 - busy_us * 1e-6 / wall, sum(e.count for e in rows), part_us * 1e-3


def _agreement(got, want):
    """(share of pixels whose max-channel |d| exceeds 1e-3, the largest
    relative gap of the channel means) of two [..., 3] images."""
    import numpy as np

    got = np.asarray(got, np.float64).reshape(-1, 3)
    want = np.asarray(want, np.float64).reshape(-1, 3)
    share = float((np.abs(got - want).max(axis=1) > 1e-3).mean())
    m_got, m_want = got.mean(axis=0), want.mean(axis=0)
    return share, float((np.abs(m_got - m_want) / np.abs(m_want)).max())


def _eager_leg(what, r, spp, kernel=None, part=None):
    """A warm-up sample, a reset, then ``r.render(spp)`` timed, then one
    more sample under torch.profiler. Prints and returns the leg's readings:
    rays/s, ms a sample, torch kernels a sample, idle share, the launches of
    ``kernel`` (a launch-counting wrapper) in the timed run, and the device
    ms a sample of the kernels named ``part`` (``part_ms``)."""
    import numpy as np
    import torch

    t0 = time.perf_counter()
    r.step(1)
    warm = time.perf_counter() - t0
    r.reset()
    if kernel is not None:
        kernel.reset_counts()
    t0 = time.perf_counter()
    r.render(spp)
    wall = time.perf_counter() - t0
    launches = None
    if kernel is not None:
        launches = (dict(kernel.launches_by_mode) if hasattr(kernel, "launches_by_mode")
                    else kernel.launches)
    img = r.linear_image()
    accum = r.state.accum.clone()
    idle, kernels, part_ms = _profile_kernels(lambda: r.step(1), part)
    idle_how = "idle share"
    if r.pipeline == "pallas":  # the profiler misses the ctypes kernels here
        idle, idle_how = _launch_idle_share(lambda: r.step(1)), "idle share at least"
    pixels = r.scene.camera.pixel_count
    out = dict(rays_per_s=pixels * spp / wall, ms_per_sample=wall / spp * 1e3,
               kernels_per_sample=kernels, idle_share=idle, launches=launches, img=img,
               accum=accum, pipeline=r.pipeline, part_ms=part_ms)
    print(f"  {what} ({r.pipeline}): warm-up sample {warm:.3f} s; render({spp}) "
          f"{out['rays_per_s']:.6e} rays/s, {out['ms_per_sample']:.3f} ms/sample; "
          f"{kernels} torch kernels a sample, {idle_how} {idle:.4f}"
          + ("" if kernel is None else f"; launches {launches}") + f"; mean {img.mean():.6f}")
    if not (np.isfinite(img).all() and img.mean() > 0.0):
        raise AssertionError(f"{what}: the image is not finite or black")
    return out


FAST_NEE_LEG = "(b) + emissive sphere, nee"


def fast_legs_scenes(scene_path):
    """Phase 20's configurations, each a (SceneDesc, RenderConfig) on the
    fast pipeline: env_spheres.txt under throughput gathering and with an
    emissive sphere added under nee (the combined NEE), both of which 'auto'
    routes there, and with its map resampled (each texel repeated 4 x 4),
    which 'auto' renders in the megakernel (phase 27) and which is named
    pipeline='fast' here, as the eager pipeline's leg at a larger map."""
    from cosc_4397_pathtracing_raytracing_project_tpu_torch import RenderConfig, parse_scene

    scenes_dir = os.path.dirname(scene_path("env_spheres.txt"))
    env_text = open(scene_path("env_spheres.txt")).read()
    lit_text = env_text.replace("\nENVIRONMENT\n", "\n" + EMITTER_MATERIAL + "ENVIRONMENT\n",
                                1) + EMITTER_OBJECT
    desc = parse_scene(env_text, base_dir=scenes_dir)
    big = big_map_desc(scene_path, 4)
    return {
        "(a) exact + throughput": (desc, RenderConfig(gather_mode="throughput")),
        FAST_NEE_LEG: (parse_scene(lit_text, base_dir=scenes_dir), RenderConfig(nee=True)),
        f"(c) map resampled to {big.env_image.shape[0]}x{big.env_image.shape[1]}, exact":
            (big, RenderConfig(pipeline="fast")),
    }


def big_map_desc(scene_path, repeat):
    """env_spheres.txt (800x800, depth 8) with the meadow map's texels each
    repeated ``repeat`` x ``repeat``: 512x1024 at 4 (6.3 MB of radiance,
    inside the 50 MB L2), 2048x4096 at 16 (100.7 MB, a production-size
    HDR past the L2)."""
    import numpy as np

    from cosc_4397_pathtracing_raytracing_project_tpu_torch import parse_scene

    desc = parse_scene(open(scene_path("env_spheres.txt")).read(),
                       base_dir=os.path.dirname(scene_path("env_spheres.txt")))
    return dataclasses.replace(desc, env_image=np.repeat(np.repeat(
        desc.env_image, repeat, 0), repeat, 1))


def mesh_env_text(scene_path):
    """Phase 23's scene: mesh1080p.txt with the meadow map's ENVIRONMENT
    block."""
    return open(scene_path("mesh1080p.txt")).read().replace(
        "\nCAMERA\n", "\nENVIRONMENT\nFILE meadow.hdr\nSTRENGTH 1\n\nCAMERA\n", 1)


def _pipeline_phases(device, seed, scene_path, ref_img, smi):
    """Phases 20-23: the fast and reference pipelines, the registry's
    models, and a mesh with a map on the reference pipeline's BVH (K7).
    Returns, for each of phase 23's legs, K7's launches in its timed run,
    their count a sample and K7's device ms a sample."""
    import numpy as np
    import torch

    from cosc_4397_pathtracing_raytracing_project_tpu_torch import (
        RenderConfig,
        Renderer,
        Scene,
        parse_scene,
    )
    from cosc_4397_pathtracing_raytracing_project_tpu_torch.models import (
        available_models,
        make_renderer,
    )
    from cosc_4397_pathtracing_raytracing_project_tpu_torch.ops.bvh import BVHIntersector
    from cosc_4397_pathtracing_raytracing_project_tpu_torch.ops.cuda import megakernel as mk
    from cosc_4397_pathtracing_raytracing_project_tpu_torch.ops.cuda import mesh_kernel as mesh
    from cosc_4397_pathtracing_raytracing_project_tpu_torch.ops.tonemap import mean_image
    from cosc_4397_pathtracing_raytracing_project_tpu_torch.render.engine import trace_sample

    scenes_dir = os.path.dirname(scene_path("cornell.txt"))
    t_phase = time.perf_counter()
    print(f"[20] fast pipeline legs: env_spheres.txt 800x800, depth 8, meadow map, "
          f"render({FAST_SPP}) ({smi})")
    legs = fast_legs_scenes(scene_path)
    fast_legs = {}
    for what, (d, cfg) in legs.items():
        r = Renderer(d, cfg, seed=seed, device=device)
        if r.pipeline != "fast":
            raise AssertionError(f"{what} took {r.pipeline!r}, not 'fast'")
        fast_legs[what] = _eager_leg(what, r, FAST_SPP)
    lit = legs[FAST_NEE_LEG][0]
    small = dataclasses.replace(lit, camera=dataclasses.replace(
        lit.camera, resolution=(FAST_GATE_RES, FAST_GATE_RES)))
    imgs = []
    for dev in (device, "cpu"):
        r = Renderer(small, RenderConfig(nee=True), seed=seed, device=dev)
        r.render(1)
        imgs.append(r.linear_image())
    share, mean_rel = _agreement(*imgs)
    print(f"  card vs CPU, (b) at {FAST_GATE_RES}x{FAST_GATE_RES}, 1 spp: share of pixels > 1e-3 "
          f"{share:.4e} (bound {ORACLE_SHARE}), channel means within {mean_rel:.4e} "
          f"(bound {ORACLE_MEAN_RTOL})")
    if share > ORACLE_SHARE or mean_rel > ORACLE_MEAN_RTOL:
        raise AssertionError("the fast pipeline on the card disagrees with the CPU")

    print(f"  phase [20] {time.perf_counter() - t_phase:.1f} s")
    t_phase = time.perf_counter()
    print(f"[21] golden through the eager pipelines: cornell_golden.txt, antialias, sobol, "
          f"{GOLDEN_EAGER_SPP} spp; each pipeline's samples in two halves, the four halves "
          f"each a process of its own, all at once")
    # host-bound, with the card idle half the time: processes on the one
    # card overlap. Every sample is keyed by its iteration index, so the
    # halves' accumulators sum to the whole render's (up to the order of
    # the float additions)
    out_dir = os.path.join(REPO, "build", "golden_eager")
    os.makedirs(out_dir, exist_ok=True)
    half = GOLDEN_EAGER_SPP // 2
    parts = {(pipeline, first): os.path.join(out_dir, f"{pipeline}_{first}.npy")
             for pipeline in ("fast", "reference") for first in (0, half)}
    procs = {key: subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--golden-eager", key[0], str(seed),
         str(key[1]), str(key[1] + half), path],
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for key, path in parts.items()}
    walls = {}
    try:
        for key, proc in procs.items():
            out, _ = proc.communicate(timeout=GOLDEN_EAGER_TIMEOUT)
            if proc.returncode != 0:
                raise AssertionError(f"pipeline={key[0]!r}'s golden process exited "
                                     f"{proc.returncode}:\n{out[-4000:]}")
            walls[key] = float(out.strip().splitlines()[-1])
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    golden = {}
    for pipeline in ("fast", "reference"):
        accum = sum(torch.from_numpy(np.load(parts[pipeline, first])) for first in (0, half))
        img = mean_image(accum, GOLDEN_EAGER_SPP).numpy().reshape(ref_img.shape)
        psnr = _golden_psnr(img, ref_img)
        wall = max(walls[pipeline, first] for first in (0, half))
        golden[pipeline] = dict(psnr=psnr, rays_per_s=accum.shape[0] * GOLDEN_EAGER_SPP / wall)
        print(f"  {pipeline}: PSNR {psnr:.4f} dB (floor {PSNR_FLOOR_1000}), "
              f"{golden[pipeline]['rays_per_s']:.6e} rays/s (the slower half's wall); each "
              f"half's ms a sample {', '.join(f'{walls[pipeline, f] / half * 1e3:.3f}' for f in (0, half))}"
              f" (four processes on the card)")
        if psnr < PSNR_FLOOR_1000:
            raise AssertionError(f"golden PSNR through pipeline={pipeline!r} below its floor")
    print(f"  phase [21] {time.perf_counter() - t_phase:.1f} s")
    t_phase = time.perf_counter()

    print(f"[22] the registry's models: cornell.txt 800x800, depth 8, render({MODEL_SPP})")
    models = {}
    runs = [(m, "none") for m in available_models()]
    runs += [("wavefront", c) for c in ("sort_alive", "sort_material")]
    for model, compaction in runs:
        r = make_renderer(model, scene_path("cornell.txt"), seed=seed, compaction=compaction,
                          device=device)
        name = model if compaction == "none" else f"{model}[{compaction}]"
        models[name] = _eager_leg(name, r, MODEL_SPP,
                                  kernel=mk.KERNEL if model == "megakernel" else None)
    if not models["megakernel"]["launches"]:
        raise AssertionError("the megakernel model never launched the megakernel")
    share, mean_rel = _agreement(models["bvh"]["accum"].cpu(), models["naive"]["accum"].cpu())
    print(f"  bvh vs naive: share of pixels > 1e-3 {share:.4e} (bound {BVH_SHARE}), channel "
          f"means within {mean_rel:.4e} (bound {BVH_MEAN_RTOL})")
    if share >= BVH_SHARE or mean_rel >= BVH_MEAN_RTOL:
        raise AssertionError("the bvh model disagrees with the naive model")
    for name, other in (("wavefront[sort_alive]", "wavefront"),
                        ("wavefront[sort_material]", "wavefront"), ("wavefront", "naive")):
        gap = float((models[name]["accum"] - models[other]["accum"]).abs().max())
        print(f"  {name} vs {other}: max |d| {gap:.3e} (rtol = atol = {WAVEFRONT_TOL})")
        torch.testing.assert_close(models[name]["accum"], models[other]["accum"],
                                   rtol=WAVEFRONT_TOL, atol=WAVEFRONT_TOL)
    print(f"  phase [22] {time.perf_counter() - t_phase:.1f} s")
    t_phase = time.perf_counter()

    print(f"[23] mesh + environment on the reference pipeline: mesh1080p.txt with the meadow "
          f"map, render({MESH_ENV_SPP})")
    mesh_text = mesh_env_text(scene_path)
    mesh_desc = parse_scene(mesh_text, base_dir=scenes_dir)
    k7 = {}
    mesh_env = {}
    for what, cfg in (("mesh + map", RenderConfig()), ("mesh + map, nee", RenderConfig(nee=True))):
        r = Renderer(mesh_desc, cfg, seed=seed, device=device)
        if (r.pipeline, cfg.resolve_intersector(r.scene)) != ("reference", "bvh"):
            raise AssertionError(f"{what} routed to {r.pipeline!r}, not 'reference' + 'bvh'")
        leg = _eager_leg(what, r, MESH_ENV_SPP, kernel=mesh.KERNEL, part="pt_mesh_intersect")
        full = leg["launches"].get("full", 0)
        print(f"  {what}: K7 launches a sample {full / MESH_ENV_SPP:.2f}, K7 device time a "
              f"sample {leg['part_ms']:.4f} ms")
        if not full:
            raise AssertionError(f"{what}: the reference pipeline never launched K7")
        k7[what] = dict(launches=full, launches_per_sample=full / MESH_ENV_SPP,
                        ms_per_sample=leg["part_ms"])
        mesh_env[what] = leg
    gate_desc = parse_scene(mesh_text.replace("RES         1920 1080",
                                              "RES         {} {}".format(*MESH_WHILE_RES)),
                            base_dir=scenes_dir)
    gate_scene = Scene.from_desc(gate_desc, device)
    cfg = RenderConfig(trace_depth=MESH_WHILE_DEPTH)
    out = {}
    for method in ("cluster", "while"):
        isect = BVHIntersector(gate_scene, leaf_size=cfg.bvh_leaf_size, tri_method=method)
        mesh.KERNEL.reset_counts()
        t0 = time.perf_counter()
        out[method] = trace_sample(gate_scene, cfg, seed, 1, isect).cpu()
        torch.cuda.synchronize()
        print(f"  {MESH_WHILE_RES[0]}x{MESH_WHILE_RES[1]}, depth {MESH_WHILE_DEPTH}, 1 spp, "
              f"triangles through {method}: {time.perf_counter() - t0:.3f} s, "
              f"K7 launches {mesh.KERNEL.launches}")
        if (method == "cluster") != (mesh.KERNEL.launches > 0):
            raise AssertionError(f"tri_method={method!r} launched K7 {mesh.KERNEL.launches} times")
    share, mean_rel = _agreement(out["cluster"], out["while"])
    print(f"  K7 vs _traverse on the card: share of pixels > 1e-3 {share:.4e} (bound {BVH_SHARE}), "
          f"channel means within {mean_rel:.4e} (bound {BVH_MEAN_RTOL})")
    if share >= BVH_SHARE or mean_rel >= BVH_MEAN_RTOL:
        raise AssertionError("the reference pipeline's K7 disagrees with its _traverse")
    drop = ("img", "accum")
    readings = dict(
        fast={k: {f: v for f, v in leg.items() if f not in drop} for k, leg in fast_legs.items()},
        golden=golden,
        models={k: {f: v for f, v in leg.items() if f not in drop} for k, leg in models.items()},
        mesh_env={k: {f: v for f, v in leg.items() if f not in drop}
                  for k, leg in mesh_env.items()})
    print("eager pipelines: " + json.dumps(readings))
    print(f"  phase [23] {time.perf_counter() - t_phase:.1f} s")
    return k7


def _golden_eager(pipeline, seed, first, last, out):
    """Part of phase 21 in a process of its own (``chip_smoke.py
    --golden-eager <pipeline> <seed> <first> <last> <out.npy>``): the
    golden's samples ``first + 1`` to ``last`` through ``pipeline`` on the
    card; saves their accumulator to ``out`` and prints the render's wall
    seconds."""
    import numpy as np
    import torch

    sys.path.insert(0, REPO)
    from cosc_4397_pathtracing_raytracing_project_tpu_torch import RenderConfig, Renderer

    r = Renderer(os.path.join(REPO, "scenes", "cornell_golden.txt"),
                 RenderConfig(antialias=True, sampler="sobol", pipeline=pipeline,
                              samples_per_launch=50), seed=seed, device=torch.device("cuda", 0))
    r.state = dataclasses.replace(r.state, iteration=first)
    r._host_iteration = first
    t0 = time.perf_counter()
    r.render(last)
    wall = time.perf_counter() - t0
    np.save(out, r.state.accum.cpu().numpy())
    print(wall)
    return 0


def _cli(args):
    """Start ``python -m <the port> args`` from the repository's root."""
    return subprocess.Popen(
        [sys.executable, "-m", "cosc_4397_pathtracing_raytracing_project_tpu_torch", *args],
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )


def _finish(proc, what):
    """Wait for a command line run (killed if it outlives CLI_TIMEOUT); any
    exit but 0 fails the phase."""
    try:
        out, _ = proc.communicate(timeout=CLI_TIMEOUT)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    if proc.returncode != 0:
        raise AssertionError(f"the command line's {what} run exited {proc.returncode}:\n{out[-4000:]}")


def _exact_ties(scene, o, d):
    """Which rays' nearest hit is an exact tie on ``scene`` (on the CPU):
    two primitives at the same distance, or, on a cube, two slab axes
    entering at the same distance (an edge, whose face is the tie). The
    card's torch may break such a tie in another order than the CPU's."""
    import torch

    from cosc_4397_pathtracing_raytracing_project_tpu_torch.ops import intersect as ix

    cand = []
    if scene.cubes.count:
        cand.append(ix.cube_candidate_t(scene.cubes, o, d))
    if scene.spheres.count:
        cand.append(ix.sphere_candidate_t(scene.spheres, o, d))
    if scene.num_triangles:
        cand.append(ix.triangle_candidate_t(scene.triangles, o, d))
    t, idx = torch.sort(torch.cat(cand, dim=1), dim=1)
    ties = (t[:, 0] == t[:, 1]) & (t[:, 0] < 1e30)  # 1e30: a miss
    if scene.cubes.count:
        is_cube = idx[:, 0] < scene.cubes.count
        inv = scene.cubes.inv_transform[torch.where(is_cube, idx[:, 0], 0)]
        q_o, q_d = ix._to_object_space(inv, o, d)
        enter = torch.minimum((-0.5 - q_o) / q_d, (0.5 - q_o) / q_d)
        top = torch.sort(torch.where(enter > 0, enter, -3.4e38), dim=1, descending=True).values
        ties |= is_cube & (top[:, 0] == top[:, 1]) & (top[:, 0] > 0)
    return ties


@contextlib.contextmanager
def _sqrt_on(device):
    """``torch.sqrt`` of every tensor computed on ``device`` and brought
    back. Torch's float32 sqrt rounds some inputs differently on the CPU
    and on the card (the CPU's also differs from the correctly rounded
    value, a float64 sqrt on the card rounded to float32), while its
    add, multiply and divide agree bit for bit."""
    import torch

    sqrt = torch.sqrt
    torch.sqrt = lambda x: sqrt(x.to(device)).to(x.device)
    try:
        yield
    finally:
        torch.sqrt = sqrt


def _aovs_agree(what, got, want, scene_cpu):
    """The AOV pass on the card against the CPU: miss masks identical,
    depth, albedo and normal within AOV_TOL but on at most ORACLE_SHARE of
    pixels (card against CPU, the same code), each of which the card's sqrt
    explains: traced again on the CPU with the card's sqrt it gives the
    card's AOVs within AOV_TOL, or its nearest hit is an exact tie that the
    two devices break in different orders."""
    import torch

    from cosc_4397_pathtracing_raytracing_project_tpu_torch.ops.intersect import (
        intersect_scene,
        take_rows,
    )
    from cosc_4397_pathtracing_raytracing_project_tpu_torch.render.denoise import _center_rays

    if not torch.equal(got.miss.cpu(), want.miss):
        raise AssertionError(f"{what}: the card's miss mask differs from the CPU's")
    diffs = [(g.cpu() - w).abs() for g, w in zip(got[:3], want[:3])]
    diffs = [d.amax(dim=-1) if d.dim() == 3 else d for d in diffs]
    diffs[2] = diffs[2] / torch.clamp_min(want.depth, 1.0)  # depth: relative
    off = (diffs[0] > AOV_TOL) | (diffs[1] > AOV_TOL) | (diffs[2] > AOV_TOL)
    rest = max(float(torch.where(off, 0.0, d).max()) for d in diffs)
    n_off = int(off.sum())
    if n_off:
        ys, xs = torch.nonzero(off, as_tuple=True)
        rays = _center_rays(scene_cpu.camera, ys * want.miss.shape[1] + xs)
        with _sqrt_on(got.miss.device):
            hit = intersect_scene(scene_cpu, *_center_rays(scene_cpu.camera,
                                                           ys * want.miss.shape[1] + xs))
        card = [g.cpu()[ys, xs] for g in got[:3]]
        explained = (
            ((take_rows(scene_cpu.materials.color, hit.material_id) - card[0]).abs().amax(dim=1)
             <= AOV_TOL)
            & ((hit.normal - card[1]).abs().amax(dim=1) <= AOV_TOL)
            & ((hit.t - card[2]).abs() <= AOV_TOL * torch.clamp_min(card[2], 1.0))
        ) | _exact_ties(scene_cpu, *rays)
        if not bool(explained.all()) or n_off > ORACLE_SHARE * off.numel():
            raise AssertionError(f"{what}: {n_off} pixels differ, explained "
                                 f"{explained.tolist()} at {list(zip(ys.tolist(), xs.tolist()))}")
    print(f"  {what}: miss masks identical; max |d| (depth: relative) {rest:.3e} (bound "
          f"{AOV_TOL}) but on {n_off} "
          f"pixels (bound {ORACLE_SHARE} of {off.numel()}), each reproduced on the CPU with the "
          f"card's sqrt, or an exact tie")


def _rank_legs(what, results, rays, backend, sp):
    """Print a sharded leg's backend, world size, time and rays/s (``rays``
    primary samples over the slowest rank's time) and return rank 0's
    result; every rank must hold the same frame."""
    if len({str(r["digest"]) for r in results}) != 1:
        raise AssertionError(f"{what}: the ranks hold different results")
    seconds = max(r["seconds"] for r in results)
    world = len(results)
    print(f"  {what}: {backend}, world {world} (sp={sp}, dp={world // sp}), "
          f"{seconds:.4f} s, {rays / seconds:.6e} rays/s (ranks share one card)")
    return results[0]


def _launched(what, results, kernel, key):
    """Every rank launched ``kernel``'s ``key`` in its timed run (counts set
    to 0 just before it)."""
    counts = [r["launches"][kernel].get(key, 0) for r in results]
    print(f"  {what}: {kernel} {key!r} launches by rank {counts}")
    if min(counts) <= 0:
        raise AssertionError(f"{what}: a rank never launched {kernel} {key!r}")


def _multi_device_phase(device, seed, scene_path, ref_img, smi):
    """Phase 25: multi-device rendering (parallel/) on the card."""
    import numpy as np
    import torch

    from cosc_4397_pathtracing_raytracing_project_tpu_torch import (
        AdaptiveRenderer,
        RenderConfig,
        RenderState,
        Scene,
        load_scene_desc,
    )
    from cosc_4397_pathtracing_raytracing_project_tpu_torch.ops.cuda import megakernel as mk
    from cosc_4397_pathtracing_raytracing_project_tpu_torch.ops.lights import make_light_sampler
    from cosc_4397_pathtracing_raytracing_project_tpu_torch.parallel import spawn_ranks
    from cosc_4397_pathtracing_raytracing_project_tpu_torch.parallel.dryrun import (
        dryrun_multichip,
        run_cases,
        scene_desc,
    )
    from cosc_4397_pathtracing_raytracing_project_tpu_torch.render.engine import (
        make_mesh_step,
        make_pallas_step,
        render_chunk,
    )

    t_phase = time.perf_counter()
    print(f"[25] multi-device rendering ({smi}): every rank a process on this one card, so "
          f"no rays/s here is a scaling number")
    # (a) the kernel on a slice of the frame against its plain version
    offset, n, tile_base = MD_SLICE
    scenes = {}
    for case, name, cfg in (
        ("main", "cornell.txt", RenderConfig(sampler="sobol")),
        ("nee", "cornell_golden.txt", RenderConfig(nee=True, antialias=True, sampler="sobol")),
        ("env exact", "env_spheres.txt", RenderConfig(sampler="sobol")),
        ("env nee", "env_spheres.txt", RenderConfig(nee=True)),
        ("split", "env_spheres.txt", RenderConfig(env_mode="split")),
    ):
        if name not in scenes:
            scenes[name] = Scene.from_desc(load_scene_desc(scene_path(name)), device)
        sc = scenes[name]
        opts = mk.kernel_options(cfg, sc)
        pk = mk.pack_scene(sc, nee=opts.nee, config=cfg)
        got = mk.render_samples(sc, cfg, seed, 3, 2, packed=pk, pixel_offset=offset,
                                num_pixels=n, tile_base=tile_base)
        pix = offset + torch.arange(n, device=device)
        stats = {} if case == "main" else None
        want = mk._add_background(
            mk.render_samples_reference(pix, pk, opts, seed, 3, 2, stats=stats,
                                        tile_base=tile_base), pk, opts, 2, offset)
        torch.cuda.synchronize()
        _check_close(got, want, f"(a) {case} [{mk.variant_name(opts)}], pixels {offset} .. "
                     f"{offset + n - 1}, tiles from {tile_base}, 2 spp")
        if not opts.nee and not torch.equal(got, want):
            raise AssertionError(f"(a) {case}: a variant without NEE differs from its plain "
                                 f"version")
        if case == "main":
            counted, owners = mk.kernel_warp_work(pk, opts, seed, 3, 2, device,
                                                  pixel_offset=offset, num_pixels=n,
                                                  tile_base=tile_base)
            steps, draws = mk.path_lengths(stats)
            em = mk.warp_schedule(steps, draws, mk.SCHEDULE, **mk.schedule_args(opts),
                                  owners=owners, vis=mk.path_visibility(stats), width=pk.width,
                                  pixel_offset=offset)
            print(f"  (a) main slice, counting build {counted}; emulation equal "
                  f"{counted == {k: em[k] for k in mk.WORK}}; spread {em['spread']}")
            if counted != {k: em[k] for k in mk.WORK}:
                raise AssertionError("(a) the counting build on a slice differs from the "
                                     "emulation")

    main_cfg = RenderConfig(sampler="sobol")
    cornell = dict(scene=scene_path("cornell.txt"))
    aligned = dict(scene=scene_path("cornell.txt"), resolution=MD_ALIGNED_RES)
    mesh_scene = dict(scene=scene_path("mesh1080p.txt"))
    mesh_cfg = RenderConfig(sky_strength=1.0)
    step = lambda pipeline, sc, cfg, spp, sp, **kw: dict(  # noqa: E731
        kind="step", pipeline=pipeline, scene=sc, config=cfg, samples=spp, sp=sp, seed=seed, **kw)
    groups = {
        ("gloo", 2, 1): {
            "cornell": step("pallas", cornell, main_cfg, MD_STEP_SPP, 1, warmup=1),
            "aligned": step("pallas", aligned, main_cfg, MD_ALIGNED_SPP, 1),
            "mesh": step("mesh", mesh_scene, mesh_cfg, MD_MESH_SPP, 1),
            "mesh nee": step("mesh", mesh_scene, dataclasses.replace(mesh_cfg, nee=True),
                             MD_MESH_SPP, 1),
            "adaptive": dict(kind="adaptive", scene=dict(scene=scene_path("cornell_golden.txt")),
                             config=RenderConfig(nee=True, sampler="sobol"), seed=seed,
                             **MD_ADAPTIVE),
        },
        ("gloo", 4, 2): {
            "cornell": step("pallas", cornell, main_cfg, MD_STEP_SPP, 2, warmup=1),
            "golden": step("pallas", dict(scene=scene_path("cornell_golden.txt")),
                           RenderConfig(antialias=True, sampler="sobol"), MD_GOLDEN_SPP, 2),
            "aligned": step("pallas", aligned, main_cfg, MD_ALIGNED_SPP, 2),
            "fast": step("fast", dict(scene=scene_path("env_spheres.txt")),
                         RenderConfig(nee=True), MD_FAST_SPP, 2),
        },
        ("nccl", torch.cuda.device_count(), 1): {
            "cornell": step("pallas", cornell, main_cfg, MD_STEP_SPP, 1, warmup=1),
        },
    }
    out = {}
    for (backend, world, sp), cases in groups.items():
        t0 = time.perf_counter()
        ranks = spawn_ranks(run_cases, world, backend, device, args=(sp, list(cases.values())),
                            timeout=MD_TIMEOUT)
        print(f"  {backend} group of {world} ranks: {time.perf_counter() - t0:.1f} s with "
              f"the ranks' start")
        for i, name in enumerate(cases):
            out[(backend, world, name)] = [r[i] for r in ranks]

    def fresh(scene):
        return RenderState.create(scene.camera.pixel_count, seed, device)

    # (b) the main path's step: cornell.txt 800x800, depth 8, sobol
    for key in (("gloo", 2, "cornell"), ("gloo", 4, "cornell"),
                ("nccl", torch.cuda.device_count(), "cornell")):
        sp = 2 if key[1] == 4 else 1
        pixels = out[key][0]["accum"].shape[0]
        res = _rank_legs(f"(b) cornell.txt sobol, {MD_STEP_SPP} spp"
                         + (" (g: NCCL)" if key[0] == "nccl" else ""),
                         out[key], pixels * MD_STEP_SPP, key[0], sp)
        _launched("(b)", out[key], "megakernel", "main")
        img = res["accum"]
        if not bool(torch.isfinite(img).all()) or not float(img.mean()) > 0:
            raise AssertionError(f"{key}: the sharded main path's image is not finite or black")
    accum = out[("gloo", 4, "golden")][0]["accum"]
    res = _rank_legs(f"(b) golden: cornell_golden.txt, antialias, sobol, {MD_GOLDEN_SPP} spp",
                     out[("gloo", 4, "golden")], accum.shape[0] * MD_GOLDEN_SPP, "gloo", 2)
    psnr = _golden_psnr((accum / MD_GOLDEN_SPP).numpy().reshape(ref_img.shape), ref_img)
    print(f"  (b) golden through the world-4 step: {psnr:.4f} dB (floor {PSNR_FLOOR_1000})")
    if not psnr >= PSNR_FLOOR_1000:
        raise AssertionError("(b) golden PSNR through the sharded step below its floor")

    # (c) the TILE-aligned frame: sp = 1 bit for bit, sp = 2 within rtol
    sc = Scene.from_desc(scene_desc(aligned), device)
    single = make_pallas_step()(sc, fresh(sc), main_cfg, MD_ALIGNED_SPP).accum.cpu()
    pixels = MD_ALIGNED_RES[0] * MD_ALIGNED_RES[1]
    got1 = _rank_legs("(c) 1024x800 aligned", out[("gloo", 2, "aligned")],
                      pixels * MD_ALIGNED_SPP, "gloo", 1)["accum"]
    got2 = _rank_legs("(c) 1024x800 aligned", out[("gloo", 4, "aligned")],
                      pixels * MD_ALIGNED_SPP, "gloo", 2)["accum"]
    gap = float(((got2 - single).abs() - MD_SP_RTOL * single.abs()).max())
    print(f"  (c) sp=1 bit for bit the single device: {torch.equal(got1, single)}; sp=2 max "
          f"|d| - rtol|want| {gap:.3e} (atol {MD_SP_ATOL})")
    if not torch.equal(got1, single):
        raise AssertionError("(c) the sp=1 step on TILE-aligned slices differs from the "
                             "single device")
    if not torch.allclose(got2, single, rtol=MD_SP_RTOL, atol=MD_SP_ATOL):
        raise AssertionError("(c) the sp=2 step differs from the single device past its bound")

    # (d) mesh1080p, dp = 2, with and without NEE
    sc = Scene.from_desc(scene_desc(mesh_scene), device)
    for name, cfg in (("mesh", mesh_cfg), ("mesh nee", dataclasses.replace(mesh_cfg, nee=True))):
        sampler = make_light_sampler(sc) if cfg.nee else None
        single = make_mesh_step(sc, sampler)(sc, fresh(sc), cfg, MD_MESH_SPP).accum
        res = _rank_legs(f"(d) {name}: mesh1080p, {MD_MESH_SPP} spp",
                         out[("gloo", 2, name)], sc.camera.pixel_count * MD_MESH_SPP, "gloo", 1)
        _launched(f"(d) {name}", out[("gloo", 2, name)], "mesh", "full")
        if cfg.nee:
            _launched(f"(d) {name}", out[("gloo", 2, name)], "mesh", "tmin")
        _check_close(res["accum"].to(device), single, f"(d) {name} sharded vs single device")

    # (e) the fast step on env_spheres, sp = 2, dp = 2
    sc = Scene.from_desc(scene_desc(dict(scene=scene_path("env_spheres.txt"))), device)
    single = (render_chunk(sc, fresh(sc), RenderConfig(nee=True), MD_FAST_SPP).accum.cpu()
              / MD_FAST_SPP)
    res = _rank_legs(f"(e) fast, env NEE: env_spheres.txt, {MD_FAST_SPP} spp",
                     out[("gloo", 4, "fast")], sc.camera.pixel_count * MD_FAST_SPP, "gloo", 2)
    got = res["accum"] / MD_FAST_SPP
    rel = abs(float(got.mean()) - float(single.mean())) / float(single.mean())
    corr = float(np.corrcoef(got.mean(-1).numpy(), single.mean(-1).numpy())[0, 1])
    print(f"  (e) mean rel gap {rel:.4e} (bound {MD_FAST_MEAN_RTOL}), correlation {corr:.4f} "
          f"(bound {MD_FAST_CORR})")
    if not (rel < MD_FAST_MEAN_RTOL and corr > MD_FAST_CORR):
        raise AssertionError("(e) the sharded fast step disagrees with the single device")

    # (f) golden NEE adaptive at world 2 against the unsharded renderer
    spec = groups[("gloo", 2, 1)]["adaptive"]
    ref = AdaptiveRenderer(scene_desc(spec["scene"]), spec["config"], seed=seed, device=device)
    ref.warmup(spec["warmup"])
    sels = [ref.refine(spp, frac).cpu() for spp, frac in spec["rounds"]]
    res = _rank_legs("(f) adaptive golden NEE: warm-up and rounds (lanes x samples dispatched)",
                     out[("gloo", 2, "adaptive")], ref._lane_budget_spent, "gloo", 1)
    if res["lanes"] != ref._lane_budget_spent:
        raise AssertionError("(f) the sharded renderer dispatched other work than the unsharded")
    _launched("(f)", out[("gloo", 2, "adaptive")], "megakernel", "nee+tiles")
    same = all(a.tolist() == b.tolist() for r in out[("gloo", 2, "adaptive")]
               for a, b in zip(r["selections"], sels))
    print(f"  (f) selections equal to the unsharded renderer's: {same}")
    _check_close(torch.from_numpy(np.ascontiguousarray(res["image"])).reshape(-1, 3),
                 torch.from_numpy(ref.linear_image()).reshape(-1, 3),
                 "(f) sharded adaptive image vs unsharded")

    # (h) the dry run
    t0 = time.perf_counter()
    dry = dryrun_multichip(4, "gloo", device)
    print(f"  (h) dry run: {time.perf_counter() - t0:.1f} s; phase [25] "
          f"{time.perf_counter() - t_phase:.1f} s")
    return dry


def _host_runtime_phase(device, seed, scene_path, host_build, smi):
    """Phase 26: the native host runtime (native/, built in phase 1 from the
    checkout's source) against its plain versions on this machine's CPU,
    a production-size map through it, and the single-device entry point.
    ``host_build`` is phase 1's (library path, build seconds)."""
    import numpy as np
    import torch

    from cosc_4397_pathtracing_raytracing_project_tpu_torch import (
        RenderConfig,
        Renderer,
        Scene,
        load_scene_desc,
    )
    from cosc_4397_pathtracing_raytracing_project_tpu_torch import entry as entry_mod
    from cosc_4397_pathtracing_raytracing_project_tpu_torch.io import png
    from cosc_4397_pathtracing_raytracing_project_tpu_torch.native import runtime
    from cosc_4397_pathtracing_raytracing_project_tpu_torch.ops import bvh as bvh_ops
    from cosc_4397_pathtracing_raytracing_project_tpu_torch.ops import envmap
    from cosc_4397_pathtracing_raytracing_project_tpu_torch.ops.cuda import build
    from cosc_4397_pathtracing_raytracing_project_tpu_torch.scene import parser

    def timed(fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        return out, time.perf_counter() - t0

    t_phase = time.perf_counter()
    print(f"[26] the host runtime (native/) and the single-device entry point ({smi}); host "
          f"times are this machine's CPU")
    path, build_s = host_build
    compiler = subprocess.run([build.host_compiler(), "--version"], capture_output=True,
                              text=True).stdout.splitlines()[0]
    if runtime.ensure_built() != path or not path.exists():
        raise AssertionError(f"the host runtime is not the library phase 1 built ({path})")
    print(f"  (a) {path.relative_to(REPO)}, built from "
          f"{build.host_source_path(runtime.NAME).relative_to(REPO)} by {compiler} "
          f"{' '.join(build.HOST_FLAGS + build.HOST_LIBS)} in {build_s:.3f} s")

    # (b) mesh1080p: its OBJ files, then the BVH of make_mesh_intersector
    mesh_path = scene_path("mesh1080p.txt")
    objs = [line.split()[1] for line in open(mesh_path) if line.split()[:1] == ["FILE"]
            and line.split()[1].endswith(".obj")]
    for name in objs:
        obj = scene_path(name)
        got, native_s = timed(runtime.load_obj_triangles, obj)
        want, plain_s = timed(parser.load_obj_triangles, obj)
        same = got.shape == want.shape and np.array_equal(got.view(np.uint32),
                                                          want.view(np.uint32))
        print(f"  (b) {name}: {len(got)} triangles, native {native_s:.4f} s, plain "
              f"{plain_s:.4f} s, bit for bit {same}")
        if not same:
            raise AssertionError(f"the native OBJ loader disagrees with the plain one on {name}")
    tri = Scene.from_desc(load_scene_desc(mesh_path), "cpu").triangles
    v0, e1, e2 = (t.numpy() for t in (tri.v0, tri.e1, tri.e2))
    tmin = np.minimum(np.minimum(v0, v0 + e1), v0 + e2)
    tmax = np.maximum(np.maximum(v0, v0 + e1), v0 + e2)
    got, native_s = timed(bvh_ops.try_native_build, tmin, tmax, 8)
    want, plain_s = timed(bvh_ops.build_bvh, tmin, tmax, 8)
    fields = ("order", "miss_link", "leaf_start", "leaf_count", "bounds_min", "bounds_max")
    differ = [f for f in fields if not (getattr(got, f).shape == getattr(want, f).shape
                                        and np.array_equal(getattr(got, f).view(np.uint32),
                                                           getattr(want, f).view(np.uint32)))]
    print(f"  (b) BVH over {len(v0)} triangle boxes, leaf 8: {got.num_nodes} nodes (plain "
          f"{want.num_nodes}); native {native_s:.4f} s, plain {plain_s:.4f} s "
          f"({plain_s / native_s:.1f}x); fields that differ (bounds bit for bit): {differ}")
    if differ or got.num_nodes != want.num_nodes:
        raise AssertionError(f"the native BVH differs from the plain build in {differ}")

    # (c) a 2048x4096 map: its alias table native against plain, then
    # env_spheres under it on the fast pipeline (named: 'auto' takes the
    # megakernel, phase 27) in exact mode and with env NEE
    big = big_map_desc(scene_path, HOST_MAP_REPEAT)
    (p, _), dist_s = timed(envmap.texel_distribution, big.env_image)
    (prob, alias), native_s = timed(runtime.build_alias, p)
    (pprob, palias), plain_s = timed(envmap._build_alias, p)
    same = np.array_equal(prob.view(np.uint64), pprob.view(np.uint64)) and np.array_equal(
        alias, palias)
    env, env_s = timed(envmap.build_envmap, big.env_image, big.env_strength, device)
    same_env = (np.array_equal(env.alias_prob.cpu().numpy(), prob.astype(np.float32))
                and np.array_equal(env.alias_idx.cpu().numpy(), alias))
    h, w = big.env_image.shape[:2]
    print(f"  (c) {h}x{w} map ({h * w} texels): texel distribution {dist_s:.3f} s; alias "
          f"table native {native_s:.4f} s, plain {plain_s:.3f} s ({plain_s / native_s:.0f}x), "
          f"bit for bit {same}; build_envmap to {device} {env_s:.3f} s, its tables the native "
          f"ones {same_env}")
    if not (same and same_env):
        raise AssertionError("the native alias table disagrees with the plain one")
    del env, p, prob, alias, pprob, palias
    for what, cfg in (("exact", RenderConfig(pipeline="fast")),
                      ("env NEE", RenderConfig(nee=True, pipeline="fast"))):
        r, setup_s = timed(Renderer, big, cfg, seed, device)
        if r.pipeline != "fast":
            raise AssertionError(f"the {h}x{w} map ({what}) took {r.pipeline!r}, not 'fast'")
        r.step(1)  # warm-up
        r.reset()
        t0 = time.perf_counter()
        r.render(HOST_ENV_SPP)
        wall = time.perf_counter() - t0
        img = r.linear_image()
        rays = r.scene.camera.pixel_count * HOST_ENV_SPP / wall
        print(f"  (c) env_spheres.txt under the {h}x{w} map, {what} ({r.pipeline}): set-up "
              f"{setup_s:.3f} s, render({HOST_ENV_SPP}) {rays:.6e} rays/s, "
              f"{wall / HOST_ENV_SPP * 1e3:.3f} ms/sample, mean {img.mean():.6f}")
        if not (np.isfinite(img).all() and img.mean() > 0.0):
            raise AssertionError(f"the {h}x{w} map's {what} frame is not finite or black")
        del r

    # (d) PNG: the golden image written natively reads back equal; its
    # decode through the native defilter equals the NumPy path's
    golden = os.path.join(REPO, "tests", "data", "REFERENCE_cornell.5000samp.png")
    img = png.read_png(golden)
    out_dir = os.path.join(REPO, "build", "host_runtime")
    os.makedirs(out_dir, exist_ok=True)
    written, write_s = timed(png.write_png, os.path.join(out_dir, "golden.png"), img)
    back = png.read_png(written)
    same_bytes = open(written, "rb").read() == png.encode_png(img)
    raw, (height, width, channels) = png._scanlines(golden)
    filters = np.bincount(raw[:, 0], minlength=5)
    got, native_s = timed(png._defilter, raw.copy(), height, width * channels, channels)
    want, plain_s = timed(png._defilter_reference, raw.copy(), height, width * channels, channels)
    print(f"  (d) golden {width}x{height} written natively in {write_s:.4f} s reads back equal "
          f"{np.array_equal(back, img)} (bytes equal to encode_png's {same_bytes}); its rows' "
          f"filters {filters.tolist()}; defilter native {native_s * 1e3:.3f} ms, plain "
          f"{plain_s * 1e3:.3f} ms, equal {np.array_equal(got, want)}")
    if not (np.array_equal(back, img) and np.array_equal(got, want)):
        raise AssertionError("the native PNG writer or defilter disagrees with the plain path")

    # (e) the single-device entry point: the card against the CPU, then one
    # call at full size on the card
    outs = []
    for dev in (device, "cpu"):
        fn, args = entry_mod.entry(dev, (ENTRY_GATE_RES, ENTRY_GATE_RES))
        outs.append(fn(*args).accum.cpu())
    share, mean_rel = _agreement(*outs)
    print(f"  (e) entry() at {ENTRY_GATE_RES}x{ENTRY_GATE_RES}, card against CPU: share of "
          f"pixels > 1e-3 {share:.4e} (bound {ORACLE_SHARE}), channel means within "
          f"{mean_rel:.4e} (bound {ORACLE_MEAN_RTOL})")
    if share > ORACLE_SHARE or mean_rel > ORACLE_MEAN_RTOL:
        raise AssertionError("entry() on the card disagrees with the CPU")
    (fn, args), setup_s = timed(entry_mod.entry)
    fn(*args)  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn(*args)
    torch.cuda.synchronize()
    call_s = time.perf_counter() - t0
    pixels = args[0].camera.pixel_count
    print(f"  (e) entry() at full size ({pixels} pixels) on {out.accum.device}: set-up "
          f"{setup_s:.3f} s, one call {call_s:.4f} s after a warm-up ({pixels / call_s:.6e} "
          f"rays/s), iteration {out.iteration}, mean {float(out.accum.mean()):.6f}")
    if not (out.accum.device.type == "cuda" and out.iteration == 1
            and bool(torch.isfinite(out.accum).all()) and float(out.accum.mean()) > 0.0):
        raise AssertionError("entry()'s accumulator is not a finite frame on the card")
    print(f"  phase [26] {time.perf_counter() - t_phase:.1f} s")
    return big


def _launch_idle_share(fn):
    """A lower bound on the device's idle share of the wall of one run of
    ``fn``, timed without torch.profiler: 1 - (the megakernel's and the row
    kernel's launches, each between CUDA events recorded on the current
    stream just before and after its ctypes call) / the wall. A call's own
    host work (argument conversion, the C entry's checks, the queue's memset
    and the launch, microseconds) counts as busy when the card waits on it,
    and the torch kernels of a step (the accumulator's add) as idle. Late
    in this script torch.profiler no longer reports the ctypes kernels'
    device time (phase 22's megakernel model read an idle share of 1 under
    it), so phases 22 and 27 take this."""
    import torch

    from cosc_4397_pathtracing_raytracing_project_tpu_torch.ops.cuda import megakernel as mk

    mk.KERNEL._fn()  # loads the library
    lib = mk.KERNEL._lib
    names = ("pt_megakernel_launch", "pt_env_rows_launch")
    originals = {name: getattr(lib, name) for name in names}
    spans = []

    def timed(call):
        def run(*args):
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            try:
                return call(*args)
            finally:
                stop.record()
                spans.append((start, stop))
        return run

    for name, call in originals.items():
        setattr(lib, name, timed(call))
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        for name, call in originals.items():
            setattr(lib, name, call)
    if not spans:
        raise AssertionError("no megakernel or row kernel launch was timed")
    busy = sum(start.elapsed_time(stop) for start, stop in spans) * 1e-3
    return 1.0 - busy / wall


def _lookup_bound(packed, opts, work, out_bytes, other_bytes, env_rows=0):
    """The bound with the map's bytes counted per lookup, not once: every
    escape's bilinear lookup reads its four texels at 12 bytes (the
    radiance) and K4's pdf lookup its texel's 4 bytes, from the plain
    version's counts of this run (``work``), beside ``other_bytes``."""
    lookup_bytes = 48 * int(work.get("env_lookup", 0)) + 4 * int(work.get("env_pdf", 0))
    return _bound(packed, opts, work, out_bytes, other_bytes + lookup_bytes, env_rows=env_rows)


def env_nee_bracket(scene, seed, device, spp):
    """Phase 13's env-NEE gate on ``scene``: the per-channel image means of
    env NEE at depth 8 and of the exact estimator at depth 8 and 9, each a
    ``render(spp)`` with ``seed``; returns them with how far env NEE lies
    below the depth-8 means and above the depth-9 means (the largest
    channel's relative gap)."""
    from cosc_4397_pathtracing_raytracing_project_tpu_torch import RenderConfig, Renderer

    means = []
    for cfg in (RenderConfig(samples_per_launch=200, nee=True),
                RenderConfig(samples_per_launch=200),
                RenderConfig(samples_per_launch=200, trace_depth=9)):
        r = Renderer(scene, cfg, seed=seed, device=device)
        r.render(spp)
        means.append(r.linear_image().reshape(-1, 3).mean(0))
        del r
    nee, d8, d9 = means
    return nee, d8, d9, float((1.0 - nee / d8).max()), float((nee / d9 - 1.0).max())


def _big_map_phase(device, seed, chunk, scene_path, big, smi):
    """Phase 27: exact maps past the JAX kernel's VMEM cap render in the
    megakernel, and env NEE under them stays in phase 13's depth bracket.
    ``big`` is phase 26's 2048x4096 map (its SceneDesc); the 512x1024 map
    is phase 20's. Returns, per map, K3's, K4's (with the row kernel's) and
    K6's readings for the kernels line."""
    import numpy as np
    import torch

    from cosc_4397_pathtracing_raytracing_project_tpu_torch import (
        AdaptiveRenderer,
        RenderConfig,
        Renderer,
        Scene,
    )
    from cosc_4397_pathtracing_raytracing_project_tpu_torch.ops.cuda import megakernel as mk

    t_phase = time.perf_counter()
    print(f"[27] exact maps past the JAX kernel's cap in the megakernel: env_spheres.txt "
          f"800x800, depth 8 ({smi})")
    out = {}
    for desc in (big_map_desc(scene_path, 4), big):
        h, w = desc.env_image.shape[:2]
        size = f"{h}x{w}"
        scene = Scene.from_desc(desc, device)
        pix = torch.arange(scene.camera.pixel_count, device=device)
        res = {}
        # K3 and K4 against their plain versions at 2 spp (K3 bit for bit),
        # then one 50-sample launch of each: times and bounds
        for key, cfg in (("K3", RenderConfig()), ("K4", RenderConfig(nee=True))):
            opts = mk.kernel_options(cfg, scene)
            pk = mk.pack_scene(scene, config=cfg)
            rows2 = mk.env_nee_rows(pk, seed, 1, 2, opts.trace_depth) if opts.env_nee else None
            got = mk.KERNEL(pk, opts, seed, 1, 2, device, env_rows=rows2)
            want = mk.render_samples_reference(pix, pk, opts, seed, 1, 2, env_rows=rows2)
            err = _check_close(got, want, f"{size} {key} [{mk.variant_name(opts)}], 2 spp")
            if key == "K3" and not torch.equal(got, want):
                raise AssertionError(f"K3 at {size} is not bit for bit its plain version")
            del got, want
            n_rows = chunk * opts.trace_depth if opts.env_nee else 0
            rows = mk.env_nee_rows(pk, seed, 1, chunk, opts.trace_depth) if n_rows else None
            k_ms = _time_ms(lambda: mk.KERNEL(pk, opts, seed, 1, chunk, device, env_rows=rows),
                            reps=3)
            work = {}
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            mk.render_samples_reference(pix, pk, opts, seed, 1, chunk, env_rows=rows, stats=work)
            torch.cuda.synchronize()
            p_ms = (time.perf_counter() - t0) * 1e3
            other = n_rows * (8 + 6 * pk.num_geoms) * 4
            bnd = _bound(pk, opts, work, pix.numel() * 12, _map_bytes(pk, opts) + other,
                         env_rows=n_rows)
            lbnd = _lookup_bound(pk, opts, work, pix.numel() * 12, other, env_rows=n_rows)
            res[key] = dict(err=err, ms=k_ms, plain_ms=p_ms, bound=bnd, lookup_bound=lbnd,
                            lookups=int(work.get("env_lookup", 0)))
            if opts.env_nee:
                # the row kernel bit for bit its plain version under this map
                # (past 2^15 texels the alias cell from words of its own)
                res[key]["rows"] = _row_kernel_check(pk, opts, seed, chunk)
            print(f"  {size} {key}: one {chunk}-sample launch: kernel {k_ms:.4f} ms, plain "
                  f"version {p_ms:.1f} ms (one run, counting its work); bound {bnd[0]:.4f} ms "
                  f"({bnd[1]}; the map's {_map_bytes(pk, opts)} bytes once); with the map's bytes "
                  f"counted per lookup ({res[key]['lookups']} lookups x 48 bytes"
                  + (f" + {int(work.get('env_pdf', 0))} pdf lookups x 4" if opts.env_nee else "")
                  + f") {lbnd[0]:.4f} ms ({lbnd[1]})")
            del work
        # K6 at the environment adaptive leg's round (bit for bit)
        cfg_t = RenderConfig(sampler="sobol")
        opts_t = mk.kernel_options(cfg_t, scene)
        pk_t = mk.pack_scene(scene, config=cfg_t)
        timing, err, work = _time_dispatch(f"{size} K6 env round", pk_t, opts_t, device, seed,
                                           _adaptive_tiles(device, "round"))
        if err != 0.0:
            raise AssertionError(f"K6 at {size} is not bit for bit its plain version")
        n_lanes = len(ADAPTIVE_DISPATCH["round"][0]) * 2 * mk.TILE
        lbnd = _lookup_bound(pk_t, opts_t, work, n_lanes * 12, n_lanes * 8 + 4 * 2 * 81)
        res["K6"] = dict(err=err, ms=timing[0], plain_ms=timing[1], bound=timing[2],
                         lookup_bound=lbnd, lookups=int(work.get("env_lookup", 0)))
        print(f"  {size} K6 env round: with the map's bytes counted per lookup "
              f"({res['K6']['lookups']} lookups x 48 bytes) {lbnd[0]:.4f} ms ({lbnd[1]})")
        del work, pk, pk_t
        # the Renderer through pipeline='auto': the megakernel, exact and env NEE
        legs = {}
        for name, cfg, variant, key in (
                ("exact", RenderConfig(samples_per_launch=200), "env_exact", "K3"),
                ("env NEE", RenderConfig(samples_per_launch=200, nee=True), "env_nee", "K4")):
            r = Renderer(scene, cfg, seed=seed, device=device)
            if r.pipeline != "pallas":
                raise AssertionError(f"{size} {name}: 'auto' took {r.pipeline!r}, not 'pallas'")
            r.step(200)  # warm-up
            r.reset()
            mk.KERNEL.reset_counts()
            t0 = time.perf_counter()
            r.render(1000)
            wall = time.perf_counter() - t0
            by_variant = dict(mk.KERNEL.launches_by_variant)
            img = r.linear_image()
            r.reset()
            idle = _launch_idle_share(lambda: r.render(1000))
            rays = scene.camera.pixel_count * 1000 / wall
            legs[name] = dict(rays_per_s=rays, idle_share=idle, mean=float(img.mean()))
            res[key]["launches"] = by_variant.get(variant, 0)
            print(f"  {size} {name} leg ({r.pipeline}): render(1000) {rays:.6e} rays/s, "
                  f"{wall:.4f} s, device idle at least {idle:.4f} of one more render(1000) "
                  f"(its ctypes calls timed by CUDA events); mean {img.mean():.6f}; launches "
                  f"{by_variant}")
            if by_variant.get(variant, 0) <= 0:
                raise AssertionError(f"the {size} {name} leg never launched {variant}")
            if not (np.isfinite(img).all() and img.mean() > 0.0):
                raise AssertionError(f"the {size} {name} frame is not finite or lit")
            del r
        # env NEE's channel means between the exact estimator's at depth 8
        # and depth 9 ([13]'s gate under the meadow): the alias draw's cell
        # from words of its own past 2^15 texels keeps env NEE unbiased here
        t0 = time.perf_counter()
        means_nee, means_d8, means_d9, below, above = env_nee_bracket(
            scene, seed, device, ENV_NEE_GATE_SPP)
        legs["env NEE"].update(below_depth8=below, above_depth9=above)
        print(f"  {size} env NEE mean / exact mean at 1000 spp: "
              f"{legs['env NEE']['mean'] / legs['exact']['mean']:.6f}; at {ENV_NEE_GATE_SPP} spp "
              f"({time.perf_counter() - t0:.1f} s) channel means: env NEE depth 8 "
              f"{means_nee.tolist()}, exact depth 8 {means_d8.tolist()}, depth 9 "
              f"{means_d9.tolist()}; below depth 8 by {below:.4e}, above depth 9 by "
              f"{above:.4e} (slack {ENV_NEE_SLACK} each)")
        if below > ENV_NEE_SLACK or above > ENV_NEE_SLACK:
            raise AssertionError(f"{size}: env NEE's channel means leave the depth-8..9 bracket")
        # the AdaptiveRenderer in exact mode: the tile dispatch
        mk.KERNEL.reset_counts()
        ada = AdaptiveRenderer(scene, RenderConfig(samples_per_launch=256, sampler="sobol"),
                               device=device)
        t0 = time.perf_counter()
        ada.render(256)
        ada_wall = time.perf_counter() - t0
        ada_launches = dict(mk.KERNEL.launches_by_variant)
        ada_img = ada.linear_image()
        spp_map = ada.spp_map()
        res["K6"]["launches"] = ada_launches.get("tiles+env_exact", 0)
        print(f"  {size} adaptive leg: avg {ada.avg_spp:.2f} spp (min {spp_map.min()} max "
              f"{spp_map.max()}), mean {ada_img.mean():.6f}; launches {ada_launches}; wall "
              f"{ada_wall:.4f} s")
        if res["K6"]["launches"] <= 0:
            raise AssertionError(f"the {size} adaptive leg never launched tiles+env_exact")
        if not (np.isfinite(ada_img).all() and ada_img.mean() > 0.0) or spp_map.min() < 64:
            raise AssertionError(f"the {size} adaptive image is malformed")
        del ada, scene
        out[size] = dict(kernels=res, legs=legs)
    print(f"  phase [27] {time.perf_counter() - t_phase:.1f} s")
    return out


def _cli_phase(device, seed, scene_path, ref_img, smi):
    """Phase 24: the command line on the card (python -m of the port), the
    denoiser, checkpoints, profiling and the preview server."""
    import json as _json
    import shutil
    import urllib.request

    import numpy as np
    import torch

    from cosc_4397_pathtracing_raytracing_project_tpu_torch import (
        RenderConfig,
        Renderer,
        Scene,
        load_scene_desc,
    )
    from cosc_4397_pathtracing_raytracing_project_tpu_torch.io.png import read_png
    from cosc_4397_pathtracing_raytracing_project_tpu_torch.ops.cuda import megakernel as mk
    from cosc_4397_pathtracing_raytracing_project_tpu_torch.render import denoise
    from cosc_4397_pathtracing_raytracing_project_tpu_torch.render.profiling import (
        profile_pipeline,
    )
    from cosc_4397_pathtracing_raytracing_project_tpu_torch.viewer import PreviewServer

    t_phase = time.perf_counter()
    out = os.path.join(REPO, "build", "cli_phase")
    shutil.rmtree(out, ignore_errors=True)
    os.makedirs(out)
    at = lambda name: os.path.join(out, name)  # noqa: E731
    golden, cornell = scene_path("cornell_golden.txt"), scene_path("cornell.txt")
    print(f"[24] the command line on the card: python -m "
          f"cosc_4397_pathtracing_raytracing_project_tpu_torch ({smi})")
    golden_flags = ["--antialias", "--sampler", "sobol", "--nee", "--iterations", "16",
                    "--chunk", "16", "--hdr", "--quiet"]
    t0 = time.perf_counter()
    runs = {
        "golden denoised": _cli([golden, *golden_flags, "--denoise", "--output", at("A.png")]),
        "golden raw": _cli([golden, *golden_flags, "--output", at("R.png")]),
        "resume 100": _cli([cornell, "--sampler", "sobol", "--iterations", "100", "--chunk", "50",
                            "--checkpoint", at("C1"), "--output", at("C1.png"), "--quiet"]),
        "adaptive": _cli([cornell, "--adaptive", "--iterations", "64", "--denoise",
                          "--checkpoint", at("C3"), "--output", at("D.png"), "--quiet"]),
    }
    try:
        for what, proc in runs.items():
            _finish(proc, what)
    finally:  # a failed run leaves none of the others running
        for proc in runs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    _finish(_cli([cornell, "--sampler", "sobol", "--resume", at("C1.npz"), "--iterations", "200",
                  "--chunk", "50", "--checkpoint", at("C2"), "--output", at("C2.png"), "--quiet"]),
            "resume 200")
    cli_s = time.perf_counter() - t0
    print(f"  five command line runs (four at once, then the resumed one): {cli_s:.1f} s")

    # (a) the denoiser's gain on the golden at 16 spp with NEE
    def png_psnr(name):
        return _golden_psnr(read_png(at(name))[:, ::-1].astype(np.float32) / 255.0, ref_img)

    for name in ("A.png", "A.hdr", "R.png", "R.hdr"):
        if not os.path.exists(at(name)):
            raise AssertionError(f"the command line wrote no {name}")
    psnr_raw, psnr_den = png_psnr("R.png"), png_psnr("A.png")
    print(f"  (a) golden, 16 spp, NEE, sobol, antialias: raw {psnr_raw:.4f} dB, denoised "
          f"{psnr_den:.4f} dB (+{psnr_den - psnr_raw:.4f}; gate +{DENOISE_GAIN_DB})")
    if psnr_den < psnr_raw + DENOISE_GAIN_DB:
        raise AssertionError("the denoiser gains less than its gate")

    # (b) the command line against the library, the same seed and steps (the
    # metrics block's iteration-10 snapshot splits the first step)
    desc = load_scene_desc(golden)
    mk.KERNEL.reset_counts()
    lib = Renderer(desc, RenderConfig(trace_depth=desc.trace_depth, antialias=True,
                                      samples_per_launch=16, nee=True, sampler="sobol"),
                   seed=seed, device=device)
    lib.psnr_snapshot = True
    lib.render(16)
    lib_launches = dict(mk.KERNEL.launches_by_variant)
    lib.save_png(at("L.png"), denoise=True)
    lsb = int(np.abs(read_png(at("L.png")).astype(np.int32)
                     - read_png(at("A.png")).astype(np.int32)).max())
    print(f"  (b) command line vs library, denoised PNG: max |d| {lsb} LSB (gate 1); "
          f"library launches {lib_launches}")
    if lsb > 1 or sum(lib_launches.values()) <= 0:
        raise AssertionError("the command line's denoised PNG differs from the library's")

    # (c) resume: the resumed accumulator against an uninterrupted render
    mk.KERNEL.reset_counts()
    whole = Renderer(cornell, RenderConfig(samples_per_launch=50, sampler="sobol"), seed=seed,
                     device=device)
    whole.psnr_snapshot = True
    whole.render(200)
    whole_launches = dict(mk.KERNEL.launches_by_variant)
    with np.load(at("C2.npz")) as ck:
        fields = sorted(ck.files)
        same = np.array_equal(ck["accum"], whole.state.accum.cpu().numpy())
        ck_iter, ck_key = int(ck["iteration"]), ck["key"].tolist()
    print(f"  (c) resumed 100 -> 200 spp: fields {fields}, iteration {ck_iter}, key {ck_key}; "
          f"bit for bit the uninterrupted render(200): {same} (its launches {whole_launches})")
    if not same or fields != ["accum", "iteration", "key", "meta", "version"] or ck_iter != 200:
        raise AssertionError("the resumed render is not the uninterrupted one")

    # (d) the adaptive path (K6) wrote its checkpoint
    with np.load(at("C3.npz")) as ck:
        ada_fields = sorted(ck.files)
    print(f"  (d) --adaptive --iterations 64 --denoise: checkpoint fields {ada_fields}")
    if not {"acc_a", "acc_b", "counts", "seed", "budget_spent"} <= set(ada_fields):
        raise AssertionError("the adaptive checkpoint lacks its fields")

    # (e) the denoiser on the card against its CPU version
    cdesc = load_scene_desc(cornell)
    c_dev, c_cpu = Scene.from_desc(cdesc, device), Scene.from_desc(cdesc, "cpu")
    aov_dev, aov_cpu = denoise.render_aovs(c_dev), denoise.render_aovs(c_cpu)
    _aovs_agree("(e) AOVs, cornell.txt {}x{}".format(*c_cpu.camera.resolution), aov_dev,
                aov_cpu, c_cpu)
    img = torch.as_tensor(whole.linear_image())
    f_dev = denoise.atrous_denoise(img.to(device), denoise.Aovs(*[a.to(device) for a in aov_cpu]))
    filter_err = float((f_dev.cpu() - denoise.atrous_denoise(img, aov_cpu)).abs().max())
    mdesc = load_scene_desc(scene_path("mesh1080p.txt"))
    small = dataclasses.replace(mdesc, camera=dataclasses.replace(mdesc.camera,
                                                                   resolution=MESH_AOV_GATE_RES))
    m_dev, m_cpu = Scene.from_desc(small, device), Scene.from_desc(small, "cpu")
    t0 = time.perf_counter()
    m_aov_cpu = denoise.render_aovs(m_cpu)
    cpu_mesh_s = time.perf_counter() - t0
    _aovs_agree("(e) AOVs, mesh1080p.txt {}x{}".format(*MESH_AOV_GATE_RES),
                denoise.render_aovs(m_dev), m_aov_cpu, m_cpu)
    noisy = torch.as_tensor(np.random.default_rng(seed).uniform(
        0, 2, (MESH_AOV_GATE_RES[1], MESH_AOV_GATE_RES[0], 3)), dtype=torch.float32)
    m_f_dev = denoise.atrous_denoise(noisy.to(device),
                                     denoise.Aovs(*[a.to(device) for a in m_aov_cpu]))
    filter_err = max(filter_err, float((m_f_dev.cpu()
                                        - denoise.atrous_denoise(noisy, m_aov_cpu)).abs().max()))
    print(f"  (e) filter on the same inputs, card vs CPU (cornell, mesh): "
          f"max |d| {filter_err:.3e} (bound {AOV_TOL}); the CPU's mesh AOV pass {cpu_mesh_s:.1f} s")
    if filter_err > AOV_TOL:
        raise AssertionError("the filter on the card disagrees with the CPU")

    # (f) times on the card
    mesh_full = Scene.from_desc(mdesc, device)
    aov_ms = _median_ms(lambda: denoise.render_aovs(c_dev), reps=5)
    img_dev = img.to(device)
    filter_ms = _median_ms(lambda: denoise.atrous_denoise(img_dev, aov_dev), reps=5)
    # (e)'s pass on the small frame ran the same chunk shapes, so no warm-up
    # pass here
    mesh_times = []
    for _ in range(MESH_AOV_REPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        denoise.render_aovs(mesh_full)
        torch.cuda.synchronize()
        mesh_times.append((time.perf_counter() - t0) * 1e3)
    mesh_aov_ms = sorted(mesh_times)[len(mesh_times) // 2]
    chunk = min(1 << 16, max(256, (1 << 27) // mesh_full.num_triangles))
    prof = profile_pipeline(c_dev, RenderConfig(sampler="sobol"))
    print(f"  (f) on the card: render_aovs cornell {aov_ms:.3f} ms, "
          f"atrous_denoise {filter_ms:.3f} ms (median of 5); render_aovs mesh1080p "
          f"{'x'.join(map(str, mesh_full.camera.resolution))} {mesh_aov_ms:.1f} ms (median of "
          f"{MESH_AOV_REPS}; {-(-mesh_full.camera.pixel_count // chunk)} chunks of {chunk} "
          f"pixels x {mesh_full.num_triangles} triangles; host clock, each pass "
          f"{', '.join(f'{t:.1f}' for t in mesh_times)} ms)")
    print(f"  (f) profile_pipeline, cornell.txt: {_json.dumps(prof)}")

    # (g) the preview server on the card
    sdesc = load_scene_desc(cornell)
    sdesc.iterations = SERVER_SPP
    mk.KERNEL.reset_counts()
    r = Renderer(sdesc, RenderConfig(samples_per_launch=8), seed=seed, device=device)
    srv = PreviewServer(r, lookat=sdesc.camera.lookat, port=0).start(block=False)
    try:
        base = f"http://127.0.0.1:{srv.port}"

        def fetch(path):
            return urllib.request.urlopen(base + path, timeout=60).read()

        def post(msg):
            req = urllib.request.Request(base + "/control", data=_json.dumps(msg).encode(),
                                         method="POST")
            urllib.request.urlopen(req, timeout=60).read()

        def wait(cond, what):
            deadline = time.monotonic() + 120
            while not cond():
                if time.monotonic() > deadline:
                    raise AssertionError(f"preview server: timed out waiting for {what}")
                time.sleep(0.01)

        frames = [fetch("/frame.png") for _ in range(2)]
        wait(lambda: r.iteration >= SERVER_SPP, "the first pose's samples")
        resets = []
        set_camera = r.set_camera
        r.set_camera = lambda cam: (resets.append(r.iteration), set_camera(cam),
                                    resets.append(r.iteration))
        gen = srv._camera_gen
        post({"type": "orbit", "dx": 60, "dy": 0})
        wait(lambda: srv._camera_gen == gen + 1, "the camera rebuild")
        post({"type": "key", "key": "d"})
        denoised = fetch("/frame.png")
    finally:
        srv.stop()
    server_launches = dict(mk.KERNEL.launches_by_variant)
    ok = (all(f[:4] == b"\x89PNG" for f in frames + [denoised]) and resets == [SERVER_SPP, 0]
          and srv._aovs is not None and srv._aovs.albedo.device == r.device)
    print(f"  (g) preview server: 2 frames, orbit reset the iteration {resets}, denoised frame "
          f"{len(denoised)} bytes; launches {server_launches}")
    if not ok or server_launches.get("main", 0) <= 0:
        raise AssertionError("the preview server failed a check")
    print(f"  phase 24: {time.perf_counter() - t_phase:.1f} s ({smi})")


def _environment_phases(device, seed, chunk, pix, scene_path):
    """Phases 10-14: the environment variants (K3-K5) on env_spheres.txt.
    Returns their errors, timings, launch counts and gate readings."""
    import numpy as np
    import torch

    from cosc_4397_pathtracing_raytracing_project_tpu_torch import (
        AdaptiveRenderer,
        RenderConfig,
        Renderer,
        Scene,
        load_scene_desc,
        parse_scene,
    )
    from cosc_4397_pathtracing_raytracing_project_tpu_torch.io.png import write_hdr
    from cosc_4397_pathtracing_raytracing_project_tpu_torch.ops.cuda import megakernel as mk
    from cosc_4397_pathtracing_raytracing_project_tpu_torch.render.adaptive import (
        make_tile_layout,
    )

    env_path = scene_path("env_spheres.txt")
    print("[10] environment variants, kernel vs plain version, env_spheres.txt 800x800, "
          "depth 8, 2 spp")
    scene = Scene.from_desc(load_scene_desc(env_path), device)
    cases = {
        "exact": RenderConfig(),
        "exact sobol": RenderConfig(sampler="sobol"),
        "exact refraction": RenderConfig(enable_refraction=True),
        "env NEE": RenderConfig(nee=True),
        "split composite": RenderConfig(env_mode="split"),
        "split aa": RenderConfig(env_mode="split", antialias=True),
    }
    errs, times, prepared = {}, {}, {}
    for what, cfg in cases.items():
        opts = mk.kernel_options(cfg, scene)
        pk = mk.pack_scene(scene, nee=opts.nee, config=cfg)
        got = mk.KERNEL(pk, opts, seed, 1, 2, device)
        want = mk.render_samples_reference(pix, pk, opts, seed, 1, 2)
        torch.cuda.synchronize()
        errs[what] = _check_close(got, want, f"{what} [{mk.variant_name(opts)}]")
        prepared[what] = (pk, opts)
    # the tile dispatch with the exact environment: 16 of the 32x64 tiles
    gpx, gpy, _gidx, _ = make_tile_layout(*scene.camera.resolution)
    cfg_t = RenderConfig(sampler="sobol")
    opts_t = mk.kernel_options(cfg_t, scene)
    pk_t = mk.pack_scene(scene, config=cfg_t)
    ids = (torch.arange(16, dtype=torch.int32, device=device) * 20) % gpx.shape[0]
    bases = 1 + 7 * torch.arange(16, dtype=torch.int32, device=device)
    tpx = torch.as_tensor(gpx, device=device)[ids.long()].reshape(-1)
    tpy = torch.as_tensor(gpy, device=device)[ids.long()].reshape(-1)
    table = torch.cat([ids, bases])
    got = mk.KERNEL(pk_t, opts_t, seed, 0, 2, device, tiles=(table, tpx, tpy))
    want = mk.render_tiles_reference(tpx, tpy, ids, bases, pk_t, opts_t, seed, 2)
    errs["exact tiles"] = _check_close(got, want, "exact tiles, 16 tiles [tiles+env_exact]")
    # K6 at the environment adaptive leg's own dispatches (phase 14)
    k6_env = {}
    for which in ("warmup", "round"):
        k6_env[which], err, w = _time_dispatch(f"K6 env {which}", pk_t, opts_t, device, seed,
                                               _adaptive_tiles(device, which))
        errs["exact tiles"] = max(errs["exact tiles"], err)
        del w
    row_kernel = None
    for what, (pk, opts) in prepared.items():
        # env NEE's rows (with their per-geom table) are built once here by
        # the row kernel and passed in, so the time is the megakernel's own
        # (the Renderer builds them once per step); its bound adds the row
        # kernel's work and the rows' bytes
        n_rows = chunk * opts.trace_depth if opts.env_nee else 0
        rows = mk.env_nee_rows(pk, seed, 1, chunk, opts.trace_depth) if opts.env_nee else None
        k_ms = _time_ms(
            lambda: mk.KERNEL(pk, opts, seed, 1, chunk, device, env_rows=rows), reps=3)
        p_ms = _time_ms(
            lambda: mk.render_samples_reference(pix, pk, opts, seed, 1, chunk), reps=1)
        w = {}
        mk.render_samples_reference(pix, pk, opts, seed, 1, chunk, stats=w)
        row_bytes = n_rows * (8 + 6 * pk.num_geoms) * 4
        times[what] = (k_ms, p_ms, _bound(pk, opts, w, pix.numel() * 12,
                                          _map_bytes(pk, opts) + row_bytes, env_rows=n_rows))
        if what in ("env NEE", "split composite"):  # K4, K5
            alone = _bound(pk, opts, w, pix.numel() * 12, _map_bytes(pk, opts) + n_rows * 32,
                           shared=False, env_rows=n_rows)
            w = {}
            mk.render_samples_reference(pix, pk, opts, seed, 1, SCHEDULE_SPP, stats=w)
            _visibility(what, pk, opts, device, seed, SCHEDULE_SPP, w, alone, times[what][2])
        del w
        print(f"  {what}: one {chunk}-sample launch: kernel {k_ms:.3f} ms, plain version "
              f"{p_ms:.1f} ms; bound {times[what][2][0]:.4f} ms ({times[what][2][1]})")
        if opts.env_nee:
            row_kernel = _row_kernel_check(pk, opts, seed, chunk)

    print("[11] environment legs: env_spheres.txt, samples_per_launch=200, 1000 spp")
    legs = {
        "exact": (RenderConfig(samples_per_launch=200), "env_exact"),
        "env NEE": (RenderConfig(samples_per_launch=200, nee=True), "env_nee"),
        "split": (RenderConfig(samples_per_launch=200, env_mode="split"), "env_split"),
    }
    launches, images, legs_out = {}, {}, {}
    for name, (cfg, variant) in legs.items():
        r = Renderer(env_path, cfg, device=device)
        r.step(200)  # warm-up: the split tables and composite are derived here
        r.reset()
        mk.KERNEL.reset_counts()
        t0 = time.perf_counter()
        r.render(1000)
        wall = time.perf_counter() - t0
        by_variant = dict(mk.KERNEL.launches_by_variant)
        row_launches = mk.KERNEL.row_launches
        launches[name] = sum(by_variant.values())
        images[name] = r.linear_image()
        # the device's idle share of one more render(1000), under the profiler
        r.reset()
        idle = _idle_share(lambda: r.render(1000))
        rays = r.scene.camera.pixel_count * 1000 / wall
        legs_out[name] = (rays, idle)
        print(f"  {name}: {rays:.6e} rays/s, {wall:.4f} s, device idle {idle:.4f} of a "
              f"profiled render(1000); mean {images[name].mean():.6f}; launches {by_variant}, "
              f"row kernel {row_launches}")
        if by_variant.get(variant, 0) <= 0:
            raise AssertionError(f"the {name} leg never launched {variant}")
        if variant == "env_nee" and row_launches <= 0:
            raise AssertionError("the env NEE leg never launched the row kernel")
        if not (np.isfinite(images[name]).all() and images[name].mean() > 0.0):
            raise AssertionError(f"the {name} leg's image is not finite or lit")

    print("[12] furnace: constant map 0.7, diffuse sphere albedo 0.6, 1000 spp")
    furnace_dir = os.path.join(REPO, "build", "furnace")
    os.makedirs(furnace_dir, exist_ok=True)
    write_hdr(os.path.join(furnace_dir, "const.hdr"), np.full((8, 16, 3), 0.7, np.float32))
    furnace = parse_scene(FURNACE_SCENE, base_dir=furnace_dir)
    c = float(furnace.env_image[0, 0, 0])
    for name, nee in (("exact", False), ("env NEE", True)):
        mk.KERNEL.reset_counts()
        r = Renderer(furnace, RenderConfig(samples_per_launch=200, nee=nee), seed=1,
                     device=device)
        r.render(1000)
        img = r.linear_image()
        h = img.shape[0]
        corner = img[:3, :3]
        body = float(img[h // 2 - 2: h // 2 + 2, h // 2 - 2: h // 2 + 2].mean())
        bg_err = float(np.abs(corner / c - 1.0).max())
        body_err = abs(body / (0.6 * c) - 1.0)
        print(f"  {name}: background rel err {bg_err:.3e} (bound {FURNACE_BG_RTOL}), body "
              f"{body:.6f} vs {0.6 * c:.6f}, rel err {body_err:.4e} (bound {FURNACE_BODY_RTOL}); "
              f"launches {dict(mk.KERNEL.launches_by_variant)}")
        if bg_err > FURNACE_BG_RTOL or body_err > FURNACE_BODY_RTOL:
            raise AssertionError(f"furnace ({name}) fails")

    print("[13] environment gates")
    split_pk = mk.pack_scene(scene, config=RenderConfig(env_mode="split"))
    miss = split_pk.env.bg_miss.cpu().numpy() > 0.5
    exact_bg = images["exact"].reshape(-1, 3)[miss]
    comp_bg = split_pk.env.bg.cpu().numpy()[miss]
    bg_rel = float(np.max(np.abs(exact_bg - comp_bg) - ENV_BG_ATOL
                          - ENV_BG_RTOL * np.abs(comp_bg)))
    print(f"  exact background vs split composite over {int(miss.sum())} primary-miss pixels: "
          f"max |d| {np.abs(exact_bg - comp_bg).max():.3e}, max rel "
          f"{np.max(np.abs(exact_bg - comp_bg) / np.abs(comp_bg)):.3e} (rtol {ENV_BG_RTOL}, "
          f"atol {ENV_BG_ATOL})")
    if bg_rel > 0.0:
        raise AssertionError("the exact background leaves the split composite's bound")
    # split vs env NEE: gated at tests/test_envmap.py's configuration (64x64,
    # depth 4); at 800x800 the split's documented approximation shows: its
    # specular bounces see the SH sky, not the suns, so the mirror sphere's
    # sun glint, which 800x800 pixel centres resolve, is missing (printed,
    # with the means of the images clipped at 1 as the saved PNG clips them)
    m_split = float(images["split"].mean())
    m_nee = float(images["env NEE"].mean())
    c_split = float(np.clip(images["split"], 0.0, 1.0).mean())
    c_nee = float(np.clip(images["env NEE"], 0.0, 1.0).mean())
    print(f"  800x800 depth 8: split mean {m_split:.6f} vs env NEE {m_nee:.6f} "
          f"({m_split / m_nee - 1.0:+.4e}); clipped at 1: {c_split:.6f} vs {c_nee:.6f} "
          f"({c_split / c_nee - 1.0:+.4e})")
    small = load_scene_desc(env_path)
    small.camera.resolution = (64, 64)
    small_means = {}
    for name, extra in (("split", dict(env_mode="split")), ("env NEE", dict(nee=True))):
        r = Renderer(small, RenderConfig(samples_per_launch=200, trace_depth=4, **extra),
                     device=device)
        r.render(1000)
        small_means[name] = float(r.linear_image().mean())
    split_gap = abs(small_means["split"] / small_means["env NEE"] - 1.0)
    print(f"  64x64 depth 4, 1000 spp: split mean {small_means['split']:.6f} vs env NEE "
          f"{small_means['env NEE']:.6f}: {split_gap:.4e} (bound {SPLIT_MEAN_RTOL})")
    if split_gap > SPLIT_MEAN_RTOL:
        raise AssertionError("the split mean leaves 2% of the env-NEE mean")
    deeper = Renderer(env_path, RenderConfig(samples_per_launch=200, trace_depth=9),
                      device=device)
    deeper.render(1000)
    means_nee = images["env NEE"].reshape(-1, 3).mean(0)
    means_d8 = images["exact"].reshape(-1, 3).mean(0)
    means_d9 = deeper.linear_image().reshape(-1, 3).mean(0)
    below = float((1.0 - means_nee / means_d8).max())
    above = float((means_nee / means_d9 - 1.0).max())
    print(f"  channel means: env NEE depth 8 {means_nee.tolist()}, exact depth 8 "
          f"{means_d8.tolist()}, depth 9 {means_d9.tolist()}; below depth 8 by {below:.4e}, "
          f"above depth 9 by {above:.4e} (slack {ENV_NEE_SLACK} each)")
    if below > ENV_NEE_SLACK or above > ENV_NEE_SLACK:
        raise AssertionError("env NEE's channel means leave the depth-8..9 bracket")

    print("[14] environment adaptive leg: env_spheres.txt, exact, sobol, render(256)")
    mk.KERNEL.reset_counts()
    ada = AdaptiveRenderer(env_path, RenderConfig(samples_per_launch=256, sampler="sobol"),
                           device=device)
    t0 = time.perf_counter()
    ada.render(256)
    ada_wall = time.perf_counter() - t0
    ada_launches = dict(mk.KERNEL.launches_by_variant)
    ada_img = ada.linear_image()
    spp_map = ada.spp_map()
    print(f"  avg {ada.avg_spp:.2f} spp (min {spp_map.min()} max {spp_map.max()}), mean "
          f"{ada_img.mean():.6f}; launches {ada_launches}; wall {ada_wall:.4f} s")
    if ada_launches.get("tiles+env_exact", 0) <= 0:
        raise AssertionError("the environment adaptive leg never launched tiles+env_exact")
    if not (np.isfinite(ada_img).all() and ada_img.mean() > 0.0) or spp_map.min() < 64:
        raise AssertionError("the environment adaptive image is malformed")
    return {"errs": errs, "times": times, "launches": launches,
            "adaptive_launches": sum(ada_launches.values()), "k6": k6_env,
            "rows": row_kernel, "legs": legs_out}


def _idle_share(fn):
    """The device's idle share of the wall of one run of ``fn`` under
    torch.profiler (1 - the device time of its kernels over the wall)."""
    return _profile_kernels(fn)[0]


def _row_kernel_check(pk, opts, seed, chunk):
    """Env NEE's row kernel against its plain version on the card, at a
    200-sample step's rows and a launch's: bit for bit (the largest |Δ| of
    each column and the largest relative difference printed; both round
    each operation alone, call the same CUDA math library and, past 2^15
    texels, take the alias cell from the same 64-bit integer product), the
    per-geom table the plain table of the kernel's own directions; the row
    kernel's time (20 launches) beside the torch row build's. Returns the
    step's readings."""
    import torch

    from cosc_4397_pathtracing_raytracing_project_tpu_torch.ops.cuda import megakernel as mk

    depth = opts.trace_depth
    out = None
    for samples in (200, chunk):
        got = mk.env_nee_rows(pk, seed, 1, samples, depth)
        want = mk.env_nee_rows_reference(pk, seed, 1, samples, depth)
        diff = (got[:, :8] - want[:, :8]).abs()
        col = [float(x) for x in diff.amax(dim=0)]
        rel = float((diff[:, :6] / want[:, :6].abs().clamp_min(0.1)).max())
        table_equal = torch.equal(
            got[:, 8:], mk.env_row_table(pk, got[:, :3]).reshape(got.shape[0], -1))
        texels_equal = torch.equal(got[:, 6:8], want[:, 6:8])
        k_ms = _time_ms(lambda: mk.env_nee_rows(pk, seed, 1, samples, depth), reps=20)
        t_ms = _time_ms(lambda: mk.build_env_nee_rows(pk.env.envmap, seed, 1, samples, depth),
                        reps=20)
        print(f"  env NEE rows under the {pk.env.height}x{pk.env.width} map, row kernel vs plain "
              f"version, {samples * depth} rows "
              f"[{8 + 6 * pk.num_geoms} floats each]: texels equal {texels_equal}, max |d| per "
              f"column (dir xyz, radiance rgb, pdf, pad) {[f'{x:.3e}' for x in col]}, largest "
              f"relative {rel:.3e}, bit-identical {torch.equal(got, want)} (gate), table = "
              f"plain table {table_equal}; row kernel {k_ms:.4f} ms, torch row build "
              f"{t_ms:.4f} ms")
        if not (torch.equal(got, want) and table_equal and bool(torch.isfinite(got).all())):
            raise AssertionError("the row kernel is not bit for bit its plain version")
        if out is None:
            out = dict(rows=samples * depth, ms=k_ms, torch_ms=t_ms, max_abs=col, rel=rel,
                       bit_identical=torch.equal(got, want))
    return out


# tests/test_envmap.py's furnace: a diffuse sphere under a constant map
FURNACE_SCENE = """MATERIAL 0
RGB         0.6 0.6 0.6
SPECEX      0
SPECRGB     0 0 0
REFL        0
REFR        0
REFRIOR     0
EMITTANCE   0

ENVIRONMENT
FILE const.hdr
STRENGTH 1

CAMERA
RES         32 32
FOVY        30
ITERATIONS  64
DEPTH       8
FILE        furnace
EYE         0 0 6
LOOKAT      0 0 0
UP          0 1 0

OBJECT 0
sphere
material 0
TRANS       0 0 0
ROTAT       0 0 0
SCALE       3 3 3
"""


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
    from cosc_4397_pathtracing_raytracing_project_tpu_torch.native import (
        runtime as native_runtime,
    )
    from cosc_4397_pathtracing_raytracing_project_tpu_torch.ops.cuda import build
    from cosc_4397_pathtracing_raytracing_project_tpu_torch.ops.cuda import megakernel as mk
    from cosc_4397_pathtracing_raytracing_project_tpu_torch.ops.cuda import mesh_kernel as mesh
    from cosc_4397_pathtracing_raytracing_project_tpu_torch.render.adaptive import (
        make_tile_layout,
    )

    device = torch.device("cuda", 0)
    t_start = time.perf_counter()
    scene_path = lambda name: os.path.join(REPO, "scenes", name)  # noqa: E731
    chunk = 50
    seed = 0

    # 1. build: one nvcc per source, started together
    print(f"[1] build ({torch.cuda.get_device_name(0)}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda})")
    t0 = time.perf_counter()

    def timed_build(kernel):
        build.build(kernel.name, kernel.flags)
        return time.perf_counter() - t0

    def timed_host_build():
        t_host = time.perf_counter()
        path = native_runtime.ensure_built()
        return path, time.perf_counter() - t_host

    libs = {"megakernel": mk.KERNEL, "megakernel (counting)": mk.COUNTING,
            "mesh_kernel": mesh.KERNEL, "mesh_kernel (counting)": mesh.COUNTING}
    with ThreadPoolExecutor(max_workers=len(libs) + 1) as pool:
        host = pool.submit(timed_host_build)
        done = {what: pool.submit(timed_build, kernel) for what, kernel in libs.items()}
        for what, fut in done.items():
            print(f"  {what} built after {fut.result():.1f} s")
        host_build = host.result()
        print(f"  host runtime {host_build[0].name} built in {host_build[1]:.1f} s")
    print(f"  built in {time.perf_counter() - t0:.1f} s")
    for kernel, regs, spill in _mesh_ptxas_report(build.log_path(mesh.KERNEL.name).read_text()):
        print(f"  ptxas: mesh {kernel}: {regs} registers; {spill}")
    report = _ptxas_report(build.log_path(mk.KERNEL.name).read_text())
    for variant, regs, spill in report:
        print(f"  ptxas: {variant}: {regs} registers; {spill}")
    # 44 option sets, and the 16 tile ones again with sample-group items
    if len(report) != 60:
        raise AssertionError(f"expected 60 kernel variants in ptxas' report, got {len(report)}")
    main_row = [r for r in report if r[0] == "main"]
    print(f"  main variant: {main_row}")
    # the blocks an SM holds of main and of every NEE variant (with the light
    # rays' queue in shared memory; the launch bounds ask for 7)
    base = mk.kernel_options(RenderConfig(sampler="sobol"))
    occupancy = {"main": mk.KERNEL.blocks_per_sm(base)}
    for refr, dof, tiles, env in ((r, d, t, e) for r in (False, True) for d in (False, True)
                                  for t in (False, True) for e in ("none", "split")
                                  if not (t and e == "split")):
        o = dataclasses.replace(base, nee=True, refraction=refr, dof=dof, env=env)
        occupancy[mk.variant_name(o, tiles)] = mk.KERNEL.blocks_per_sm(o, tiles)
    print(f"  resident blocks an SM: {occupancy}")

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
    # the bounce loop's warp schedule: the counting build against the
    # emulation's replay of the warps it recorded, on the plain version's
    # path lengths of the same launch
    work = {}
    mk.render_samples_reference(pix, packed, opts, seed, 1, SCHEDULE_SPP, stats=work)
    counted, owners = mk.kernel_warp_work(packed, opts, seed, 1, SCHEDULE_SPP, device)
    steps, draws = mk.path_lengths(work)
    emulated = mk.warp_schedule(steps, draws, mk.SCHEDULE, **mk.schedule_args(opts),
                                owners=owners, vis=mk.path_visibility(work))
    today = mk.warp_schedule(steps, draws, "thread")
    print(f"  bounce loop of a {SCHEDULE_SPP}-sample launch, counting build: {counted}, SIMT efficiency "
          f"{counted['lane_iters'] / (32 * counted['warp_iters']):.4f}; emulation "
          f"{ {k: emulated[k] for k in mk.WORK} }, {emulated['efficiency']:.4f} (a thread per "
          f"pixel: {today['efficiency']:.4f}, {today['warp_iters']} warp iterations)")
    if counted != {k: emulated[k] for k in mk.WORK}:
        raise AssertionError("the counting build's warp counts differ from the emulation's")

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
        alone = _bound(pk, opts, w, pix.numel() * 12, 0, shared=False)
        # K2's and K1b's light rays: the counting build against the emulation
        w = {}
        mk.render_samples_reference(pix, pk, opts, seed, 1, SCHEDULE_SPP, stats=w)
        _visibility(f"{key} ({'K2' if key == 'a' else 'K1b'})", pk, opts, device, seed,
                    SCHEDULE_SPP, w, alone, times[key][2])
        del w
    k_ms = _time_ms(lambda: tiles_kernel(chunk), reps=3)
    p_ms = _time_ms(lambda: tiles_plain(chunk), reps=1)
    w = {}
    tiles_plain(chunk, w)
    times["g"] = (k_ms, p_ms, _bound(pk_g, opts_g, w, tpx.numel() * 12, tpx.numel() * 8 + 128))
    del w
    for key, (k_ms, p_ms, bnd) in times.items():
        print(f"  {key}: one {chunk}-sample launch: kernel {k_ms:.3f} ms, plain version "
              f"{p_ms:.1f} ms; bound {bnd[0]:.4f} ms ({bnd[1]})")
    # K6 at the adaptive leg's own dispatches (phase 9): the warm-up, once a
    # leg, and a round, 23 times a leg; the round's counts against the
    # emulation; a pixel-sample of the round beside one of the full-frame
    # NEE launch with the leg's options (no antialiasing, sobol)
    k6 = {}
    for which in ("warmup", "round"):
        k6[which], err, w = _time_dispatch(f"K6 {which}", pk_g, opts_g, device, seed,
                                           _adaptive_tiles(device, which))
        errs["g"] = max(errs["g"], err)
        if which == "round":
            ids_r, bases_r, rpx, rpy, n_r = _adaptive_tiles(device, which)
            _visibility("K6 round", pk_g, opts_g, device, seed, n_r, w,
                        k6[which][2], k6[which][2], tiles=(torch.cat([ids_r, bases_r]), rpx, rpy))
        del w
    nee_ms = _time_ms(lambda: mk.KERNEL(pk_g, opts_g, seed, 1, chunk, device), reps=3)
    round_ps = k6["round"][0] / (rpx.numel() * n_r)
    nee_ps = nee_ms / (pix.numel() * chunk)
    print(f"  K6 round {round_ps * 1e6:.4f} ns a pixel-sample against the full-frame nee "
          f"variant's {nee_ps * 1e6:.4f} ns ({nee_ms:.4f} ms a {chunk}-sample launch): "
          f"x{round_ps / nee_ps:.4f} (a tile-specific loss above x{K6_TILE_LOSS})")

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

    env = _environment_phases(device, seed, chunk, pix, scene_path)
    print(f"[15] peak device memory {torch.cuda.max_memory_allocated(device)} bytes; "
          f"{time.perf_counter() - t_start:.1f} s so far")

    meshes = _mesh_phases(device, seed, scene_path)

    # 19. kernels, then the result
    print(f"[19] peak device memory {torch.cuda.max_memory_allocated(device)} bytes; "
          f"total {time.perf_counter() - t_start:.1f} s")
    src = "cosc_4397_pathtracing_raytracing_project_tpu/ops/pallas/megakernel.py"

    def entry(name, replaces, launches, err, timing, source=mk.SOURCE):
        k_ms, p_ms, (b_ms, b_by) = timing
        return {
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches, "max_abs_err": err, "ms": k_ms, "plain_ms": p_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
        }

    def mk_entry(name, line, launches, err, timing):
        return entry(name, f"{src}:{line}", launches, err, timing)

    def mesh_entry(name, kernel, launches, **extra):
        # ms, plain_ms and bound_ms: the sum over one mesh pipeline sample's
        # launches
        ps = meshes["per_sample"][kernel]
        return dict(entry(name, src.replace("megakernel.py", "mesh_kernel.py:541"), launches,
                          ps["err"], (ps["ms"], ps["plain_ms"], ps["bound"]), source=mesh.SOURCE),
                    launches_per_sample=ps["launches"], **extra)

    k1b_launches = sum(leg_launches["glass+dof"].values()) + sum(
        leg_launches["reference parity"].values())
    # K6's loss over the adaptive legs' launches (a warm-up, then rounds),
    # each at its own dispatch's time and bound
    k6_loss = 0.0
    for leg, launches, times_k6 in (("golden NEE", sum(ada_launches.values()), k6),
                                    ("env exact", env["adaptive_launches"], env["k6"])):
        loss = sum((n * (times_k6[which][0] - times_k6[which][2][0]))
                   for which, n in (("warmup", 1), ("round", launches - 1)))
        k6_loss += loss
        print(f"  K6, {leg} adaptive leg: {launches} launches (1 warm-up "
              f"{times_k6['warmup'][0]:.4f} ms, bound {times_k6['warmup'][2][0]:.4f}; "
              f"{launches - 1} rounds {times_k6['round'][0]:.4f} ms, bound "
              f"{times_k6['round'][2][0]:.4f}): launches x (time - bound) {loss:.3f} ms")
    print(f"  K6 over both adaptive legs: launches x (time - bound) {k6_loss:.3f} ms")
    rk = env["rows"]
    print("row kernel (part of K4's row): " + json.dumps(dict(
        name="pt_env_rows", source=mk.SOURCE, rows_a_step=rk["rows"], ms_a_step=rk["ms"],
        torch_row_build_ms_a_step=rk["torch_ms"], max_abs_err_by_column=rk["max_abs"],
        bit_identical=rk["bit_identical"],
        env_legs={k: dict(rays_per_s=v[0], idle_share=v[1]) for k, v in env["legs"].items()})))

    k7_reference = _pipeline_phases(device, seed, scene_path, ref_img, smi)
    _cli_phase(device, seed, scene_path, ref_img, smi)
    _multi_device_phase(device, seed, scene_path, ref_img, smi)
    big = _host_runtime_phase(device, seed, scene_path, host_build, smi)
    big_maps = _big_map_phase(device, seed, chunk, scene_path, big, smi)
    print(f"  peak device memory {torch.cuda.max_memory_allocated(device)} bytes; "
          f"total {time.perf_counter() - t_start:.1f} s")

    def big_map_entries():
        # K3, K4 and K6 at phase 27's maps: launches from its legs, K6's
        # times and bound the round's; lookup_bound_ms counts the map's bytes
        # per lookup where bound_ms counts them once
        names = {"K3": ("K3 megakernel[env exact]", 1055), "K4": ("K4 megakernel[env nee]", 1673),
                 "K6": ("K6 megakernel[tiles]", 2173)}
        for size, got in big_maps.items():
            for key, (name, line) in names.items():
                k = got["kernels"][key]
                rows = {}
                if "rows" in k:  # K4: its row kernel under this map
                    rows = dict(row_kernel_ms_a_step=k["rows"]["ms"],
                                row_kernel_bit_identical=k["rows"]["bit_identical"])
                yield dict(mk_entry(f"{name} @{size}", line, k["launches"], k["err"],
                                    (k["ms"], k["plain_ms"], k["bound"])),
                           lookup_bound_ms=k["lookup_bound"][0], map=size, **rows)
    print(json.dumps({"kernels": [
        mk_entry("K1 megakernel", 2393, main_launches, max_abs_err, (ms, plain_ms, k1_bound)),
        mk_entry("K1b megakernel[refraction,dof,early_exit,throughput]", 1510, k1b_launches,
                 max(errs[k] for k in "cdef"), times["c"]),
        mk_entry("K2 megakernel[nee]", 1554, sum(nee_launches.values()),
                 max(errs[k] for k in "ab"), times["a"]),
        mk_entry("K3 megakernel[env exact]", 1055, env["launches"]["exact"],
                 max(env["errs"][k] for k in ("exact", "exact sobol", "exact refraction")),
                 env["times"]["exact"]),
        mk_entry("K4 megakernel[env nee]", 1673, env["launches"]["env NEE"], env["errs"]["env NEE"],
                 env["times"]["env NEE"]),
        mk_entry("K5 megakernel[env split]", 1312, env["launches"]["split"],
                 max(env["errs"][k] for k in ("split composite", "split aa")),
                 env["times"]["split composite"]),
        mk_entry("K6 megakernel[tiles]", 2173, sum(ada_launches.values()) + env["adaptive_launches"],
                 max(errs["g"], env["errs"]["exact tiles"]), k6["round"]),
        # phase 23's uncompacted full-frame launches keep counts of their own
        mesh_entry("K7 mesh_intersect[full]", "K7", meshes["k7_launches"],
                   reference_pipeline=k7_reference),
        mesh_entry("K8 mesh_intersect[tmin]", "K8", meshes["k8_launches"]),
        *big_map_entries(),
    ]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--golden-eager"]:
        sys.exit(_golden_eager(sys.argv[2], *map(int, sys.argv[3:6]), sys.argv[6]))
    sys.exit(main())
