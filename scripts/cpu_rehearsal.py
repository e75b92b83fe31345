#!/usr/bin/env python3
"""Rehearse csrc/megakernel.cu on the CPU, without a card or nvcc.

    python3 scripts/cpu_rehearsal.py [--parent DIR] [CASE ...]

Builds the port's megakernel source with g++ against scripts/cpu_shim/
(a stand-in for the CUDA runtime: blocks run in turn, a std::thread per
thread, a std::barrier per warp for the warp intrinsics), as the
production build and as its work-counting build (-DPT_MEGA_COUNT), into
build/cpu_shim/, and runs small cases (40x30 pixels, a few samples) of the
compile-time variants through ctypes. For each case it prints:

- the counting build's counters against megakernel.warp_schedule's
  emulation on the plain version's paths and visibility rays (these must
  be equal: the kernel's schedule and the emulation are the same);
- the kernel's output against the plain version's (share of pixels off by
  more than 1e-3, largest |d|; the CPU's sinf/cosf differ from torch's in
  the last bits, so this is a sanity check, not bit identity);
- with ``--parent DIR`` (a checkout of an earlier commit, e.g. unpacked
  with git archive into build/), the same case on that checkout's source:
  whether the two outputs are bit-identical, else their share above 1e-3
  and largest |d|;
- for env NEE, the row kernel (``pt_env_rows``) against the plain
  ``env_nee_rows_reference``: whether the integer draws (the pdf column)
  agree, the largest |d| of the directions and radiance (the CPU's
  trigonometry again), and whether the per-geom table equals
  ``env_row_table`` of the kernel's own directions bit for bit.

The tile dispatch cases run with queue items of one sample, of two and of
all of a pixel's samples; the ``-slice`` cases render a slice of the frame
(``SLICE``: its pixel offset, count and first hash tile) against the plain
version of the same slice. Exits non-zero if a counting build disagrees with
the emulation. A logic error found here costs no chip time; timing means
nothing here.
"""

import argparse
import ctypes
import hashlib
import os
import subprocess
import sys

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from cosc_4397_pathtracing_raytracing_project_tpu_torch import (  # noqa: E402
    RenderConfig,
    Scene,
    parse_scene,
)
from cosc_4397_pathtracing_raytracing_project_tpu_torch.ops.cuda import megakernel as mk  # noqa: E402
from cosc_4397_pathtracing_raytracing_project_tpu_torch.ops.rng import kernel_seed  # noqa: E402

SHIM = os.path.join(REPO, "scripts", "cpu_shim")
OUT = os.path.join(REPO, "build", "cpu_shim")
SCENES = os.path.join(REPO, "scenes")
RES = (40, 30)
# the slice cases' pixels (the multi-device tiling's launch): 601 pixels from
# global pixel 517, their hash tiles numbered from 5
SLICE = dict(pixel_offset=517, num_pixels=601, tile_base=5)
# the launches' rewrites: `<<<...>>>` becomes the shim's launch, and the
# dynamic shared memory a per-launch buffer
SED = (
    r"s/kernel<<<blocks, PT_BLOCK, smem, stream>>>(/shim_launch(kernel, blocks, PT_BLOCK, smem, "
    r"stream, /",
    r"s/pt_fold_samples<<<\(.*\), 256, 0, stream>>>(/shim_launch(pt_fold_samples, \1, 256, 0, "
    r"stream, /",
    r"s/extern __shared__ float s_sun\[\];/float* s_sun = shim_dyn.data();/",
    r"s/pt_env_rows<<<\(.*\), PT_BLOCK, 0, (cudaStream_t)stream>>>(/shim_launch(pt_env_rows, \1, "
    r"PT_BLOCK, 0, (cudaStream_t)stream, /",
)


def build(source, counting):
    """g++ build of ``source`` through the shim; the library's name hashes
    the source, the shim and the flags, so an edit to either rebuilds."""
    flags = ["-DPT_MEGA_COUNT"] if counting else []
    text = open(source).read()
    shim = open(os.path.join(SHIM, "cuda_runtime.h")).read()
    key = hashlib.sha256((text + shim + " ".join(flags)).encode()).hexdigest()[:16]
    lib = os.path.join(OUT, f"megakernel_{key}.so")
    if not os.path.exists(lib):
        os.makedirs(OUT, exist_ok=True)
        cpp = lib[:-3] + ".cpp"
        sed = ["sed"] + [a for e in SED for a in ("-e", e)] + [source]
        with open(cpp, "w") as f:
            subprocess.run(sed, stdout=f, check=True)
        subprocess.run(["g++", "-std=c++20", "-O1", "-ffp-contract=off", "-fPIC", "-shared",
                        "-pthread", f"-I{SHIM}", *flags, "-x", "c++", cpp, "-o", lib],
                       check=True)
    dll = ctypes.CDLL(lib)
    fn = dll.pt_megakernel_launch
    fn.restype = ctypes.c_int
    i, p, f = ctypes.c_int, ctypes.c_void_p, ctypes.c_float
    # a source with queue items for the tile dispatch takes (group, units)
    # after the tile count; one with env NEE's row kernel reads the rows
    # with their per-geom table
    groups = "int num_tiles, int group," in text
    # one that renders pixel slices takes their offset and tile base after
    # the iteration base
    sliced = "int pixel_offset," in text
    fn.argtypes = ([p] + [i] * (14 if sliced else 12) + [f] + [i] * 4 + [p] * 5 + [i] * 3
                   + [p, p, i, p, p, p, i] + ([i, p] if groups else [])
                   + [i, p, p, i, i, p, i, p, i, p, p, p, p])
    rows = None
    if "pt_env_rows_launch" in text:
        rows = dll.pt_env_rows_launch
        rows.restype = ctypes.c_int
        rows.argtypes = [p, i, i, i, i, p, p, p, p, p, i, i, p, p, i, i, p]
    return fn, groups, rows, sliced


def launch(lib, packed, opts, seed, iter_base, num_samples, tiles=None, group=None,
           work_len=None, pixel_offset=0, num_pixels=None, tile_base=0):
    """One launch of a shim build, as Megakernel.__call__ makes it on a
    card: the [N, 3] output, and for a counting build its counters and the
    warp of each chunk of 32 queue items. Without tiles it renders
    ``num_pixels`` pixels from ``pixel_offset`` (the whole frame by
    default), their hash tiles numbered from ``tile_base``."""
    fn, groups, row_kernel, sliced = lib
    if not sliced and (pixel_offset or num_pixels is not None or tile_base):
        raise ValueError("this source renders the whole frame only")
    lights_f = lights_i = None
    num_lights = 0
    if opts.nee:
        lights_f, lights_i = packed.lights.packed()
        num_lights = packed.lights.count
    n = packed.width * packed.height if num_pixels is None else num_pixels
    table = px = py = None
    num_tiles = 0
    items = n
    if tiles is not None:
        table, px, py = tiles
        num_tiles = table.shape[0] // 2
        n = num_tiles * opts.tile
        group = group or num_samples
        items = n * (num_samples // group)
    env = packed.env
    env_mode = mk._ENV_MODES[(opts.env, opts.env_nee)]
    tex = rows = suns = sh = None
    if env_mode in (1, 2):
        tex = env.tex.contiguous()
        if env_mode == 2:
            if row_kernel is not None:  # the rows with their per-geom table
                rows = mk.env_nee_rows_reference(packed, seed, iter_base, num_samples,
                                                 opts.trace_depth).contiguous()
            else:
                rows = mk.build_env_nee_rows(env.envmap, seed, iter_base, num_samples,
                                             opts.trace_depth).contiguous()
    elif env_mode == 3:
        suns = np.ascontiguousarray(env.suns.reshape(-1), np.float32)
        sh = np.ascontiguousarray(env.sh.reshape(-1), np.float32)
    out = torch.zeros((n, 3), dtype=torch.float32)
    units = None
    if tiles is not None and group < num_samples:
        units = torch.zeros((num_samples * n, 6 if env_mode == 1 else 3), dtype=torch.float32)
    queue = torch.zeros(1, dtype=torch.int32)
    work = torch.zeros(work_len, dtype=torch.int64) if work_len else None
    owners = torch.full(((items + 31) // 32,), -1, dtype=torch.int32) if work_len else None
    ptr = lambda a: None if a is None else a.ctypes.data  # noqa: E731
    dptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    tile_args = [dptr(table), dptr(px), dptr(py), num_tiles]
    if groups:
        tile_args += [int(group or num_samples), dptr(units)]
    slice_args = [pixel_offset, tile_base] if sliced else []
    err = fn(out.data_ptr(), n, packed.width, packed.height, kernel_seed(seed), int(iter_base),
             *slice_args, opts.tile, int(num_samples), opts.trace_depth, opts.rr_start_depth,
             int(opts.antialias), int(opts.use_ld), opts.n_ld, opts.sky_strength, int(opts.nee),
             int(opts.refraction), int(opts.dof), int(opts.legacy), packed.cam.ctypes.data,
             packed.geo.ctypes.data, packed.mats.ctypes.data, packed.gmat.ctypes.data,
             packed.perm.ctypes.data, packed.num_cubes, packed.num_geoms, packed.num_materials,
             ptr(lights_f), ptr(lights_i), num_lights, *tile_args, env_mode,
             dptr(tex), dptr(rows), env.height if env_mode else 0, env.width if env_mode else 0,
             ptr(suns), env.num_suns if env_mode == 3 else 0, ptr(sh), int(opts.bg_external),
             queue.data_ptr(), dptr(work), dptr(owners), None)
    if err != 0:
        raise RuntimeError(f"shim launch failed: error {err}")
    if work_len:
        return out, dict(zip(mk.WORK, work.tolist())), owners.numpy()
    return out


def check_rows(lib, packed, opts, seed, iter_base, num_samples):
    """The shim's row kernel against the plain version: a line of text."""
    rows_fn = lib[2]
    env = packed.env
    em = env.envmap
    want = mk.env_nee_rows_reference(packed, seed, iter_base, num_samples, opts.trace_depth)
    got = torch.full_like(want, float("nan"))
    tabs = [t.contiguous() for t in (em.img, em.alias_prob, em.alias_idx, em.pdf, em.strength)]
    err = rows_fn(got.data_ptr(), num_samples, opts.trace_depth, iter_base, kernel_seed(seed),
                  *(t.data_ptr() for t in tabs), env.height, env.width, packed.geo.ctypes.data,
                  packed.perm.ctypes.data, packed.num_cubes, packed.num_geoms, None)
    if err != 0:
        raise RuntimeError(f"shim row kernel failed: error {err}")
    table = mk.env_row_table(packed, got[:, :3]).reshape(got.shape[0], -1)
    same_table = torch.equal(got[:, 8:], table)
    return (f"rows: pdf column equal {torch.equal(got[:, 6], want[:, 6])}, "
            f"max |d| dir {float((got[:, :3] - want[:, :3]).abs().max()):.2e} "
            f"radiance {float((got[:, 3:6] - want[:, 3:6]).abs().max()):.2e}, "
            f"table = env_row_table of its directions {same_table}"), same_table


def agreement(got, want):
    diff = (got - want).abs().amax(-1)
    return f"share >1e-3 {float((diff > 1e-3).float().mean()):.2e}, max |d| {float(diff.max()):.3e}"


def scene(name, aperture=False, repeat=1):
    """``name`` at RES; with ``repeat`` its map's texels each repeated
    ``repeat`` x ``repeat`` (chip_smoke.py's large maps)."""
    text = open(os.path.join(SCENES, name)).read()
    text = text.replace("RES         800 800", f"RES         {RES[0]} {RES[1]}")
    if aperture:
        text = text.replace("LOOKAT", "APERTURE    0.3\nLOOKAT", 1)
    desc = parse_scene(text, base_dir=SCENES)
    if repeat > 1:
        desc.env_image = np.repeat(np.repeat(desc.env_image, repeat, 0), repeat, 1)
    return Scene.from_desc(desc, "cpu")


# (scene file, lens, config, samples[, map texel repeat]); "tiles" cases run
# the tile dispatch; the "-512x1024" / "-2048x4096" cases take the meadow
# map's texels repeated 4 x 4 / 16 x 16, past the alias draw's 2^15 split
CASES = {
    "main": ("cornell.txt", False, dict(sampler="sobol"), 3),
    "aa": ("cornell.txt", False, dict(antialias=True), 3),
    "nee-aa-sobol": ("cornell_golden.txt", False, dict(nee=True, antialias=True, sampler="sobol"),
                     6),
    "nee-hoisted": ("cornell_golden.txt", False, dict(nee=True, sampler="sobol"), 6),
    "nee-depth1": ("cornell_golden.txt", False, dict(nee=True, trace_depth=1), 3),
    "glass-dof-nee": ("cornell_glass.txt", True, dict(enable_refraction=True, dof=True, nee=True,
                                                      sampler="sobol"), 4),
    "throughput": ("cornell.txt", False, dict(gather_mode="throughput"), 3),
    "env-exact": ("env_spheres.txt", False, dict(), 3),
    "env-nee": ("env_spheres.txt", False, dict(nee=True), 3),
    "env-nee-512x1024": ("env_spheres.txt", False, dict(nee=True), 3, 4),
    "env-nee-2048x4096": ("env_spheres.txt", False, dict(nee=True), 2, 16),
    "split": ("env_spheres.txt", False, dict(env_mode="split"), 3),
    "main-slice": ("cornell.txt", False, dict(sampler="sobol"), 3),
    "nee-slice": ("cornell_golden.txt", False, dict(nee=True, antialias=True, sampler="sobol"),
                  4),
    "env-exact-slice": ("env_spheres.txt", False, dict(sampler="sobol"), 3),
    "env-nee-slice": ("env_spheres.txt", False, dict(nee=True), 3),
    "split-slice": ("env_spheres.txt", False, dict(env_mode="split"), 3),
    "tiles-nee": ("cornell_golden.txt", False, dict(nee=True, sampler="sobol"), 4),
    "tiles": ("cornell_golden.txt", False, dict(sampler="sobol"), 4),
    "tiles-env-exact": ("env_spheres.txt", False, dict(sampler="sobol"), 4),
}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", default=None, help="an earlier checkout to compare with")
    ap.add_argument("cases", nargs="*", help=f"cases to run (default all: {', '.join(CASES)})")
    args = ap.parse_args()
    torch.set_num_threads(4)
    source = os.path.join(REPO, mk.SOURCE)
    libs = {"change": build(source, False), "counting": build(source, True)}
    if args.parent:
        libs["parent"] = build(os.path.join(args.parent, mk.SOURCE), False)
    ok = True
    for name in args.cases or list(CASES):
        file, lens, cfg, samples, *repeat = CASES[name]
        sc = scene(file, lens, *repeat)
        config = RenderConfig(**cfg)
        opts = mk.kernel_options(config, sc)
        packed = mk.pack_scene(sc, nee=opts.nee, config=config)
        tiled = name.startswith("tiles")
        runs = [None]
        kw = dict(tiles=None)
        if tiled:
            ids = torch.tensor([1, 0, 1], dtype=torch.int32)
            bases = torch.tensor([1, 5, 9], dtype=torch.int32)
            flat = torch.as_tensor(np.random.default_rng(3).integers(0, RES[0] * RES[1],
                                                                     3 * mk.TILE))
            px = (flat % RES[0]).to(torch.float32)
            py = (flat // RES[0]).to(torch.float32)
            kw = dict(tiles=(torch.cat([ids, bases]), px, py))
            runs = [1, 2, samples]
        elif name.endswith("-slice"):
            # a slice that starts and ends inside a warp's chunk of 32, on
            # hash tiles numbered from 5
            kw = dict(tiles=None, **SLICE)
        stats = {}
        if tiled:
            want = mk.render_tiles_reference(px, py, ids, bases, packed, opts, 7, samples,
                                             stats=stats)
        else:
            first = kw.get("pixel_offset", 0)
            pix = first + torch.arange(kw.get("num_pixels") or RES[0] * RES[1])
            want = mk.render_samples_reference(pix, packed, opts, 7, 3, samples, stats=stats,
                                               tile_base=kw.get("tile_base", 0))
        base = 0 if tiled else 3
        steps, draws = mk.path_lengths(stats)
        parent = (launch(libs["parent"], packed, opts, 7, base, samples, tiles=kw["tiles"])
                  if args.parent and "pixel_offset" not in kw else None)
        for group in runs:
            got = launch(libs["change"], packed, opts, 7, base, samples, group=group, **kw)
            _, counted, owners = launch(libs["counting"], packed, opts, 7, base, samples,
                                        group=group, work_len=len(mk.WORK), **kw)
            em = mk.warp_schedule(steps, draws, mk.SCHEDULE, **mk.schedule_args(opts, tiled),
                                  owners=owners, vis=mk.path_visibility(stats),
                                  group=group if tiled else None, width=RES[0],
                                  pixel_offset=kw.get("pixel_offset", 0))
            equal = counted == {k: em[k] for k in mk.WORK}
            ok = ok and equal
            line = (f"{name} [{mk.variant_name(opts, tiled)}]"
                    + (f" items of {group} samples" if tiled else "")
                    + f": counting build = emulation {equal}; vs plain {agreement(got, want)}")
            if parent is not None:
                same = torch.equal(got, parent)
                line += "; vs parent " + ("bit-identical" if same else agreement(got, parent))
            print(line, flush=True)
            if not equal:
                print(f"  counted  {counted}\n  emulated {({k: em[k] for k in mk.WORK})}")
        if opts.env_nee and libs["change"][2] is not None:
            line, same = check_rows(libs["change"], packed, opts, 7, base, samples)
            ok = ok and same
            print(f"{name} {line}", flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
