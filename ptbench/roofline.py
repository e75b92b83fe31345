"""The frozen count of the megakernel's work and the card's peaks.

The least time the work allows is the larger of its float operations over
the card's float32 peak and its bytes (each input read once, each output
written once) over its memory rate. Operations are counted per unit of
work from the estimator's arithmetic (add, sub, mul, div, sqrt, min/max,
sin/cos as one each; compares, selects and integer hashing not counted):

- a ray's object-space origin and direction at a geom (axis-aligned or a
  general transform), a cube's slab test or a sphere's quadratic with the
  normal, the winner's normalize (a nearest-hit trace: ``isect``);
- a scatter (frame, direction, hit point, throughput: ``scatter``);
- an escape's bilinear lookup (``env_lookup``), its pdf lookup
  (``env_pdf``), an env NEE shadow ray (``env_shadow``): its shading
  arithmetic and, per geom, its origin transform and the rest of the test,
  its direction's terms coming from its row's table;
- env NEE's row kernel, per row: the alias draw, the bilinear radiance and
  per geom the row table's entries.

The counts per sample of each configuration are frozen in its file
(``work_per_sample``), measured once by the plain reference over the whole
frame at its first camera, so the same work reads the same whatever
implements it.
"""

from __future__ import annotations

# NVIDIA H100 SXM data sheet, 700 W: float32 outside the tensor cores, HBM3
PEAK_F32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12

FLOPS_ORIGIN = {True: 6, False: 18}
FLOPS_DIR = {True: 3, False: 15}
FLOPS_CUBE = {True: 29, False: 46}
FLOPS_SPHERE = {True: 40, False: 52}
FLOPS_SHADOW_CUBE = 26
FLOPS_SHADOW_SPHERE = 28
FLOPS_TABLE = {True: 3, False: 6}  # a row table entry's reciprocals, cube / sphere
FLOPS_NORMALIZE = 11
FLOPS_SCATTER = 70
FLOPS_ENV_LOOKUP = 96
FLOPS_ENV_PDF = 2
FLOPS_ENV_NEE = 27
# a row: the alias draw (29; 2 fewer where the cell comes from words of its
# own, past 2^15 texels) and the bilinear radiance (14 + 10 a channel)
FLOPS_ENV_ROW = 29 + 14 + 3 * 10
ENV_CELL_SPLIT = 1 << 15


def flops_isect(geoms) -> float:
    """A nearest-hit trace over every primitive."""
    return FLOPS_NORMALIZE + sum(FLOPS_ORIGIN[a] + FLOPS_DIR[a]
                                 + (FLOPS_CUBE[a] if cube else FLOPS_SPHERE[a])
                                 for a, cube in geoms)


def flops_per_sample(geoms, work: dict) -> float:
    """Float operations of one sample past its primary hit (which a launch
    traces once a pixel). ``geoms``: (axis_aligned, is_cube) per primitive;
    ``work``: the counts per sample of each kind of event."""
    isect = flops_isect(geoms)
    env_occlusion = sum(FLOPS_ORIGIN[a] + (FLOPS_SHADOW_CUBE - 3 if cube
                                           else FLOPS_SHADOW_SPHERE - 6)
                        for a, cube in geoms)
    return (work.get("isect", 0.0) * isect
            + work.get("scatter", 0.0) * FLOPS_SCATTER
            + work.get("env_shadow", 0.0) * (FLOPS_ENV_NEE + env_occlusion)
            + work.get("env_lookup", 0.0) * FLOPS_ENV_LOOKUP
            + work.get("env_pdf", 0.0) * FLOPS_ENV_PDF)


def flops_per_row(geoms, texels: int) -> float:
    row = FLOPS_ENV_ROW - (2 if texels > ENV_CELL_SPLIT else 0)
    return row + sum(FLOPS_DIR[a] + FLOPS_TABLE[cube] for a, cube in geoms)


def launch_bound_s(geoms, work: dict, pixels: int, samples: int, depth: int,
                   texels: int = 0, env_nee: bool = False) -> float:
    """The least seconds of one launch of ``samples`` samples over
    ``pixels`` pixels, with its env NEE rows' kernel under a map."""
    flops = pixels * (samples * flops_per_sample(geoms, work) + flops_isect(geoms))
    out_bytes = pixels * 12  # the launch's [N, 3] f32 sums
    in_bytes = 0
    if texels:
        in_bytes += texels * (16 if env_nee else 12)  # the texels, with the pdf under env NEE
    if env_nee:  # the rows pass from one kernel to the other: no bytes of their own
        flops += samples * depth * flops_per_row(geoms, texels)
    return max(flops / PEAK_F32_FLOPS, (out_bytes + in_bytes) / PEAK_BYTES_PER_S)


def share(bound_s: float, kernel_s: float) -> float:
    """The kernel's share of its roofline, in %."""
    return 100.0 * bound_s / kernel_s


def window_share(ctx):
    """The megakernel's share of its roofline over a traced window: the
    window's steps (``measured["steps"]``: samples of a step → steps) at the
    frozen count against the device seconds of the megakernel source's
    kernels."""
    from .reference.scene import load

    config = ctx.cell.config
    scene = load("\n".join(config["scene"]))
    geoms = [(int(scene.perm[3 * k]) >= 0, k < scene.num_cubes) for k in range(scene.num_geoms)]
    texels = 0
    if "envmap" in config:
        texels = 2 * config["envmap"]["height"] ** 2
    env_nee = bool(texels and config["render"].get("nee"))
    bound = sum(count * launch_bound_s(geoms, config["work_per_sample"],
                                       scene.width * scene.height, spp, scene.trace_depth,
                                       texels, env_nee)
                for spp, count in ctx.measured["steps"].items())
    kernel_s = ctx.trace.kernel_seconds()
    if kernel_s is None:
        raise RuntimeError("the trace holds no kernel of csrc/megakernel.cu")
    return share(bound, kernel_s)
