"""The path-tracing megakernel: a batch of samples per launch, and its plain
PyTorch version.

Port of the JAX package's ``ops/pallas/megakernel.py`` (the kernel built by
``_make_kernel`` and launched by ``_render_samples_impl``), restricted to the
main path's options: light_only gathering, Russian roulette past
``rr_start_depth``, the Owen-scrambled Sobol sampler on the leading
``ld_depths`` bounces (or the counter-hash streams alone), a hoisted primary
hit without antialiasing and sub-pixel jitter with it.

- :func:`render_samples` is the entry point. On a scene whose tensors lie on
  a CUDA device it launches ``csrc/megakernel.cu`` (one thread per pixel);
  on the CPU it runs :func:`render_samples_reference`. There is no fallback
  from one to the other.
- :func:`render_samples_reference` is the plain version: the same math, in
  the same operation order, and the same random streams, as torch operations
  over a ``[samples, pixels]`` batch.

Random numbers are those of the JAX kernel in interpret mode (its only
replayable form): the LD lattice keyed by the global pixel id, and the
counter hash ``_HashPrng`` keyed by ``lane = p % TILE`` and reseeded with
``_mix(seed, iteration, depth, p // TILE)``. So the port is comparable pixel
by pixel with ``render_samples(..., interpret=True)``.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from .build import NVCC_FLAGS, load
from ..rng import (
    MASK32,
    bit_reverse32,
    kernel_seed,
    laine_karras,
    ld_bounce_tags,
    ld_shift,
    mul32,
    to_u01,
    u32,
)

# Pixels per RNG tile (the TPU kernel's TILE = 16 rows × 128 lanes): the hash
# stream of pixel p is keyed by lane p % TILE and tile p // TILE. Read at call
# time; the tests set the JAX tests' 4096 here.
TILE = 2048

_PI = 3.14159265358979323846
# the f32 constants of the TPU kernel's azimuth and cone angles:
# 2.0 * float32(pi) and float32(pi / 2)
_TWO_PI_F32 = float(np.float32(2.0 * np.float32(_PI)))
_HALF_PI_F32 = float(np.float32(_PI * 0.5))
_FMAX = 3.402823466e38
_MISS = 1e30
_BACKOFF = 1e-4
_ORIGIN_OFFSET = 1e-3

_GF = 21  # floats per geom: inverse transform rows (12) + inverse-transpose (9)
_MF = 10  # floats per material: color(3) spec_color(3) refl refr emit ior
# table capacity of csrc/megakernel.cu's by-value scene parameter
MAX_GEOMS = 16
MAX_MATERIALS = 16

# Samples × pixels per batch of the plain version (bounds its memory).
_REFERENCE_BATCH = 1 << 21

SOURCE = "cosc_4397_pathtracing_raytracing_project_tpu_torch/csrc/megakernel.cu"


# ───────────────────────────── scene tables ─────────────────────────────


@dataclasses.dataclass(frozen=True)
class PackedScene:
    """Host copies of the tables the kernel reads (the TPU kernel's SMEM
    operands): camera [16], geometry [K·21], geom material ids [K],
    materials [M·10], and the per-geom axis-aligned column map [K·3]
    (-1 rows = general transform)."""

    cam: np.ndarray
    geo: np.ndarray
    gmat: np.ndarray
    mats: np.ndarray
    perm: np.ndarray
    num_cubes: int
    num_spheres: int
    width: int
    height: int

    @property
    def num_geoms(self) -> int:
        return self.num_cubes + self.num_spheres

    @property
    def num_materials(self) -> int:
        return self.mats.shape[0] // _MF


def _host(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def static_geom_kinds(scene) -> tuple:
    """Per-geom ('cube'|'sphere', perm) tags, perm being the column of the
    single nonzero in each row of the 3×3 inverse transform for axis-aligned
    geoms (translation + scale + 90°-multiple rotations) and None otherwise.
    Same classification as the JAX ``_static_geom_kinds``."""
    kinds = []
    for batch, base in ((scene.cubes, "cube"), (scene.spheres, "sphere")):
        inv = _host(batch.inv_transform)
        for k in range(batch.count):
            m = inv[k, :3, :3]
            scale = max(float(np.abs(m).max()), 1e-20)
            perm = []
            ok = True
            for r in range(3):
                nz = np.nonzero(np.abs(m[r]) > 1e-7 * scale)[0]
                if len(nz) != 1:
                    ok = False
                    break
                perm.append(int(nz[0]))
            ok = ok and sorted(perm) == [0, 1, 2]
            kinds.append((base, tuple(perm) if ok else None))
    return tuple(kinds)


def pack_scene(scene) -> PackedScene:
    """Read the scene's tables to the host once (the layout of the JAX
    ``_pack_scene`` plus the camera vector of ``_render_samples_impl``)."""

    def pack_batch(b):
        if b.count == 0:
            return np.zeros((0, _GF), np.float32)
        inv = _host(b.inv_transform)[:, :3, :4].reshape(b.count, 12)
        invt = _host(b.inv_transpose)[:, :3, :3].reshape(b.count, 9)
        return np.concatenate([inv, invt], axis=1)

    geo = np.concatenate([pack_batch(scene.cubes), pack_batch(scene.spheres)])
    gmat = np.concatenate(
        [_host(scene.cubes.material_id), _host(scene.spheres.material_id)]
    ).astype(np.int32)
    m = scene.materials
    mats = np.concatenate(
        [
            _host(m.color),
            _host(m.specular_color),
            _host(m.reflectivity)[:, None],
            _host(m.refractive)[:, None],
            _host(m.emittance)[:, None],
            _host(m.ior)[:, None],
        ],
        axis=1,
    ).astype(np.float32)
    num_materials = mats.shape[0]
    if num_materials == 0 or np.any((gmat < 0) | (gmat >= num_materials)):
        raise ValueError(
            f"geometry material ids {gmat.tolist()} must name one of the "
            f"{num_materials} materials"
        )
    cam = scene.camera
    cam_vec = np.concatenate(
        [
            _host(cam.position), _host(cam.view), _host(cam.right),
            _host(cam.up), _host(cam.pixel_length),
            _host(cam.aperture).reshape(1), _host(cam.focal).reshape(1),
        ]
    ).astype(np.float32)
    perm = np.full((geo.shape[0], 3), -1, np.int32)
    for k, (_kind, p) in enumerate(static_geom_kinds(scene)):
        if p is not None:
            perm[k] = p
    w, h = cam.resolution
    return PackedScene(
        cam=np.ascontiguousarray(cam_vec),
        geo=np.ascontiguousarray(geo.reshape(-1), np.float32),
        gmat=np.ascontiguousarray(gmat),
        mats=np.ascontiguousarray(mats.reshape(-1)),
        perm=np.ascontiguousarray(perm.reshape(-1)),
        num_cubes=scene.cubes.count,
        num_spheres=scene.spheres.count,
        width=int(w),
        height=int(h),
    )


# ─────────────────────────────── options ───────────────────────────────


@dataclasses.dataclass(frozen=True)
class KernelOptions:
    trace_depth: int
    rr_start_depth: int
    antialias: bool
    sky_strength: float
    use_ld: bool  # sampler='sobol': AA jitter from the LD lattice
    n_ld: int  # leading bounce depths drawing from the LD lattice
    tile: int  # pixels per hash-stream tile (the module's TILE)


def kernel_options(config) -> KernelOptions:
    """The kernel's options from a ``RenderConfig`` and the module's
    ``TILE``. Raises ``NotImplementedError`` for estimator options this port
    does not carry yet, naming the ROADMAP item that brings them."""
    if config.gather_mode == "throughput":
        raise NotImplementedError(
            "gather_mode='throughput' is not ported yet (ROADMAP Queue 1 item 7, "
            "kernel K1b)"
        )
    if config.gather_mode != "light_only":
        raise ValueError(f"unknown gather_mode {config.gather_mode!r}")
    for field, item in (
        ("nee", "item 8, analytic NEE (kernel K2)"),
        ("enable_refraction", "item 7, kernel K1b"),
        ("dof", "item 7, kernel K1b"),
        ("early_exit", "item 7, kernel K1b"),
    ):
        if getattr(config, field):
            raise NotImplementedError(
                f"{field}=True is not ported yet (ROADMAP Queue 1 {item})"
            )
    if config.sampler not in ("independent", "sobol"):
        raise ValueError(f"unknown sampler {config.sampler!r}")
    if TILE <= 0:
        raise ValueError(f"TILE must be positive, got {TILE}")
    use_ld = config.sampler == "sobol"
    ld = max(1, int(config.ld_depths)) if use_ld else 0
    return KernelOptions(
        trace_depth=int(config.trace_depth),
        rr_start_depth=int(config.rr_start_depth),
        antialias=bool(config.antialias),
        sky_strength=float(config.sky_strength),
        use_ld=use_ld,
        n_ld=min(ld, int(config.trace_depth)),
        tile=int(TILE),
    )


# ───────────────────────────── random streams ─────────────────────────────


def mix(*xs) -> torch.Tensor:
    """The JAX kernel's ``_mix``: a uint32 hash of int words (tensors or
    ints, broadcast), as an int64 tensor."""
    out = torch.zeros((), dtype=torch.int64)
    for i, x in enumerate(xs):
        xi = u32(x)
        out = out ^ mul32(xi, 0x9E3779B9 + 2 * i + 1)
        out = mul32(out, 0x85EBCA6B)
        out = out ^ (out >> 13)
    return out


class HashPrng:
    """The JAX kernel's ``_HashPrng`` counter hash: uniforms are a function
    of (seed, draw counter, lane). ``lane`` is a uint32 int64 tensor."""

    def __init__(self, lane: torch.Tensor):
        self.lane = u32(lane)
        self.seed_mul = torch.zeros((), dtype=torch.int64, device=lane.device)
        self.counter = 0

    def reseed(self, seed: torch.Tensor) -> None:
        self.seed_mul = mul32(u32(seed), 0x9E3779B9)
        self.counter = 0

    def u01(self) -> torch.Tensor:
        self.counter += 1
        x = self.lane ^ self.seed_mul
        x = (x + ((self.counter * 0x85EBCA6B) & MASK32)) & MASK32
        x = mul32(x ^ (x >> 16), 0x7FEB352D)
        x = mul32(x ^ (x >> 15), 0x846CA68B)
        x = x ^ (x >> 16)
        return to_u01(x >> 8)


def _sobol_rev_pair(idx: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Bit-reversed (0,2) components of sample indices (low 21 bits): the
    kernel's ``_sobol_scalar_pair``."""
    x0 = idx & ((1 << 21) - 1)
    x1 = torch.zeros_like(idx)
    m = 1
    for k in range(21):
        x1 = x1 ^ (((idx >> k) & 1) * ((m << (31 - k)) & MASK32))
        m = (m << 1) ^ m
    return x0, bit_reverse32(x1)


def _ld_rev_components(it, depth: int, seed: int, pid):
    """The kernel's ``_ld_rev_components``: raw index at depth 0, the
    per-(pixel, depth) Owen-shuffled index past it."""
    if depth == 0:
        return _sobol_rev_pair(it)
    j = bit_reverse32(it) >> 11
    jp = laine_karras(j, ld_shift(seed, pid, 256 + depth)) & ((1 << 21) - 1)
    return _sobol_rev_pair(bit_reverse32(jp) >> 11)


def _ld_u01(rev_bits, lattice) -> torch.Tensor:
    """The kernel's ``_ld_u01`` (reversed-domain Owen scramble)."""
    return to_u01(bit_reverse32(laine_karras(rev_bits, lattice)) >> 8)


# ─────────────────────────── plain version ───────────────────────────


def _rsqrt(x):
    return 1.0 / torch.sqrt(x)


def _raygen(cam, width, height, fx, fy):
    """Pinhole raygen (generateRayFromCamera, `pathtrace.cu:270-286`)."""
    sx = cam[12] * (fx - 0.5 * width)
    sy = cam[13] * (fy - 0.5 * height)
    dx = cam[3] - cam[6] * sx - cam[9] * sy
    dy = cam[4] - cam[7] * sx - cam[10] * sy
    dz = cam[5] - cam[8] * sx - cam[11] * sy
    rn = _rsqrt(dx * dx + dy * dy + dz * dz)
    return dx * rn, dy * rn, dz * rn


def _intersect_all(packed: PackedScene, ox, oy, oz, dx, dy, dz):
    """Nearest hit over every primitive: (t, world normal xyz, material)."""
    geo = packed.geo.tolist()
    gmat = packed.gmat.tolist()
    perms = packed.perm.reshape(-1, 3).tolist()
    shape = torch.broadcast_shapes(ox.shape, dx.shape)
    dev = dx.device
    best_t = torch.full(shape, _MISS, dtype=torch.float32, device=dev)
    best_nx = torch.zeros(shape, dtype=torch.float32, device=dev)
    best_ny = torch.zeros_like(best_nx)
    best_nz = torch.zeros_like(best_nx)
    best_mat = torch.zeros(shape, dtype=torch.int64, device=dev)
    for k in range(packed.num_geoms):
        iv = geo[k * _GF : k * _GF + 12]
        it = geo[k * _GF + 12 : (k + 1) * _GF]
        perm = None if perms[k][0] < 0 else tuple(perms[k])
        if perm is None:
            qox = iv[0] * ox + iv[1] * oy + iv[2] * oz + iv[3]
            qoy = iv[4] * ox + iv[5] * oy + iv[6] * oz + iv[7]
            qoz = iv[8] * ox + iv[9] * oy + iv[10] * oz + iv[11]
            qdx = iv[0] * dx + iv[1] * dy + iv[2] * dz
            qdy = iv[4] * dx + iv[5] * dy + iv[6] * dz
            qdz = iv[8] * dx + iv[9] * dy + iv[10] * dz
        else:
            pw = (ox, oy, oz)
            dw = (dx, dy, dz)
            c0, c1, c2 = perm
            qox = iv[c0] * pw[c0] + iv[3]
            qoy = iv[4 + c1] * pw[c1] + iv[7]
            qoz = iv[8 + c2] * pw[c2] + iv[11]
            qdx = iv[c0] * dw[c0]
            qdy = iv[4 + c1] * dw[c1]
            qdz = iv[8 + c2] * dw[c2]

        if k < packed.num_cubes:
            ix = 1.0 / qdx
            iy = 1.0 / qdy
            iz = 1.0 / qdz
            t1x = (-0.5 - qox) * ix
            t2x = (0.5 - qox) * ix
            t1y = (-0.5 - qoy) * iy
            t2y = (0.5 - qoy) * iy
            t1z = (-0.5 - qoz) * iz
            t2z = (0.5 - qoz) * iz
            tax = torch.minimum(t1x, t2x)
            tbx = torch.maximum(t1x, t2x)
            tay = torch.minimum(t1y, t2y)
            tby = torch.maximum(t1y, t2y)
            taz = torch.minimum(t1z, t2z)
            tbz = torch.maximum(t1z, t2z)
            sgx = torch.where(t2x < t1x, 1.0, -1.0)
            sgy = torch.where(t2y < t1y, 1.0, -1.0)
            sgz = torch.where(t2z < t1z, 1.0, -1.0)
            ax = torch.where(tax > 0, tax, -_FMAX)
            ay = torch.where(tay > 0, tay, -_FMAX)
            az = torch.where(taz > 0, taz, -_FMAX)
            bx = torch.where(tbx < _FMAX, tbx, _FMAX)
            by = torch.where(tby < _FMAX, tby, _FMAX)
            bz = torch.where(tbz < _FMAX, tbz, _FMAX)
            s_min = torch.maximum(ax, torch.maximum(ay, az))
            s_max = torch.minimum(bx, torch.minimum(by, bz))
            min_is_x = (ax >= ay) & (ax >= az)
            min_is_y = ~min_is_x & (ay >= az)
            max_is_x = (bx <= by) & (bx <= bz)
            max_is_y = ~max_is_x & (by <= bz)
            outside = s_min > 0
            hit = (s_max >= s_min) & (s_max > 0)
            sparam = torch.where(outside, s_min, s_max)
            use_x = (outside & min_is_x) | (~outside & max_is_x)
            use_y = (outside & min_is_y) | (~outside & max_is_y)
            t_world = sparam - _BACKOFF
            if perm is not None:
                inv_p = [perm.index(r) for r in range(3)]
                sgs = (sgx, sgy, sgz)
                sels = (use_x, use_y, ~(use_x | use_y))
                nox, noy, noz = (
                    torch.where(sels[inv_p[r]], sgs[inv_p[r]] * it[r * 3 + inv_p[r]], 0.0)
                    for r in range(3)
                )
            else:
                sfx = torch.where(use_x, 1.0, 0.0)
                sfy = torch.where(use_y, 1.0, 0.0)
                gx = sgx * sfx
                gy = sgy * sfy
                gz = sgz * (1.0 - sfx - sfy)
                nox = gx * it[0] + gy * it[1] + gz * it[2]
                noy = gx * it[3] + gy * it[4] + gz * it[5]
                noz = gx * it[6] + gy * it[7] + gz * it[8]
        else:
            nq2 = qdx * qdx + qdy * qdy + qdz * qdz
            b = qox * qdx + qoy * qdy + qoz * qdz
            c = qox * qox + qoy * qoy + qoz * qoz - 0.25
            disc = b * b - nq2 * c
            sq = torch.sqrt(torch.clamp_min(disc, 0.0))
            inv_a = 1.0 / nq2
            s1 = (-b + sq) * inv_a
            s2 = (-b - sq) * inv_a
            both_neg = (s1 < 0) & (s2 < 0)
            both_pos = (s1 > 0) & (s2 > 0)
            sparam = torch.where(
                both_pos, torch.minimum(s1, s2), torch.maximum(s1, s2)
            )
            hit = (disc >= 0) & ~both_neg
            t_world = sparam - _BACKOFF
            flip = torch.where(both_pos, 1.0, -1.0)
            sv = (
                (qox + t_world * qdx) * flip,
                (qoy + t_world * qdy) * flip,
                (qoz + t_world * qdz) * flip,
            )
            if perm is not None:
                inv_p = [perm.index(r) for r in range(3)]
                nox, noy, noz = (
                    it[r * 3 + inv_p[r]] * sv[inv_p[r]] for r in range(3)
                )
            else:
                nox = it[0] * sv[0] + it[1] * sv[1] + it[2] * sv[2]
                noy = it[3] * sv[0] + it[4] * sv[1] + it[5] * sv[2]
                noz = it[6] * sv[0] + it[7] * sv[1] + it[8] * sv[2]

        better = hit & (t_world > 0) & (t_world < best_t)
        best_t = torch.where(better, t_world, best_t)
        best_nx = torch.where(better, nox, best_nx)
        best_ny = torch.where(better, noy, best_ny)
        best_nz = torch.where(better, noz, best_nz)
        best_mat = torch.where(better, gmat[k], best_mat)

    rw = _rsqrt(
        torch.clamp_min(best_nx * best_nx + best_ny * best_ny + best_nz * best_nz, 1e-30)
    )
    return best_t, best_nx * rw, best_ny * rw, best_nz * rw, best_mat


def _trace_batch(packed, opts, seed, its, p, fx, fy, lane, tile_id, primary):
    """Radiance [3, S, N] of one batch of samples (its: [S, 1] int64)."""
    cam = packed.cam.tolist()
    mat_cols = torch.as_tensor(
        packed.mats.reshape(-1, _MF).T.copy(), device=p.device
    )  # [10, M]
    shape = (its.shape[0], p.shape[0])
    seed_u = seed & MASK32
    prng = HashPrng(lane)

    if opts.antialias:
        if opts.use_ld:
            s0, s1 = _sobol_rev_pair(its)
            jx = _ld_u01(s0, ld_shift(seed_u, p, 0))
            jy = _ld_u01(s1, ld_shift(seed_u, p, 1))
        else:
            prng.reseed(mix(seed_u, its, 0xAA, tile_id))
            jx = prng.u01()
            jy = prng.u01()
        dx, dy, dz = _raygen(cam, packed.width, packed.height, fx + jx, fy + jy)
    else:
        dx, dy, dz = (v.expand(shape) for v in primary[0])
    f32 = dict(dtype=torch.float32, device=p.device)
    ox = torch.full(shape, cam[0], **f32)
    oy = torch.full(shape, cam[1], **f32)
    oz = torch.full(shape, cam[2], **f32)
    cr = torch.ones(shape, **f32)
    cg = torch.ones(shape, **f32)
    cb = torch.ones(shape, **f32)
    rad_r = torch.zeros(shape, **f32)
    rad_g = torch.zeros(shape, **f32)
    rad_b = torch.zeros(shape, **f32)
    alive = torch.ones(shape, dtype=torch.bool, device=p.device)

    for depth in range(opts.trace_depth):
        rr = depth > opts.rr_start_depth
        u_rr = None
        if opts.use_ld and depth < opts.n_ld:
            s0, s1 = _ld_rev_components(its, depth, seed_u, p)
            if rr:
                prng.reseed(mix(seed_u, its, depth, tile_id))
                u_rr = prng.u01()
            tags = ld_bounce_tags(depth)
            u_branch = _ld_u01(s0, ld_shift(seed_u, p, tags[0]))
            u_a = _ld_u01(s0, ld_shift(seed_u, p, tags[1]))
            u_b = _ld_u01(s1, ld_shift(seed_u, p, tags[2]))
        else:
            prng.reseed(mix(seed_u, its, depth, tile_id))
            if rr:
                u_rr = prng.u01()
            u_branch = prng.u01()
            u_a = prng.u01()
            u_b = prng.u01()

        if depth == 0 and not opts.antialias:
            best_t, nx, ny, nz, mat = (v.expand(shape) for v in primary[1])
        else:
            best_t, nx, ny, nz, mat = _intersect_all(packed, ox, oy, oz, dx, dy, dz)

        missed = best_t >= _MISS
        if opts.sky_strength:
            esc = missed & alive
            t_sky = 0.5 * (dy + 1.0)
            sky = (
                ((1.0 - t_sky) + t_sky * 0.5) * 0.5,
                ((1.0 - t_sky) + t_sky * 0.7) * 0.5,
                ((1.0 - t_sky) + t_sky * 1.0) * 0.5,
            )
            ss = opts.sky_strength
            rad_r = torch.where(esc, rad_r + cr * sky[0] * ss, rad_r)
            rad_g = torch.where(esc, rad_g + cg * sky[1] * ss, rad_g)
            rad_b = torch.where(esc, rad_b + cb * sky[2] * ss, rad_b)
        act = ~missed & alive

        m_cr, m_cg, m_cb, m_sr, m_sg, m_sb, m_refl, m_refr, m_emit = (
            mat_cols[j][mat] for j in range(9)
        )
        hit_light = act & (m_emit > 0.0)
        rad_r = torch.where(hit_light, rad_r + cr * m_cr * m_emit, rad_r)
        rad_g = torch.where(hit_light, rad_g + cg * m_cg * m_emit, rad_g)
        rad_b = torch.where(hit_light, rad_b + cb * m_cb * m_emit, rad_b)
        act = act & ~(m_emit > 0.0)

        if rr:  # Russian roulette with the 1/p boost
            p_cont = torch.maximum(m_cr, torch.maximum(m_cg, m_cb))
            rr_kill = act & (u_rr > p_cont)
            keep = act & ~rr_kill
            boost = torch.where(keep, 1.0 / torch.clamp_min(p_cont, 1e-12), 1.0)
            cr = cr * boost
            cg = cg * boost
            cb = cb * boost
            act = act & ~rr_kill

        rough = 1.0 - m_refr
        spec = act & (m_refl > 0.0) & (u_branch < m_refl)
        ddn = dx * nx + dy * ny + dz * nz
        rx = dx - 2.0 * ddn * nx
        ry = dy - 2.0 * ddn * ny
        rz = dz - 2.0 * ddn * nz
        ph2 = _TWO_PI_F32 * u_b
        cp2 = torch.cos(ph2)
        sp2 = torch.sin(ph2)
        ang = rough * u_a * _HALF_PI_F32
        sa = torch.sin(ang)
        ca = torch.cos(ang)
        st_ = torch.sqrt(u_a)
        ct_ = torch.sqrt(torch.clamp_min(1.0 - u_a, 0.0))
        vax = torch.where(spec, rx, nx)
        vay = torch.where(spec, ry, ny)
        vaz = torch.where(spec, rz, nz)
        s_pol = torch.where(spec, sa, st_)
        c_pol = torch.where(spec, ca, ct_)
        use_a = torch.abs(vax) > torch.abs(vay)
        tx = torch.where(use_a, vaz, 0.0)
        ty = torch.where(use_a, 0.0, -vaz)
        tz = torch.where(use_a, -vax, vay)
        rt = _rsqrt(torch.clamp_min(tx * tx + ty * ty + tz * tz, 1e-20))
        tx, ty, tz = tx * rt, ty * rt, tz * rt
        bxv = vay * tz - vaz * ty
        byv = vaz * tx - vax * tz
        bzv = vax * ty - vay * tx
        scp = s_pol * cp2
        ssp = s_pol * sp2
        ndx = tx * scp + vax * c_pol + bxv * ssp
        ndy = ty * scp + vay * c_pol + byv * ssp
        ndz = tz * scp + vaz * c_pol + bzv * ssp
        t_r = torch.where(spec, m_sr, m_cr)
        t_g = torch.where(spec, m_sg, m_cg)
        t_b = torch.where(spec, m_sb, m_cb)

        hx = ox + best_t * dx + nx * _ORIGIN_OFFSET
        hy = oy + best_t * dy + ny * _ORIGIN_OFFSET
        hz = oz + best_t * dz + nz * _ORIGIN_OFFSET
        cr = torch.where(act, cr * t_r, cr)
        cg = torch.where(act, cg * t_g, cg)
        cb = torch.where(act, cb * t_b, cb)
        ox = torch.where(act, hx, ox)
        oy = torch.where(act, hy, oy)
        oz = torch.where(act, hz, oz)
        dx = torch.where(act, ndx, dx)
        dy = torch.where(act, ndy, dy)
        dz = torch.where(act, ndz, dz)
        alive = act
    return rad_r, rad_g, rad_b


def render_samples_reference(
    pixel_ids: torch.Tensor,
    packed: PackedScene,
    opts: KernelOptions,
    seed: int,
    iter_base: int,
    num_samples: int,
) -> torch.Tensor:
    """Plain PyTorch version of the kernel over the flat pixel array.

    ``pixel_ids`` [N] int64 are the global pixel ids ``py·W + px`` of the
    rendered pixels, in order; pixel i of the array draws its hash stream as
    lane ``i % tile`` of tile ``i // tile``. Returns the [N, 3]
    f32 radiance sum over iterations ``iter_base .. iter_base+num_samples-1``,
    accumulated in ascending iteration order."""
    p = u32(pixel_ids)
    dev = p.device
    n = p.shape[0]
    pos = torch.arange(n, dtype=torch.int64, device=dev)
    lane = pos % opts.tile
    tile_id = pos // opts.tile
    fx = (p % packed.width).to(torch.float32)
    fy = (p // packed.width).to(torch.float32)
    primary = None
    if not opts.antialias:
        # iteration-invariant primary ray and hit, traced once per call
        cam = packed.cam.tolist()
        base_dir = _raygen(cam, packed.width, packed.height, fx, fy)
        o = torch.tensor(cam[:3], dtype=torch.float32, device=dev)
        hit0 = _intersect_all(packed, o[0], o[1], o[2], *base_dir)
        primary = (base_dir, hit0)
    acc = [torch.zeros(n, dtype=torch.float32, device=dev) for _ in range(3)]
    group = max(1, min(num_samples, _REFERENCE_BATCH // max(n, 1)))
    for start in range(0, num_samples, group):
        stop = min(num_samples, start + group)
        its = torch.arange(
            iter_base + start, iter_base + stop, dtype=torch.int64, device=dev
        )[:, None]
        rad = _trace_batch(packed, opts, seed, its, p, fx, fy, lane, tile_id, primary)
        for s in range(stop - start):
            for c in range(3):
                acc[c] = acc[c] + rad[c][s]
    return torch.stack(acc, dim=-1)


# ──────────────────────────────── kernel ────────────────────────────────


class Megakernel:
    """ctypes binding of ``csrc/megakernel.cu`` built with ``flags``.
    ``launches`` counts the kernel launches this binding made; it is
    incremented where the kernel is launched and nowhere else."""

    name = "megakernel"

    def __init__(self, flags: Sequence[str] = NVCC_FLAGS):
        self.flags = tuple(flags)
        self.launches = 0
        self._lib: Optional[ctypes.CDLL] = None

    def _fn(self):
        if self._lib is None:
            lib = load(self.name, self.flags)
            fn = lib.pt_megakernel_launch
            fn.restype = ctypes.c_int
            i, p = ctypes.c_int, ctypes.c_void_p
            fn.argtypes = [
                p, i, i, i, i, i, i, i, i, i, i, i, i, ctypes.c_float,
                p, p, p, p, p, i, i, i, p,
            ]
            self._lib = lib
        return self._lib.pt_megakernel_launch

    def __call__(
        self,
        packed: PackedScene,
        opts: KernelOptions,
        seed: int,
        iter_base: int,
        num_samples: int,
        device: torch.device,
    ) -> torch.Tensor:
        device = torch.device(device)
        if device.type != "cuda":
            raise ValueError(f"the CUDA megakernel needs a CUDA device, got {device}")
        if packed.num_geoms > MAX_GEOMS or packed.num_materials > MAX_MATERIALS:
            raise ValueError(
                f"scene has {packed.num_geoms} geoms / {packed.num_materials} "
                f"materials; the kernel's tables hold {MAX_GEOMS} / {MAX_MATERIALS}"
            )
        n = packed.width * packed.height
        fn = self._fn()
        out = torch.empty((n, 3), dtype=torch.float32, device=device)
        with torch.cuda.device(device):
            stream = torch.cuda.current_stream(device).cuda_stream
            self.launches += 1
            err = fn(
                out.data_ptr(), n, packed.width, packed.height,
                kernel_seed(seed), int(iter_base), opts.tile,
                int(num_samples), opts.trace_depth, opts.rr_start_depth,
                int(opts.antialias), int(opts.use_ld), opts.n_ld,
                opts.sky_strength,
                packed.cam.ctypes.data, packed.geo.ctypes.data,
                packed.mats.ctypes.data, packed.gmat.ctypes.data,
                packed.perm.ctypes.data, packed.num_cubes, packed.num_geoms,
                packed.num_materials, stream,
            )
        if err != 0:
            raise RuntimeError(f"megakernel launch failed: CUDA error {err}")
        return out


KERNEL = Megakernel()


def render_samples(
    scene,
    config,
    seed: int,
    iter_base: int,
    num_samples: int,
    packed: Optional[PackedScene] = None,
) -> torch.Tensor:
    """Render ``num_samples`` samples of the full frame in one launch.

    Returns the [N, 3] radiance *sum* over iterations ``iter_base ..
    iter_base+num_samples-1`` (the caller adds it to its accumulator).
    ``seed`` is the int32 kernel seed; the module's ``TILE`` keys the hash
    streams. ``packed`` (from :func:`pack_scene`)
    saves re-reading the scene tables on every call. A scene on a CUDA
    device runs the CUDA kernel; a scene on the CPU runs the plain version."""
    opts = kernel_options(config)
    if packed is None:
        packed = pack_scene(scene)
    n = packed.width * packed.height
    if opts.use_ld and n >= 1 << 24:
        raise ValueError("sampler='sobol' supports at most 2^24 pixels")
    device = scene.device
    if device.type == "cuda":
        return KERNEL(packed, opts, seed, iter_base, num_samples, device)
    if device.type == "cpu":
        pix = torch.arange(n, dtype=torch.int64, device=device)
        return render_samples_reference(pix, packed, opts, seed, iter_base, num_samples)
    raise ValueError(f"unsupported device {device}")
