"""The path-tracing megakernel: a batch of samples per launch, and its plain
PyTorch version.

Port of the JAX package's ``ops/pallas/megakernel.py``: the kernel built by
``_make_kernel``, launched over the full frame by ``_render_samples_impl``
and over chosen tiles by ``_render_tiles_impl``, with the estimator options
of analytic scenes: light_only or throughput (legacy) gathering, Russian
roulette past ``rr_start_depth``, the Owen-scrambled Sobol sampler on the
leading ``ld_depths`` bounces (or the counter-hash streams alone), sub-pixel
jitter, a thin-lens camera, dielectric refraction, and next-event estimation
(NEE) of the analytic emitters with multiple importance sampling (MIS).
Environment maps (kernels K3-K5) are not ported yet.

- :func:`render_samples` and :func:`render_tiles` are the entry points. On
  a scene whose tensors lie on a CUDA device they launch
  ``csrc/megakernel.cu`` (one thread per pixel); on the CPU they run
  :func:`render_samples_reference` / :func:`render_tiles_reference`. There
  is no fallback from one to the other.
- The plain versions are the same math, in the same operation order, and
  the same random streams, as torch operations over a ``[samples, pixels]``
  batch.

Random numbers are those of the JAX kernel in interpret mode (its only
replayable form): the LD lattice keyed by the global pixel id, and the
counter hash ``_HashPrng`` keyed by ``lane = p % TILE`` and reseeded with
``_mix(seed, iteration, depth | 0xAA | 0xD0F, tile)``. So the port is
comparable pixel by pixel with ``render_samples(..., interpret=True)``.
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
    ld_nee_tags,
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
_INV_PI = 0.3183098861837907
# the f32 constants of the TPU kernel's azimuth and cone angles:
# 2.0 * float32(pi) and float32(pi / 2)
_TWO_PI_F32 = float(np.float32(2.0 * np.float32(_PI)))
_HALF_PI_F32 = float(np.float32(_PI * 0.5))
_INV_PI_F32 = float(np.float32(_INV_PI))
_FMAX = 3.402823466e38
_MISS = 1e30
_BACKOFF = 1e-4
_ORIGIN_OFFSET = 1e-3

_GF = 21  # floats per geom: inverse transform rows (12) + inverse-transpose (9)
_MF = 10  # floats per material: color(3) spec_color(3) refl refr emit ior
_LF = 26  # floats per light row: A(9) translation(3) A^-T(9) |det A| Le(3) pdf
# table capacity of csrc/megakernel.cu's by-value scene parameter
MAX_GEOMS = 16
MAX_MATERIALS = 16
MAX_LIGHTS = MAX_GEOMS

# Samples × pixels per batch of the plain version (bounds its memory).
_REFERENCE_BATCH = 1 << 21

SOURCE = "cosc_4397_pathtracing_raytracing_project_tpu_torch/csrc/megakernel.cu"


# ───────────────────────────── scene tables ─────────────────────────────


@dataclasses.dataclass(frozen=True)
class LightTable:
    """The analytic emitters, one row per emissive cube or sphere in geom
    order (cubes, then spheres): the JAX ``_static_light_table`` rows
    ``(kind, mat_id, A 3×3, translation, A⁻ᵀ 3×3, |det A|, Le rgb)`` as
    float32 arrays (``kind`` 0 = cube, 1 = sphere)."""

    kind: np.ndarray  # [L] int32
    mat: np.ndarray  # [L] int32
    a: np.ndarray  # [L, 3, 3] f32, object-to-world linear part
    tr: np.ndarray  # [L, 3] f32, translation
    ait: np.ndarray  # [L, 3, 3] f32, inverse transpose of A
    det: np.ndarray  # [L] f32, |det A|
    le: np.ndarray  # [L, 3] f32, emitted radiance (color × emittance)

    @property
    def count(self) -> int:
        return int(self.kind.shape[0])

    @property
    def pdf(self) -> np.ndarray:
        """[L] f32 object-space area pdf over the light count, rounded once
        from double as the JAX kernel's ``float32(pdf_obj / n_lights)``."""
        n = self.count
        return np.array(
            [np.float32((_INV_PI if k == 1 else 1.0 / 6.0) / n) for k in self.kind],
            np.float32,
        )

    def packed(self) -> Tuple[np.ndarray, np.ndarray]:
        """(floats [L·26], ints [L·2]) rows of the kernel's light table."""
        f = np.concatenate(
            [
                self.a.reshape(-1, 9), self.tr, self.ait.reshape(-1, 9),
                self.det[:, None], self.le, self.pdf[:, None],
            ],
            axis=1,
        ).astype(np.float32)
        i = np.stack([self.kind, self.mat], axis=1).astype(np.int32)
        return np.ascontiguousarray(f.reshape(-1)), np.ascontiguousarray(i.reshape(-1))


@dataclasses.dataclass(frozen=True)
class PackedScene:
    """Host copies of the tables the kernel reads (the TPU kernel's SMEM
    operands): camera [16], geometry [K·21], geom material ids [K],
    materials [M·10], the per-geom axis-aligned column map [K·3]
    (-1 rows = general transform), and the light table for NEE."""

    cam: np.ndarray
    geo: np.ndarray
    gmat: np.ndarray
    mats: np.ndarray
    perm: np.ndarray
    num_cubes: int
    num_spheres: int
    width: int
    height: int
    lights: Optional[LightTable] = None

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


def static_light_table(scene) -> Optional[LightTable]:
    """The emissive-light table of in-kernel NEE (the JAX
    ``_static_light_table``), or None when the scene has no analytic
    emitter. Raises ``ValueError`` when two lights share a material id: the
    MIS weight at an emissive hit identifies the light by its material.
    (Emissive triangles, which the JAX table also rejects, cannot reach
    here: this port's scenes hold no triangles yet.)"""
    emit = _host(scene.materials.emittance)
    colors = _host(scene.materials.color)
    kind, mat, a, tr, ait, det, le = [], [], [], [], [], [], []
    for kind_id, batch in ((0, scene.cubes), (1, scene.spheres)):
        if not batch.count:
            continue
        mids = _host(batch.material_id)
        tfs = _host(batch.transform)
        its = _host(batch.inv_transpose)
        for i in np.nonzero(emit[mids] > 0.0)[0]:
            m3 = tfs[i][:3, :3]
            kind.append(kind_id)
            mat.append(int(mids[i]))
            a.append(m3)
            tr.append(tfs[i][:3, 3])
            ait.append(its[i][:3, :3])
            det.append(abs(np.linalg.det(m3)))
            le.append(colors[mids[i]] * emit[mids[i]])
    if not kind:
        return None
    if len(set(mat)) != len(mat):
        raise ValueError(
            "nee (megakernel): two lights share a material id — the MIS "
            "weight identifies the hit light by material; give each "
            "emitter its own material or use pipeline='reference'"
        )
    f32 = lambda xs: np.asarray(xs, np.float32)  # noqa: E731
    return LightTable(
        kind=np.asarray(kind, np.int32), mat=np.asarray(mat, np.int32),
        a=f32(a), tr=f32(tr), ait=f32(ait), det=f32(det), le=f32(le),
    )


def pack_scene(scene, nee: bool = False) -> PackedScene:
    """Read the scene's tables to the host once (the layout of the JAX
    ``_pack_scene`` plus the camera vector of ``_render_samples_impl``).
    With ``nee``, also the light table; a scene without analytic emitters
    then raises ``ValueError``, as the JAX ``render_samples`` does."""

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
    lights = None
    if nee:
        lights = static_light_table(scene)
        if lights is None:
            raise ValueError(
                "nee: scene has no analytic (cube/sphere) emissive lights"
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
        lights=lights,
    )


# ─────────────────────────────── options ───────────────────────────────


@dataclasses.dataclass(frozen=True)
class KernelOptions:
    trace_depth: int
    rr_start_depth: int
    antialias: bool
    sky_strength: float
    use_ld: bool  # sampler='sobol': AA jitter, lens and leading bounces from the LD lattice
    n_ld: int  # leading bounce depths drawing from the LD lattice
    tile: int  # pixels per hash-stream tile (the module's TILE)
    legacy: bool = False  # gather_mode='throughput'
    refraction: bool = False
    dof: bool = False
    nee: bool = False


def kernel_options(config) -> KernelOptions:
    """The kernel's options from a ``RenderConfig`` and the module's
    ``TILE``. Raises ``ValueError`` where the JAX kernel does (NEE with the
    throughput estimator); ``config.dof`` None counts as off (the Renderer
    resolves it from the camera's aperture). ``config.early_exit`` is
    accepted and changes nothing: the CUDA kernel's threads already leave
    their bounce loop when their path ends, and the JAX flag only skips
    bounces in which every lane of a tile is dead."""
    if config.gather_mode not in ("light_only", "throughput"):
        raise ValueError(f"unknown gather_mode {config.gather_mode!r}")
    legacy = config.gather_mode == "throughput"
    if config.nee and legacy:
        raise ValueError("nee requires gather_mode='light_only'")
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
        legacy=legacy,
        refraction=bool(config.enable_refraction),
        dof=bool(config.dof),
        nee=bool(config.nee),
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


def _object_ray(iv, perm, ox, oy, oz, dx, dy, dz):
    """Ray in a geom's object space (unnormalized direction)."""
    if perm is None:
        return (
            iv[0] * ox + iv[1] * oy + iv[2] * oz + iv[3],
            iv[4] * ox + iv[5] * oy + iv[6] * oz + iv[7],
            iv[8] * ox + iv[9] * oy + iv[10] * oz + iv[11],
            iv[0] * dx + iv[1] * dy + iv[2] * dz,
            iv[4] * dx + iv[5] * dy + iv[6] * dz,
            iv[8] * dx + iv[9] * dy + iv[10] * dz,
        )
    pw = (ox, oy, oz)
    dw = (dx, dy, dz)
    c0, c1, c2 = perm
    return (
        iv[c0] * pw[c0] + iv[3],
        iv[4 + c1] * pw[c1] + iv[7],
        iv[8 + c2] * pw[c2] + iv[11],
        iv[c0] * dw[c0],
        iv[4 + c1] * dw[c1],
        iv[8 + c2] * dw[c2],
    )


def _geom_rows(packed: PackedScene):
    geo = packed.geo.tolist()
    perms = packed.perm.reshape(-1, 3).tolist()
    for k in range(packed.num_geoms):
        perm = None if perms[k][0] < 0 else tuple(perms[k])
        yield k, geo[k * _GF : k * _GF + 12], geo[k * _GF + 12 : (k + 1) * _GF], perm


def _intersect_all(packed: PackedScene, ox, oy, oz, dx, dy, dz, want_out=False):
    """Nearest hit over every primitive: (t, world normal xyz, material[,
    outside]); ``outside`` (with ``want_out``) is whether the ray entered
    the primitive from outside, for refraction."""
    gmat = packed.gmat.tolist()
    shape = torch.broadcast_shapes(ox.shape, dx.shape)
    dev = dx.device
    best_t = torch.full(shape, _MISS, dtype=torch.float32, device=dev)
    best_nx = torch.zeros(shape, dtype=torch.float32, device=dev)
    best_ny = torch.zeros_like(best_nx)
    best_nz = torch.zeros_like(best_nx)
    best_mat = torch.zeros(shape, dtype=torch.int64, device=dev)
    best_out = torch.ones(shape, dtype=torch.bool, device=dev)
    for k, iv, it, perm in _geom_rows(packed):
        qox, qoy, qoz, qdx, qdy, qdz = _object_ray(iv, perm, ox, oy, oz, dx, dy, dz)
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
            outside = both_pos
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
        if want_out:
            best_out = torch.where(better, outside, best_out)

    rw = _rsqrt(
        torch.clamp_min(best_nx * best_nx + best_ny * best_ny + best_nz * best_nz, 1e-30)
    )
    hit = (best_t, best_nx * rw, best_ny * rw, best_nz * rw, best_mat)
    return hit + (best_out,) if want_out else hit


def _occluded_any(packed: PackedScene, ox, oy, oz, dx, dy, dz, limit):
    """Shadow test (the JAX ``occluded_any``): does any primitive hit with
    backoff-adjusted t in (0, limit)? Same per-geom arithmetic and
    positivity gate as :func:`_intersect_all`."""
    occ = torch.zeros(torch.broadcast_shapes(ox.shape, dx.shape), dtype=torch.bool,
                      device=dx.device)
    for k, iv, _it, perm in _geom_rows(packed):
        qox, qoy, qoz, qdx, qdy, qdz = _object_ray(iv, perm, ox, oy, oz, dx, dy, dz)
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
            ax = torch.minimum(t1x, t2x)
            ay = torch.minimum(t1y, t2y)
            az = torch.minimum(t1z, t2z)
            bx = torch.maximum(t1x, t2x)
            by = torch.maximum(t1y, t2y)
            bz = torch.maximum(t1z, t2z)
            ax = torch.where(ax > 0, ax, -_FMAX)
            ay = torch.where(ay > 0, ay, -_FMAX)
            az = torch.where(az > 0, az, -_FMAX)
            bx = torch.where(bx < _FMAX, bx, _FMAX)
            by = torch.where(by < _FMAX, by, _FMAX)
            bz = torch.where(bz < _FMAX, bz, _FMAX)
            s_min = torch.maximum(ax, torch.maximum(ay, az))
            s_max = torch.minimum(bx, torch.minimum(by, bz))
            hit = (s_max >= s_min) & (s_max > 0)
            sparam = torch.where(s_min > 0, s_min, s_max)
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
        occ = occ | (hit & (t_world > 0) & (t_world < limit))
    return occ


def _light_rows(lights: LightTable):
    """Per-light python-float rows (kind, mat, A, tr, A^-T, det, Le, pdf)."""
    pdf = lights.pdf
    for i in range(lights.count):
        yield (
            int(lights.kind[i]), int(lights.mat[i]), lights.a[i].tolist(),
            lights.tr[i].tolist(), lights.ait[i].tolist(), float(lights.det[i]),
            lights.le[i].tolist(), float(pdf[i]),
        )


def _emit_mis_weight(lights, hit, dx, dy, dz, prev_pdf):
    """Balance-heuristic weight of a BRDF-sampled emissive hit against NEE
    having sampled the same point (the JAX kernel's emissive branch): the
    hit light is found by material id, its area pdf follows from its
    transform and the world normal."""
    best_t, nx, ny, nz, mat = hit[:5]
    p_nee_area = torch.zeros_like(nx)
    sampled = torch.zeros_like(nx, dtype=torch.bool)
    for _kind, lmat, la, _tr, lait, ldet, _le, pdf in _light_rows(lights):
        o0 = la[0][0] * nx + la[1][0] * ny + la[2][0] * nz
        o1 = la[0][1] * nx + la[1][1] * ny + la[2][1] * nz
        o2 = la[0][2] * nx + la[1][2] * ny + la[2][2] * nz
        rn = _rsqrt(torch.clamp_min(o0 * o0 + o1 * o1 + o2 * o2, 1e-20))
        o0, o1, o2 = o0 * rn, o1 * rn, o2 * rn
        t0 = lait[0][0] * o0 + lait[0][1] * o1 + lait[0][2] * o2
        t1 = lait[1][0] * o0 + lait[1][1] * o1 + lait[1][2] * o2
        t2 = lait[2][0] * o0 + lait[2][1] * o1 + lait[2][2] * o2
        s = ldet * torch.sqrt(torch.clamp_min(t0 * t0 + t1 * t1 + t2 * t2, 1e-40))
        p_l = pdf * (1.0 / torch.clamp_min(s, 1e-20))
        sel = mat == lmat
        p_nee_area = torch.where(sel, p_l, p_nee_area)
        sampled = sampled | sel
    cos_l = torch.clamp_min(-(dx * nx + dy * ny + dz * nz), 1e-6)
    p_nee_dir = p_nee_area * best_t * best_t * (1.0 / cos_l)
    return torch.where(
        (prev_pdf < 0.0) | ~sampled,
        1.0,
        prev_pdf * (1.0 / torch.clamp_min(prev_pdf + p_nee_dir, 1e-20)),
    )


def _sample_light(row, u_l1, u_l2):
    """A point on one emitter, uniform by object-space area: (world point
    xyz, world unit normal xyz, world-area pdf including the 1/L pick, Le)."""
    kind, _m, la, ltr, lait, ldet, le, pdf = row
    if kind == 1:  # sphere: uniform direction, r = 0.5
        z = 1.0 - 2.0 * u_l1
        rxy = torch.sqrt(torch.clamp_min(1.0 - z * z, 0.0))
        ph = _TWO_PI_F32 * u_l2
        sn0 = rxy * torch.cos(ph)
        sn1 = z
        sn2 = rxy * torch.sin(ph)
        sp0, sp1, sp2 = 0.5 * sn0, 0.5 * sn1, 0.5 * sn2
    else:  # cube: uniform over the 6 unit faces
        f6 = u_l1 * 6.0
        face = torch.clamp_max(f6.to(torch.int32), 5)
        u_f = f6 - face.to(torch.float32)
        axis = face // 2
        sgn = torch.where(face % 2 == 0, 1.0, -1.0)
        cu = u_f - 0.5
        cv = u_l2 - 0.5
        sp0 = torch.where(axis == 0, sgn * 0.5, cu)
        sp1 = torch.where(axis == 1, sgn * 0.5, torch.where(axis == 0, cu, cv))
        sp2 = torch.where(axis == 2, sgn * 0.5, cv)
        sn0 = torch.where(axis == 0, sgn, 0.0)
        sn1 = torch.where(axis == 1, sgn, 0.0)
        sn2 = torch.where(axis == 2, sgn, 0.0)
    wx = la[0][0] * sp0 + la[0][1] * sp1 + la[0][2] * sp2 + ltr[0]
    wy = la[1][0] * sp0 + la[1][1] * sp1 + la[1][2] * sp2 + ltr[1]
    wz = la[2][0] * sp0 + la[2][1] * sp1 + la[2][2] * sp2 + ltr[2]
    un0 = lait[0][0] * sn0 + lait[0][1] * sn1 + lait[0][2] * sn2
    un1 = lait[1][0] * sn0 + lait[1][1] * sn1 + lait[1][2] * sn2
    un2 = lait[2][0] * sn0 + lait[2][1] * sn1 + lait[2][2] * sn2
    nn = torch.sqrt(torch.clamp_min(un0 * un0 + un1 * un1 + un2 * un2, 1e-40))
    rnn = 1.0 / nn
    pdf_a = pdf * (1.0 / torch.clamp_min(ldet * nn, 1e-20))
    full = torch.ones_like(wx)
    return (wx, wy, wz, un0 * rnn, un1 * rnn, un2 * rnn, pdf_a,
            full * le[0], full * le[1], full * le[2])


@dataclasses.dataclass(frozen=True)
class _Pixels:
    """Per-pixel keys of the flat batch: global id (LD lattice), float
    coordinates, hash lane and hash tile, first iteration (int or [N])."""

    pid: torch.Tensor
    fx: torch.Tensor
    fy: torch.Tensor
    lane: torch.Tensor
    tile_id: torch.Tensor
    iter_base: object


def _init_sample(packed, opts, seed_u, its, px: _Pixels, prng, primary, shape):
    """Primary rays of one batch of samples (the JAX ``init_sample``)."""
    cam = packed.cam.tolist()
    ld_pair = None
    if opts.use_ld and (opts.antialias or opts.dof):
        ld_pair = _sobol_rev_pair(its)
    if opts.antialias:
        if opts.use_ld:
            jx = _ld_u01(ld_pair[0], ld_shift(seed_u, px.pid, 0))
            jy = _ld_u01(ld_pair[1], ld_shift(seed_u, px.pid, 1))
        else:
            prng.reseed(mix(seed_u, its, 0xAA, px.tile_id))
            jx = prng.u01()
            jy = prng.u01()
        dx, dy, dz = _raygen(cam, packed.width, packed.height, px.fx + jx, px.fy + jy)
    elif opts.dof:
        if not opts.use_ld:
            # the lens stream; with antialias the 0xAA stream continues
            prng.reseed(mix(seed_u, its, 0xD0F, px.tile_id))
        dx, dy, dz = _raygen(cam, packed.width, packed.height, px.fx, px.fy)
    else:
        dx, dy, dz = primary[0]
    dx, dy, dz = (v.expand(shape) for v in (dx, dy, dz))
    f32 = dict(dtype=torch.float32, device=px.pid.device)
    ox = torch.full(shape, cam[0], **f32)
    oy = torch.full(shape, cam[1], **f32)
    oz = torch.full(shape, cam[2], **f32)
    if opts.dof:
        # thin lens: trace the pinhole ray to the focal plane, move the
        # origin to a concentric lens-disk sample, re-aim at that point
        ct = dx * cam[3] + dy * cam[4] + dz * cam[5]
        ft = torch.full_like(ct, cam[15]) / torch.clamp_min(ct, 1e-6)
        fpx = ox + dx * ft
        fpy = oy + dy * ft
        fpz = oz + dz * ft
        if opts.use_ld:
            u1 = _ld_u01(ld_pair[0], ld_shift(seed_u, px.pid, 2))
            u2 = _ld_u01(ld_pair[1], ld_shift(seed_u, px.pid, 3))
        else:
            u1 = prng.u01()
            u2 = prng.u01()
        rl = cam[14] * torch.sqrt(u1)
        th = _TWO_PI_F32 * u2
        lx = rl * torch.cos(th)
        ly = rl * torch.sin(th)
        ox = ox + cam[6] * lx + cam[9] * ly
        oy = oy + cam[7] * lx + cam[10] * ly
        oz = oz + cam[8] * lx + cam[11] * ly
        dx = fpx - ox
        dy = fpy - oy
        dz = fpz - oz
        rn = _rsqrt(torch.clamp_min(dx * dx + dy * dy + dz * dz, 1e-20))
        dx, dy, dz = dx * rn, dy * rn, dz * rn
    return ox, oy, oz, dx, dy, dz


def _count(stats, key, mask):
    if stats is not None:
        stats[key] = stats.get(key, 0) + mask.sum()


def _trace_batch(packed, opts, seed, its, px: _Pixels, primary, stats=None):
    """Radiance [3, S, N] of one batch of samples (its: [S, 1] or [S, N]).
    With ``stats``, adds the work the CUDA kernel's threads do for these
    samples: nearest-hit traces ('isect'), scatters ('scatter') and
    shadow rays ('shadow'), as 0-d tensors."""
    mat_cols = torch.as_tensor(
        packed.mats.reshape(-1, _MF).T.copy(), device=px.pid.device
    )  # [10, M]
    shape = torch.broadcast_shapes(its.shape, px.pid.shape)
    seed_u = seed & MASK32
    prng = HashPrng(px.lane)
    lights = packed.lights if opts.nee else None
    light_rows = list(_light_rows(lights)) if lights is not None else []
    n_lights = len(light_rows)

    ox, oy, oz, dx, dy, dz = _init_sample(packed, opts, seed_u, its, px, prng, primary, shape)
    f32 = dict(dtype=torch.float32, device=px.pid.device)
    cr = torch.ones(shape, **f32)
    cg = torch.ones(shape, **f32)
    cb = torch.ones(shape, **f32)
    rad_r = torch.zeros(shape, **f32)
    rad_g = torch.zeros(shape, **f32)
    rad_b = torch.zeros(shape, **f32)
    prev_pdf = torch.full(shape, -1.0, **f32)
    alive = torch.ones(shape, dtype=torch.bool, device=px.pid.device)

    for depth in range(opts.trace_depth):
        rr = depth > opts.rr_start_depth
        u_rr = u_l0 = u_l1 = u_l2 = None
        if opts.use_ld and depth < opts.n_ld:
            s0, s1 = _ld_rev_components(its, depth, seed_u, px.pid)
            if rr:
                prng.reseed(mix(seed_u, its, depth, px.tile_id))
                u_rr = prng.u01()
            tags = ld_bounce_tags(depth)
            u_branch = _ld_u01(s0, ld_shift(seed_u, px.pid, tags[0]))
            u_a = _ld_u01(s0, ld_shift(seed_u, px.pid, tags[1]))
            u_b = _ld_u01(s1, ld_shift(seed_u, px.pid, tags[2]))
            if lights is not None:
                ntags = ld_nee_tags(depth)
                if n_lights > 1:
                    u_l0 = _ld_u01(s0, ld_shift(seed_u, px.pid, ntags[0]))
                u_l1 = _ld_u01(s0, ld_shift(seed_u, px.pid, ntags[1]))
                u_l2 = _ld_u01(s1, ld_shift(seed_u, px.pid, ntags[2]))
        else:
            prng.reseed(mix(seed_u, its, depth, px.tile_id))
            if rr:
                u_rr = prng.u01()
            u_branch = prng.u01()
            u_a = prng.u01()
            u_b = prng.u01()
            if lights is not None:  # after the BSDF draws: the NEE-off stream is unchanged
                if n_lights > 1:
                    u_l0 = prng.u01()
                u_l1 = prng.u01()
                u_l2 = prng.u01()

        if depth == 0 and primary is not None:
            hit = tuple(v.expand(shape) for v in primary[1])
        else:
            hit = _intersect_all(packed, ox, oy, oz, dx, dy, dz, want_out=opts.refraction)
            _count(stats, "isect", alive)
        best_t, nx, ny, nz, mat = hit[:5]

        missed = best_t >= _MISS
        t_sky = 0.5 * (dy + 1.0)
        sky = (
            ((1.0 - t_sky) + t_sky * 0.5) * 0.5,
            ((1.0 - t_sky) + t_sky * 0.7) * 0.5,
            ((1.0 - t_sky) + t_sky * 1.0) * 0.5,
        )
        if opts.legacy:
            # reference quirk (`pathtrace.cu:358-362` parity): no alive
            # mask, so an escaped path, which re-misses on its kept ray,
            # takes the sky's tint again at every later depth
            cr = torch.where(missed, cr * sky[0], cr)
            cg = torch.where(missed, cg * sky[1], cg)
            cb = torch.where(missed, cb * sky[2], cb)
        elif opts.sky_strength:
            esc = missed & alive
            ss = opts.sky_strength
            rad_r = torch.where(esc, rad_r + cr * sky[0] * ss, rad_r)
            rad_g = torch.where(esc, rad_g + cg * sky[1] * ss, rad_g)
            rad_b = torch.where(esc, rad_b + cb * sky[2] * ss, rad_b)
        act = ~missed & alive

        m_cr, m_cg, m_cb, m_sr, m_sg, m_sb, m_refl, m_refr, m_emit, m_ior = (
            mat_cols[j][mat] for j in range(10)
        )
        hit_light = act & (m_emit > 0.0)
        if opts.legacy:
            cr = torch.where(hit_light, cr * m_cr * m_emit, cr)
            cg = torch.where(hit_light, cg * m_cg * m_emit, cg)
            cb = torch.where(hit_light, cb * m_cb * m_emit, cb)
        elif lights is not None:
            w_emit = _emit_mis_weight(lights, hit, dx, dy, dz, prev_pdf)
            rad_r = torch.where(hit_light, rad_r + cr * m_cr * m_emit * w_emit, rad_r)
            rad_g = torch.where(hit_light, rad_g + cg * m_cg * m_emit * w_emit, rad_g)
            rad_b = torch.where(hit_light, rad_b + cb * m_cb * m_emit * w_emit, rad_b)
        else:
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

        _count(stats, "scatter", act)
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

        glass = None
        off = _ORIGIN_OFFSET
        if opts.refraction:
            # dielectric: Snell + Schlick, transmit when u_branch >= Fresnel
            best_out = hit[5]
            is_glass = (m_ior > 0.0) & (m_refr > 0.0)
            cos_i = torch.clamp(-ddn, 0.0, 1.0)
            n1 = torch.where(best_out, 1.0, m_ior)
            n2 = torch.where(best_out, m_ior, 1.0)
            eta = n1 * (1.0 / torch.clamp_min(n2, 1e-6))
            sin2_t = eta * eta * torch.clamp_min(1.0 - cos_i * cos_i, 0.0)
            tir = sin2_t > 1.0
            cos_t = torch.sqrt(torch.clamp_min(1.0 - sin2_t, 0.0))
            r0 = (n1 - n2) * (1.0 / (n1 + n2))
            r0 = r0 * r0
            omc = 1.0 - cos_i
            omc2 = omc * omc
            fres = r0 + (1.0 - r0) * omc2 * omc2 * omc
            coef = eta * cos_i - cos_t
            fxr = eta * dx + coef * nx
            fyr = eta * dy + coef * ny
            fzr = eta * dz + coef * nz
            rnr = _rsqrt(torch.clamp_min(fxr * fxr + fyr * fyr + fzr * fzr, 1e-20))
            transmit = is_glass & ~tir & (u_branch >= fres)
            glass = act & is_glass
            ndx = torch.where(glass, torch.where(transmit, fxr * rnr, rx), ndx)
            ndy = torch.where(glass, torch.where(transmit, fyr * rnr, ry), ndy)
            ndz = torch.where(glass, torch.where(transmit, fzr * rnr, rz), ndz)
            t_r = torch.where(glass, torch.where(transmit, m_cr, m_sr), t_r)
            t_g = torch.where(glass, torch.where(transmit, m_cg, m_sg), t_g)
            t_b = torch.where(glass, torch.where(transmit, m_cb, m_sb), t_b)
            off = torch.where(glass & transmit, -_ORIGIN_OFFSET, _ORIGIN_OFFSET)

        hx = ox + best_t * dx + nx * off
        hy = oy + best_t * dy + ny * off
        hz = oz + best_t * dz + nz * off

        if lights is not None:
            # direct light at this vertex: the diffuse lobe (1 − P_spec)·albedo/π
            # with the post-RR, pre-tint throughput, MIS-weighted
            if n_lights == 1:
                lv = _sample_light(light_rows[0], u_l1, u_l2)
            else:
                pick = torch.clamp_max((u_l0 * n_lights).to(torch.int32), n_lights - 1)
                lv = None
                for li, row in enumerate(light_rows):
                    cand = _sample_light(row, u_l1, u_l2)
                    lv = cand if lv is None else tuple(
                        torch.where(pick == li, c, v) for c, v in zip(cand, lv)
                    )
            lpx, lpy, lpz, lnx, lny, lnz, pdf_a, le_r, le_g, le_b = lv
            tox, toy, toz = lpx - hx, lpy - hy, lpz - hz
            d2 = tox * tox + toy * toy + toz * toz
            dist = torch.sqrt(torch.clamp_min(d2, 1e-24))
            rdist = 1.0 / dist
            wix, wiy, wiz = tox * rdist, toy * rdist, toz * rdist
            cos_s = nx * wix + ny * wiy + nz * wiz
            cos_l2 = -(lnx * wix + lny * wiy + lnz * wiz)
            limit = dist - torch.clamp_min(1e-3 * dist, 1e-3)
            visible = ~_occluded_any(packed, hx, hy, hz, wix, wiy, wiz, limit)
            base = act & ~glass if glass is not None else act
            shadow = base & (cos_s > 0.0) & (cos_l2 > 0.0) & (dist > 1e-4)
            _count(stats, "shadow", shadow)
            add = shadow & visible
            diffuse_prob = 1.0 - m_refl
            p_brdf_area = (
                diffuse_prob * torch.clamp_min(cos_s, 0.0) * _INV_PI_F32
                * torch.clamp_min(cos_l2, 0.0) * (1.0 / torch.clamp_min(d2, 1e-12))
            )
            w_mis = pdf_a * (1.0 / torch.clamp_min(pdf_a + p_brdf_area, 1e-20))
            geomf = cos_s * cos_l2 * (1.0 / torch.clamp_min(d2 * pdf_a, 1e-20))
            k_d = diffuse_prob * _INV_PI_F32 * geomf * w_mis
            rad_r = torch.where(add, rad_r + cr * m_cr * k_d * le_r, rad_r)
            rad_g = torch.where(add, rad_g + cg * m_cg * k_d * le_g, rad_g)
            rad_b = torch.where(add, rad_b + cb * m_cb * k_d * le_b, rad_b)
            # pdf of the lobe that generated the extension ray, for the
            # next emissive hit's MIS weight; delta lobes carry −1
            cos_new = torch.clamp_min(ndx * nx + ndy * ny + ndz * nz, 0.0)
            diffuse_ext = act & ~spec
            if glass is not None:
                diffuse_ext = diffuse_ext & ~glass
            prev_pdf = torch.where(
                diffuse_ext, (1.0 - m_refl) * cos_new * _INV_PI_F32, -1.0
            )

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
    if opts.legacy:  # every path's terminal throughput, as `pathtrace.cu:439-444`
        return cr, cg, cb
    return rad_r, rad_g, rad_b


def _render_reference(packed, opts, seed, px: _Pixels, num_samples, stats=None):
    """Radiance sums [N, 3] of the plain version over ``px``, accumulated
    in ascending iteration order (``stats``: see :func:`_trace_batch`)."""
    dev = px.pid.device
    n = px.pid.shape[0]
    primary = None
    if not opts.antialias and not opts.dof:
        # iteration-invariant primary ray and hit, traced once per call
        cam = packed.cam.tolist()
        base_dir = _raygen(cam, packed.width, packed.height, px.fx, px.fy)
        o = torch.tensor(cam[:3], dtype=torch.float32, device=dev)
        hit0 = _intersect_all(packed, o[0], o[1], o[2], *base_dir, want_out=opts.refraction)
        primary = (base_dir, hit0)
        _count(stats, "isect", torch.ones_like(px.fx, dtype=torch.bool))
    base = px.iter_base
    acc = [torch.zeros(n, dtype=torch.float32, device=dev) for _ in range(3)]
    group = max(1, min(num_samples, _REFERENCE_BATCH // max(n, 1)))
    for start in range(0, num_samples, group):
        stop = min(num_samples, start + group)
        its = base + torch.arange(start, stop, dtype=torch.int64, device=dev)[:, None]
        rad = _trace_batch(packed, opts, seed, its, px, primary, stats)
        for s in range(stop - start):
            for c in range(3):
                acc[c] = acc[c] + rad[c][s]
    return torch.stack(acc, dim=-1)


def render_samples_reference(
    pixel_ids: torch.Tensor,
    packed: PackedScene,
    opts: KernelOptions,
    seed: int,
    iter_base: int,
    num_samples: int,
    stats: Optional[dict] = None,
) -> torch.Tensor:
    """Plain PyTorch version of the kernel over the flat pixel array.

    ``pixel_ids`` [N] int64 are the global pixel ids ``py·W + px`` of the
    rendered pixels, in order; pixel i of the array draws its hash stream as
    lane ``i % tile`` of tile ``i // tile``. Returns the [N, 3]
    f32 radiance sum over iterations ``iter_base .. iter_base+num_samples-1``,
    accumulated in ascending iteration order. ``stats``, if given, receives
    the work counts of :func:`_trace_batch`."""
    p = u32(pixel_ids)
    pos = torch.arange(p.shape[0], dtype=torch.int64, device=p.device)
    px = _Pixels(
        pid=p,
        fx=(p % packed.width).to(torch.float32),
        fy=(p // packed.width).to(torch.float32),
        lane=pos % opts.tile,
        tile_id=pos // opts.tile,
        iter_base=int(iter_base),
    )
    return _render_reference(packed, opts, seed, px, num_samples, stats)


def render_tiles_reference(
    px: torch.Tensor,
    py: torch.Tensor,
    tile_ids: torch.Tensor,
    iter_bases: torch.Tensor,
    packed: PackedScene,
    opts: KernelOptions,
    seed: int,
    num_samples: int,
    stats: Optional[dict] = None,
) -> torch.Tensor:
    """Plain PyTorch version of the tile dispatch (the JAX
    ``render_tiles``): ``px``/``py`` [K·tile] f32 pixel coordinates of K
    tiles; tile g's pixels draw hash tile ``tile_ids[g]`` and iterations
    ``iter_bases[g] .. iter_bases[g]+num_samples-1``. Returns [K·tile, 3]."""
    k = tile_ids.shape[0]
    if px.shape != (k * opts.tile,) or py.shape != px.shape:
        raise ValueError(
            f"px/py must be [{k * opts.tile}] for {k} tiles; got "
            f"{tuple(px.shape)}/{tuple(py.shape)}"
        )
    dev = px.device
    pos = torch.arange(px.shape[0], dtype=torch.int64, device=dev)
    g = pos // opts.tile
    pid = py.to(torch.int64) * packed.width + px.to(torch.int64)
    pixels = _Pixels(
        pid=pid,
        fx=px.to(torch.float32),
        fy=py.to(torch.float32),
        lane=pos % opts.tile,
        tile_id=tile_ids.to(torch.int64)[g],
        iter_base=iter_bases.to(torch.int64)[g],
    )
    return _render_reference(packed, opts, seed, pixels, num_samples, stats)


# ──────────────────────────────── kernel ────────────────────────────────


class Megakernel:
    """ctypes binding of ``csrc/megakernel.cu`` built with ``flags``.
    ``launches`` counts the kernel launches of every option set this
    binding made; ``launches_by_variant`` splits them by the kernel's
    compile-time variant (:func:`variant_name`). Both are incremented where
    the kernel is launched and nowhere else."""

    name = "megakernel"

    def __init__(self, flags: Sequence[str] = NVCC_FLAGS):
        self.flags = tuple(flags)
        self.launches = 0
        self.launches_by_variant: dict = {}
        self._lib: Optional[ctypes.CDLL] = None

    def reset_counts(self) -> None:
        self.launches = 0
        self.launches_by_variant = {}

    def _fn(self):
        if self._lib is None:
            lib = load(self.name, self.flags)
            fn = lib.pt_megakernel_launch
            fn.restype = ctypes.c_int
            i, p, f = ctypes.c_int, ctypes.c_void_p, ctypes.c_float
            fn.argtypes = [
                p, i, i, i, i, i, i, i, i, i, i, i, i, f,  # output, frame, sampling
                i, i, i, i,  # nee, refraction, dof, legacy
                p, p, p, p, p, i, i, i,  # scene tables
                p, p, i,  # light table
                p, p, p, i,  # tile dispatch
                p,  # stream
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
        tiles: Optional[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]] = None,
    ) -> torch.Tensor:
        """Launch over the full frame, or with ``tiles = (table, px, py)``
        over K chosen tiles: ``table`` int32 [2K] (K tile ids, then K
        1-based iteration bases) and ``px``/``py`` f32 [K·tile], all on
        ``device``."""
        device = torch.device(device)
        if device.type != "cuda":
            raise ValueError(f"the CUDA megakernel needs a CUDA device, got {device}")
        if packed.num_geoms > MAX_GEOMS or packed.num_materials > MAX_MATERIALS:
            raise ValueError(
                f"scene has {packed.num_geoms} geoms / {packed.num_materials} "
                f"materials; the kernel's tables hold {MAX_GEOMS} / {MAX_MATERIALS}"
            )
        lights_f = lights_i = None
        num_lights = 0
        if opts.nee:
            if packed.lights is None:
                raise ValueError("nee: the packed scene carries no light table")
            lights_f, lights_i = packed.lights.packed()
            num_lights = packed.lights.count
        n = packed.width * packed.height
        table = px = py = None
        num_tiles = 0
        if tiles is not None:
            table, px, py = tiles
            num_tiles = table.shape[0] // 2
            n = num_tiles * opts.tile
            for t, dtype in ((table, torch.int32), (px, torch.float32), (py, torch.float32)):
                if t.device != device or t.dtype != dtype or not t.is_contiguous():
                    raise ValueError(
                        "tile tables must be contiguous int32/f32 tensors on "
                        f"{device}, got {t.dtype} on {t.device}"
                    )
            if table.shape != (2 * num_tiles,) or px.shape != (n,) or py.shape != (n,):
                raise ValueError(
                    f"tile table [{2 * num_tiles}] needs px/py [{n}], got "
                    f"{tuple(px.shape)}/{tuple(py.shape)}"
                )
        fn = self._fn()
        out = torch.empty((n, 3), dtype=torch.float32, device=device)
        ptr = lambda a: None if a is None else a.ctypes.data  # noqa: E731
        dptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
        with torch.cuda.device(device):
            stream = torch.cuda.current_stream(device).cuda_stream
            self.launches += 1
            key = variant_name(opts, tiles is not None)
            self.launches_by_variant[key] = self.launches_by_variant.get(key, 0) + 1
            err = fn(
                out.data_ptr(), n, packed.width, packed.height,
                kernel_seed(seed), int(iter_base), opts.tile,
                int(num_samples), opts.trace_depth, opts.rr_start_depth,
                int(opts.antialias), int(opts.use_ld), opts.n_ld,
                opts.sky_strength,
                int(opts.nee), int(opts.refraction), int(opts.dof), int(opts.legacy),
                packed.cam.ctypes.data, packed.geo.ctypes.data,
                packed.mats.ctypes.data, packed.gmat.ctypes.data,
                packed.perm.ctypes.data, packed.num_cubes, packed.num_geoms,
                packed.num_materials,
                ptr(lights_f), ptr(lights_i), num_lights,
                dptr(table), dptr(px), dptr(py), num_tiles,
                stream,
            )
        if err != 0:
            raise RuntimeError(f"megakernel launch failed: CUDA error {err}")
        return out


def variant_name(opts: KernelOptions, tiles: bool = False) -> str:
    """The kernel's compile-time variant for these options, as named in its
    ptxas report: the enabled features joined by '+' ('main' if none)."""
    parts = [
        name for name, on in (
            ("nee", opts.nee), ("refraction", opts.refraction), ("dof", opts.dof),
            ("throughput", opts.legacy), ("tiles", tiles),
        ) if on
    ]
    return "+".join(parts) or "main"


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
    streams. ``packed`` (from :func:`pack_scene`, with the light table when
    ``config.nee``) saves re-reading the scene tables on every call. A
    scene on a CUDA device runs the CUDA kernel; a scene on the CPU runs the
    plain version."""
    opts = kernel_options(config)
    if packed is None:
        packed = pack_scene(scene, nee=opts.nee)
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


def render_tiles(
    scene,
    config,
    seed: int,
    tile_ids: torch.Tensor,
    iter_bases: torch.Tensor,
    px: torch.Tensor,
    py: torch.Tensor,
    num_samples: int,
    packed: Optional[PackedScene] = None,
) -> torch.Tensor:
    """Render ``num_samples`` samples for K chosen tiles in one launch (the
    JAX ``render_tiles``, the adaptive sampler's entry point).

    ``tile_ids`` [K] are the tiles' hash keys, ``iter_bases`` [K] each
    tile's next 1-based iteration, ``px``/``py`` [K·TILE] f32 the pixel
    coordinates of each tile's lanes (the caller owns the pixel→lane layout
    and scatters the result back). All live on the scene's device, so a
    dispatch never reads them back to the host. Returns [K·TILE, 3]."""
    opts = kernel_options(config)
    if packed is None:
        packed = pack_scene(scene, nee=opts.nee)
    if opts.use_ld and packed.width * packed.height >= 1 << 24:
        raise ValueError("sampler='sobol' supports at most 2^24 pixels")
    device = scene.device
    if device.type == "cuda":
        table = torch.cat([tile_ids.to(torch.int32), iter_bases.to(torch.int32)])
        tiles = (table, px.to(torch.float32).contiguous(), py.to(torch.float32).contiguous())
        return KERNEL(packed, opts, seed, 0, num_samples, device, tiles=tiles)
    if device.type == "cpu":
        return render_tiles_reference(
            px, py, tile_ids, iter_bases, packed, opts, seed, num_samples
        )
    raise ValueError(f"unsupported device {device}")
