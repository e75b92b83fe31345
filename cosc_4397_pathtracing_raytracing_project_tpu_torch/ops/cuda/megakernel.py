"""The path-tracing megakernel: a batch of samples per launch, and its plain
PyTorch version.

Port of the JAX package's ``ops/pallas/megakernel.py``: the kernel built by
``_make_kernel``, launched over the full frame by ``_render_samples_impl``
and over chosen tiles by ``_render_tiles_impl``, with the estimator options
of analytic scenes: light_only or throughput (legacy) gathering, Russian
roulette past ``rr_start_depth``, the Owen-scrambled Sobol sampler on the
leading ``ld_depths`` bounces (or the counter-hash streams alone), sub-pixel
jitter, a thin-lens camera, dielectric refraction, and next-event estimation
(NEE) of the analytic emitters with multiple importance sampling (MIS),
and the environment map: the exact bilinear HDR lookup at escape (K3),
environment NEE from shared alias-table rows with MIS (K4), and the sun/sky
split with delta suns, an SH-9 residual sky and the exact background
composited outside the kernel (K5).

- :func:`render_samples` and :func:`render_tiles` are the entry points. On
  a scene whose tensors lie on a CUDA device they launch
  ``csrc/megakernel.cu`` (persistent warps over a pixel queue with path
  regeneration, emulated by :func:`warp_schedule`); on the CPU they run
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
from ...render import profiling
from .. import camera as camera_ops
from .. import envmap as envmap_ops
from ..intersect import intersect_scene
from ..rng import (
    MASK32,
    bit_reverse32,
    cell_words,
    fold_in,
    kernel_seed,
    laine_karras,
    ld_bounce_tags,
    ld_nee_tags,
    ld_shift,
    mul32,
    prng_key,
    to_u01,
    u32,
    uniform,
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
# table capacity of csrc/megakernel.cu's by-value scene parameter: the JAX
# package's MAX_UNROLL analytic primitives (its megakernel takes 1-64, and
# routes other counts to its reference pipeline); pack_scene keeps only the
# materials the geoms reference, so they never outnumber the geoms
MAX_GEOMS = 64
MAX_MATERIALS = MAX_GEOMS
MAX_LIGHTS = MAX_GEOMS
# delta suns of env_mode='split' that travel by value (RenderConfig's
# default env_split_suns is 8)
MAX_SUNS = 32
# entries of a warp's queue of light rays in the NEE variants (a warp tests
# them 32 at a time, and at most 31 wait when an iteration adds 32 more)
QUEUE_SLOTS = 64
# Largest exact map the kernel takes: it indexes the map's texels (one
# float4 each, EnvTables.tex) with 32-bit float offsets, h·w·4 < 2^31. The
# JAX kernel holds the map in VMEM and caps it at 256×512 texels
# (`megakernel.py:420-427`, MAX_ENV_EXACT_TEXELS); the card reads it from
# device memory, so any map below this limit renders in-kernel (a deliberate
# deviation, ROADMAP Queue 3).
MAX_ENV_TEXELS = ((1 << 31) - 1) // 4

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
class EnvTables:
    """The environment map as the kernel reads it (the JAX kernel's env
    VMEM planes and static split tables).

    - ``exact``: ``tex`` the map's texels [H·W·4] f32 on the scene's
      device, texel (y, x) (row-major) the strength-folded radiance RGB and
      the sampler's pdf, which the kernel reads as one float4
      (:func:`texel_table`); ``envmap`` draws env NEE's shared rows and
      holds the planes the plain version reads.
    - ``split``: ``suns`` [S, 6] f32 rows (dx, dy, dz, Er, Eg, Eb) and
      ``sh`` [3, 9] f32 (column 0 holds the rounded product coef·Y00, as the
      JAX kernel's first SH term), from ``sh_coeffs``, the float64
      ``split_envmap`` output; with ``bg_external``, ``bg`` [N, 3] is the
      exact bilinear background of each primary ray and ``bg_miss`` [N]
      f32 1 where that ray misses every primitive."""

    mode: str  # 'exact' | 'split'
    height: int
    width: int
    envmap: object = None  # ops.envmap.EnvMap
    tex: Optional[torch.Tensor] = None
    suns: Optional[np.ndarray] = None
    sh: Optional[np.ndarray] = None
    sh_coeffs: tuple = ()
    bg: Optional[torch.Tensor] = None
    bg_miss: Optional[torch.Tensor] = None

    @property
    def num_suns(self) -> int:
        return 0 if self.suns is None else int(self.suns.shape[0])


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
    env: Optional[EnvTables] = None

    @property
    def num_geoms(self) -> int:
        return self.num_cubes + self.num_spheres

    @property
    def num_materials(self) -> int:
        return self.mats.shape[0] // _MF

    @property
    def has_emitters(self) -> bool:
        """Whether any geom's material emits (from the host tables, so
        routing a packed scene reads nothing back from the device)."""
        return bool(np.any(self.mats.reshape(-1, _MF)[self.gmat, 8] > 0.0))


def _host(t: torch.Tensor) -> np.ndarray:
    """A scene table's copy to the host (a wait for the device)."""
    profiling.count("host_syncs")
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
    here: scenes with triangles take the mesh pipeline.)"""
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


def pack_scene(scene, nee: bool = False, config=None) -> PackedScene:
    """Read the scene's tables to the host once (the layout of the JAX
    ``_pack_scene`` plus the camera vector of ``_render_samples_impl``).
    Only the materials that some geom references are kept, renumbered
    densely in id order (the geoms' and lights' ids follow), so a file with
    any number of materials fits the kernel's table; where every material
    is referenced, the tables are the JAX ones. With ``nee``, also the
    light table; a scene without analytic emitters then raises
    ``ValueError``, as the JAX ``render_samples`` does. With a ``config``
    and a scene with an environment map, also the map's tables for
    ``config.env_mode`` (:func:`pack_env`)."""

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
    used = np.unique(gmat)
    dense = np.full(num_materials, -1, np.int32)
    dense[used] = np.arange(used.size, dtype=np.int32)
    gmat, mats = dense[gmat], mats[used]
    lights = None
    if nee:
        lights = static_light_table(scene)
        if lights is None:
            raise ValueError(
                "nee: scene has no analytic (cube/sphere) emissive lights"
            )
        lights = dataclasses.replace(lights, mat=dense[lights.mat])
    perm = np.full((geo.shape[0], 3), -1, np.int32)
    for k, (_kind, p) in enumerate(static_geom_kinds(scene)):
        if p is not None:
            perm[k] = p
    w, h = scene.camera.resolution
    return PackedScene(
        cam=pack_camera(scene.camera),
        geo=np.ascontiguousarray(geo.reshape(-1), np.float32),
        gmat=np.ascontiguousarray(gmat),
        mats=np.ascontiguousarray(mats.reshape(-1)),
        perm=np.ascontiguousarray(perm.reshape(-1)),
        num_cubes=scene.cubes.count,
        num_spheres=scene.spheres.count,
        width=int(w),
        height=int(h),
        lights=lights,
        env=pack_env(scene, config) if config is not None and scene.envmap is not None else None,
    )


def pack_camera(camera) -> np.ndarray:
    """The kernel's camera vector [16] f32: position, view, right, up,
    pixel_length, aperture, focal, joined on the camera's device and read
    to the host in one copy (one wait)."""
    c = camera
    vec = torch.cat([c.position, c.view, c.right, c.up, c.pixel_length,
                     c.aperture.reshape(1), c.focal.reshape(1)])
    return np.ascontiguousarray(_host(vec), np.float32)


def with_camera(packed: PackedScene, scene, opts: KernelOptions) -> PackedScene:
    """``packed`` for ``scene``, which differs from the scene it was packed
    from only in its camera, at the same resolution (the same geometry,
    materials and map; ``opts`` their kernel options): the camera vector
    read anew, and in split mode with the background composited outside
    the kernel, the new primary rays' background and miss mask. Every other
    table, the texel table too, is the same object."""
    env = packed.env
    if env is not None and opts.bg_external:
        bg, bg_miss = _split_background(scene)
        env = dataclasses.replace(env, bg=bg, bg_miss=bg_miss)
    return dataclasses.replace(packed, cam=pack_camera(scene.camera), env=env)


def _split_background(scene) -> Tuple[torch.Tensor, torch.Tensor]:
    """Split mode's background composited outside the kernel: the exact
    bilinear background [N, 3] of each primary ray of ``scene``'s camera,
    and [N] f32 1 where that ray misses every primitive."""
    o3, d3 = camera_ops.generate_rays(scene.camera)
    bg_miss = intersect_scene(scene, o3, d3).miss.to(torch.float32)
    return envmap_ops.env_radiance(scene.envmap, d3), bg_miss


def pack_env(scene, config) -> EnvTables:
    """The environment tables of ``scene`` for ``config`` (the JAX
    ``_static_env_exact`` / ``_static_env_split`` and the planes of
    ``_render_samples_impl``). Split tables come from float64 NumPy, as in
    JAX; the split background is one bilinear lookup per primary ray and the
    primary rays' miss mask, both iteration-invariant, so they are computed
    once here. Raises ``ValueError`` past ``MAX_SUNS`` suns."""
    opts = kernel_options(config, scene)
    env = scene.envmap
    h, w = env.shape
    if opts.env == "exact":
        return EnvTables(mode="exact", height=h, width=w, envmap=env, tex=texel_table(env))
    img = _host(env.img).astype(np.float64) * float(_host(env.strength))
    suns, sh = envmap_ops.split_envmap(
        img, max_suns=int(config.env_split_suns), thresh=float(config.env_split_thresh)
    )
    if len(suns) > MAX_SUNS:
        raise ValueError(
            f"env_mode='split': {len(suns)} suns exceed the kernel's MAX_SUNS="
            f"{MAX_SUNS}; lower env_split_suns or use env_mode='exact'"
        )
    sh_f = np.array([[np.float32(ch[0] * envmap_ops._SH_C[0])] + list(ch[1:]) for ch in sh],
                    np.float32)
    bg, bg_miss = _split_background(scene) if opts.bg_external else (None, None)
    return EnvTables(
        mode="split", height=h, width=w, envmap=env,
        suns=np.asarray(suns, np.float32).reshape(-1, 6), sh=sh_f, sh_coeffs=sh,
        bg=bg, bg_miss=bg_miss,
    )


def texel_table(env) -> torch.Tensor:
    """The exact map's texels [H·W·4] f32 on the map's device
    (:class:`EnvTables`): texel (y, x) at 4·(y·W + x), its strength-folded
    RGB and the sampler's pdf."""
    h, w = env.shape
    return torch.cat([(env.img * env.strength).reshape(h, w, 3), env.pdf.reshape(h, w, 1)],
                     dim=-1).reshape(-1).contiguous()


def build_env_nee_rows(env, seed: int, iter_base: int, num_samples: int,
                       trace_depth: int) -> torch.Tensor:
    """[S·D, 8] shared env-NEE rows (the JAX ``_build_env_nee_rows``): one
    alias draw per (iteration, depth), ``(dir xyz, bilinear radiance rgb,
    solid-angle pdf, 0)``, on the map's device. The uniforms are
    ``jax.random``'s: ``PRNGKey(uint32(seed) ^ 0xE17B0075)`` folded with the
    absolute iteration, then ``uniform(k, (trace_depth, 2))``; on a map past
    ``envmap.ENV_CELL_SPLIT`` texels the alias cells come from
    ``rng.cell_words(k, (trace_depth,))`` (where the JAX rows take them from
    the first uniform). Radiance is bilinear, so both MIS techniques
    integrate the same L as the escape lookup."""
    dev = env.device
    key = prng_key(u32(seed) ^ 0xE17B0075)
    iters = u32(int(iter_base) + torch.arange(num_samples, dtype=torch.int64))
    keys = tuple(k.to(dev) for k in fold_in(key, iters))
    u = uniform(keys, (trace_depth, 2)).reshape(-1, 2)
    words = (cell_words(keys, (trace_depth,)).reshape(-1, 2)
             if envmap_ops.needs_cell_words(env) else None)
    d, _le_nearest, pdf = envmap_ops.sample_env(env, u[:, 0], u[:, 1], words)
    le = envmap_ops.env_radiance(env, d)
    return torch.cat([d, le, pdf[:, None], torch.zeros_like(pdf)[:, None]], dim=-1)


def env_row_table(packed: PackedScene, dirs: torch.Tensor) -> torch.Tensor:
    """[R, num_geoms, 6] f32: per direction (``dirs`` [R, 3], env NEE's row
    directions) and geom, what the env ray's test against that geom reads
    that no origin changes, in :func:`_occluded_any`'s expressions: the
    object-space direction (``_object_ray``'s) and, for a cube, its three
    reciprocals, for a sphere ``|q_d|²`` and its reciprocal (then 0)."""
    dx, dy, dz = dirs[:, 0], dirs[:, 1], dirs[:, 2]
    zero = torch.zeros((), dtype=torch.float32, device=dirs.device)
    entries = []
    for k, iv, _it, perm in _geom_rows(packed):
        _, _, _, qdx, qdy, qdz = _object_ray(iv, perm, zero, zero, zero, dx, dy, dz)
        if k < packed.num_cubes:
            e = (qdx, qdy, qdz, 1.0 / qdx, 1.0 / qdy, 1.0 / qdz)
        else:
            nq2 = qdx * qdx + qdy * qdy + qdz * qdz
            e = (qdx, qdy, qdz, nq2, 1.0 / nq2, torch.zeros_like(nq2))
        entries.append(torch.stack(e, dim=-1))
    if not entries:
        return torch.zeros((dirs.shape[0], 0, 6), dtype=torch.float32, device=dirs.device)
    return torch.stack(entries, dim=1)


def env_nee_rows_reference(packed: PackedScene, seed: int, iter_base: int, num_samples: int,
                           trace_depth: int) -> torch.Tensor:
    """Plain version of the row kernel (``pt_env_rows``): env NEE's rows
    [S·D, 8 + 6·num_geoms] on the map's device, :func:`build_env_nee_rows`'
    eight columns, then :func:`env_row_table`'s entries of the row's
    direction, geom by geom."""
    rows = build_env_nee_rows(packed.env.envmap, seed, iter_base, num_samples, trace_depth)
    table = env_row_table(packed, rows[:, :3])
    return torch.cat([rows, table.reshape(rows.shape[0], -1)], dim=-1)


def env_nee_rows(packed: PackedScene, seed: int, iter_base: int, num_samples: int,
                 trace_depth: int) -> torch.Tensor:
    """Env NEE's rows of iterations ``iter_base .. iter_base+num_samples-1``
    with their per-geom table, [S·D, 8 + 6·num_geoms] (the layout the
    kernel's env NEE reads; a slice of whole samples is the rows of those
    iterations). On a map on a CUDA device one launch of the row kernel
    builds them; on the CPU :func:`env_nee_rows_reference`, the kernel's
    plain version, table included: the plain megakernel step reads only
    the first eight columns, but the wrapper returns the kernel's layout on
    either device, so its callers and tests see one function."""
    if packed.env is None or packed.env.mode != "exact":
        raise ValueError("env NEE rows need the packed scene's exact environment tables")
    device = packed.env.envmap.device
    if device.type == "cuda":
        return KERNEL.env_rows(packed, seed, iter_base, num_samples, trace_depth)
    if device.type == "cpu":
        return env_nee_rows_reference(packed, seed, iter_base, num_samples, trace_depth)
    raise ValueError(f"unsupported device {device}")


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
    nee: bool = False  # NEE of the analytic emitters (K2)
    env: str = "none"  # 'none' | 'exact' (K3) | 'split' (K5)
    env_nee: bool = False  # exact env importance-sampled in-kernel (K4)
    bg_external: bool = False  # split: depth-0 background composited outside


def supports(scene) -> bool:
    """Whether the megakernel renders ``scene`` (the JAX ``supports``):
    analytic scenes of 1 to ``MAX_GEOMS`` primitives (triangles take the
    mesh pipeline, other counts the reference pipeline). Unlike the JAX
    ``supports`` it takes an environment map of any size: the JAX kernel's
    VMEM cap does not apply here (:data:`MAX_ENV_TEXELS`)."""
    return not scene.num_triangles and 0 < scene.cubes.count + scene.spheres.count <= MAX_GEOMS


def _has_emitters(scene, packed=None) -> bool:
    if packed is not None:
        return packed.has_emitters
    return static_light_table(scene) is not None


def wants_env_nee(scene, config, packed=None) -> bool:
    """True iff ``(scene, config)`` runs the in-kernel env NEE estimator
    (the JAX ``_wants_env_nee``): ``env_mode='exact'`` + ``nee`` on a scene
    with an environment map and no analytic emitter. Raises ``ValueError``
    for an environment plus analytic emitters under ``nee`` (their combined
    NEE runs on the fast pipeline, ``ops/fast.trace_sample_fast``). With the
    scene's ``packed`` tables, reads nothing from the device."""
    if not config.nee or scene.envmap is None or config.env_mode == "split":
        return False
    if config.gather_mode != "light_only":
        raise ValueError("nee requires gather_mode='light_only'")
    if _has_emitters(scene, packed):
        raise ValueError(
            "exact env + analytic emissive lights: the combined "
            "two-technique NEE runs on pipeline='fast'"
        )
    return True


def kernel_options(config, scene=None, packed=None) -> KernelOptions:
    """The kernel's options from a ``RenderConfig`` (and, for a scene with
    an environment map, the scene, whose emitters are read from ``packed``
    when given) and the module's ``TILE``. Raises
    ``ValueError`` where the JAX kernel does: NEE with the throughput
    estimator, an environment with it, exact env + analytic emitters under
    ``nee``; and for an exact map past the kernel's own limit,
    :data:`MAX_ENV_TEXELS` (the JAX kernel's is 256×512 texels).
    ``config.dof`` None counts as off (the Renderer resolves it from the
    camera's aperture). ``config.early_exit`` is accepted and changes
    nothing: the CUDA kernel's threads already leave their bounce loop when
    their path ends, and the JAX flag only skips bounces in which every
    lane of a tile is dead."""
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
    nee = bool(config.nee)
    env, env_nee, bg_external = "none", False, False
    if scene is not None and scene.envmap is not None:
        if config.env_mode == "split":
            if legacy:
                raise ValueError("env_mode='split' requires gather_mode='light_only'")
            env = "split"
            bg_external = not (config.antialias or config.dof)
            # an env-only scene renders split + nee without analytic NEE
            nee = nee and _has_emitters(scene, packed)
        else:
            h, w = scene.envmap.shape
            if h * w > MAX_ENV_TEXELS:
                raise ValueError(
                    f"env_mode='exact': the kernel indexes the map's texels with 32-bit "
                    f"offsets, at most MAX_ENV_TEXELS={MAX_ENV_TEXELS} texels (got {h}x{w})"
                )
            env_nee = wants_env_nee(scene, config, packed)
            if legacy:
                raise ValueError(
                    "env_mode='exact' (in-kernel) requires gather_mode='light_only' "
                    "and excludes env_mode='split'"
                )
            env, nee = "exact", False
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
        nee=nee,
        env=env,
        env_nee=env_nee,
        bg_external=bg_external,
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


# the JAX kernel's polynomial atan2 (`megakernel.py:76-109`): a degree-9
# fit of atan(t)/t in t² with the octant reduction, not the library atan2
_ATAN_C = (
    0.9999999930825906, -0.33333254080432473, 0.199977505037471,
    -0.14257992653960597, 0.1092607635073435, -0.08340029963538047,
    0.05703403618375145, -0.030384225558022983, 0.010544175519843985,
    -0.0017213223616973183,
)


def _patan2(y, x):
    """The JAX kernel's ``_patan2``: atan2 from the polynomial, (0, 0) → 0."""
    ax = torch.abs(x)
    ay = torch.abs(y)
    swap = ay > ax
    num = torch.where(swap, ax, ay)
    den = torch.clamp_min(torch.where(swap, ay, ax), 1e-30)
    t = num / den
    sq = t * t
    p = torch.full_like(t, _ATAN_C[-1])
    for c in _ATAN_C[-2::-1]:
        p = p * sq + c
    r = p * t
    r = torch.where(swap, (_PI * 0.5) - r, r)
    r = torch.where(x < 0, _PI - r, r)
    return torch.where(y < 0, -r, r)


def _pacos(x):
    """The JAX kernel's ``_pacos``: acos through :func:`_patan2`."""
    return _patan2(torch.sqrt(torch.clamp_min((1.0 - x) * (1.0 + x), 0.0)), x)


def _env_uv(dx, dy, dz):
    u = 0.5 + _patan2(dx, -dz) * (1.0 / (2.0 * _PI))
    v = _pacos(torch.clamp(dy, -1.0, 1.0)) * (1.0 / _PI)
    return u, v


def _env_lookup(env: EnvTables, dx, dy, dz):
    """Bilinear radiance at escape, as the JAX kernel's ``env_lookup`` (K3):
    wrap in azimuth, clamp at the poles, per-texel weights summed as its
    one-hot rows sum them (at the pole clamp ``y0 == y1`` the row weight is
    ``(1-ty)+ty``), then two-term sums: ``P[y0]·wy0 + P[y1]·wy1`` per column,
    ``wx0·col0 + wx1·col1``. It reads the map's own planes
    (``envmap.img`` × ``strength``), not the kernel's texels."""
    h, w = env.height, env.width
    u, v = _env_uv(dx, dy, dz)
    fx = u * w - 0.5
    fy = v * h - 0.5
    x0 = torch.floor(fx)
    y0 = torch.floor(fy)
    tx = fx - x0
    ty = fy - y0
    x0i = x0.to(torch.int64)
    x0i = torch.where(x0i < 0, w - 1, torch.clamp_max(x0i, w - 1))
    x1i = torch.where(x0i + 1 > w - 1, 0, x0i + 1)
    y0i = torch.clamp(y0.to(torch.int64), 0, h - 1)
    y1i = torch.clamp_max(y0i + 1, h - 1)
    same_y = y0i == y1i
    same_x = x0i == x1i
    wy0 = torch.where(same_y, (1.0 - ty) + ty, 1.0 - ty)
    wx0 = torch.where(same_x, (1.0 - tx) + tx, 1.0 - tx)
    rad = (env.envmap.img * env.envmap.strength).reshape(h, w, 3)
    out = []
    for c in range(3):
        plane = rad[..., c]

        def column(xi):
            top = plane[y0i, xi] * wy0
            return torch.where(same_y, top, top + plane[y1i, xi] * ty)

        left = wx0 * column(x0i)
        out.append(torch.where(same_x, left, left + tx * column(x1i)))
    return out


def _env_pdf_lookup(env: EnvTables, dx, dy, dz):
    """The sampler's pdf of the escape direction, nearest texel without the
    −0.5 offset (the JAX kernel's ``env_pdf_lookup``, K4's MIS partner)."""
    h, w = env.height, env.width
    u, v = _env_uv(dx, dy, dz)
    xi = torch.clamp((u * w).to(torch.int64), 0, w - 1)
    yi = torch.clamp((v * h).to(torch.int64), 0, h - 1)
    return env.envmap.pdf.reshape(-1)[yi * w + xi]


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


def _trace_batch(packed, opts, seed, its, px: _Pixels, primary, stats=None, env_rows=None):
    """Radiance of one batch of samples (its: [S, 1] or [S, N]): the three
    [S, N] path sums, and with an exact environment the three [S, N]
    escape terms, which the kernel adds to its sum after the path's
    radiance (``acc + rad + env``, as the JAX ``accumulate``). ``env_rows``
    are env NEE's shared rows for these iterations (:func:`build_env_nee_rows`
    from ``px.iter_base``). With ``stats``, adds the work the CUDA kernel's
    threads do for these samples: nearest-hit traces ('isect'), scatters
    ('scatter'), analytic-light shadow rays ('shadow'), env NEE shadow
    rays ('env_shadow'), sun shadow rays ('sun_shadow'), SH-9 sky
    evaluations ('sh'), escape lookups ('env_lookup') and the escape's pdf
    lookups under env NEE ('env_pdf'), as 0-d tensors; and per path, the
    bounce-loop iterations it entered ('path_steps') and those of them that
    reached the draws, past the miss and emitter exits ('path_draws'), as
    lists of int32 [S, N] tensors, one per batch (:func:`path_lengths`);
    where the variant casts visibility rays, per path the depths d at which
    it casts a light, env or sun ray (bit d of int64 [S, N] tensors
    'path_light', 'path_env', 'path_sun') and its sun rays ('path_sun_rays',
    int32), one per batch (:func:`path_visibility`)."""
    mat_cols = torch.as_tensor(
        packed.mats.reshape(-1, _MF).T.copy(), device=px.pid.device
    )  # [10, M]
    shape = torch.broadcast_shapes(its.shape, px.pid.shape)
    seed_u = seed & MASK32
    prng = HashPrng(px.lane)
    lights = packed.lights if opts.nee else None
    light_rows = list(_light_rows(lights)) if lights is not None else []
    n_lights = len(light_rows)
    env = packed.env
    if opts.env != "none" and (env is None or env.mode != opts.env):
        raise ValueError(f"env_mode {opts.env!r}: the packed scene carries no such tables")
    exact = opts.env == "exact"
    carry_pdf = lights is not None or opts.env_nee
    suns = []
    if opts.env == "split":
        # f32 scalars, so the shadow ray's object-space direction is f32 math
        suns = [tuple(torch.tensor(float(v), dtype=torch.float32, device=px.pid.device)
                      for v in row) for row in env.suns]

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
    steps = torch.zeros(shape, dtype=torch.int32, device=px.pid.device)
    draws = torch.zeros(shape, dtype=torch.int32, device=px.pid.device)
    vis = {}
    if stats is not None:
        kinds = [k for k, on in (("path_light", lights is not None), ("path_env", opts.env_nee),
                                 ("path_sun", bool(suns))) if on]
        vis = {k: torch.zeros(shape, dtype=torch.int64, device=px.pid.device) for k in kinds}
        if suns:
            vis["path_sun_rays"] = torch.zeros(shape, dtype=torch.int32, device=px.pid.device)
    if exact:
        # deferred escape: throughput, direction and lobe pdf at the escape
        # (never-escaped samples keep weight 0 and a valid direction)
        e_wr = torch.zeros(shape, **f32)
        e_wg = torch.zeros(shape, **f32)
        e_wb = torch.zeros(shape, **f32)
        e_dx = torch.zeros(shape, **f32)
        e_dy = torch.ones(shape, **f32)
        e_dz = torch.zeros(shape, **f32)
        e_pp = torch.full(shape, -1.0, **f32)

    for depth in range(opts.trace_depth):
        steps += alive
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
        if exact:
            esc = missed & alive
            _count(stats, "env_lookup", esc)
            e_wr = torch.where(esc, cr, e_wr)
            e_wg = torch.where(esc, cg, e_wg)
            e_wb = torch.where(esc, cb, e_wb)
            e_dx = torch.where(esc, dx, e_dx)
            e_dy = torch.where(esc, dy, e_dy)
            e_dz = torch.where(esc, dz, e_dz)
            if opts.env_nee:
                _count(stats, "env_pdf", esc & (prev_pdf >= 0.0))
                e_pp = torch.where(esc, prev_pdf, e_pp)
        elif opts.env == "split":
            # SH-9 residual sky, clamped at 0; with the background composited
            # outside, depth-0 misses add nothing here
            if not (opts.bg_external and depth == 0):
                esc = missed & alive
                _count(stats, "sh", esc)
                s3 = envmap_ops.sh9_eval(env.sh_coeffs, dx, dy, dz)
                rad_r = torch.where(esc, rad_r + cr * torch.clamp_min(s3[0], 0.0), rad_r)
                rad_g = torch.where(esc, rad_g + cg * torch.clamp_min(s3[1], 0.0), rad_g)
                rad_b = torch.where(esc, rad_b + cb * torch.clamp_min(s3[2], 0.0), rad_b)
        elif opts.legacy:
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
        draws += act

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
            if vis:
                vis["path_light"] |= shadow.to(torch.int64) << depth
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

        base = act & ~glass if glass is not None else act
        if opts.env_nee:
            # environment light at this vertex: the (iteration, depth) row's
            # shared alias-sampled direction, a shadow ray to 1e7 and the
            # balance heuristic against the diffuse lobe
            erow = env_rows[(its - px.iter_base) * opts.trace_depth + depth]
            ewx, ewy, ewz = erow[..., 0], erow[..., 1], erow[..., 2]
            e_pdf = erow[..., 6]
            ecos = nx * ewx + ny * ewy + nz * ewz
            _count(stats, "env_shadow", base & (ecos > 0.0))
            if vis:
                vis["path_env"] |= (base & (ecos > 0.0)).to(torch.int64) << depth
            evis = ~_occluded_any(packed, hx, hy, hz, ewx, ewy, ewz, 1e7)
            ediff = 1.0 - m_refl
            e_pb = ediff * torch.clamp_min(ecos, 0.0) * _INV_PI_F32
            e_w = e_pdf / torch.clamp_min(e_pdf + e_pb, 1e-20)
            e_k = (
                ediff * _INV_PI_F32 * torch.clamp_min(ecos, 0.0)
                / torch.clamp_min(e_pdf, 1e-20) * e_w
            )
            eadd = base & (ecos > 0.0) & evis
            rad_r = torch.where(eadd, rad_r + cr * m_cr * e_k * erow[..., 3], rad_r)
            rad_g = torch.where(eadd, rad_g + cg * m_cg * e_k * erow[..., 4], rad_g)
            rad_b = torch.where(eadd, rad_b + cb * m_cb * e_k * erow[..., 5], rad_b)

        if carry_pdf:
            # pdf of the lobe that generated the extension ray, for the next
            # emissive hit's (or escape's) MIS weight; delta lobes carry −1
            cos_new = torch.clamp_min(ndx * nx + ndy * ny + ndz * nz, 0.0)
            diffuse_ext = act & ~spec
            if glass is not None:
                diffuse_ext = diffuse_ext & ~glass
            prev_pdf = torch.where(
                diffuse_ext, (1.0 - m_refl) * cos_new * _INV_PI_F32, -1.0
            )

        for sd0, sd1, sd2, ser, seg, seb in suns:
            # a delta sun at the diffuse lobe: one shadow ray, no draw, no MIS
            cos_sun = nx * sd0 + ny * sd1 + nz * sd2
            _count(stats, "sun_shadow", base & (cos_sun > 0.0))
            if vis:
                vis["path_sun"] |= (base & (cos_sun > 0.0)).to(torch.int64) << depth
                vis["path_sun_rays"] += (base & (cos_sun > 0.0)).to(torch.int32)
            sun_vis = ~_occluded_any(packed, hx, hy, hz, sd0, sd1, sd2, 1e7)
            sun_add = base & (cos_sun > 0.0) & sun_vis
            k_sun = (1.0 - m_refl) * _INV_PI_F32 * torch.clamp_min(cos_sun, 0.0)
            rad_r = torch.where(sun_add, rad_r + cr * m_cr * k_sun * ser, rad_r)
            rad_g = torch.where(sun_add, rad_g + cg * m_cg * k_sun * seg, rad_g)
            rad_b = torch.where(sun_add, rad_b + cb * m_cb * k_sun * seb, rad_b)

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
    if stats is not None:
        stats.setdefault("path_steps", []).append(steps)
        stats.setdefault("path_draws", []).append(draws)
        for key, v in vis.items():
            stats.setdefault(key, []).append(v)
    if opts.legacy:  # every path's terminal throughput, as `pathtrace.cu:439-444`
        return (cr, cg, cb)
    if not exact:
        return (rad_r, rad_g, rad_b)
    # settle the deferred escape: one lookup per sample (never-escaped
    # samples add weight 0 times a valid lookup)
    er, eg, eb = _env_lookup(env, e_dx, e_dy, e_dz)
    terms = [e_wr * er, e_wg * eg, e_wb * eb]
    if opts.env_nee:
        # balance heuristic against env NEE (prev_pdf < 0: primary, specular
        # or glass escape, weight 1); the JAX kernel takes its approximate
        # reciprocal here, the port an exact one
        pe = _env_pdf_lookup(env, e_dx, e_dy, e_dz)
        wmis = torch.where(e_pp < 0.0, 1.0, e_pp * (1.0 / torch.clamp_min(e_pp + pe, 1e-20)))
        terms = [t * wmis for t in terms]
    return (rad_r, rad_g, rad_b, *terms)


def _render_reference(packed, opts, seed, px: _Pixels, num_samples, stats=None,
                      env_rows=None):
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
    if opts.env_nee and env_rows is None:
        env_rows = build_env_nee_rows(
            packed.env.envmap, seed, base, num_samples, opts.trace_depth
        ).to(dev)
    acc = [torch.zeros(n, dtype=torch.float32, device=dev) for _ in range(3)]
    group = max(1, min(num_samples, _REFERENCE_BATCH // max(n, 1)))
    for start in range(0, num_samples, group):
        stop = min(num_samples, start + group)
        its = base + torch.arange(start, stop, dtype=torch.int64, device=dev)[:, None]
        rad = _trace_batch(packed, opts, seed, its, px, primary, stats, env_rows)
        for s in range(stop - start):
            for c in range(len(rad)):  # the path's radiance, then the escape term
                acc[c % 3] = acc[c % 3] + rad[c][s]
    return torch.stack(acc, dim=-1)


def render_samples_reference(
    pixel_ids: torch.Tensor,
    packed: PackedScene,
    opts: KernelOptions,
    seed: int,
    iter_base: int,
    num_samples: int,
    stats: Optional[dict] = None,
    env_rows: Optional[torch.Tensor] = None,
    tile_base: int = 0,
) -> torch.Tensor:
    """Plain PyTorch version of the kernel over the flat pixel array.

    ``pixel_ids`` [N] int64 are the global pixel ids ``py·W + px`` of the
    rendered pixels, in order; pixel i of the array draws its hash stream as
    lane ``i % tile`` of tile ``tile_base + i // tile``. Returns the [N, 3]
    f32 radiance sum over iterations ``iter_base .. iter_base+num_samples-1``,
    accumulated in ascending iteration order. ``stats``, if given, receives
    the work counts of :func:`_trace_batch`. Env NEE's rows for these
    iterations are built here unless ``env_rows`` holds them."""
    p = u32(pixel_ids)
    pos = torch.arange(p.shape[0], dtype=torch.int64, device=p.device)
    px = _Pixels(
        pid=p,
        fx=(p % packed.width).to(torch.float32),
        fy=(p // packed.width).to(torch.float32),
        lane=pos % opts.tile,
        tile_id=int(tile_base) + pos // opts.tile,
        iter_base=int(iter_base),
    )
    return _render_reference(packed, opts, seed, px, num_samples, stats, env_rows)


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


def path_lengths(stats: dict) -> Tuple[np.ndarray, np.ndarray]:
    """The per-path counts of :func:`_trace_batch`'s ``stats`` as two int64
    [S, N] arrays: bounce-loop iterations entered, and those of them that
    reached the draws."""
    return tuple(
        torch.cat(stats[key], dim=0).cpu().numpy().astype(np.int64)
        for key in ("path_steps", "path_draws")
    )


def path_visibility(stats: dict) -> Optional[dict]:
    """The per-path visibility rays of :func:`_trace_batch`'s ``stats`` as
    int64 [S, N] arrays: the depths at which each path casts a light, env or
    sun ray (bit d; keys 'light', 'env', 'sun', zeros where the variant casts
    none) and its sun rays ('sun_rays'); None for a variant without
    visibility rays."""
    keys = ("path_light", "path_env", "path_sun", "path_sun_rays")
    if not any(k in stats for k in keys):
        return None
    shape = torch.cat(stats["path_steps"], dim=0).shape
    return {
        k[5:]: (torch.cat(stats[k], dim=0).cpu().numpy().astype(np.int64) if k in stats
                else np.zeros(shape, np.int64))
        for k in keys
    }


def schedule_args(opts: KernelOptions, tiles: bool = False) -> dict:
    """The kernel options :func:`warp_schedule` reads: the Sobol depths,
    whether the primary hit is hoisted, and how many lanes start a sample
    together (12 under an environment map over the full frame, else each at
    once)."""
    return dict(use_ld=opts.use_ld, n_ld=opts.n_ld, hoisted=not (opts.antialias or opts.dof),
                batch=12 if opts.env != "none" and not tiles else 1)


def warp_schedule(
    steps: np.ndarray,
    draws: np.ndarray,
    schedule: str = "regen",
    use_ld: bool = False,
    n_ld: int = 0,
    hoisted: bool = False,
    batch: int = 1,
    warps: Optional[int] = None,
    owners: Optional[np.ndarray] = None,
    vis: Optional[dict] = None,
    group: Optional[int] = None,
    width: Optional[int] = None,
    pixel_offset: int = 0,
) -> dict:
    """Emulate the kernel's warps on the plain version's path lengths
    (:func:`path_lengths`; ``steps``/``draws`` [S, N] by sample and by the
    kernel's pixel index) and return the counting build's counts (:data:`WORK`)
    with their SIMT efficiency, and how the pixels were served.

    ``schedule="thread"`` is a thread per pixel rendering its samples in
    series, a warp per 32 consecutive pixels: every lane of a warp is at the
    same sample and depth, so a sample costs the warp its longest path and
    both draw branches never run in one iteration. ``schedule="regen"`` is
    path regeneration over the pixel queue: a persistent warp whose lanes
    each take one step of their own path per iteration, start their pixel's
    next sample when a path ends and take the next pixel of the warp's chunk
    of 32 (in lane order; one more chunk from the queue when it runs out)
    when their pixel's samples are done. With the primary hit ``hoisted``, a
    pixel whose first path ends at its first vertex before any draw (a miss
    or an emitter) ends so in every sample: its lane settles them all at
    once and takes its next pixel. Lanes whose next sample (or first, on a
    new pixel) is pending start it together once ``batch`` of them wait or
    no lane of the warp is inside a path. ``owners`` [ceil(N/32)] is the warp
    that took each chunk (the counting build records it); without it,
    ``warps`` warps step in lockstep and take chunks in warp order.

    ``vis`` (:func:`path_visibility`) are the paths' visibility rays. Env
    rays are traced in the iteration of the vertex that casts them; sun rays
    cast at a path's vertex d ride in the lane's next loop iteration, in the
    trace of the ray leaving that vertex, and those cast at the path's last
    vertex (trace depth reached) take one more iteration of their own before
    the sample settles (``added``). Light rays join their warp's queue at
    the end of the iteration that casts them, in lane order, after the
    iteration's samples have settled; while 32 or more are pending the warp
    tests the 32 oldest in one pass, a ray a lane, and the warp tests what
    is left in one last pass once it holds no pixel (``light_exit_passes``).
    A ray tested after its lane has written out its pixel (settled every
    sample and handed the lane to another pixel or to none) is late
    (``light_late``): its term lands in the kernel's output, not in the
    lane's sum. ``group`` below S is a tile dispatch whose queue items are
    (pixel, ``group`` samples) pairs (see :func:`tile_group`): the warps
    serve items as pixels of ``group`` samples, and each sample settles
    into a unit of its own, so a light ray is late once its sample has
    settled. The visibility counters (warp iterations in which lanes
    cast light or env rays or test sun rays, the lanes testing sun rays,
    rays of each kind, the light passes, their lanes, the exit passes and
    the late rays) are counted there, and are 0 without ``vis``.

    Returns the counters of :data:`WORK`, ``light_pass_sizes`` (the light
    passes by the rays they test, [33]), ``warp_iters_by_warp`` (each warp's
    iterations: the last warp's against the mean is the launch's tail),
    ``efficiency``, ``added``,
    ``settle_iters`` (warp iterations in which some lane settled a sample:
    the per-sample work, such as the exact environment's escape lookup, runs
    in each of them), ``repeated`` (samples settled with an earlier one's
    path, each one loop iteration of the plain version), and per pixel the
    lane that served it (``lane_of``, warp·32 + lane), the number of times
    it was served (``visits``), its samples settled (``samples``) and
    whether every pixel's samples settled in ascending order
    (``in_order``). With the frame's ``width`` (items in the kernel's pixel
    order, row-major, from global pixel ``pixel_offset`` for a launch over a
    slice of the frame), ``spread`` is how far apart a warp's pixels lie: the
    mean, over the warp iterations with an active lane, of the bounding box
    of the pixels its lanes hold, as (columns, rows), and ``spread_area`` the
    mean of its area (a thread per pixel: 32 x 1 where 32 divides the
    width); None without ``width``."""
    steps = np.asarray(steps, np.int64)
    draws = np.asarray(draws, np.int64)
    sample_units = group is not None and group < steps.shape[0]
    if sample_units:
        steps, draws = item_paths(group, steps, draws)
        if vis is not None:
            vis = dict(zip(vis, item_paths(group, *(np.asarray(v) for v in vis.values()))))
    num_samples, n = steps.shape
    zero_vis = dict.fromkeys(WORK[3:], 0)
    if width is not None and width < 1:
        raise ValueError(f"width must be positive, got {width}")
    if schedule == "thread":
        pad = (-n) % 32
        per_warp = np.pad(steps, ((0, 0), (0, pad))).reshape(num_samples, -1, 32)
        iters = int(per_warp.max(axis=2).sum())
        lanes = int(steps.sum())
        by_warp = per_warp.max(axis=2).sum(axis=0)
        spread = area = None
        if width is not None:
            # a warp holds its 32 consecutive pixels throughout
            first = pixel_offset + np.arange(0, n, 32)
            last = np.minimum(first + 31, pixel_offset + n - 1)
            rows = last // width - first // width + 1
            cols = np.where(rows == 1, last - first + 1, width)
            w = by_warp / max(iters, 1)
            spread = (float((cols * w).sum()), float((rows * w).sum()))
            area = float((cols * rows * w).sum())
        return dict(
            warp_iters=iters, lane_iters=lanes, both_draws=0, **zero_vis, added=0,
            settle_iters=num_samples * per_warp.shape[1], repeated=0,
            light_pass_sizes=np.zeros(33, np.int64),
            warp_iters_by_warp=by_warp,
            efficiency=lanes / (32 * iters) if iters else 1.0,
            lane_of=np.arange(n), visits=np.ones(n, np.int64),
            samples=np.full(n, num_samples, np.int64), in_order=True,
            spread=spread, spread_area=area,
        )
    if schedule != "regen":
        raise ValueError(f"unknown schedule {schedule!r}")
    chunks = (n + 31) // 32
    if owners is not None:
        owners = np.asarray(owners, np.int64)
        if owners.shape != (chunks,) or owners.min(initial=0) < 0:
            raise ValueError(f"owners must be [{chunks}] warp ids")
        warps = int(owners.max(initial=-1)) + 1
        order = np.argsort(owners, kind="stable")  # each warp's chunks, ascending
        first = np.searchsorted(owners[order], np.arange(warps))
        last = np.searchsorted(owners[order], np.arange(warps), side="right")
    elif warps is None or warps < 1:
        raise ValueError("the regen schedule needs warps or owners")
    length = steps.T.copy()  # [N, S]
    drawn = draws.T.copy()
    counts = dict(zero_vis)
    if vis is not None:
        masks = {k: np.asarray(vis[k], np.int64).T for k in ("light", "env", "sun")}
        # a path whose last vertex cast sun rays traces them in one more
        # iteration
        extra = (masks["sun"] >> np.maximum(length - 1, 0)) & 1
        length = length + extra
        # one light and one env ray at most per vertex
        for kind in ("light", "env"):
            counts[f"{kind}_rays"] = sum(int(((masks[kind] >> b) & 1).sum())
                                         for b in range(int(steps.max(initial=0))))
        counts["sun_rays"] = int(np.asarray(vis["sun_rays"]).sum())
    # each warp's queue of pending light rays: a ring of 64 (pixel, lane)
    # entries, oldest at head
    q_pix = np.zeros((warps, QUEUE_SLOTS), np.int64)
    q_lane = np.zeros((warps, QUEUE_SLOTS), np.int64)
    q_head = np.zeros(warps, np.int64)
    q_count = np.zeros(warps, np.int64)
    exited = np.zeros(warps, bool)
    pass_sizes = np.zeros(33, np.int64)
    pix = np.full((warps, 32), -1, np.int64)
    pend = np.zeros((warps, 32), bool)
    smp = np.zeros((warps, 32), np.int64)
    dep = np.zeros((warps, 32), np.int64)
    q_next = np.zeros(warps, np.int64)
    q_end = np.zeros(warps, np.int64)
    drained = np.zeros(warps, bool)
    lane_of = np.full(n, -1, np.int64)
    visits = np.zeros(n, np.int64)
    settled = np.zeros(n, np.int64)
    in_order = True
    counter = 0
    rows = np.arange(warps)[:, None]
    gid = rows * 32 + np.arange(32)[None, :]

    def refill():
        nonlocal counter
        need = (pix < 0) & ~drained[:, None]
        n_need = need.sum(axis=1)
        take = np.minimum(n_need, q_end - q_next)
        fetch = (n_need > take) & ~drained
        if owners is not None:
            nxt = first + 0
            base = np.where(nxt < last, order[np.minimum(nxt, len(order) - 1)] * 32, n)
            first[fetch] += 1
        else:
            rank = np.cumsum(fetch) - 1
            base = counter + 32 * rank
            counter += 32 * int(fetch.sum())
        got = fetch & (base < n)
        drained[fetch & ~got] = True
        end = np.minimum(base + 32, n)
        r = np.cumsum(need, axis=1) - 1
        old = need & (r < take[:, None])
        new = need & ~old & got[:, None] & (r - take[:, None] < (end - base)[:, None])
        assigned = np.where(old, q_next[:, None] + r, base[:, None] + r - take[:, None])
        mask = old | new
        pix[mask] = assigned[mask]
        pend[mask] = True
        smp[mask] = 0
        dep[mask] = 0
        lane_of[pix[mask]] = gid[mask]
        visits[pix[mask]] += 1
        q_next[:] = np.where(got, base + np.minimum(n_need - take, end - base), q_next + take)
        q_end[:] = np.where(got, end, q_end)

    def unit_of():
        """Where each lane's terms go: its pixel, or with sample_units its
        sample's unit (-1 without a pixel)."""
        if sample_units:
            return np.where(pix >= 0, pix * num_samples + smp, -1)
        return pix.copy()

    iters = lanes = both = settles = repeated = 0
    box = np.zeros(3)  # the held pixels' bounding boxes: columns, rows, area
    warp_busy = np.zeros(warps, np.int64)
    refill()
    while True:
        held = pix >= 0
        if not held.any():
            break
        waiting = held & pend
        go = (waiting.sum(axis=1) >= batch) | ~(held & ~pend).any(axis=1)
        act = held & (~pend | go[:, None])
        pend &= ~act
        busy = act.any(axis=1)
        iters += int(busy.sum())
        warp_busy += busy
        if width is not None:
            r, c = (pix + pixel_offset) // width, (pix + pixel_offset) % width
            big = np.iinfo(np.int64).max
            rows = (np.where(held, r, -1).max(axis=1) - np.where(held, r, big).min(axis=1) + 1)
            cols = (np.where(held, c, -1).max(axis=1) - np.where(held, c, big).min(axis=1) + 1)
            box += [cols[busy].sum(), rows[busy].sum(), (cols * rows)[busy].sum()]
        lanes += int(act.sum())
        p, sm, d = pix[act], smp[act], dep[act]
        cast = np.zeros((warps, 32), bool)
        cast_pix = unit_of()
        if vis is not None:
            # the light and env rays that the lane's vertex casts now, the
            # sun rays that its previous vertex cast
            for kind, m in masks.items():
                bit = np.maximum(d - 1, 0) if kind == "sun" else d
                carry = np.zeros((warps, 32), bool)
                carry[act] = (((m[p, sm] >> bit) & 1) == 1) & ((d >= 1) | (kind != "sun"))
                counts[f"{kind}_warps"] += int(carry.any(axis=1).sum())
                if kind == "sun":
                    counts["sun_lanes"] += int(carry.sum())
                if kind == "light":
                    cast = carry
        if use_ld:
            reach = np.zeros((warps, 32), bool)
            reach[act] = d < drawn[p, sm]
            ld = np.zeros((warps, 32), bool)
            ld[act] = d < n_ld
            both += int((((reach & ld).any(axis=1)) & ((reach & ~ld).any(axis=1))).sum())
        dep[act] += 1
        done = np.zeros((warps, 32), bool)
        done[act] = dep[act] == length[p, sm]
        if done.any():
            settles += int(done.any(axis=1).sum())
            dp, ds = pix[done], smp[done]
            in_order = in_order and bool((settled[dp] == ds).all())
            settled[dp] += 1
            smp[done] += 1
            dep[done] = 0
            pend |= done
            if hoisted:
                # a first path that ended at its first vertex before any draw
                # repeats in every later sample, settled at once
                rep = np.zeros((warps, 32), bool)
                rep[done] = (length[dp, ds] == 1) & (drawn[dp, ds] == 0)
                rest = np.where(rep, num_samples - smp, 0)
                repeated += int(rest.sum())
                settled[pix[rep]] += rest[rep]
                smp[rep] = num_samples
            fin = done & (smp == num_samples)
            pix[fin] = -1
        if cast.any():
            # the iteration's light rays join the queue in lane order; then
            # the 32 oldest are tested if that many are pending
            slot = (q_head + q_count)[:, None] + np.cumsum(cast, axis=1) - 1
            w_idx, lane_idx = np.nonzero(cast)
            s_idx = slot[cast] % QUEUE_SLOTS
            q_pix[w_idx, s_idx] = cast_pix[cast]
            q_lane[w_idx, s_idx] = lane_idx
            q_count += cast.sum(axis=1)
            full = q_count >= 32
            if full.any():
                wf = np.nonzero(full)[0]
                slots = (q_head[wf, None] + np.arange(32)[None, :]) % QUEUE_SLOTS
                lane = q_lane[wf[:, None], slots]
                held = unit_of()[wf[:, None], lane] == q_pix[wf[:, None], slots]
                counts["light_passes"] += len(wf)
                counts["light_pass_lanes"] += 32 * len(wf)
                pass_sizes[32] += len(wf)
                counts["light_late"] += int((~held).sum())
                q_head[wf] = (q_head[wf] + 32) % QUEUE_SLOTS
                q_count[wf] -= 32
        refill()
        # a warp left without a pixel tests its pending light rays, all late,
        # in one last pass before it exits
        leaving = ~(pix >= 0).any(axis=1) & ~exited & (q_count > 0)
        counts["light_passes"] += int(leaving.sum())
        counts["light_exit_passes"] += int(leaving.sum())
        counts["light_pass_lanes"] += int(q_count[leaving].sum())
        counts["light_late"] += int(q_count[leaving].sum())
        np.add.at(pass_sizes, q_count[leaving], 1)
        q_count[leaving] = 0
        exited |= ~(pix >= 0).any(axis=1)
    return dict(
        warp_iters=iters, lane_iters=lanes, both_draws=both, **counts,
        added=int(extra.sum()) if vis is not None else 0, settle_iters=settles,
        repeated=repeated, light_pass_sizes=pass_sizes, warp_iters_by_warp=warp_busy,
        efficiency=lanes / (32 * iters) if iters else 1.0,
        lane_of=lane_of, visits=visits, samples=settled, in_order=in_order,
        spread=(float(box[0] / iters), float(box[1] / iters)) if width and iters else None,
        spread_area=float(box[2] / iters) if width and iters else None,
    )


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
        self.counts = "-DPT_MEGA_COUNT" in self.flags
        self.launches = 0
        self.launches_by_variant: dict = {}
        # launches of the row kernel (env_rows), counted apart
        self.row_launches = 0
        self._lib: Optional[ctypes.CDLL] = None
        # the pixel queue's counter, one per (device, stream): a launch zeroes
        # it on its stream first, so launches on one stream reuse it in turn
        # and launches on two streams never share one
        self._queues: dict = {}

    def reset_counts(self) -> None:
        self.launches = 0
        self.launches_by_variant = {}
        self.row_launches = 0

    def _fn(self):
        if self._lib is None:
            lib = load(self.name, self.flags)
            fn = lib.pt_megakernel_launch
            fn.restype = ctypes.c_int
            i, p, f = ctypes.c_int, ctypes.c_void_p, ctypes.c_float
            fn.argtypes = [
                p, i, i, i, i, i, i, i, i, i, i, i, i, i, i, f,  # output, frame, slice, sampling
                i, i, i, i,  # nee, refraction, dof, legacy
                p, p, p, p, p, i, i, i,  # scene tables
                p, p, i,  # light table
                p, p, p, i, i, p,  # tile dispatch: tables, count, item samples, units
                i, p, p, i, i,  # environment: mode, texels, NEE rows, h, w
                p, i, p, i,  # split: suns, count, SH, background outside
                p, p, p,  # pixel queue; work counters and chunk owners (counting build)
                p,  # stream
            ]
            occupancy = lib.pt_megakernel_blocks_per_sm
            occupancy.restype = ctypes.c_int
            occupancy.argtypes = [i, i]
            rows = lib.pt_env_rows_launch
            rows.restype = ctypes.c_int
            rows.argtypes = [p, i, i, i, i, p, p, p, p, p, i, i, p, p, i, i, p]
            self._lib = lib
        return self._lib.pt_megakernel_launch

    def env_rows(self, packed: PackedScene, seed: int, iter_base: int, num_samples: int,
                 trace_depth: int) -> torch.Tensor:
        """Env NEE's rows with their per-geom table (:func:`env_nee_rows`),
        [S·D, 8 + 6·num_geoms], from one launch of the row kernel
        ``pt_env_rows`` on the current stream of the map's CUDA device
        (counted in ``row_launches``)."""
        env = packed.env
        if env is None or env.mode != "exact":
            raise ValueError("env NEE rows need the packed scene's exact environment tables")
        em = env.envmap
        device = em.device
        if device.type != "cuda":
            raise ValueError(f"the row kernel needs a CUDA device, got {device}")
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        tabs = (em.img, em.alias_prob, em.alias_idx, em.pdf, em.strength)
        for t, dtype in zip(tabs, (torch.float32,) * 2 + (torch.int32,) + (torch.float32,) * 2):
            if t.device != device or t.dtype != dtype or not t.is_contiguous():
                raise ValueError(f"the map's tables must be contiguous tensors on {device}")
        h, w = env.height, env.width
        if packed.num_geoms > MAX_GEOMS:
            raise ValueError(f"scene has {packed.num_geoms} geoms; the kernel's tables hold "
                             f"{MAX_GEOMS}")
        self._fn()
        out = torch.empty((num_samples * trace_depth, 8 + 6 * packed.num_geoms),
                          dtype=torch.float32, device=device)
        with torch.cuda.device(device):
            stream = torch.cuda.current_stream(device).cuda_stream
            self.row_launches += 1
            err = self._lib.pt_env_rows_launch(
                out.data_ptr(), int(num_samples), int(trace_depth), int(iter_base),
                kernel_seed(seed), *(t.data_ptr() for t in tabs), h, w,
                packed.geo.ctypes.data, packed.perm.ctypes.data, packed.num_cubes,
                packed.num_geoms, stream,
            )
        if err != 0:
            raise RuntimeError(f"env NEE row kernel launch failed: CUDA error {err}")
        return out

    def blocks_per_sm(self, opts: KernelOptions, tiles: bool = False, smem: int = 0) -> int:
        """The blocks of this option set's compile-time variant that one SM
        of the current device holds at once, with ``smem`` bytes of dynamic
        shared memory (the env split mode's sun table), as the launcher sizes its
        persistent grid."""
        self._fn()
        flags = (int(opts.nee) | int(opts.refraction) << 1 | int(opts.dof) << 2
                 | int(opts.legacy) << 3 | int(tiles) << 4
                 | _ENV_MODES[(opts.env, opts.env_nee)] << 5)
        blocks = self._lib.pt_megakernel_blocks_per_sm(flags, int(smem))
        if blocks < 0:
            raise RuntimeError(f"occupancy query failed for variant {variant_name(opts, tiles)}")
        return blocks

    def __call__(
        self,
        packed: PackedScene,
        opts: KernelOptions,
        seed: int,
        iter_base: int,
        num_samples: int,
        device: torch.device,
        tiles: Optional[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]] = None,
        env_rows: Optional[torch.Tensor] = None,
        work: Optional[torch.Tensor] = None,
        owners: Optional[torch.Tensor] = None,
        group: Optional[int] = None,
        pixel_offset: int = 0,
        num_pixels: Optional[int] = None,
        tile_base: Optional[int] = None,
    ) -> torch.Tensor:
        """Launch over the pixels ``pixel_offset .. pixel_offset +
        num_pixels - 1`` of the frame (all of it by default), their hash
        tiles numbered from ``tile_base`` (default ``pixel_offset // tile``),
        or with ``tiles = (table, px, py)`` over K chosen tiles: ``table`` int32 [2K] (K tile ids, then K
        1-based iteration bases) and ``px``/``py`` f32 [K·tile], all on
        ``device``. The tile dispatch's queue items are (pixel, ``group``
        samples) pairs, ``group`` a divisor of ``num_samples`` that
        :func:`tile_group` picks unless given; below ``num_samples`` each
        sample settles into a unit of a scratch tensor, which a second
        kernel sums in sample order. Env NEE reads the shared rows of this launch's
        iterations with their per-geom table, ``env_rows`` [num_samples·
        trace_depth, 8 + 6·num_geoms] on ``device`` (:func:`env_nee_rows`),
        which this binding's row kernel builds before the launch when not
        given. The counting build (:data:`COUNTING`) takes ``work``,
        ``len(WORK)`` int64 counters it adds to, and ``owners``, int32
        [ceil(items/32)], where it writes the warp that took each chunk of 32
        queue items (pixels, or the tile dispatch's items); any other build
        raises on them."""
        device = torch.device(device)
        if device.type != "cuda":
            raise ValueError(f"the CUDA megakernel needs a CUDA device, got {device}")
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        if (work is not None) != self.counts or (owners is not None) != self.counts:
            raise ValueError("work and owners go with a -DPT_MEGA_COUNT build, and only there")
        if work is not None and (work.device != device or work.dtype != torch.int64
                                 or work.shape != (len(WORK),) or not work.is_contiguous()):
            raise ValueError(f"work must be a contiguous int64 [{len(WORK)}] tensor on {device}")
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
        n, tile_base = pixel_slice(packed, opts, pixel_offset, num_pixels, tile_base)
        table = px = py = None
        num_tiles = 0
        items = n
        if tiles is not None:
            if pixel_offset or num_pixels is not None or tile_base:
                raise ValueError("the tile dispatch takes no pixel slice")
            table, px, py = tiles
            num_tiles = table.shape[0] // 2
            n = num_tiles * opts.tile
            if group is None:
                group = tile_group(n, num_samples, device)
            if not (0 < group <= num_samples and num_samples % group == 0):
                raise ValueError(f"group {group} must divide num_samples {num_samples}")
            items = n * (num_samples // group)
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
        env = packed.env
        env_mode = _ENV_MODES[(opts.env, opts.env_nee)]
        if env_mode and (env is None or env.mode != opts.env):
            raise ValueError(f"env_mode {opts.env!r}: the packed scene carries no such tables")
        if env_mode >= 2 and tiles is not None:
            raise ValueError("the tile dispatch carries only env_mode='exact' without nee")
        tex = rows = suns = sh = None
        if env_mode in (1, 2):
            tex = env.tex
            if (tex.device != device or tex.dtype != torch.float32 or not tex.is_contiguous()
                    or tex.numel() != 4 * env.height * env.width or tex.data_ptr() % 16):
                raise ValueError(f"the map's texels must be a contiguous, 16-byte aligned f32 "
                                 f"[{4 * env.height * env.width}] tensor on {device}")
            if env_mode == 2:
                rows = env_rows
                if rows is None:
                    rows = self.env_rows(packed, seed, iter_base, num_samples, opts.trace_depth)
                shape = (num_samples * opts.trace_depth, 8 + 6 * packed.num_geoms)
                if (rows.shape != shape or rows.device != device
                        or rows.dtype != torch.float32 or not rows.is_contiguous()):
                    raise ValueError(
                        f"env NEE rows must be contiguous f32 {list(shape)} on {device} "
                        f"(env_nee_rows), got {tuple(rows.shape)} {rows.dtype} on {rows.device}"
                    )
        elif env_mode == 3:
            suns = np.ascontiguousarray(env.suns.reshape(-1), np.float32)
            sh = np.ascontiguousarray(env.sh.reshape(-1), np.float32)
        if owners is not None and (owners.device != device or owners.dtype != torch.int32
                                   or owners.shape != ((items + 31) // 32,)
                                   or not owners.is_contiguous()):
            raise ValueError(f"owners must be a contiguous int32 [{(items + 31) // 32}] tensor "
                             f"on {device}")
        fn = self._fn()
        out = torch.empty((n, 3), dtype=torch.float32, device=device)
        units = None
        if tiles is not None and group < num_samples:
            units = torch.empty((num_samples * n, 6 if env_mode == 1 else 3),
                                dtype=torch.float32, device=device)
        ptr = lambda a: None if a is None else a.ctypes.data  # noqa: E731
        dptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
        with torch.cuda.device(device):
            stream = torch.cuda.current_stream(device).cuda_stream
            queue = self._queues.get((device.index, stream))
            if queue is None:
                queue = torch.zeros(1, dtype=torch.int32, device=device)
                self._queues[(device.index, stream)] = queue
            self.launches += 1
            key = variant_name(opts, tiles is not None)
            self.launches_by_variant[key] = self.launches_by_variant.get(key, 0) + 1
            err = fn(
                out.data_ptr(), n, packed.width, packed.height,
                kernel_seed(seed), int(iter_base), int(pixel_offset), int(tile_base), opts.tile,
                int(num_samples), opts.trace_depth, opts.rr_start_depth,
                int(opts.antialias), int(opts.use_ld), opts.n_ld,
                opts.sky_strength,
                int(opts.nee), int(opts.refraction), int(opts.dof), int(opts.legacy),
                packed.cam.ctypes.data, packed.geo.ctypes.data,
                packed.mats.ctypes.data, packed.gmat.ctypes.data,
                packed.perm.ctypes.data, packed.num_cubes, packed.num_geoms,
                packed.num_materials,
                ptr(lights_f), ptr(lights_i), num_lights,
                dptr(table), dptr(px), dptr(py), num_tiles, int(group or num_samples),
                dptr(units),
                env_mode, dptr(tex), dptr(rows),
                env.height if env_mode else 0, env.width if env_mode else 0,
                ptr(suns), env.num_suns if env_mode == 3 else 0, ptr(sh),
                int(opts.bg_external),
                queue.data_ptr(), dptr(work), dptr(owners),
                stream,
            )
        if err != 0:
            raise RuntimeError(f"megakernel launch failed: CUDA error {err}")
        return out


# (opts.env, opts.env_nee) → the kernel's ENV template argument
_ENV_MODES = {("none", False): 0, ("exact", False): 1, ("exact", True): 2, ("split", False): 3}
_ENV_NAMES = ("", "env_exact", "env_nee", "env_split")


def variant_name(opts: KernelOptions, tiles: bool = False) -> str:
    """The kernel's compile-time variant for these options, as named in its
    ptxas report: the enabled features joined by '+' ('main' if none)."""
    parts = [
        name for name, on in (
            ("nee", opts.nee), ("refraction", opts.refraction), ("dof", opts.dof),
            ("throughput", opts.legacy), ("tiles", tiles),
        ) if on
    ]
    env = _ENV_NAMES[_ENV_MODES[(opts.env, opts.env_nee)]]
    return "+".join(parts + ([env] if env else [])) or "main"


KERNEL = Megakernel()
# the counting build: the same kernel, adding up its bounce loop's warp work
COUNTING = Megakernel(NVCC_FLAGS + ("-DPT_MEGA_COUNT",))
# the counting build's counters: warp iterations of the bounce loop, active
# lane-iterations in them, iterations that ran both draw branches; warp
# iterations that cast area-light or env NEE rays or test sun rays, the lanes
# that test sun rays in them, and the rays of each kind; the passes that test
# queued light rays, the rays tested in them, the last passes of warps that
# exit with fewer than 32 pending, and the rays tested after their pixel was
# written out
WORK = ("warp_iters", "lane_iters", "both_draws", "light_warps", "env_warps", "sun_warps",
        "sun_lanes", "light_rays", "env_rays", "sun_rays", "light_passes", "light_pass_lanes",
        "light_exit_passes", "light_late")
# the kernel's schedule, as warp_schedule names it
SCHEDULE = "regen"


# the queue items a resident lane of the tile dispatch should get at least:
# the launch ends when its last lane has rendered its last item, so fewer
# and longer items leave lanes idle at the end (the adaptive leg's rounds,
# 2.8 pixels of 16 samples a lane, lost 15% a pixel-sample to it on an
# NVIDIA H100 80GB HBM3 at 700 W, PERF.md)
ITEMS_PER_LANE = 8


def tile_group(pixels: int, num_samples: int, device) -> int:
    """The samples a queue item of the tile dispatch renders: all of a
    pixel's where ``pixels`` give each lane the card holds at once (the
    launch bounds' 7 blocks of 128 an SM) ITEMS_PER_LANE of them, else the
    largest divisor of ``num_samples`` whose (pixel, group) items do (down
    to one sample an item)."""
    sms = torch.cuda.get_device_properties(torch.device(device)).multi_processor_count
    lanes = sms * 7 * 128
    for groups in range(1, num_samples + 1):
        if num_samples % groups == 0 and pixels * groups >= ITEMS_PER_LANE * lanes:
            return num_samples // groups
    return 1


def item_paths(group: int, *arrays: np.ndarray) -> Tuple[np.ndarray, ...]:
    """Per-path arrays [S, N] (:func:`path_lengths`, :func:`path_visibility`)
    of a tile dispatch whose items are (pixel, ``group`` samples) pairs, as
    [group, (S/group)·N] arrays in the kernel's item order (item g·N + p:
    pixel p, samples g·group ..), for :func:`warp_schedule`."""
    out = []
    for a in arrays:
        s, n = a.shape
        out.append(a.reshape(s // group, group, n).transpose(1, 0, 2).reshape(group, -1))
    return tuple(out)


def kernel_warp_work(packed: PackedScene, opts: KernelOptions, seed: int, iter_base: int,
                     num_samples: int, device, **kwargs) -> Tuple[dict, np.ndarray]:
    """One launch of the counting build (:data:`COUNTING`, the other
    arguments as :class:`Megakernel` takes them, a tile dispatch's
    ``group`` included): its counts by :data:`WORK`, and the warp that took
    each chunk of 32 queue items (int32 [ceil(items/32)]), for
    :func:`warp_schedule`."""
    tiles = kwargs.get("tiles")
    n = pixel_slice(packed, opts, kwargs.get("pixel_offset", 0), kwargs.get("num_pixels"))[0]
    if tiles is not None:
        group = kwargs.setdefault("group", tile_group(tiles[1].shape[0], num_samples, device))
        n = tiles[1].shape[0] * (num_samples // group)
    work = torch.zeros(len(WORK), dtype=torch.int64, device=device)
    owners = torch.full(((n + 31) // 32,), -1, dtype=torch.int32, device=device)
    COUNTING(packed, opts, seed, iter_base, num_samples, device, work=work, owners=owners,
             **kwargs)
    return dict(zip(WORK, (int(v) for v in work.tolist()))), owners.cpu().numpy()


def pixel_slice(packed: PackedScene, opts: KernelOptions, pixel_offset: int = 0,
                num_pixels: Optional[int] = None, tile_base: Optional[int] = None
                ) -> Tuple[int, int]:
    """The pixel count and first hash tile of the slice of ``num_pixels``
    pixels from ``pixel_offset`` (to the frame's end by default; hash tiles
    from ``pixel_offset // tile`` by default); ValueError if it is not a
    slice of the frame."""
    frame = packed.width * packed.height
    n = frame - pixel_offset if num_pixels is None else int(num_pixels)
    if tile_base is None:
        tile_base = pixel_offset // opts.tile
    if pixel_offset < 0 or n < 0 or pixel_offset + n > frame or tile_base < 0:
        raise ValueError(f"pixels {pixel_offset} .. {pixel_offset + n - 1} (tile base "
                         f"{tile_base}) are not a slice of the {frame}-pixel frame")
    return n, int(tile_base)


def _add_background(rad: torch.Tensor, packed: PackedScene, opts: KernelOptions,
                    num_samples: int, pixel_offset: int = 0) -> torch.Tensor:
    """Split mode's exact background (the JAX ``_render_samples_impl``
    composite): ``num_samples`` times the bilinear background of each primary
    ray that misses every primitive, added outside the kernel, for the
    ``rad.shape[0]`` pixels from ``pixel_offset``."""
    if not opts.bg_external:
        return rad
    env = packed.env
    rows = slice(pixel_offset, pixel_offset + rad.shape[0])
    return rad + float(num_samples) * env.bg[rows] * env.bg_miss[rows, None]


def render_samples(
    scene,
    config,
    seed: int,
    iter_base: int,
    num_samples: int,
    packed: Optional[PackedScene] = None,
    env_rows: Optional[torch.Tensor] = None,
    pixel_offset: int = 0,
    num_pixels: Optional[int] = None,
    tile_base: Optional[int] = None,
) -> torch.Tensor:
    """Render ``num_samples`` samples of the frame in one launch, or of its
    ``num_pixels`` pixels from ``pixel_offset`` (a contiguous slice of the
    flat pixel array: the multi-device pixel tiling, ``parallel.shard``).

    Returns the [N, 3] radiance *sum* over iterations ``iter_base ..
    iter_base+num_samples-1`` (the caller adds it to its accumulator).
    Pixel i of a slice is global pixel ``pixel_offset + i`` (its LD lattice
    key and coordinates); its hash stream is lane ``i % TILE`` of tile
    ``tile_base + i // TILE``, ``tile_base`` by default
    ``pixel_offset // TILE`` (the JAX ``render_samples``).
    ``seed`` is the int32 kernel seed; the module's ``TILE`` keys the hash
    streams. ``packed`` (from ``pack_scene(scene, nee=opts.nee,
    config=config)``) saves re-reading the scene tables on every call, and
    with it the call reads nothing back from the device. ``env_rows`` are
    env NEE's rows of these iterations if the caller built them
    (:func:`env_nee_rows`, with their per-geom table; a slice of a larger
    table is fine: rows are keyed by absolute iteration). A scene
    on a CUDA device runs the CUDA kernel; a scene on the CPU runs the plain
    version. In split mode without antialiasing or lens, the exact
    background is added after the launch."""
    opts = kernel_options(config, scene, packed)
    if packed is None:
        packed = pack_scene(scene, nee=opts.nee, config=config)
    frame = packed.width * packed.height
    if opts.use_ld and frame >= 1 << 24:
        raise ValueError("sampler='sobol' supports at most 2^24 pixels")
    n, tile_base = pixel_slice(packed, opts, pixel_offset, num_pixels, tile_base)
    device = scene.device
    if device.type == "cuda":
        rad = KERNEL(packed, opts, seed, iter_base, num_samples, device, env_rows=env_rows,
                     pixel_offset=pixel_offset, num_pixels=n, tile_base=tile_base)
    elif device.type == "cpu":
        pix = pixel_offset + torch.arange(n, dtype=torch.int64, device=device)
        rad = render_samples_reference(
            pix, packed, opts, seed, iter_base, num_samples, env_rows=env_rows,
            tile_base=tile_base,
        )
    else:
        raise ValueError(f"unsupported device {device}")
    return _add_background(rad, packed, opts, num_samples, pixel_offset)


def check_tiles_env(scene, config) -> None:
    """The tile dispatch's environment limits (the JAX ``render_tiles``):
    exact mode only, without ``nee``; a map of any size the kernel takes
    (:data:`MAX_ENV_TEXELS`), where the JAX one caps it at 256×512."""
    if scene.envmap is None:
        return
    if config.env_mode == "split":
        raise ValueError(
            "render_tiles (adaptive sampling) does not carry "
            "env_mode='split' — its exact-background composite needs "
            "the full frame; use env_mode='exact' or render dense"
        )
    if config.nee:
        raise ValueError(
            "render_tiles (adaptive sampling): env NEE rows are keyed "
            "by dense absolute iterations, which per-tile bases break; "
            "render dense (render_samples) or use pipeline='fast'"
        )


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
    dispatch never reads them back to the host. Returns [K·TILE, 3]. An
    environment map renders in exact mode only (:func:`check_tiles_env`)."""
    check_tiles_env(scene, config)
    opts = kernel_options(config, scene, packed)
    if packed is None:
        packed = pack_scene(scene, nee=opts.nee, config=config)
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
