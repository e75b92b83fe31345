"""Structure-of-arrays wavefront: the fast pipeline and the triangle-mesh
pipeline.

Port of the JAX package's ``ops/fast.py``: every quantity is a flat ``[N]``
float32 tensor (x/y/z separate), the analytic primitives are tested a
batch at a time, keeping the first primitive at the least distance, which
is the JAX package's unrolled loop with a running winner
(:func:`intersect_unrolled`), the object-space direction stays unnormalized
(``t_world = s - 1e-4 / |q_d|``),
and :func:`shade_soa` is one masked shade/extend pass over the wavefront
state, with the gradient sky or an environment map, area-light NEE and
environment NEE.

:func:`trace_sample_fast` renders one sample of an analytic scene of 1 to
``MAX_UNROLL`` primitives (:func:`supports`): the fast pipeline, whose rays
stay in pixel order, so its per-bounce streams are the lane-indexed
threefry draws of ``ops/rng.py``. :func:`trace_sample_mesh` renders one
sample of a triangle-mesh scene: per bounce, the cluster-culled triangle
kernel (``ops/cuda/mesh_kernel.py``, K7; K8 for NEE's shadow rays) and the
analytic test, merged by nearest ``t``, feed :func:`shade_soa`.
The wavefront is re-sorted by (origin cell, direction octant) every
``mesh_sort_every`` bounces with dead rays last, and every random stream is
keyed by pixel id, so the sort never changes the image. In JAX both
wavefronts are XLA code outside any Pallas kernel; here they are torch
tensor code, on the card or the CPU.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import numpy as np
import torch

from . import envmap as envmap_ops
from . import rng as rng_ops

MAX_UNROLL = 64
_MISS = 1e30
_FMAX = 3.402823466e38
_PI = 3.14159265358979323846
_BACKOFF = 1e-4
_ORIGIN_OFFSET = 1e-3
_INV_PI = 0.3183098861837907


def supports(scene) -> bool:
    """The fast pipeline carries analytic scenes of 1 to ``MAX_UNROLL``
    primitives."""
    return scene.num_triangles == 0 and 0 < scene.cubes.count + scene.spheres.count <= MAX_UNROLL


class _Best(NamedTuple):
    t: torch.Tensor
    nx: torch.Tensor
    ny: torch.Tensor
    nz: torch.Tensor
    mat: torch.Tensor  # int32 material id
    miss: torch.Tensor  # bool
    outside: torch.Tensor  # bool: hit from outside the primitive (for ior)
    # original scene OBJECT index of the winner, for the NEE MIS weight
    # (lights.area_pdf_at); None where no caller needs it
    geom: Optional[torch.Tensor] = None


def _rsqrt(x):
    return 1.0 / torch.sqrt(x)


def _obj_ray(iv, ox, oy, oz, dx, dy, dz):
    """Object-space ray (direction left unnormalized). ``iv``: [..., 4, 4],
    leading dims broadcasting against the rays'."""
    qox = iv[..., 0, 0] * ox + iv[..., 0, 1] * oy + iv[..., 0, 2] * oz + iv[..., 0, 3]
    qoy = iv[..., 1, 0] * ox + iv[..., 1, 1] * oy + iv[..., 1, 2] * oz + iv[..., 1, 3]
    qoz = iv[..., 2, 0] * ox + iv[..., 2, 1] * oy + iv[..., 2, 2] * oz + iv[..., 2, 3]
    qdx = iv[..., 0, 0] * dx + iv[..., 0, 1] * dy + iv[..., 0, 2] * dz
    qdy = iv[..., 1, 0] * dx + iv[..., 1, 1] * dy + iv[..., 1, 2] * dz
    qdz = iv[..., 2, 0] * dx + iv[..., 2, 1] * dy + iv[..., 2, 2] * dz
    return qox, qoy, qoz, qdx, qdy, qdz


def _world_normal(it, nox, noy, noz):
    """invTranspose · n_obj, normalized."""
    wx = it[..., 0, 0] * nox + it[..., 0, 1] * noy + it[..., 0, 2] * noz
    wy = it[..., 1, 0] * nox + it[..., 1, 1] * noy + it[..., 1, 2] * noz
    wz = it[..., 2, 0] * nox + it[..., 2, 1] * noy + it[..., 2, 2] * noz
    r = _rsqrt(wx * wx + wy * wy + wz * wz)
    return wx * r, wy * r, wz * r


def _cube_test(iv, it, ox, oy, oz, dx, dy, dz):
    """Unit-cube slab test, reference tie-breaking (first-max / first-min).
    Returns (t_world, hit, nx, ny, nz, outside)."""
    qox, qoy, qoz, qdx, qdy, qdz = _obj_ray(iv, ox, oy, oz, dx, dy, dz)
    rinv = _rsqrt(qdx * qdx + qdy * qdy + qdz * qdz)
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
    sx = torch.where(t2x < t1x, 1.0, -1.0)
    sy = torch.where(t2y < t1y, 1.0, -1.0)
    sz = torch.where(t2z < t1z, 1.0, -1.0)
    ax = torch.where(tax > 0, tax, -_FMAX)
    ay = torch.where(tay > 0, tay, -_FMAX)
    az = torch.where(taz > 0, taz, -_FMAX)
    bx = torch.where(tbx < _FMAX, tbx, _FMAX)
    by = torch.where(tby < _FMAX, tby, _FMAX)
    bz = torch.where(tbz < _FMAX, tbz, _FMAX)
    s_min = torch.maximum(ax, torch.maximum(ay, az))
    s_max = torch.minimum(bx, torch.minimum(by, bz))
    # first-max axis for the entry face, first-min for the exit face
    min_is_x = (ax >= ay) & (ax >= az)
    min_is_y = ~min_is_x & (ay >= az)
    max_is_x = (bx <= by) & (bx <= bz)
    max_is_y = ~max_is_x & (by <= bz)
    outside = s_min > 0
    hit = (s_max >= s_min) & (s_max > 0)
    s = torch.where(outside, s_min, s_max)
    use_x = torch.where(outside, min_is_x, max_is_x)
    use_y = torch.where(outside, min_is_y, max_is_y)
    nox = torch.where(use_x, sx, 0.0)
    noy = torch.where(use_y, sy, 0.0)
    noz = torch.where(use_x | use_y, 0.0, sz)
    t_world = s - _BACKOFF * rinv
    nx, ny, nz = _world_normal(it, nox, noy, noz)
    return t_world, hit, nx, ny, nz, outside


def _sphere_test(iv, it, ox, oy, oz, dx, dy, dz):
    """Canonical r=0.5 sphere quadratic (unnormalized direction form)."""
    qox, qoy, qoz, qdx, qdy, qdz = _obj_ray(iv, ox, oy, oz, dx, dy, dz)
    a = qdx * qdx + qdy * qdy + qdz * qdz
    rinv = _rsqrt(a)
    b = qox * qdx + qoy * qdy + qoz * qdz
    c = qox * qox + qoy * qoy + qoz * qoz - 0.25
    disc = b * b - a * c
    sq = torch.sqrt(torch.clamp_min(disc, 0.0))
    inv_a = 1.0 / a
    s1 = (-b + sq) * inv_a
    s2 = (-b - sq) * inv_a
    both_neg = (s1 < 0) & (s2 < 0)
    both_pos = (s1 > 0) & (s2 > 0)
    outside = both_pos
    s = torch.where(both_pos, torch.minimum(s1, s2), torch.maximum(s1, s2))
    hit = (disc >= 0) & ~both_neg
    t_world = s - _BACKOFF * rinv
    # object-space hit point (with backoff) = q_o + t_world * q_d
    pnx = qox + t_world * qdx
    pny = qoy + t_world * qdy
    pnz = qoz + t_world * qdz
    nx, ny, nz = _world_normal(it, pnx, pny, pnz)
    flip = torch.where(outside, 1.0, -1.0)
    return t_world, hit, nx * flip, ny * flip, nz * flip, outside


def intersect_unrolled(scene, ox, oy, oz, dx, dy, dz) -> _Best:
    """Nearest hit over all analytic primitives. Each batch (cubes, then
    spheres) is tested at once as [K, N]; the winner is the first primitive
    at the least distance, which is what the JAX package's unrolled loop
    with a running winner and a strict ``t < best_t`` keeps. Every
    distance and normal is computed with the same operations in the same
    order as that loop's."""
    n = ox.shape[0]
    dev = ox.device
    ts, ns, outs, mats, geoms = [], [], [], [], []
    for batch, test in ((scene.cubes, _cube_test), (scene.spheres, _sphere_test)):
        if batch.count:
            t, hit, nx, ny, nz, outside = test(
                batch.inv_transform[:, None], batch.inv_transpose[:, None], ox, oy, oz, dx, dy, dz
            )
            ts.append(torch.where(hit & (t > 0) & (t < _MISS), t, _MISS))
            ns.append(torch.stack([nx, ny, nz]))
            outs.append(outside)
            mats.append(batch.material_id)
            geoms.append(batch.geom_index)
    if not ts:
        f32 = dict(dtype=torch.float32, device=dev)
        zero = torch.zeros((n,), **f32)
        return _Best(
            t=torch.full((n,), _MISS, **f32), nx=zero, ny=zero, nz=zero,
            mat=torch.zeros((n,), dtype=torch.int32, device=dev),
            miss=torch.ones((n,), dtype=torch.bool, device=dev),
            outside=torch.ones((n,), dtype=torch.bool, device=dev),
            geom=torch.full((n,), -1, dtype=torch.int32, device=dev),
        )
    # min over dim 0 returns the first index of equal minima
    t, k = torch.cat(ts).min(dim=0)
    miss = t >= _MISS
    normal = torch.cat(ns, dim=1).gather(1, k.expand(3, 1, n)).squeeze(1)
    normal = torch.where(miss, 0.0, normal)
    outside = torch.cat(outs).gather(0, k[None]).squeeze(0)
    return _Best(
        t=t, nx=normal[0], ny=normal[1], nz=normal[2],
        mat=torch.where(miss, 0, torch.cat(mats)[k]),
        miss=miss,
        outside=outside | miss,
        geom=torch.where(miss, -1, torch.cat(geoms)[k]),
    )


_MATERIAL_FIELDS = ("cr", "cg", "cb", "sr", "sg", "sb", "refl", "refr", "emit", "ior")


def _select_material(materials, mat_id):
    """Per-lane material fields: the rows of the packed table [M, 10]
    (color, specular color, reflectivity, refractive, emittance, ior),
    gathered by id; the JAX package selects the same values in an unrolled
    loop of selects."""
    table = torch.cat([
        materials.color, materials.specular_color, materials.reflectivity[:, None],
        materials.refractive[:, None], materials.emittance[:, None], materials.ior[:, None],
    ], dim=1)
    rows = table[mat_id.long()]
    return {k: rows[:, i] for i, k in enumerate(_MATERIAL_FIELDS)}


def _local_frame(vx, vy, vz):
    """createLocalCoordinateSystem, componentwise (`pathtrace.cu:216-223`)."""
    use_a = torch.abs(vx) > torch.abs(vy)
    tx = torch.where(use_a, vz, 0.0)
    ty = torch.where(use_a, 0.0, -vz)
    tz = torch.where(use_a, -vx, vy)
    r = _rsqrt(torch.clamp_min(tx * tx + ty * ty + tz * tz, 1e-20))
    tx, ty, tz = tx * r, ty * r, tz * r
    bx = vy * tz - vz * ty
    by = vz * tx - vx * tz
    bz = vx * ty - vy * tx
    return tx, ty, tz, bx, by, bz


def _thin_lens_soa(cam, ox, oy, oz, dx, dy, dz, u1, u2):
    """Componentwise thin-lens transform of pinhole rays: the pinhole
    direction is traced to the focal plane, the origin moves to a
    concentric lens-disk sample of radius cam.aperture in the (right, up)
    plane, and the direction re-aims at the pierce point."""
    ct = dx * cam.view[0] + dy * cam.view[1] + dz * cam.view[2]
    ft = cam.focal / torch.clamp_min(ct, 1e-6)
    fx = ox + dx * ft
    fy = oy + dy * ft
    fz = oz + dz * ft
    r = cam.aperture * torch.sqrt(u1)
    th = (2.0 * np.pi) * u2
    lx = r * torch.cos(th)
    ly = r * torch.sin(th)
    ox = ox + cam.right[0] * lx + cam.up[0] * ly
    oy = oy + cam.right[1] * lx + cam.up[1] * ly
    oz = oz + cam.right[2] * lx + cam.up[2] * ly
    ndx = fx - ox
    ndy = fy - oy
    ndz = fz - oz
    rn = _rsqrt(torch.clamp_min(ndx * ndx + ndy * ndy + ndz * ndz, 1e-20))
    return ox, oy, oz, ndx * rn, ndy * rn, ndz * rn


def trace_sample_fast(scene, config, seed, iteration: int, pixel_offset: int = 0,
                      num_pixels: Optional[int] = None, light_sampler=None) -> torch.Tensor:
    """One sample of pixels [pixel_offset, pixel_offset + N) of an analytic
    scene (the JAX ``trace_sample_fast``): raygen, the bounce loop, and the
    [N, 3] radiance (light_only) or terminal throughput (throughput mode).
    ``seed`` is the JAX ``base_key``: a key ``(k0, k1)``, or the render seed
    as the shorthand for ``PRNGKey(seed)`` (``ops.rng.as_key``);
    ``iteration`` is the 1-based sample index.

    With ``config.nee``, a ``light_sampler`` (``ops.lights.make_light_sampler``)
    adds area-light NEE and a scene map (``scene.envmap``) environment NEE;
    at least one of them must be there. An environment map replaces the
    gradient sky with its lookup."""
    cam = scene.camera
    w, h = cam.resolution
    n = num_pixels if num_pixels is not None else cam.pixel_count
    dev = cam.position.device
    legacy = config.gather_mode == "throughput"
    env = scene.envmap
    want_nee = bool(getattr(config, "nee", False))
    use_area_nee = want_nee and light_sampler is not None
    use_env_nee = want_nee and env is not None
    use_nee = use_area_nee or use_env_nee
    if use_nee and legacy:
        raise ValueError("nee requires gather_mode='light_only'")
    if want_nee and not use_nee:
        raise ValueError(
            "config.nee=True needs a light_sampler "
            "(ops.lights.make_light_sampler on the scene) or an ENVIRONMENT map"
        )
    # sampler='sobol': the leading ld_depths bounces and the first vertex's
    # jitter and lens draw from the per-pixel LD lattices, keyed by global
    # pixel id; the other draws are the lane-indexed threefry streams
    use_ld = getattr(config, "sampler", "independent") == "sobol"

    idx = pixel_offset + torch.arange(n, dtype=torch.int64, device=dev)
    px = (idx % w).to(torch.float32)
    py = (idx // w).to(torch.float32)
    if config.antialias:
        jit2 = (rng_ops.ld_pixel_jitter(seed, iteration, idx) if use_ld
                else rng_ops.pixel_jitter(seed, iteration, n, dev))
        px = px + jit2[:, 0]
        py = py + jit2[:, 1]
    sx = cam.pixel_length[0] * (px - 0.5 * w)
    sy = cam.pixel_length[1] * (py - 0.5 * h)
    dx = cam.view[0] - cam.right[0] * sx - cam.up[0] * sy
    dy = cam.view[1] - cam.right[1] * sx - cam.up[1] * sy
    dz = cam.view[2] - cam.right[2] * sx - cam.up[2] * sy
    r = _rsqrt(dx * dx + dy * dy + dz * dz)
    dx, dy, dz = dx * r, dy * r, dz * r
    ox = cam.position[0].expand(n)
    oy = cam.position[1].expand(n)
    oz = cam.position[2].expand(n)
    if getattr(config, "dof", False):
        lens2 = (rng_ops.ld_lens_uniforms(seed, iteration, idx) if use_ld
                 else rng_ops.lens_uniforms(seed, iteration, n, dev))
        ox, oy, oz, dx, dy, dz = _thin_lens_soa(
            cam, ox, oy, oz, dx, dy, dz, lens2[:, 0], lens2[:, 1]
        )

    f32 = dict(dtype=torch.float32, device=dev)
    ones = torch.ones((n,), **f32)
    zeros = torch.zeros((n,), **f32)
    carry = (
        ox.contiguous(), oy.contiguous(), oz.contiguous(), dx, dy, dz,
        ones, ones, ones,  # throughput r,g,b
        torch.full((n,), config.trace_depth, dtype=torch.int32, device=dev),  # bounces
        zeros, zeros, zeros,  # radiance r,g,b
    )
    if use_nee:
        # solid-angle pdf of the lobe that produced this ray (−1 = delta /
        # primary), for the next emissive hit's or escape's MIS weight
        carry = carry + (torch.full((n,), -1.0, **f32),)

    def shadow_t(sx, sy, sz, wx, wy, wz, active):
        return intersect_unrolled(scene, sx, sy, sz, wx, wy, wz).t

    # the threefry draws of every depth at once (a batch of folded keys):
    # the same bits as one draw a depth, in a fraction of the launches
    n_ld = min(getattr(config, "ld_depths", 1), config.trace_depth) if use_ld else 0
    depths = torch.arange(config.trace_depth, device=dev)
    u_all = rng_ops.bounce_lane_uniforms(seed, iteration, depths[n_ld:], n, dev)
    nee_all = (rng_ops.nee_uniforms(seed, iteration, depths[n_ld:], n, dev)
               if use_area_nee else None)
    env_all = rng_ops.env_uniforms(seed, iteration, depths, n, dev) if use_env_nee else None
    cells_all = (rng_ops.env_cell_words(seed, iteration, depths, n, dev)
                 if use_env_nee and envmap_ops.needs_cell_words(env) else None)

    for d in range(config.trace_depth):
        best = intersect_unrolled(scene, *carry[:6])
        if d < n_ld:
            u = rng_ops.ld_bounce_uniforms(seed, iteration, idx, d)
            nee_u = (rng_ops.ld_nee_bounce_uniforms(seed, iteration, idx, d)
                     if use_area_nee else None)
        else:
            u = u_all[d - n_ld]
            nee_u = None if nee_all is None else nee_all[d - n_ld]
        nee = (light_sampler, shadow_t, nee_u) if use_area_nee else None
        env_nee = ((shadow_t, env_all[d], None if cells_all is None else cells_all[d])
                   if use_env_nee else None)
        carry = shade_soa(carry, best, u, scene.materials, d, config, nee=nee, env=env,
                          env_nee=env_nee)
    if legacy:
        return torch.stack(carry[6:9], dim=-1)
    return torch.stack(carry[10:13], dim=-1)


def shade_soa(carry, best: _Best, u, materials, depth, config, nee=None, env=None,
              env_nee=None):
    """One masked shade/extend pass over the SoA wavefront state (the JAX
    ``shade_soa``). ``carry`` is the 13-tuple state (14 with ``nee`` or
    ``env_nee``: a trailing prev_pdf); ``u`` is [NUM_LANES, N]. ``nee`` is
    ``(light_sampler, shadow_t_fn, uniforms [N, 3])``, where
    ``shadow_t_fn(ox, oy, oz, dx, dy, dz, active)`` gives the shadow rays'
    nearest distance (``_MISS`` when they escape) wherever ``active`` holds
    (the rays whose sample can count). ``env`` (an ``ops.envmap.EnvMap``)
    replaces the gradient sky with the map's lookup; ``env_nee`` is
    ``(shadow_t_fn, uniforms [N, 2], alias-cell words [N, 2] or None)`` for
    environment importance sampling with its own MIS pair against BRDF
    sampling (the words: ``envmap.sample_env``)."""
    (ox, oy, oz, dx, dy, dz, cr, cg, cb, bounces, rr_, rg_, rb_) = carry[:13]
    carry_pdf = nee is not None or env_nee is not None
    prev_pdf = carry[13] if carry_pdf else None
    legacy = config.gather_mode == "throughput"
    u_rr, u_branch, u_a, u_b, u_c = u[0], u[1], u[2], u[3], u[4]

    alive = bounces > 0
    missed = best.miss

    if env is not None:
        dirs3 = torch.stack([dx, dy, dz], dim=-1)
        sky3 = envmap_ops.env_radiance(env, dirs3)
        sky_r, sky_g, sky_b = sky3[:, 0], sky3[:, 1], sky3[:, 2]
    else:
        # sky (`pathtrace.cu:358-362`)
        t_sky = 0.5 * (dy + 1.0)
        sky_r = ((1.0 - t_sky) + t_sky * 0.5) * 0.5
        sky_g = ((1.0 - t_sky) + t_sky * 0.7) * 0.5
        sky_b = ((1.0 - t_sky) + t_sky * 1.0) * 0.5
    if legacy:
        cr = torch.where(missed, cr * sky_r, cr)
        cg = torch.where(missed, cg * sky_g, cg)
        cb = torch.where(missed, cb * sky_b, cb)
    elif env is not None:
        esc = missed & alive
        w_esc = 1.0
        if env_nee is not None:
            # MIS partner of env importance sampling: a BRDF-sampled escape
            # competes with the env sampler having drawn the same direction
            p_env = envmap_ops.env_pdf(env, dirs3)
            w_esc = torch.where(
                prev_pdf < 0.0, 1.0, prev_pdf / torch.clamp_min(prev_pdf + p_env, 1e-20)
            )
        rr_ = torch.where(esc, rr_ + cr * sky_r * w_esc, rr_)
        rg_ = torch.where(esc, rg_ + cg * sky_g * w_esc, rg_)
        rb_ = torch.where(esc, rb_ + cb * sky_b * w_esc, rb_)
    elif config.sky_strength:
        esc = missed & alive
        ss = float(np.float32(config.sky_strength))
        rr_ = torch.where(esc, rr_ + cr * sky_r * ss, rr_)
        rg_ = torch.where(esc, rg_ + cg * sky_g * ss, rg_)
        rb_ = torch.where(esc, rb_ + cb * sky_b * ss, rb_)

    act = ~missed & alive
    mat = _select_material(materials, best.mat)

    # emissive termination
    emissive = mat["emit"] > 0.0
    hit_light = act & emissive
    if legacy:
        cr = torch.where(hit_light, cr * mat["cr"] * mat["emit"], cr)
        cg = torch.where(hit_light, cg * mat["cg"] * mat["emit"], cg)
        cb = torch.where(hit_light, cb * mat["cb"] * mat["emit"], cb)
    elif nee is not None:
        # MIS balance heuristic: a BRDF-sampled emissive hit reached via the
        # previous vertex's diffuse lobe competes with NEE having sampled
        # the same point
        sampler = nee[0]
        normal3 = torch.stack([best.nx, best.ny, best.nz], dim=-1)
        p_nee_area, sampled = sampler.area_pdf_at(best.geom, normal3)
        cos_l = torch.clamp_min(-(dx * best.nx + dy * best.ny + dz * best.nz), 1e-6)
        p_nee_dir = p_nee_area * best.t * best.t / cos_l
        w_emit = torch.where(
            (prev_pdf < 0.0) | ~sampled,
            1.0,
            prev_pdf / torch.clamp_min(prev_pdf + p_nee_dir, 1e-20),
        )
        rr_ = torch.where(hit_light, rr_ + cr * mat["cr"] * mat["emit"] * w_emit, rr_)
        rg_ = torch.where(hit_light, rg_ + cg * mat["cg"] * mat["emit"] * w_emit, rg_)
        rb_ = torch.where(hit_light, rb_ + cb * mat["cb"] * mat["emit"] * w_emit, rb_)
    else:
        rr_ = torch.where(hit_light, rr_ + cr * mat["cr"] * mat["emit"], rr_)
        rg_ = torch.where(hit_light, rg_ + cg * mat["cg"] * mat["emit"], rg_)
        rb_ = torch.where(hit_light, rb_ + cb * mat["cb"] * mat["emit"], rb_)
    act = act & ~emissive

    # Russian roulette
    rr_on = int(depth) > int(config.rr_start_depth)
    p_cont = torch.maximum(mat["cr"], torch.maximum(mat["cg"], mat["cb"]))
    rr_kill = act & rr_on & (u_rr > p_cont)
    rr_boost = torch.where(act & rr_on & ~rr_kill, 1.0 / torch.clamp_min(p_cont, 1e-12), 1.0)
    cr, cg, cb = cr * rr_boost, cg * rr_boost, cb * rr_boost
    act = act & ~rr_kill

    # scatter
    nx, ny, nz = best.nx, best.ny, best.nz
    refl = mat["refl"]
    rough = 1.0 - mat["refr"]
    spec = act & (refl > 0.0) & (u_branch < refl)

    # mirror + cone perturb around the reflected direction
    ddn = dx * nx + dy * ny + dz * nz
    rx = dx - 2.0 * ddn * nx
    ry = dy - 2.0 * ddn * ny
    rz = dz - 2.0 * ddn * nz
    ang = rough * u_a * (_PI * 0.5)
    sa = torch.sin(ang)
    ca = torch.cos(ang)
    ph_s = 2.0 * _PI * u_c
    cp_s = torch.cos(ph_s)
    sp_s = torch.sin(ph_s)
    # cosine-weighted diffuse: cosθ=√(1-u_a), sinθ=√u_a
    st = torch.sqrt(u_a)
    ct = torch.sqrt(torch.clamp_min(1.0 - u_a, 0.0))
    ph_d = 2.0 * _PI * u_b
    cp_d = torch.cos(ph_d)
    sp_d = torch.sin(ph_d)
    # a lane is either specular (cone around r) or diffuse (cosine lobe
    # around n): select the polar axis and the local-frame coefficients
    # first and build one orthonormal frame
    vax = torch.where(spec, rx, nx)
    vay = torch.where(spec, ry, ny)
    vaz = torch.where(spec, rz, nz)
    w0 = torch.where(spec, sa * cp_s, st * cp_d)
    w1 = torch.where(spec, ca, ct)
    w2 = torch.where(spec, sa * sp_s, st * sp_d)
    tx, ty, tz, bx, by, bz = _local_frame(vax, vay, vaz)
    ndx = tx * w0 + vax * w1 + bx * w2
    ndy = ty * w0 + vay * w1 + by * w2
    ndz = tz * w0 + vaz * w1 + bz * w2
    rs = _rsqrt(torch.clamp_min(ndx * ndx + ndy * ndy + ndz * ndz, 1e-20))
    new_dx = ndx * rs
    new_dy = ndy * rs
    new_dz = ndz * rs
    tint_r = torch.where(spec, mat["sr"], mat["cr"])
    tint_g = torch.where(spec, mat["sg"], mat["cg"])
    tint_b = torch.where(spec, mat["sb"], mat["cb"])

    # dielectric refraction, componentwise (Snell + Schlick Fresnel)
    push_through = glass_mask = None
    if getattr(config, "enable_refraction", False):
        is_glass = (mat["ior"] > 0.0) & (mat["refr"] > 0.0)
        cos_i = torch.clamp(-(dx * nx + dy * ny + dz * nz), 0.0, 1.0)
        n1 = torch.where(best.outside, 1.0, mat["ior"])
        n2 = torch.where(best.outside, mat["ior"], 1.0)
        eta = n1 / torch.clamp_min(n2, 1e-6)
        sin2_t = eta * eta * torch.clamp_min(1.0 - cos_i * cos_i, 0.0)
        tir = sin2_t > 1.0
        cos_t = torch.sqrt(torch.clamp_min(1.0 - sin2_t, 0.0))
        r0 = ((n1 - n2) / (n1 + n2)) ** 2
        fres = r0 + (1.0 - r0) * (1.0 - cos_i) ** 5
        coef = eta * cos_i - cos_t
        fx_ = eta * dx + coef * nx
        fy_ = eta * dy + coef * ny
        fz_ = eta * dz + coef * nz
        rn_ = _rsqrt(torch.clamp_min(fx_ * fx_ + fy_ * fy_ + fz_ * fz_, 1e-20))
        transmit = is_glass & ~tir & (u_branch >= fres)
        glass_mask = act & is_glass
        # transmit → refracted dir; reflect (incl. TIR) → pure mirror r
        gdx = torch.where(transmit, fx_ * rn_, rx)
        gdy = torch.where(transmit, fy_ * rn_, ry)
        gdz = torch.where(transmit, fz_ * rn_, rz)
        new_dx = torch.where(glass_mask, gdx, new_dx)
        new_dy = torch.where(glass_mask, gdy, new_dy)
        new_dz = torch.where(glass_mask, gdz, new_dz)
        tint_r = torch.where(glass_mask, torch.where(transmit, mat["cr"], mat["sr"]), tint_r)
        tint_g = torch.where(glass_mask, torch.where(transmit, mat["cg"], mat["sg"]), tint_g)
        tint_b = torch.where(glass_mask, torch.where(transmit, mat["cb"], mat["sb"]), tint_b)
        push_through = glass_mask & transmit

    # hit point = o + t·d; a transmitted ray steps through the interface
    off = (
        _ORIGIN_OFFSET
        if push_through is None
        else torch.where(push_through, -_ORIGIN_OFFSET, _ORIGIN_OFFSET)
    )
    hx = ox + best.t * dx + nx * off
    hy = oy + best.t * dy + ny * off
    hz = oz + best.t * dz + nz * off

    diffuse_prob = 1.0 - refl
    if nee is not None:
        # direct light at this vertex: the diffuse component of the mixture
        # BRDF, (1−P_spec)·albedo/π; cr/cg/cb are the post-RR, pre-tint
        # throughput
        sampler, shadow_t, nee_u = nee
        base = act if glass_mask is None else act & ~glass_mask
        lp, ln, pdf_a, le = sampler.sample(nee_u)
        tox = lp[:, 0] - hx
        toy = lp[:, 1] - hy
        toz = lp[:, 2] - hz
        d2 = tox * tox + toy * toy + toz * toz
        dist = torch.sqrt(torch.clamp_min(d2, 1e-24))
        rdist = 1.0 / dist
        wx, wy, wz = tox * rdist, toy * rdist, toz * rdist
        cos_s = nx * wx + ny * wy + nz * wz
        cos_l2 = -(ln[:, 0] * wx + ln[:, 1] * wy + ln[:, 2] * wz)
        # only the shadow rays whose sample can count are traced (the JAX
        # package traces every live ray's; the others' t is never read)
        facing = base & (cos_s > 0.0) & (cos_l2 > 0.0) & (dist > 1e-4)
        sh_t = shadow_t(hx, hy, hz, wx, wy, wz, facing)
        visible = sh_t >= dist - torch.clamp_min(1e-3 * dist, 1e-3)
        add = facing & visible
        p_brdf_area = (
            diffuse_prob * torch.clamp_min(cos_s, 0.0) * _INV_PI
            * torch.clamp_min(cos_l2, 0.0) / torch.clamp_min(d2, 1e-12)
        )
        w_mis = pdf_a / torch.clamp_min(pdf_a + p_brdf_area, 1e-20)
        geomf = cos_s * cos_l2 / torch.clamp_min(d2 * pdf_a, 1e-20)
        k_d = diffuse_prob * _INV_PI * geomf * w_mis
        rr_ = torch.where(add, rr_ + cr * mat["cr"] * k_d * le[:, 0], rr_)
        rg_ = torch.where(add, rg_ + cg * mat["cg"] * k_d * le[:, 1], rg_)
        rb_ = torch.where(add, rb_ + cb * mat["cb"] * k_d * le[:, 2], rb_)

    if env_nee is not None:
        # direct environment light: the light pdf in solid angle,
        # visibility = the shadow ray escapes the scene, its own MIS pair
        # against BRDF sampling
        shadow_t, env_u, cell_words = env_nee
        base = act if glass_mask is None else act & ~glass_mask
        wi, _, pdf_e = envmap_ops.sample_env(env, env_u[:, 0], env_u[:, 1], cell_words)
        # both techniques integrate the same bilinear L
        le3 = envmap_ops.env_radiance(env, wi)
        wx, wy, wz = wi[:, 0], wi[:, 1], wi[:, 2]
        cos_s = nx * wx + ny * wy + nz * wz
        facing = base & (cos_s > 0.0)
        sh_t = shadow_t(hx, hy, hz, wx, wy, wz, facing)
        visible = sh_t >= _MISS  # the miss sentinel: escaped
        p_brdf = diffuse_prob * torch.clamp_min(cos_s, 0.0) * _INV_PI
        w_mis = pdf_e / torch.clamp_min(pdf_e + p_brdf, 1e-20)
        k_e = (diffuse_prob * _INV_PI * torch.clamp_min(cos_s, 0.0)
               / torch.clamp_min(pdf_e, 1e-20) * w_mis)
        add = facing & visible
        rr_ = torch.where(add, rr_ + cr * mat["cr"] * k_e * le3[:, 0], rr_)
        rg_ = torch.where(add, rg_ + cg * mat["cg"] * k_e * le3[:, 1], rg_)
        rb_ = torch.where(add, rb_ + cb * mat["cb"] * k_e * le3[:, 2], rb_)

    if carry_pdf:
        # density of this vertex's lobe choice (the next emissive hit's or
        # escape's MIS): diffuse lanes carry (1−P)·cosθ/π, delta lobes −1
        cos_new = torch.clamp_min(new_dx * nx + new_dy * ny + new_dz * nz, 0.0)
        diffuse_ext = act & ~spec
        if glass_mask is not None:
            diffuse_ext = diffuse_ext & ~glass_mask
        prev_pdf = torch.where(diffuse_ext, diffuse_prob * cos_new * _INV_PI, -1.0)

    cr = torch.where(act, cr * tint_r, cr)
    cg = torch.where(act, cg * tint_g, cg)
    cb = torch.where(act, cb * tint_b, cb)
    ox = torch.where(act, hx, ox)
    oy = torch.where(act, hy, oy)
    oz = torch.where(act, hz, oz)
    dx = torch.where(act, new_dx, dx)
    dy = torch.where(act, new_dy, dy)
    dz = torch.where(act, new_dz, dz)
    bounces = torch.where(act, bounces - 1, torch.zeros_like(bounces))

    out = (ox, oy, oz, dx, dy, dz, cr, cg, cb, bounces, rr_, rg_, rb_)
    return out + (prev_pdf,) if carry_pdf else out


def supports_mesh(scene) -> bool:
    """Mesh SoA pipeline: triangles via the cluster kernel + the
    analytic primitives, no environment map."""
    return (
        scene.num_triangles > 0
        and scene.cubes.count + scene.spheres.count <= MAX_UNROLL
        and scene.envmap is None
    )


@functools.lru_cache(maxsize=8)
def _block_order(w: int, h: int, block: int = 32) -> np.ndarray:
    """Pixel visit permutation grouping ``block``×``block`` screen rects, as
    int32 [w*h]: entry i is the linear pixel id the i-th ray handles (row
    major inside a block, ragged edge blocks smaller). Each group of rays
    then covers a compact screen rect, whose frustum culls far more
    clusters than a run of one scanline."""
    py, px = np.mgrid[0:h, 0:w]
    bw = (w + block - 1) // block
    key = (py // block) * bw + (px // block)
    return np.argsort(key.ravel(), kind="stable").astype(np.int32)


@functools.lru_cache(maxsize=8)
def _block_order_on(w: int, h: int, device: torch.device) -> torch.Tensor:
    """:func:`_block_order` as int64 on ``device``, uploaded once."""
    return torch.as_tensor(_block_order(w, h), device=device).to(torch.int64)


def trace_sample_mesh(scene, config, seed, iteration: int, cluster_isect,
                      pixel_offset: int = 0, num_pixels: Optional[int] = None,
                      light_sampler=None) -> torch.Tensor:
    """One sample of every pixel of a triangle-mesh scene: the [N, 3]
    radiance (light_only) or terminal throughput (throughput mode), in pixel
    order. ``seed`` is the JAX ``base_key``: a key ``(k0, k1)``, or the
    render seed as the shorthand for ``PRNGKey(seed)``; ``iteration`` is the
    1-based sample index, ``cluster_isect`` a
    :class:`~.cuda.mesh_kernel.ClusterMeshIntersector` over the scene's
    triangles. ``pixel_offset``/``num_pixels`` select a contiguous slice of
    the flat pixel array (the multi-device pixel tiling, ``parallel.shard``).

    With ``config.nee`` a ``light_sampler`` over the scene's analytic
    emitters (``ops.lights.make_light_sampler``) must be given; the shadow
    rays then test triangles through K8 and analytic primitives through
    :func:`intersect_unrolled`. Emissive triangles stay BRDF-sampled."""
    cam = scene.camera
    w, h = cam.resolution
    n = num_pixels if num_pixels is not None else cam.pixel_count
    dev = cam.position.device
    legacy = config.gather_mode == "throughput"
    use_nee = bool(getattr(config, "nee", False))
    if use_nee and legacy:
        raise ValueError("nee requires gather_mode='light_only'")
    if use_nee and light_sampler is None:
        raise ValueError(
            "config.nee=True needs a light_sampler "
            "(ops.lights.make_light_sampler on the scene)"
        )
    has_analytic = scene.cubes.count + scene.spheres.count > 0
    do_sort = getattr(config, "mesh_ray_sort", True) and not legacy
    fused = getattr(config, "mesh_sort_fused", False)
    if do_sort and w * h >= (1 << 24) and not fused:
        # the JAX package's unfused sort carries pixel ids through float32,
        # exact only below 2^24
        raise ValueError(
            f"frames with {w * h} pixels need mesh_sort_fused=True "
            "(pixel ids exceed exact f32 range)"
        )
    # block-ordered primary rays: only where the final unsort exists and the
    # call renders the full frame
    blocked = do_sort and pixel_offset == 0 and n == w * h
    if blocked:
        idx = _block_order_on(w, h, dev)
    else:
        idx = pixel_offset + torch.arange(n, dtype=torch.int64, device=dev)
    px = (idx % w).to(torch.float32)
    py = (idx // w).to(torch.float32)
    use_ld = getattr(config, "sampler", "independent") == "sobol"
    direct = not blocked and num_pixels is None
    if config.antialias:
        if use_ld:
            jit2 = rng_ops.ld_pixel_jitter(seed, iteration, idx)
        else:
            # pixel-keyed: the full frame's rows, gathered by pixel id
            jit2 = rng_ops.pixel_jitter(seed, iteration, w * h, dev)
            if not direct:
                jit2 = jit2[idx]
        px = px + jit2[:, 0]
        py = py + jit2[:, 1]
    sx = cam.pixel_length[0] * (px - 0.5 * w)
    sy = cam.pixel_length[1] * (py - 0.5 * h)
    dx = cam.view[0] - cam.right[0] * sx - cam.up[0] * sy
    dy = cam.view[1] - cam.right[1] * sx - cam.up[1] * sy
    dz = cam.view[2] - cam.right[2] * sx - cam.up[2] * sy
    r = _rsqrt(dx * dx + dy * dy + dz * dz)
    dx, dy, dz = dx * r, dy * r, dz * r
    ox = cam.position[0].expand(n)
    oy = cam.position[1].expand(n)
    oz = cam.position[2].expand(n)
    if getattr(config, "dof", False):
        if use_ld:
            lens2 = rng_ops.ld_lens_uniforms(seed, iteration, idx)
        else:
            lens2 = rng_ops.lens_uniforms(seed, iteration, w * h, dev)
            if not direct:
                lens2 = lens2[idx]
        ox, oy, oz, dx, dy, dz = _thin_lens_soa(
            cam, ox, oy, oz, dx, dy, dz, lens2[:, 0], lens2[:, 1]
        )

    f32 = dict(dtype=torch.float32, device=dev)
    ones = torch.ones((n,), **f32)
    zeros = torch.zeros((n,), **f32)
    carry = (
        ox.contiguous(), oy.contiguous(), oz.contiguous(), dx, dy, dz,
        ones, ones, ones,
        torch.full((n,), config.trace_depth, dtype=torch.int32, device=dev),
        zeros, zeros, zeros,
    )
    if use_nee:
        # prev-lobe solid-angle pdf for MIS (−1 = delta/primary), last so
        # slots 0-12 keep their layout
        carry = carry + (torch.full((n,), -1.0, **f32),)
    # ray i carries its global pixel id through every reorder: the streams
    # are keyed by it, and the final unsort scatters by it
    pixel = idx

    cells = int(getattr(config, "mesh_sort_cells", 4))
    if getattr(config, "mesh_ray_sort", True):
        # the triangles' bounding box, computed once with the intersector
        lo, extent = cluster_isect.tables.bounds
        cell_scale = float(cells) / extent

    def sort_rays(carry, pixel):
        """Reorder the wavefront by (origin cell, direction octant), dead
        rays last: one stable sort of the key, then a gather of every
        payload. The JAX package's fused sort and its argsort + row gather
        both take exactly this permutation."""
        ox, oy, oz, dx, dy, dz = carry[:6]
        alive = carry[9] > 0
        octant = (dx > 0).to(torch.int32) + 2 * (dy > 0).to(torch.int32) \
            + 4 * (dz > 0).to(torch.int32)
        cx = torch.clamp(((ox - lo[0]) * cell_scale[0]).to(torch.int32), 0, cells - 1)
        cy = torch.clamp(((oy - lo[1]) * cell_scale[1]).to(torch.int32), 0, cells - 1)
        cz = torch.clamp(((oz - lo[2]) * cell_scale[2]).to(torch.int32), 0, cells - 1)
        key = octant + 8 * (cx + cells * cy + cells * cells * cz)
        dead_key = 8 * cells * cells * cells  # > any live key
        key = torch.where(alive, key, dead_key)
        perm = torch.sort(key, stable=True).indices
        return tuple(c[perm] for c in carry), pixel[perm]

    def intersect_combined(ox, oy, oz, dx, dy, dz, alive, walk) -> _Best:
        t, ti, nx, ny, nz, mat_f = cluster_isect.call_soa(ox, oy, oz, dx, dy, dz, active=alive,
                                                          walk=walk)
        tri_hit = ti >= 0
        best = _Best(
            t=torch.where(tri_hit, t, _MISS),
            nx=nx, ny=ny, nz=nz,
            mat=mat_f.to(torch.int32),
            miss=~tri_hit,
            outside=torch.ones_like(tri_hit),  # triangles are thin surfaces
            # triangles are never in the analytic light sampler: id -1
            # (pdf 0, weight 1)
            geom=torch.full_like(ti, -1) if use_nee else None,
        )
        if has_analytic:
            a = intersect_unrolled(scene, ox, oy, oz, dx, dy, dz)
            a_wins = a.t < best.t
            best = _Best(
                t=torch.where(a_wins, a.t, best.t),
                nx=torch.where(a_wins, a.nx, best.nx),
                ny=torch.where(a_wins, a.ny, best.ny),
                nz=torch.where(a_wins, a.nz, best.nz),
                mat=torch.where(a_wins, a.mat, best.mat),
                miss=best.miss & ~a_wins,
                outside=torch.where(a_wins, a.outside, best.outside),
                geom=torch.where(a_wins, a.geom, best.geom) if use_nee else None,
            )
        return best

    def bounce_at(carry, pixel, depth: int, sort: bool, ld_depth: int = -1):
        if sort:
            carry, pixel = sort_rays(carry, pixel)
        ox, oy, oz, dx, dy, dz = carry[:6]
        bounces = carry[9]
        # pixel-keyed uniforms: the streams follow the pixel through reorders
        if ld_depth >= 0:
            u = rng_ops.ld_bounce_uniforms(seed, iteration, pixel, ld_depth)
        else:
            u = rng_ops.hash_bounce_uniforms(seed, iteration, depth, pixel)
        # dead rays are inactive (a miss) in light_only, where they gather
        # nothing; legacy mode keeps every ray active (its sky multiply
        # touches dead rays) and never sorts
        alive = bounces > 0 if not legacy else torch.ones((n,), dtype=torch.bool, device=dev)
        # the kernel's lane walk for the primary rays, all live and coherent;
        # its warp walk for the later bounces' scattered and thinning rays
        best = intersect_combined(ox, oy, oz, dx, dy, dz, alive,
                                  "lane" if depth == 0 else "warp")
        nee = None
        if use_nee:
            def shadow_t(sx, sy, sz, wx, wy, wz, active):
                st = cluster_isect.call_t(sx, sy, sz, wx, wy, wz, active=active)
                if has_analytic:
                    st = torch.minimum(st, intersect_unrolled(scene, sx, sy, sz, wx, wy, wz).t)
                return st

            nee = (
                light_sampler,
                shadow_t,
                rng_ops.ld_nee_bounce_uniforms(seed, iteration, pixel, ld_depth)
                if ld_depth >= 0
                else rng_ops.hash_nee_uniforms(seed, iteration, depth, pixel),
            )
        return shade_soa(carry, best, u, scene.materials, depth, config, nee=nee), pixel

    # primary rays are coherent by construction (block order): bounce 0
    # skips the sort; with sampler='sobol' the leading ld_depths bounces
    # draw from their LD lattices, and LD bounces past 0 sort like any other
    n_ld = min(getattr(config, "ld_depths", 1), config.trace_depth) if use_ld else 1
    carry, pixel = bounce_at(carry, pixel, 0, sort=False, ld_depth=0 if use_ld else -1)
    for d in range(1, n_ld):
        carry, pixel = bounce_at(carry, pixel, d, sort=do_sort, ld_depth=d)
    # sort cadence: the first bounce of every group of mesh_sort_every sorts
    se = max(1, int(getattr(config, "mesh_sort_every", 1)))
    for k, d in enumerate(range(n_ld, config.trace_depth)):
        carry, pixel = bounce_at(carry, pixel, d, sort=do_sort and k % se == 0)
    cr, cg, cb = carry[6:9]
    if legacy:
        return torch.stack([cr, cg, cb], dim=-1)
    out = torch.stack(carry[10:13], dim=-1)
    if do_sort:
        # finalGather: radiance back to pixel order, scattered by pixel id
        unsorted = torch.empty_like(out)
        unsorted[pixel - pixel_offset] = out
        return unsorted
    return out
