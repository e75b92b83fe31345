"""The plain reference of the path tracer's estimator, in PyTorch.

One path per (sample, pixel), traced through ``depth`` vertices over every
primitive: the pinhole primary ray, nearest hit over unit cubes (slab test)
and unit spheres (quadratic) in object space, emitters added at the hit,
Russian roulette past ``RR_START`` with the 1/p boost, a mirror or cosine
lobe picked by the material's reflectivity, and, under an environment map,
the escape's bilinear radiance and one shared env NEE direction per
(iteration, depth) with its shadow ray, both weighted by the balance
heuristic. Random numbers: the per-pixel Owen-scrambled Sobol lattice on
the first ``N_LD`` bounces and the counter hash of the pixel's tile lane on
the rest. The image of a pixel is its sample sums added launch by launch in
ascending iteration order, over the iteration count.

``dtype`` sets the float type of the path arithmetic (the random streams
are integer words and stay exact). The random streams are keyed by the
render seed's int32 word (``rng.kernel_seed``), as the megakernel's are.

The reference of the megakernel's configurations (cubes, spheres, a map):
:func:`estimator` is the one ``check.estimator`` calls.
"""

from __future__ import annotations

import copy
from types import SimpleNamespace

import numpy as np
import torch

from ..meadow import meadow
from . import envmap, rng
from .scene import GF, MF, RefScene, load

TILE = 2048  # pixels per hash-stream tile: pixel p draws lane p % TILE of tile p // TILE
N_LD = 2  # leading bounce depths that draw from the Sobol lattice
RR_START = 3  # Russian roulette opens past this depth
BATCH = 1 << 21  # paths traced together

_PI = 3.14159265358979323846
_INV_PI = 0.3183098861837907
_TWO_PI_F32 = float(np.float32(2.0 * np.float32(_PI)))
_HALF_PI_F32 = float(np.float32(_PI * 0.5))
_INV_PI_F32 = float(np.float32(_INV_PI))
_FMAX = 3.402823466e38
_MISS = 1e30
_BACKOFF = 1e-4
_ORIGIN_OFFSET = 1e-3
_ATAN_C = (
    0.9999999930825906, -0.33333254080432473, 0.199977505037471,
    -0.14257992653960597, 0.1092607635073435, -0.08340029963538047,
    0.05703403618375145, -0.030384225558022983, 0.010544175519843985,
    -0.0017213223616973183,
)


def _rsqrt(x):
    return 1.0 / torch.sqrt(x)


def _raygen(cam, width, height, fx, fy):
    sx = cam[12] * (fx - 0.5 * width)
    sy = cam[13] * (fy - 0.5 * height)
    dx = cam[3] - cam[6] * sx - cam[9] * sy
    dy = cam[4] - cam[7] * sx - cam[10] * sy
    dz = cam[5] - cam[8] * sx - cam[11] * sy
    rn = _rsqrt(dx * dx + dy * dy + dz * dz)
    return dx * rn, dy * rn, dz * rn


def _object_ray(iv, perm, ox, oy, oz, dx, dy, dz):
    if perm is None:
        return (iv[0] * ox + iv[1] * oy + iv[2] * oz + iv[3],
                iv[4] * ox + iv[5] * oy + iv[6] * oz + iv[7],
                iv[8] * ox + iv[9] * oy + iv[10] * oz + iv[11],
                iv[0] * dx + iv[1] * dy + iv[2] * dz,
                iv[4] * dx + iv[5] * dy + iv[6] * dz,
                iv[8] * dx + iv[9] * dy + iv[10] * dz)
    pw, dw = (ox, oy, oz), (dx, dy, dz)
    c0, c1, c2 = perm
    return (iv[c0] * pw[c0] + iv[3], iv[4 + c1] * pw[c1] + iv[7], iv[8 + c2] * pw[c2] + iv[11],
            iv[c0] * dw[c0], iv[4 + c1] * dw[c1], iv[8 + c2] * dw[c2])


def _geoms(scene: RefScene):
    geo = scene.geo.tolist()
    perms = scene.perm.reshape(-1, 3).tolist()
    for k in range(scene.num_geoms):
        perm = None if perms[k][0] < 0 else tuple(perms[k])
        yield k, geo[k * GF:k * GF + 12], geo[k * GF + 12:(k + 1) * GF], perm


def _fmax(dtype, device) -> torch.Tensor:
    """The float32 maximum at ``dtype`` (past a narrower type's range: its infinity)."""
    return torch.tensor(_FMAX, dtype=torch.float32, device=device).to(dtype)


def _slabs(qox, qoy, qoz, qdx, qdy, qdz):
    ix, iy, iz = 1.0 / qdx, 1.0 / qdy, 1.0 / qdz
    t1x, t2x = (-0.5 - qox) * ix, (0.5 - qox) * ix
    t1y, t2y = (-0.5 - qoy) * iy, (0.5 - qoy) * iy
    t1z, t2z = (-0.5 - qoz) * iz, (0.5 - qoz) * iz
    return t1x, t2x, t1y, t2y, t1z, t2z


def _quadratic(qox, qoy, qoz, qdx, qdy, qdz):
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
    sparam = torch.where(both_pos, torch.minimum(s1, s2), torch.maximum(s1, s2))
    return sparam, (disc >= 0) & ~both_neg, both_pos


def intersect(scene: RefScene, ox, oy, oz, dx, dy, dz, dtype):
    """Nearest hit over every primitive: (t, unit world normal xyz, material)."""
    gmat = scene.gmat.tolist()
    shape = torch.broadcast_shapes(ox.shape, dx.shape)
    dev = dx.device
    best_t = torch.full(shape, _MISS, dtype=dtype, device=dev)
    best_nx = torch.zeros(shape, dtype=dtype, device=dev)
    best_ny = torch.zeros_like(best_nx)
    best_nz = torch.zeros_like(best_nx)
    best_mat = torch.zeros(shape, dtype=torch.int64, device=dev)
    one = torch.ones((), dtype=dtype, device=dev)
    fmax = _fmax(dtype, dev)
    for k, iv, it, perm in _geoms(scene):
        qox, qoy, qoz, qdx, qdy, qdz = _object_ray(iv, perm, ox, oy, oz, dx, dy, dz)
        if k < scene.num_cubes:
            t1x, t2x, t1y, t2y, t1z, t2z = _slabs(qox, qoy, qoz, qdx, qdy, qdz)
            tax, tbx = torch.minimum(t1x, t2x), torch.maximum(t1x, t2x)
            tay, tby = torch.minimum(t1y, t2y), torch.maximum(t1y, t2y)
            taz, tbz = torch.minimum(t1z, t2z), torch.maximum(t1z, t2z)
            sgx = torch.where(t2x < t1x, one, -one)
            sgy = torch.where(t2y < t1y, one, -one)
            sgz = torch.where(t2z < t1z, one, -one)
            ax = torch.where(tax > 0, tax, -fmax)
            ay = torch.where(tay > 0, tay, -fmax)
            az = torch.where(taz > 0, taz, -fmax)
            bx = torch.where(tbx < _FMAX, tbx, fmax)
            by = torch.where(tby < _FMAX, tby, fmax)
            bz = torch.where(tbz < _FMAX, tbz, fmax)
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
                nox, noy, noz = (torch.where(sels[inv_p[r]], sgs[inv_p[r]] * it[r * 3 + inv_p[r]],
                                             0.0) for r in range(3))
            else:
                sfx = torch.where(use_x, one, 0.0 * one)
                sfy = torch.where(use_y, one, 0.0 * one)
                gx, gy, gz = sgx * sfx, sgy * sfy, sgz * (1.0 - sfx - sfy)
                nox = gx * it[0] + gy * it[1] + gz * it[2]
                noy = gx * it[3] + gy * it[4] + gz * it[5]
                noz = gx * it[6] + gy * it[7] + gz * it[8]
        else:
            sparam, hit, both_pos = _quadratic(qox, qoy, qoz, qdx, qdy, qdz)
            t_world = sparam - _BACKOFF
            flip = torch.where(both_pos, one, -one)
            sv = ((qox + t_world * qdx) * flip, (qoy + t_world * qdy) * flip,
                  (qoz + t_world * qdz) * flip)
            if perm is not None:
                inv_p = [perm.index(r) for r in range(3)]
                nox, noy, noz = (it[r * 3 + inv_p[r]] * sv[inv_p[r]] for r in range(3))
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
    rw = _rsqrt(torch.clamp_min(best_nx * best_nx + best_ny * best_ny + best_nz * best_nz, 1e-30))
    return best_t, best_nx * rw, best_ny * rw, best_nz * rw, best_mat


def occluded(scene: RefScene, ox, oy, oz, dx, dy, dz, limit):
    """Does any primitive hit with backoff-adjusted t in (0, limit)?"""
    occ = torch.zeros(torch.broadcast_shapes(ox.shape, dx.shape), dtype=torch.bool,
                      device=dx.device)
    fmax = _fmax(dx.dtype, dx.device)
    for k, iv, _it, perm in _geoms(scene):
        qox, qoy, qoz, qdx, qdy, qdz = _object_ray(iv, perm, ox, oy, oz, dx, dy, dz)
        if k < scene.num_cubes:
            t1x, t2x, t1y, t2y, t1z, t2z = _slabs(qox, qoy, qoz, qdx, qdy, qdz)
            ax = torch.minimum(t1x, t2x)
            ay = torch.minimum(t1y, t2y)
            az = torch.minimum(t1z, t2z)
            bx = torch.maximum(t1x, t2x)
            by = torch.maximum(t1y, t2y)
            bz = torch.maximum(t1z, t2z)
            ax = torch.where(ax > 0, ax, -fmax)
            ay = torch.where(ay > 0, ay, -fmax)
            az = torch.where(az > 0, az, -fmax)
            bx = torch.where(bx < _FMAX, bx, fmax)
            by = torch.where(by < _FMAX, by, fmax)
            bz = torch.where(bz < _FMAX, bz, fmax)
            s_min = torch.maximum(ax, torch.maximum(ay, az))
            s_max = torch.minimum(bx, torch.minimum(by, bz))
            hit = (s_max >= s_min) & (s_max > 0)
            sparam = torch.where(s_min > 0, s_min, s_max)
        else:
            sparam, hit, _ = _quadratic(qox, qoy, qoz, qdx, qdy, qdz)
        t_world = sparam - _BACKOFF
        occ = occ | (hit & (t_world > 0) & (t_world < limit))
    return occ


def _patan2(y, x):
    """atan2 from the degree-9 polynomial of atan(t)/t with the octant
    reduction; (0, 0) → 0."""
    ax, ay = torch.abs(x), torch.abs(y)
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


def _env_uv(dx, dy, dz):
    u = 0.5 + _patan2(dx, -dz) * (1.0 / (2.0 * _PI))
    c = torch.clamp(dy, -1.0, 1.0)
    v = _patan2(torch.sqrt(torch.clamp_min((1.0 - c) * (1.0 + c), 0.0)), c) * (1.0 / _PI)
    return u, v


def _env_escape(rad, h, w, dx, dy, dz):
    """Bilinear radiance at escape per channel, ``rad`` [H, W, 3] the
    strength-folded map: wrap in azimuth, clamp at the poles, two-term sums
    per column then across columns (at a clamp the weight is (1-t)+t)."""
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
    out = []
    for c in range(3):
        plane = rad[..., c]

        def column(xi):
            top = plane[y0i, xi] * wy0
            return torch.where(same_y, top, top + plane[y1i, xi] * ty)

        left = wx0 * column(x0i)
        out.append(torch.where(same_x, left, left + tx * column(x1i)))
    return out


def _env_pdf(pdf, h, w, dx, dy, dz):
    """The sampler's pdf of a direction: its texel, without the -0.5 offset."""
    u, v = _env_uv(dx, dy, dz)
    xi = torch.clamp((u * w).to(torch.int64), 0, w - 1)
    yi = torch.clamp((v * h).to(torch.int64), 0, h - 1)
    return pdf.reshape(-1)[yi * w + xi]


class Pixels:
    """The traced pixels: global ids, coordinates, hash lanes and tiles."""

    def __init__(self, scene: RefScene, pixel_ids: torch.Tensor, dtype):
        p = rng.u32(pixel_ids)
        self.pid = p
        self.fx = (p % scene.width).to(torch.float32).to(dtype)
        self.fy = (p // scene.width).to(torch.float32).to(dtype)
        self.lane = p % TILE
        self.tile_id = p // TILE


def _trace(scene: RefScene, env, seed, its, px: Pixels, primary, rows, iter_base, dtype,
           stats):
    """Radiance of the samples ``its`` [S, 1] at pixels ``px``: [S, N, 3] path
    sums and, under a map, [S, N, 3] escape terms."""
    dev = px.pid.device
    mat_cols = torch.as_tensor(scene.mats.reshape(-1, MF).T.copy(), device=dev).to(dtype)
    shape = torch.broadcast_shapes(its.shape, px.pid.shape)
    seed_u = seed & rng.MASK32
    prng = rng.HashPrng(px.lane)
    cam = scene.cam.tolist()
    f = dict(dtype=dtype, device=dev)
    dx, dy, dz = (v.expand(shape) for v in primary[0])
    ox = torch.full(shape, cam[0], **f)
    oy = torch.full(shape, cam[1], **f)
    oz = torch.full(shape, cam[2], **f)
    cr, cg, cb = (torch.ones(shape, **f) for _ in range(3))
    rad_r, rad_g, rad_b = (torch.zeros(shape, **f) for _ in range(3))
    prev_pdf = torch.full(shape, -1.0, **f)
    alive = torch.ones(shape, dtype=torch.bool, device=dev)
    if env is not None:
        e_wr, e_wg, e_wb, e_dx, e_dz = (torch.zeros(shape, **f) for _ in range(5))
        e_dy = torch.ones(shape, **f)
        e_pp = torch.full(shape, -1.0, **f)
    u01 = lambda bits: bits.to(dtype)  # noqa: E731
    for depth in range(scene.trace_depth):
        rr = depth > RR_START
        if depth < N_LD:
            s0, s1 = rng.ld_rev_components(its, depth, seed_u, px.pid)
            if rr:
                prng.reseed(rng.mix(seed_u, its, depth, px.tile_id))
                u_rr = u01(prng.u01())
            tags = rng.ld_bounce_tags(depth)
            u_branch = u01(rng.ld_u01(s0, rng.ld_shift(seed_u, px.pid, tags[0])))
            u_a = u01(rng.ld_u01(s0, rng.ld_shift(seed_u, px.pid, tags[1])))
            u_b = u01(rng.ld_u01(s1, rng.ld_shift(seed_u, px.pid, tags[2])))
        else:
            prng.reseed(rng.mix(seed_u, its, depth, px.tile_id))
            if rr:
                u_rr = u01(prng.u01())
            u_branch = u01(prng.u01())
            u_a = u01(prng.u01())
            u_b = u01(prng.u01())
        if depth == 0:
            best_t, nx, ny, nz, mat = (v.expand(shape) for v in primary[1])
        else:
            best_t, nx, ny, nz, mat = intersect(scene, ox, oy, oz, dx, dy, dz, dtype)
            _count(stats, "isect", alive)
        missed = best_t >= _MISS
        if env is not None:
            esc = missed & alive
            _count(stats, "env_lookup", esc)
            _count(stats, "env_pdf", esc & (prev_pdf >= 0.0))
            e_wr = torch.where(esc, cr, e_wr)
            e_wg = torch.where(esc, cg, e_wg)
            e_wb = torch.where(esc, cb, e_wb)
            e_dx = torch.where(esc, dx, e_dx)
            e_dy = torch.where(esc, dy, e_dy)
            e_dz = torch.where(esc, dz, e_dz)
            e_pp = torch.where(esc, prev_pdf, e_pp)
        act = ~missed & alive
        m_cr, m_cg, m_cb, m_sr, m_sg, m_sb, m_refl, m_refr, m_emit, _m_ior = (
            mat_cols[j][mat] for j in range(MF))
        hit_light = act & (m_emit > 0.0)
        rad_r = torch.where(hit_light, rad_r + cr * m_cr * m_emit, rad_r)
        rad_g = torch.where(hit_light, rad_g + cg * m_cg * m_emit, rad_g)
        rad_b = torch.where(hit_light, rad_b + cb * m_cb * m_emit, rad_b)
        act = act & ~(m_emit > 0.0)
        if rr:
            p_cont = torch.maximum(m_cr, torch.maximum(m_cg, m_cb))
            rr_kill = act & (u_rr > p_cont)
            boost = torch.where(act & ~rr_kill, 1.0 / torch.clamp_min(p_cont, 1e-12), 1.0)
            cr, cg, cb = cr * boost, cg * boost, cb * boost
            act = act & ~rr_kill
        _count(stats, "scatter", act)
        rough = 1.0 - m_refr
        spec = act & (m_refl > 0.0) & (u_branch < m_refl)
        ddn = dx * nx + dy * ny + dz * nz
        rx = dx - 2.0 * ddn * nx
        ry = dy - 2.0 * ddn * ny
        rz = dz - 2.0 * ddn * nz
        ph2 = _TWO_PI_F32 * u_b
        cp2, sp2 = torch.cos(ph2), torch.sin(ph2)
        ang = rough * u_a * _HALF_PI_F32
        sa, ca = torch.sin(ang), torch.cos(ang)
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
        scp, ssp = s_pol * cp2, s_pol * sp2
        ndx = tx * scp + vax * c_pol + bxv * ssp
        ndy = ty * scp + vay * c_pol + byv * ssp
        ndz = tz * scp + vaz * c_pol + bzv * ssp
        t_r = torch.where(spec, m_sr, m_cr)
        t_g = torch.where(spec, m_sg, m_cg)
        t_b = torch.where(spec, m_sb, m_cb)
        hx = ox + best_t * dx + nx * _ORIGIN_OFFSET
        hy = oy + best_t * dy + ny * _ORIGIN_OFFSET
        hz = oz + best_t * dz + nz * _ORIGIN_OFFSET
        if env is not None:
            # the (iteration, depth) row's direction, a shadow ray to 1e7 and
            # the balance heuristic against the diffuse lobe
            erow = rows[(its - iter_base) * scene.trace_depth + depth]
            ewx, ewy, ewz, e_pdf = erow[..., 0], erow[..., 1], erow[..., 2], erow[..., 6]
            ecos = nx * ewx + ny * ewy + nz * ewz
            _count(stats, "env_shadow", act & (ecos > 0.0))
            evis = ~occluded(scene, hx, hy, hz, ewx, ewy, ewz, 1e7)
            ediff = 1.0 - m_refl
            e_pb = ediff * torch.clamp_min(ecos, 0.0) * _INV_PI_F32
            e_w = e_pdf / torch.clamp_min(e_pdf + e_pb, 1e-20)
            e_k = (ediff * _INV_PI_F32 * torch.clamp_min(ecos, 0.0)
                   / torch.clamp_min(e_pdf, 1e-20) * e_w)
            eadd = act & (ecos > 0.0) & evis
            rad_r = torch.where(eadd, rad_r + cr * m_cr * e_k * erow[..., 3], rad_r)
            rad_g = torch.where(eadd, rad_g + cg * m_cg * e_k * erow[..., 4], rad_g)
            rad_b = torch.where(eadd, rad_b + cb * m_cb * e_k * erow[..., 5], rad_b)
            cos_new = torch.clamp_min(ndx * nx + ndy * ny + ndz * nz, 0.0)
            prev_pdf = torch.where(act & ~spec, (1.0 - m_refl) * cos_new * _INV_PI_F32, -1.0)
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
    path = torch.stack([rad_r, rad_g, rad_b], dim=-1)
    if env is None:
        return path, None
    h, w = env.shape
    er, eg, eb = _env_escape(env.rad, h, w, e_dx, e_dy, e_dz)
    pe = _env_pdf(env.pdf, h, w, e_dx, e_dy, e_dz)
    wmis = torch.where(e_pp < 0.0, 1.0, e_pp * (1.0 / torch.clamp_min(e_pp + pe, 1e-20)))
    return path, torch.stack([e_wr * er * wmis, e_wg * eg * wmis, e_wb * eb * wmis], dim=-1)


def _count(stats, key, mask):
    if stats is not None:
        stats[key] = stats.get(key, 0) + int(mask.sum())


class Estimator:
    """The reference renderer of one scene (and map) at one float type."""

    def __init__(self, scene: RefScene, env: envmap.RefEnv = None, dtype=torch.float32):
        self.scene = scene
        self.env = env
        self.dtype = dtype
        if env is not None:
            h, w = env.shape
            # the strength-folded map and the pdf at the path's float type
            self.env_tables = SimpleNamespace(
                shape=env.shape, rad=(env.img * env.strength).reshape(h, w, 3).to(dtype),
                pdf=env.pdf.to(dtype))

    def with_scene(self, scene: RefScene) -> "Estimator":
        """The same estimator (and map) over another camera of the scene."""
        other = copy.copy(self)
        other.scene = scene
        return other

    def accumulate(self, seed: int, pixel_ids: torch.Tensor, launches, stats=None):
        """The accumulator [N, 3] f32 of ``pixel_ids`` after ``launches``
        [(first iteration, samples), ...] of consecutive iterations on the
        render seed ``seed``: each launch sums its samples in ascending
        iteration order from zero (a path's radiance, then its escape term),
        and the accumulator adds each launch's sum. ``stats`` (a dict)
        receives the work counted per kind of event; a launch traces its
        primary hits once."""
        seed = rng.kernel_seed(seed)
        scene, dtype = self.scene, self.dtype
        dev = pixel_ids.device
        px = Pixels(scene, pixel_ids, dtype)
        cam = scene.cam.tolist()
        base_dir = _raygen(cam, scene.width, scene.height, px.fx, px.fy)
        o = torch.tensor(cam[:3], dtype=dtype, device=dev)
        primary = (base_dir, intersect(scene, o[0], o[1], o[2], *base_dir, dtype))
        n = pixel_ids.shape[0]
        first = launches[0][0]
        total = sum(k for _b, k in launches)
        ends = set()
        for b, k in launches:
            ends.add(b + k - first)
            _count(stats, "primary", torch.ones(n, dtype=torch.bool))
        env = rows = None
        if self.env is not None:
            env = self.env_tables
            rows = envmap.nee_rows(self.env, seed, first, total, scene.trace_depth).to(dtype)
        accum = torch.zeros((n, 3), dtype=torch.float32, device=dev)
        acc = torch.zeros((n, 3), dtype=dtype, device=dev)
        group = max(1, BATCH // max(n, 1))
        for start in range(0, total, group):
            stop = min(total, start + group)
            its = first + torch.arange(start, stop, dtype=torch.int64, device=dev)[:, None]
            path, escape = _trace(scene, env, seed, its, px, primary, rows, first, dtype, stats)
            for s in range(stop - start):
                acc = acc + path[s]
                if escape is not None:
                    acc = acc + escape[s]
                if start + s + 1 in ends:
                    accum = accum + acc.to(torch.float32)
                    acc = torch.zeros_like(acc)
        return accum


def estimator(config: dict, dtype=torch.float32, device="cpu") -> Estimator:
    """The estimator of a configuration: its scene text and, under an
    ``envmap`` entry, the generated map."""
    env = None
    if "envmap" in config:
        env = envmap.build(meadow(config["envmap"]["height"]), config["envmap"]["strength"],
                           device)
    return Estimator(load("\n".join(config["scene"])), env, dtype)
