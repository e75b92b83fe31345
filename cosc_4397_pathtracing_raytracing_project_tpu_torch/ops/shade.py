"""The per-bounce shade/extend stage (`shadeAndExtendRays`,
`src/pathtrace.cu:336-437`) as a masked-wavefront function: the reference
pipeline's shading.

Port of the JAX package's ``ops/shade.py``. Where the reference returns
early per thread, every branch is computed for every lane and blended with
``where`` masks. The reference's quirks are kept for image-level parity:

- in ``throughput`` mode the sky factor multiplies in on every depth at
  which the stored ray misses, dead lanes included (`pathtrace.cu:356-365`);
- Russian roulette starts strictly after depth ``rr_start_depth``
  (`pathtrace.cu:381-388`);
- the uniforms are consumed in the same roles (roulette, branch select, two
  to three direction draws);
- ``hasRefractive`` serves as ``1 - roughness`` of the glossy cone
  (`pathtrace.cu:400`), and the tint is the specular color on the mirror
  path and the albedo on the diffuse path.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..scene.structs import Materials
from . import envmap as envmap_ops
from . import linalg, rng, sampling
from .intersect import Hit, take_rows

_ORIGIN_OFFSET = 1e-3  # self-intersection offset (`pathtrace.cu:418,431`)
_INV_PI = 0.3183098861837907


@dataclasses.dataclass
class PathState:
    """SoA PathSegment (`sceneStructs.h:67-72`)."""

    origin: torch.Tensor  # (N, 3) f32
    direction: torch.Tensor  # (N, 3) f32
    color: torch.Tensor  # (N, 3) f32 throughput
    bounces: torch.Tensor  # (N,) i32 remaining bounces

    @property
    def alive(self) -> torch.Tensor:
        return self.bounces > 0


def init_paths(origins: torch.Tensor, directions: torch.Tensor, trace_depth: int) -> PathState:
    n = origins.shape[0]
    dev = origins.device
    return PathState(
        origin=origins,
        direction=directions,
        color=torch.ones((n, 3), dtype=torch.float32, device=dev),
        bounces=torch.full((n,), trace_depth, dtype=torch.int32, device=dev),
    )


def _gather_materials(materials: Materials, material_id: torch.Tensor, with_ior: bool = False):
    """Per-lane material rows of the packed table [M, 9|10]: color(3) |
    specular_color(3) | reflectivity | refractive | emittance | [ior]."""
    cols = [
        materials.color,
        materials.specular_color,
        materials.reflectivity[:, None],
        materials.refractive[:, None],
        materials.emittance[:, None],
    ]
    if with_ior:
        cols.append(materials.ior[:, None])
    rows = take_rows(torch.cat(cols, dim=1), material_id)
    out = {
        "color": rows[:, 0:3],
        "specular_color": rows[:, 3:6],
        "reflectivity": rows[:, 6],
        "refractive": rows[:, 7],
        "emittance": rows[:, 8],
    }
    if with_ior:
        out["ior"] = rows[:, 9]
    return out


def shade_step(
    paths: PathState,
    hit: Hit,
    materials: Materials,
    uniforms: torch.Tensor,
    depth: int,
    rr_start_depth: int = 3,
    gather_mode: str = "throughput",
    sky_strength: float = 1.0,
    enable_refraction: bool = False,
    nee=None,
    prev_pdf: torch.Tensor = None,
    env=None,
    env_nee=None,
):
    """One masked shade/extend pass (the JAX ``shade_step``). Returns
    ``(new_paths, radiance_contrib)``, or with ``nee`` (a
    :class:`~.lights.NEEInputs`) or ``env_nee`` (an
    :class:`~.envmap.EnvNEEInputs`) ``(new_paths, radiance_contrib,
    prev_pdf_next)``: direct light is sampled at every diffuse-capable
    vertex and weighed against BRDF sampling by the balance heuristic.
    ``prev_pdf`` is the solid-angle density with which the previous
    vertex's diffuse lobe generated this ray (−1 for primary, specular and
    glass rays, which keep MIS weight 1). ``uniforms`` is [N,
    rng.NUM_LANES]; ``depth`` the 0-based bounce. ``env`` (an
    ``ops.envmap.EnvMap``) replaces the gradient sky with the map's lookup.

    ``gather_mode`` selects the estimator: ``"throughput"`` (the reference
    code: misses multiply the sky in on every depth, the caller adds every
    path's final ``paths.color``, ``radiance_contrib`` stays zero) or
    ``"light_only"`` (a path adds ``throughput × emittance × color`` at an
    emissive hit and ``throughput × sky × sky_strength`` once when it
    escapes; RR keeps its 1/p compensation)."""
    u_rr = uniforms[:, rng.U_RR]
    u_branch = uniforms[:, rng.U_BRANCH]
    u_a = uniforms[:, rng.U_A]
    u_b = uniforms[:, rng.U_B]
    u_c = uniforms[:, rng.U_C]

    if gather_mode not in ("throughput", "light_only"):
        raise ValueError(f"unknown gather_mode {gather_mode!r}")
    legacy = gather_mode == "throughput"
    if (nee is not None or env_nee is not None) and legacy:
        raise ValueError("nee requires gather_mode='light_only'")
    carry_pdf = nee is not None or env_nee is not None

    alive = paths.alive
    missed = hit.miss
    contrib = torch.zeros_like(paths.color)

    # miss / dead early-out (`pathtrace.cu:356-365`)
    if env is not None:
        sky = envmap_ops.env_radiance(env, paths.direction)
    else:
        sky = sampling.sky_color(paths.direction)
    if legacy:
        # the sky multiplies on every miss, dead lanes included
        color = torch.where(missed[:, None], paths.color * sky, paths.color)
    else:
        # an escaping path adds the environment radiance once, while alive
        color = paths.color
        if env is not None:
            esc = color * sky
            if env_nee is not None:
                # MIS partner of env importance sampling
                p_env = envmap_ops.env_pdf(env, paths.direction)
                w_esc = torch.where(
                    prev_pdf < 0.0, 1.0, prev_pdf / torch.clamp_min(prev_pdf + p_env, 1e-20)
                )
                esc = esc * w_esc[:, None]
            contrib = torch.where((missed & alive)[:, None], esc, contrib)
        elif sky_strength:
            contrib = torch.where(
                (missed & alive)[:, None], color * sky * float(np.float32(sky_strength)),
                contrib,
            )
    act = ~(missed | ~alive)

    mat = _gather_materials(materials, hit.material_id, enable_refraction)

    # emissive termination (`pathtrace.cu:374-378`)
    emissive = mat["emittance"] > 0.0
    hit_light = act & emissive
    light_radiance = color * mat["color"] * mat["emittance"][:, None]
    if nee is not None:
        # balance heuristic: a BRDF-sampled emissive hit reached via the
        # previous vertex's diffuse lobe competes with NEE having sampled
        # the same point (both densities in solid angle there)
        p_nee_area, sampled = nee.sampler.area_pdf_at(hit.geom_index, hit.normal)
        cos_l = torch.clamp_min(-linalg.dot(paths.direction, hit.normal), 1e-6)
        p_nee_dir = p_nee_area * hit.t * hit.t / cos_l
        w_emit = torch.where(
            (prev_pdf < 0.0) | ~sampled,
            1.0,
            prev_pdf / torch.clamp_min(prev_pdf + p_nee_dir, 1e-20),
        )
        light_radiance = light_radiance * w_emit[:, None]
    if legacy:
        color = torch.where(hit_light[:, None], light_radiance, color)
    else:
        contrib = torch.where(hit_light[:, None], light_radiance, contrib)
    act = act & ~emissive

    # Russian roulette after rr_start_depth (`pathtrace.cu:381-388`)
    rr_on = int(depth) > rr_start_depth
    p_continue = mat["color"].max(dim=-1).values
    rr_kill = act & rr_on & (u_rr > p_continue)
    rr_survive = act & rr_on & ~rr_kill
    color = torch.where(
        rr_survive[:, None], color / torch.clamp_min(p_continue, 1e-12)[:, None], color
    )
    act = act & ~rr_kill

    # scatter (`pathtrace.cu:394-436`)
    reflectivity = mat["reflectivity"]
    roughness = 1.0 - mat["refractive"]
    spec = act & (reflectivity > 0.0) & (u_branch < reflectivity)
    glass_mask = torch.zeros_like(act)

    spec_dir = sampling.perturbed_specular(paths.direction, hit.normal, roughness, u_a, u_c)
    diff_dir = sampling.cosine_weighted_hemisphere(u_a, u_b, hit.normal)
    new_dir = torch.where(spec[:, None], spec_dir, diff_dir)
    tint = torch.where(spec[:, None], mat["specular_color"], mat["color"])
    new_origin = hit.point + hit.normal * _ORIGIN_OFFSET

    if enable_refraction:
        # dielectric transmission: Snell + Schlick Fresnel; a material
        # refracts when ior > 0 and hasRefractive > 0
        is_glass = (mat["ior"] > 0.0) & (mat["refractive"] > 0.0)
        n = hit.normal  # already faces the incoming ray
        cos_i = torch.clamp(-linalg.dot(paths.direction, n), 0.0, 1.0)
        n1 = torch.where(hit.outside, 1.0, mat["ior"])
        n2 = torch.where(hit.outside, mat["ior"], 1.0)
        eta = n1 / torch.clamp_min(n2, 1e-6)
        sin2_t = eta * eta * torch.clamp_min(1.0 - cos_i * cos_i, 0.0)
        tir = sin2_t > 1.0
        cos_t = torch.sqrt(torch.clamp_min(1.0 - sin2_t, 0.0))
        fresnel = sampling.schlick_fresnel(cos_i, n1, n2)
        refract_dir = linalg.normalize(
            eta[:, None] * paths.direction + (eta * cos_i - cos_t)[:, None] * n, eps=1e-20
        )
        reflect_dir = linalg.reflect(paths.direction, n)
        transmit = is_glass & ~tir & (u_branch >= fresnel)
        glass_dir = torch.where(transmit[:, None], refract_dir, reflect_dir)
        glass_origin = torch.where(
            transmit[:, None],
            hit.point - n * _ORIGIN_OFFSET,  # step through the interface
            hit.point + n * _ORIGIN_OFFSET,
        )
        glass_mask = act & is_glass
        new_dir = torch.where(glass_mask[:, None], glass_dir, new_dir)
        new_origin = torch.where(glass_mask[:, None], glass_origin, new_origin)
        tint = torch.where(
            glass_mask[:, None],
            torch.where(transmit[:, None], mat["color"], mat["specular_color"]),
            tint,
        )

    if nee is not None:
        # direct light at this vertex: the diffuse component of the mixture
        # BRDF, (1−P_spec)·albedo/π, for every diffuse-capable lane; `color`
        # is the post-RR, pre-tint throughput
        base = act & ~glass_mask
        sx = hit.point + hit.normal * _ORIGIN_OFFSET
        lp, ln, pdf_a, le = nee.sampler.sample(nee.uniforms)
        to_l = lp - sx
        dist = linalg.norm(to_l)
        wi = to_l / torch.clamp_min(dist, 1e-12)[:, None]
        cos_s = linalg.dot(hit.normal, wi)
        cos_l = linalg.dot(ln, -wi)
        facing = (cos_s > 0.0) & (cos_l > 0.0) & (dist > 1e-4)
        sh = nee.shadow_isect(sx, wi)
        # the sampled point itself is hit at ~dist (less the backoff)
        visible = sh.t >= dist - torch.clamp_min(1e-3 * dist, 1e-3)
        diffuse_prob = 1.0 - reflectivity
        w_diff = diffuse_prob[:, None] * mat["color"] * _INV_PI
        p_brdf_area = (
            diffuse_prob * torch.clamp_min(cos_s, 0.0) * _INV_PI
            * torch.clamp_min(cos_l, 0.0) / torch.clamp_min(dist * dist, 1e-12)
        )
        w_mis = pdf_a / torch.clamp_min(pdf_a + p_brdf_area, 1e-20)
        geom = cos_s * cos_l / torch.clamp_min(dist * dist * pdf_a, 1e-20)
        direct = color * w_diff * (geom * w_mis)[:, None] * le
        contrib = torch.where((base & facing & visible)[:, None], contrib + direct, contrib)

    if env_nee is not None:
        # direct environment light: the light pdf in solid angle, visibility
        # = the shadow ray escapes the scene, its own MIS pair against BRDF
        # sampling
        base = act & ~glass_mask
        sx = hit.point + hit.normal * _ORIGIN_OFFSET
        wi, _, pdf_e = envmap_ops.sample_env(
            env_nee.env, env_nee.uniforms[:, 0], env_nee.uniforms[:, 1], env_nee.cell_words
        )
        # both techniques integrate the same bilinear L as the miss path
        le = envmap_ops.env_radiance(env_nee.env, wi)
        cos_s = linalg.dot(hit.normal, wi)
        sh = env_nee.shadow_isect(sx, wi)
        visible = sh.miss
        diffuse_prob = 1.0 - reflectivity
        w_diff = diffuse_prob[:, None] * mat["color"] * _INV_PI
        p_brdf = diffuse_prob * torch.clamp_min(cos_s, 0.0) * _INV_PI
        w_mis = pdf_e / torch.clamp_min(pdf_e + p_brdf, 1e-20)
        direct = color * w_diff * (
            torch.clamp_min(cos_s, 0.0) / torch.clamp_min(pdf_e, 1e-20) * w_mis
        )[:, None] * le
        contrib = torch.where((base & (cos_s > 0.0) & visible)[:, None], contrib + direct,
                              contrib)

    color = torch.where(act[:, None], color * tint, color)
    origin = torch.where(act[:, None], new_origin, paths.origin)
    direction = torch.where(act[:, None], new_dir, paths.direction)
    bounces = torch.where(act, paths.bounces - 1, torch.zeros_like(paths.bounces))

    new_paths = PathState(origin=origin, direction=direction, color=color, bounces=bounces)
    if carry_pdf:
        # density with which this vertex's lobe choice generated the
        # extension ray: diffuse lanes (1−P)·cosθ/π, specular and glass −1
        cos_new = torch.clamp_min(linalg.dot(new_dir, hit.normal), 0.0)
        diffuse_ext = act & ~spec & ~glass_mask
        pdf_next = torch.where(diffuse_ext, (1.0 - reflectivity) * cos_new * _INV_PI, -1.0)
        return new_paths, contrib, pdf_next
    return new_paths, contrib
