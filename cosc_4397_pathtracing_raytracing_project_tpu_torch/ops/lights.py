"""Direct light sampling (next-event estimation) over the analytic emitters.

Port of the JAX package's ``ops/lights.py`` (``LightSampler``, ``_det3``,
``make_light_sampler``): area sampling over the emissive cubes and spheres
as dense ``[N]`` tensor math, uniform over each primitive's *object-space*
surface, with the world-space area density from the local area scale of the
affine transform, ``s(x) = |det A| · |A⁻ᵀ·n̂_obj|``. The mesh pipeline
(``ops/fast.trace_sample_mesh``) samples these lights at every vertex and
weighs its emissive hits against them with the balance heuristic; emissive
triangles stay BRDF-sampled. :class:`NEEInputs` carries a bounce's light
sampler, shadow intersector and uniforms into the reference pipeline's
``shade_step``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from . import linalg

_TWO_PI = 6.2831853071795864
_INV_PI = 0.3183098861837907
# object-space area pdfs, rounded to float32 as the JAX module's constants
_PDF_SPHERE = float(np.float32(_INV_PI))
_PDF_CUBE = float(np.float32(1.0 / 6.0))


@dataclasses.dataclass(frozen=True)
class LightSampler:
    """Stacked emissive-primitive table (L analytic lights) on one device."""

    kind: torch.Tensor  # (L,) i32 — 0 cube, 1 sphere
    transform: torch.Tensor  # (L, 4, 4) f32
    inv_transpose: torch.Tensor  # (L, 4, 4) f32
    radiance: torch.Tensor  # (L, 3) f32 — material color × emittance
    geom_index: torch.Tensor  # (L,) i32
    num_lights: int = 0

    def sample(self, u: torch.Tensor):
        """Sample one light point per lane. ``u`` is [N, 3] uniforms (pick,
        surface-a, surface-b). Returns ``(point [N,3], normal [N,3],
        pdf_area [N], radiance [N,3])``, the pdf in world-space area measure
        including the 1/L light-selection factor."""
        ell = self.num_lights
        pick = torch.clamp_max((u[:, 0] * ell).to(torch.int64), ell - 1)
        u_a, u_b = u[:, 1], u[:, 2]
        m = self.transform[pick]
        m_it = self.inv_transpose[pick]
        rad = self.radiance[pick]
        kind = self.kind[pick]

        # cube: uniform over the 6 unit-cube faces (object area 6)
        face = torch.clamp_max((u_a * 6.0).to(torch.int32), 5)
        u_f = u_a * 6.0 - face.to(torch.float32)  # reclaimed face fraction
        axis = face // 2
        sgn = torch.where(face % 2 == 0, 1.0, -1.0)
        a_onehot = (
            torch.arange(3, dtype=torch.int32, device=u.device)[None, :] == axis[:, None]
        ).to(torch.float32)
        # the axis slot gets ±0.5, the other two (in index order) the
        # in-face coordinates (cu, cv)
        cu, cv = u_f - 0.5, u_b - 0.5
        in_face = torch.stack(
            [
                torch.where(axis == 0, 0.0, cu),
                torch.where(axis == 1, 0.0, torch.where(axis == 0, cu, cv)),
                torch.where(axis == 2, 0.0, cv),
            ],
            dim=-1,
        )
        p_cube = a_onehot * (sgn * 0.5)[:, None] + in_face
        n_cube = a_onehot * sgn[:, None]

        # sphere: uniform direction, r = 0.5 (object area π)
        z = 1.0 - 2.0 * u_a
        r_xy = torch.sqrt(torch.clamp_min(1.0 - z * z, 0.0))
        phi = _TWO_PI * u_b
        n_sph = torch.stack([r_xy * torch.cos(phi), z, r_xy * torch.sin(phi)], dim=-1)
        p_sph = 0.5 * n_sph

        is_sphere = (kind == 1)[:, None]
        p_obj = torch.where(is_sphere, p_sph, p_cube)
        n_obj = torch.where(is_sphere, n_sph, n_cube)
        pdf_obj = torch.where(kind == 1, _PDF_SPHERE, _PDF_CUBE)

        point = linalg.transform_point(m, p_obj)
        n_unnorm = linalg.transform_vector(m_it, n_obj)  # cof(A)·n̂ / det(A)
        normal = linalg.normalize(n_unnorm, eps=1e-20)
        # |cof(A)·n̂_obj| = |det(A)| · |A⁻ᵀ·n̂_obj| — local area scale
        scale = torch.abs(_det3(m[:, :3, :3])) * linalg.norm(n_unnorm)
        pdf_area = pdf_obj / (float(ell) * torch.clamp_min(scale, 1e-20))
        return point, normal, pdf_area, rad

    def area_pdf_at(self, geom_index: torch.Tensor, normal_world: torch.Tensor):
        """World-area density this sampler assigns to a point on light
        ``geom_index`` whose surface normal there is ``normal_world`` (the
        MIS counterpart of :meth:`sample`). Returns ``(pdf_area [N],
        sampled [N] bool)``; ``sampled`` is False for geoms this sampler does
        not cover (pdf then 0)."""
        match = geom_index[:, None] == self.geom_index[None, :]
        sampled = match.any(dim=1)
        pick = torch.argmax(match.to(torch.int32), dim=1)  # first match
        a = self.transform[pick][:, :3, :3]
        m_it = self.inv_transpose[pick]
        kind = self.kind[pick]
        # invert the normal transform: n_world ∝ A⁻ᵀ·n_obj ⇒ n̂_obj ∝ Aᵀ·n_world
        n_obj = linalg.normalize(
            linalg.transform_vector(a.transpose(1, 2), normal_world), eps=1e-20
        )
        s = torch.abs(_det3(a)) * linalg.norm(linalg.transform_vector(m_it, n_obj))
        pdf_obj = torch.where(kind == 1, _PDF_SPHERE, _PDF_CUBE)
        pdf = pdf_obj / (float(self.num_lights) * torch.clamp_min(s, 1e-20))
        return torch.where(sampled, pdf, 0.0), sampled


def _det3(a: torch.Tensor) -> torch.Tensor:
    """Determinant of [..., 3, 3] by cofactors along the first row."""
    return (
        a[..., 0, 0] * (a[..., 1, 1] * a[..., 2, 2] - a[..., 1, 2] * a[..., 2, 1])
        - a[..., 0, 1] * (a[..., 1, 0] * a[..., 2, 2] - a[..., 1, 2] * a[..., 2, 0])
        + a[..., 0, 2] * (a[..., 1, 0] * a[..., 2, 1] - a[..., 1, 1] * a[..., 2, 0])
    )


def make_light_sampler(scene) -> Optional[LightSampler]:
    """Collect the emissive analytic geoms of a scene into a sampler on the
    scene's device; None when the scene has no analytic emitter. Raises
    ``ValueError`` on emissive triangles: the mesh pipeline BRDF-samples
    them, and leaving them out of the sampler silently would bias the
    estimator."""
    host = lambda t: t.detach().cpu().numpy()  # noqa: E731
    emit = host(scene.materials.emittance)
    colors = host(scene.materials.color)
    rows = []
    for kind_id, batch in ((0, scene.cubes), (1, scene.spheres)):
        mids = host(batch.material_id)
        tfs, its, gids = host(batch.transform), host(batch.inv_transpose), host(batch.geom_index)
        for i in np.nonzero(emit[mids] > 0.0)[0]:
            rows.append((kind_id, tfs[i], its[i], colors[mids[i]] * emit[mids[i]], int(gids[i])))
    if scene.num_triangles:
        if np.any(emit[host(scene.triangles.material_id)] > 0.0):
            raise ValueError(
                "nee: emissive triangles are not sampleable yet — "
                "use analytic (cube/sphere) lights or disable nee"
            )
    if not rows:
        return None
    kinds, tfs, its, rads, gids = zip(*rows)
    dev = scene.device
    return LightSampler(
        kind=torch.tensor(kinds, dtype=torch.int32, device=dev),
        transform=torch.tensor(np.stack(tfs), dtype=torch.float32, device=dev),
        inv_transpose=torch.tensor(np.stack(its), dtype=torch.float32, device=dev),
        radiance=torch.tensor(np.stack(rads), dtype=torch.float32, device=dev),
        geom_index=torch.tensor(gids, dtype=torch.int32, device=dev),
        num_lights=len(rows),
    )


@dataclasses.dataclass
class NEEInputs:
    """Per-bounce NEE wiring passed into ``ops.shade.shade_step``."""

    sampler: LightSampler
    shadow_isect: Callable  # (origins [N,3], dirs [N,3]) -> Hit
    uniforms: torch.Tensor  # [N, 3]: light pick + 2 surface coords
