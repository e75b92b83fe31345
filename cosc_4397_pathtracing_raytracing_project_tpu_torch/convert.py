"""Carry a scene or a partial render over from the JAX package.

The JAX package's ``Scene`` and ``RenderState`` are pytrees; handed over as
their leaves in NumPy, they become this port's tensors on one device, so both
packages can render the same scene and continue the same render. Nothing
here imports jax: the caller converts the leaves (``np.asarray``).
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from .render.state import RenderState, kernel_seed
from .scene.structs import Camera, GeomBatch, Materials, Scene

_BATCH_FIELDS = ("material_id", "geom_index", "transform", "inv_transform", "inv_transpose")
_MATERIAL_FIELDS = (
    "color", "specular_color", "specular_exponent", "reflectivity",
    "refractive", "ior", "emittance",
)
_CAMERA_FIELDS = ("position", "view", "up", "right", "pixel_length", "aperture", "focal")


def scene_from_jax_arrays(d: Mapping, device) -> Scene:
    """Build a :class:`Scene` from the JAX ``Scene``'s leaves.

    ``d`` is nested like the JAX pytree: ``d["cubes"]`` and ``d["spheres"]``
    map each ``GeomBatch`` field to an array, ``d["materials"]`` each
    ``Materials`` field, and ``d["camera"]`` each ``Camera`` field plus
    ``"resolution"`` (width, height). A non-empty ``d["triangles"]`` or an
    ``d["envmap"]`` raises ``NotImplementedError``: this port does not render
    them yet."""
    tris = d.get("triangles")
    if tris is not None and np.asarray(tris["material_id"]).shape[0]:
        raise NotImplementedError(
            "triangle meshes are not ported yet (ROADMAP Queue 1 item 12)"
        )
    if d.get("envmap") is not None:
        raise NotImplementedError(
            "ENVIRONMENT maps are not ported yet (ROADMAP Queue 1 item 11)"
        )
    device = torch.device(device)

    def tensor(a, dtype):
        return torch.tensor(np.asarray(a, dtype), device=device)

    def batch(b) -> GeomBatch:
        return GeomBatch(
            **{
                f: tensor(b[f], np.int32 if f in ("material_id", "geom_index") else np.float32)
                for f in _BATCH_FIELDS
            }
        )

    cam = d["camera"]
    w, h = (int(v) for v in cam["resolution"])
    return Scene(
        cubes=batch(d["cubes"]),
        spheres=batch(d["spheres"]),
        materials=Materials(**{f: tensor(d["materials"][f], np.float32) for f in _MATERIAL_FIELDS}),
        camera=Camera(
            resolution=(w, h),
            **{f: tensor(cam[f], np.float32) for f in _CAMERA_FIELDS},
        ),
    )


def state_from_jax_arrays(accum, iteration, key_data, device) -> RenderState:
    """Build a :class:`RenderState` from the JAX ``RenderState``'s leaves:
    the accumulator, the iteration count and ``jax.random.key_data`` of its
    key. The kernel seed is ``int32(key_data[-1])``, as the JAX step derives
    it."""
    last = int(np.asarray(key_data).reshape(-1)[-1].astype(np.uint32))
    return RenderState(
        accum=torch.tensor(np.asarray(accum, np.float32), device=torch.device(device)),
        iteration=int(iteration),
        seed=kernel_seed(last),
    )
