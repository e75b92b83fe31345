"""Carry a scene or a partial render over from the JAX package.

The JAX package's ``Scene`` and ``RenderState`` are pytrees; handed over as
their leaves in NumPy, they become this port's tensors on one device, so both
packages can render the same scene and continue the same render. Nothing
here imports jax: the caller converts the leaves (``np.asarray``), or, for an
adaptive render, hands over the JAX ``AdaptiveRenderer`` itself, whose
arrays convert with ``np.asarray``.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from .ops.envmap import EnvMap
from .render.state import RenderState, kernel_seed
from .scene.structs import Camera, GeomBatch, Materials, Scene, TriangleBatch

_BATCH_FIELDS = ("material_id", "geom_index", "transform", "inv_transform", "inv_transpose")
_MATERIAL_FIELDS = (
    "color", "specular_color", "specular_exponent", "reflectivity",
    "refractive", "ior", "emittance",
)
_TRIANGLE_FIELDS = ("v0", "e1", "e2", "normal", "material_id", "geom_index")
_CAMERA_FIELDS = ("position", "view", "up", "right", "pixel_length", "aperture", "focal")


def scene_from_jax_arrays(d: Mapping, device) -> Scene:
    """Build a :class:`Scene` from the JAX ``Scene``'s leaves.

    ``d`` is nested like the JAX pytree: ``d["cubes"]`` and ``d["spheres"]``
    map each ``GeomBatch`` field to an array, ``d["materials"]`` each
    ``Materials`` field, and ``d["camera"]`` each ``Camera`` field plus
    ``"resolution"`` (width, height). ``d["envmap"]``, if not None, is the
    JAX ``EnvMap`` (or a mapping of its fields ``img``, ``alias_prob``,
    ``alias_idx``, ``pdf``, ``strength``); its arrays carry over unchanged.
    ``d["triangles"]``, if given with a non-empty ``material_id``, maps each
    ``TriangleBatch`` field to an array; otherwise the scene holds no
    triangles."""
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

    tris = d.get("triangles")
    if tris is not None and np.asarray(tris["material_id"]).shape[0]:
        tris = TriangleBatch(**{
            f: tensor(tris[f], np.int32 if f in ("material_id", "geom_index") else np.float32)
            for f in _TRIANGLE_FIELDS
        })
    else:
        tris = TriangleBatch.empty(device)
    env = d.get("envmap")
    if env is not None:
        fields = env if isinstance(env, Mapping) else vars(env)
        env = EnvMap(
            img=tensor(fields["img"], np.float32),
            alias_prob=tensor(fields["alias_prob"], np.float32),
            alias_idx=tensor(fields["alias_idx"], np.int32),
            pdf=tensor(fields["pdf"], np.float32),
            strength=tensor(fields["strength"], np.float32),
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
        envmap=env,
        triangles=tris,
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


def adaptive_state_from_jax(renderer, device) -> dict:
    """The state of a JAX ``AdaptiveRenderer`` as this port's tensors on
    ``device``: the half-buffer accumulators ``acc_a``/``acc_b`` [n+1, 3]
    f32, the per-tile sample counts ``counts`` [T+1] i32, the int32 kernel
    ``seed`` and the dispatched-lane count ``budget_spent``. A port
    ``AdaptiveRenderer`` of the same scene and configuration continues the
    JAX render from it (``AdaptiveRenderer.load_state``)."""
    device = torch.device(device)

    def tensor(a, dtype):
        return torch.tensor(np.asarray(a, dtype), device=device)

    return {
        "acc_a": tensor(renderer._acc_a, np.float32),
        "acc_b": tensor(renderer._acc_b, np.float32),
        "counts": tensor(renderer._counts, np.int32),
        "seed": kernel_seed(int(np.asarray(renderer._seed).astype(np.int64))),
        "budget_spent": int(renderer._lane_budget_spent),
    }
