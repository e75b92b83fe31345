"""Scene data model.

Host side: the plain-dataclass ``SceneDesc`` built by the parser (NumPy
arrays), identical to the JAX package's. Device side: plain dataclasses of
torch tensors on one explicit device, in the same structure-of-arrays layout
as the JAX package's flax pytrees: geometry is partitioned by primitive type
(cubes / spheres) at build time.

An ENVIRONMENT block becomes ``Scene.envmap``, an ``ops.envmap.EnvMap`` on
the scene's device. Triangle meshes (``mesh`` objects, already in world space
after parsing) become ``Scene.triangles``, a :class:`TriangleBatch` of
``v0``/``e1``/``e2`` rows, as the JAX package's ``Scene.from_desc`` builds
it; a scene without meshes carries an empty batch.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from . import transforms

# Primitive type ids (reference enum GeomType, `src/sceneStructs.h:10-13`)
CUBE = 0
SPHERE = 1
TRIANGLE = 2  # extension: triangle meshes


# ─────────────────────────── host-side description ───────────────────────────


@dataclasses.dataclass
class CameraDesc:
    """Raw camera parameters as parsed (`src/scene.cpp:92-151`)."""

    resolution: Tuple[int, int]  # (width, height)
    fovy_deg: float
    eye: np.ndarray  # (3,)
    lookat: np.ndarray  # (3,)
    up: np.ndarray  # (3,)
    # thin-lens depth of field: aperture = lens radius in world units
    # (0 = pinhole); focal = focal-plane distance along view (≤0 = auto:
    # focus on LOOKAT).
    aperture: float = 0.0
    focal: float = 0.0


@dataclasses.dataclass
class SceneDesc:
    """Host-side parsed scene: NumPy SoA + render settings.

    Produced by :mod:`.parser`; converted to device tensors by
    :meth:`Scene.from_desc`.
    """

    # geometry (G entries)
    geom_type: np.ndarray  # (G,) int32
    material_id: np.ndarray  # (G,) int32
    translation: np.ndarray  # (G, 3)
    rotation: np.ndarray  # (G, 3) degrees
    scale: np.ndarray  # (G, 3)
    transform: np.ndarray  # (G, 4, 4)
    inv_transform: np.ndarray  # (G, 4, 4)
    inv_transpose: np.ndarray  # (G, 4, 4)
    # materials (M entries) — fields per `src/sceneStructs.h:38-49`
    color: np.ndarray  # (M, 3)
    specular_exponent: np.ndarray  # (M,)
    specular_color: np.ndarray  # (M, 3)
    reflectivity: np.ndarray  # (M,)  "hasReflective": mirror-branch probability
    refractive: np.ndarray  # (M,)   "hasRefractive": 1 - roughness in reference
    ior: np.ndarray  # (M,)
    emittance: np.ndarray  # (M,)
    # camera + run settings (CAMERA block, `src/scene.cpp:99-115`)
    camera: CameraDesc = None
    iterations: int = 0
    trace_depth: int = 8
    image_name: str = "render"
    # triangle mesh extension (empty for reference-format scenes)
    tri_vertices: Optional[np.ndarray] = None  # (T, 3, 3) world-space
    tri_material_id: Optional[np.ndarray] = None  # (T,) int32
    # environment-map extension (ENVIRONMENT block)
    env_image: Optional[np.ndarray] = None  # (H, W, 3) f32 linear radiance
    env_strength: float = 1.0

    @property
    def num_geoms(self) -> int:
        return int(self.geom_type.shape[0])

    @property
    def num_materials(self) -> int:
        return int(self.color.shape[0])

    @property
    def num_triangles(self) -> int:
        return 0 if self.tri_vertices is None else int(self.tri_vertices.shape[0])


# ─────────────────────────── device-side tensors ───────────────────────────


@dataclasses.dataclass
class Materials:
    """SoA material table, one row per material (`src/sceneStructs.h:38-49`)."""

    color: torch.Tensor  # (M, 3) f32
    specular_color: torch.Tensor  # (M, 3) f32
    specular_exponent: torch.Tensor  # (M,) f32
    reflectivity: torch.Tensor  # (M,) f32
    refractive: torch.Tensor  # (M,) f32
    ior: torch.Tensor  # (M,) f32
    emittance: torch.Tensor  # (M,) f32


@dataclasses.dataclass
class GeomBatch:
    """A dense batch of same-type primitives (all cubes or all spheres)."""

    material_id: torch.Tensor  # (K,) i32
    geom_index: torch.Tensor  # (K,) i32 — original scene OBJECT index
    transform: torch.Tensor  # (K, 4, 4) f32
    inv_transform: torch.Tensor  # (K, 4, 4) f32
    inv_transpose: torch.Tensor  # (K, 4, 4) f32

    @property
    def count(self) -> int:
        return int(self.material_id.shape[0])


@dataclasses.dataclass
class TriangleBatch:
    """World-space triangle soup (the mesh extension; the reference declares
    triangle fields in `sceneStructs.h:30-35` but never fills them)."""

    v0: torch.Tensor  # (T, 3) f32
    e1: torch.Tensor  # (T, 3) f32, v1 - v0
    e2: torch.Tensor  # (T, 3) f32, v2 - v0
    normal: torch.Tensor  # (T, 3) f32, unit geometric normal
    material_id: torch.Tensor  # (T,) i32
    geom_index: torch.Tensor  # (T,) i32, num_geoms + triangle index

    @property
    def count(self) -> int:
        return int(self.material_id.shape[0])

    @classmethod
    def empty(cls, device) -> "TriangleBatch":
        z3 = torch.zeros((0, 3), dtype=torch.float32, device=device)
        zi = torch.zeros((0,), dtype=torch.int32, device=device)
        return cls(v0=z3, e1=z3, e2=z3, normal=z3, material_id=zi, geom_index=zi)


@dataclasses.dataclass
class Camera:
    """Derived render camera (tensors on the scene's device)."""

    position: torch.Tensor  # (3,)
    view: torch.Tensor  # (3,)
    up: torch.Tensor  # (3,)
    right: torch.Tensor  # (3,)
    pixel_length: torch.Tensor  # (2,)
    resolution: Tuple[int, int]  # (width, height)
    aperture: torch.Tensor  # () lens radius, 0 = pinhole
    focal: torch.Tensor  # () focal-plane distance

    @property
    def width(self) -> int:
        return self.resolution[0]

    @property
    def height(self) -> int:
        return self.resolution[1]

    @property
    def pixel_count(self) -> int:
        return self.resolution[0] * self.resolution[1]


@dataclasses.dataclass
class Scene:
    """Full device scene: partitioned analytic geometry, the triangle soup
    (None counts as empty), materials, camera, and the environment map
    (None = the reference's gradient sky)."""

    cubes: GeomBatch
    spheres: GeomBatch
    materials: Materials
    camera: Camera
    envmap: Optional[object] = None  # ops.envmap.EnvMap
    triangles: Optional[TriangleBatch] = None

    @property
    def device(self) -> torch.device:
        return self.materials.color.device

    @property
    def num_primitives(self) -> int:
        return self.cubes.count + self.spheres.count

    @property
    def num_triangles(self) -> int:
        return 0 if self.triangles is None else self.triangles.count

    def replace(self, **changes) -> "Scene":
        return dataclasses.replace(self, **changes)

    @classmethod
    def from_desc(cls, desc: SceneDesc, device) -> "Scene":
        device = torch.device(device)

        def f32(a):
            return torch.as_tensor(np.asarray(a, np.float32), device=device)

        def i32(a):
            return torch.as_tensor(np.asarray(a, np.int32), device=device)

        def batch(type_id: int) -> GeomBatch:
            sel = np.nonzero(desc.geom_type == type_id)[0]
            return GeomBatch(
                material_id=i32(desc.material_id[sel]),
                geom_index=i32(sel),
                transform=f32(desc.transform[sel]),
                inv_transform=f32(desc.inv_transform[sel]),
                inv_transpose=f32(desc.inv_transpose[sel]),
            )

        materials = Materials(
            color=f32(desc.color),
            specular_color=f32(desc.specular_color),
            specular_exponent=f32(desc.specular_exponent),
            reflectivity=f32(desc.reflectivity),
            refractive=f32(desc.refractive),
            ior=f32(desc.ior),
            emittance=f32(desc.emittance),
        )
        tris = TriangleBatch.empty(device)
        if desc.num_triangles:
            # the JAX Scene.from_desc's float32 edges and normalized normals
            v = np.asarray(desc.tri_vertices, np.float32)
            e1 = v[:, 1] - v[:, 0]
            e2 = v[:, 2] - v[:, 0]
            n = np.cross(e1, e2)
            n /= np.maximum(np.linalg.norm(n, axis=-1, keepdims=True), 1e-20)
            tris = TriangleBatch(
                v0=f32(v[:, 0]),
                e1=f32(e1),
                e2=f32(e2),
                normal=f32(n),
                material_id=i32(desc.tri_material_id),
                geom_index=i32(desc.num_geoms + np.arange(desc.num_triangles)),
            )
        env = None
        if desc.env_image is not None:
            from ..ops.envmap import build_envmap

            env = build_envmap(desc.env_image, desc.env_strength, device)
        return cls(
            cubes=batch(CUBE),
            spheres=batch(SPHERE),
            materials=materials,
            camera=derive_camera(desc.camera, device),
            envmap=env,
            triangles=tris,
        )


def derive_camera(desc: CameraDesc, device) -> Camera:
    """Build the render camera exactly as the reference's first frame.

    The reference decomposes EYE/LOOKAT into spherical (zoom, phi, theta)
    (`src/main.cpp:64-71`) and rebuilds the basis before the first frame
    (`src/main.cpp:110-128` — `camchanged` starts true), so the *effective*
    camera is the spherical reconstruction, not the raw file values. The
    pixel-length derivation follows `src/scene.cpp:133-140`, including its
    use of tan(fovy) rather than tan(fovy/2).
    """
    zoom, phi, theta = spherical_from_view(desc.eye, desc.lookat)
    position, view, up, right = camera_basis_from_spherical(
        zoom, phi, theta, desc.lookat
    )
    w, h = desc.resolution
    yscaled = np.tan(np.float64(desc.fovy_deg) * np.pi / 180.0)
    xscaled = yscaled * w / h
    pixel_length = np.array([2 * xscaled / w, 2 * yscaled / h], dtype=np.float32)

    def f32(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)

    return Camera(
        position=f32(position),
        view=f32(view),
        up=f32(up),
        right=f32(right),
        pixel_length=f32(pixel_length),
        resolution=(int(w), int(h)),
        aperture=f32(float(desc.aperture)),
        # auto-focus: FOCAL ≤ 0 focuses on LOOKAT (zoom is exactly
        # |eye − lookat|, and view points at lookat)
        focal=f32(float(desc.focal) if desc.focal > 0 else float(zoom)),
    )


def spherical_from_view(eye, lookat):
    """(zoom, phi, theta) such that `camera_basis_from_spherical` reproduces
    the eye exactly.

    Deliberate fix of a reference bug: `src/main.cpp:64-71` decomposes via
    acos of *projected view* components, which mirrors any pitched camera
    (eye.y ≠ lookat.y) about the lookat plane on the first frame. The
    correct inverse of the reconstruction (`main.cpp:113-115`,
    offset = zoom·(sinφ·sinθ, cosθ, cosφ·sinθ)) is used instead; it is
    identical for level cameras (theta = π/2)."""
    eye = np.asarray(eye, np.float64)
    lookat = np.asarray(lookat, np.float64)
    offset = eye - lookat
    zoom = np.linalg.norm(offset)
    if zoom < 1e-12:
        return 0.0, 0.0, float(np.pi / 2)
    theta = np.arccos(np.clip(offset[1] / zoom, -1.0, 1.0))
    phi = np.arctan2(offset[0], offset[2])
    return float(zoom), float(phi), float(theta)


def camera_basis_from_spherical(zoom, phi, theta, lookat):
    """Rebuild (position, view, up, right) per `src/main.cpp:110-126`."""
    lookat = np.asarray(lookat, np.float64)
    cam_pos = zoom * np.array(
        [np.sin(phi) * np.sin(theta), np.cos(theta), np.cos(phi) * np.sin(theta)]
    )
    view = -cam_pos / np.linalg.norm(cam_pos)
    u = np.array([0.0, 1.0, 0.0])
    right = np.cross(view, u)
    up = np.cross(right, view)
    position = cam_pos + lookat
    return (
        position.astype(np.float32),
        view.astype(np.float32),
        up.astype(np.float32),
        right.astype(np.float32),
    )


def desc_world_aabbs(desc: SceneDesc):
    """Per-geom world AABBs (8-corner method, `src/pathtrace.cu:34-50`),
    extended with exact triangle bounds for mesh scenes: ``(mins, maxs)``,
    float32 ``(G + T, 3)`` each (the JAX ``desc_world_aabbs``)."""
    n = desc.num_geoms
    mins = np.zeros((n, 3), np.float32)
    maxs = np.zeros((n, 3), np.float32)
    for i in range(n):
        mins[i], maxs[i] = transforms.unit_cube_world_aabb(desc.transform[i])
    if desc.num_triangles:
        tmins = desc.tri_vertices.min(axis=1)
        tmaxs = desc.tri_vertices.max(axis=1)
        mins = np.concatenate([mins, tmins.astype(np.float32)], axis=0)
        maxs = np.concatenate([maxs, tmaxs.astype(np.float32)], axis=0)
    return mins, maxs
