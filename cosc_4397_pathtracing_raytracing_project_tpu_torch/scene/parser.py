"""Parser for the reference's text scene format (`src/scene.cpp`).

Grammar (line-oriented, whitespace-tokenized, CRLF-safe):

- ``MATERIAL <id>`` then exactly 7 property lines
  ``RGB/SPECEX/SPECRGB/REFL/REFR/REFRIOR/EMITTANCE`` (`scene.cpp:163-183`).
- ``CAMERA`` then 5 property lines ``RES/FOVY/ITERATIONS/DEPTH/FILE``
  followed by ``EYE/LOOKAT/UP`` lines until a blank line (`scene.cpp:99-130`).
- ``OBJECT <id>`` then a type line (``cube``|``sphere``|``mesh``), a
  ``material <id>`` line, and ``TRANS/ROTAT/SCALE`` lines until a blank line
  (`scene.cpp:35-90`). ``mesh`` additionally takes a ``FILE <path.obj>`` line
  (a TPU-build extension; the reference declares triangle storage in
  `sceneStructs.h:30-35` but never loads meshes).

IDs must be sequential from 0, matching the reference's check
(`scene.cpp:37,155`). Unknown top-level lines are skipped, so ``//`` comment
lines behave exactly as in the reference.
"""

from __future__ import annotations

import os
from typing import List, Optional

import numpy as np

from .structs import CUBE, SPHERE, CameraDesc, Scene, SceneDesc
from . import transforms


class SceneParseError(ValueError):
    pass


def _vec3(tokens: List[str], start: int = 1) -> np.ndarray:
    return np.array(
        [float(tokens[start]), float(tokens[start + 1]), float(tokens[start + 2])],
        dtype=np.float32,
    )


class _Cursor:
    def __init__(self, lines: List[str]):
        self.lines = lines
        self.i = 0

    def next_line(self) -> Optional[str]:
        if self.i >= len(self.lines):
            return None
        line = self.lines[self.i]
        self.i += 1
        return line


def parse_scene(text: str, base_dir: str = ".") -> SceneDesc:
    """Parse scene text into a host-side :class:`SceneDesc`."""
    # safeGetline equivalence: split on \n, strip a trailing \r
    lines = [ln[:-1] if ln.endswith("\r") else ln for ln in text.split("\n")]
    cur = _Cursor(lines)

    materials: List[dict] = []
    geoms: List[dict] = []
    tri_vertices: List[np.ndarray] = []
    tri_material_id: List[int] = []
    num_objects = 0  # sequential OBJECT ids count meshes too
    camera: Optional[CameraDesc] = None
    iterations = 0
    trace_depth = 8
    image_name = "render"
    env_image = None
    env_strength = 1.0

    while True:
        line = cur.next_line()
        if line is None:
            break
        tokens = line.split()
        if not tokens:
            continue
        head = tokens[0]
        if head == "MATERIAL":
            mid = int(tokens[1])
            if mid != len(materials):
                raise SceneParseError(
                    f"MATERIAL ID {mid} does not match expected {len(materials)}"
                )
            mat = {
                "color": np.zeros(3, np.float32),
                "specular_exponent": 0.0,
                "specular_color": np.zeros(3, np.float32),
                "reflectivity": 0.0,
                "refractive": 0.0,
                "ior": 0.0,
                "emittance": 0.0,
            }
            for _ in range(7):
                ptoks = (cur.next_line() or "").split()
                if not ptoks:
                    continue
                key = ptoks[0]
                if key == "RGB":
                    mat["color"] = _vec3(ptoks)
                elif key == "SPECEX":
                    mat["specular_exponent"] = float(ptoks[1])
                elif key == "SPECRGB":
                    mat["specular_color"] = _vec3(ptoks)
                elif key == "REFL":
                    mat["reflectivity"] = float(ptoks[1])
                elif key == "REFR":
                    mat["refractive"] = float(ptoks[1])
                elif key == "REFRIOR":
                    mat["ior"] = float(ptoks[1])
                elif key == "EMITTANCE":
                    mat["emittance"] = float(ptoks[1])
            materials.append(mat)
        elif head == "CAMERA":
            res = (0, 0)
            fovy = 45.0
            eye = np.zeros(3, np.float32)
            lookat = np.zeros(3, np.float32)
            up = np.array([0, 1, 0], np.float32)
            aperture = 0.0
            focal = 0.0
            for _ in range(5):
                ptoks = (cur.next_line() or "").split()
                if not ptoks:
                    continue
                key = ptoks[0]
                if key == "RES":
                    res = (int(ptoks[1]), int(ptoks[2]))
                elif key == "FOVY":
                    fovy = float(ptoks[1])
                elif key == "ITERATIONS":
                    iterations = int(ptoks[1])
                elif key == "DEPTH":
                    trace_depth = int(ptoks[1])
                elif key == "FILE":
                    image_name = ptoks[1]
            while True:
                pline = cur.next_line()
                if pline is None or not pline.strip():
                    break
                ptoks = pline.split()
                if ptoks[0] == "EYE":
                    eye = _vec3(ptoks)
                elif ptoks[0] == "LOOKAT":
                    lookat = _vec3(ptoks)
                elif ptoks[0] == "UP":
                    up = _vec3(ptoks)
                # extension lines (absent from every reference scene): thin-
                # lens depth of field — APERTURE <radius>, FOCAL <distance>
                # (FOCAL ≤ 0 or omitted = auto-focus on LOOKAT)
                elif ptoks[0] == "APERTURE":
                    aperture = float(ptoks[1])
                elif ptoks[0] == "FOCAL":
                    focal = float(ptoks[1])
            camera = CameraDesc(
                resolution=res, fovy_deg=fovy, eye=eye, lookat=lookat, up=up,
                aperture=aperture, focal=focal,
            )
        elif head == "OBJECT":
            oid = int(tokens[1])
            if oid != num_objects:
                raise SceneParseError(
                    f"OBJECT ID {oid} does not match expected {num_objects}"
                )
            num_objects += 1
            type_line = (cur.next_line() or "").strip()
            mesh_file = None
            if type_line == "sphere":
                gtype = SPHERE
            elif type_line == "cube":
                gtype = CUBE
            elif type_line.split()[0] in ("mesh", "mesh_obj"):
                gtype = -1  # triangle mesh extension
            else:
                raise SceneParseError(f"unknown object type {type_line!r}")
            mtoks = (cur.next_line() or "").split()
            material_id = int(mtoks[1]) if len(mtoks) > 1 else 0
            translation = np.zeros(3, np.float32)
            rotation = np.zeros(3, np.float32)
            scale = np.ones(3, np.float32)
            while True:
                pline = cur.next_line()
                if pline is None or not pline.strip():
                    break
                ptoks = pline.split()
                if ptoks[0] == "TRANS":
                    translation = _vec3(ptoks)
                elif ptoks[0] == "ROTAT":
                    rotation = _vec3(ptoks)
                elif ptoks[0] == "SCALE":
                    scale = _vec3(ptoks)
                elif ptoks[0] == "FILE":
                    mesh_file = ptoks[1]
            if gtype < 0:
                if mesh_file is None:
                    raise SceneParseError("mesh OBJECT requires a FILE line")
                verts = load_obj_triangles(os.path.join(base_dir, mesh_file))
                m = transforms.build_transformation_matrix(
                    translation, rotation, scale
                )
                world = verts.reshape(-1, 3) @ m[:3, :3].T + m[:3, 3]
                world = world.reshape(-1, 3, 3).astype(np.float32)
                tri_vertices.append(world)
                tri_material_id.append(
                    np.full(world.shape[0], material_id, np.int32)
                )
            else:
                geoms.append(
                    {
                        "type": gtype,
                        "material_id": material_id,
                        "translation": translation,
                        "rotation": rotation,
                        "scale": scale,
                    }
                )

        elif head == "ENVIRONMENT":
            # extension block (no reference counterpart — its sky is
            # hard-coded, `pathtrace.cu:358-362`): an equirectangular
            # Radiance HDR environment light.
            #   ENVIRONMENT
            #   FILE <map.hdr>     (path relative to the scene file)
            #   STRENGTH <s>       (optional radiance multiplier, default 1)
            env_file = None
            while True:
                pline = cur.next_line()
                if pline is None or not pline.strip():
                    break
                ptoks = pline.split()
                if ptoks[0] == "FILE":
                    if len(ptoks) < 2:
                        raise SceneParseError(
                            f"ENVIRONMENT FILE line needs a path: {pline!r}"
                        )
                    env_file = ptoks[1]
                elif ptoks[0] == "STRENGTH":
                    if len(ptoks) < 2:
                        raise SceneParseError(
                            f"ENVIRONMENT STRENGTH line needs a value: "
                            f"{pline!r}"
                        )
                    try:
                        env_strength = float(ptoks[1])
                    except ValueError as e:
                        raise SceneParseError(
                            f"bad ENVIRONMENT STRENGTH value: {pline!r}"
                        ) from e
            if env_file is None:
                raise SceneParseError("ENVIRONMENT block requires a FILE line")
            from ..io.png import read_hdr

            try:
                env_image = read_hdr(os.path.join(base_dir, env_file))
            except FileNotFoundError as e:
                raise SceneParseError(
                    f"ENVIRONMENT FILE not found: {env_file}"
                ) from e

    if camera is None:
        raise SceneParseError("scene has no CAMERA block")

    G = len(geoms)
    transform = np.zeros((G, 4, 4), np.float32)
    inv_transform = np.zeros((G, 4, 4), np.float32)
    inv_transpose = np.zeros((G, 4, 4), np.float32)
    for i, g in enumerate(geoms):
        transform[i], inv_transform[i], inv_transpose[i] = transforms.geom_matrices(
            g["translation"], g["rotation"], g["scale"]
        )

    desc = SceneDesc(
        geom_type=np.array([g["type"] for g in geoms], np.int32),
        material_id=np.array([g["material_id"] for g in geoms], np.int32),
        translation=np.stack([g["translation"] for g in geoms])
        if G
        else np.zeros((0, 3), np.float32),
        rotation=np.stack([g["rotation"] for g in geoms])
        if G
        else np.zeros((0, 3), np.float32),
        scale=np.stack([g["scale"] for g in geoms])
        if G
        else np.zeros((0, 3), np.float32),
        transform=transform,
        inv_transform=inv_transform,
        inv_transpose=inv_transpose,
        color=np.stack([m["color"] for m in materials])
        if materials
        else np.zeros((0, 3), np.float32),
        specular_exponent=np.array(
            [m["specular_exponent"] for m in materials], np.float32
        ),
        specular_color=np.stack([m["specular_color"] for m in materials])
        if materials
        else np.zeros((0, 3), np.float32),
        reflectivity=np.array([m["reflectivity"] for m in materials], np.float32),
        refractive=np.array([m["refractive"] for m in materials], np.float32),
        ior=np.array([m["ior"] for m in materials], np.float32),
        emittance=np.array([m["emittance"] for m in materials], np.float32),
        camera=camera,
        iterations=iterations,
        trace_depth=trace_depth,
        image_name=image_name,
        tri_vertices=np.concatenate(tri_vertices) if tri_vertices else None,
        tri_material_id=np.concatenate(tri_material_id) if tri_material_id else None,
        env_image=env_image,
        env_strength=env_strength,
    )
    return desc


def load_scene_desc(path: str) -> SceneDesc:
    with open(path, "r") as f:
        text = f.read()
    return parse_scene(text, base_dir=os.path.dirname(os.path.abspath(path)))


def load_scene(path: str, device="cuda") -> Scene:
    """Parse a scene file and build its tensors on ``device`` (the JAX
    ``load_scene``, with the device named)."""
    return Scene.from_desc(load_scene_desc(path), device)


def load_obj_triangles(path: str) -> np.ndarray:
    """Wavefront OBJ loader: `v` and `f` records, fan-triangulated.

    Returns an (T, 3, 3) float32 array of object-space triangles.
    """
    verts: List[List[float]] = []
    tris: List[List[int]] = []
    with open(path, "r") as f:
        for line in f:
            t = line.split()
            if not t:
                continue
            if t[0] == "v":
                verts.append([float(t[1]), float(t[2]), float(t[3])])
            elif t[0] == "f":
                idx = [int(tok.split("/")[0]) for tok in t[1:]]
                idx = [i - 1 if i > 0 else len(verts) + i for i in idx]
                for k in range(1, len(idx) - 1):
                    tris.append([idx[0], idx[k], idx[k + 1]])
    v = np.asarray(verts, np.float32)
    t = np.asarray(tris, np.int64)
    return v[t]
