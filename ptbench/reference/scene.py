"""The scene of a configuration, as the plain reference reads it: the
reference project's text format (materials, a camera, transformed unit
cubes and spheres) parsed and packed into the tables the estimator reads.

Transforms follow the reference's ``T · Rx · Ry · Rz · S`` in float32 with
the inverse taken in float64 (`src/utilities.cpp:65-72`,
`src/scene.cpp:82-85`); the camera is rebuilt from spherical coordinates
as the viewer does before the first frame and on every orbit step
(`src/main.cpp:110-136`), with pixel lengths from ``tan(fovy)``
(`src/scene.cpp:133-140`).
"""

from __future__ import annotations

import dataclasses

import numpy as np

GF = 21  # floats per geom row: inverse transform rows (12), inverse transpose (9)
MF = 10  # floats per material: color(3) spec_color(3) refl refr emit ior
_DEG2RAD = np.pi / 180.0


@dataclasses.dataclass
class Orbit:
    """The viewer's spherical camera: zoom, azimuth, polar angle, look-at."""

    zoom: float
    phi: float
    theta: float
    lookat: np.ndarray

    def step(self, dx_px: float, dy_px: float, width: int, height: int) -> None:
        """A left-drag of (dx, dy) pixels (`src/main.cpp:190-195`)."""
        self.phi -= dx_px / width
        self.theta -= dy_px / height
        self.theta = max(0.001, min(self.theta, float(np.pi)))

    def basis(self):
        """(position, view, up, right) as float32 (`src/main.cpp:110-126`)."""
        lookat = np.asarray(self.lookat, np.float64)
        cam_pos = self.zoom * np.array([np.sin(self.phi) * np.sin(self.theta),
                                        np.cos(self.theta),
                                        np.cos(self.phi) * np.sin(self.theta)])
        view = -cam_pos / np.linalg.norm(cam_pos)
        right = np.cross(view, np.array([0.0, 1.0, 0.0]))
        up = np.cross(right, view)
        return tuple(a.astype(np.float32) for a in (cam_pos + lookat, view, up, right))


@dataclasses.dataclass
class RefScene:
    """The packed tables: camera [16], geom rows [K·21] (cubes, then
    spheres), geom material ids [K] (renumbered densely), materials [M·10],
    the axis-aligned column map [K·3] (-1: a general transform)."""

    cam: np.ndarray
    geo: np.ndarray
    gmat: np.ndarray
    mats: np.ndarray
    perm: np.ndarray
    num_cubes: int
    num_spheres: int
    width: int
    height: int
    trace_depth: int
    orbit: Orbit

    @property
    def num_geoms(self) -> int:
        return self.num_cubes + self.num_spheres

    def with_orbit(self, orbit: Orbit) -> "RefScene":
        position, view, up, right = orbit.basis()
        cam = self.cam.copy()
        cam[0:3], cam[3:6], cam[6:9], cam[9:12] = position, view, right, up
        cam[15] = np.float32(orbit.zoom)  # focal: auto-focus on the look-at
        return dataclasses.replace(self, cam=cam, orbit=orbit)


def _vec3(tokens, start=1) -> np.ndarray:
    return np.array([float(t) for t in tokens[start:start + 3]], np.float32)


def _rotation(angle: float, axis: int) -> np.ndarray:
    c = np.float32(np.cos(angle))
    s = np.float32(np.sin(angle))
    m = np.eye(4, dtype=np.float32)
    i, j = [(1, 2), (0, 2), (0, 1)][axis]
    m[i, i], m[j, j] = c, c
    m[i, j], m[j, i] = (s, -s) if axis == 1 else (-s, s)
    return m


def geom_matrices(translation, rotation_deg, scale):
    """(transform, inverse, inverse transpose), float32 4×4."""
    rot = np.asarray(rotation_deg, np.float64) * _DEG2RAD
    m = np.eye(4, dtype=np.float32)
    m[:3, 3] = translation
    for axis in range(3):
        m = m @ _rotation(rot[axis], axis)
    s = np.eye(4, dtype=np.float32)
    s[0, 0], s[1, 1], s[2, 2] = scale
    m = (m @ s).astype(np.float32)
    inv = np.linalg.inv(m.astype(np.float64)).astype(np.float32)
    return m, inv, inv.T.copy()


def parse(text: str):
    """(materials [M, 10] f32, geoms [(kind, material, matrices)], camera
    dict, depth) of a scene's text. Kinds: 0 cube, 1 sphere."""
    lines = [ln.rstrip("\r") for ln in text.split("\n")]
    mats, geoms, camera, depth = [], [], None, 8
    i = 0

    def take():
        nonlocal i
        i += 1
        return lines[i - 1].split() if i <= len(lines) else []

    while i < len(lines):
        tokens = take()
        if not tokens:
            continue
        if tokens[0] == "MATERIAL":
            m = dict(RGB=np.zeros(3, np.float32), SPECRGB=np.zeros(3, np.float32))
            for _ in range(7):
                t = take()
                if t:
                    m[t[0]] = _vec3(t) if t[0] in ("RGB", "SPECRGB") else float(t[1])
            mats.append(np.concatenate([m["RGB"], m["SPECRGB"],
                                        [m.get("REFL", 0.0), m.get("REFR", 0.0),
                                         m.get("EMITTANCE", 0.0), m.get("REFRIOR", 0.0)]]))
        elif tokens[0] == "CAMERA":
            camera = {}
            for _ in range(5):
                t = take()
                if t:
                    camera[t[0]] = t[1:]
            while True:
                t = take()
                if not t:
                    break
                camera[t[0]] = _vec3(t)
            depth = int(camera.get("DEPTH", ["8"])[0])
        elif tokens[0] == "OBJECT":
            kind = {"cube": 0, "sphere": 1}[take()[0]]
            material = int(take()[1])
            trs = {"TRANS": np.zeros(3, np.float32), "ROTAT": np.zeros(3, np.float32),
                   "SCALE": np.ones(3, np.float32)}
            while True:
                t = take()
                if not t:
                    break
                trs[t[0]] = _vec3(t)
            geoms.append((kind, material, geom_matrices(trs["TRANS"], trs["ROTAT"],
                                                        trs["SCALE"])))
    return np.asarray(mats, np.float32), geoms, camera, depth


def _axis_perm(inv: np.ndarray):
    """The column of the one nonzero of each row of an axis-aligned
    inverse transform, or None."""
    m = inv[:3, :3]
    scale = max(float(np.abs(m).max()), 1e-20)
    perm = []
    for r in range(3):
        nz = np.nonzero(np.abs(m[r]) > 1e-7 * scale)[0]
        if len(nz) != 1:
            return None
        perm.append(int(nz[0]))
    return perm if sorted(perm) == [0, 1, 2] else None


def load(text: str) -> RefScene:
    mats, geoms, camera, depth = parse(text)
    ordered = [g for g in geoms if g[0] == 0] + [g for g in geoms if g[0] == 1]
    used = sorted({g[1] for g in ordered})
    dense = {m: k for k, m in enumerate(used)}
    geo = np.concatenate([np.concatenate([inv[:3, :4].reshape(12), it[:3, :3].reshape(9)])
                          for _kind, _m, (_tf, inv, it) in ordered]).astype(np.float32)
    perm = np.full((len(ordered), 3), -1, np.int32)
    for k, (_kind, _m, (_tf, inv, _it)) in enumerate(ordered):
        p = _axis_perm(inv)
        if p is not None:
            perm[k] = p
    w, h = (int(v) for v in camera["RES"])
    eye = np.asarray(camera["EYE"], np.float64)
    lookat = np.asarray(camera["LOOKAT"], np.float64)
    offset = eye - lookat
    zoom = float(np.linalg.norm(offset))
    orbit = Orbit(zoom=zoom, phi=float(np.arctan2(offset[0], offset[2])),
                  theta=float(np.arccos(np.clip(offset[1] / zoom, -1.0, 1.0))),
                  lookat=lookat)
    yscaled = np.tan(np.float64(float(camera["FOVY"][0])) * np.pi / 180.0)
    xscaled = yscaled * w / h
    pixel_length = np.array([2 * xscaled / w, 2 * yscaled / h], np.float32)
    cam = np.zeros(16, np.float32)
    cam[12:14] = pixel_length
    scene = RefScene(
        cam=cam, geo=geo, gmat=np.array([dense[g[1]] for g in ordered], np.int32),
        mats=np.ascontiguousarray(mats[used].reshape(-1)), perm=perm.reshape(-1),
        num_cubes=sum(1 for g in ordered if g[0] == 0),
        num_spheres=sum(1 for g in ordered if g[0] == 1),
        width=w, height=h, trace_depth=depth, orbit=orbit,
    )
    return scene.with_orbit(orbit)
