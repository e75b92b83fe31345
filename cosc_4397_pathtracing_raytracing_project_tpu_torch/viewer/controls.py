"""Orbit camera controller — the reference's mouse/key interaction model.

Port of the JAX package's ``viewer/controls.py``; the camera it builds is
this package's ``Camera`` on the controller's ``device`` (the renderer's).
Replicates `src/main.cpp` exactly:

- left-drag orbit: ``phi -= dx/width; theta -= dy/height`` with theta clamped
  to [0.001, π] (`main.cpp:190-195`);
- right-drag zoom: ``zoom += dy/height`` clamped ≥ 0.1 (`main.cpp:197-199`);
- middle-drag pan: lookAt moves against y-flattened right / along y-flattened
  forward, 0.01 per pixel (`main.cpp:202-214`);
- Space recenters lookAt to the scene file's original (`main.cpp:168-172`);
- any change rebuilds the camera basis from spherical coordinates exactly as
  `runCuda` does (`main.cpp:110-128`) and invalidates the accumulator.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..render import profiling
from ..scene.structs import (
    Camera,
    camera_basis_from_spherical,
    spherical_from_view,
)

_PI = float(np.pi)


@dataclasses.dataclass
class OrbitCameraController:
    width: int
    height: int
    zoom: float
    phi: float
    theta: float
    lookat: np.ndarray
    og_lookat: np.ndarray
    pixel_length: np.ndarray
    changed: bool = True  # camchanged starts true (`main.cpp:14`)
    # thin-lens extension: carried through rebuilds so orbiting a DOF
    # camera keeps its lens. focal_auto=True refocuses on the (possibly
    # panned) lookat every rebuild — focal tracks zoom exactly like the
    # scene loader's FOCAL ≤ 0 auto mode.
    aperture: float = 0.0
    focal: float = 0.0
    focal_auto: bool = True
    device: torch.device = torch.device("cpu")  # where camera() builds its tensors

    @classmethod
    def from_camera(
        cls, camera: Camera, lookat=None, focal_auto: bool = True
    ) -> "OrbitCameraController":
        position = camera.position.cpu().numpy().astype(np.float64)
        if lookat is None:
            # reconstruct lookAt from position + view (reference keeps the
            # scene-file lookAt; callers should pass it when available)
            view = camera.view.cpu().numpy().astype(np.float64)
            lookat = position + view * 1.0
        lookat = np.asarray(lookat, np.float64)
        zoom, phi, theta = spherical_from_view(position, lookat)
        return cls(
            width=camera.resolution[0],
            height=camera.resolution[1],
            zoom=zoom,
            phi=phi,
            theta=theta,
            lookat=lookat.copy(),
            og_lookat=lookat.copy(),
            pixel_length=camera.pixel_length.cpu().numpy().astype(np.float32),
            aperture=float(camera.aperture),
            focal=float(camera.focal),
            focal_auto=focal_auto,
            device=camera.position.device,
        )

    # ── interactions ──

    def orbit(self, dx_px: float, dy_px: float) -> None:
        self.phi -= dx_px / self.width
        self.theta -= dy_px / self.height
        self.theta = max(0.001, min(self.theta, _PI))
        self.changed = True

    def zoom_by(self, dy_px: float) -> None:
        self.zoom += dy_px / self.height
        self.zoom = max(0.1, self.zoom)
        self.changed = True

    def pan(self, dx_px: float, dy_px: float) -> None:
        _, view, _, right = camera_basis_from_spherical(
            self.zoom, self.phi, self.theta, self.lookat
        )
        forward = np.array([view[0], 0.0, view[2]], np.float64)
        n = np.linalg.norm(forward)
        if n > 0:
            forward /= n
        r = np.array([right[0], 0.0, right[2]], np.float64)
        rn = np.linalg.norm(r)
        if rn > 0:
            r /= rn
        self.lookat = self.lookat - dx_px * r * 0.01 + dy_px * forward * 0.01
        self.changed = True

    def recenter(self) -> None:
        self.lookat = self.og_lookat.copy()
        self.changed = True

    # ── camera reconstruction (`main.cpp:110-128`) ──

    def camera(self) -> Camera:
        with profiling.span("viewer.camera"):
            position, view, up, right = camera_basis_from_spherical(
                self.zoom, self.phi, self.theta, self.lookat
            )
            self.changed = False

            def f32(a):
                profiling.count("host_syncs")  # a copy from pageable host memory
                return torch.as_tensor(np.asarray(a, np.float32), device=self.device)

            return Camera(
                position=f32(position),
                view=f32(view),
                up=f32(up),
                right=f32(right),
                pixel_length=f32(self.pixel_length),
                resolution=(self.width, self.height),
                aperture=f32(self.aperture),
                focal=f32(self.zoom if self.focal_auto else self.focal),
            )
