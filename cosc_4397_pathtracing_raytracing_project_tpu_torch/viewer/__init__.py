from .controls import OrbitCameraController
from .server import PreviewServer

__all__ = ["OrbitCameraController", "PreviewServer"]
