from .structs import (
    CUBE,
    SPHERE,
    TRIANGLE,
    Camera,
    CameraDesc,
    GeomBatch,
    Materials,
    Scene,
    SceneDesc,
    TriangleBatch,
    camera_basis_from_spherical,
    derive_camera,
    spherical_from_view,
)
from .parser import SceneParseError, load_obj_triangles, load_scene_desc, parse_scene
from . import transforms

__all__ = [
    "CUBE",
    "SPHERE",
    "TRIANGLE",
    "Camera",
    "CameraDesc",
    "GeomBatch",
    "Materials",
    "Scene",
    "SceneDesc",
    "SceneParseError",
    "TriangleBatch",
    "camera_basis_from_spherical",
    "derive_camera",
    "spherical_from_view",
    "load_obj_triangles",
    "load_scene_desc",
    "parse_scene",
    "transforms",
]
