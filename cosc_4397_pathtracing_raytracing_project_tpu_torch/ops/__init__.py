from . import camera, intersect, lights, linalg, rng, sampling, shade, tonemap
from .camera import generate_rays
from .intersect import Hit, intersect_scene
from .lights import LightSampler, make_light_sampler
from .shade import PathState, init_paths, shade_step

__all__ = [
    "camera",
    "intersect",
    "lights",
    "linalg",
    "rng",
    "sampling",
    "shade",
    "tonemap",
    "LightSampler",
    "make_light_sampler",
    "Hit",
    "intersect_scene",
    "PathState",
    "init_paths",
    "shade_step",
    "generate_rays",
]
