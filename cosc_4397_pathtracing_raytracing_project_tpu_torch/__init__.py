"""PyTorch/CUDA port of the path tracer, beside the JAX package.

Same scene format, estimator and random streams as
``cosc_4397_pathtracing_raytracing_project_tpu``; the megakernel that carries
the main path is a hand-written CUDA kernel for Hopper
(``csrc/megakernel.cu``), with a plain PyTorch version that runs on the CPU.
This package imports torch and never jax.
"""

from .render.engine import RenderConfig, Renderer
from .render.state import RenderState
from .scene import Scene, SceneDesc, load_scene_desc, parse_scene

__all__ = [
    "Scene",
    "SceneDesc",
    "load_scene_desc",
    "parse_scene",
    "Renderer",
    "RenderConfig",
    "RenderState",
]
