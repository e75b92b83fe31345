"""PyTorch/CUDA port of the path tracer, beside the JAX package.

Same scene format, estimator and random streams as
``cosc_4397_pathtracing_raytracing_project_tpu``; the megakernel that carries
the analytic scenes (``csrc/megakernel.cu``) and the triangle kernels of the
mesh pipeline (``csrc/mesh_kernel.cu``) are hand-written CUDA kernels for
Hopper, each with a plain PyTorch version that runs on the CPU. This package
imports torch and never jax.
"""

from .render.adaptive import AdaptiveRenderer
from .render.engine import RenderConfig, Renderer
from .render.state import RenderState
from .scene import Scene, SceneDesc, load_scene_desc, parse_scene

__all__ = [
    "Scene",
    "SceneDesc",
    "load_scene_desc",
    "parse_scene",
    "Renderer",
    "AdaptiveRenderer",
    "RenderConfig",
    "RenderState",
]
