from .registry import ModelSpec, available_models, get, make_renderer, register
from .wavefront import render_chunk_wavefront, trace_sample_wavefront

__all__ = [
    "ModelSpec",
    "available_models",
    "get",
    "make_renderer",
    "register",
    "render_chunk_wavefront",
    "trace_sample_wavefront",
]
