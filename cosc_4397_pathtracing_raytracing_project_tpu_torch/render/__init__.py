from .adaptive import AdaptiveRenderer, make_tile_layout
from .engine import (
    PALLAS_CHUNK,
    RenderConfig,
    Renderer,
    make_pallas_step,
    render_chunk,
    trace_sample,
)
from .metrics import MetricsTracker, mse_between, psnr_from_mse
from .state import RenderState, kernel_seed

__all__ = [
    "AdaptiveRenderer",
    "make_tile_layout",
    "PALLAS_CHUNK",
    "RenderConfig",
    "Renderer",
    "make_pallas_step",
    "render_chunk",
    "trace_sample",
    "MetricsTracker",
    "mse_between",
    "psnr_from_mse",
    "RenderState",
    "kernel_seed",
]
