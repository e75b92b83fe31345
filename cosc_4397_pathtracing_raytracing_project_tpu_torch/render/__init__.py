from .engine import PALLAS_CHUNK, RenderConfig, Renderer, make_pallas_step
from .metrics import MetricsTracker, mse_between, psnr_from_mse
from .state import RenderState, kernel_seed

__all__ = [
    "PALLAS_CHUNK",
    "RenderConfig",
    "Renderer",
    "make_pallas_step",
    "MetricsTracker",
    "mse_between",
    "psnr_from_mse",
    "RenderState",
    "kernel_seed",
]
