"""Debugging aids: the analog of the reference's ERRORCHECK
(`pathtrace.cu:137-150`, a device sync + error check after every kernel).

Port of the JAX package's ``utils/debug.py``. JAX raises on a NaN inside
any computation under ``jax_debug_nans``; PyTorch has no such switch for
forward code, so :func:`enable_nan_checks` sets a flag under which
``Renderer.step`` checks the accumulator after each step and raises
``FloatingPointError``, the error JAX raises. The flag is off by default.
"""

from __future__ import annotations

import numpy as np
import torch

_nan_checks = False


def enable_nan_checks() -> None:
    """Make every ``Renderer.step`` check its accumulator for NaN and raise
    ``FloatingPointError`` on one. The check reads a flag back from the
    device, so each step waits for its kernels: debug runs only."""
    global _nan_checks
    _nan_checks = True


def disable_nan_checks() -> None:
    global _nan_checks
    _nan_checks = False


def nan_checks_enabled() -> bool:
    return _nan_checks


def check_nans(accum: torch.Tensor, iteration: int) -> None:
    """Raise ``FloatingPointError`` if ``accum`` holds a NaN (syncs the
    host with the accumulator's device)."""
    if bool(torch.isnan(accum).any()):
        raise FloatingPointError(
            f"NaN in the accumulator after iteration {iteration} "
            f"({int(torch.isnan(accum).sum())} values)"
        )


def validate_radiance(accum, iteration: int) -> dict:
    """Health check of the accumulator (a tensor on any device, or an
    array): NaN/Inf counts and basic stats. Cheap enough to run at
    checkpoint cadence."""
    if not torch.is_tensor(accum):
        accum = torch.as_tensor(np.asarray(accum))
    nan_count = int(torch.isnan(accum).sum())
    inf_count = int(torch.isinf(accum).sum())
    finite = torch.nan_to_num(accum)
    mean = float(finite.mean() / max(iteration, 1))
    peak = float(finite.max() / max(iteration, 1))
    return {
        "nan_count": nan_count,
        "inf_count": inf_count,
        "mean_radiance": mean,
        "peak_radiance": peak,
        "healthy": nan_count == 0 and inf_count == 0,
    }
