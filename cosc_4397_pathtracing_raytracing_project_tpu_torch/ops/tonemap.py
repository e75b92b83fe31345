"""Accumulator → display conversions (same semantics as the JAX package).

- display path (`sendImageToPBO`, `pathtrace.cu:250-268`): mean, gamma 1/2.2,
  clamp, uint8;
- PNG save path (`saveImage` + `image::savePNG`, `main.cpp:86-107`,
  `image.cpp:22-39`): mean, clamp [0,1], ×255, NO gamma, horizontally
  mirrored (x → width-1-x).
"""

from __future__ import annotations

import torch


def _denominator(accum: torch.Tensor, iteration) -> torch.Tensor:
    it = torch.as_tensor(iteration, dtype=torch.float32, device=accum.device)
    return torch.clamp_min(it, 1.0)


def display_image(accum: torch.Tensor, iteration) -> torch.Tensor:
    """[H, W, 3] or [N, 3] accumulator → uint8 with gamma 2.2."""
    pix = accum / _denominator(accum, iteration)
    gamma = torch.tensor(1.0 / 2.2, dtype=torch.float32, device=accum.device)
    pix = torch.pow(torch.clamp_min(pix, 0.0), gamma)
    return torch.clamp(pix * 255.0, 0.0, 255.0).to(torch.uint8)


def save_image(accum: torch.Tensor, iteration, width: int, height: int) -> torch.Tensor:
    """Accumulator (flat [N,3] or [H,W,3]) → [H, W, 3] uint8, linear (no
    gamma), mirrored horizontally as the reference writes PNGs."""
    img = accum.reshape(height, width, 3)
    pix = img / _denominator(accum, iteration)
    pix = torch.clamp(pix, 0.0, 1.0) * 255.0
    pix = torch.flip(pix, dims=(1,))  # saveImage writes pixel x to column width-1-x
    return pix.to(torch.uint8)


def mean_image(accum: torch.Tensor, iteration) -> torch.Tensor:
    """Linear per-pixel mean (used by the PSNR harness)."""
    return accum / _denominator(accum, iteration)
