"""Render state: the accumulation buffer, the iteration counter and the seed.

The reference's full mutable renderer state is the accumulation buffer plus
the iteration counter (`dev_image` + ``iteration``, `pathtrace.cu:448`,
`main.cpp:25`). The seed is the int32 kernel seed that the JAX package
derives from its threefry key, ``int32(key_data[-1])`` (``engine.py:471``):
``jax.random.PRNGKey(s)`` holds ``s mod 2^32`` in its last word, so the
kernel seed of render seed ``s`` is ``s`` wrapped to int32
(:func:`kernel_seed`)."""

from __future__ import annotations

import dataclasses

import torch

from ..ops.rng import kernel_seed


@dataclasses.dataclass
class RenderState:
    accum: torch.Tensor  # (N, 3) f32 linear radiance sums
    iteration: int  # samples accumulated so far
    seed: int  # int32 kernel seed

    @classmethod
    def create(cls, num_pixels: int, seed: int, device) -> "RenderState":
        return cls(
            accum=torch.zeros((num_pixels, 3), dtype=torch.float32, device=device),
            iteration=0,
            seed=kernel_seed(seed),
        )

    def reset(self) -> "RenderState":
        """Camera-change reset (`main.cpp:110-136`): zero the accumulator and
        the iteration counter; the seed is kept."""
        return dataclasses.replace(
            self, accum=torch.zeros_like(self.accum), iteration=0
        )
