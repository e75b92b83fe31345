"""The one generator of every traffic mix, driven by the mix's file.

- ``"kind": "offline"``: a closed loop of render jobs, one at a time. Job
  ``j`` is a fresh accumulation of ``job_spp`` samples on a render seed
  drawn from the run's seed, queued in steps of the configuration's
  ``samples_per_launch`` (:func:`job_steps`); every job has the same size.
- ``"kind": "interactive"``: a closed loop of one viewer's frames of
  ``frame_spp`` samples each, in cycles of ``drag_frames`` frames of a left
  drag (each an orbit step, which resets the accumulation) and then
  ``still_frames`` frames that keep accumulating. Every drag takes the mix's
  ``drag_px`` steps, (dx, dy) pixels a frame, in an order drawn from the
  seed, every other drag in the opposite direction, so the camera swings
  about its first pose and every seed renders the same set of moves.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np

MASK63 = (1 << 63) - 1


@dataclasses.dataclass(frozen=True)
class Job:
    index: int
    seed: int
    spp: int


@dataclasses.dataclass(frozen=True)
class Frame:
    index: int
    drag: tuple  # (dx, dy) pixels of the orbit step, or () on a still frame
    spp: int


def job_steps(spp: int, per_step: int) -> list:
    """The steps a job is queued in: ``per_step`` samples each, the rest last."""
    full, rest = divmod(int(spp), int(per_step))
    return [int(per_step)] * full + ([rest] if rest else [])


def jobs(traffic: dict, seed: int) -> Iterator[Job]:
    rng = np.random.default_rng([seed & MASK63, 0x0FF1])
    index = 0
    while True:
        yield Job(index=index, seed=int(rng.integers(0, 1 << 31)), spp=int(traffic["job_spp"]))
        index += 1


def frames(traffic: dict, seed: int) -> Iterator[Frame]:
    rng = np.random.default_rng([seed & MASK63, 0x1A7E])
    steps = [tuple(s) for s in traffic["drag_px"]]
    n_drag, n_still = int(traffic["drag_frames"]), int(traffic["still_frames"])
    if len(steps) != n_drag:
        raise ValueError(f"drag_px holds {len(steps)} steps for {n_drag} drag frames")
    spp = int(traffic["frame_spp"])
    index, sign = 0, 1
    while True:
        for k in rng.permutation(n_drag):
            dx, dy = steps[k]
            yield Frame(index=index, drag=(sign * dx, sign * dy), spp=spp)
            index += 1
        for _ in range(n_still):
            yield Frame(index=index, drag=(), spp=spp)
            index += 1
        sign = -sign
