"""Whether what the timed path produced is correct: the answers kept from
the window, judged against the plain reference (``reference/``).

An offline job's answer is its linear image read back at its end; an
interactive frame's is the uint8 preview frame on the host. Of each answer
the window keeps the pixels drawn for it from the run's seed
(:func:`pixel_table`); after the window a sample of the answers, drawn from
the seed with the last one always in it, is rendered again by the reference
from the same inputs (the configuration's scene text and map, the job's
seed, the frame's orbit steps and iterations), with the reference's own
scene build, alias table, env NEE rows, path sums, accumulation (a step's
samples summed in order, then added to the accumulator) and tonemapping.

The reference is the module ``reference/<name>.py`` that the
configuration's ``"reference"`` names (``"trace"`` by default), imported
after the window. Its ``estimator(config, dtype, device)`` returns an
object with:

- ``accumulate(render_seed, pixel_ids, launches)``: the [N, 3] float32
  accumulator of the pixels after the launches [(first iteration,
  samples), ...], ``render_seed`` being the seed the program was given
  (how it keys the random streams is the reference's own business);
- ``scene``, with ``width``, ``height``, ``orbit`` (a
  ``reference.scene.Orbit``: the first camera's) and ``with_orbit(orbit)``,
  the scene under another orbit (read for interactive cells only);
- ``with_scene(scene)``: the estimator over another such scene.

Compared numbers (each against its limit in ``limits/<cell>.json``):

- ``rel_gap`` (offline): the widest gap between a checked pixel channel of
  the image and the reference's, over ``max(|reference|, REL_FLOOR)``;
- ``lsb_gap`` (interactive): the widest gap between a checked pixel
  channel of the preview frame and the reference's, in uint8 steps.

A checked answer with a number past its limit counts as failed.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import numpy as np
import torch

from . import manifest

REL_FLOOR = 1e-3


@dataclasses.dataclass
class Answer:
    """One answer of the window: the inputs that made it and the values of
    its drawn pixels."""

    index: int
    seed: int  # the render seed
    launches: list  # [(first iteration, samples), ...] since the last reset
    orbit_steps: int  # the window's drag steps taken before it (interactive)
    pixels: np.ndarray  # int64 [P] flat pixel ids
    values: np.ndarray  # [P, 3] f32 (offline) or uint8 (interactive)


PIXEL_ROWS = 1 << 15  # answers with a pixel draw of their own; answer i takes row i % PIXEL_ROWS


def pixel_table(seed: int, count: int, num_pixels: int) -> np.ndarray:
    """[PIXEL_ROWS, count] pixel ids drawn from the seed (drawn before the
    window, so the window only gathers them): row i for answer i."""
    rng = np.random.default_rng([seed % (1 << 63), 0x9E11])
    return rng.integers(0, num_pixels, size=(PIXEL_ROWS, count), dtype=np.int64)


def answers_to_check(seed: int, n: int, count: int) -> List[int]:
    """``count`` of the ``n`` answers drawn from the seed, the last among them."""
    if n <= count:
        return list(range(n))
    rng = np.random.default_rng([seed % (1 << 63), 0xC4EC])
    picked = set(rng.choice(n - 1, size=count - 1, replace=False).tolist())
    return sorted(picked | {n - 1})


def estimator(config: dict, dtype=torch.float32, device="cpu"):
    """The estimator of the configuration's reference module."""
    return manifest.reference_module(config).estimator(config, dtype, device)


def display(accum: torch.Tensor, iterations: int) -> torch.Tensor:
    """The preview frame of an accumulator: its mean, gamma 1/2.2, ×255,
    clamped, as uint8."""
    it = torch.clamp_min(torch.as_tensor(iterations, dtype=torch.float32, device=accum.device),
                         1.0)
    gamma = torch.tensor(1.0 / 2.2, dtype=torch.float32, device=accum.device)
    pix = torch.pow(torch.clamp_min(accum / it, 0.0), gamma)
    return torch.clamp(pix * 255.0, 0.0, 255.0).to(torch.uint8)


def viewer_orbit(scene):
    """The viewer's orbit as it starts from the first frame's camera (the
    reference scene's ``orbit``): its spherical coordinates read back from
    the float32 camera position."""
    from .reference.scene import Orbit

    position = scene.orbit.basis()[0].astype(np.float64)
    lookat = np.asarray(scene.orbit.lookat, np.float64)
    offset = position - lookat
    zoom = float(np.linalg.norm(offset))
    return Orbit(zoom=zoom, phi=float(np.arctan2(offset[0], offset[2])),
                 theta=float(np.arccos(np.clip(offset[1] / zoom, -1.0, 1.0))),
                 lookat=lookat.copy())


def reference_values(est, answer: Answer, kind: str, drags=(), device="cpu") -> np.ndarray:
    """The reference's values at the answer's pixels; ``drags`` [(dx, dy)]
    are the window's orbit steps in order."""
    if kind == "interactive":
        orbit = viewer_orbit(est.scene)
        for dx, dy in list(drags)[:answer.orbit_steps]:
            orbit.step(dx, dy, est.scene.width, est.scene.height)
        est = est.with_scene(est.scene.with_orbit(orbit))
    pixels = torch.as_tensor(answer.pixels, device=device)
    accum = est.accumulate(answer.seed, pixels, answer.launches)
    iterations = sum(k for _b, k in answer.launches)
    if kind == "interactive":
        return display(accum, iterations).cpu().numpy()
    it = torch.clamp_min(torch.as_tensor(iterations, dtype=torch.float32, device=device), 1.0)
    return (accum / it).cpu().numpy()


def gaps(kind: str, values: np.ndarray, ref: np.ndarray) -> Dict[str, float]:
    if kind == "interactive":
        return {"lsb_gap": float(np.abs(values.astype(np.int64) - ref.astype(np.int64)).max())}
    rel = np.abs(values.astype(np.float64) - ref) / np.maximum(np.abs(ref.astype(np.float64)),
                                                              REL_FLOOR)
    return {"rel_gap": float(np.nan_to_num(rel, nan=np.inf).max())}


def judge(est, kind: str, answers: List[Answer], limits: dict, seed: int,
          drags=(), device="cpu") -> Tuple[Dict[str, float], int, int]:
    """(widest reading of each number over the checked answers, answers
    failed, answers checked)."""
    picked = answers_to_check(seed, len(answers), int(limits["answers"]))
    worst: Dict[str, float] = {}
    failed = 0
    for i in picked:
        a = answers[i]
        got = gaps(kind, a.values, reference_values(est, a, kind, drags, device))
        failed += any(v > limits["numbers"][k] for k, v in got.items())
        for k, v in got.items():
            worst[k] = max(worst.get(k, 0.0), v)
    return worst, failed, len(picked)
