"""Checkpoint / resume.

Port of the JAX package's ``render/checkpoint.py``, in its npz format field
for field, so a checkpoint written by either package loads in the other. The
accumulation buffer, the iteration counter and the random key are the whole
render state: iteration indices key every stream, so a resumed render
continues the exact sample sequence of an uninterrupted one.

The key field is ``jax.random.key_data`` of the render's key, ``uint32[2]``.
This package keeps the int32 kernel seed instead, which is the key's last
word (``ops.rng.prng_key``: ``PRNGKey(s)`` is ``(0, s mod 2^32)``), so it
writes ``[0, seed mod 2^32]`` and reads the last word back. A key whose high
word is not 0 came from a seed past 32 bits; its streams are not the ones
this package draws, so loading it raises rather than change them silently.
"""

from __future__ import annotations

import json
import os
from typing import Optional

import numpy as np
import torch

from ..ops.rng import kernel_seed
from .state import RenderState

_FORMAT_VERSION = 1


def _replace_tmp(tmp: str, path: str) -> None:
    # numpy appends .npz to the temporary name
    os.replace(tmp + ".npz" if os.path.exists(tmp + ".npz") else tmp, path)


def _read_version(data) -> None:
    version = int(data["version"])
    if version > _FORMAT_VERSION:
        raise ValueError(f"checkpoint version {version} is newer than supported")


def save_checkpoint(path: str, state: RenderState, meta: Optional[dict] = None) -> str:
    """Write ``state`` (and ``meta`` as JSON) to ``path`` (``.npz`` added if
    missing); returns the path written."""
    if not path.endswith(".npz"):
        path = path + ".npz"
    tmp = path + ".tmp"
    np.savez_compressed(
        tmp,
        version=np.int32(_FORMAT_VERSION),
        accum=state.accum.detach().cpu().numpy(),
        iteration=np.int32(state.iteration),
        key=np.array([0, state.seed & 0xFFFFFFFF], np.uint32),
        meta=json.dumps(meta or {}),
    )
    _replace_tmp(tmp, path)
    return path


def load_checkpoint(path: str, device="cpu"):
    """Returns (RenderState with its accumulator on ``device``, meta dict)."""
    with np.load(path, allow_pickle=False) as data:
        _read_version(data)
        if "acc_a" in data:
            raise ValueError(
                "this is an adaptive-sampling checkpoint — load it with "
                "AdaptiveRenderer.load_checkpoint"
            )
        key = np.asarray(data["key"]).reshape(-1).astype(np.uint32)
        if key.size != 2 or key[0] != 0:
            raise ValueError(
                f"checkpoint key {key.tolist()} is not PRNGKey(seed) of a 32-bit seed; "
                "its streams cannot be continued"
            )
        state = RenderState(
            accum=torch.tensor(np.asarray(data["accum"], np.float32), device=torch.device(device)),
            iteration=int(data["iteration"]),
            seed=kernel_seed(int(key[1])),
        )
        meta = json.loads(str(data["meta"]))
    return state, meta


# ── adaptive-sampler state (render.adaptive) ──
#
# The adaptive renderer's complete state is the two half-buffer accumulators,
# the per-tile sample counts, the seed and the lane-budget odometer: per-tile
# iteration counters key every stream, so a resumed adaptive render continues
# each tile's sample sequence where it stopped.

def save_adaptive_checkpoint(path: str, r, meta: Optional[dict] = None) -> str:
    """Write an ``AdaptiveRenderer``'s state; returns the path written."""
    if not path.endswith(".npz"):
        path = path + ".npz"
    tmp = path + ".tmp"
    np.savez_compressed(
        tmp,
        version=np.int32(_FORMAT_VERSION),
        acc_a=r._acc_a.detach().cpu().numpy(),
        acc_b=r._acc_b.detach().cpu().numpy(),
        counts=r._counts.detach().cpu().numpy(),
        seed=np.int32(r._seed),
        budget_spent=np.int64(r._lane_budget_spent),
        meta=json.dumps(meta or {}),
    )
    _replace_tmp(tmp, path)
    return path


def load_adaptive_checkpoint(path: str, device="cpu"):
    """Returns (state dict with its tensors on ``device``, meta dict) for
    AdaptiveRenderer.load_checkpoint."""
    device = torch.device(device)
    with np.load(path, allow_pickle=False) as data:
        _read_version(data)
        if "acc_a" not in data:
            raise ValueError(
                "this is a uniform-render checkpoint — load it with "
                "Renderer.load_checkpoint"
            )
        state = {
            "acc_a": torch.tensor(np.asarray(data["acc_a"], np.float32), device=device),
            "acc_b": torch.tensor(np.asarray(data["acc_b"], np.float32), device=device),
            "counts": torch.tensor(np.asarray(data["counts"], np.int32), device=device),
            "seed": kernel_seed(int(np.asarray(data["seed"]).astype(np.int64))),
            "budget_spent": int(data["budget_spent"]),
        }
        meta = json.loads(str(data["meta"]))
    return state, meta
