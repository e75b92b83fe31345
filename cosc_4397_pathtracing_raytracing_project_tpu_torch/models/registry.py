"""Renderer model registry.

Port of the JAX package's ``models/registry.py``: one entry for each of the
reference project's benchmark configurations (`README.md:30-59`,
BASELINE.md), with the same names:

- ``naive``: brute-force intersection, the readable pipeline;
- ``shared``: the SoA fast pipeline;
- ``bvh``: BVH-accelerated intersection with stackless threaded traversal
  (triangles through the cluster kernel K7 on the card);
- ``megakernel``: the CUDA megakernel, the fastest;
- ``wavefront``: the readable pipeline with an explicit pixel index and
  optional stream compaction / material sorting.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

from ..render.engine import RenderConfig, Renderer


@dataclasses.dataclass(frozen=True)
class ModelSpec:
    name: str
    description: str
    config_overrides: dict


_REGISTRY: Dict[str, ModelSpec] = {}


def register(spec: ModelSpec) -> None:
    _REGISTRY[spec.name] = spec


def available_models():
    return sorted(_REGISTRY)


def get(name: str) -> ModelSpec:
    if name not in _REGISTRY:
        raise KeyError(f"unknown model {name!r}; available: {', '.join(available_models())}")
    return _REGISTRY[name]


register(ModelSpec("naive", "brute-force intersection, readable pipeline",
                   {"pipeline": "reference", "intersector": "bruteforce"}))
register(ModelSpec("shared", "SoA fast pipeline", {"pipeline": "fast"}))
register(ModelSpec("bvh", "BVH-accelerated intersection (stackless threaded traversal)",
                   {"pipeline": "reference", "intersector": "bvh"}))
register(ModelSpec("megakernel", "single-launch CUDA megakernel (best)", {"pipeline": "pallas"}))
register(ModelSpec("wavefront", "pixel-indexed wavefront with compaction / material sort",
                   {"pipeline": "wavefront"}))


def make_renderer(model: str, scene, config: Optional[RenderConfig] = None, seed: int = 0,
                  compaction: str = "none", device="cuda") -> Renderer:
    """A Renderer configured as the named model, on ``device``."""
    spec = get(model)
    base = config or RenderConfig()
    overrides = dict(spec.config_overrides)
    if model == "wavefront":
        # the wavefront step replaces trace_sample, so nee would do nothing
        if base.nee:
            raise ValueError(
                "nee is not supported by the wavefront-compaction model — "
                "use 'auto', 'megakernel', 'shared' or 'bvh'"
            )
        overrides = {"pipeline": "reference"}
    renderer = Renderer(scene, dataclasses.replace(base, **overrides), seed=seed, device=device)
    if model == "wavefront":
        from .wavefront import render_chunk_wavefront

        isect = renderer._intersector

        def step(scene, state, config, num_samples):
            return render_chunk_wavefront(scene, state, config, num_samples, compaction, isect)

        renderer._step = step
    return renderer
