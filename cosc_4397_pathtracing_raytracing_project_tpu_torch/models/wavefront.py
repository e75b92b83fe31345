"""Wavefront pipeline with stream compaction and material sorting.

Port of the JAX package's ``models/wavefront.py``. The reference attempted
both and shipped neither (`pathtrace.cu:556-559,605`; `README.md:61-66`).
Here paths carry an explicit ``pixel_index`` (PathSegment.pixelIndex,
`sceneStructs.h:70`) and the final gather scatters by it (`finalGather`,
`pathtrace.cu:439-444`), so the path array can be reordered between
bounces:

- ``sort_alive``: live paths first after each bounce (stream compaction
  with static shapes, by a stable sort);
- ``sort_material``: paths grouped by hit material id.

The random rows are drawn in pixel order and gathered by ``pixel_index``,
so a reorder never changes which numbers a path sees, and the image is the
same under every compaction mode.
"""

from __future__ import annotations

import dataclasses

import torch

from ..ops import camera as camera_ops
from ..ops import rng as rng_ops
from ..ops.intersect import intersect_scene
from ..ops.shade import PathState, shade_step

COMPACTIONS = ("none", "sort_alive", "sort_material")


def trace_sample_wavefront(scene, config, seed: int, iteration: int, compaction: str = "none",
                           intersector=None) -> torch.Tensor:
    """One sample per pixel with optional per-bounce path reordering: the
    [N, 3] image contribution in pixel order. ``seed`` is the render seed,
    ``iteration`` the 1-based sample index."""
    if compaction not in COMPACTIONS:
        raise ValueError(f"unknown compaction mode {compaction!r}")
    isect = intersector if intersector is not None else intersect_scene
    cam = scene.camera
    n = cam.pixel_count
    dev = cam.position.device

    use_ld = getattr(config, "sampler", "independent") == "sobol"
    pix_ids = torch.arange(n, dtype=torch.int64, device=dev)
    jitter = lens = None
    if config.antialias:
        jitter = (rng_ops.ld_pixel_jitter(seed, iteration, pix_ids) if use_ld
                  else rng_ops.pixel_jitter(seed, iteration, n, dev))
    if getattr(config, "dof", False):
        lens = (rng_ops.ld_lens_uniforms(seed, iteration, pix_ids) if use_ld
                else rng_ops.lens_uniforms(seed, iteration, n, dev))
    origins, directions = camera_ops.generate_rays(cam, jitter, lens=lens)
    paths = PathState(
        origin=origins,
        direction=directions,
        color=torch.ones((n, 3), dtype=torch.float32, device=dev),
        bounces=torch.full((n,), config.trace_depth, dtype=torch.int32, device=dev),
    )
    pixel_index = pix_ids
    radiance = torch.zeros((n, 3), dtype=torch.float32, device=dev)

    def permute(paths, pixel_index, radiance, perm):
        paths = PathState(**{f.name: getattr(paths, f.name)[perm]
                             for f in dataclasses.fields(PathState)})
        return paths, pixel_index[perm], radiance[perm]

    n_ld = min(getattr(config, "ld_depths", 1), config.trace_depth) if use_ld else 0
    # the threefry rows of every depth at once (a batch of folded keys)
    rows = rng_ops.bounce_uniforms(seed, iteration,
                                   torch.arange(n_ld, config.trace_depth, device=dev), n, dev)

    def bounce(paths, pixel_index, radiance, depth: int, u_all):
        # keyed by pixel, not lane: a reordered path sees its own numbers
        uniforms = u_all[pixel_index]
        hit = isect(scene, paths.origin, paths.direction)
        paths, contrib = shade_step(
            paths, hit, scene.materials, uniforms, depth, config.rr_start_depth,
            gather_mode=config.gather_mode, sky_strength=config.sky_strength,
            env=scene.envmap,
        )
        radiance = radiance + contrib
        if compaction == "sort_alive":
            perm = torch.sort((~paths.alive).to(torch.int32), stable=True).indices
            paths, pixel_index, radiance = permute(paths, pixel_index, radiance, perm)
        elif compaction == "sort_material":
            key = torch.where(paths.alive, hit.material_id, 2**20)
            perm = torch.sort(key, stable=True).indices
            paths, pixel_index, radiance = permute(paths, pixel_index, radiance, perm)
        return paths, pixel_index, radiance

    for d in range(n_ld):
        # the LD rows are built in pixel order and ride the same gather
        paths, pixel_index, radiance = bounce(
            paths, pixel_index, radiance, d,
            rng_ops.ld_bounce_uniforms(seed, iteration, pix_ids, d).T,
        )
    for d in range(n_ld, config.trace_depth):
        paths, pixel_index, radiance = bounce(paths, pixel_index, radiance, d, rows[d - n_ld])

    values = paths.color if config.gather_mode == "throughput" else radiance
    # finalGather: scatter the path values back to pixel order
    out = torch.zeros((n, 3), dtype=torch.float32, device=dev)
    return out.index_add_(0, pixel_index, values)


def render_chunk_wavefront(scene, state, config, num_samples: int, compaction: str = "none",
                           intersector=None):
    """Accumulate ``num_samples`` wavefront samples into the state."""
    accum = state.accum
    for i in range(num_samples):
        accum = accum + trace_sample_wavefront(
            scene, config, state.seed, state.iteration + 1 + i, compaction, intersector
        )
    return dataclasses.replace(state, accum=accum, iteration=state.iteration + num_samples)
