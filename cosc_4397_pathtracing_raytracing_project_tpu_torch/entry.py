"""The program's single-device entry point: one full render step of the
flagship Cornell scene.

:func:`entry` returns ``(fn, args)``, a step and its inputs, so that
``fn(*args)`` renders one sample of ``scenes/cornell.txt`` (raygen, then the
scene's trace depth of bounces of the SoA wavefront,
``ops.fast.trace_sample_fast``, then the accumulate) in the flagship
configuration, ``sampler='sobol'``. It is the counterpart of the JAX
package's ``__graft_entry__.entry``; its multi-device twin is
``parallel.dryrun.dryrun_multichip``.
"""

from __future__ import annotations

import os
from functools import partial

from .render.engine import RenderConfig, _check_device, render_chunk
from .render.state import RenderState
from .scene.parser import load_scene_desc
from .scene.structs import Scene, SceneDesc

CORNELL = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                       "scenes", "cornell.txt")


def _cornell_desc(resolution=None) -> SceneDesc:
    """``scenes/cornell.txt``, at ``resolution`` (width, height) when given."""
    desc = load_scene_desc(CORNELL)
    if resolution is not None:
        desc.camera.resolution = tuple(resolution)
    return desc


def entry(device="cuda", resolution=None):
    """``(fn, (scene, state))``: ``fn`` is :func:`render_chunk` of one
    sample under ``RenderConfig(trace_depth=<the scene's>,
    samples_per_launch=1, sampler="sobol")``; ``scene`` is
    ``scenes/cornell.txt`` on ``device`` (at ``resolution`` when given) and
    ``state`` a fresh ``RenderState`` of seed 0 there. ``fn(*args)`` returns
    the next state. The default device is the CUDA card; without one this
    raises, as ``Renderer`` does (``device="cpu"`` runs the same step on the
    CPU)."""
    device = _check_device(device)
    desc = _cornell_desc(resolution)
    scene = Scene.from_desc(desc, device)
    state = RenderState.create(scene.camera.pixel_count, 0, device)
    config = RenderConfig(trace_depth=desc.trace_depth, samples_per_launch=1, sampler="sobol")
    fn = partial(render_chunk, config=config, num_samples=1)
    return fn, (scene, state)
