"""The megakernel's warp schedule, emulated on the CPU (no jax).

``megakernel.warp_schedule`` replays the kernel's warps on the plain
version's per-path loop counts: ``"thread"`` is a thread per pixel rendering
its samples in series, ``"regen"`` the persistent warps of the CUDA kernel,
whose lanes start their pixel's next sample when a path ends (all of them at
once where the hoisted primary path ends at its first vertex) and take the
next pixel of the queue when their pixel is done. On the card the kernel's
counting build must give the same counts (tests/test_torch_cuda.py). Here,
on the small Cornell box at depth 3 and 2 spp, both schedules must serve
every pixel exactly once, from one lane, its samples in ascending order, and
the regenerating schedule must never take more warp iterations; given the
frame's width, the emulation's ``spread`` is the box of the pixels a warp's
lanes hold (a thread per pixel: a row of 32).
"""

import os

import numpy as np
import pytest
import torch

from cosc_4397_pathtracing_raytracing_project_tpu_torch import RenderConfig, Scene, parse_scene
from cosc_4397_pathtracing_raytracing_project_tpu_torch.ops.cuda import megakernel as tmk

_SCENES = os.path.join(os.path.dirname(__file__), "..", "scenes")

CONFIGS = {
    "hoisted-sobol": dict(trace_depth=3, sampler="sobol"),
    "aa-independent": dict(trace_depth=3, antialias=True),
}


@pytest.fixture(scope="module")
def paths():
    """Per config: (kernel options, steps [2, N], draws [2, N]) of the
    64×64 Cornell box, seed 7, iterations 1-2."""
    text = open(os.path.join(_SCENES, "cornell.txt")).read()
    scene = Scene.from_desc(parse_scene(text.replace("RES         800 800", "RES         64 64")),
                            "cpu")
    out = {}
    for name, cfg in CONFIGS.items():
        opts = tmk.kernel_options(RenderConfig(**cfg))
        packed = tmk.pack_scene(scene)
        stats = {}
        pix = torch.arange(scene.camera.pixel_count)
        tmk.render_samples_reference(pix, packed, opts, 7, 1, 2, stats=stats)
        out[name] = (opts, *tmk.path_lengths(stats))
    return out


def _run(paths, name, schedule, warps=8, owners=None, width=None):
    opts, steps, draws = paths[name]
    return tmk.warp_schedule(steps, draws, schedule, **tmk.schedule_args(opts),
                             warps=warps, owners=owners, width=width)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_path_lengths_match_the_work_counts(paths, name):
    """Each path enters 1..depth loop iterations; those past the hoisted
    primary are the plain version's nearest-hit traces, and the ones that
    reached the draws are its scatters plus its roulette kills."""
    opts, steps, draws = paths[name]
    assert steps.shape == draws.shape == (2, 64 * 64)
    assert steps.min() >= 1 and steps.max() <= opts.trace_depth
    assert ((draws == steps) | (draws == steps - 1)).all()
    assert steps.max() == opts.trace_depth and (draws < steps).any()


@pytest.mark.parametrize("schedule", ["thread", "regen"])
@pytest.mark.parametrize("name", list(CONFIGS))
def test_schedule_serves_each_pixel_once_in_order(paths, name, schedule):
    got = _run(paths, name, schedule)
    n = 64 * 64
    assert (got["visits"] == 1).all()
    assert (got["samples"] == 2).all() and got["in_order"]
    lanes = got["lane_of"]
    assert lanes.shape == (n,) and lanes.min() >= 0
    if schedule == "thread":
        np.testing.assert_array_equal(lanes, np.arange(n))


@pytest.mark.parametrize("schedule", ["thread", "regen"])
@pytest.mark.parametrize("name", list(CONFIGS))
def test_lane_steps_sum_to_path_lengths(paths, name, schedule):
    """Every loop iteration of every path is one active lane-iteration,
    except those of the samples a lane settles by repeating its pixel's
    first path (one iteration each)."""
    _, steps, _ = paths[name]
    got = _run(paths, name, schedule)
    assert got["lane_iters"] + got["repeated"] == int(steps.sum())
    assert got["efficiency"] == pytest.approx(got["lane_iters"] / (32 * got["warp_iters"]))


def test_only_a_hoisted_first_path_that_ends_at_once_repeats(paths):
    """With the primary hit hoisted, a pixel whose first path ends at its
    first vertex before any draw (it sees the light, or out through the
    open front) repeats that path in its other sample; with antialiasing
    every sample traces its own primary ray."""
    opts, steps, draws = paths["hoisted-sobol"]
    once = (steps[0] == 1) & (draws[0] == 0)
    assert once.any()
    assert (steps[1][once] == 1).all() and (draws[1][once] == 0).all()
    assert _run(paths, "hoisted-sobol", "regen")["repeated"] == int(once.sum())
    assert _run(paths, "aa-independent", "regen")["repeated"] == 0


@pytest.mark.parametrize("name", list(CONFIGS))
def test_thread_schedule_runs_each_samples_longest_path(paths, name):
    """Today's warp: 32 consecutive pixels at the same sample, each sample
    costing the warp its longest path; one draw branch per iteration."""
    _, steps, _ = paths[name]
    got = _run(paths, name, "thread")
    want = sum(int(steps[s, w:w + 32].max()) for s in range(2) for w in range(0, 64 * 64, 32))
    assert got["warp_iters"] == want
    assert got["both_draws"] == 0


@pytest.mark.parametrize("warps", [1, 8, 128])
@pytest.mark.parametrize("name", list(CONFIGS))
def test_regeneration_never_takes_more_iterations(paths, name, warps):
    regen = _run(paths, name, "regen", warps=warps)
    thread = _run(paths, name, "thread")
    assert regen["warp_iters"] <= thread["warp_iters"]


@pytest.mark.parametrize("name", list(CONFIGS))
def test_recorded_owners_replay_the_schedule(paths, name):
    """Given the warp that took each chunk of 32 pixels (what the counting
    build records), the emulation replays the same schedule."""
    first = _run(paths, name, "regen", warps=8)
    owners = first["lane_of"][::32] // 32
    again = _run(paths, name, "regen", warps=None, owners=owners)
    for key in tmk.WORK:
        assert again[key] == first[key]
    np.testing.assert_array_equal(again["lane_of"], first["lane_of"])


@pytest.mark.parametrize("batch", [4, 12, 32])
def test_lanes_that_start_together_keep_every_pixel_in_order(paths, batch):
    """Lanes that wait for others before starting a sample still serve each
    pixel once, in order, and take at least the iterations of lanes that
    start at once."""
    opts, steps, draws = paths["hoisted-sobol"]
    args = dict(tmk.schedule_args(opts), warps=8)
    eager = tmk.warp_schedule(steps, draws, "regen", **args)
    args["batch"] = batch
    got = tmk.warp_schedule(steps, draws, "regen", **args)
    assert (got["visits"] == 1).all() and (got["samples"] == 2).all() and got["in_order"]
    assert got["lane_iters"] == eager["lane_iters"]
    assert got["warp_iters"] >= eager["warp_iters"]


def test_lanes_at_different_depths_take_both_draw_branches(paths):
    """With the Sobol draws on depths 0-1 and the hash stream past them, a
    regenerating warp runs both branches in one iteration; the independent
    sampler has one branch."""
    assert _run(paths, "hoisted-sobol", "regen")["both_draws"] > 0
    assert _run(paths, "aa-independent", "regen")["both_draws"] == 0


def test_schedule_rejects_bad_arguments(paths):
    _, steps, draws = paths["hoisted-sobol"]
    with pytest.raises(ValueError):
        tmk.warp_schedule(steps, draws, "wavefront")
    with pytest.raises(ValueError):
        tmk.warp_schedule(steps, draws, "regen")
    with pytest.raises(ValueError):
        tmk.warp_schedule(steps, draws, "regen", owners=np.zeros(3, np.int64))


def test_spread_of_a_thread_per_pixel_is_a_row_of_32(paths):
    """A thread per pixel holds 32 neighbours of one row (64 is a multiple
    of 32): its spread is 32 x 1 in every warp iteration; without the
    frame's width there is none."""
    got = _run(paths, "hoisted-sobol", "thread", width=64)
    assert got["spread"] == (32.0, 1.0) and got["spread_area"] == 32.0
    assert _run(paths, "hoisted-sobol", "thread")["spread"] is None
    assert _run(paths, "hoisted-sobol", "regen")["spread_area"] is None


def test_spread_of_a_warp_across_rows():
    """On a frame 40 pixels wide a thread per pixel's second warp holds the
    end of row 0 and the start of row 1: a box of 40 x 2; each warp's box
    is weighted by its iterations."""
    steps = np.ones((1, 48), np.int64)
    steps[0, 32:] = 3  # the second warp takes three iterations
    got = tmk.warp_schedule(steps, np.zeros_like(steps), "thread", width=40)
    assert got["warp_iters"] == 4
    assert got["spread"] == pytest.approx(((32 + 3 * 40) / 4, (1 + 3 * 2) / 4))
    assert got["spread_area"] == pytest.approx((32 + 3 * 80) / 4)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_regenerating_warps_spread_over_the_frame(paths, name):
    """Path regeneration hands a warp's free lanes the next pixels of the
    queue: the box of the pixels its lanes hold stays inside the frame and
    holds at least one pixel, and with 8 lockstep warps over a 64 x 64
    frame it spans more than one row."""
    got = _run(paths, name, "regen", width=64)
    cols, rows = got["spread"]
    assert 1.0 <= cols <= 64.0 and 1.0 <= rows <= 64.0
    assert rows > 1.0 and got["spread_area"] >= cols
    with pytest.raises(ValueError):
        _run(paths, name, "regen", width=0)
