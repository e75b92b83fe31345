"""The megakernel's visibility rays on the CPU (no jax): the plain version's
per-path record of them and the warp schedule that emulates where the CUDA
kernel traces them.

At a diffuse vertex the kernel casts visibility rays: toward a point on an
area light under NEE, queued in the warp and tested 32 at a time, a ray a
lane, once 32 are pending (the rest in a last pass before the warp exits);
along the (sample, depth) row's direction under env NEE, traced there; and
toward each sun above the normal in the sun/sky split, traced in the same
loop over the primitives as the ray that next leaves that vertex, one loop
iteration later; sun rays cast at a path's last vertex (trace depth
reached) take one more iteration of their own. ``megakernel.path_visibility``
records, per path, the depths at which it casts each kind (bit d) and its
sun rays; ``warp_schedule(..., vis=)`` counts what the kernel's counting
build counts (tests/test_torch_cuda.py holds the two equal on the card).
Here, on the small Cornell box with NEE and a small env_spheres with env
NEE and in split mode, at depth 3 (and 1) and 2 spp, the per-path records
must add up to the plain version's ray counts, the schedule must serve
every pixel once, its samples in order, in the path steps plus one step for
each path whose last vertex cast sun rays, and the light queue must test
every light ray once, in full passes but for one last pass a warp.
"""

import os

import numpy as np
import pytest
import torch

from cosc_4397_pathtracing_raytracing_project_tpu_torch import RenderConfig, Scene, parse_scene
from cosc_4397_pathtracing_raytracing_project_tpu_torch.ops.cuda import megakernel as tmk

torch.set_num_threads(2)

_SCENES = os.path.join(os.path.dirname(__file__), "..", "scenes")


def _scene(name, res):
    text = open(os.path.join(_SCENES, name)).read()
    text = text.replace("RES         800 800", f"RES         {res} {res}")
    return Scene.from_desc(parse_scene(text, base_dir=_SCENES), "cpu")


# (scene file, resolution, config): every kind of visibility ray, and a trace
# depth at which every continuing vertex is a path's last
CONFIGS = {
    "nee-depth3": ("cornell.txt", 64, dict(nee=True, trace_depth=3)),
    "nee-depth1-sobol": ("cornell.txt", 64, dict(nee=True, trace_depth=1, sampler="sobol")),
    "split-depth3": ("env_spheres.txt", 32, dict(env_mode="split", trace_depth=3)),
    "split-depth1": ("env_spheres.txt", 32, dict(env_mode="split", trace_depth=1)),
    "env-nee-depth3": ("env_spheres.txt", 32, dict(nee=True, trace_depth=3)),
}
# the plain version's ray counts of each kind
PLAIN = {"light": "shadow", "env": "env_shadow", "sun": "sun_shadow"}


@pytest.fixture(scope="module")
def paths():
    """Per config: (kernel options, suns, stats, steps, draws, visibility)
    of 2 samples, seed 7, iterations 1-2."""
    out = {}
    for name, (scene_file, res, cfg) in CONFIGS.items():
        scene = _scene(scene_file, res)
        config = RenderConfig(**cfg)
        opts = tmk.kernel_options(config, scene)
        packed = tmk.pack_scene(scene, nee=opts.nee, config=config)
        stats = {}
        pix = torch.arange(scene.camera.pixel_count)
        tmk.render_samples_reference(pix, packed, opts, 7, 1, 2, stats=stats)
        suns = packed.env.num_suns if opts.env == "split" else 0
        out[name] = (opts, suns, stats, *tmk.path_lengths(stats), tmk.path_visibility(stats))
    return out


def _popcount(masks, bits):
    return sum(int(((masks >> b) & 1).sum()) for b in range(bits))


@pytest.mark.parametrize("name", list(CONFIGS))
def test_per_path_rays_add_up_to_the_plain_counts(paths, name):
    """Each kind's per-path depths (one light and one env ray at most per
    vertex) and the per-path sun rays sum to the plain version's counts; a
    variant casts only its own kinds, and a path casts only at vertices it
    shaded past the draws."""
    opts, suns, stats, steps, draws, vis = paths[name]
    depth = opts.trace_depth
    assert _popcount(vis["light"], depth) == int(stats.get("shadow", 0))
    assert _popcount(vis["env"], depth) == int(stats.get("env_shadow", 0))
    assert int(vis["sun_rays"].sum()) == int(stats.get("sun_shadow", 0))
    own = {"light": opts.nee, "env": opts.env_nee, "sun": opts.env == "split"}
    for kind, on in own.items():
        assert (int(stats.get(PLAIN[kind], 0)) > 0) == on
    cast = vis["light"] | vis["env"] | vis["sun"]
    assert ((cast >> draws) == 0).all()
    # a depth with sun rays has at least one, and at most every sun
    sun_depths = np.zeros_like(vis["sun"])
    for b in range(depth):
        sun_depths += (vis["sun"] >> b) & 1
    assert (sun_depths <= vis["sun_rays"]).all()
    assert (vis["sun_rays"] <= sun_depths * suns).all()


@pytest.mark.parametrize("name", list(CONFIGS))
def test_schedule_serves_each_pixel_once_with_the_added_steps(paths, name):
    """The emulated schedule serves each pixel once, its samples in order,
    and its lane-steps are the path steps plus one for each path whose last
    vertex cast sun rays (less the samples settled by repeating a hoisted
    first path, one step each)."""
    opts, _suns, _stats, steps, draws, vis = paths[name]
    got = tmk.warp_schedule(steps, draws, tmk.SCHEDULE, **tmk.schedule_args(opts), warps=8,
                            vis=vis)
    assert (got["visits"] == 1).all()
    assert (got["samples"] == 2).all() and got["in_order"]
    last = ((vis["sun"] >> np.maximum(steps - 1, 0)) & 1) == 1
    assert got["added"] == int(last.sum())
    assert got["lane_iters"] + got["repeated"] == int(steps.sum()) + got["added"]
    assert (got["added"] > 0) == (opts.env == "split")
    if opts.trace_depth == 1:  # every vertex that casts is a path's last
        assert got["added"] == int((vis["sun"] != 0).sum())


@pytest.mark.parametrize("name", list(CONFIGS))
def test_visibility_counters_follow_the_rays(paths, name):
    """The emulated ray counts are the plain version's; a warp iteration that
    carries rays of a kind carries at least one and at most 32 lanes of
    them, and without the per-path record every visibility counter is 0 and
    no step is added."""
    opts, _suns, stats, steps, draws, vis = paths[name]
    got = tmk.warp_schedule(steps, draws, tmk.SCHEDULE, **tmk.schedule_args(opts), warps=8,
                            vis=vis)
    for kind, key in PLAIN.items():
        assert got[f"{kind}_rays"] == int(stats.get(key, 0))
        lanes = got["sun_lanes"] if kind == "sun" else got[f"{kind}_rays"]
        assert got[f"{kind}_warps"] <= lanes <= 32 * got[f"{kind}_warps"]
    assert got["sun_lanes"] <= got["sun_rays"]
    plain = tmk.warp_schedule(steps, draws, tmk.SCHEDULE, **tmk.schedule_args(opts), warps=8)
    assert all(plain[k] == 0 for k in tmk.WORK[3:]) and plain["added"] == 0
    assert plain["lane_iters"] + plain["repeated"] == int(steps.sum())


@pytest.mark.parametrize("name", list(CONFIGS))
def test_light_queue_tests_every_ray_once_in_full_passes(paths, name):
    """The NEE variants' light rays go through each warp's queue: every ray
    the plain version records is tested exactly once, no pass tests more
    than 32, every pass but a warp's last one (at most one a warp) tests
    32, and the rays tested after their lane wrote out the pixel, whose
    terms land in the output, are counted: every ray of a last pass among
    them. Without light rays the queue stays empty."""
    opts, _suns, stats, steps, draws, vis = paths[name]
    warps = 8
    got = tmk.warp_schedule(steps, draws, tmk.SCHEDULE, **tmk.schedule_args(opts), warps=warps,
                            vis=vis)
    sizes = got["light_pass_sizes"]
    rays = int(stats.get("shadow", 0))
    assert sizes.shape == (33,) and sizes[0] == 0
    assert int((np.arange(33) * sizes).sum()) == got["light_pass_lanes"] == rays
    assert int(sizes.sum()) == got["light_passes"]
    assert int(sizes[:32].sum()) == got["light_exit_passes"] <= warps
    exit_rays = got["light_pass_lanes"] - 32 * int(sizes[32])
    assert exit_rays <= got["light_late"] <= rays
    assert (rays > 0) == opts.nee == (got["light_late"] > 0)


def test_item_paths_keep_each_sample_of_each_pixel():
    """A tile dispatch whose queue items are (pixel, group samples) pairs:
    item g·N + p, sample j is pixel p's sample g·group + j."""
    steps = np.arange(6 * 5).reshape(6, 5)
    (items,) = tmk.item_paths(2, steps)
    assert items.shape == (2, 15)
    for g in range(3):
        for p in range(5):
            for j in range(2):
                assert items[j, g * 5 + p] == steps[g * 2 + j, p]
    assert (tmk.item_paths(6, steps)[0] == steps).all()


@pytest.mark.parametrize("group", [1, 2])
@pytest.mark.parametrize("name", ["nee-depth3", "nee-depth1-sobol"])
def test_light_queue_of_split_items(paths, name, group):
    """With a pixel's samples split over queue items, each of ``group``
    samples and settling into a unit of its own, the schedule serves every
    item once and the queue still tests every light ray once, in full
    passes but for one last pass a warp, and every ray of a last pass is
    late (its sample has settled)."""
    opts, _suns, stats, steps, draws, vis = paths[name]
    args = dict(**tmk.schedule_args(opts, tiles=True), warps=8, vis=vis)
    got = tmk.warp_schedule(steps, draws, tmk.SCHEDULE, group=group, **args)
    items = steps.shape[1] * (steps.shape[0] // group)
    assert got["visits"].shape == (items,) and (got["visits"] == 1).all()
    assert (got["samples"] == group).all() and got["in_order"]
    assert got["lane_iters"] + got["repeated"] == int(steps.sum())
    rays = int(stats["shadow"])
    sizes = got["light_pass_sizes"]
    assert int((np.arange(33) * sizes).sum()) == got["light_pass_lanes"] == rays
    assert got["light_rays"] == rays
    assert int(sizes[:32].sum()) == got["light_exit_passes"] <= 8
    exit_rays = got["light_pass_lanes"] - 32 * int(sizes[32])
    assert exit_rays <= got["light_late"] <= rays


def test_main_variant_records_no_visibility_rays():
    """Without NEE or an environment that casts rays, the plain version
    records none and the schedule adds nothing."""
    scene = _scene("cornell.txt", 32)
    opts = tmk.kernel_options(RenderConfig(trace_depth=3))
    stats = {}
    tmk.render_samples_reference(torch.arange(32 * 32), tmk.pack_scene(scene), opts, 7, 1, 2,
                                 stats=stats)
    assert tmk.path_visibility(stats) is None
