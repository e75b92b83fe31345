"""PyTorch port, the fast pipeline on the CPU: the lane-indexed threefry
streams bit for bit with ``jax.random``, ``supports``, ``trace_sample_fast``
against the JAX package's on CORNELL_SMALL and on a small environment scene
(exact, throughput, env NEE, and env NEE with an emissive sphere added: the
combined two-technique NEE), and the port's Renderer on
``pipeline="fast"`` against the JAX Renderer, which takes its fast pipeline
on the CPU.

One sample at depth 3 (the Renderer case two), seed 3. Tolerance: the ROADMAP
bound against the JAX package, at most 0.5% of pixels with a max-channel
|Δ| above 1e-3 and channel means within 0.5%. Measured (``pytest -s``):
the light_only cases on CORNELL_SMALL bit-identical; throughput and NEE one
pixel of 4096 over 1e-3 (a library sin/cos ulp that turns one path), the
environment cases no pixel over 1e-3 (max |Δ| under 5e-5: the map's
atan2/acos lookups).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cosc_4397_pathtracing_raytracing_project_tpu import RenderConfig as JConfig
from cosc_4397_pathtracing_raytracing_project_tpu import Renderer as JRenderer
from cosc_4397_pathtracing_raytracing_project_tpu.ops import fast as jfast
from cosc_4397_pathtracing_raytracing_project_tpu.ops import rng as jrng
from cosc_4397_pathtracing_raytracing_project_tpu.ops.lights import (
    make_light_sampler as jax_make_light_sampler,
)
from cosc_4397_pathtracing_raytracing_project_tpu.scene import Scene as JScene
from cosc_4397_pathtracing_raytracing_project_tpu.scene import parse_scene as jparse
from cosc_4397_pathtracing_raytracing_project_tpu_torch import RenderConfig, Renderer, Scene, parse_scene
from cosc_4397_pathtracing_raytracing_project_tpu_torch.ops import fast
from cosc_4397_pathtracing_raytracing_project_tpu_torch.ops import rng as trng
from cosc_4397_pathtracing_raytracing_project_tpu_torch.ops.lights import make_light_sampler

from test_render import CORNELL_SMALL
from test_torch_cuda import (
    assert_within_oracle_tolerance,
    env_scene_text,
    many_cubes_text,
    tri_scene_desc,
    write_env_map,
)

torch.set_num_threads(2)

SEED = 3
ITERATION = 2


def _bits(a):
    return np.asarray(a, np.float32).view(np.uint32)


STREAMS = {
    "bounce_uniforms": (jrng.bounce_uniforms, trng.bounce_uniforms),
    "bounce_lane_uniforms": (
        lambda k, it, d, n: jax.random.uniform(jrng.bounce_key(k, it, d), (jrng.NUM_LANES, n),
                                               jnp.float32),
        trng.bounce_lane_uniforms,
    ),
    "nee_uniforms": (jrng.nee_uniforms, trng.nee_uniforms),
    "env_uniforms": (jrng.env_uniforms, trng.env_uniforms),
}


@pytest.mark.parametrize("n", [1, 7, 64])
@pytest.mark.parametrize("stream", list(STREAMS))
def test_streams_are_bit_exact(stream, n):
    """Each stream, for odd and even element counts, seeds at and past 2^31
    and iterations and depths folded as int32, bit for bit; the [5, n] draw
    is another layout of other bits than the [n, 5] one."""
    jax_fn, port_fn = STREAMS[stream]
    for seed in (0, SEED, 2**31 - 1, -1):
        for it, depth in ((1, 0), (ITERATION, 3), (70000, 7)):
            want = jax_fn(jrng.render_key(seed), jnp.int32(it), jnp.int32(depth), n)
            got = port_fn(seed, it, depth, n)
            assert got.shape == want.shape and got.dtype == torch.float32
            np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))
    if stream == "bounce_lane_uniforms" and n > 1:
        assert not np.array_equal(trng.bounce_uniforms(SEED, 1, 0, n).numpy().T,
                                  trng.bounce_lane_uniforms(SEED, 1, 0, n).numpy())


def test_depth_batched_draws_equal_one_draw_a_depth():
    """The pipelines draw every depth at once from a batch of folded keys:
    the same bits as one draw a depth."""
    depths = torch.arange(2, 8)
    for fn in (trng.bounce_uniforms, trng.bounce_lane_uniforms, trng.nee_uniforms,
               trng.env_uniforms):
        batched = fn(SEED, ITERATION, depths, 33)
        assert torch.equal(batched, torch.stack([fn(SEED, ITERATION, int(d), 33)
                                                 for d in depths]))


@pytest.mark.parametrize("kind", ["cornell", "empty", "65-cubes", "triangles"])
def test_supports_equals_jax(kind):
    if kind == "triangles":
        desc = tri_scene_desc()
        port, oracle = Scene.from_desc(desc, "cpu"), JScene.from_desc(desc)
    else:
        text = {"cornell": CORNELL_SMALL, "empty": many_cubes_text(2).split("OBJECT 0")[0],
                "65-cubes": many_cubes_text(65)}[kind]
        port, oracle = Scene.from_desc(parse_scene(text), "cpu"), JScene.from_desc(jparse(text))
    assert fast.supports(port) == jfast.supports(oracle) == (kind == "cornell")


def _compare(port_scene, jax_scene, cfg, area_nee=False):
    jl = jax_make_light_sampler(jax_scene) if area_nee else None
    tl = make_light_sampler(port_scene) if area_nee else None
    want = np.asarray(jfast.trace_sample_fast(jax_scene, JConfig(**cfg), jrng.render_key(SEED),
                                              jnp.int32(ITERATION), light_sampler=jl))
    got = fast.trace_sample_fast(port_scene, RenderConfig(**cfg), SEED, ITERATION,
                                 light_sampler=tl)
    assert_within_oracle_tolerance(got.numpy(), want)


CORNELL_CASES = {
    "light_only": dict(trace_depth=3),
    "sobol-aa": dict(trace_depth=3, sampler="sobol", antialias=True),
    "throughput": dict(trace_depth=3, gather_mode="throughput"),
    "nee": dict(trace_depth=3, nee=True),
}


@pytest.mark.parametrize("case", list(CORNELL_CASES))
def test_trace_sample_fast_matches_jax_on_cornell(case):
    cfg = CORNELL_CASES[case]
    _compare(Scene.from_desc(parse_scene(CORNELL_SMALL), "cpu"),
             JScene.from_desc(jparse(CORNELL_SMALL)), cfg, area_nee=cfg.get("nee", False))


@pytest.fixture(scope="module")
def env_scenes(tmp_path_factory):
    """(port, JAX) scenes of the small environment scene (32×32, the 'sun'
    stress map), without and with an emissive sphere."""
    d = tmp_path_factory.mktemp("env")
    path = write_env_map(d, "sun")
    out = {}
    for light in (False, True):
        text = env_scene_text(path, res=32, light=light)
        out[light] = (Scene.from_desc(parse_scene(text, base_dir=str(d)), "cpu"),
                      JScene.from_desc(jparse(text, base_dir=str(d))))
    return out


ENV_CASES = {
    "exact": (False, dict(trace_depth=3)),
    "throughput": (False, dict(trace_depth=3, gather_mode="throughput")),
    "env-nee": (False, dict(trace_depth=3, nee=True)),
    "env-nee-sobol-aa": (False, dict(trace_depth=3, nee=True, sampler="sobol", antialias=True)),
    "combined-nee": (True, dict(trace_depth=3, nee=True)),
}


@pytest.mark.parametrize("case", list(ENV_CASES))
def test_trace_sample_fast_matches_jax_under_an_environment(case, env_scenes):
    light, cfg = ENV_CASES[case]
    port, oracle = env_scenes[light]
    _compare(port, oracle, cfg, area_nee=light)


def test_fast_pipeline_needs_a_light_or_a_map():
    """nee without a light sampler on a scene without a map raises, as in
    JAX."""
    scene = Scene.from_desc(parse_scene(CORNELL_SMALL), "cpu")
    with pytest.raises(ValueError, match="light_sampler"):
        jfast.trace_sample_fast(JScene.from_desc(jparse(CORNELL_SMALL)),
                                JConfig(trace_depth=1, nee=True), jrng.render_key(SEED), 1)
    with pytest.raises(ValueError, match="light_sampler"):
        fast.trace_sample_fast(scene, RenderConfig(trace_depth=1, nee=True), SEED, 1)


def test_renderer_matches_the_jax_renderer():
    """The port's Renderer on pipeline='fast' (auto takes the megakernel
    on this scene) against the JAX Renderer, which takes its fast pipeline
    on the CPU: render(2)'s accumulator."""
    cfg = dict(trace_depth=3, samples_per_launch=2)
    want = JRenderer(jparse(CORNELL_SMALL), JConfig(**cfg), seed=SEED)
    want.render(2)
    got = Renderer(parse_scene(CORNELL_SMALL), RenderConfig(pipeline="fast", **cfg), seed=SEED,
                   device="cpu")
    assert got.pipeline == "fast"
    got.render(2)
    assert got.iteration == 2
    assert_within_oracle_tolerance(got.state.accum.numpy(), np.asarray(want.state.accum))


def test_renderer_resolves_its_pipeline_once(env_scenes, monkeypatch):
    """The Renderer resolves its pipeline when it is built and hands it to
    every sample: with nee, an exact map and an emitter, resolving reads the
    scene's light table back to the host, which on the card waits for its
    queue."""
    from cosc_4397_pathtracing_raytracing_project_tpu_torch.render import engine

    calls = []
    resolve = engine.RenderConfig.resolve_pipeline

    def counting(self, scene):
        calls.append(1)
        return resolve(self, scene)

    monkeypatch.setattr(engine.RenderConfig, "resolve_pipeline", counting)
    r = Renderer(env_scenes[True][0], RenderConfig(trace_depth=2, nee=True, samples_per_launch=3),
                 seed=SEED, device="cpu")
    assert r.pipeline == "fast" and len(calls) == 1
    r.render(3)
    assert r.iteration == 3 and len(calls) == 1
    assert torch.isfinite(r.state.accum).all()
