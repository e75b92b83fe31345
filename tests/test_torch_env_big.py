"""PyTorch port, exact environment maps past the JAX kernel's VMEM cap.

The JAX megakernel keeps the map's planes in VMEM and caps them at
``MAX_ENV_EXACT_TEXELS`` = 256×512 texels; its router sends larger maps to
the fast pipeline. The port's kernel reads the map from device memory and
takes any map whose floats take 32-bit offsets (``MAX_ENV_TEXELS``), a
deliberate deviation (ROADMAP Queue 3). Here:

- the port's plain version of K3 / K4 over a 256×1024 map (the smallest
  past the cap that the JAX kernel takes with its cap raised by
  ``monkeypatch``; the JAX package's files are untouched) against that JAX
  kernel in interpret mode, 64×64, depth 3, 2 spp, with the oracle
  tolerance of test_torch_env_kernel.py (at most 0.5% of pixels with a
  max-channel |Δ| above 1e-3, channel means within 0.5%) for the reasons it
  states (K4 on the port's own env NEE rows, patched into the oracle: past
  2^15 texels the port's alias draw deviates from the JAX one, which is
  biased there). The map is the meadow resampled bilinearly (every texel its own,
  as smooth as the meadow): the oracle's approximate reciprocal moves its
  secondary rays by about 1e-4 rad, a few hundredths of a texel here, which
  a map of independent texels turns into differences above 1e-3 on 1.4% of
  pixels already at 128×256, inside the JAX cap. Measured on the
  development host (jax 0.9.0, torch 2.13.0 CPU) with ``pytest -s``: share
  above 1e-3 0.049% (exact) and 0.073% (env NEE);
- the plain version's bilinear lookup (``_env_lookup``, K3's arithmetic on
  the map's planes) at 2048×4096 against the JAX package's
  ``ops/envmap.env_radiance`` on 1e5 seeded directions, with the azimuth
  seam and the pole rows: the lookup's polynomial atan2/acos against XLA's
  library trigonometry. They differ by up to two ulps of u (1.2e-7), which
  moves a texel coordinate by up to 4096·1.2e-7 ≈ 5e-4 of a texel; the
  sampled neighbouring texels of the map (lognormal, σ = 0.5) differ by up
  to a factor of about 10, so the radiance moves by up to about 5e-3
  relative, the bound (atol 1e-6), where a lookup of a wrong texel or row
  is off by tens of percent. (At the exact poles the azimuth is undefined:
  XLA's atan2(0, -0) is π, the polynomial's 0, so those two directions are
  left out.) Measured on the development host: largest relative
  difference 1.51e-3;
- the ``ValueError`` at the kernel's own limit, on the CPU and through the
  router, which never falls back to another pipeline.
"""

import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cosc_4397_pathtracing_raytracing_project_tpu import RenderConfig as JConfig
from cosc_4397_pathtracing_raytracing_project_tpu.ops import envmap as jenv
from cosc_4397_pathtracing_raytracing_project_tpu.ops.pallas import megakernel as jmk
from cosc_4397_pathtracing_raytracing_project_tpu.scene import Scene as JScene
from cosc_4397_pathtracing_raytracing_project_tpu.scene import parse_scene as jparse
from cosc_4397_pathtracing_raytracing_project_tpu_torch import RenderConfig, Scene, parse_scene
from cosc_4397_pathtracing_raytracing_project_tpu_torch.io.png import read_hdr
from cosc_4397_pathtracing_raytracing_project_tpu_torch.ops.cuda import megakernel as tmk

from test_torch_cuda import assert_within_oracle_tolerance, env_spheres_text
from test_torch_env_kernel import oracle_tiles  # noqa: F401

torch.set_num_threads(2)

SCENES = os.path.join(os.path.dirname(__file__), "..", "scenes")
SEED = 0
N_SAMPLES = 2


def lognormal_map(h, w, seed=11, sigma=0.5):
    """A map whose every texel differs from its neighbours (a lookup of a
    wrong texel shows), f32 [h, w, 3]."""
    rng = np.random.default_rng(seed)
    return rng.lognormal(0.0, sigma, size=(h, w, 3)).astype(np.float32)


def meadow_resampled(h, w):
    """The meadow map resampled bilinearly to h x w, f32 [h, w, 3]."""
    img = torch.as_tensor(read_hdr(os.path.join(SCENES, "meadow.hdr"))).permute(2, 0, 1)
    out = torch.nn.functional.interpolate(img[None], size=(h, w), mode="bilinear",
                                          align_corners=False)
    return out[0].permute(1, 2, 0).contiguous().numpy()


def big_scene_pair(img):
    """(JAX scene, port scene on the CPU): env_spheres at 64x64 under ``img``."""
    desc_j = jparse(env_spheres_text(), base_dir=SCENES)
    desc_t = parse_scene(env_spheres_text(), base_dir=SCENES)
    desc_j = dataclasses.replace(desc_j, env_image=img)
    desc_t = dataclasses.replace(desc_t, env_image=img)
    return JScene.from_desc(desc_j), Scene.from_desc(desc_t, "cpu")


@pytest.mark.parametrize("cfg, variant", [(dict(trace_depth=3), "env_exact"),
                                          (dict(trace_depth=3, nee=True), "env_nee")],
                         ids=["exact", "env-nee"])
def test_plain_version_past_the_cap_matches_the_uncapped_oracle(cfg, variant, monkeypatch):
    """K3 and K4 over a 256x1024 map (262,144 texels, twice the JAX cap)."""
    jscene, scene = big_scene_pair(meadow_resampled(256, 1024))
    with pytest.raises(ValueError, match="supports maps up to"):
        jmk.render_samples(jscene, JConfig(**cfg), jnp.int32(SEED), jnp.int32(1), N_SAMPLES,
                           interpret=True)
    monkeypatch.setattr(jmk, "MAX_ENV_EXACT_TEXELS", 256 * 1024)
    config = RenderConfig(**cfg)
    if config.nee:
        # past 2^15 texels the port draws env NEE's alias cells from words
        # of their own where the JAX rows take them from u1 (ROADMAP Queue
        # 3), so the oracle kernel reads the port's rows: K4 is compared on
        # the same rows
        rows = jnp.asarray(tmk.build_env_nee_rows(scene.envmap, SEED, 1, N_SAMPLES,
                                                  config.trace_depth).numpy())
        monkeypatch.setattr(jmk, "_build_env_nee_rows", lambda *args: rows)
    assert tmk.variant_name(tmk.kernel_options(config, scene)) == variant
    want = np.asarray(jmk.render_samples(
        jscene, JConfig(**cfg), jnp.int32(SEED), jnp.int32(1), N_SAMPLES, interpret=True))
    got = tmk.render_samples(scene, config, SEED, 1, N_SAMPLES)
    assert_within_oracle_tolerance(got.numpy(), want)


def test_lookup_at_2048x4096_matches_jax_env_radiance():
    """``_env_lookup`` over a 2048x4096 map (its texel table packed too)
    against the JAX bilinear radiance, 1e5 seeded directions plus the pole rows
    and the azimuth seam (the bound and its reason: the module's
    docstring)."""
    img = lognormal_map(2048, 4096)
    strength = 1.5
    scene = Scene.from_desc(dataclasses.replace(
        parse_scene(env_spheres_text(), base_dir=SCENES), env_image=img, env_strength=strength),
        "cpu")
    packed = tmk.pack_scene(scene, config=RenderConfig())
    assert packed.env.tex.shape == (2048 * 4096 * 4,)
    rng = np.random.default_rng(5)
    d = rng.normal(size=(100_000, 3))
    d[:6] = [[1e-4, 1, 0], [0, -1, 1e-4], [0, 0, 1], [0, 0, -1], [1e-9, 0.3, 1],
             [-1e-9, 0.3, 1]]
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    t = torch.as_tensor(d)
    got = torch.stack(tmk._env_lookup(packed.env, t[:, 0], t[:, 1], t[:, 2]), dim=-1).numpy()
    want = np.asarray(jenv.env_radiance(jenv.build_envmap(img, strength), jnp.asarray(d)))
    rel = np.abs(got - want) / np.abs(want)
    print(f"lookup at 2048x4096 vs JAX env_radiance: largest relative {rel.max():.3e}")
    np.testing.assert_allclose(got, want, rtol=5e-3, atol=1e-6)


def test_a_map_past_the_kernels_limit_raises():
    """Past MAX_ENV_TEXELS (h·w·4 floats no longer take 32-bit offsets) the
    kernel's options raise, and so does the router: it never sends the map
    to another pipeline. A map at the limit is taken. (The maps are
    broadcast views: nothing of their size is allocated.)"""
    scene = Scene.from_desc(parse_scene(env_spheres_text(), base_dir=SCENES), "cpu")

    def with_shape(h, w):
        img = torch.zeros((1, 1, 3)).expand(h, w, 3)
        return scene.replace(envmap=dataclasses.replace(scene.envmap, img=img))

    at_limit = with_shape(16384, tmk.MAX_ENV_TEXELS // 16384)
    assert tmk.kernel_options(RenderConfig(), at_limit).env == "exact"
    assert RenderConfig().resolve_pipeline(at_limit) == "pallas"
    past = with_shape(16384, tmk.MAX_ENV_TEXELS // 16384 + 1)
    for cfg in (RenderConfig(), RenderConfig(nee=True)):
        with pytest.raises(ValueError, match="MAX_ENV_TEXELS"):
            tmk.kernel_options(cfg, past)
        with pytest.raises(ValueError, match="MAX_ENV_TEXELS"):
            cfg.resolve_pipeline(past)
    # the split mode reads no texel table in the kernel
    assert RenderConfig(env_mode="split").resolve_pipeline(past) == "pallas"
