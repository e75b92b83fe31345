"""PyTorch port, environment NEE's alias draw (``ops/envmap.sample_env``)
under maps of every size: the distribution of its directions, not only the
mean of radiance / pdf.

The JAX package's draw takes the alias cell from the integer part of
``u1·n``, stay-or-alias from the fraction and the azimuth offset from the
fraction's leftover. ``u1`` has 23 bits, so a map of n texels leaves the
choice 23 − log2(n) bits, none at 2^23 texels (2048×4096), where the alias
is never taken. Past 2^15 texels the port draws the cell from a 64-bit word
of its own (``rng.env_cell_words``; a deliberate deviation, ROADMAP Queue 3)
and keeps the JAX draw bit for bit at and below 2^15.

Each map draws 2^22 directions from the pipelines' own streams
(``rng.env_uniforms`` and ``rng.env_cell_words`` of seed 3, iteration 1,
depth 0): the meadow (128×256) and the meadow resampled bilinearly to
512×1024 and 2048×4096 (as ``test_torch_env_big.py`` builds them). Two
measures:

- block χ²/dof: the directions binned into 16×32 blocks of texels against
  the table's probability of each block (511 dof). A sound sampler reads
  1 ± 0.06 (one σ of χ²/dof at 511 dof); the bound is 1.3;
- cosine integrals: the mean of ``max(0, n·d)·lum(L)/pdf`` over the draws
  for n = +y and n = +x, against the texel-wise integral ``Σ lum(L_i)
  ∫_texel max(0, n·d) dω`` (the estimator's expectation: nearest-texel
  radiance, directions uniform in solid angle within the texel), as a z
  score against the draws' standard error; the bound is |z| ≤ 4. (The mean
  of radiance / pdf alone barely sees the fault: the pdf is nearly ∝
  luminance, so L/pdf is nearly constant whatever texel is drawn.)

Readings on the development host (torch 2.13.0 CPU), the seed above.
The JAX draw, which the port made at every size before this deviation (its
``sample_env`` run through this module's measures): χ²/dof 180.3 at
512×1024 and 91,320 at 2048×4096; the cosine integrals 0.9888 (z −46.4)
and 0.9777 (z −79.0) at 512×1024, 0.7293 (z −627) and 0.4896 (z −1494) at
2048×4096. Both bounds fail there. The port's draw: χ²/dof 1.075 and
1.024, the integrals within 1.3e-4 (|z| ≤ 0.48). At 128×256, where the
port keeps the JAX draw, χ²/dof reads 1.419 and the integrals 0.99938
(z −1.49) and 0.99872 (z −2.78): that residual is recorded; the test holds
the draw to JAX's (texel, radiance and pdf bit for bit, the direction
within the trigonometry's last bits, 2e-6) and the integrals within 0.5%,
and prints χ²/dof.
"""

import math
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cosc_4397_pathtracing_raytracing_project_tpu.ops import envmap as jenv
from cosc_4397_pathtracing_raytracing_project_tpu_torch import RenderConfig, Scene, parse_scene
from cosc_4397_pathtracing_raytracing_project_tpu_torch.io.png import read_hdr
from cosc_4397_pathtracing_raytracing_project_tpu_torch.ops import envmap as tenv
from cosc_4397_pathtracing_raytracing_project_tpu_torch.ops import fast
from cosc_4397_pathtracing_raytracing_project_tpu_torch.ops import rng as trng
from cosc_4397_pathtracing_raytracing_project_tpu_torch.ops.cuda import megakernel as tmk
from cosc_4397_pathtracing_raytracing_project_tpu_torch.render import engine

from test_torch_cuda import env_spheres_text
from test_torch_env_big import meadow_resampled

torch.set_num_threads(2)

SCENES = os.path.join(os.path.dirname(__file__), "..", "scenes")
N_DRAWS = 1 << 22
SEED = 3
BLOCKS = (16, 32)
CHI2_BOUND = 1.3
Z_BOUND = 4.0
LUM = (0.2126, 0.7152, 0.0722)


def meadow(h, w):
    if (h, w) == (128, 256):
        return read_hdr(os.path.join(SCENES, "meadow.hdr")).astype(np.float32)
    return meadow_resampled(h, w)


def draw(env, n=N_DRAWS):
    """``n`` directions from the pipelines' streams: (u [n, 2], cell words
    [n, 2] or None, sample_env's (d, radiance, pdf))."""
    u = trng.env_uniforms(SEED, 1, 0, n)
    words = trng.env_cell_words(SEED, 1, 0, n) if tenv.needs_cell_words(env) else None
    return u, words, tenv.sample_env(env, u[:, 0], u[:, 1], words)


def block_chi2(img, d):
    """χ²/dof of the directions' 16×32 block counts against the table's
    probability of each block (from ``texel_distribution``, float64)."""
    h, w = img.shape[:2]
    p, _pdf = tenv.texel_distribution(img)
    by, bx = BLOCKS
    expected = p.reshape(by, h // by, bx, w // bx).sum(axis=(1, 3)) * d.shape[0]
    u, v = tenv.dir_to_uv(d)
    iy = torch.clamp((v * by).to(torch.int64), 0, by - 1)
    ix = torch.clamp((u * bx).to(torch.int64), 0, bx - 1)
    counts = torch.bincount(iy * bx + ix, minlength=by * bx).numpy().reshape(by, bx)
    return float(((counts - expected) ** 2 / expected).sum()) / (by * bx - 1)


def cosine_integrals(img, d, radiance, pdf):
    """For n = +y and n = +x: (ratio of the draws' mean to the texel-wise
    integral, z score). The integral is exact per texel: ∫ max(0, cosθ) dω
    over a band is Δφ·(max(0, cosθ0)² − max(0, cosθ1)²)/2, ∫ max(0,
    sinθ·sinφ) dω is ∫ sin²θ dθ · ∫ max(0, sinφ) dφ, with φ = (u − 0.5)·2π."""
    h, w = img.shape[:2]
    lum = (LUM[0] * img[..., 0].astype(np.float64) + LUM[1] * img[..., 1]
           + LUM[2] * img[..., 2])
    theta = np.linspace(0.0, math.pi, h + 1)
    phi = (np.arange(w + 1) / w - 0.5) * 2.0 * math.pi
    c = np.maximum(np.cos(theta), 0.0)
    band_y = (c[:-1] ** 2 - c[1:] ** 2) / 2.0 * (2.0 * math.pi / w)
    s2 = (theta - np.sin(theta) * np.cos(theta)) / 2.0
    pos = np.where(phi > 0.0, 1.0 - np.cos(np.clip(phi, 0.0, math.pi)), 0.0)
    want = {"+y": float((lum * band_y[:, None]).sum()),
            "+x": float((lum * np.outer(np.diff(s2), np.diff(pos))).sum())}
    lum_d = (radiance.double() * torch.tensor(LUM, dtype=torch.float64)).sum(-1)
    out = {}
    for name, cos in (("+y", d[:, 1]), ("+x", d[:, 0])):
        x = (torch.clamp_min(cos.double(), 0.0) * lum_d / pdf.double()).numpy()
        out[name] = (x.mean() / want[name],
                     (x.mean() - want[name]) / (x.std() / math.sqrt(x.size)))
    return out


@pytest.mark.parametrize("size", [(128, 256), (512, 1024), (2048, 4096)],
                         ids=["128x256", "512x1024", "2048x4096"])
def test_alias_draw_follows_the_table(size):
    """The distribution bounds at 512×1024 and 2048×4096; at 128×256 the
    JAX draw and the integrals within 0.5% (the module's docstring gives
    the bounds, their readings and the JAX draw's failing ones)."""
    img = meadow(*size)
    env = tenv.build_envmap(img)
    u, words, (d, radiance, pdf) = draw(env)
    assert (words is None) == (size == (128, 256))
    chi2 = block_chi2(img, d)
    ints = cosine_integrals(img, d, radiance, pdf)
    print(f"{size[0]}x{size[1]}: block chi2/dof {chi2:.3f}; cosine integrals "
          + ", ".join(f"n = {k} {r:.5f} (z {z:+.2f})" for k, (r, z) in ints.items()))
    if size == (128, 256):
        jd, jl, jp = (np.asarray(a) for a in jenv.sample_env(
            jenv.build_envmap(img), jnp.asarray(u[:, 0].numpy()), jnp.asarray(u[:, 1].numpy())))
        np.testing.assert_array_equal(pdf.numpy(), jp)
        np.testing.assert_array_equal(radiance.numpy(), jl)
        np.testing.assert_allclose(d.numpy(), jd, atol=2e-6)
        for name, (ratio, _z) in ints.items():
            assert abs(ratio - 1.0) <= 5e-3, name
        return
    assert chi2 <= CHI2_BOUND
    for name, (_ratio, z) in ints.items():
        assert abs(z) <= Z_BOUND, name


def test_alias_cell_is_uniform_to_the_largest_map():
    """``alias_cell`` is floor(W·n / 2^64) of the word's 64 bits: exact
    against Python integers on edge words at the kernel's largest map and at
    maps whose size is not a power of two, so each cell takes floor or ceil
    of 2^64 / n words (uniform within n / 2^64 relative)."""
    top = (1 << 32) - 1
    for n in (tmk.MAX_ENV_TEXELS, 3 * 5 * 7 * 11 * 13 * 17 * 19, (1 << 15) + 1, 2048 * 4096):
        hi = torch.tensor([0, 0, top, top, 1 << 31, 12345, top, 0])
        lo = torch.tensor([0, top, 0, top, 0, 678, top - 1, 1])
        got = tenv.alias_cell(torch.stack([hi, lo], dim=-1), n).tolist()
        want = [((int(a) << 32 | int(b)) * n) >> 64 for a, b in zip(hi, lo)]
        assert got == want and max(got) == n - 1 and min(got) == 0


def test_pipelines_and_rows_draw_what_sample_env_draws(monkeypatch):
    """At 2048×4096 the same key gives the same draw everywhere: the plain
    rows (``build_env_nee_rows``) hold ``sample_env``'s directions and pdf
    for the row key's uniforms and cell words, and the fast and reference
    pipelines pass ``sample_env`` their depth's ``env_uniforms`` and
    ``env_cell_words`` (recorded through the module, 16×16 pixels, depth
    2); a map past the split without words raises."""
    img = meadow_resampled(2048, 4096)
    env = tenv.build_envmap(img)
    seed, iter_base, samples, depth = 5, 7, 6, 3
    rows = tmk.build_env_nee_rows(env, seed, iter_base, samples, depth)
    key = trng.prng_key(trng.u32(seed) ^ 0xE17B0075)
    keys = trng.fold_in(key, trng.u32(iter_base + torch.arange(samples)))
    u = trng.uniform(keys, (depth, 2)).reshape(-1, 2)
    words = trng.random_bits(trng.fold_in(keys, trng.ENV_CELL_TAG), (depth, 2)).reshape(-1, 2)
    d, _le, pdf = tenv.sample_env(env, u[:, 0], u[:, 1], words)
    assert torch.equal(rows[:, :3], d) and torch.equal(rows[:, 6], pdf)
    with pytest.raises(ValueError, match="cell_words"):
        tenv.sample_env(env, u[:, 0], u[:, 1])

    desc = parse_scene(env_spheres_text(res=16), base_dir=SCENES)
    desc.env_image = img
    scene = Scene.from_desc(desc, "cpu")
    config = RenderConfig(nee=True, trace_depth=2)
    calls = []
    sample_env = tenv.sample_env

    def recording(env_, u1, u2, cell_words=None):
        out = sample_env(env_, u1, u2, cell_words)
        calls.append((u1, u2, cell_words, out[0]))
        return out

    monkeypatch.setattr(tenv, "sample_env", recording)
    for run in (lambda: fast.trace_sample_fast(scene, config, seed, 2),
                lambda: engine.trace_sample(scene, config, seed, 2, pipeline="reference")):
        calls.clear()
        run()
        assert len(calls) == 2
        for depth_, (u1, u2, cw, dirs) in enumerate(calls):
            n = u1.shape[0]
            u = trng.env_uniforms(seed, 2, depth_, n)
            cw_want = trng.env_cell_words(seed, 2, depth_, n)
            assert torch.equal(u1, u[:, 0]) and torch.equal(u2, u[:, 1])
            assert torch.equal(cw, cw_want)
            assert torch.equal(dirs, sample_env(scene.envmap, u[:, 0], u[:, 1], cw_want)[0])
