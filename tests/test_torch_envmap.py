"""PyTorch port, environment maps outside the kernel: the map's tables, the
sun/sky split, the lookups and the sampler (``ops/envmap.py``), env NEE's
shared rows, the scene and ``convert`` hand-over, the primary rays and miss
mask of the split mode's background composite (``ops/camera.py``,
``ops/intersect.py``), the routing of ``resolve_pipeline`` and the raises,
against the JAX package.

Tolerances: the tables (alias probabilities and partners, pdf, the split's
suns and SH coefficients) are exactly equal: both packages build them in
float64 NumPy with the same operations. The lookups and the sampler run
torch's atan2/acos/sin/cos where JAX runs XLA's, which differ in the last
ulp: directions within 1e-6, radiance within 5e-5 relative, and the
piecewise-constant pdf equal on all but 0.1% of directions (a last-ulp
(u, v) on a texel edge picks the neighbour). Measured on the development
host (jax 0.9.0, torch 2.13.0 CPU), meadow.hdr: sampled directions within
5.7e-7, bilinear radiance within 1.32e-5 relative (1.64e-5 in the env-NEE
rows: meadow's sun texels are ~4000x its sky, so an ulp of u moves the
blend visibly), every pdf and every row's pdf equal; the primary miss mask
of env_spheres at 800×800 equal on every pixel.
"""

import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cosc_4397_pathtracing_raytracing_project_tpu import RenderConfig as JConfig
from cosc_4397_pathtracing_raytracing_project_tpu.io.png import read_hdr
from cosc_4397_pathtracing_raytracing_project_tpu.ops import camera as jcamera
from cosc_4397_pathtracing_raytracing_project_tpu.ops import envmap as jenv
from cosc_4397_pathtracing_raytracing_project_tpu.ops import intersect as jintersect
from cosc_4397_pathtracing_raytracing_project_tpu.ops.pallas import megakernel as jmk
from cosc_4397_pathtracing_raytracing_project_tpu.render import engine as jengine
from cosc_4397_pathtracing_raytracing_project_tpu.scene import Scene as JScene
from cosc_4397_pathtracing_raytracing_project_tpu.scene import load_scene_desc as jload
from cosc_4397_pathtracing_raytracing_project_tpu.scene import parse_scene as jparse
from cosc_4397_pathtracing_raytracing_project_tpu_torch import (
    AdaptiveRenderer,
    RenderConfig,
    Renderer,
    Scene,
    convert,
    load_scene_desc,
    parse_scene,
)
from cosc_4397_pathtracing_raytracing_project_tpu_torch.ops import camera as tcamera
from cosc_4397_pathtracing_raytracing_project_tpu_torch.ops import envmap as tenv
from cosc_4397_pathtracing_raytracing_project_tpu_torch.ops import intersect as tintersect
from cosc_4397_pathtracing_raytracing_project_tpu_torch.ops.cuda import megakernel as tmk

from test_torch_cuda import env_scene_text, write_env_map

torch.set_num_threads(2)

SCENES = os.path.join(os.path.dirname(__file__), "..", "scenes")
MEADOW = os.path.join(SCENES, "meadow.hdr")


def _map(kind, tmp_path):
    if kind == "meadow":
        return read_hdr(MEADOW)
    return read_hdr(write_env_map(tmp_path, kind))


def _dirs(n=4096, seed=5):
    d = np.random.default_rng(seed).normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    # the poles and the azimuth seam, where the lookups clamp and wrap
    d[:6] = [[0, 1, 0], [0, -1, 0], [0, 0, 1], [0, 0, -1], [1e-9, 0.3, 1], [-1e-9, 0.3, 1]]
    d[:6] /= np.linalg.norm(d[:6], axis=1, keepdims=True)
    return d.astype(np.float32)


def _pair(kind, tmp_path):
    img = _map(kind, tmp_path)
    return jenv.build_envmap(img, 1.5), tenv.build_envmap(img, 1.5, "cpu")


@pytest.mark.parametrize("kind", ["const", "sun", "meadow"])
def test_build_envmap_tables_equal_jax(kind, tmp_path):
    want, got = _pair(kind, tmp_path)
    for f in ("img", "alias_prob", "alias_idx", "pdf", "strength"):
        w = np.asarray(getattr(want, f))
        g = getattr(got, f).numpy()
        assert g.dtype == w.dtype, f
        np.testing.assert_array_equal(g, w, err_msg=f)


@pytest.mark.parametrize("kind", ["sun", "meadow"])
def test_split_envmap_equals_jax(kind, tmp_path):
    img = _map(kind, tmp_path).astype(np.float64) * 1.5
    want = jenv.split_envmap(img, max_suns=8, thresh=32.0)
    got = tenv.split_envmap(img, max_suns=8, thresh=32.0)
    assert got == want
    assert len(got[0]) >= 1  # both maps hold a sun


@pytest.mark.parametrize("kind", ["sun", "meadow"])
def test_lookups_match_jax(kind, tmp_path):
    jmap, tmap = _pair(kind, tmp_path)
    d = _dirs()
    ju, jv = (np.asarray(a) for a in jenv.dir_to_uv(jnp.asarray(d)))
    tu, tv = (a.numpy() for a in tenv.dir_to_uv(torch.as_tensor(d)))
    np.testing.assert_allclose(tu, ju, atol=1e-6)
    np.testing.assert_allclose(tv, jv, atol=1e-6)
    back = tenv.uv_to_dir(torch.as_tensor(tu), torch.as_tensor(tv)).numpy()
    np.testing.assert_allclose(back, np.asarray(jenv.uv_to_dir(jnp.asarray(tu), jnp.asarray(tv))),
                               atol=1e-6)
    np.testing.assert_allclose(back, d, atol=2e-6)
    np.testing.assert_allclose(
        tenv.env_radiance(tmap, torch.as_tensor(d)).numpy(),
        np.asarray(jenv.env_radiance(jmap, jnp.asarray(d))), rtol=5e-5, atol=1e-7,
    )
    same = tenv.env_pdf(tmap, torch.as_tensor(d)).numpy() == np.asarray(
        jenv.env_pdf(jmap, jnp.asarray(d)))
    assert same.mean() >= 0.999


@pytest.mark.parametrize("kind", ["sun", "meadow"])
def test_sample_env_matches_jax(kind, tmp_path):
    jmap, tmap = _pair(kind, tmp_path)
    u = np.random.default_rng(11).random((4096, 2)).astype(np.float32)
    jd, jl, jp = (np.asarray(a) for a in jenv.sample_env(jmap, jnp.asarray(u[:, 0]),
                                                         jnp.asarray(u[:, 1])))
    td, tl, tp = (a.numpy() for a in tenv.sample_env(tmap, torch.as_tensor(u[:, 0]),
                                                     torch.as_tensor(u[:, 1])))
    np.testing.assert_allclose(td, jd, atol=1e-6)
    np.testing.assert_array_equal(tl, jl)
    np.testing.assert_array_equal(tp, jp)


def test_sh9_matches_jax():
    _suns, sh = jenv.split_envmap(read_hdr(MEADOW).astype(np.float64))
    d = _dirs()
    want = jenv.sh9_eval(sh, *(jnp.asarray(d[:, i]) for i in range(3)))
    got = tenv.sh9_eval(sh, *(torch.as_tensor(d[:, i]) for i in range(3)))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=1e-6)
    for g, w in zip(tenv.sh9_basis(torch.as_tensor(d)), jenv.sh9_basis(jnp.asarray(d))):
        np.testing.assert_allclose(np.broadcast_to(g.numpy(), d.shape[:1]), np.asarray(w),
                                   rtol=1e-6)


@pytest.mark.parametrize("seed, iter_base", [(0, 1), (-7, 51), (2**31 - 5, 1001)])
def test_env_nee_rows_match_jax(seed, iter_base):
    """One alias draw per (iteration, depth) from the same threefry streams:
    the same texels (pdf equal), directions and bilinear radiance to the
    last ulp of the trigonometry."""
    jmap, tmap = _pair("meadow", None)
    want = np.asarray(jmk._build_env_nee_rows(jmap, jnp.int32(seed), jnp.int32(iter_base), 6, 8))
    got = tmk.build_env_nee_rows(tmap, seed, iter_base, 6, 8).numpy()
    assert got.shape == want.shape == (48, 8)
    np.testing.assert_allclose(got[:, :3], want[:, :3], atol=1e-6)
    np.testing.assert_allclose(got[:, 3:6], want[:, 3:6], rtol=5e-5)
    np.testing.assert_array_equal(got[:, 6:], want[:, 6:])


def test_env_nee_rows_are_keyed_by_absolute_iteration():
    """A Renderer step builds the rows of all its iterations at once and
    each launch reads its slice: the slice equals the launch's own rows."""
    _jmap, tmap = _pair("meadow", None)
    whole = tmk.build_env_nee_rows(tmap, 5, 1, 120, 4)
    part = tmk.build_env_nee_rows(tmap, 5, 51, 50, 4)
    torch.testing.assert_close(whole[50 * 4:100 * 4], part, rtol=0, atol=0)


def test_kernel_lookup_matches_env_radiance():
    """The kernel's polynomial lookup against the library-trigonometry
    ``env_radiance`` (the bound of tests/test_envmap.py's background rows)."""
    desc = load_scene_desc(os.path.join(SCENES, "env_spheres.txt"))
    packed = tmk.pack_scene(Scene.from_desc(desc, "cpu"), config=RenderConfig())
    d = torch.as_tensor(_dirs())
    got = torch.stack(tmk._env_lookup(packed.env, d[:, 0], d[:, 1], d[:, 2]), dim=-1)
    want = tenv.env_radiance(packed.env.envmap, d)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=3e-4, atol=1e-5)


def test_scene_from_desc_and_convert_carry_the_map():
    jscene = JScene.from_desc(jload(os.path.join(SCENES, "env_spheres.txt")))
    scene = Scene.from_desc(load_scene_desc(os.path.join(SCENES, "env_spheres.txt")), "cpu")
    fields = ("material_id", "geom_index", "transform", "inv_transform", "inv_transpose")
    leaves = lambda obj, fs: {f: np.asarray(getattr(obj, f)) for f in fs}  # noqa: E731
    d = {
        "cubes": leaves(jscene.cubes, fields),
        "spheres": leaves(jscene.spheres, fields),
        "triangles": leaves(jscene.triangles, ("material_id",)),
        "materials": leaves(jscene.materials, (
            "color", "specular_color", "specular_exponent", "reflectivity",
            "refractive", "ior", "emittance")),
        "camera": dict(leaves(jscene.camera, ("position", "view", "up", "right",
                                              "pixel_length", "aperture", "focal")),
                       resolution=jscene.camera.resolution),
        "envmap": jscene.envmap,
    }
    converted = convert.scene_from_jax_arrays(d, "cpu")
    for s in (scene, converted):
        for f in ("img", "alias_prob", "alias_idx", "pdf", "strength"):
            np.testing.assert_array_equal(getattr(s.envmap, f).numpy(),
                                          np.asarray(getattr(jscene.envmap, f)), err_msg=f)
    cfg = RenderConfig(env_mode="split")
    a, b = (tmk.pack_scene(s, config=cfg) for s in (scene, converted))
    assert a.env.sh_coeffs == b.env.sh_coeffs
    np.testing.assert_array_equal(a.env.bg.numpy(), b.env.bg.numpy())
    # the JAX split tables, as _static_env_split derives them
    suns, sh, bg_external = jmk._static_env_split(jscene, JConfig(env_mode="split"))
    assert a.env.sh_coeffs == sh and bg_external
    np.testing.assert_array_equal(a.env.suns, np.asarray(suns, np.float32).reshape(-1, 6))


def test_primary_rays_and_miss_mask_match_jax():
    """The split mode's composite: primary rays within 1e-6 and their miss
    mask equal on every pixel of env_spheres at 800×800 (silhouettes
    included); the full hit record at 64×64."""
    desc = jload(os.path.join(SCENES, "env_spheres.txt"))
    jscene = JScene.from_desc(desc)
    scene = Scene.from_desc(load_scene_desc(os.path.join(SCENES, "env_spheres.txt")), "cpu")
    jo, jd = jcamera.generate_rays(jscene.camera)
    to, td = tcamera.generate_rays(scene.camera)
    np.testing.assert_array_equal(to.numpy(), np.asarray(jo))
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), atol=1e-6)
    jmiss = np.asarray(jintersect.intersect_scene(jscene, jo, jd).miss)
    tmiss = tintersect.intersect_scene(scene, torch.as_tensor(np.array(jo)),
                                       torch.as_tensor(np.array(jd))).miss.numpy()
    assert 0.1 < jmiss.mean() < 0.9
    np.testing.assert_array_equal(tmiss, jmiss)

    desc.camera.resolution = (64, 64)
    small = JScene.from_desc(desc)
    o, d = jcamera.generate_rays(small.camera)
    want = jintersect.intersect_scene(small, o, d)
    tsmall = convert.scene_from_jax_arrays({
        "cubes": {f: np.asarray(getattr(small.cubes, f)) for f in (
            "material_id", "geom_index", "transform", "inv_transform", "inv_transpose")},
        "spheres": {f: np.asarray(getattr(small.spheres, f)) for f in (
            "material_id", "geom_index", "transform", "inv_transform", "inv_transpose")},
        "materials": {f: np.asarray(getattr(small.materials, f)) for f in (
            "color", "specular_color", "specular_exponent", "reflectivity", "refractive",
            "ior", "emittance")},
        "camera": dict({f: np.asarray(getattr(small.camera, f)) for f in (
            "position", "view", "up", "right", "pixel_length", "aperture", "focal")},
            resolution=small.camera.resolution),
    }, "cpu")
    got = tintersect.intersect_scene(tsmall, torch.as_tensor(np.array(o)),
                                     torch.as_tensor(np.array(d)))
    hit = ~np.asarray(want.miss)
    for f in ("miss", "material_id", "geom_index", "outside"):
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(want, f)),
                                      err_msg=f)
    for f in ("t", "point", "normal"):
        np.testing.assert_allclose(getattr(got, f).numpy()[hit],
                                   np.asarray(getattr(want, f))[hit], rtol=1e-5, atol=1e-5,
                                   err_msg=f)


# ─────────────────────────── routing and raises ───────────────────────────


def _scenes(kind, tmp_path):
    """(JAX scene, port scene) of one routing case's scene; 'oversize' is
    the env-only scene under a 512x1024 map (four times the JAX kernel's
    cap), built in full on the port's side, which renders it."""
    if kind == "oversize":
        jscene, scene = _scenes("env-only", tmp_path)
        big = np.full((512, 1024, 3), 0.05, np.float32)
        big[100, 200] = [120.0, 100.0, 80.0]
        return (jscene.replace(envmap=jscene.envmap.replace(img=jnp.asarray(big))),
                scene.replace(envmap=tenv.build_envmap(big, float(scene.envmap.strength),
                                                       "cpu")))
    path = write_env_map(tmp_path, "sun")
    text = env_scene_text(path, res=16, light=kind == "mixed")
    return (JScene.from_desc(jparse(text, base_dir=str(tmp_path))),
            Scene.from_desc(parse_scene(text, base_dir=str(tmp_path)), "cpu"))


ROUTES = [
    ("env-only", dict()),
    ("env-only", dict(nee=True)),
    ("env-only", dict(env_mode="split")),
    ("env-only", dict(env_mode="split", nee=True)),
    ("env-only", dict(gather_mode="throughput")),
    ("mixed", dict()),
    ("mixed", dict(nee=True)),
    ("mixed", dict(env_mode="split", nee=True)),
    ("oversize", dict()),
    ("oversize", dict(env_mode="split")),
    ("oversize", dict(nee=True)),
]


@pytest.mark.parametrize("kind, cfg", ROUTES, ids=[f"{k}-{c}" for k, c in ROUTES])
def test_resolve_pipeline_routes_as_jax_on_its_accelerator(kind, cfg, tmp_path, monkeypatch):
    """"pallas" exactly where the JAX package's accelerator branch picks
    it, "fast" where it picks the fast pipeline, but for one deliberate
    deviation (ROADMAP Queue 3): an exact map past the JAX kernel's VMEM
    cap, which JAX sends to "fast", stays in the port's megakernel, which
    reads the map from device memory."""
    jscene, scene = _scenes(kind, tmp_path)
    monkeypatch.setattr(jengine.jax, "devices", lambda: [type("D", (), {"platform": "tpu"})()])
    want = JConfig(**cfg).resolve_pipeline(jscene)
    monkeypatch.undo()
    assert want in ("pallas", "fast")
    if kind == "oversize" and cfg.get("env_mode") != "split":
        assert want == "fast"
        want = "pallas"
    assert RenderConfig(**cfg).resolve_pipeline(scene) == want


RAISES = [
    ("mixed", dict(nee=True), "analytic emissive lights"),
    ("oversize", dict(), "supports maps up to"),
    ("env-only", dict(gather_mode="throughput"), "requires gather_mode='light_only'"),
    ("env-only", dict(env_mode="split", gather_mode="throughput"),
     "split' requires gather_mode='light_only'"),
]


@pytest.mark.parametrize("kind, cfg, match", RAISES, ids=[r[2][:16] for r in RAISES])
def test_render_samples_raises_as_jax(kind, cfg, match, tmp_path):
    """The port raises where the JAX package does, but for the deliberate
    deviation (ROADMAP Queue 3): an exact map past the JAX kernel's cap,
    which the port renders in-kernel (finite, lit)."""
    jscene, scene = _scenes(kind, tmp_path)
    with pytest.raises(ValueError, match=match):
        jmk.render_samples(jscene, JConfig(**cfg), jnp.int32(0), jnp.int32(1), 1, interpret=True)
    if kind == "oversize":
        out = tmk.render_samples(scene, RenderConfig(**cfg), 0, 1, 1)
        assert out.shape == (scene.camera.pixel_count, 3)
        assert bool(torch.isfinite(out).all()) and float(out.mean()) > 0.0
        return
    with pytest.raises(ValueError, match=match):
        tmk.render_samples(scene, RenderConfig(**cfg), 0, 1, 1)


@pytest.mark.parametrize("cfg, match", [(dict(env_mode="split"), "split"),
                                        (dict(nee=True), "env NEE rows")])
def test_tile_dispatch_raises_as_jax(cfg, match, tmp_path):
    """The adaptive sampler carries exact environments only, without nee:
    the JAX render_tiles' messages, from render_tiles and from the
    AdaptiveRenderer before any launch."""
    jscene, scene = _scenes("env-only", tmp_path)
    ids = np.zeros(1, np.int32)
    px = np.zeros(jmk.TILE, np.float32)
    with pytest.raises(ValueError, match=match):
        jmk.render_tiles(jscene, JConfig(**cfg), jnp.int32(0), jnp.asarray(ids),
                         jnp.asarray(ids + 1), jnp.asarray(px).reshape(-1, jmk.LANES),
                         jnp.asarray(px).reshape(-1, jmk.LANES), 1, interpret=True)
    t = torch.as_tensor
    with pytest.raises(ValueError, match=match):
        tmk.render_tiles(scene, RenderConfig(**cfg), 0, t(ids), t(ids + 1), t(px), t(px), 1)
    with pytest.raises(ValueError, match=match):
        AdaptiveRenderer(scene, RenderConfig(**cfg), device="cpu")


def test_adaptive_rejects_an_oversize_map_as_jax(tmp_path):
    """The JAX AdaptiveRenderer rejects a map past its kernel's cap; the
    port's takes it (the deliberate deviation, ROADMAP Queue 3) and renders
    it through the tile dispatch with the exact environment."""
    jscene, scene = _scenes("oversize", tmp_path)
    from cosc_4397_pathtracing_raytracing_project_tpu.render.adaptive import (
        AdaptiveRenderer as JAdaptive,
    )

    with pytest.raises(ValueError, match="megakernel pipeline"):
        JAdaptive(jscene, JConfig(), interpret=True)
    ada = AdaptiveRenderer(scene, RenderConfig(samples_per_launch=8), device="cpu")
    ada.render(8)
    img = ada.linear_image()
    assert img.shape == (16, 16, 3) and np.isfinite(img).all() and img.mean() > 0.0


def test_too_many_suns_raise(tmp_path):
    """More suns than the kernel carries by value (MAX_SUNS) raise."""
    img = np.full((32, 64, 3), 0.05, np.float32)
    img[16, ::2] = 500.0  # 32 hard texels, then one more
    img[8, 1] = 500.0
    path = os.path.join(str(tmp_path), "many.hdr")
    from cosc_4397_pathtracing_raytracing_project_tpu_torch.io.png import write_hdr

    write_hdr(path, img)
    scene = Scene.from_desc(parse_scene(env_scene_text(path, res=8), base_dir=str(tmp_path)),
                            "cpu")
    with pytest.raises(ValueError, match="MAX_SUNS"):
        tmk.pack_scene(scene, config=RenderConfig(env_mode="split", env_split_suns=64))
    with pytest.warns(UserWarning, match="33 texels"):
        packed = tmk.pack_scene(scene, config=RenderConfig(env_mode="split"))
    assert packed.env.num_suns == 8


def test_renderer_renders_every_env_mode_on_the_cpu():
    """Renderer(env_spheres) in exact, exact + nee and split mode runs the
    plain version on the CPU and returns finite, lit images."""
    desc = load_scene_desc(os.path.join(SCENES, "env_spheres.txt"))
    desc.camera.resolution = (32, 32)
    for cfg in (dict(), dict(nee=True), dict(env_mode="split")):
        r = Renderer(desc, RenderConfig(trace_depth=2, samples_per_launch=2, **cfg), device="cpu")
        r.render(2)
        img = r.linear_image()
        assert img.shape == (32, 32, 3) and np.isfinite(img).all() and img.mean() > 0.1
