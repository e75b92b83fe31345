"""PyTorch port on a CUDA card: the hand-written kernels against their plain
PyTorch versions. The megakernel on the same small scenes as
test_torch_megakernel.py, the option scenes of slice 2 and the environment
scenes of slice 3 (the meadow map of scenes/env_spheres.txt and small
synthetic maps, whose helpers the CPU environment tests share); the mesh
kernels K7/K8 on random triangle soups and scenes/mesh1080p.txt, and the
mesh pipeline's Renderer (the triangle helpers are shared with the CPU mesh
tests).

This module imports neither jax nor the JAX package, so it also runs where
only the port is installed (``python -m pytest tests/test_torch_cuda.py
--noconftest``); without a CUDA device its kernel cases (marked ``cuda``)
skip.

Two tolerances live here. ``assert_within_oracle_tolerance`` is the bound
of the port against the JAX interpret-mode oracle (test_torch_megakernel.py
and test_torch_engine.py state its reason). ``assert_matches_plain_version``
is the bound of the kernel against its plain version on the same card, where
both run the same IEEE operations in the same order (the kernel is built
without multiply-add contraction) and the same CUDA sinf/cosf: at most 1e-4
of pixels with a max-channel |Δ| above 1e-3, and per-channel image means
within 1e-4. Measured on an H100 at 800×800, depth 8: the kernel is
bit-identical to the plain version (max |Δ| 0) in every variant without
NEE, and within 1e-6 at 2 spp in the NEE variants, which add each light
ray's term to the pixel's sum from the warp's queue of light rays, after
the path's later terms (another float grouping of the same terms:
``assert_kernel_output``), while a build with contraction on (-fmad=true)
differs in 1.25e-5 of pixels by more than 1e-3 with a mean gap of 2.5e-5
(scripts/torch_measure.py, chip_smoke.py). The bound leaves room for
last-ulp noise of that size, while a fault on more than 64 of 640,000
pixels fails it.
"""

import os
import warnings

import numpy as np
import pytest
import torch

from cosc_4397_pathtracing_raytracing_project_tpu_torch import (
    AdaptiveRenderer,
    RenderConfig,
    Renderer,
    Scene,
    parse_scene,
)
from cosc_4397_pathtracing_raytracing_project_tpu_torch.io.png import write_hdr
from cosc_4397_pathtracing_raytracing_project_tpu_torch.ops import fast
from cosc_4397_pathtracing_raytracing_project_tpu_torch.ops.cuda import megakernel as tmk
from cosc_4397_pathtracing_raytracing_project_tpu_torch.ops.cuda import mesh_kernel as tmesh
from cosc_4397_pathtracing_raytracing_project_tpu_torch.render import profiling
from cosc_4397_pathtracing_raytracing_project_tpu_torch.render.adaptive import make_tile_layout
from cosc_4397_pathtracing_raytracing_project_tpu_torch.render.engine import (
    make_mesh_intersector,
)
from cosc_4397_pathtracing_raytracing_project_tpu_torch.scene import (
    CameraDesc,
    SceneDesc,
    transforms,
)
from cosc_4397_pathtracing_raytracing_project_tpu_torch.viewer import OrbitCameraController

torch.set_num_threads(2)

_SCENES = os.path.join(os.path.dirname(__file__), "..", "scenes")


def assert_within_oracle_tolerance(got, want):
    assert got.shape == want.shape and got.dtype == np.float32
    assert np.isfinite(got).all()
    diff = np.abs(got - want).max(axis=-1)
    frac = float((diff > 1e-3).mean())
    gap = np.abs(got.mean(axis=0) / want.mean(axis=0) - 1.0).max()
    # the readings the test docstrings quote (shown with pytest -s)
    print(f"vs oracle: share |d|>1e-3 {frac:.5f}, bit-identical "
          f"{float((diff == 0).mean()):.4f}, max |d| {diff.max():.3e}, mean gap {gap:.2e}")
    assert frac <= 0.005, f"{frac:.4%} of pixels differ by more than 1e-3"
    np.testing.assert_allclose(got.mean(axis=0), want.mean(axis=0), rtol=5e-3)


def assert_matches_plain_version(got, want):
    assert got.shape == want.shape and got.dtype == np.float32
    assert np.isfinite(got).all()
    diff = np.abs(got - want).max(axis=-1)
    frac = float((diff > 1e-3).mean())
    assert frac <= 1e-4, f"{frac:.4%} of pixels differ by more than 1e-3"
    np.testing.assert_allclose(got.mean(axis=0), want.mean(axis=0), rtol=1e-4)


def assert_kernel_output(got, want, nee):
    """The kernel's output against its plain version's on the same card: an
    NEE variant adds each light ray's term to the pixel's sum after the
    path's later terms (the light rays' queue: the same terms in another
    float grouping), so it is held to ``assert_matches_plain_version``;
    every other variant is bit for bit the plain version."""
    if nee:
        assert_matches_plain_version(got.cpu().numpy(), want.cpu().numpy())
    else:
        assert torch.equal(got, want)


def _scene_text(name, res=64):
    text = open(os.path.join(_SCENES, name)).read()
    return text.replace("RES         800 800", f"RES         {res} {res}")


def two_light_golden(text):
    """cornell_golden with its sphere turned into a second light on its own
    material (covers sphere-light sampling and the light-pick draw)."""
    text = text.replace(
        "// Specular white\nMATERIAL 4\nRGB         .98 .98 .98\nSPECEX      0\n"
        "SPECRGB     .98 .98 .98\nREFL        1",
        "// Sphere light\nMATERIAL 4\nRGB         1 .9 .7\nSPECEX      0\n"
        "SPECRGB     0 0 0\nREFL        0",
    ).replace("REFRIOR     0\nEMITTANCE   0\n\n// Camera", "REFRIOR     0\nEMITTANCE   2\n\n// Camera")
    return text.replace("// Sphere\nOBJECT 6\nsphere\nmaterial 1", "// Sphere\nOBJECT 6\nsphere\nmaterial 4")


def with_aperture(text, aperture=0.3):
    """The camera with a thin lens, as the CLI's --aperture sets it
    (auto-focus on LOOKAT)."""
    return text.replace("LOOKAT", f"APERTURE    {aperture}\nLOOKAT", 1)


def write_env_map(directory, kind):
    """A small synthetic environment map as an HDR file in ``directory``:
    'const' is 8×16 texels of 0.7, 'sun' 16×32 texels of a dim 0.05 sky
    with one hard bright texel (the env-NEE stress case)."""
    if kind == "const":
        img = np.full((8, 16, 3), 0.7, np.float32)
    else:
        img = np.full((16, 32, 3), 0.05, np.float32)
        img[4, 7] = [120.0, 100.0, 80.0]
    return write_hdr(os.path.join(str(directory), f"{kind}.hdr"), img)


def env_scene_text(map_file, res=64, light=False):
    """A ground slab, a diffuse and a mirror sphere under the environment
    ``map_file``; with ``light``, also a small emissive sphere."""
    text = f"""MATERIAL 0
RGB         .7 .7 .7
SPECEX      0
SPECRGB     0 0 0
REFL        0
REFR        0
REFRIOR     0
EMITTANCE   0

MATERIAL 1
RGB         .9 .9 .9
SPECEX      0
SPECRGB     .9 .9 .9
REFL        1
REFR        0
REFRIOR     0
EMITTANCE   0

MATERIAL 2
RGB         1 .9 .8
SPECEX      0
SPECRGB     0 0 0
REFL        0
REFR        0
REFRIOR     0
EMITTANCE   4

ENVIRONMENT
FILE {os.path.basename(map_file)}
STRENGTH 1

CAMERA
RES         {res} {res}
FOVY        35
ITERATIONS  64
DEPTH       3
FILE        env
EYE         0 1.5 7
LOOKAT      0 0.5 0
UP          0 1 0

OBJECT 0
cube
material 0
TRANS       0 -0.5 0
ROTAT       0 0 0
SCALE       20 1 20

OBJECT 1
sphere
material 0
TRANS       0.6 1 0
ROTAT       0 0 0
SCALE       2 2 2

OBJECT 2
sphere
material 1
TRANS       -1.6 0.6 1
ROTAT       0 0 0
SCALE       1.2 1.2 1.2
"""
    if light:
        text += "\nOBJECT 3\nsphere\nmaterial 2\nTRANS 1.5 2.6 1\nROTAT 0 0 0\nSCALE .6 .6 .6\n"
    return text


def env_spheres_text(res=64, aperture=None):
    """scenes/env_spheres.txt (the meadow map) at ``res``², optionally with
    a thin lens."""
    text = _scene_text("env_spheres.txt", res)
    return with_aperture(text, aperture) if aperture is not None else text


def many_cubes_text(n_cubes=20, n_materials=40, res=64, depth=3):
    """A box of ``n_cubes`` cubes (``n_cubes`` ≥ 2): a floor, then small
    cubes in a 6-wide grid, every third one rotated (a general transform),
    under the last one, an emissive slab. The file holds ``n_materials``
    materials and the cubes reference only the odd ids, so packing keeps
    about half of them and renumbers every geom's and the light's id."""
    text = ""
    for m in range(n_materials):
        c = (0.3 + 0.6 * ((m * 7) % 10) / 10, 0.3 + 0.6 * ((m * 3) % 10) / 10, 0.5)
        mirror = m % 10 == 5
        text += (f"MATERIAL {m}\nRGB {c[0]:.2f} {c[1]:.2f} {c[2]:.2f}\nSPECEX 0\n"
                 f"SPECRGB {'.9 .9 .9' if mirror else '0 0 0'}\nREFL {int(mirror)}\nREFR 0\n"
                 f"REFRIOR 0\nEMITTANCE {5 if m == n_materials - 1 else 0}\n\n")
    text += (f"CAMERA\nRES {res} {res}\nFOVY 45\nITERATIONS 16\nDEPTH {depth}\nFILE cubes\n"
             "EYE 0 5 10.5\nLOOKAT 0 4 0\nUP 0 1 0\n\n")
    odd = lambda k: (2 * k + 1) % n_materials  # noqa: E731
    text += f"OBJECT 0\ncube\nmaterial {odd(0)}\nTRANS 0 0 0\nROTAT 0 0 0\nSCALE 10 .01 10\n\n"
    for k in range(1, n_cubes - 1):
        x, z = -5 + 2 * ((k - 1) % 6), -3 + 2 * ((k - 1) // 6)
        rot = "20 35 10" if k % 3 == 0 else "0 0 0"
        text += (f"OBJECT {k}\ncube\nmaterial {odd(k)}\nTRANS {x} {0.5 + 0.4 * (k % 4)} {z}\n"
                 f"ROTAT {rot}\nSCALE 1 {0.8 + 0.3 * (k % 3)} 1\n\n")
    text += (f"OBJECT {n_cubes - 1}\ncube\nmaterial {n_materials - 1}\nTRANS 0 10 0\n"
             "ROTAT 0 0 0\nSCALE 3 .3 3\n")
    return text


def tri_scene_desc(res=32):
    """tests/test_fast_mesh.py's ``tri_scene``: an emissive slab (a cube,
    material 0) above a triangulated 8×8 floor of 72 triangles (material 1),
    at ``res``²."""
    tf, inv, invt = transforms.geom_matrices([0, 4, 0], [0, 0, 0], [2, 0.2, 2])
    xs = np.linspace(-4, 4, 7)
    verts = []
    for i in range(6):
        for j in range(6):
            a = [xs[i], 0, xs[j]]
            b = [xs[i + 1], 0, xs[j]]
            c = [xs[i], 0, xs[j + 1]]
            d = [xs[i + 1], 0, xs[j + 1]]
            verts.append([a, b, c])
            verts.append([b, d, c])
    tri = np.asarray(verts, np.float32)
    return SceneDesc(
        geom_type=np.array([0], np.int32),
        material_id=np.array([0], np.int32),
        translation=np.array([[0, 4, 0]], np.float32),
        rotation=np.zeros((1, 3), np.float32),
        scale=np.array([[2, 0.2, 2]], np.float32),
        transform=tf[None],
        inv_transform=inv[None],
        inv_transpose=invt[None],
        color=np.array([[1, 1, 1], [0.7, 0.5, 0.3]], np.float32),
        specular_exponent=np.zeros(2, np.float32),
        specular_color=np.zeros((2, 3), np.float32),
        reflectivity=np.zeros(2, np.float32),
        refractive=np.zeros(2, np.float32),
        ior=np.zeros(2, np.float32),
        emittance=np.array([5, 0], np.float32),
        camera=CameraDesc(
            (res, res), 45.0, np.array([0, 2.5, 9.0]), np.array([0, 1.5, 0.0]),
            np.array([0, 1, 0.0]),
        ),
        tri_vertices=tri,
        tri_material_id=np.full(len(tri), 1, np.int32),
    )


def triangle_soup(seed, t=300):
    """A random soup of ``t`` triangles (tests/test_megakernel.py's cluster
    kernel case): (v0, e1, e2, material ids) f32 / i32."""
    rng = np.random.default_rng(seed)
    v0 = rng.uniform(-5, 5, (t, 3)).astype(np.float32)
    e1 = rng.normal(size=(t, 3)).astype(np.float32)
    e2 = rng.normal(size=(t, 3)).astype(np.float32)
    return v0, e1, e2, rng.integers(0, 4, t).astype(np.int32)


def soup_rays(seed, n=512, inactive_every=5):
    """``n`` rays through the soup's volume: origins in [-8, 8]³, unit
    directions, every ``inactive_every``-th ray inactive; as f32 numpy
    (ox, oy, oz, dx, dy, dz, active)."""
    rng = np.random.default_rng(seed)
    o = rng.uniform(-8, 8, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    active = np.ones(n, np.float32)
    active[::inactive_every] = 0.0
    return (*o.T, *d.T, active)


def brute_force_mt(v0, e1, e2, rays):
    """Nearest hit of every ray over every triangle in index order, with the
    kernel's float32 Möller–Trumbore arithmetic (numpy rounds every
    operation, as the plain version does): (t [n], idx [n])."""
    ox, oy, oz, dx, dy, dz = (np.asarray(r, np.float32)[:, None] for r in rays[:6])
    v0x, v0y, v0z = v0.T[:, None, :]
    e1x, e1y, e1z = e1.T[:, None, :]
    e2x, e2y, e2z = e2.T[:, None, :]
    px = dy * e2z - dz * e2y
    py = dz * e2x - dx * e2z
    pz = dx * e2y - dy * e2x
    det = e1x * px + e1y * py + e1z * pz
    big = np.abs(det) > np.float32(1e-9)
    with np.errstate(divide="ignore", invalid="ignore"):
        inv_det = np.where(big, np.float32(1.0) / det, np.float32(0.0))
    tx, ty, tz = ox - v0x, oy - v0y, oz - v0z
    u = (tx * px + ty * py + tz * pz) * inv_det
    qx = ty * e1z - tz * e1y
    qy = tz * e1x - tx * e1z
    qz = tx * e1y - ty * e1x
    v = (dx * qx + dy * qy + dz * qz) * inv_det
    t = (e2x * qx + e2y * qy + e2z * qz) * inv_det
    ok = big & (u >= 0) & (v >= 0) & (u + v <= 1) & (t > np.float32(1e-4)) & (t < 1e30)
    tt = np.where(ok, t, np.float32(np.inf))
    idx = np.argmin(tt, axis=1)  # the first least distance, as a strict < in index order
    best = tt[np.arange(tt.shape[0]), idx]
    hit = np.isfinite(best)
    return np.where(hit, best, np.float32(1e30)).astype(np.float32), np.where(hit, idx, -1)


def octant_walk(tables, rays, walk="warp"):
    """The CUDA mesh kernel's walk, ray by ray in numpy: an active ray
    slab-tests every supercluster of its direction octant front to back, the
    16 clusters of each one it enters, and the rows of each cluster it
    enters (brute_force_mt, whose first least distance is what a strict
    ``t < best_t`` in row order keeps), all against its running best t.
    Returns (t [n], idx [n], work): ``work`` counts the supercluster slab
    tests ('sc_slab'), cluster slab tests ('cl_slab') and triangle tests
    ('tri'), as the kernel's counting build does, and the warp iterations
    that run them ('sc_warp', 'cl_warp', 'tri_warp') in the kernel's
    ``walk``. The lane walk: warps of 32 consecutive rays (the last one
    padded with inactive lanes), whose rays step through the superclusters
    together; those that enter a supercluster walk its clusters side by
    side, 16 iterations, then ``cluster_size`` for each cluster index that
    any of them enters. The warp walk: a warp serves each active ray alone,
    32 superclusters an iteration, then one iteration for the 16 cluster
    slabs of each supercluster the ray enters and ``cluster_size / 32`` for
    each cluster it enters."""
    assert walk in tmesh.WALKS
    tri = tables.tri_rows.cpu().numpy()
    sc = tables.sc_rows.cpu().numpy()
    cl = tables.cl_rows.cpu().numpy()
    s_count, cs = tables.num_super, tables.cluster_size
    ox, oy, oz, dx, dy, dz, active = (np.asarray(r, np.float32) for r in rays)
    t_out = np.full(len(ox), np.float32(1e30), np.float32)
    i_out = np.full(len(ox), -1)
    work = {"sc_slab": 0, "cl_slab": 0, "tri": 0}
    entered = {}  # ray -> {supercluster: [the clusters it enters]}
    for p in np.nonzero(active > 0.5)[0]:
        o = np.array([ox[p], oy[p], oz[p]], np.float32)
        d = np.array([dx[p], dy[p], dz[p]], np.float32)
        with np.errstate(divide="ignore"):
            inv = np.float32(1.0) / d
        octant = int(d[0] > 0) + 2 * int(d[1] > 0) + 4 * int(d[2] > 0)
        best, best_i = np.float32(1e30), -1

        def slab(box):
            with np.errstate(invalid="ignore"):
                t0, t1 = (box[0:3] - o) * inv, (box[3:6] - o) * inv
            lo, hi = np.minimum(t0, t1), np.maximum(t0, t1)  # NaN propagates
            tmin = np.maximum(np.maximum(lo[0], lo[1]), np.maximum(lo[2], np.float32(0.0)))
            tmax = np.minimum(np.minimum(hi[0], hi[1]), hi[2])
            return bool(tmax >= tmin) and bool(tmin < best)

        path = entered[p] = {}
        for s in range(s_count):
            work["sc_slab"] += 1
            if not slab(sc[octant * s_count + s]):
                continue
            path[s] = []
            for k in range(16):
                box = cl[(octant * s_count + s) * 16 + k]
                work["cl_slab"] += 1
                if not slab(box):
                    continue
                path[s].append(k)
                work["tri"] += cs
                rows = tri[int(box[6]): int(box[6]) + cs]
                bt, bj = brute_force_mt(rows[:, 0:3], rows[:, 3:6], rows[:, 6:9],
                                        [v[None] for v in (*o, *d)])
                if bj[0] >= 0 and bt[0] < best:
                    best, best_i = bt[0], int(rows[bj[0], 13])
        t_out[p], i_out[p] = best, best_i
    work.update(sc_warp=0, cl_warp=0, tri_warp=0)
    rows_step = -(-cs // 32)  # iterations of 32 lanes over a cluster's rows
    if walk == "warp":
        for ray in entered.values():
            work["sc_warp"] += -(-s_count // 32)
            work["cl_warp"] += len(ray)
            work["tri_warp"] += rows_step * sum(len(k) for k in ray.values())
        return t_out, i_out, work
    for w in range(0, len(ox), 32):
        rays_w = [entered[p] for p in range(w, min(w + 32, len(ox))) if p in entered]
        if not rays_w:
            continue
        work["sc_warp"] += s_count
        for s in range(s_count):
            ks = [ray[s] for ray in rays_w if s in ray]
            if ks:
                work["cl_warp"] += 16
                work["tri_warp"] += cs * len(set().union(*ks))
    return t_out, i_out, work


def _small(rotated=False):
    text = _scene_text("cornell.txt")
    if rotated:
        text = text.replace("ROTAT       0 0 90", "ROTAT       20 45 10", 1)
    return parse_scene(text)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


CASES = {
    "a-depth1-aa-sobol": (False, dict(trace_depth=1, antialias=True, sampler="sobol")),
    "b-depth3-hoisted-sobol": (False, dict(trace_depth=3, sampler="sobol")),
    "c-depth3-independent": (False, dict(trace_depth=3)),
    "d-rotated-depth2": (True, dict(trace_depth=2)),
    "e-depth8-sobol": (False, dict(trace_depth=8, sampler="sobol")),
    "f-depth8-aa-independent-sky": (
        False, dict(trace_depth=8, antialias=True, sky_strength=0.5)
    ),
}

# the slice's options, one scene text each (64×64, depth 8)
OPTION_CASES = {
    "nee-aa-sobol": ("cornell_golden.txt", None, dict(nee=True, antialias=True, sampler="sobol")),
    "nee-two-lights": ("cornell_golden.txt", two_light_golden, dict(nee=True)),
    "glass-dof-nee-sobol": (
        "cornell_glass.txt", with_aperture,
        dict(enable_refraction=True, dof=True, nee=True, sampler="sobol"),
    ),
    "glass-dof-aa-independent": (
        "cornell_glass.txt", with_aperture,
        dict(enable_refraction=True, dof=True, antialias=True),
    ),
    "throughput": ("cornell.txt", None, dict(gather_mode="throughput")),
    "sphere-early-exit": ("sphere.txt", None, dict(early_exit=True)),
}


def _option_scene(case, device):
    name, edit, cfg = OPTION_CASES[case]
    text = _scene_text(name)
    if edit is not None:
        text = edit(text)
    return Scene.from_desc(parse_scene(text), device), RenderConfig(**cfg)


def test_small_scene_is_the_cornell_box():
    desc = _small(rotated=True)
    assert desc.camera.resolution == (64, 64) and desc.num_geoms == 7
    kinds = tmk.static_geom_kinds(Scene.from_desc(desc, "cpu"))
    assert any(perm is None for _, perm in kinds)


def test_option_scenes_carry_their_options():
    """The edited scene texts really hold what their cases exercise."""
    two, _ = _option_scene("nee-two-lights", "cpu")
    lights = tmk.static_light_table(two)
    assert lights.count == 2 and sorted(lights.kind.tolist()) == [0, 1]
    lens, _ = _option_scene("glass-dof-nee-sobol", "cpu")
    assert float(lens.camera.aperture) == pytest.approx(0.3)
    assert np.any(tmk.pack_scene(lens).mats.reshape(-1, 10)[:, 9] > 0)


# the environment variants (kernels K3-K5), 64×64, depth 8: (scene, config)
ENV_CASES = {
    "exact": ("meadow", None, dict()),
    "exact-sobol-aa": ("meadow", None, dict(sampler="sobol", antialias=True)),
    "exact-refraction-dof": ("meadow", 0.2, dict(enable_refraction=True, dof=True)),
    "env-nee": ("meadow", None, dict(nee=True)),
    "env-nee-refraction-sobol": ("meadow", None, dict(nee=True, enable_refraction=True,
                                                     sampler="sobol")),
    "split-composite": ("meadow", None, dict(env_mode="split")),
    "split-aa-refraction": ("meadow", None, dict(env_mode="split", antialias=True,
                                                 enable_refraction=True)),
    "split-nee": ("sun+light", None, dict(env_mode="split", nee=True)),
}


def _env_case(case, device, tmp_path):
    kind, aperture, cfg = ENV_CASES[case]
    if kind == "meadow":
        desc = parse_scene(env_spheres_text(aperture=aperture), base_dir=_SCENES)
    else:
        path = write_env_map(tmp_path, "sun")
        desc = parse_scene(env_scene_text(path, light=True), base_dir=str(tmp_path))
    return Scene.from_desc(desc, device), RenderConfig(**cfg)


@pytest.mark.parametrize("case", list(ENV_CASES))
def test_env_cases_carry_their_options(case, tmp_path):
    """Each environment case selects the variant it names, on the CPU."""
    scene, config = _env_case(case, "cpu", tmp_path)
    opts = tmk.kernel_options(config, scene)
    want = {"exact": "env_exact", "env": "env_nee", "split": "env_split"}[case.split("-")[0]]
    assert tmk.variant_name(opts).endswith(want)
    assert opts.nee == (case == "split-nee")
    assert opts.bg_external == (case in ("split-composite", "split-nee"))


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(ENV_CASES))
def test_cuda_env_kernel_matches_plain_version(case, cuda, tmp_path):
    scene, config = _env_case(case, cuda, tmp_path)
    opts = tmk.kernel_options(config, scene)
    packed = tmk.pack_scene(scene, nee=opts.nee, config=config)
    launches = tmk.KERNEL.launches_by_variant.get(tmk.variant_name(opts), 0)
    got = tmk.KERNEL(packed, opts, 7, 1, 2, cuda)
    assert tmk.KERNEL.launches_by_variant[tmk.variant_name(opts)] == launches + 1
    pix = torch.arange(scene.camera.pixel_count, device=cuda)
    want = tmk.render_samples_reference(pix, packed, opts, 7, 1, 2)
    assert_matches_plain_version(got.cpu().numpy(), want.cpu().numpy())


def _row_case(kind, device, tmp_path):
    """(packed scene, kernel options) of env NEE at 64x64 under the meadow
    map or the one-hot-texel stress map, depth 8."""
    if kind == "meadow":
        desc = parse_scene(env_spheres_text(), base_dir=_SCENES)
    else:
        path = write_env_map(tmp_path, "sun")
        desc = parse_scene(env_scene_text(path), base_dir=str(tmp_path))
    scene = Scene.from_desc(desc, device)
    config = RenderConfig(nee=True, trace_depth=8)
    opts = tmk.kernel_options(config, scene)
    return scene, opts, tmk.pack_scene(scene, config=config)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["meadow", "sun"])
def test_cuda_env_row_kernel_matches_plain_version(kind, cuda, tmp_path):
    """The row kernel's [S·D, 8 + 6·G] rows of one 200-sample step against
    its plain version on the card: bit for bit (both round each operation
    alone and call the same acosf/atan2f/sinf/cosf; the largest |Δ| of
    every column is printed, with -s), the table the plain table of the
    kernel's own directions. One launch, counted."""
    scene, opts, packed = _row_case(kind, cuda, tmp_path)
    launches = tmk.KERNEL.row_launches
    got = tmk.env_nee_rows(packed, 7, 51, 200, opts.trace_depth)
    assert tmk.KERNEL.row_launches == launches + 1
    want = tmk.env_nee_rows_reference(packed, 7, 51, 200, opts.trace_depth)
    assert got.shape == want.shape == (1600, 8 + 6 * packed.num_geoms)
    assert torch.isfinite(got).all()
    diff = (got - want).abs().amax(dim=0)
    print(f"row kernel vs plain, {kind}: max |d| per column {diff[:8].tolist()}, "
          f"bit-identical {torch.equal(got, want)}")
    assert torch.equal(got, want)
    table = tmk.env_row_table(packed, got[:, :3]).reshape(got.shape[0], -1)
    assert torch.equal(got[:, 8:], table)
    # keyed by absolute iteration: a launch's slice is its own rows
    assert torch.equal(tmk.env_nee_rows(packed, 7, 101, 50, opts.trace_depth),
                       got[50 * opts.trace_depth:100 * opts.trace_depth])


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["exact", "exact-sobol", "env-nee", "env-nee-sun"])
def test_cuda_exact_env_kernels_are_bit_for_bit(case, cuda, tmp_path):
    """K3 and K4 (whose env ray reads the row's per-geom table) against the
    plain version on the same rows, 50 samples at 64x64: bit for bit."""
    scene, _opts, packed = _row_case("sun" if case.endswith("sun") else "meadow", cuda,
                                     tmp_path)
    config = RenderConfig(nee=case.startswith("env-nee"), trace_depth=8,
                          sampler="sobol" if case.endswith("sobol") else "independent")
    opts = tmk.kernel_options(config, scene)
    packed = tmk.pack_scene(scene, config=config)
    rows = tmk.env_nee_rows(packed, 7, 3, 50, 8) if opts.env_nee else None
    got = tmk.KERNEL(packed, opts, 7, 3, 50, cuda, env_rows=rows)
    pix = torch.arange(scene.camera.pixel_count, device=cuda)
    want = tmk.render_samples_reference(pix, packed, opts, 7, 3, 50, env_rows=rows)
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_cuda_env_nee_step_builds_its_rows_in_one_launch(cuda, monkeypatch):
    """On the card a Renderer step of env NEE builds all its iterations'
    rows with one launch of the row kernel and no torch threefry."""
    def no_torch_rows(*args, **kwargs):
        raise AssertionError("the torch row build ran on the card")

    monkeypatch.setattr(tmk, "build_env_nee_rows", no_torch_rows)
    r = Renderer(os.path.join(_SCENES, "env_spheres.txt"),
                 RenderConfig(nee=True, samples_per_launch=120, trace_depth=3), device=cuda)
    rows, launches = tmk.KERNEL.row_launches, tmk.KERNEL.launches_by_variant.get("env_nee", 0)
    r.step(120)
    assert tmk.KERNEL.row_launches == rows + 1
    assert tmk.KERNEL.launches_by_variant["env_nee"] == launches + 3  # 50 + 50 + 20 samples
    assert np.isfinite(r.linear_image()).all()


@pytest.mark.cuda
@pytest.mark.parametrize("case, drag_syncs", [("cornell", 12), ("env-nee", 12)])
def test_cuda_host_syncs_match_the_sync_debug_mode(case, drag_syncs, cuda):
    """``host_syncs`` counts every wait of the host in a viewer's drag frame
    (orbit, ``set_camera``, a step that re-reads only the camera, ``sync``,
    the preview) and still frame: each operation torch's sync debug mode
    warns of, and ``Renderer.sync``'s synchronize, which that mode does not
    flag."""
    if case == "cornell":
        desc, config = parse_scene(_scene_text("cornell.txt")), RenderConfig(sampler="sobol")
    else:
        desc = parse_scene(env_spheres_text(), base_dir=_SCENES)
        config = RenderConfig(nee=True, sampler="sobol")
    r = Renderer(desc, config, device=cuda)
    ctl = OrbitCameraController.from_camera(r.scene.camera, lookat=desc.camera.lookat)

    def frame(drag):
        if drag:
            ctl.orbit(3.0, 1.0)
            r.set_camera(ctl.camera())
        r.step(16, sync=False)
        r.sync()
        return r.display_image()

    frame(True)
    frame(False)
    got = []
    for drag in (True, False):
        before = profiling.counters().get("host_syncs", 0)
        torch.cuda.set_sync_debug_mode("warn")
        try:
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                frame(drag)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        flagged = sum("synchronizing" in str(w.message) for w in caught)
        got.append((profiling.counters()["host_syncs"] - before, flagged))
    print(f"{case}: (host_syncs, flagged) drag {got[0]}, still {got[1]}")
    assert got == [(drag_syncs, drag_syncs - 1), (4, 3)]


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["exact", "env-nee"])
def test_cuda_counting_build_equals_the_warp_schedule_under_an_environment(case, cuda):
    """K3 and K4 (64x64 meadow, depth 8, 4 samples): the counting build's
    counters equal the emulation replaying the warps it recorded; the
    emulation's spread is a warp's 32 x 1 for a thread per pixel."""
    scene = Scene.from_desc(parse_scene(env_spheres_text(), base_dir=_SCENES), cuda)
    config = RenderConfig(nee=case == "env-nee", trace_depth=8)
    opts = tmk.kernel_options(config, scene)
    packed = tmk.pack_scene(scene, config=config)
    counted, owners = tmk.kernel_warp_work(packed, opts, 7, 3, 4, cuda)
    stats = {}
    pix = torch.arange(scene.camera.pixel_count, device=cuda)
    tmk.render_samples_reference(pix, packed, opts, 7, 3, 4, stats=stats)
    steps, draws = tmk.path_lengths(stats)
    want = tmk.warp_schedule(steps, draws, tmk.SCHEDULE, **tmk.schedule_args(opts),
                             owners=owners, vis=tmk.path_visibility(stats), width=64)
    assert counted == {k: want[k] for k in tmk.WORK}
    assert (want["visits"] == 1).all() and want["in_order"]
    assert counted["env_rays"] == int(stats.get("env_shadow", 0))
    thread = tmk.warp_schedule(steps, draws, "thread", width=64)
    assert thread["spread"] == (32.0, 1.0)
    assert want["spread_area"] >= 1.0


def big_map_scene(h, w, device, seed=11):
    """env_spheres.txt at 64x64 under a seeded h x w map whose every texel
    differs from its neighbours (lognormal, sigma 0.5: a lookup of a wrong
    texel shows) with one bright sun texel, past the JAX kernel's 256x512
    cap; built on ``device``."""
    img = np.random.default_rng(seed).lognormal(0.0, 0.5, size=(h, w, 3)).astype(np.float32)
    img[h // 5, w // 3] = [4000.0, 3500.0, 3000.0]
    desc = parse_scene(env_spheres_text(), base_dir=_SCENES)
    desc.env_image = img
    return Scene.from_desc(desc, device)


def test_texel_table_holds_each_texel():
    """Texel (y, x) of the exact map's table, the float4 K3 reads, holds its
    strength-folded radiance and the sampler's pdf, row-major."""
    scene = big_map_scene(6, 5, "cpu")
    env = scene.envmap
    tab = tmk.pack_scene(scene, config=RenderConfig()).env.tex.reshape(6, 5, 4)
    assert torch.equal(tab[..., :3], env.img * env.strength)
    assert torch.equal(tab[..., 3], env.pdf)


@pytest.mark.cuda
@pytest.mark.parametrize("size", [(512, 1024), (2048, 4096)], ids=["512x1024", "2048x4096"])
@pytest.mark.parametrize("case", ["exact", "env-nee", "tiles"])
def test_cuda_large_maps_render_in_kernel(case, size, cuda):
    """Maps past the JAX kernel's cap render in the port's kernel: K3
    (exact) and K6 (the tile dispatch, 4 tiles, exact) bit for bit their
    plain version, K4 (env NEE, its rows from the row kernel) within the
    kernel-vs-plain bound; 64x64, depth 8, 2 samples, the launch counted.
    Under env NEE the row kernel is bit for bit its plain version over a
    200-sample step (past 2^15 texels both take the alias cell from a
    64-bit word of its own)."""
    scene = big_map_scene(*size, cuda)
    config = RenderConfig(nee=case == "env-nee", sampler="sobol" if case == "tiles" else
                          "independent")
    opts = tmk.kernel_options(config, scene)
    packed = tmk.pack_scene(scene, config=config)
    variant = tmk.variant_name(opts, case == "tiles")
    launches = tmk.KERNEL.launches_by_variant.get(variant, 0)
    if case == "tiles":
        ids = torch.tensor([1, 0, 1, 3], dtype=torch.int32, device=cuda)
        bases = torch.tensor([1, 5, 9, 3], dtype=torch.int32, device=cuda)
        flat = torch.as_tensor(np.random.default_rng(3).integers(0, 64 * 64, 4 * tmk.TILE),
                               device=cuda)
        px, py = (flat % 64).to(torch.float32), (flat // 64).to(torch.float32)
        got = tmk.render_tiles(scene, config, 7, ids, bases, px, py, 2, packed=packed)
        want = tmk.render_tiles_reference(px, py, ids, bases, packed, opts, 7, 2)
    else:
        rows = tmk.env_nee_rows(packed, 7, 1, 2, opts.trace_depth) if opts.env_nee else None
        got = tmk.KERNEL(packed, opts, 7, 1, 2, cuda, env_rows=rows)
        pix = torch.arange(scene.camera.pixel_count, device=cuda)
        want = tmk.render_samples_reference(pix, packed, opts, 7, 1, 2, env_rows=rows)
    assert tmk.KERNEL.launches_by_variant[variant] == launches + 1
    assert float(got.mean()) > 0.0
    if case == "env-nee":
        assert_matches_plain_version(got.cpu().numpy(), want.cpu().numpy())
        step = tmk.env_nee_rows(packed, 7, 1, 200, opts.trace_depth)
        assert torch.equal(step, tmk.env_nee_rows_reference(packed, 7, 1, 200, opts.trace_depth))
    else:
        assert torch.equal(got, want)


@pytest.mark.cuda
def test_cuda_env_tile_dispatch_matches_plain_version(cuda):
    """K6 with the exact environment (K3): 4 tiles with distinct bases."""
    scene = Scene.from_desc(parse_scene(env_spheres_text(), base_dir=_SCENES), cuda)
    config = RenderConfig(sampler="sobol")
    opts = tmk.kernel_options(config, scene)
    packed = tmk.pack_scene(scene, config=config)
    ids = torch.tensor([1, 0, 1, 3], dtype=torch.int32, device=cuda)
    bases = torch.tensor([1, 5, 9, 3], dtype=torch.int32, device=cuda)
    flat = torch.as_tensor(np.random.default_rng(3).integers(0, 64 * 64, 4 * tmk.TILE),
                           device=cuda)
    px = (flat % 64).to(torch.float32)
    py = (flat // 64).to(torch.float32)
    got = tmk.render_tiles(scene, config, 7, ids, bases, px, py, 2, packed=packed)
    want = tmk.render_tiles_reference(px, py, ids, bases, packed, opts, 7, 2)
    assert_matches_plain_version(got.cpu().numpy(), want.cpu().numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(CASES))
def test_cuda_kernel_matches_plain_version(case, cuda):
    rotated, cfg = CASES[case]
    desc = _small(rotated)
    config = RenderConfig(**cfg)
    scene = Scene.from_desc(desc, cuda)
    launches = tmk.KERNEL.launches
    got = tmk.render_samples(scene, config, 7, 1, 2)
    assert tmk.KERNEL.launches == launches + 1
    pix = torch.arange(scene.camera.pixel_count, device=cuda)
    want = tmk.render_samples_reference(
        pix, tmk.pack_scene(scene), tmk.kernel_options(config), 7, 1, 2
    )
    assert_matches_plain_version(got.cpu().numpy(), want.cpu().numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(OPTION_CASES))
def test_cuda_kernel_options_match_plain_version(case, cuda):
    scene, config = _option_scene(case, cuda)
    launches = tmk.KERNEL.launches
    got = tmk.render_samples(scene, config, 7, 1, 2)
    assert tmk.KERNEL.launches == launches + 1
    pix = torch.arange(scene.camera.pixel_count, device=cuda)
    opts = tmk.kernel_options(config)
    want = tmk.render_samples_reference(
        pix, tmk.pack_scene(scene, nee=opts.nee), opts, 7, 1, 2
    )
    assert_matches_plain_version(got.cpu().numpy(), want.cpu().numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("config", [dict(), dict(nee=True, sampler="sobol")],
                         ids=["default", "nee-sobol"])
def test_cuda_twenty_cubes_match_plain_version(config, cuda):
    """20 cubes over 40 file materials (20 referenced): past the 16-row
    tables of earlier builds; the light's material id is renumbered."""
    scene = Scene.from_desc(parse_scene(many_cubes_text(20)), cuda)
    config = RenderConfig(**config)
    assert config.resolve_pipeline(scene) == "pallas"
    launches = tmk.KERNEL.launches
    got = tmk.render_samples(scene, config, 7, 1, 2)
    assert tmk.KERNEL.launches == launches + 1
    pix = torch.arange(scene.camera.pixel_count, device=cuda)
    opts = tmk.kernel_options(config)
    want = tmk.render_samples_reference(pix, tmk.pack_scene(scene, nee=opts.nee), opts, 7, 1, 2)
    assert_matches_plain_version(got.cpu().numpy(), want.cpu().numpy())


@pytest.mark.cuda
def test_cuda_early_exit_is_bit_identical(cuda):
    scene, config = _option_scene("sphere-early-exit", cuda)
    on = tmk.render_samples(scene, config, 7, 1, 2)
    off = tmk.render_samples(scene, RenderConfig(), 7, 1, 2)
    torch.testing.assert_close(on, off, rtol=0, atol=0)


@pytest.mark.cuda
def test_cuda_tile_dispatch_matches_plain_version(cuda):
    """K6: 4 chosen tiles (one repeated) with distinct iteration bases."""
    scene, _ = _option_scene("nee-aa-sobol", cuda)
    config = RenderConfig(nee=True, sampler="sobol")
    packed = tmk.pack_scene(scene, nee=True)
    ids = torch.tensor([1, 0, 1, 3], dtype=torch.int32, device=cuda)
    bases = torch.tensor([1, 5, 9, 3], dtype=torch.int32, device=cuda)
    n = scene.camera.pixel_count
    rng = np.random.default_rng(3)
    flat = torch.as_tensor(rng.integers(0, n, 4 * tmk.TILE), device=cuda)
    px = (flat % 64).to(torch.float32)
    py = (flat // 64).to(torch.float32)
    launches = tmk.KERNEL.launches
    got = tmk.render_tiles(scene, config, 7, ids, bases, px, py, 2, packed=packed)
    assert tmk.KERNEL.launches == launches + 1
    want = tmk.render_tiles_reference(
        px, py, ids, bases, packed, tmk.kernel_options(config), 7, 2
    )
    assert_matches_plain_version(got.cpu().numpy(), want.cpu().numpy())


@pytest.mark.cuda
def test_cuda_adaptive_renderer_runs_the_tile_kernel(cuda):
    text = _scene_text("cornell_golden.txt", res=128)
    r = AdaptiveRenderer(parse_scene(text), RenderConfig(nee=True, sampler="sobol"), device=cuda)
    launches = tmk.KERNEL.launches
    r.render(8, warmup_spp=4, round_spp=2, frac=0.5)
    assert tmk.KERNEL.launches > launches
    assert r.avg_spp >= 8.0 and r.spp_map().min() >= 4
    img = r.linear_image()
    assert img.shape == (128, 128, 3) and np.isfinite(img).all() and img.mean() > 0


# ── the pixel queue and path regeneration: bit for bit ──

# (resolution, config, num_samples): frames that fill no whole warp or block,
# and the shortest and the main path's launches
QUEUE_CASES = {
    "1850-px-sobol": ((50, 37), dict(sampler="sobol"), 2),
    "20-px-aa": ((5, 4), dict(antialias=True), 2),
    "1-sample": ((64, 64), dict(sampler="sobol"), 1),
    "50-samples": ((64, 64), dict(sampler="sobol"), 50),
    "50-samples-glass-dof-nee": ((64, 64), dict(enable_refraction=True, dof=True, nee=True,
                                                sampler="sobol"), 50),
}


def _queue_scene(res, config, device):
    name = "cornell_glass.txt" if config.get("dof") else "cornell.txt"
    text = open(os.path.join(_SCENES, name)).read()
    text = text.replace("RES         800 800", f"RES         {res[0]} {res[1]}")
    if config.get("dof"):
        text = with_aperture(text)
    scene = Scene.from_desc(parse_scene(text), device)
    opts = tmk.kernel_options(RenderConfig(**config))
    return scene, opts, tmk.pack_scene(scene, nee=opts.nee)


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(QUEUE_CASES))
def test_cuda_queue_matches_plain_version_bit_for_bit(case, cuda):
    """Bit for bit without NEE; with it, within the kernel-vs-plain bound
    (assert_kernel_output)."""
    res, config, samples = QUEUE_CASES[case]
    scene, opts, packed = _queue_scene(res, config, cuda)
    got = tmk.KERNEL(packed, opts, 7, 3, samples, cuda)
    pix = torch.arange(scene.camera.pixel_count, device=cuda)
    want = tmk.render_samples_reference(pix, packed, opts, 7, 3, samples)
    assert_kernel_output(got, want, opts.nee)


@pytest.mark.cuda
def test_cuda_tile_queue_matches_plain_version_bit_for_bit(cuda):
    """K6 through the queue: 4 tiles (one repeated) with distinct bases;
    with NEE, within the kernel-vs-plain bound (assert_kernel_output)."""
    scene, _ = _option_scene("nee-aa-sobol", cuda)
    config = RenderConfig(nee=True, sampler="sobol")
    packed = tmk.pack_scene(scene, nee=True)
    ids = torch.tensor([1, 0, 1, 3], dtype=torch.int32, device=cuda)
    bases = torch.tensor([1, 5, 9, 3], dtype=torch.int32, device=cuda)
    flat = torch.as_tensor(np.random.default_rng(5).integers(0, 64 * 64, 4 * tmk.TILE),
                           device=cuda)
    px = (flat % 64).to(torch.float32)
    py = (flat // 64).to(torch.float32)
    got = tmk.render_tiles(scene, config, 7, ids, bases, px, py, 3, packed=packed)
    want = tmk.render_tiles_reference(px, py, ids, bases, packed, tmk.kernel_options(config), 7, 3)
    assert_kernel_output(got, want, nee=True)


@pytest.mark.cuda
def test_cuda_queue_resets_between_launches_and_streams(cuda):
    """Two launches in a row on one stream, then launches on two streams at
    once: each zeroes its own stream's queue first, so each renders every
    pixel of its frame."""
    a, opts_a, pk_a = _queue_scene((64, 64), dict(sampler="sobol"), cuda)
    b, opts_b, pk_b = _queue_scene((50, 37), dict(antialias=True), cuda)
    want_a = tmk.render_samples_reference(
        torch.arange(a.camera.pixel_count, device=cuda), pk_a, opts_a, 7, 1, 4)
    want_b = tmk.render_samples_reference(
        torch.arange(b.camera.pixel_count, device=cuda), pk_b, opts_b, 7, 1, 4)
    first = tmk.KERNEL(pk_a, opts_a, 7, 1, 4, cuda)
    second = tmk.KERNEL(pk_a, opts_a, 7, 1, 4, cuda)
    assert torch.equal(first, want_a) and torch.equal(second, want_a)
    streams = [torch.cuda.Stream(cuda), torch.cuda.Stream(cuda)]
    torch.cuda.synchronize(cuda)
    outs = []
    for _ in range(3):
        with torch.cuda.stream(streams[0]):
            outs.append(("a", tmk.KERNEL(pk_a, opts_a, 7, 1, 4, cuda)))
        with torch.cuda.stream(streams[1]):
            outs.append(("b", tmk.KERNEL(pk_b, opts_b, 7, 1, 4, cuda)))
    torch.cuda.synchronize(cuda)
    for which, out in outs:
        assert torch.equal(out, want_a if which == "a" else want_b)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["1850-px-sobol", "50-samples-glass-dof-nee"])
def test_cuda_counting_build_equals_the_warp_schedule(case, cuda):
    """The counting build's warp iterations, lane-iterations and both-branch
    iterations (and with NEE its light rays' queue) equal warp_schedule's
    replay of the warps it recorded, on the plain version's path lengths;
    its output is the production build's (with NEE within the
    kernel-vs-plain bound: which pass tests a light ray depends on the
    pixels each warp took)."""
    res, config, samples = QUEUE_CASES[case]
    scene, opts, packed = _queue_scene(res, config, cuda)
    counted, owners = tmk.kernel_warp_work(packed, opts, 7, 3, samples, cuda)
    stats = {}
    pix = torch.arange(scene.camera.pixel_count, device=cuda)
    tmk.render_samples_reference(pix, packed, opts, 7, 3, samples, stats=stats)
    steps, draws = tmk.path_lengths(stats)
    want = tmk.warp_schedule(steps, draws, tmk.SCHEDULE, **tmk.schedule_args(opts),
                             owners=owners, vis=tmk.path_visibility(stats))
    assert counted == {k: want[k] for k in tmk.WORK}
    assert (want["visits"] == 1).all() and want["in_order"]
    work = torch.zeros(len(tmk.WORK), dtype=torch.int64, device=cuda)
    own = torch.full_like(torch.as_tensor(owners, device=cuda), -1)
    got = tmk.COUNTING(packed, opts, 7, 3, samples, cuda, work=work, owners=own)
    assert_kernel_output(got, tmk.KERNEL(packed, opts, 7, 3, samples, cuda), opts.nee)


# ── the visibility rays (K2's light ray, K4's env ray, K5's sun rays, the
# last traced with the next ray from their vertex): bit for bit ──


def sun_below_text(directory, res=64):
    """A ground slab alone under a map whose one bright texel lies below the
    horizon: every diffuse vertex faces up, away from the split's sun."""
    img = np.full((16, 32, 3), 0.05, np.float32)
    img[12, 7] = [120.0, 100.0, 80.0]
    path = write_hdr(os.path.join(str(directory), "low_sun.hdr"), img)
    text = env_scene_text(path, res)
    return text[: text.index("OBJECT 1")]


def _vis_case(case, device, tmp_path):
    """(scene, config, samples) of a visibility case (64×64 unless named)."""
    sun = lambda: write_env_map(tmp_path, "sun")  # noqa: E731
    parse = lambda text, base=_SCENES: Scene.from_desc(parse_scene(text, base_dir=base), device)  # noqa: E731
    golden = _scene_text("cornell_golden.txt")
    meadow = env_spheres_text()
    cubes = many_cubes_text(64, depth=3).replace(
        "CAMERA", "ENVIRONMENT\nFILE meadow.hdr\nSTRENGTH 1\n\nCAMERA", 1)
    cases = {
        "nee-depth1": (golden, _SCENES, dict(nee=True, trace_depth=1, sampler="sobol"), 3),
        "nee-aa-sobol-depth8": (golden, _SCENES, dict(nee=True, antialias=True, sampler="sobol"),
                                4),
        "nee-depth2-aa": (golden, _SCENES, dict(nee=True, trace_depth=2, antialias=True), 3),
        "nee-two-lights": (two_light_golden(golden), _SCENES, dict(nee=True), 2),
        "nee-glass-refraction": (_scene_text("cornell_glass.txt"), _SCENES,
                                 dict(nee=True, enable_refraction=True), 2),
        "nee-50x37-px": (_scene_text("cornell_golden.txt").replace(
            "RES         64 64", "RES         50 37"), _SCENES, dict(nee=True, sampler="sobol"), 3),
        "nee-env-split": (None, None, dict(env_mode="split", nee=True), 2),
        "split-0-suns": (meadow, _SCENES, dict(env_mode="split", env_split_suns=0), 2),
        "split-1-sun": (meadow, _SCENES, dict(env_mode="split", env_split_suns=1), 2),
        "split-32-suns": (meadow, _SCENES, dict(env_mode="split", env_split_suns=32,
                                                env_split_thresh=1.0), 2),
        "split-suns-below": (None, None, dict(env_mode="split"), 2),
        "split-64-geoms-32-suns": (cubes, _SCENES, dict(env_mode="split", env_split_suns=32,
                                                        env_split_thresh=1.0), 2),
        "env-nee-depth2": (meadow, _SCENES, dict(nee=True, trace_depth=2), 2),
    }
    text, base, cfg, samples = cases[case]
    if case == "nee-env-split":
        text, base = env_scene_text(sun(), light=True), str(tmp_path)
    elif case == "split-suns-below":
        text, base = sun_below_text(tmp_path), str(tmp_path)
    return parse(text, base), RenderConfig(**cfg), samples


VIS_CASES = ["nee-depth1", "nee-aa-sobol-depth8", "nee-depth2-aa", "nee-two-lights",
             "nee-glass-refraction", "nee-50x37-px", "nee-env-split", "split-0-suns",
             "split-1-sun", "split-32-suns", "split-suns-below", "split-64-geoms-32-suns",
             "env-nee-depth2"]


def test_visibility_cases_carry_what_they_name(tmp_path):
    """On the CPU: each case's scene holds the suns, geoms and lights it
    names, and the low sun casts no ray in the plain version."""
    suns = {}
    for case in VIS_CASES:
        scene, config, _ = _vis_case(case, "cpu", tmp_path)
        opts = tmk.kernel_options(config, scene)
        packed = tmk.pack_scene(scene, nee=opts.nee, config=config)
        suns[case] = packed.env.num_suns if opts.env == "split" else None
        if case == "split-64-geoms-32-suns":
            assert packed.num_geoms == tmk.MAX_GEOMS
        if case.startswith("nee"):
            assert opts.nee
    assert suns["split-0-suns"] == 0 and suns["split-1-sun"] == 1
    assert suns["split-32-suns"] == suns["split-64-geoms-32-suns"] == tmk.MAX_SUNS
    assert suns["split-suns-below"] >= 1
    scene, config, n = _vis_case("split-suns-below", "cpu", tmp_path)
    stats = {}
    tmk.render_samples_reference(torch.arange(scene.camera.pixel_count),
                                 tmk.pack_scene(scene, config=config),
                                 tmk.kernel_options(config, scene), 7, 3, n, stats=stats)
    assert int(stats["sun_shadow"]) == 0 and int(stats["scatter"]) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("case", VIS_CASES)
def test_cuda_visibility_rays_match_plain_version_bit_for_bit(case, cuda, tmp_path):
    """Bit for bit without NEE; the NEE cases, whose light rays' terms join
    the sum from the warp's queue, within the kernel-vs-plain bound."""
    scene, config, samples = _vis_case(case, cuda, tmp_path)
    opts = tmk.kernel_options(config, scene)
    packed = tmk.pack_scene(scene, nee=opts.nee, config=config)
    got = tmk.KERNEL(packed, opts, 7, 3, samples, cuda)
    pix = torch.arange(scene.camera.pixel_count, device=cuda)
    want = tmk.render_samples_reference(pix, packed, opts, 7, 3, samples)
    assert_kernel_output(got, want, opts.nee)


@pytest.mark.cuda
def test_cuda_tile_dispatch_with_nee_depth1_is_bit_for_bit(cuda):
    """K6 with NEE at depth 1, where every light ray is cast at a path's
    last vertex: 4 tiles (one repeated) with distinct bases, within the
    kernel-vs-plain bound (assert_kernel_output)."""
    scene, _ = _option_scene("nee-aa-sobol", cuda)
    config = RenderConfig(nee=True, sampler="sobol", trace_depth=1)
    packed = tmk.pack_scene(scene, nee=True)
    ids = torch.tensor([1, 0, 1, 3], dtype=torch.int32, device=cuda)
    bases = torch.tensor([1, 5, 9, 3], dtype=torch.int32, device=cuda)
    flat = torch.as_tensor(np.random.default_rng(7).integers(0, 64 * 64, 4 * tmk.TILE),
                           device=cuda)
    px = (flat % 64).to(torch.float32)
    py = (flat // 64).to(torch.float32)
    got = tmk.render_tiles(scene, config, 7, ids, bases, px, py, 3, packed=packed)
    want = tmk.render_tiles_reference(px, py, ids, bases, packed, tmk.kernel_options(config), 7, 3)
    assert_kernel_output(got, want, nee=True)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["nee-aa-sobol-depth8", "nee-depth2-aa", "nee-env-split",
                                  "split-32-suns", "env-nee-depth2"])
def test_cuda_counting_build_counts_the_visibility_rays(case, cuda, tmp_path):
    """The counting build's rays of each kind are the plain version's
    counts, and all its counters equal warp_schedule's emulation on the
    plain version's paths and visibility rays."""
    scene, config, samples = _vis_case(case, cuda, tmp_path)
    opts = tmk.kernel_options(config, scene)
    packed = tmk.pack_scene(scene, nee=opts.nee, config=config)
    counted, owners = tmk.kernel_warp_work(packed, opts, 7, 3, samples, cuda)
    stats = {}
    pix = torch.arange(scene.camera.pixel_count, device=cuda)
    tmk.render_samples_reference(pix, packed, opts, 7, 3, samples, stats=stats)
    assert [counted["light_rays"], counted["env_rays"], counted["sun_rays"]] == [
        int(stats.get(k, 0)) for k in ("shadow", "env_shadow", "sun_shadow")]
    steps, draws = tmk.path_lengths(stats)
    want = tmk.warp_schedule(steps, draws, tmk.SCHEDULE, **tmk.schedule_args(opts),
                             owners=owners, vis=tmk.path_visibility(stats))
    assert counted == {k: want[k] for k in tmk.WORK}
    assert (want["added"] > 0) == (opts.env == "split")
    assert counted["light_pass_lanes"] == counted["light_rays"]
    assert (counted["light_passes"] > 0) == opts.nee


def _adaptive_round(device, n_tiles=81):
    """The adaptive leg's refine round at 800x800 (AdaptiveRenderer.render
    (256)): both buffers of ``n_tiles`` of the 325 tiles, every fourth, at
    the bases of the first round after the 64-spp warm-up."""
    gpx, gpy, _, _ = make_tile_layout(800, 800)
    ids = torch.arange(0, 4 * n_tiles, 4, dtype=torch.int32, device=device).repeat(2)
    bases = torch.cat([torch.full((n_tiles,), 65, dtype=torch.int32, device=device),
                       torch.full((n_tiles,), 81, dtype=torch.int32, device=device)])
    px = torch.as_tensor(gpx, device=device)[ids.long()].reshape(-1).contiguous()
    py = torch.as_tensor(gpy, device=device)[ids.long()].reshape(-1).contiguous()
    return ids, bases, px, py


@pytest.mark.cuda
def test_cuda_tile_dispatch_at_the_adaptive_round_size(cuda):
    """K6 at the size of the adaptive leg's rounds: 162 tile slots of
    cornell_golden at 800x800 with NEE and sobol, 2 samples (a queue item a
    sample, tile_group's choice there, and both in one item), against the
    plain version within the kernel-vs-plain bound."""
    desc = parse_scene(open(os.path.join(_SCENES, "cornell_golden.txt")).read())
    scene = Scene.from_desc(desc, cuda)
    config = RenderConfig(nee=True, sampler="sobol")
    packed = tmk.pack_scene(scene, nee=True)
    ids, bases, px, py = _adaptive_round(cuda)
    assert ids.numel() == 162 and px.numel() == 162 * tmk.TILE
    assert tmk.tile_group(px.numel(), 2, cuda) == 1
    launches = tmk.KERNEL.launches_by_variant.get("nee+tiles", 0)
    got = tmk.render_tiles(scene, config, 7, ids, bases, px, py, 2, packed=packed)
    assert tmk.KERNEL.launches_by_variant["nee+tiles"] == launches + 1
    want = tmk.render_tiles_reference(px, py, ids, bases, packed, tmk.kernel_options(config), 7, 2)
    assert_kernel_output(got, want, nee=True)
    opts = tmk.kernel_options(config)
    whole = tmk.KERNEL(packed, opts, 7, 0, 2, cuda, tiles=(torch.cat([ids, bases]), px, py),
                       group=2)
    assert_kernel_output(whole, want, nee=True)


@pytest.mark.cuda
@pytest.mark.parametrize("group", [1, 3])
def test_cuda_counting_build_counts_the_tile_dispatch_light_rays(group, cuda):
    """nee+tiles (K6 with NEE): the counting build's counters, its light
    rays' queue included, equal the emulation on the plain version's paths,
    over 8 of golden's tiles (64x64 frame coordinates), 3 samples, with a
    queue item a sample and a pixel's three samples in one item."""
    scene, _ = _option_scene("nee-aa-sobol", cuda)
    config = RenderConfig(nee=True, sampler="sobol")
    opts = tmk.kernel_options(config)
    packed = tmk.pack_scene(scene, nee=True)
    ids = torch.tensor([1, 0, 1, 3, 2, 5, 4, 6], dtype=torch.int32, device=cuda)
    bases = torch.tensor([1, 5, 9, 3, 7, 2, 4, 8], dtype=torch.int32, device=cuda)
    flat = torch.as_tensor(np.random.default_rng(11).integers(0, 64 * 64, 8 * tmk.TILE),
                           device=cuda)
    px = (flat % 64).to(torch.float32)
    py = (flat // 64).to(torch.float32)
    counted, owners = tmk.kernel_warp_work(packed, opts, 7, 0, 3, cuda,
                                           tiles=(torch.cat([ids, bases]), px, py), group=group)
    stats = {}
    tmk.render_tiles_reference(px, py, ids, bases, packed, opts, 7, 3, stats=stats)
    steps, draws = tmk.path_lengths(stats)
    want = tmk.warp_schedule(steps, draws, tmk.SCHEDULE, **tmk.schedule_args(opts, tiles=True),
                             owners=owners, vis=tmk.path_visibility(stats), group=group)
    assert (want["visits"] == 1).all() and len(want["visits"]) == 8 * tmk.TILE * (3 // group)
    assert counted == {k: want[k] for k in tmk.WORK}
    assert counted["light_rays"] == int(stats["shadow"]) == counted["light_pass_lanes"]


def _all_variants():
    """Every compile-time variant of the megakernel as (nee, refraction,
    dof, throughput, tiles, env 0-3), the set csrc/megakernel.cu's
    valid_variant admits, and its name (megakernel.variant_name)."""
    out = {}
    for f in range(128):
        nee, refr, dof, legacy, tiles = (bool(f >> b & 1) for b in range(5))
        env = f >> 5
        if (nee and legacy) or (env and legacy) or (nee and env in (1, 2)) or (tiles and env >= 2):
            continue
        parts = [n for n, on in (("nee", nee), ("refraction", refr), ("dof", dof),
                                 ("throughput", legacy), ("tiles", tiles)) if on]
        env_name = ("", "env_exact", "env_nee", "env_split")[env]
        out["+".join(parts + ([env_name] if env_name else [])) or "main"] = (
            nee, refr, dof, legacy, tiles, env)
    return out


VARIANTS = _all_variants()


def test_every_variant_is_named_once():
    """The 44 compile-time variants, each named as the kernel's ptxas
    report and launch counts name it."""
    assert len(VARIANTS) == 44
    scene = Scene.from_desc(_small(), "cpu")
    for name, (nee, refr, dof, legacy, tiles, env) in VARIANTS.items():
        if env == 0:
            opts = tmk.kernel_options(RenderConfig(
                nee=nee, enable_refraction=refr, dof=dof,
                gather_mode="throughput" if legacy else "light_only"), scene)
            assert tmk.variant_name(opts, tiles) == name


def _load_torch_measure():
    import importlib.util

    path = os.path.join(os.path.dirname(__file__), "..", "scripts", "torch_measure.py")
    spec = importlib.util.spec_from_file_location("torch_measure", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


TORCH_MEASURE = _load_torch_measure()


@pytest.mark.parametrize("name", list(TORCH_MEASURE.DIAG_EDITS))
def test_diagnostic_edit_applies_to_the_megakernel_source(name):
    """Each of torch_measure.py's diagnostic edits (--diag-edits) finds each
    of its texts exactly once in today's csrc/megakernel.cu, and changes
    the source."""
    with open(os.path.join(os.path.dirname(__file__), "..", tmk.SOURCE)) as f:
        text = f.read()
    edited = TORCH_MEASURE.diag_source(text, name)
    assert edited != text
    for _old, new in TORCH_MEASURE.DIAG_EDITS[name]:
        assert new in edited


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(VARIANTS))
def test_cuda_every_variant_against_plain_version(name, cuda, tmp_path):
    """Every compile-time variant at 32x32, depth 8, sobol, 3 samples (4
    tiles of random frame coordinates for a tile variant, its queue items
    one sample and three): an NEE variant within the kernel-vs-plain bound,
    every other bit for bit (assert_kernel_output)."""
    nee, refr, dof, legacy, tiles, env = VARIANTS[name]
    base = _SCENES
    if env == 0:
        text = _scene_text("cornell_golden.txt", res=32)
    elif env == 3 and nee:  # split + NEE needs an analytic light
        text, base = env_scene_text(write_env_map(tmp_path, "sun"), 32, light=True), str(tmp_path)
    else:
        text = env_spheres_text(32)
    if dof:
        text = with_aperture(text)
    config = RenderConfig(nee=nee or env == 2, enable_refraction=refr, dof=dof, sampler="sobol",
                          gather_mode="throughput" if legacy else "light_only",
                          env_mode="split" if env == 3 else "exact")
    scene = Scene.from_desc(parse_scene(text, base_dir=base), cuda)
    opts = tmk.kernel_options(config, scene)
    assert tmk.variant_name(opts, tiles) == name
    packed = tmk.pack_scene(scene, nee=opts.nee, config=config)
    if tiles:
        ids = torch.tensor([1, 0, 1, 3], dtype=torch.int32, device=cuda)
        bases = torch.tensor([1, 5, 9, 3], dtype=torch.int32, device=cuda)
        flat = torch.as_tensor(np.random.default_rng(13).integers(0, 32 * 32, 4 * tmk.TILE),
                               device=cuda)
        px = (flat % 32).to(torch.float32)
        py = (flat // 32).to(torch.float32)
        want = tmk.render_tiles_reference(px, py, ids, bases, packed, opts, 7, 3)
        for group in (1, 3):
            got = tmk.KERNEL(packed, opts, 7, 0, 3, cuda, tiles=(torch.cat([ids, bases]), px, py),
                             group=group)
            assert_kernel_output(got, want, opts.nee)
    else:
        got = tmk.KERNEL(packed, opts, 7, 1, 3, cuda)
        want = tmk.render_samples_reference(torch.arange(32 * 32, device=cuda), packed, opts,
                                            7, 1, 3)
        assert_kernel_output(got, want, opts.nee)


# ── the mesh kernels K7/K8 and the mesh pipeline ──

_MESH = os.path.join(_SCENES, "mesh1080p.txt")


def _soup_intersector(device, bvh):
    v0, e1, e2, mat = triangle_soup(5)
    if not bvh:
        return tmesh.ClusterMeshIntersector(v0, e1, e2, mat, device=device)
    desc = tri_scene_desc()
    desc.tri_vertices = np.stack([v0, v0 + e1, v0 + e2], axis=1)
    desc.tri_material_id = mat
    return make_mesh_intersector(Scene.from_desc(desc, device))


def assert_mesh_kernel_matches_plain(isect, rays, max_tie_share=0.0):
    """K7 and K8 against the plain version on the same card: the same t on
    every active ray, and every other output equal except on tie rays (two
    triangles at exactly the same distance, kept in another visit order), of
    which at most ``max_tie_share`` of the active rays; misses on the
    inactive ones. Returns the number of active rays that hit."""
    a = rays[6] > 0.5
    got, want = isect.call_soa(*rays), isect.plain().call_soa(*rays)
    assert torch.equal(got[0][a], want[0][a])
    same = a & (got[1] == want[1])
    assert int((a & ~same).sum()) <= max_tie_share * int(a.sum())
    for g, w in zip(got[1:], want[1:]):
        assert torch.equal(g[same], w[same])
    assert bool((got[0][~a] == tmesh._MISS).all()) and bool((got[1][~a] == -1).all())
    t = isect.call_t(*rays)
    assert torch.equal(t[a], isect.plain().call_t(*rays)[a]) and torch.equal(t[a], got[0][a])
    return int((got[1][a] >= 0).sum())


@pytest.mark.cuda
@pytest.mark.parametrize("bvh", [False, True], ids=["consecutive", "treelets"])
def test_cuda_mesh_kernels_match_plain_version(bvh, cuda):
    """K7/K8 against the plain version, and both walks of the kernel against
    each other (all outputs equal) and against the octant_walk emulation on
    the first 4096 rays: the same t and index, ties included."""
    isect = _soup_intersector(cuda, bvh)
    rays = [torch.tensor(np.ascontiguousarray(r), device=cuda) for r in soup_rays(9, n=65536)]
    launches = dict(tmesh.KERNEL.launches_by_mode)
    assert assert_mesh_kernel_matches_plain(isect, rays) > 1000
    assert tmesh.KERNEL.launches_by_mode["full"] == launches.get("full", 0) + 1
    assert tmesh.KERNEL.launches_by_mode["tmin"] == launches.get("tmin", 0) + 1
    t, idx, _ = octant_walk(isect.tables, [r[:4096].cpu().numpy() for r in rays])
    for full in (True, False):
        lane = tmesh.KERNEL(isect.tables, *rays, full=full, walk="lane")
        warp = tmesh.KERNEL(isect.tables, *rays, full=full, walk="warp")
        for g, w in zip(lane, warp):
            assert torch.equal(g, w)
        np.testing.assert_array_equal(lane[0][:4096].cpu().numpy(), t)
    np.testing.assert_array_equal(tmesh.KERNEL(isect.tables, *rays)[1][:4096].cpu().numpy(), idx)


@pytest.mark.cuda
@pytest.mark.parametrize("walk", tmesh.WALKS)
@pytest.mark.parametrize("bvh", [False, True], ids=["consecutive", "treelets"])
def test_cuda_mesh_kernel_counts_its_own_work(bvh, walk, cuda):
    """The counting build adds up the kernel's own walk (the octant_walk
    emulation's counts, exactly): the tests, the same in both walks, and the
    warp iterations of this one; and it returns what the production build
    returns."""
    isect = _soup_intersector(cuda, bvh)
    rays = [torch.tensor(np.ascontiguousarray(r), device=cuda) for r in soup_rays(9, n=2048)]
    host = [r.cpu().numpy() for r in rays]
    want = octant_walk(isect.tables, host, walk)[2]
    tests = ("sc_slab", "cl_slab", "tri")
    other = octant_walk(isect.tables, host, "lane" if walk == "warp" else "warp")[2]
    assert {k: want[k] for k in tests} == {k: other[k] for k in tests}
    assert tmesh.kernel_work(isect.tables, *rays, walk=walk) == want
    assert tmesh.kernel_work(isect.tables, *rays, full=False, walk=walk) == want
    work = torch.zeros(len(tmesh.WORK), dtype=torch.int64, device=cuda)
    counted = tmesh.COUNTING(isect.tables, *rays, full=True, work=work, walk=walk)
    for c, p in zip(counted, tmesh.KERNEL(isect.tables, *rays, full=True, walk=walk)):
        assert torch.equal(c, p)
    assert work.tolist() == [want[k] for k in tmesh.WORK]


@pytest.mark.cuda
def test_cuda_mesh_inactive_rays_miss(cuda):
    isect = _soup_intersector(cuda, False)
    rays = [torch.tensor(np.ascontiguousarray(r), device=cuda) for r in soup_rays(9, n=4096)]
    rays[6] = torch.zeros_like(rays[6])
    t, i, nx, ny, nz, m = isect.call_soa(*rays)
    assert bool((t == tmesh._MISS).all()) and bool((i == -1).all())
    assert not bool(torch.cat([nx, ny, nz, m]).any())
    assert bool((isect.call_t(*rays) == tmesh._MISS).all())


@pytest.mark.cuda
def test_cuda_mesh_nan_slab_ray(cuda):
    """An axis-parallel ray whose origin lies on a cluster box's plane: its
    slab is NaN in the kernel too, which culls the box as the plain version
    does (and as jnp.minimum/maximum do in the TPU kernel)."""
    isect = _soup_intersector(cuda, False)
    box = isect.tables.aabbs[0]
    vals = [box[0] - 1.0, float(box[1]), 0.5 * (box[2] + box[5]), 1.0, 0.0, 0.0, 1.0]
    rays = [torch.tensor([v], dtype=torch.float32, device=cuda) for v in vals]
    assert assert_mesh_kernel_matches_plain(isect, rays) == 0


@pytest.mark.cuda
def test_cuda_mesh_kernels_on_mesh1080p_primary_rays(cuda):
    """K7/K8 on the real primary rays (block order) of mesh1080p: one of the
    2,073,600 rays is a tie on the H100 (chip_smoke.py's bound, 1e-4 of the
    rays, allows it)."""
    r = Renderer(_MESH, RenderConfig(sky_strength=1.0), device=cuda)
    isect = r._step.cluster
    rec = tmesh.RayRecorder(isect)
    fast.trace_sample_mesh(r.scene, RenderConfig(sky_strength=1.0, trace_depth=1), 0, 1, rec)
    rays = rec.soa[0]
    assert rays[0].shape == (1920 * 1080,)
    assert assert_mesh_kernel_matches_plain(isect, rays, max_tie_share=1e-4) > 1920 * 1080 // 2


@pytest.mark.cuda
def test_cuda_mesh_renderer_sort_on_and_off(cuda):
    """Renderer on mesh1080p (at 480×270): 8 K7 launches a sample, sorted and
    unsorted wavefronts give the same image (the JAX test's bound)."""
    text = open(_MESH).read().replace("RES         1920 1080", "RES         480 270")
    images = []
    for sort in (True, False):
        r = Renderer(parse_scene(text, base_dir=_SCENES),
                     RenderConfig(sky_strength=1.0, mesh_ray_sort=sort, samples_per_launch=2),
                     device=cuda)
        assert r.pipeline == "fast_mesh"
        tmesh.KERNEL.reset_counts()
        r.render(2)
        assert tmesh.KERNEL.launches_by_mode == {"full": 16}
        images.append(r.linear_image())
    assert images[0].shape == (270, 480, 3) and images[0].mean() > 0
    np.testing.assert_allclose(images[0], images[1], rtol=1e-6, atol=1e-7)


# ───────────── the fast and reference pipelines, the models ─────────────


@pytest.mark.cuda
def test_cuda_bvh_intersector_launches_k7(cuda):
    """On the card the reference pipeline's BVH hands triangles to K7 (its
    launch count grows), and its hits meet the threaded walk's
    (``tri_method='while'``, on the card too) within tests/test_bvh.py's
    bounds: misses agree on 99% of rays, distances within 2e-3."""
    from cosc_4397_pathtracing_raytracing_project_tpu_torch.ops.bvh import BVHIntersector

    scene = Scene.from_desc(tri_scene_desc(), cuda)
    rng = np.random.default_rng(4)
    o = rng.uniform(-4, 4, (4096, 3)).astype(np.float32) + np.float32([0, 3, 0])
    d = rng.normal(size=(4096, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    o, d = torch.as_tensor(o, device=cuda), torch.as_tensor(d, device=cuda)
    isect = BVHIntersector(scene, leaf_size=4)
    assert isect.tri_method == "cluster"
    tmesh.KERNEL.reset_counts()
    got = isect(scene, o, d)
    assert tmesh.KERNEL.launches_by_mode == {"full": 1}
    want = BVHIntersector(scene, leaf_size=4, tri_method="while")(scene, o, d)
    assert tmesh.KERNEL.launches == 1
    miss_agree = float((got.miss == want.miss).float().mean())
    assert miss_agree > 0.99 and int((~got.miss).sum()) > 256
    both = ~got.miss & ~want.miss
    np.testing.assert_allclose(got.t[both].cpu().numpy(), want.t[both].cpu().numpy(),
                               rtol=2e-3, atol=2e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("config", [dict(pipeline="fast"), dict(pipeline="fast", nee=True),
                                    dict(pipeline="reference"),
                                    dict(pipeline="reference", intersector="bvh", nee=True)],
                         ids=["fast", "fast-nee", "reference", "reference-bvh-nee"])
def test_cuda_eager_pipelines_match_the_cpu(config, cuda):
    """The fast and reference pipelines on the card against the same port
    code on the CPU, 64×64, depth 8, 2 spp: the ROADMAP oracle bound (torch's
    CPU and CUDA math round differently)."""
    images = []
    for device in (cuda, "cpu"):
        r = Renderer(_small(), RenderConfig(samples_per_launch=2, **config), device=device)
        assert r.pipeline == config["pipeline"]
        r.render(2)
        images.append(r.state.accum.cpu().numpy())
    assert_within_oracle_tolerance(*images)


@pytest.mark.cuda
@pytest.mark.parametrize("model", ["naive", "shared", "bvh", "megakernel", "wavefront"])
def test_cuda_every_model_renders(model, cuda):
    from cosc_4397_pathtracing_raytracing_project_tpu_torch.models import make_renderer

    r = make_renderer(model, _small(), RenderConfig(trace_depth=3, samples_per_launch=2),
                      device=cuda)
    r.render(2)
    img = r.linear_image()
    assert img.shape == (64, 64, 3) and np.isfinite(img).all() and img.max() > 0.05


def exact_ties(scene, o, d):
    """Which rays' nearest hit on ``scene`` is an exact tie: two primitives
    at the same distance, or, on a cube, two slab axes entering at the same
    distance (an edge). Torch on the card may break such a tie in another
    order than on the CPU."""
    from cosc_4397_pathtracing_raytracing_project_tpu_torch.ops import intersect as ix

    cand = []
    if scene.cubes.count:
        cand.append(ix.cube_candidate_t(scene.cubes, o, d))
    if scene.spheres.count:
        cand.append(ix.sphere_candidate_t(scene.spheres, o, d))
    t, idx = torch.sort(torch.cat(cand, dim=1), dim=1)
    ties = (t[:, 0] == t[:, 1]) & (t[:, 0] < 1e30)  # 1e30: a miss
    is_cube = idx[:, 0] < scene.cubes.count
    inv = scene.cubes.inv_transform[torch.where(is_cube, idx[:, 0], 0)]
    q_o, q_d = ix._to_object_space(inv, o, d)
    enter = torch.minimum((-0.5 - q_o) / q_d, (0.5 - q_o) / q_d)
    top = torch.sort(torch.where(enter > 0, enter, -3.4e38), dim=1, descending=True).values
    return ties | (is_cube & (top[:, 0] == top[:, 1]) & (top[:, 0] > 0))


def test_exact_ties_finds_the_box_edges():
    """CPU check of the helper: on cornell.txt's center rays the exact ties
    lie on the box's edges (the image's diagonals), a small share."""
    from cosc_4397_pathtracing_raytracing_project_tpu_torch.render import denoise

    scene = Scene.from_desc(_small(), "cpu")
    idx = torch.arange(64 * 64)
    ties = exact_ties(scene, *denoise._center_rays(scene.camera, idx))
    y, x = idx[ties] // 64, idx[ties] % 64
    assert 0 < int(ties.sum()) < 64 * 64 // 20
    assert bool(((y - x).abs() <= 1).logical_or((y + x - 63).abs() <= 1).all())


@pytest.mark.cuda
def test_cuda_denoiser_matches_the_cpu(cuda):
    """The denoiser on the card against the same code on the CPU, 64×64:
    the AOV pass (miss masks identical, the rest within 1e-4 but on at most
    0.5% of pixels, the ROADMAP's share, where torch's float32 sqrt, which
    rounds some inputs otherwise on the card than on the CPU, moves a
    grazing hit or an exact tie), and the filter on the same inputs within
    1e-4."""
    from cosc_4397_pathtracing_raytracing_project_tpu_torch.ops.intersect import intersect_scene
    from cosc_4397_pathtracing_raytracing_project_tpu_torch.render import denoise

    desc = _small()
    cpu_scene = Scene.from_desc(desc, "cpu")
    got = denoise.render_aovs(Scene.from_desc(desc, cuda))
    want = denoise.render_aovs(cpu_scene)
    assert torch.equal(got.miss.cpu(), want.miss)
    off = torch.zeros(want.miss.shape, dtype=torch.bool)
    for g, w in zip(got[:3], want[:3]):
        d = (g.cpu() - w).abs()
        off |= (d.amax(dim=-1) if d.dim() == 3 else d) > 1e-4
    assert float(off.float().mean()) <= 0.005
    ys, xs = torch.nonzero(off, as_tuple=True)
    idx = ys * 64 + xs
    # traced again on the CPU with the card's sqrt, each such pixel gives
    # the card's AOVs (or is an exact tie)
    sqrt = torch.sqrt
    torch.sqrt = lambda x: sqrt(x.to(cuda)).to(x.device)
    try:
        hit = intersect_scene(cpu_scene, *denoise._center_rays(cpu_scene.camera, idx))
    finally:
        torch.sqrt = sqrt
    agree = (hit.normal - got.normal.cpu()[ys, xs]).abs().amax(dim=1) <= 1e-4
    assert bool((agree | exact_ties(cpu_scene, *denoise._center_rays(cpu_scene.camera,
                                                                     idx))).all())
    img = np.random.default_rng(5).uniform(0, 2, (64, 64, 3)).astype(np.float32)
    on_card = denoise.Aovs(*[a.to(cuda) for a in want])
    out = denoise.atrous_denoise(torch.from_numpy(img).to(cuda), on_card).cpu().numpy()
    ref = denoise.atrous_denoise(torch.from_numpy(img), want).numpy()
    assert np.abs(out - ref).max() <= 1e-4


@pytest.mark.cuda
def test_cuda_checkpoint_round_trip(cuda, tmp_path):
    """Save on the card, load into a second renderer on the card (the
    accumulator lands there), continue: bit for bit."""
    a = Renderer(_small(), RenderConfig(trace_depth=3, samples_per_launch=2), seed=3, device=cuda)
    a.step(2)
    path = a.save_checkpoint(str(tmp_path / "ck"))
    b = Renderer(_small(), RenderConfig(trace_depth=3, samples_per_launch=2), device=cuda)
    b.load_checkpoint(path)
    assert b.state.accum.device == a.state.accum.device and b.state.seed == a.state.seed
    a.step(2)
    b.step(2)
    assert torch.equal(a.state.accum, b.state.accum)


@pytest.mark.cuda
def test_cuda_cli_default_device(cuda, tmp_path):
    """The command line with its default device renders on the card."""
    from cosc_4397_pathtracing_raytracing_project_tpu_torch.io.png import read_png
    from cosc_4397_pathtracing_raytracing_project_tpu_torch.utils import cli

    scene = tmp_path / "scene.txt"
    scene.write_text(_scene_text("cornell.txt"))
    out = tmp_path / "out.png"
    tmk.KERNEL.reset_counts()
    rc = cli.main([str(scene), "--depth", "3", "--iterations", "4", "--chunk", "2", "--denoise",
                   "--output", str(out), "--checkpoint", str(tmp_path / "ck"), "--quiet"])
    assert rc == 0 and tmk.KERNEL.launches > 0
    img = read_png(str(out))
    assert img.shape == (64, 64, 3) and img.max() > 0


# ── a pixel slice of the frame (the multi-device pixel tiling): 800x800,
# misaligned slices, the hash tiles from the tile base ──

SLICE_CASES = {
    "main": ("cornell.txt", dict(sampler="sobol")),
    "nee": ("cornell_golden.txt", dict(nee=True, antialias=True, sampler="sobol")),
    "env-exact": ("env_spheres.txt", dict(sampler="sobol")),
    "env-nee": ("env_spheres.txt", dict(nee=True)),
    "split": ("env_spheres.txt", dict(env_mode="split")),
}
# (pixel offset, pixels, tile base): the second dp rank's half of 800x800
# (no TILE boundary at 320,000) on its own tile base, and a slice that
# starts and ends inside a warp's chunk of 32 on the default base
SLICES = {"dp-half": (320000, 320000, 157), "odd": (123457, 100001, None)}


def slice_case(case, device):
    """(scene, config, options, packed scene) of a slice case at 800x800."""
    from cosc_4397_pathtracing_raytracing_project_tpu_torch import load_scene_desc

    name, cfg = SLICE_CASES[case]
    scene = Scene.from_desc(load_scene_desc(os.path.join(_SCENES, name)), device)
    config = RenderConfig(**cfg)
    opts = tmk.kernel_options(config, scene)
    return scene, config, opts, tmk.pack_scene(scene, nee=opts.nee, config=config)


def slice_reference(packed, opts, seed, iter_base, num_samples, offset, n, tile_base, device):
    """The plain version of ``render_samples`` on the slice (the split
    mode's composite of the slice's own rows included)."""
    pix = offset + torch.arange(n, device=device)
    rad = tmk.render_samples_reference(pix, packed, opts, seed, iter_base, num_samples,
                                       tile_base=offset // tmk.TILE if tile_base is None
                                       else tile_base)
    return tmk._add_background(rad, packed, opts, num_samples, offset)


@pytest.mark.cuda
@pytest.mark.parametrize("where", list(SLICES))
@pytest.mark.parametrize("case", list(SLICE_CASES))
def test_cuda_slice_matches_plain_version(case, where, cuda):
    """render_samples on a slice of the frame, on the card, against its
    plain version on the same slice: bit for bit without NEE, within the
    kernel-vs-plain bound with it."""
    scene, config, opts, packed = slice_case(case, cuda)
    offset, n, tile_base = SLICES[where]
    launches = tmk.KERNEL.launches
    got = tmk.render_samples(scene, config, 7, 3, 2, packed=packed, pixel_offset=offset,
                             num_pixels=n, tile_base=tile_base)
    assert tmk.KERNEL.launches == launches + 1 and got.shape == (n, 3)
    want = slice_reference(packed, opts, 7, 3, 2, offset, n, tile_base, cuda)
    assert_kernel_output(got, want, opts.nee)


@pytest.mark.cuda
def test_cuda_counting_build_on_a_slice_equals_the_warp_schedule(cuda):
    """The counting build on the odd slice (main variant, 2 samples) against
    warp_schedule's replay on the plain version's paths of that slice."""
    scene, config, opts, packed = slice_case("main", cuda)
    offset, n, _ = SLICES["odd"]
    counted, owners = tmk.kernel_warp_work(packed, opts, 7, 3, 2, cuda, pixel_offset=offset,
                                           num_pixels=n)
    stats = {}
    pix = offset + torch.arange(n, device=cuda)
    tmk.render_samples_reference(pix, packed, opts, 7, 3, 2, stats=stats,
                                 tile_base=offset // tmk.TILE)
    steps, draws = tmk.path_lengths(stats)
    want = tmk.warp_schedule(steps, draws, tmk.SCHEDULE, **tmk.schedule_args(opts),
                             owners=owners, vis=tmk.path_visibility(stats), width=800,
                             pixel_offset=offset)
    assert counted == {k: want[k] for k in tmk.WORK}
    assert (want["visits"] == 1).all() and len(owners) == (n + 31) // 32


@pytest.mark.cuda
def test_cuda_entry_matches_the_cpu(cuda):
    """The single-device entry point's step on the card against the same
    step on the CPU, 64×64 (the fast pipeline in eager torch on both: the
    ROADMAP's 0.5% share, as chip_smoke.py's card-vs-CPU gates)."""
    from cosc_4397_pathtracing_raytracing_project_tpu_torch.entry import entry

    fn, args = entry(resolution=(64, 64))
    got = fn(*args)
    assert got.accum.device.type == "cuda" and got.iteration == 1
    fn, args = entry(device="cpu", resolution=(64, 64))
    want = fn(*args)
    assert_within_oracle_tolerance(got.accum.cpu().numpy(), want.accum.numpy())
