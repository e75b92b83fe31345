"""PyTorch port, the native host runtime (``native/``) on the CPU: each entry
point of the port's ``libptruntime`` against its plain version in the port
and against the JAX package's function, bit for bit: the PNG writer and
defilter, the BVH builder, the alias-table builder and the OBJ loader. Then
the build itself: a source that does not compile raises, and two processes
that build into one fresh directory at once both load the library.

The JAX package's functions run as its own tests run them here: through its
native library when that is built, else through its Python code; either
gives the same tables (tests/test_native.py).
"""

import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

from cosc_4397_pathtracing_raytracing_project_tpu.io import png as jpng
from cosc_4397_pathtracing_raytracing_project_tpu.ops import bvh as jbvh
from cosc_4397_pathtracing_raytracing_project_tpu.ops import envmap as jenv
from cosc_4397_pathtracing_raytracing_project_tpu.scene import parser as jparser
from cosc_4397_pathtracing_raytracing_project_tpu_torch.io import png as tpng
from cosc_4397_pathtracing_raytracing_project_tpu_torch.native import runtime
from cosc_4397_pathtracing_raytracing_project_tpu_torch.ops import bvh as tbvh
from cosc_4397_pathtracing_raytracing_project_tpu_torch.ops import envmap as tenv
from cosc_4397_pathtracing_raytracing_project_tpu_torch.ops.cuda import build
from cosc_4397_pathtracing_raytracing_project_tpu_torch.scene import parser as tparser

from test_native import _encode_png_forced_filters

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCENES = os.path.join(REPO, "scenes")
GOLDEN_PNG = os.path.join(REPO, "tests", "data", "REFERENCE_cornell.5000samp.png")
BVH_FIELDS = ("bounds_min", "bounds_max", "miss_link", "leaf_start", "leaf_count", "order")


# ─────────────────────────── PNG ───────────────────────────


@pytest.mark.parametrize("channels", [3, 4])
def test_png_round_trip(tmp_path, channels):
    """The native writer, the plain encoder and the JAX writer produce files
    that every decoder (native defilter, NumPy defilter, the JAX package's
    read_png) reads back as the image."""
    img = np.random.default_rng(7).integers(0, 256, (37, 53, channels), dtype=np.uint8)
    native = tpng.write_png(str(tmp_path / "native"), img)
    assert native.endswith("native.png")
    plain = str(tmp_path / "plain.png")
    with open(plain, "wb") as f:
        f.write(tpng.encode_png(img))
    jax_path = str(tmp_path / "jax.png")
    jpng.write_png(jax_path, img)
    for path in (native, plain, jax_path):
        np.testing.assert_array_equal(tpng.read_png(path), img)
        np.testing.assert_array_equal(jpng.read_png(path), img)
        raw, (height, width, _) = tpng._scanlines(path)
        np.testing.assert_array_equal(
            tpng._defilter_reference(raw, height, width * channels, channels).reshape(img.shape),
            img)


def test_png_writer_rejects_bad_images(tmp_path):
    with pytest.raises(ValueError):
        tpng.write_png(str(tmp_path / "two.png"), np.zeros((4, 4, 2), np.uint8))
    with pytest.raises(ValueError):
        tpng.write_png(str(tmp_path / "flat.png"), np.zeros((4, 4), np.uint8))
    with pytest.raises(ValueError):
        tpng.write_png(str(tmp_path / "float.png"), np.zeros((4, 4, 3), np.float32))
    with pytest.raises(OSError):
        tpng.write_png(str(tmp_path / "missing" / "x.png"), np.zeros((4, 4, 3), np.uint8))


@pytest.mark.parametrize("channels", [3, 4])
@pytest.mark.parametrize("ftypes", [[4], [3], [0, 1, 2, 3, 4], [4, 0, 4, 2]],
                         ids=["paeth", "average", "cycle", "paeth-none-up"])
def test_defilter_matches_plain_and_jax(tmp_path, ftypes, channels):
    """Rows under a forced cycle of filter types: the native defilter, the
    NumPy wavefront and the JAX package's defilter each give the image."""
    img = np.random.default_rng(11).integers(0, 256, (23, 31, channels), dtype=np.uint8)
    path = tmp_path / "f.png"
    path.write_bytes(_encode_png_forced_filters(img, ftypes))
    raw, (height, width, _) = tpng._scanlines(str(path))
    stride = width * channels
    got = tpng._defilter(raw.copy(), height, stride, channels)
    plain = tpng._defilter_reference(raw.copy(), height, stride, channels)
    want = jpng._defilter(raw.copy(), height, stride, channels)
    for out in (got, plain, want):
        np.testing.assert_array_equal(np.asarray(out).reshape(img.shape), img)
    np.testing.assert_array_equal(tpng.read_png(str(path)), img)


def test_defilter_rejects_unknown_filter_type():
    raw = np.zeros((3, 1 + 12), np.uint8)
    raw[1, 0] = 7
    with pytest.raises(ValueError, match="filter"):
        tpng._defilter(raw.copy(), 3, 12, 3)
    with pytest.raises(ValueError, match="filter"):
        tpng._defilter_reference(raw.copy(), 3, 12, 3)


def test_golden_png_decodes_equal_to_plain():
    """The reference image (stb's Paeth-heavy rows) through the native
    defilter equals the NumPy path's and the JAX package's decode."""
    raw, (height, width, _) = tpng._scanlines(GOLDEN_PNG)
    stride = width * 3
    got = tpng._defilter(raw.copy(), height, stride, 3)
    np.testing.assert_array_equal(got, tpng._defilter_reference(raw.copy(), height, stride, 3))
    np.testing.assert_array_equal(tpng.read_png(GOLDEN_PNG), jpng.read_png(GOLDEN_PNG))


# ─────────────────────────── BVH ───────────────────────────


def _assert_bvh_equal(got, want):
    for f in BVH_FIELDS:
        g, w = getattr(got, f), getattr(want, f)
        assert g.dtype == w.dtype, f
        np.testing.assert_array_equal(g, w, err_msg=f)


@pytest.mark.parametrize("leaf", [1, 4, 8])
@pytest.mark.parametrize("n", [1, 2, 57])
def test_native_bvh_equals_plain_and_jax(n, leaf):
    """Every array of the tree, the bounds bit for bit."""
    rng = np.random.default_rng(100 + n)
    mins = rng.uniform(-10, 10, (n, 3)).astype(np.float32)
    maxs = mins + rng.uniform(0.1, 3, (n, 3)).astype(np.float32)
    got = tbvh.try_native_build(mins, maxs, leaf)
    _assert_bvh_equal(got, tbvh.build_bvh(mins, maxs, leaf))
    _assert_bvh_equal(got, jbvh.build_bvh(mins, maxs, leaf))


def test_native_bvh_equals_plain_on_mesh1080p():
    """mesh1080p's 38,530 triangle boxes at leaf 8, as make_mesh_intersector
    builds them: the same 16,383 nodes, bit for bit."""
    desc = tparser.load_scene_desc(os.path.join(SCENES, "mesh1080p.txt"))
    tri = desc.tri_vertices.astype(np.float32)
    v0, e1, e2 = tri[:, 0], tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0]
    tmin = np.minimum(np.minimum(v0, v0 + e1), v0 + e2)
    tmax = np.maximum(np.maximum(v0, v0 + e1), v0 + e2)
    got = tbvh.try_native_build(tmin, tmax, 8)
    assert len(tri) == 38530 and got.num_nodes == 16383
    _assert_bvh_equal(got, tbvh.build_bvh(tmin, tmax, 8))
    _assert_bvh_equal(got, jbvh.build_bvh(tmin, tmax, 8))


def test_native_bvh_rejects_no_primitives():
    empty = np.zeros((0, 3), np.float32)
    with pytest.raises(ValueError):
        tbvh.try_native_build(empty, empty, 4)
    with pytest.raises(ValueError):
        tbvh.build_bvh(empty, empty, 4)


# ─────────────────────────── alias table ───────────────────────────


def _distribution(kind, n):
    if kind == "one-hot":
        p = np.zeros(n, np.float64)
        p[n // 3] = 1.0
        return p
    if kind == "uniform":
        return np.full(n, 1.0 / n, np.float64)
    w = np.random.default_rng(n).gamma(0.3, size=n)
    return w / w.sum()


@pytest.mark.parametrize("kind", ["one-hot", "uniform", "random"])
@pytest.mark.parametrize("n", [1, 7, 4096, 512 * 1024], ids=["1", "7", "4096", "512x1024"])
def test_native_alias_equals_plain_and_jax(n, kind):
    """prob and alias bit for bit against the Python Vose loop of both
    packages."""
    p = _distribution(kind, n)
    prob, alias = runtime.build_alias(p)
    assert prob.dtype == np.float64 and alias.dtype == np.int32
    for want_prob, want_alias in (tenv._build_alias(p), jenv._build_alias(p)):
        np.testing.assert_array_equal(prob.view(np.uint64), np.asarray(want_prob).view(np.uint64))
        np.testing.assert_array_equal(alias, want_alias)


def test_build_envmap_tables_equal_jax():
    """build_envmap's tables (native alias) equal the JAX package's on the
    meadow map, and its distribution's plain alias table."""
    img = jpng.read_hdr(os.path.join(SCENES, "meadow.hdr"))
    got = tenv.build_envmap(img)
    want = jenv.build_envmap(img)
    for f in ("alias_prob", "alias_idx", "pdf"):
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(want, f)),
                                      err_msg=f)
    p, _ = tenv.texel_distribution(img)
    prob, alias = tenv._build_alias(p)
    np.testing.assert_array_equal(got.alias_prob.numpy(), prob.astype(np.float32))
    np.testing.assert_array_equal(got.alias_idx.numpy(), alias.astype(np.int32))


def test_native_alias_rejects_empty():
    with pytest.raises(ValueError):
        runtime.build_alias(np.zeros(0))


# ─────────────────────────── OBJ ───────────────────────────

OBJ_CASES = {
    "v/vt/vn": "v 0 0 0\nv 1 0 0\nv 0 1 0\nvt 0 0\nvt 1 0\nvt 0 1\nvn 0 0 1\n"
               "f 1/1/1 2/2/1 3/3/1\n",
    "v//vn": "v 0 0 0\nv 1 0 0\nv 0 1 0\nv 1 1 0\nvn 0 0 1\nf 1//1 2//1 3//1\nf 2//1 4//1 3//1\n",
    "negative": "v 0 0 0\nv 1 0 0\nv 0 1 0\nf -3 -2 -1\nv 1 1 0.5\nf -3 -1 -2\n",
    "n-gon": "# comment\nmtllib a.mtl\no thing\ng part\nv 0 0 0\nv 2 0 0\nv 2 2 0\nv 1 3 0\n"
             "v 0 2 0\ns 1\nusemtl red\nf 1 2 3 4 5\ns off\nf 5 4 3\n",
    "tabs, v x y z w": "v\t0.25\t0 0 1\nv 1.5\t0  0 1\nv 0 -1e-3 2.5e1 1\n"
                       "f\t1\t2\t3\nf 3 2 1\n",
}


@pytest.mark.parametrize("case", list(OBJ_CASES))
def test_native_obj_equals_plain_and_jax(tmp_path, case):
    path = str(tmp_path / "m.obj")
    with open(path, "w") as f:
        f.write(OBJ_CASES[case])
    got = runtime.load_obj_triangles(path)
    assert got.dtype == np.float32 and got.ndim == 3 and got.shape[1:] == (3, 3)
    assert len(got) > 0
    for want in (tparser.load_obj_triangles(path), jparser.load_obj_triangles(path)):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", ["mesh_sphere.obj", "mesh_terrain.obj"])
def test_native_obj_equals_plain_on_repo_meshes(name):
    path = os.path.join(SCENES, name)
    got = runtime.load_obj_triangles(path)
    np.testing.assert_array_equal(got, tparser.load_obj_triangles(path))
    np.testing.assert_array_equal(got, jparser.load_obj_triangles(path))


def test_scene_parser_loads_meshes_natively(monkeypatch):
    """The parser takes the native loader, never the plain one."""
    def plain(path):
        raise AssertionError("the parser called the plain OBJ loader")

    monkeypatch.setattr(tparser, "load_obj_triangles", plain)
    desc = tparser.load_scene_desc(os.path.join(SCENES, "mesh1080p.txt"))
    assert desc.tri_vertices.shape == (38530, 3, 3)


def test_native_obj_rejects_unreadable_file(tmp_path):
    with pytest.raises(ValueError, match="cannot read"):
        runtime.load_obj_triangles(str(tmp_path / "missing.obj"))


# ─────────────────────────── the build ───────────────────────────


def test_source_that_does_not_compile_raises(tmp_path, monkeypatch):
    src = tmp_path / "src"
    src.mkdir()
    (src / f"{runtime.NAME}.cc").write_text('extern "C" int pt_write_png( { broken\n')
    monkeypatch.setattr(build, "NATIVE_SRC_DIR", src)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "out")
    monkeypatch.setattr(runtime, "_LIB", None)
    with pytest.raises(RuntimeError, match="failed for"):
        runtime.ensure_built()
    with pytest.raises(RuntimeError, match="failed for"):
        runtime.available()
    assert not list((tmp_path / "out").glob("*.so"))


def test_two_processes_build_one_fresh_directory(tmp_path):
    """Two processes build the library into one empty directory at the same
    moment: both load it, and one library is left, with no temporary file."""
    out = tmp_path / "out"
    code = textwrap.dedent(f"""
        import sys
        from pathlib import Path
        from cosc_4397_pathtracing_raytracing_project_tpu_torch.ops.cuda import build
        build.BUILD_DIR = Path({str(out)!r})
        from cosc_4397_pathtracing_raytracing_project_tpu_torch.native import runtime
        import numpy as np
        assert runtime.available()
        prob, alias = runtime.build_alias(np.full(5, 0.2))
        assert (alias == np.arange(5)).all()
        print(runtime.ensure_built())
        assert 'jax' not in sys.modules
    """)
    env = dict(os.environ, PYTHONPATH=REPO)
    procs = [subprocess.Popen([sys.executable, "-c", code], env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True) for _ in range(2)]
    results = [p.communicate(timeout=120) + (p.returncode,) for p in procs]
    for stdout, stderr, rc in results:
        assert rc == 0, stderr
    paths = {r[0].strip() for r in results}
    assert len(paths) == 1
    assert [p.name for p in out.iterdir()] == [os.path.basename(paths.pop())]
