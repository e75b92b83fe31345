"""PyTorch port, scene layer and image I/O: the port's parser, transforms,
packed kernel tables and PNG codec against the JAX package's, exactly."""

import glob
import os

import numpy as np
import pytest
import torch

from cosc_4397_pathtracing_raytracing_project_tpu.io import png as jpng
from cosc_4397_pathtracing_raytracing_project_tpu.ops.pallas import megakernel as jmk
from cosc_4397_pathtracing_raytracing_project_tpu.scene import Scene as JScene
from cosc_4397_pathtracing_raytracing_project_tpu.scene import parse_scene as jparse
from cosc_4397_pathtracing_raytracing_project_tpu.scene import parser as jparser
from cosc_4397_pathtracing_raytracing_project_tpu_torch import convert
from cosc_4397_pathtracing_raytracing_project_tpu_torch.io import png as tpng
from cosc_4397_pathtracing_raytracing_project_tpu_torch.ops.cuda import megakernel as tmk
from cosc_4397_pathtracing_raytracing_project_tpu_torch.scene import Scene, parser as tparser

from test_render import CORNELL_SMALL

torch.set_num_threads(2)

HERE = os.path.dirname(__file__)
SCENES = sorted(glob.glob(os.path.join(HERE, "..", "scenes", "*.txt")))
GOLDEN_PNG = os.path.join(HERE, "data", "REFERENCE_cornell.5000samp.png")
ROTATED = CORNELL_SMALL.replace("ROTAT 0 0 90", "ROTAT 20 45 10", 1)


def _desc_fields(desc):
    cam = desc.camera
    return {
        "geom_type": desc.geom_type,
        "material_id": desc.material_id,
        "translation": desc.translation,
        "rotation": desc.rotation,
        "scale": desc.scale,
        "transform": desc.transform,
        "inv_transform": desc.inv_transform,
        "inv_transpose": desc.inv_transpose,
        "color": desc.color,
        "specular_exponent": desc.specular_exponent,
        "specular_color": desc.specular_color,
        "reflectivity": desc.reflectivity,
        "refractive": desc.refractive,
        "ior": desc.ior,
        "emittance": desc.emittance,
        "tri_vertices": desc.tri_vertices,
        "tri_material_id": desc.tri_material_id,
        "env_image": desc.env_image,
        "cam.eye": cam.eye,
        "cam.lookat": cam.lookat,
        "cam.up": cam.up,
        "settings": np.array(
            [cam.resolution[0], cam.resolution[1], cam.fovy_deg, cam.aperture,
             cam.focal, desc.iterations, desc.trace_depth, desc.env_strength],
            np.float64,
        ),
    }


@pytest.mark.parametrize("path", SCENES, ids=os.path.basename)
def test_every_scene_parses_identically(path):
    want = jparser.load_scene_desc(path)
    got = tparser.load_scene_desc(path)
    assert got.image_name == want.image_name
    w, g = _desc_fields(want), _desc_fields(got)
    for key in w:
        if w[key] is None:
            assert g[key] is None, key
            continue
        assert g[key].dtype == w[key].dtype, key
        np.testing.assert_array_equal(g[key], w[key], err_msg=key)


@pytest.mark.parametrize(
    "text, error",
    [
        (CORNELL_SMALL.replace("OBJECT 0", "OBJECT 1", 1), tparser.SceneParseError),
        (CORNELL_SMALL.replace("MATERIAL 1", "MATERIAL 5", 1), tparser.SceneParseError),
        (CORNELL_SMALL.replace("CAMERA", "XCAMERA", 1), tparser.SceneParseError),
    ],
    ids=["object-id", "material-id", "no-camera"],
)
def test_parse_errors_raise(text, error):
    with pytest.raises(error):
        tparser.parse_scene(text)
    with pytest.raises(jparser.SceneParseError):
        jparser.parse_scene(text)


def test_missing_scene_file_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        tparser.load_scene_desc(str(tmp_path / "missing.txt"))


@pytest.mark.parametrize(
    "text", [CORNELL_SMALL, ROTATED, open(SCENES[0]).read()],
    ids=["cornell-small", "rotated", os.path.basename(SCENES[0])],
)
def test_packed_tables_match_jax(text):
    jscene = JScene.from_desc(jparse(text))
    scene = Scene.from_desc(tparser.parse_scene(text), "cpu")
    packed = tmk.pack_scene(scene)
    geo, gmat, mats = (np.asarray(a) for a in jmk._pack_scene(jscene))
    np.testing.assert_array_equal(packed.geo, geo)
    np.testing.assert_array_equal(packed.gmat, gmat)
    np.testing.assert_array_equal(packed.mats, mats)
    kinds = jmk._static_geom_kinds(jscene)
    assert tmk.static_geom_kinds(scene) == kinds
    for k, (_kind, perm) in enumerate(kinds):
        want = (-1, -1, -1) if perm is None else perm
        assert tuple(packed.perm[3 * k : 3 * k + 3]) == want
    _, gm_static, mat_static = jmk._static_scene_tables(jscene)
    assert tuple(packed.gmat.tolist()) == gm_static
    assert tuple(tuple(r) for r in packed.mats.reshape(-1, 10).tolist()) == mat_static
    cam = jscene.camera
    cam_vec = np.concatenate(
        [np.asarray(v).reshape(-1) for v in (
            cam.position, cam.view, cam.right, cam.up, cam.pixel_length,
            cam.aperture, cam.focal)]
    )
    np.testing.assert_array_equal(packed.cam, cam_vec)
    assert (packed.width, packed.height) == cam.resolution


def test_scene_from_jax_arrays_matches_from_desc():
    jscene = JScene.from_desc(jparse(ROTATED))

    def leaves(obj, fields):
        return {f: np.asarray(getattr(obj, f)) for f in fields}

    batch_fields = ("material_id", "geom_index", "transform", "inv_transform", "inv_transpose")
    d = {
        "cubes": leaves(jscene.cubes, batch_fields),
        "spheres": leaves(jscene.spheres, batch_fields),
        "triangles": leaves(jscene.triangles, ("material_id",)),
        "materials": leaves(jscene.materials, (
            "color", "specular_color", "specular_exponent", "reflectivity",
            "refractive", "ior", "emittance")),
        "camera": dict(
            leaves(jscene.camera, ("position", "view", "up", "right",
                                   "pixel_length", "aperture", "focal")),
            resolution=jscene.camera.resolution,
        ),
        "envmap": jscene.envmap,
    }
    got = tmk.pack_scene(convert.scene_from_jax_arrays(d, "cpu"))
    want = tmk.pack_scene(Scene.from_desc(tparser.parse_scene(ROTATED), "cpu"))
    for f in ("cam", "geo", "gmat", "mats", "perm"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f), err_msg=f)


@pytest.mark.parametrize("name", ["mesh1080p.txt"])
def test_mesh_scene_builds(name):
    """A scene with ``mesh`` objects builds its triangles (the field-by-field
    comparison with JAX is in test_torch_mesh_scene.py)."""
    desc = tparser.load_scene_desc(os.path.join(HERE, "..", "scenes", name))
    scene = Scene.from_desc(desc, "cpu")
    assert scene.num_triangles == desc.num_triangles > 0
    tri = scene.triangles
    assert tri.v0.shape == tri.e1.shape == tri.e2.shape == tri.normal.shape == (desc.num_triangles, 3)
    assert tri.geom_index[0] == desc.num_geoms


def test_golden_png_decodes_identically():
    got = tpng.read_png(GOLDEN_PNG)
    want = jpng.read_png(GOLDEN_PNG)
    assert got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("channels", [3, 4])
def test_png_round_trip(tmp_path, channels):
    img = np.random.default_rng(7).integers(0, 256, (23, 37, channels), dtype=np.uint8)
    assert tpng.encode_png(img) == jpng.encode_png(img)
    path = tpng.write_png(str(tmp_path / "x.png"), img)
    np.testing.assert_array_equal(tpng.read_png(path), img)
    np.testing.assert_array_equal(jpng.read_png(path), img)


def test_hdr_round_trip(tmp_path):
    img = np.random.default_rng(8).uniform(0, 40, (9, 14, 3)).astype(np.float32)
    path = tpng.write_hdr(str(tmp_path / "x.hdr"), img)
    np.testing.assert_array_equal(tpng.read_hdr(path), jpng.read_hdr(path))
