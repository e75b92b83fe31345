"""PyTorch port, golden-image regression: region radiances of a low-res
light_only render by the port (the plain PyTorch version of the megakernel,
on the CPU) must match the upstream reference render
`img/REFERENCE_cornell.5000samp.png` — the region pins and tolerances of
test_golden.py."""

import math
import os

import numpy as np
import pytest
import torch

from cosc_4397_pathtracing_raytracing_project_tpu_torch import RenderConfig, Renderer, parse_scene
from cosc_4397_pathtracing_raytracing_project_tpu_torch.io.png import read_png

from test_golden import GOLDEN_REGIONS

torch.set_num_threads(2)

HERE = os.path.dirname(__file__)


def _golden_scene(res: int):
    path = os.path.join(HERE, "..", "scenes", "cornell_golden.txt")
    return parse_scene(open(path).read().replace("RES         800 800", f"RES         {res} {res}"))


@pytest.fixture(scope="module")
def golden_render():
    r = Renderer(
        _golden_scene(128),
        RenderConfig(samples_per_launch=25, gather_mode="light_only", antialias=True),
        device="cpu",
    )
    r.render(100)
    return np.clip(r.linear_image(), 0, 1)[:, ::-1, :]


@pytest.mark.parametrize("region", list(GOLDEN_REGIONS))
def test_region_matches_golden(golden_render, region):
    (ys, xs), want = GOLDEN_REGIONS[region]
    got = golden_render[ys, xs].mean(axis=(0, 1))
    np.testing.assert_allclose(got, np.asarray(want), rtol=0.15, atol=0.02)


@pytest.mark.slow
def test_full_image_psnr_vs_golden():
    """Full-image PSNR gate of test_golden.py on the port: 160² (the golden
    box-filtered 5×5), 200 spp, PSNR above 25.5 dB."""
    golden = read_png(os.path.join(HERE, "data", "REFERENCE_cornell.5000samp.png"))
    g160 = (golden.astype(np.float32) / 255.0).reshape(160, 5, 160, 5, 3).mean(axis=(1, 3))
    r = Renderer(
        _golden_scene(160), RenderConfig(samples_per_launch=50, antialias=True), device="cpu"
    )
    r.render(200)
    img = np.clip(r.linear_image(), 0, 1)[:, ::-1, :]
    psnr = 10 * math.log10(1.0 / float(((img - g160) ** 2).mean()))
    assert psnr > 25.5, f"full-image PSNR {psnr:.2f} dB below gate"
