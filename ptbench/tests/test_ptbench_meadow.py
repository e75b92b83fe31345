"""The map generator at height 128 gives the repository's meadow map, within
the precision of the HDR format: RGBE keeps an 8-bit mantissa per channel
under the texel's shared exponent, so a channel is good to one step of the
largest channel's mantissa, 2^-7 of it."""

from __future__ import annotations

import numpy as np

from cosc_4397_pathtracing_raytracing_project_tpu_torch.io.png import read_hdr
from ptbench.meadow import meadow
from ptbench_fixtures import ROOT


def test_meadow_reproduces_the_repository_map():
    stored = read_hdr(str(ROOT / "scenes" / "meadow.hdr"))
    made = meadow(128)
    assert made.shape == stored.shape == (128, 256, 3)
    top = made.max(axis=-1, keepdims=True)
    assert np.all(np.abs(made - stored) <= top * 2.0 ** -7)
    assert np.array_equal(made.max(axis=-1) > 1000.0, stored.max(axis=-1) > 1000.0)  # the sun


def test_meadow_at_the_configured_size_is_the_same_sky():
    small, large = meadow(64), meadow(256)
    assert large.shape == (256, 512, 3)
    # the sun covers the same share of the sphere's texels at any size, to a texel's rim
    assert abs((large > 1000).mean() - (small > 1000).mean()) < 0.6 * (small > 1000).mean()
    # the zenith row is the sky's zenith blue at any size
    assert np.allclose(large[0].mean(axis=0), small[0].mean(axis=0), atol=1e-3)
