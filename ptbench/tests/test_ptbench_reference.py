"""The plain reference against the program's plain version, and its
control.

The reference (``ptbench/reference/``) rebuilds the scene, the map's alias
table, env NEE's rows, the path sums and the accumulation from the inputs
alone; on the CPU at a small size it equals the program's plain PyTorch
version bit for bit. Its control, the reference computed in bfloat16 in
the program's place, fails each cell's limits (the chip reads the same
comparison at the cells' own sizes: ``python3 -m ptbench.calibrate
control``)."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from cosc_4397_pathtracing_raytracing_project_tpu_torch.ops.envmap import build_envmap
from cosc_4397_pathtracing_raytracing_project_tpu_torch.render.engine import (
    RenderConfig, Renderer)
from ptbench import calibrate, check, drive
from ptbench.meadow import meadow
from ptbench.reference import envmap as ref_envmap
from ptbench_fixtures import small_cell

CELLS = ("cornell.offline", "env4k.offline", "cornell.interactive", "env4k.interactive")


@pytest.fixture(autouse=True)
def _few_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 4))
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("height", [16, 256])
def test_alias_table_equals_the_programs(height):
    img = meadow(height)
    prog = build_envmap(img, 1.0, "cpu")
    ref = ref_envmap.build(img, 1.0, "cpu")
    assert torch.equal(ref.alias_prob, prog.alias_prob)
    assert torch.equal(ref.alias_idx, prog.alias_idx.to(torch.int64))
    assert torch.equal(ref.pdf, prog.pdf)


@pytest.mark.parametrize("name", ["cornell.offline", "env4k.offline"])
def test_reference_equals_the_programs_plain_version(name):
    cell = small_cell(name)
    seed = 2 ** 32 + 17
    r = Renderer(drive.scene_desc(cell.config), RenderConfig(**cell.config["render"]),
                 seed=seed, device="cpu")
    r.step(4)
    r.step(4)
    got = r.linear_image().reshape(-1, 3)
    est = check.estimator(cell.config)
    pixels = torch.arange(got.shape[0])
    accum = est.accumulate(seed, pixels, [(1, 4), (5, 4)])  # its int32 word keys the streams
    assert np.array_equal((accum / 8.0).numpy(), got)


@pytest.mark.parametrize("name", CELLS)
def test_bfloat16_control_fails_the_limits(name):
    cell = small_cell(name)
    out = calibrate.control(cell, 7, 8, torch.device("cpu"))
    assert out["checked"] == 3 and out["failed"] > 0
    assert any(v > cell.limits["numbers"][k] for k, v in out["numbers"].items())


def test_frozen_count_reads_the_reference():
    cell = small_cell("env4k.offline")
    work = calibrate.count(cell.config, 2, torch.device("cpu"))
    assert set(work) == {"isect", "scatter", "env_shadow", "env_lookup", "env_pdf"}
    # every sample escapes once or is absorbed; never more lookups than samples
    assert 0.0 < work["env_lookup"] <= 1.0 and work["env_pdf"] <= work["env_lookup"]
