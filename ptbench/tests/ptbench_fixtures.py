"""Cells of the benchmark cut to a size a CPU test run holds: the same scene
text at a few pixels, a small map, short jobs and short drags."""

from __future__ import annotations

import copy
import dataclasses
from pathlib import Path

from ptbench.manifest import Manifest

ROOT = Path(__file__).resolve().parents[2]
SMALL_RES = 12
SMALL_MAP = 256  # 256×512 texels: past the alias draw's 2^15-texel split


def small_config(config: dict, res: int = SMALL_RES, map_height: int = SMALL_MAP) -> dict:
    config = copy.deepcopy(config)
    config["scene"] = [f"RES         {res} {res}" if line.startswith("RES") else line
                       for line in config["scene"]]
    config["render"]["samples_per_launch"] = 4
    if "envmap" in config:
        config["envmap"]["height"] = map_height
    return config


def small_cell(name: str, **kw):
    cell = Manifest(ROOT / "BENCHMARK.json").cell(name)
    traffic = dict(cell.traffic)
    if traffic["kind"] == "offline":
        traffic["job_spp"] = 10  # steps of 4, 4 and 2
    else:
        traffic.update(frame_spp=4, drag_frames=3, still_frames=2,
                       drag_px=[[3, 1], [5, -1], [2, 0]])
    limits = dict(cell.limits, pixels=48, answers=3)
    return dataclasses.replace(cell, config=small_config(cell.config, **kw), traffic=traffic,
                               limits=limits)
