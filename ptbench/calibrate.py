"""Readings the benchmark's limits and frozen counts are set from; the
benchmark's own runs never call this.

    python3 -m ptbench.calibrate count <config> [--spp N]
    python3 -m ptbench.calibrate control <workload> --seeds S [S ...] [--answers N]

``count``: the work per sample of a configuration (``work_per_sample`` in
its file), counted by the plain reference over the whole frame at its first
camera: nearest-hit traces past the primary hit, scatters, escapes, their
pdf lookups and env NEE shadow rays.

``control``: the reference computed in bfloat16 put in the program's place,
at the cell's own size: for each seed, the answers a run of ``--answers``
jobs or frames would check, their pixels and inputs, read by the same
comparison against the float32 reference. Prints the readings as JSON.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from . import check, load
from .manifest import HERE, Manifest


def count(config: dict, spp: int, device) -> dict:
    est = check.estimator(config, device=device)
    sc = est.scene
    stats = {}
    pixels = torch.arange(sc.width * sc.height, dtype=torch.int64, device=device)
    est.accumulate(12345, pixels, [(1, spp)], stats=stats)
    n = float(pixels.numel() * spp)
    return {k: v / n for k, v in sorted(stats.items()) if k != "primary"}


def answers_of(cell, seed: int, n: int, num_pixels: int):
    """The first ``n`` answers of a run of the cell on ``seed`` over a frame
    of ``num_pixels`` (values left empty), and the drags taken before each."""
    table = check.pixel_table(seed, int(cell.limits["pixels"]), num_pixels)
    out, drags = [], []
    if cell.traffic["kind"] == "offline":
        step = int(cell.config["render"]["samples_per_launch"])
        for job in load.jobs(cell.traffic, seed):
            if job.index >= n:
                break
            steps = load.job_steps(job.spp, step)
            out.append(check.Answer(
                index=job.index, seed=job.seed,
                launches=[(1 + step * k, m) for k, m in enumerate(steps)],
                orbit_steps=0, pixels=table[job.index % check.PIXEL_ROWS], values=None))
        return out, drags
    since = []
    for f in load.frames(cell.traffic, seed):
        if f.index >= n:
            break
        if f.drag:
            drags.append(f.drag)
            since = []
        since.append((1 + f.spp * len(since), f.spp))
        out.append(check.Answer(index=f.index, seed=seed, launches=list(since),
                                orbit_steps=len(drags),
                                pixels=table[f.index % check.PIXEL_ROWS], values=None))
    return out, drags


def control(cell, seed: int, n: int, device) -> dict:
    kind = cell.traffic["kind"]
    est = check.estimator(cell.config, device=device)
    answers, drags = answers_of(cell, seed, n, est.scene.width * est.scene.height)
    low = check.estimator(cell.config, dtype=torch.bfloat16, device=device)
    for i in check.answers_to_check(seed, len(answers), int(cell.limits["answers"])):
        answers[i].values = check.reference_values(low, answers[i], kind, drags, device)
    numbers, failed, checked = check.judge(est, kind, answers, cell.limits, seed, drags, device)
    return {"seed": seed, "numbers": numbers, "failed": failed, "checked": checked}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("what", choices=("count", "control"))
    ap.add_argument("name")
    ap.add_argument("--spp", type=int, default=8)
    ap.add_argument("--seeds", type=int, nargs="*", default=[1, 2, 3])
    ap.add_argument("--answers", type=int, default=25)
    args = ap.parse_args(argv)
    device = torch.device("cuda" if torch.cuda.is_available() else "cpu")
    t0 = time.perf_counter()
    if args.what == "count":
        config = json.loads((HERE / "configs" / f"{args.name}.json").read_text())
        print(json.dumps({"config": args.name, "spp": args.spp,
                          "work_per_sample": count(config, args.spp, device)}))
    else:
        cell = Manifest(HERE.parent / "BENCHMARK.json").cell(args.name)
        for seed in args.seeds:
            print(json.dumps({"workload": args.name, **control(cell, seed, args.answers, device),
                              "seconds": time.perf_counter() - t0}), flush=True)
    print(f"device {device}, {time.perf_counter() - t0:.1f} s", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
