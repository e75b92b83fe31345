"""Run one cell of the benchmark of the PyTorch/CUDA path tracer.

    python3 -m ptbench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds ``BENCHMARK.json``. With ``--trace
0`` the result reports the cell's end-to-end metrics, with ``--trace 1``
its per-layer metrics read from a ``torch.profiler`` trace of the window.
The last line of standard output is the result, one JSON object; an
earlier line carries the noise record's summary (the card's clocks, power
and temperature beside the window, the jobs' or frames' times), whose whole
is written under ``TMPDIR``. The compared numbers and their limits are the
last lines of standard error.
"""

import time

T_START = time.perf_counter()  # before the heavy imports: set-up starts here

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

# top-level module names that must not be loaded: JAX and the JAX package
FORBIDDEN = ("jax", "jaxlib", "flax", "cosc_4397_pathtracing_raytracing_project_tpu")
ROOT = Path.cwd()
# build and kernel caches of the program at fixed paths inside the checkout
CACHES = {"TRITON_CACHE_DIR": ROOT / "build" / "ptbench" / "triton",
          "TORCH_EXTENSIONS_DIR": ROOT / "build" / "ptbench" / "torch_extensions"}


def forbidden_modules() -> list:
    """The loaded modules whose top-level name, compared whole, is forbidden."""
    return sorted({name.split(".")[0] for name in sys.modules} & set(FORBIDDEN))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    for key, path in CACHES.items():
        os.environ[key] = str(path)
    from .manifest import Manifest

    cell = Manifest(ROOT / "BENCHMARK.json").cell(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"ptbench: {args.workload} needs {cell.chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    from . import drive

    result, record = drive.run_cell(cell, args.seed, args.seconds, bool(args.trace),
                                    device="cuda", t_start=T_START)
    found = forbidden_modules()
    if found:
        print(f"ptbench: the run loaded {', '.join(found)}", file=sys.stderr)
        return 3
    path = drive.write_record(record, args.workload, args.seed, bool(args.trace))
    print(json.dumps({"noise": record["summary"], "record": str(path)}))
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']} (limit {c['limit']})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result))
    sys.stdout.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
