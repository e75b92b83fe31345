"""``BENCHMARK.json`` and the files it names, looked up by name.

A cell (an entry of ``workloads``) names a configuration and a traffic mix;
each lives in a file of its own: ``configs/<config>.json`` (its ``file`` in
``BENCHMARK.json``), ``traffic/<traffic>.json``, ``limits/<cell>.json`` (the
limits of the outputs' comparison) and, for each per-layer metric,
``metrics/<metric>.py``, a reader with a ``read(ctx)`` function. A new cell
or metric is new files and new entries, never an edit of a file here.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path
from typing import Callable, Dict, List, Optional

HERE = Path(__file__).resolve().parent


@dataclasses.dataclass(frozen=True)
class Metric:
    name: str
    unit: str
    moves: Optional[str]  # the end-to-end metric a per-layer metric moves
    workloads: Optional[tuple]  # the cells that report it; None: every cell

    def applies_to(self, cell: str) -> bool:
        return self.workloads is None or cell in self.workloads


@dataclasses.dataclass(frozen=True)
class Cell:
    name: str
    config: dict
    traffic: dict
    limits: dict
    chips: int
    end_to_end: tuple
    per_layer: tuple


class Manifest:
    def __init__(self, path: Path):
        self.path = Path(path)
        self.root = self.path.parent
        self.data = json.loads(self.path.read_text())

    def _metrics(self, key: str) -> List[Metric]:
        return [Metric(name=m["name"], unit=m["unit"], moves=m.get("moves"),
                       workloads=tuple(m["workloads"]) if "workloads" in m else None)
                for m in self.data[key]]

    def cell(self, name: str) -> Cell:
        """The workload ``name`` with its configuration, traffic and limits
        read from their files, and the metrics it reports."""
        found = [w for w in self.data["workloads"] if w["name"] == name]
        if not found:
            names = ", ".join(w["name"] for w in self.data["workloads"])
            raise KeyError(f"no workload {name!r} in {self.path} (one of: {names})")
        w = found[0]
        cfg = [c for c in self.data["configs"] if c["name"] == w["config"]]
        if not cfg:
            raise KeyError(f"workload {name!r} names no configuration {w['config']!r}")
        config = json.loads((self.root / cfg[0]["file"]).read_text())
        traffic = json.loads((HERE / "traffic" / f"{w['traffic']}.json").read_text())
        limits = json.loads((HERE / "limits" / f"{name}.json").read_text())
        end_to_end = tuple(m for m in self._metrics("end_to_end") if m.applies_to(name))
        per_layer = tuple(m for m in self._metrics("per_layer") if m.applies_to(name))
        return Cell(name=name, config=config, traffic=traffic, limits=limits,
                    chips=int(w["chips"]), end_to_end=end_to_end, per_layer=per_layer)


def reader(metric: str) -> Callable:
    """The ``read(ctx)`` function of ``metrics/<metric>.py``."""
    path = HERE / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(f"ptbench.metrics.{metric}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def readers(cell: Cell) -> Dict[str, Callable]:
    return {m.name: reader(m.name) for m in cell.per_layer}
