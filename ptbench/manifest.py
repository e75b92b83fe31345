"""``BENCHMARK.json`` and the files it names, looked up by name.

A cell (an entry of ``workloads``) names a configuration and a traffic mix;
each lives in a file of its own: ``configs/<config>.json`` (its ``file`` in
``BENCHMARK.json``), ``traffic/<traffic>.json``, ``limits/<cell>.json`` (the
limits of the outputs' comparison) and, for each per-layer metric,
``metrics/<metric>.py``, a reader with a ``read(ctx)`` function. A new cell
or metric is new files and new entries, never an edit of a file here.

A configuration's file names, besides its scene and render settings, three
things whose defaults are the megakernel's, so a configuration on another
pipeline is new files too:

- ``"pipeline"`` (default ``"pallas"``): the pipeline the program's
  ``Renderer`` must resolve the configuration to; another fails the run;
- ``"kernels"`` (default ``["pt_megakernel", "pt_env_rows"]``): substrings
  of the device operations the timed path must show in a traced window
  (the idle share's readers fail a trace without one);
- ``"reference"`` (default ``"trace"``): the module
  ``reference/<reference>.py`` that renders the answers again; it defines
  ``estimator(config, dtype, device)`` (the protocol: ``check.py``), which
  the helper modules there (``rng``, ``scene``, ``envmap``) do not.

A scene's ``FILE`` lines (a mesh's OBJ) resolve from the checkout's root,
:data:`ROOT`, whatever the working directory: the program and a reference
that reads them load the same bytes.
"""

from __future__ import annotations

import ast
import dataclasses
import importlib.util
import json
from pathlib import Path
from typing import Callable, Dict, List, Optional

from .devtrace import MEGAKERNEL_NAMES

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent  # the checkout's root
REFERENCES = HERE / "reference"
# a configuration's optional keys and their defaults
DEFAULTS = {"pipeline": "pallas", "kernels": list(MEGAKERNEL_NAMES), "reference": "trace"}


def setting(config: dict, key: str):
    """The configuration's ``pipeline``, ``kernels`` or ``reference``."""
    return config.get(key, DEFAULTS[key])


def defines_estimator(path: Path) -> bool:
    """Whether the module file defines ``estimator`` at its top level (read
    from its source, so nothing is imported before the run's set-up)."""
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)) and node.name == "estimator":
            return True
        if isinstance(node, ast.Assign) and any(
                isinstance(t, ast.Name) and t.id == "estimator" for t in node.targets):
            return True
    return False


def check_settings(config: dict) -> None:
    """Raise ValueError, naming the key, for a ``pipeline`` that is no
    name, ``kernels`` that are not a list of names or are empty, or a
    ``reference`` that names no module of ``reference/`` defining
    ``estimator``."""
    pipeline, kernels, ref = (setting(config, k) for k in ("pipeline", "kernels", "reference"))
    if not isinstance(pipeline, str) or not pipeline:
        raise ValueError(f"configuration key 'pipeline': {pipeline!r} is not a pipeline's name")
    if not isinstance(kernels, list) or not all(isinstance(k, str) and k for k in kernels):
        raise ValueError(f"configuration key 'kernels': {kernels!r} is not a list of names")
    if not kernels:
        raise ValueError("configuration key 'kernels' is empty: a traced window would "
                         "have nothing to find")
    if not (isinstance(ref, str) and ref.isidentifier() and not ref.startswith("_")
            and (REFERENCES / f"{ref}.py").is_file()):
        raise ValueError(f"configuration key 'reference': {ref!r} names no module "
                         f"{REFERENCES.relative_to(ROOT)}/<name>.py")
    if not defines_estimator(REFERENCES / f"{ref}.py"):
        raise ValueError(f"configuration key 'reference': {ref!r} is a module of "
                         f"{REFERENCES.relative_to(ROOT)}/ that defines no "
                         f"estimator(config, dtype, device)")


def reference_module(config: dict):
    """The configuration's reference module, imported by name."""
    return importlib.import_module(f"{__package__}.reference.{setting(config, 'reference')}")


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
        read from their files, and the metrics it reports; ValueError for a
        configuration whose optional keys are misused."""
        found = [w for w in self.data["workloads"] if w["name"] == name]
        if not found:
            names = ", ".join(w["name"] for w in self.data["workloads"])
            raise KeyError(f"no workload {name!r} in {self.path} (one of: {names})")
        w = found[0]
        cfg = [c for c in self.data["configs"] if c["name"] == w["config"]]
        if not cfg:
            raise KeyError(f"workload {name!r} names no configuration {w['config']!r}")
        config = json.loads((self.root / cfg[0]["file"]).read_text())
        check_settings(config)
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
