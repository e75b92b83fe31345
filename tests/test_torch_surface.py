"""The port does what the JAX package does: every public top-level function
and class of the JAX package has a counterpart of the same name, bound at
the top level of the port's module of the same path (``ops/pallas/<m>.py``
maps to ``ops/cuda/<m>.py``; ``__graft_entry__.py`` at the repo's root maps
to the port's ``entry.py`` and ``parallel/dryrun.py``). Both packages are
read as text with ``ast``; neither is imported."""

import ast
import os

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_PKG = os.path.join(REPO, "cosc_4397_pathtracing_raytracing_project_tpu")
PORT_PKG = os.path.join(REPO, "cosc_4397_pathtracing_raytracing_project_tpu_torch")

# (JAX module, name) -> why the port has no counterpart of that name.
EXCEPTIONS: dict = {
    ("render/profiling.py", "profile_stages"):
        "nothing of the port timed the readable pipeline's stages one by one",
    ("render/profiling.py", "annotate"): "the tracer's span takes its place",
}

# the driver's entry points beside the package, and their counterparts
GRAFT_ENTRY = {"entry": "entry.py", "dryrun_multichip": "parallel/dryrun.py"}


def _public_defs(path):
    tree = ast.parse(open(path).read(), path)
    return [n.name for n in tree.body
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef))
            and not n.name.startswith("_")]


def _bound_names(path):
    """Names a module binds at its top level: functions, classes and
    assignments (an alias such as ``f = g`` counts)."""
    tree = ast.parse(open(path).read(), path)
    names = set()
    for n in tree.body:
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            names.add(n.name)
        elif isinstance(n, ast.Assign):
            names.update(t.id for t in n.targets if isinstance(t, ast.Name))
        elif isinstance(n, ast.AnnAssign) and isinstance(n.target, ast.Name):
            names.add(n.target.id)
    return names


def _port_module(rel):
    parts = rel.split("/")
    if parts[:2] == ["ops", "pallas"]:
        parts = ["ops", "cuda"] + parts[2:]
    return "/".join(parts)


def _jax_modules():
    out = []
    for root, _dirs, files in os.walk(JAX_PKG):
        for f in files:
            if f.endswith(".py"):
                rel = os.path.relpath(os.path.join(root, f), JAX_PKG).replace(os.sep, "/")
                if _public_defs(os.path.join(JAX_PKG, rel)):
                    out.append(rel)
    return sorted(out)


JAX_MODULES = _jax_modules()


def test_the_walk_finds_the_packages():
    assert "ops/bvh.py" in JAX_MODULES and "native/runtime.py" in JAX_MODULES
    assert "ops/pallas/megakernel.py" in JAX_MODULES
    assert _port_module("ops/pallas/mesh_kernel.py") == "ops/cuda/mesh_kernel.py"
    assert len(JAX_MODULES) >= 30


@pytest.mark.parametrize("rel", JAX_MODULES)
def test_every_public_name_has_a_counterpart(rel):
    port = os.path.join(PORT_PKG, _port_module(rel))
    assert os.path.exists(port), f"the port has no module {_port_module(rel)}"
    have = _bound_names(port)
    missing = [name for name in _public_defs(os.path.join(JAX_PKG, rel))
               if name not in have and (rel, name) not in EXCEPTIONS]
    assert not missing, f"{_port_module(rel)} lacks {missing}"


def test_the_entry_points_have_counterparts():
    assert sorted(_public_defs(os.path.join(REPO, "__graft_entry__.py"))) == sorted(GRAFT_ENTRY)
    for name, rel in GRAFT_ENTRY.items():
        assert name in _bound_names(os.path.join(PORT_PKG, rel)), f"{rel} lacks {name}"
    assert "_cornell_desc" in _bound_names(os.path.join(PORT_PKG, "entry.py"))


def test_exceptions_name_existing_jax_functions():
    for (rel, name), why in EXCEPTIONS.items():
        assert name in _public_defs(os.path.join(JAX_PKG, rel)) and why
