"""Build the package's CUDA and host C++ sources into shared libraries and
load them.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled by ``nvcc``
alone (no PyTorch headers, so a build takes seconds) into
``build/torch_kernels/lib<name>.<hash>.so`` at the root of the checkout, then
loaded with ``ctypes``. The host runtime's ``native/src/<name>.cc`` is
compiled the same way by the host C++ compiler (:func:`build_host`). The hash
covers the source and the flags, so an edited source is rebuilt and a stale
library is never loaded. Nothing is built when a module is imported: the
first call that needs a library builds it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Sequence

PACKAGE_DIR = Path(__file__).resolve().parents[2]
CSRC_DIR = PACKAGE_DIR / "csrc"
NATIVE_SRC_DIR = PACKAGE_DIR / "native" / "src"
BUILD_DIR = PACKAGE_DIR.parent / "build" / "torch_kernels"

# -fmad=false: no multiply-add contraction, so every kernel rounds after each
# operation exactly as its plain PyTorch version does (see the note at the top
# of each source). No --use_fast_math.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-fmad=false",
    "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

# The host runtime: -ffp-contract=off and no -ffast-math or -march=native, so
# its double arithmetic rounds after each operation as NumPy's does.
HOST_FLAGS = ("-O2", "-shared", "-fPIC", "-std=c++17", "-ffp-contract=off")
HOST_LIBS = ("-lz",)


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = Path(cuda_home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin): cannot build CUDA kernels")


def source_path(name: str) -> Path:
    return CSRC_DIR / f"{name}.cu"


def host_source_path(name: str) -> Path:
    return NATIVE_SRC_DIR / f"{name}.cc"


def _library_path(source: Path, name: str, flags: Sequence[str]) -> Path:
    digest = hashlib.sha256(source.read_bytes())
    digest.update(" ".join(flags).encode())
    return BUILD_DIR / f"lib{name}.{digest.hexdigest()[:12]}.so"


def library_path(name: str, flags: Sequence[str] = NVCC_FLAGS) -> Path:
    return _library_path(source_path(name), name, flags)


def host_library_path(name: str, flags: Sequence[str] = HOST_FLAGS) -> Path:
    return _library_path(host_source_path(name), name, (*flags, *HOST_LIBS))


def log_path(name: str, flags: Sequence[str] = NVCC_FLAGS) -> Path:
    """nvcc's output (ptxas registers, spills) of the library's build."""
    return library_path(name, flags).with_suffix(".log")


def _compile(path: Path, source: Path, argv, log: Path = None) -> None:
    """Run ``argv + [-o tmp]`` unless ``path`` exists, write the compiler's
    output to ``log`` if one is given, then move the library into place.
    Raises with the compiler's output on failure."""
    if path.exists():
        return
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(f".tmp{os.getpid()}.so")
    try:
        proc = subprocess.run(
            [*argv, "-o", str(tmp)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        if proc.returncode != 0:
            raise RuntimeError(f"{argv[0]} failed for {source}:\n{proc.stdout}")
        if log is not None:
            log.write_text(proc.stdout)
        os.replace(tmp, path)  # atomic: a concurrent build never sees a partial file
    finally:
        if tmp.exists():
            tmp.unlink()


def build(name: str, flags: Sequence[str] = NVCC_FLAGS) -> Path:
    """Compile ``csrc/<name>.cu`` with ``flags`` unless its library exists;
    returns the library's path. Raises with nvcc's output on failure."""
    path = library_path(name, flags)
    source = source_path(name)
    _compile(path, source, [nvcc_path(), *flags, str(source)], log_path(name, flags))
    return path


def host_compiler() -> str:
    for name in ("g++", "c++"):
        found = shutil.which(name)
        if found:
            return found
    raise RuntimeError("no C++ compiler (g++, c++) on PATH: cannot build the host runtime")


def build_host(name: str, flags: Sequence[str] = HOST_FLAGS) -> Path:
    """Compile ``native/src/<name>.cc`` with the host C++ compiler and
    ``flags``, linked with ``HOST_LIBS``, unless its library exists; returns
    the library's path. Raises with the compiler's output on failure."""
    path = host_library_path(name, flags)
    source = host_source_path(name)
    _compile(path, source, [host_compiler(), *flags, str(source), *HOST_LIBS])
    return path


def load(name: str, flags: Sequence[str] = NVCC_FLAGS) -> ctypes.CDLL:
    """Build ``csrc/<name>.cu`` if needed and load it."""
    return ctypes.CDLL(str(build(name, flags)))
