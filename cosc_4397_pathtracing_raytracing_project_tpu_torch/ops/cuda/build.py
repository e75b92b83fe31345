"""Build the package's CUDA sources into shared libraries and load them.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled by ``nvcc``
alone (no PyTorch headers, so a build takes seconds) into
``build/torch_kernels/lib<name>.<hash>.so`` at the root of the checkout, then
loaded with ``ctypes``. The hash covers the source and the flags, so an edited
source is rebuilt and a stale library is never loaded. Nothing is built when
a module is imported: the first launch of a kernel builds it.
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


def library_path(name: str, flags: Sequence[str] = NVCC_FLAGS) -> Path:
    digest = hashlib.sha256(source_path(name).read_bytes())
    digest.update(" ".join(flags).encode())
    return BUILD_DIR / f"lib{name}.{digest.hexdigest()[:12]}.so"


def log_path(name: str, flags: Sequence[str] = NVCC_FLAGS) -> Path:
    """nvcc's output (ptxas registers, spills) of the library's build."""
    return library_path(name, flags).with_suffix(".log")


def build(name: str, flags: Sequence[str] = NVCC_FLAGS) -> Path:
    """Compile ``csrc/<name>.cu`` with ``flags`` unless its library exists;
    returns the library's path. Raises with nvcc's output on failure."""
    path = library_path(name, flags)
    if path.exists():
        return path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(f".tmp{os.getpid()}.so")
    try:
        proc = subprocess.run(
            [nvcc_path(), *flags, "-o", str(tmp), str(source_path(name))],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {source_path(name)}:\n{proc.stdout}")
        log_path(name, flags).write_text(proc.stdout)
        os.replace(tmp, path)  # atomic: a concurrent build never sees a partial file
    finally:
        if tmp.exists():
            tmp.unlink()
    return path


def load(name: str, flags: Sequence[str] = NVCC_FLAGS) -> ctypes.CDLL:
    """Build ``csrc/<name>.cu`` if needed and load it."""
    return ctypes.CDLL(str(build(name, flags)))
