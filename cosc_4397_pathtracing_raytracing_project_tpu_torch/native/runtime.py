"""ctypes bindings for the port's native host runtime (``native/src/ptruntime.cc``).

The reference's host runtime is C++ (scene parsing `src/scene.cpp`, BVH
construction `src/pathtrace.cu:23-111`, PNG encoding via stb). This module
builds the port's own copy of that library at first use
(``ops/cuda/build.build_host``, into ``build/torch_kernels/``) and binds its
entry points under the JAX package's names.

Nothing here is optional: the first call builds and loads the library, a
library that cannot be built raises ``RuntimeError`` with the compiler's
output, and an input the C++ rejects (an unknown PNG filter byte, an
unreadable OBJ, a BVH over no primitives) raises ``ValueError``. Each caller
in the package takes these functions; its NumPy code stays beside it as the
plain version that the tests hold the library against.
"""

from __future__ import annotations

import ctypes
import threading
from pathlib import Path
from typing import Optional

import numpy as np

from ..ops.cuda import build

NAME = "ptruntime"

_LIB: Optional[ctypes.CDLL] = None
_LOCK = threading.Lock()

_u8p = ctypes.POINTER(ctypes.c_uint8)
_f32p = ctypes.POINTER(ctypes.c_float)
_f64p = ctypes.POINTER(ctypes.c_double)
_i32p = ctypes.POINTER(ctypes.c_int32)


def _ptr(a: np.ndarray, kind):
    return a.ctypes.data_as(kind)


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    lib.pt_write_png.restype = ctypes.c_int
    lib.pt_write_png.argtypes = [ctypes.c_char_p, _u8p, ctypes.c_int, ctypes.c_int, ctypes.c_int]
    lib.pt_png_defilter.restype = ctypes.c_int
    # raw [h, 1+stride] in place, height, stride (bytes), bytes per pixel
    lib.pt_png_defilter.argtypes = [_u8p, ctypes.c_int, ctypes.c_int, ctypes.c_int]
    lib.pt_build_bvh.restype = ctypes.c_int
    lib.pt_build_bvh.argtypes = [
        _f32p,  # mins [n, 3]
        _f32p,  # maxs [n, 3]
        ctypes.c_int,  # n
        ctypes.c_int,  # leaf_size
        _f32p,  # out node bounds [2n, 6]
        _i32p,  # out left / subtree_end / start / count [2n, 4]
        _i32p,  # out primitive order [n]
    ]
    lib.pt_build_alias.restype = ctypes.c_int
    # p [n] (sums to 1), n, out stay probability [n], out alias partner [n]
    lib.pt_build_alias.argtypes = [_f64p, ctypes.c_int64, _f64p, _i32p]
    lib.pt_count_obj.restype = ctypes.c_int
    lib.pt_count_obj.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
    ]
    lib.pt_load_obj.restype = ctypes.c_int
    lib.pt_load_obj.argtypes = [ctypes.c_char_p, _f32p, ctypes.c_int64]
    return lib


def ensure_built() -> Path:
    """Build the library unless it exists; returns its path. Raises
    ``RuntimeError`` with the compiler's output when it does not build."""
    return build.build_host(NAME)


def _lib() -> ctypes.CDLL:
    global _LIB
    with _LOCK:
        if _LIB is None:
            _LIB = _bind(ctypes.CDLL(str(ensure_built())))
        return _LIB


def available() -> bool:
    """True once the library is built and loaded; building it raises
    rather than returning False."""
    return _lib() is not None


def write_png(path: str, image: np.ndarray) -> str:
    """Write an [H, W, 3|4] uint8 image as a PNG (filter 0, zlib level 6);
    ``.png`` is appended when missing. Returns the path written."""
    image = np.ascontiguousarray(image)
    if image.dtype != np.uint8 or image.ndim != 3:
        raise ValueError(f"expected [H, W, 3|4] uint8 image, got {image.dtype} {image.shape}")
    h, w, c = image.shape
    if not path.endswith(".png"):
        path = path + ".png"
    rc = _lib().pt_write_png(path.encode(), _ptr(image, _u8p), w, h, c)
    if rc == 1:
        raise ValueError(f"expected [H, W, 3|4] uint8 image, got {image.dtype} {image.shape}")
    if rc == 2:
        raise RuntimeError("zlib compression failed")
    if rc != 0:
        raise OSError(f"cannot write {path}")
    return path


def png_defilter(raw: np.ndarray, height: int, stride: int, bpp: int) -> None:
    """Reverse PNG scanline filters in place: ``raw`` is a contiguous uint8
    ``[height, 1+stride]`` array (filter byte + payload per row). Raises
    ``ValueError`` on an unknown filter type."""
    if raw.dtype != np.uint8 or not raw.flags["C_CONTIGUOUS"] or raw.size != height * (1 + stride):
        raise ValueError("raw must be a contiguous uint8 [height, 1+stride] array")
    if _lib().pt_png_defilter(_ptr(raw, _u8p), height, stride, bpp) != 0:
        raise ValueError(f"unknown PNG filter type among {sorted(set(raw[:, 0].tolist()))}")


def build_bvh(mins: np.ndarray, maxs: np.ndarray, leaf_size: int = 1):
    """Median-split BVH build over the boxes ``mins``/``maxs`` [n, 3]
    (``ops.bvh.build_bvh``'s algorithm). Returns the preorder arrays
    ``(bounds_min, bounds_max, left, subtree_end, start, count, order)``.
    Raises ``ValueError`` for no primitives."""
    mins = np.ascontiguousarray(mins, np.float32)
    maxs = np.ascontiguousarray(maxs, np.float32)
    n = mins.shape[0]
    if mins.shape != (n, 3) or maxs.shape != (n, 3):
        raise ValueError(f"expected two [n, 3] box arrays, got {mins.shape} and {maxs.shape}")
    max_nodes = max(2 * n, 1)
    node_bounds = np.zeros((max_nodes, 6), np.float32)
    node_meta = np.zeros((max_nodes, 4), np.int32)
    order = np.zeros(n, np.int32)
    count = _lib().pt_build_bvh(
        _ptr(mins, _f32p), _ptr(maxs, _f32p), n, leaf_size,
        _ptr(node_bounds, _f32p), _ptr(node_meta, _i32p), _ptr(order, _i32p),
    )
    if count <= 0:
        raise ValueError(f"cannot build a BVH over {n} primitives")
    return (
        node_bounds[:count, :3].copy(),
        node_bounds[:count, 3:].copy(),
        node_meta[:count, 0].copy(),
        node_meta[:count, 1].copy(),
        node_meta[:count, 2].copy(),
        node_meta[:count, 3].copy(),
        order,
    )


def build_alias(p: np.ndarray):
    """Vose alias-table build for a normalized distribution ``p`` (the
    stack order of ``ops.envmap._build_alias``). Returns ``(prob f64[n],
    alias i32[n])``; raises ``ValueError`` for an empty ``p`` or one past
    2^31 - 1 cells."""
    p = np.ascontiguousarray(p, np.float64).reshape(-1)
    n = p.size
    prob = np.empty(n, np.float64)
    alias = np.empty(n, np.int32)
    if _lib().pt_build_alias(_ptr(p, _f64p), n, _ptr(prob, _f64p), _ptr(alias, _i32p)) != 0:
        raise ValueError(f"cannot build an alias table over {n} cells")
    return prob, alias


def load_obj_triangles(path: str) -> np.ndarray:
    """Triangle soup of a Wavefront OBJ (``v`` and ``f`` records, fans):
    ``(T, 3, 3)`` float32 object-space triangles. Raises ``ValueError`` when
    the file cannot be read."""
    lib = _lib()
    nv = ctypes.c_int64(0)
    nt = ctypes.c_int64(0)
    if lib.pt_count_obj(path.encode(), ctypes.byref(nv), ctypes.byref(nt)) != 0:
        raise ValueError(f"cannot read OBJ file {path}")
    tris = np.zeros((max(int(nt.value), 1), 3, 3), np.float32)
    got = lib.pt_load_obj(path.encode(), _ptr(tris, _f32p), int(nt.value))
    if got < 0:
        raise ValueError(f"cannot read OBJ file {path}")
    return tris[:got]
