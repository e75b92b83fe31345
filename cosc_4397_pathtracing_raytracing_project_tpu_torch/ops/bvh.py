"""BVH construction (host, NumPy).

Port of the host build of the JAX package's ``ops/bvh.py`` (``FlatBVH``,
``build_bvh``), which replicates the reference exactly
(`src/pathtrace.cu:23-111`): a recursive median split on the longest axis of
the *centroid* bounding box, primitives sorted by centroid
(`buildBVHRecursive`, `:52-99`), nodes emitted in preorder so the left child
is always ``index + 1``, each node threaded with a ``miss_link`` (the
preorder successor of its subtree). The mesh pipeline cuts this tree into
the cluster kernel's treelets (``ops/cuda/mesh_kernel.treelet_cut``).

The NumPy build is the JAX package's reference semantics, and the JAX
package's tests pin its native C++ builder equal to it, so this tree equals
whichever the JAX package builds. The device traversal (``BVHIntersector``,
``intersector='bvh'``) belongs to the reference pipeline (ROADMAP Queue 1
item 9); the native builder's loader to the host tooling (item 16).
"""

from __future__ import annotations

import dataclasses
import sys

import numpy as np


@dataclasses.dataclass
class FlatBVH:
    """Flattened, threaded BVH (NumPy, host)."""

    bounds_min: np.ndarray  # (K, 3) f32
    bounds_max: np.ndarray  # (K, 3) f32
    miss_link: np.ndarray  # (K,) i32 — preorder successor of the subtree
    leaf_start: np.ndarray  # (K,) i32 — index into `order`, -1 for internal
    leaf_count: np.ndarray  # (K,) i32
    order: np.ndarray  # (P,) i32 — primitive ids in leaf-contiguous order

    @property
    def num_nodes(self) -> int:
        return int(self.bounds_min.shape[0])


def build_bvh(mins: np.ndarray, maxs: np.ndarray, leaf_size: int = 1) -> FlatBVH:
    """Median-split build (reference algorithm, generalized leaf size) over
    the primitives' axis-aligned boxes ``mins``/``maxs`` [P, 3]."""
    n = mins.shape[0]
    if n == 0:
        raise ValueError("cannot build a BVH over zero primitives")
    mins = np.asarray(mins, np.float32)
    maxs = np.asarray(maxs, np.float32)
    centroids = (mins + maxs) * 0.5

    bmin, bmax, lstart, lcount = [], [], [], []
    order: list = []

    # Preorder recursion; parents union their children's bounds after both
    # subtrees are emitted (`pathtrace.cu:95-98`).
    def rec(indices: np.ndarray) -> int:
        node = len(bmin)
        bmin.append(None)
        bmax.append(None)
        lstart.append(-1)
        lcount.append(0)
        if len(indices) <= leaf_size:
            bmin[node] = mins[indices].min(axis=0)
            bmax[node] = maxs[indices].max(axis=0)
            lstart[node] = len(order)
            lcount[node] = len(indices)
            order.extend(int(i) for i in indices)
            return node
        cent = centroids[indices]
        extent = cent.max(axis=0) - cent.min(axis=0)
        # axis pick per `pathtrace.cu:79-80`
        if extent[0] > extent[1] and extent[0] > extent[2]:
            axis = 0
        elif extent[1] > extent[2]:
            axis = 1
        else:
            axis = 2
        indices = indices[np.argsort(cent[:, axis], kind="stable")]
        mid = len(indices) // 2
        left = rec(indices[:mid])
        right = rec(indices[mid:])
        bmin[node] = np.minimum(bmin[left], bmin[right])
        bmax[node] = np.maximum(bmax[left], bmax[right])
        return node

    old_limit = sys.getrecursionlimit()
    sys.setrecursionlimit(max(old_limit, 4 * n + 100))
    try:
        rec(np.arange(n))
        k = len(bmin)
        leaf_start = np.asarray(lstart, np.int32)
        # miss link of a node = end of its preorder subtree (next node to
        # visit when the node's box is missed, or after a leaf is tested)
        subtree_end = np.zeros(k, np.int32)

        def mark_ends(node: int) -> int:
            if leaf_start[node] >= 0:
                subtree_end[node] = node + 1
                return node + 1
            left_end = mark_ends(node + 1)
            right_end = mark_ends(left_end)
            subtree_end[node] = right_end
            return right_end

        mark_ends(0)
    finally:
        sys.setrecursionlimit(old_limit)

    return FlatBVH(
        bounds_min=np.stack(bmin).astype(np.float32),
        bounds_max=np.stack(bmax).astype(np.float32),
        miss_link=subtree_end.astype(np.int32),
        leaf_start=leaf_start,
        leaf_count=np.asarray(lcount, np.int32),
        order=np.asarray(order, np.int32),
    )
