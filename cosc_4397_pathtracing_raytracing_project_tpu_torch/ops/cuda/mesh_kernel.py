"""Cluster-culled triangle intersection: the host packing, the CUDA kernels
K7/K8 and their plain PyTorch version.

Port of the JAX package's ``ops/pallas/mesh_kernel.py``. The host side is
the same NumPy code: triangles in BVH leaf order cut into treelet clusters
of ``CLUSTER`` rows (:func:`treelet_cut`), packed into ``ROWF=14``-float
rows with their AABBs (:func:`pack_clusters`), and grouped into
superclusters of ``SUPER`` clusters with a front-to-back visit order per
direction octant (:func:`build_visit_tables`). The TPU kernel's compile
knobs (``JIT_COMPILER_OPTIONS``, ``ABLATION``, its tile shape) have no
counterpart here; ``BATCH`` is kept only because the supercluster count is
padded to its multiple.

- On rays that lie on a CUDA device, :class:`ClusterMeshIntersector` launches
  ``csrc/mesh_kernel.cu`` (one thread per ray): ``call_soa`` the nearest hit
  (K7, the TPU kernel's ``mode="full"``), ``call_t`` its distance only (K8,
  ``mode="tmin"``). On the CPU both run the plain version,
  :func:`intersect_reference`. There is no fallback from one to the other.
- The plain version is vectorized over rays and loops over the clusters in
  packed order: a cluster's rows are tested only for the rays whose slab
  test against the cluster's AABB passes under their current ``best_t``,
  with the kernel's arithmetic and the same strict ``t < best_t``.

The nearest hit is the same whatever the visit order; two triangles at
exactly the same distance (a shared edge) are a tie, which keeps the one
visited first, so the kernel (per-ray octant order) and the plain version
(cluster order) may return different indices there. An inactive ray is a
miss (t ``_MISS``, index -1, zero normal and material).
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from .build import NVCC_FLAGS, load

CLUSTER = 64  # default triangles per cluster (one packed row block)
SUPER = 16  # clusters per supercluster
BATCH = 8  # the TPU kernel's boxes per scalar branch: superclusters pad to it
ROWF = 14  # floats per packed triangle row
_MISS = 1e30
_BACKOFF = 1e-4

# the 8 octant diagonal directions, index = (dx>0) + 2(dy>0) + 4(dz>0)
_OCTANT_SIGNS = np.array(
    [[1 if o & (1 << a) else -1 for a in range(3)] for o in range(8)],
    np.float32,
)

SOURCE = "cosc_4397_pathtracing_raytracing_project_tpu_torch/csrc/mesh_kernel.cu"

# The kernel's two walks (csrc/mesh_kernel.cu states why): in the lane walk
# lane l of a warp walks ray l alone; in the warp walk each warp serves live
# rays one at a time with all its lanes. Measured on mesh1080p's rays
# (PERF.md, Findings), the lane walk wins only on primary rays, all live and
# coherent, so the mesh pipeline takes it there and the warp walk elsewhere.
WALKS = ("lane", "warp")

# Rays per batch of the plain version's per-cluster triangle test (bounds the
# memory of its [rays, cluster_size] temporaries).
_REFERENCE_RAYS = 1 << 18


# ──────────────────────────────── host packing ────────────────────────────────


def treelet_cut(bvh, cluster_size: int):
    """Cut a preorder FlatBVH (ops.bvh) into a two-level treelet partition.

    Returns (clusters, membership): ``clusters`` is a list of (start, count)
    primitive ranges — the deepest subtrees with ≤ cluster_size primitives —
    and ``membership[s]`` lists the cluster ids of supercluster s (the
    deepest subtrees containing ≤ SUPER clusters). Preorder + contiguous
    leaf emission ⇒ every subtree is a contiguous primitive range, so
    clusters stay contiguous in the packed row array."""
    k = bvh.bounds_min.shape[0]
    leaf = bvh.leaf_start >= 0
    prim_count = np.zeros(k, np.int64)
    prim_start = np.zeros(k, np.int64)
    for n in range(k - 1, -1, -1):
        if leaf[n]:
            prim_start[n] = bvh.leaf_start[n]
            prim_count[n] = bvh.leaf_count[n]
        else:
            left = n + 1
            right = int(bvh.miss_link[left])
            prim_start[n] = prim_start[left]
            prim_count[n] = prim_count[left] + prim_count[right]

    def cut(pred):
        out = []
        stack = [0]
        while stack:
            n = stack.pop()
            if pred(n) or leaf[n]:
                out.append(n)
            else:
                left = n + 1
                stack.append(int(bvh.miss_link[left]))  # right
                stack.append(left)  # popped first → preorder
        return out

    cl_nodes = cut(lambda n: prim_count[n] <= cluster_size)
    clusters = []
    for n in cl_nodes:
        s, c = int(prim_start[n]), int(prim_count[n])
        # an oversized leaf (leaf_size > cluster_size) splits into runs
        for lo in range(s, s + c, cluster_size):
            clusters.append((lo, min(cluster_size, s + c - lo)))
    starts = np.asarray([c[0] for c in clusters], np.int64)

    def c_range(n):
        lo = int(np.searchsorted(starts, prim_start[n]))
        hi = int(np.searchsorted(starts, prim_start[n] + prim_count[n]))
        return lo, hi

    sc_nodes = cut(lambda n: (lambda r: r[1] - r[0] <= SUPER)(c_range(n)))
    membership = []
    for n in sc_nodes:
        lo, hi = c_range(n)
        # an SC node can still exceed SUPER clusters (oversized-leaf splits):
        # emit multiple superclusters over the run
        for mlo in range(lo, hi, SUPER):
            membership.append(list(range(mlo, min(mlo + SUPER, hi))))
    return clusters, membership


def pack_clusters(v0, e1, e2, material_id, clusters, cluster_size: int):
    """Pack triangle clusters into fixed-size row blocks.

    Returns (tri_rows [(C·cluster_size), ROWF] f32, aabbs [C, 8] f32). Row
    layout: v0(0:3) e1(3:6) e2(6:9) n = e1×e2 (9:12), col 12 = material
    id, col 13 = the triangle's index in the caller's arrays (the hit id).
    Padding rows are all-zero (zero edges → det 0 → never hit). AABB rows:
    min(3) max(3), each padded by 1e-5, col 6 = base row of the cluster's
    block, col 7 free."""
    if len(v0) >= (1 << 24):
        # cols 12-13 round-trip ids through f32 (exact only below 2^24)
        raise ValueError(
            f"mesh has {len(v0)} triangles; the cluster kernel's f32 id "
            "columns are exact only below 2^24"
        )
    c = len(clusters)
    rows = np.zeros((c * cluster_size, ROWF), np.float32)
    aabbs = np.zeros((c, 8), np.float32)
    v1 = v0 + e1
    v2 = v0 + e2
    tmin = np.minimum(np.minimum(v0, v1), v2)
    tmax = np.maximum(np.maximum(v0, v1), v2)
    n = np.cross(e1, e2)
    for i, (lo, cnt) in enumerate(clusters):
        base = i * cluster_size
        rows[base : base + cnt, 0:3] = v0[lo : lo + cnt]
        rows[base : base + cnt, 3:6] = e1[lo : lo + cnt]
        rows[base : base + cnt, 6:9] = e2[lo : lo + cnt]
        rows[base : base + cnt, 9:12] = n[lo : lo + cnt]
        if material_id is not None:
            rows[base : base + cnt, 12] = material_id[lo : lo + cnt]
        rows[base : base + cnt, 13] = np.arange(lo, lo + cnt, dtype=np.float32)
        aabbs[i, 0:3] = tmin[lo : lo + cnt].min(axis=0) - 1e-5
        aabbs[i, 3:6] = tmax[lo : lo + cnt].max(axis=0) + 1e-5
        aabbs[i, 6] = base
    return rows, aabbs


def build_visit_tables(aabbs: np.ndarray, membership):
    """Two-level, per-octant visit tables.

    ``aabbs`` [C, 8] are cluster AABB rows (col 6 = triangle-block base);
    ``membership[s]`` lists the cluster ids of supercluster s (≤ SUPER each).
    Returns (sc_rows [(8·S), 8], cl_rows [(8·S·SUPER), 8], S):

    - ``sc_rows[o·S + s]``: AABB of the s-th supercluster in octant o's
      front-to-back order;
    - ``cl_rows[o·S·SUPER + s·SUPER + k]``: AABB row of the k-th member
      cluster (front-to-back within its supercluster).

    Padding slots (S rounds up to a BATCH multiple; superclusters of fewer
    than SUPER clusters) are degenerate point boxes at (+FAR,+FAR,+FAR),
    which every slab test rejects."""
    s_count = ((len(membership) + BATCH - 1) // BATCH) * BATCH
    far = np.float32(3e30)

    sc = np.zeros((s_count, 8), np.float32)
    sc[:, 0:6] = far
    grp = np.zeros((s_count, SUPER, 8), np.float32)
    grp[:, :, 0:6] = far  # pad slots: point at (FAR,FAR,FAR), always rejected
    for s, members in enumerate(membership):
        m = aabbs[members]
        grp[s, : len(members)] = m
        sc[s, 0:3] = m[:, 0:3].min(axis=0)
        sc[s, 3:6] = m[:, 3:6].max(axis=0)
    sc_centers = 0.5 * (sc[:, 0:3] + sc[:, 3:6])

    sc_rows = np.zeros((8, s_count, 8), np.float32)
    cl_rows = np.zeros((8, s_count, SUPER, 8), np.float32)
    for o in range(8):
        d = _OCTANT_SIGNS[o]
        sc_key = sc_centers @ d
        sc_key = np.where(sc[:, 0] >= far, np.inf, sc_key)  # pads last
        sc_ord = np.argsort(sc_key, kind="stable")
        sc_rows[o] = sc[sc_ord]
        for si, s in enumerate(sc_ord):
            members = grp[s]
            key = 0.5 * (members[:, 0:3] + members[:, 3:6]) @ d
            key = np.where(members[:, 0] >= far, np.inf, key)  # pads last
            cl_rows[o, si] = members[np.argsort(key, kind="stable")]
    return (
        sc_rows.reshape(8 * s_count, 8),
        cl_rows.reshape(8 * s_count * SUPER, 8),
        s_count,
    )


@dataclasses.dataclass(frozen=True)
class MeshTables:
    """The packed tables on one device: ``tri_rows`` [C·cluster_size, 14],
    ``sc_rows`` [8·S, 8] and ``cl_rows`` [8·S·SUPER, 8] f32 (what the kernel
    reads), the cluster AABBs in packed order, ``aabbs`` [C, 8] f32 on the
    host (what the plain version loops over), and ``bounds`` [2, 3] f32 on
    the device: the triangles' bounding-box minimum and its extent clamped
    at 1e-3 (the mesh pipeline's ray sort cuts its cells from them)."""

    tri_rows: torch.Tensor
    sc_rows: torch.Tensor
    cl_rows: torch.Tensor
    aabbs: np.ndarray
    bounds: torch.Tensor
    num_super: int
    cluster_size: int

    @property
    def num_clusters(self) -> int:
        return int(self.aabbs.shape[0])

    @property
    def device(self) -> torch.device:
        return self.tri_rows.device

    @property
    def nbytes(self) -> int:
        return sum(t.numel() * 4 for t in (self.tri_rows, self.sc_rows, self.cl_rows))


# ──────────────────────────────── plain version ────────────────────────────────


def _slab(box, ox, oy, oz, inv_dx, inv_dy, inv_dz, best_t):
    """The TPU kernel's ``_slab`` (without the ``active`` gate) against one
    AABB row of host floats; torch.minimum/maximum propagate NaN as
    jnp.minimum/maximum do."""
    t0x = (box[0] - ox) * inv_dx
    t1x = (box[3] - ox) * inv_dx
    t0y = (box[1] - oy) * inv_dy
    t1y = (box[4] - oy) * inv_dy
    t0z = (box[2] - oz) * inv_dz
    t1z = (box[5] - oz) * inv_dz
    lox = torch.minimum(t0x, t1x)
    hix = torch.maximum(t0x, t1x)
    loy = torch.minimum(t0y, t1y)
    hiy = torch.maximum(t0y, t1y)
    loz = torch.minimum(t0z, t1z)
    hiz = torch.maximum(t0z, t1z)
    tmin = torch.maximum(torch.maximum(lox, loy), torch.clamp_min(loz, 0.0))
    tmax = torch.minimum(torch.minimum(hix, hiy), hiz)
    return (tmax >= tmin) & (tmin < best_t)


def _triangle_tests(r, ox, oy, oz, dx, dy, dz, bt):
    """Möller–Trumbore of rays [k, 1] against one cluster's rows r [cs, 14],
    the TPU kernel's order of operations (`mesh_kernel.py:390-412`):
    (t [k, cs], det [k, cs], ok [k, cs])."""
    v0x, v0y, v0z = r[:, 0], r[:, 1], r[:, 2]
    e1x, e1y, e1z = r[:, 3], r[:, 4], r[:, 5]
    e2x, e2y, e2z = r[:, 6], r[:, 7], r[:, 8]
    px = dy * e2z - dz * e2y
    py = dz * e2x - dx * e2z
    pz = dx * e2y - dy * e2x
    det = e1x * px + e1y * py + e1z * pz
    big = torch.abs(det) > 1e-9
    inv_det = torch.where(big, 1.0 / det, 0.0)
    tx = ox - v0x
    ty = oy - v0y
    tz = oz - v0z
    u = (tx * px + ty * py + tz * pz) * inv_det
    qx = ty * e1z - tz * e1y
    qy = tz * e1x - tx * e1z
    qz = tx * e1y - ty * e1x
    v = (dx * qx + dy * qy + dz * qz) * inv_det
    t = (e2x * qx + e2y * qy + e2z * qz) * inv_det
    ok = big & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (t > _BACKOFF) & (t < bt)
    return t, det, ok


def intersect_reference(tables: MeshTables, ox, oy, oz, dx, dy, dz, active,
                        full: bool = True, stats: Optional[dict] = None):
    """The plain version of K7 (``full``) / K8 on [N] f32 rays and ``active``
    ([N] bool or f32, active where > 0.5). Returns (t, idx, nx, ny, nz, mat)
    with ``full``, else (t,). With ``stats``, adds the work it did: cluster
    slab tests ('slab') and triangle tests ('tri'), as ints.

    Within a cluster the triangles are tested in row order with a strict
    ``t < best_t`` against the running best: the winner is the first row of
    the least distance below the ray's best on entry, which is what
    ``torch.min`` over the rows returns (the first index of the minimum)."""
    n = ox.shape[0]
    dev = ox.device
    act = active > 0.5 if active.dtype != torch.bool else active
    inv_dx, inv_dy, inv_dz = 1.0 / dx, 1.0 / dy, 1.0 / dz
    best_t = torch.full((n,), _MISS, dtype=torch.float32, device=dev)
    if full:
        best_i = torch.full((n,), -1, dtype=torch.int32, device=dev)
        bn = torch.zeros((n, 3), dtype=torch.float32, device=dev)
        bmat = torch.zeros((n,), dtype=torch.float32, device=dev)
    live = torch.nonzero(act).reshape(-1)
    lox, loy, loz = ox[live], oy[live], oz[live]
    lix, liy, liz = inv_dx[live], inv_dy[live], inv_dz[live]
    cs = tables.cluster_size
    rows = tables.tri_rows.reshape(-1, cs, ROWF)
    inf = torch.tensor(float("inf"), dtype=torch.float32, device=dev)
    slabs = tris = 0
    for c, box in enumerate(tables.aabbs.tolist()):
        useful = _slab(box, lox, loy, loz, lix, liy, liz, best_t[live])
        sel = live[useful]
        slabs += int(live.numel())
        tris += int(sel.numel()) * cs
        r = rows[c]
        for lo in range(0, int(sel.numel()), _REFERENCE_RAYS):
            rs = sel[lo : lo + _REFERENCE_RAYS]
            bt = best_t[rs][:, None]
            t, det, ok = _triangle_tests(
                r, ox[rs][:, None], oy[rs][:, None], oz[rs][:, None],
                dx[rs][:, None], dy[rs][:, None], dz[rs][:, None], bt,
            )
            tmin, j = torch.where(ok, t, inf).min(dim=1)
            hit = tmin < inf
            rh, jh = rs[hit], j[hit]
            best_t[rh] = tmin[hit]
            if full:
                win = r[jh]
                fsign = torch.where(det[hit, jh] > 0, 1.0, -1.0)
                bn[rh] = win[:, 9:12] * fsign[:, None]
                bmat[rh] = win[:, 12]
                best_i[rh] = win[:, 13].to(torch.int32)
    if stats is not None:
        stats["slab"] = stats.get("slab", 0) + slabs
        stats["tri"] = stats.get("tri", 0) + tris
    if not full:
        return (best_t,)
    bnx, bny, bnz = bn[:, 0], bn[:, 1], bn[:, 2]
    rn = 1.0 / torch.sqrt(torch.clamp_min(bnx * bnx + bny * bny + bnz * bnz, 1e-30))
    return best_t, best_i, bnx * rn, bny * rn, bnz * rn, bmat


# ──────────────────────────────── kernel ────────────────────────────────


class MeshKernel:
    """ctypes binding of ``csrc/mesh_kernel.cu`` built with ``flags``.
    ``launches`` counts every launch; ``launches_by_mode`` splits them into
    'full' (K7) and 'tmin' (K8). Both are incremented where the kernel is
    launched and nowhere else. A build with ``-DPT_MESH_COUNT`` in its
    flags (``counts``) also adds up the work of each launch (see
    :func:`kernel_work`)."""

    name = "mesh_kernel"

    def __init__(self, flags: Sequence[str] = NVCC_FLAGS):
        self.flags = tuple(flags)
        self.counts = "-DPT_MESH_COUNT" in self.flags
        self.launches = 0
        self.launches_by_mode: dict = {}
        self._lib: Optional[ctypes.CDLL] = None

    def reset_counts(self) -> None:
        self.launches = 0
        self.launches_by_mode = {}

    def _fn(self):
        if self._lib is None:
            lib = load(self.name, self.flags)
            fn = lib.pt_mesh_intersect_launch
            fn.restype = ctypes.c_int
            i, p = ctypes.c_int, ctypes.c_void_p
            fn.argtypes = [i, p, p, p, i, i, i] + [p] * 7 + [p] * 6 + [i, p, p]
            self._lib = lib
        return self._lib.pt_mesh_intersect_launch

    def __call__(self, tables: MeshTables, ox, oy, oz, dx, dy, dz, active,
                 full: bool = True, work: Optional[torch.Tensor] = None,
                 walk: str = "warp") -> Tuple[torch.Tensor, ...]:
        """Launch K7 (``full``) or K8 over the [N] rays in ``walk`` (one of
        :data:`WALKS`; the results are the same in both); ``active`` is [N]
        f32 (active where > 0.5). Every tensor lies on the tables' CUDA
        device; rays and ``active`` are contiguous f32. A counting build
        takes ``work``, ``len(WORK)`` int64 counters it adds to; any other
        build none."""
        if walk not in WALKS:
            raise ValueError(f"walk must be one of {WALKS}, got {walk!r}")
        if (work is not None) != self.counts:
            raise ValueError("work counters go with a -DPT_MESH_COUNT build, and only there")
        device = tables.device
        if device.type != "cuda":
            raise ValueError(f"the CUDA mesh kernel needs a CUDA device, got {device}")
        if work is not None and (work.device != device or work.dtype != torch.int64
                                 or work.shape != (len(WORK),) or not work.is_contiguous()):
            raise ValueError(f"work must be a contiguous int64 [{len(WORK)}] tensor on {device}")
        n = ox.shape[0]
        for t in (ox, oy, oz, dx, dy, dz, active):
            if (t.device != device or t.dtype != torch.float32 or not t.is_contiguous()
                    or t.shape != (n,)):
                raise ValueError(
                    f"rays and active must be contiguous f32 [{n}] tensors on {device}, "
                    f"got {t.dtype} {tuple(t.shape)} on {t.device}"
                )
        fn = self._fn()
        f32 = dict(dtype=torch.float32, device=device)
        t_out = torch.empty((n,), **f32)
        outs = (t_out,)
        if full:
            outs = (t_out, torch.empty((n,), dtype=torch.int32, device=device),
                    torch.empty((n,), **f32), torch.empty((n,), **f32),
                    torch.empty((n,), **f32), torch.empty((n,), **f32))
        ptrs = [o.data_ptr() for o in outs] + [None] * (6 - len(outs))
        with torch.cuda.device(device):
            stream = torch.cuda.current_stream(device).cuda_stream
            self.launches += 1
            mode = "full" if full else "tmin"
            self.launches_by_mode[mode] = self.launches_by_mode.get(mode, 0) + 1
            err = fn(
                int(full), tables.tri_rows.data_ptr(), tables.sc_rows.data_ptr(),
                tables.cl_rows.data_ptr(), tables.num_super, tables.cluster_size, n,
                *(t.data_ptr() for t in (ox, oy, oz, dx, dy, dz, active)),
                *ptrs, int(walk == "warp"), None if work is None else work.data_ptr(), stream,
            )
        if err != 0:
            raise RuntimeError(f"mesh kernel launch failed: CUDA error {err}")
        return outs


KERNEL = MeshKernel()
# the counting build: the same kernel, adding up its own work
COUNTING = MeshKernel(NVCC_FLAGS + ("-DPT_MESH_COUNT",))


# the counting build's counters: the tests each level of the walk ran (lanes),
# then the loop iterations warps executed for them
WORK = ("sc_slab", "cl_slab", "tri", "sc_warp", "cl_warp", "tri_warp")


def kernel_work(tables: MeshTables, ox, oy, oz, dx, dy, dz, active, full: bool = True,
                walk: str = "warp") -> dict:
    """The work the kernel does on these rays, counted by its counting
    build (:data:`COUNTING`) in one launch in ``walk``: supercluster slab
    tests ('sc_slab', every supercluster of the ray's octant), cluster slab
    tests ('cl_slab', the 16 clusters of each supercluster the ray enters)
    and triangle tests ('tri', the rows of each cluster it enters), summed
    over the active rays, the same in both walks; and for each level the
    iterations that warps executed to run those tests ('sc_warp',
    'cl_warp', 'tri_warp'). A level's SIMT efficiency is its tests over 32
    × its warp iterations (:func:`simt_efficiency`)."""
    work = torch.zeros(len(WORK), dtype=torch.int64, device=tables.device)
    COUNTING(tables, ox, oy, oz, dx, dy, dz, active, full=full, work=work, walk=walk)
    return dict(zip(WORK, (int(v) for v in work.tolist())))


def simt_efficiency(work: dict) -> dict:
    """Per level ('sc', 'cl', 'tri'): the share of the lanes of the executed
    warp iterations that ran a test (1.0 when no iteration ran)."""
    eff = {}
    for level, lanes in (("sc", "sc_slab"), ("cl", "cl_slab"), ("tri", "tri")):
        warps = work[f"{level}_warp"]
        eff[level] = work[lanes] / (32 * warps) if warps else 1.0
    return eff


class ClusterMeshIntersector:
    """Triangle nearest-hit over cluster tables, built from BVH-leaf-ordered
    triangle arrays (the JAX ``ClusterMeshIntersector``). ``call_soa``
    returns (t, idx, nx, ny, nz, mat_f32) with idx -1 on a miss; ``call_t``
    the distance only (``_MISS`` on a miss); ``__call__`` (t, idx).

    The tables live on ``device``. Rays on a CUDA device launch the kernel
    (K7 / K8); rays on the CPU run :func:`intersect_reference`; the twin
    that :meth:`plain` returns runs the plain version on either device (how
    the kernel is compared with it on the card)."""

    def __init__(self, v0, e1, e2, material_id=None, cluster_size: int = CLUSTER,
                 bvh=None, device="cpu"):
        v0 = np.asarray(v0, np.float32)
        e1 = np.asarray(e1, np.float32)
        e2 = np.asarray(e2, np.float32)
        mat = np.asarray(material_id, np.float32) if material_id is not None else None
        t = v0.shape[0]
        if bvh is not None:
            # treelet partition: tight subtree AABBs at both levels. The
            # caller passes arrays already permuted into bvh.order space.
            clusters, membership = treelet_cut(bvh, cluster_size)
        else:
            # fixed consecutive runs (correct for any input order, fastest
            # when the input is spatially sorted)
            c = (t + cluster_size - 1) // cluster_size
            clusters = [
                (i * cluster_size, min(cluster_size, t - i * cluster_size))
                for i in range(c)
            ]
            membership = [list(range(i, min(i + SUPER, c))) for i in range(0, c, SUPER)]
        rows, aabbs = pack_clusters(v0, e1, e2, mat, clusters, cluster_size)
        sc_rows, cl_rows, num_super = build_visit_tables(aabbs, membership)
        v1, v2 = v0 + e1, v0 + e2
        lo = np.minimum(v0.min(axis=0), np.minimum(v1.min(axis=0), v2.min(axis=0)))
        hi = np.maximum(v0.max(axis=0), np.maximum(v1.max(axis=0), v2.max(axis=0)))
        bounds = np.stack([lo, np.maximum(hi - lo, np.float32(1e-3))])
        device = torch.device(device)
        self.tables = MeshTables(
            tri_rows=torch.as_tensor(rows, device=device),
            sc_rows=torch.as_tensor(sc_rows, device=device),
            cl_rows=torch.as_tensor(cl_rows, device=device),
            aabbs=aabbs,
            bounds=torch.as_tensor(bounds, device=device),
            num_super=num_super,
            cluster_size=cluster_size,
        )
        self.reference = False

    @property
    def num_super(self) -> int:
        return self.tables.num_super

    @property
    def num_clusters(self) -> int:
        return self.tables.num_clusters

    def plain(self) -> "ClusterMeshIntersector":
        """This intersector over the same tables, running the plain version
        on every device."""
        twin = object.__new__(ClusterMeshIntersector)
        twin.tables, twin.reference = self.tables, True
        return twin

    def _run(self, full, ox, oy, oz, dx, dy, dz, active, walk="warp"):
        if active is None:
            active = torch.ones_like(ox)
        if self.reference or ox.device.type == "cpu":
            return intersect_reference(self.tables, ox, oy, oz, dx, dy, dz, active, full)
        if ox.device.type == "cuda":
            rays = [t.to(torch.float32).contiguous() for t in (ox, oy, oz, dx, dy, dz, active)]
            return KERNEL(self.tables, *rays, full=full, walk=walk)
        raise ValueError(f"unsupported device {ox.device}")

    def call_soa(self, ox, oy, oz, dx, dy, dz, active=None, walk="warp"):
        """(t, idx, nx, ny, nz, mat_f32) [N] tensors; idx = -1 on a miss.
        ``active`` ([N] bool or f32) marks the rays to trace; the others
        are misses. ``walk`` is the kernel's (:data:`WALKS`): 'lane' for
        coherent rays that are all live, such as primary rays; the results
        are the same in both."""
        return self._run(True, ox, oy, oz, dx, dy, dz, active, walk)

    def call_t(self, ox, oy, oz, dx, dy, dz, active=None) -> torch.Tensor:
        """Nearest-hit distance only (``_MISS`` when nothing is hit), in the
        kernel's warp walk."""
        return self._run(False, ox, oy, oz, dx, dy, dz, active)[0]

    def __call__(self, origins, directions) -> Tuple[torch.Tensor, torch.Tensor]:
        t, i, _, _, _, _ = self.call_soa(
            origins[:, 0], origins[:, 1], origins[:, 2],
            directions[:, 0], directions[:, 1], directions[:, 2],
        )
        return t, i


class RayRecorder:
    """An intersector that keeps a copy of every ray set the mesh pipeline
    hands it (the six ray components and the active mask, as contiguous f32
    [N] tensors: the kernel's inputs) in ``soa`` (nearest-hit calls, with
    the walk each asked for in ``walks``) and ``tmin`` (shadow rays), and
    passes each call on to ``inner``. It is how
    the kernels are measured on the rays a render really traces."""

    def __init__(self, inner: ClusterMeshIntersector):
        self.inner, self.soa, self.walks, self.tmin = inner, [], [], []
        self.tables = inner.tables

    @staticmethod
    def _copy(rays, active):
        if active is None:
            active = torch.ones_like(rays[0])
        return [r.to(torch.float32).contiguous().clone() for r in (*rays, active)]

    def call_soa(self, *rays, active=None, walk="warp"):
        self.soa.append(self._copy(rays, active))
        self.walks.append(walk)
        return self.inner.call_soa(*rays, active=active, walk=walk)

    def call_t(self, *rays, active=None):
        self.tmin.append(self._copy(rays, active))
        return self.inner.call_t(*rays, active=active)
