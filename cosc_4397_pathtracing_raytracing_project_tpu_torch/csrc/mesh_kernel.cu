// Cluster-culled nearest-hit triangle intersection for NVIDIA Hopper
// (sm_90a): every ray walks its own octant's tables, and a warp shares out
// the work of its rays' walks among its 32 lanes.
//
// Replaces the TPU kernel built by
// cosc_4397_pathtracing_raytracing_project_tpu/ops/pallas/mesh_kernel.py:
// _make_kernel, launched by _intersect (pallas_call), in both modes:
//   pt_mesh_intersect<true>  (K7, mode="full"): the strict nearest hit's
//     distance, triangle index (-1 on a miss), ray-facing unit geometric
//     normal and material id (as f32);
//   pt_mesh_intersect<false> (K8, mode="tmin"): the nearest distance only
//     (1e30 on a miss), for the mesh pipeline's NEE shadow rays.
//
// Tables (built on the host by ops/cuda/mesh_kernel.py, the JAX package's
// treelet_cut / pack_clusters / build_visit_tables):
//   tri [C * cluster_size, 14] f32 rows: v0 (0:3), e1 (3:6), e2 (6:9),
//     n = e1 x e2 (9:12), material id (12), triangle index (13); padding
//     rows are zero (det 0: never hit);
//   sc  [8 * S, 8] f32: supercluster AABBs (min xyz, max xyz), front to back
//     for each direction octant o = (dx>0) + 2(dy>0) + 4(dz>0);
//   cl  [8 * S * 16, 8] f32: the 16 member cluster AABBs of each of those
//     superclusters, front to back, column 6 the cluster's first tri row.
// Padding slots are point boxes at (3e30, 3e30, 3e30), always rejected.
//
// The walk. The TPU kernel culls per tile of 2048 rays: it walks the tables
// in the tile's majority octant and enters a box when any lane's slab test
// passes. Here every ray walks its own octant, front to back: it slab-tests
// each supercluster and, on a pass, its 16 clusters, and runs a passing
// cluster's rows with the TPU kernel's Moller-Trumbore arithmetic in the
// same order of operations (mesh_kernel.py:390-433), every test against the
// ray's own running best_t with a strict `<`. Culling per ray changes which
// triangles are tested, never which one wins: the nearest, the first
// visited among equal distances (a tie on a shared edge may therefore pick
// another triangle than the plain version's cluster order). An inactive ray
// writes a miss (the TPU kernel tests every lane of an entered tile, so its
// inactive lanes carry their neighbours' hits).
//
// What bounds it on this card. The operations of that walk are far below
// the card's rate. With one thread per ray (the first design), a warp
// executes every cluster that any of its 32 rays enters, 64 rows each, with
// only the rays that entered it active. Measured on the H100 (chip_smoke.py
// [16], the counting build below, a 1-spp NEE render of
// scenes/mesh1080p.txt): the triangle rows ran at 75% SIMT efficiency on
// primary rays, 22% on bounce 1, 7-9% from bounce 2 on and 4-5% for shadow
// rays past bounce 0. And each launch from bounce 2 on took 1.6-1.8 ms
// whether 146,445 or 1,162 rays were live: the dead rays are sorted last,
// so the live ones filled a few dozen warps, each a long chain of dependent
// row loads, on a card with 132 SMs. The kernel therefore has two walks,
// and the caller picks one (ClusterMeshIntersector, ops/fast.py):
//   - the lane walk, for primary rays (all live, coherent): lane l of warp
//     w walks ray 32 w + l alone, the first design. Coherent rays mostly
//     enter the same clusters, so the lanes share each cluster's row loads.
//   - the warp walk, for every later bounce and every shadow ray: warp w
//     writes the misses of its inactive slots 32 w + l and serves the live
//     rays among slots w + l * W (W warps in the grid) one at a time with
//     all its lanes (`serve_super`): 32 superclusters slab-tested a step;
//     then for each supercluster the ray enters, 16 lanes slab-test its 16
//     clusters at once, and for each cluster that passes, in order, all 32
//     lanes test two of its rows, coalesced, and a shuffle reduction picks
//     the least t below the ray's best_t and the lowest row among equal t:
//     what the serial row loop keeps. The live rays spread over as many
//     warps as there are rays, and each one's chain is a few coalesced steps
//     a cluster instead of 64.
// A box's entry distance is the same number whenever it is tested, and
// best_t only falls, so a box that fails against the best_t of an earlier
// moment fails later too: the lane-parallel slab tests keep each box's entry
// distance and compare it with the running best_t when the walk reaches the
// box. The tests, their count, every t, the index and the tie rule are
// therefore those of the one-thread walk (tests/test_torch_cuda.py
// octant_walk): only the lanes that run them differ. Every table is a
// device tensor read with read-only loads: the rows of scenes/mesh1080p.txt
// are ~1000 clusters x 64 x 56 B = 3.6 MB, resident in the 50 MB L2.
//
// Floating point: exact IEEE division (1.0f/d, 1.0f/det), 1/sqrtf for the
// TPU kernel's rsqrt, and the library is built with -fmad=false so each
// expression rounds after every operation, as the plain PyTorch version
// does. min/max in the slab test propagate NaN as jnp.minimum/maximum do
// (an axis-parallel ray whose origin lies on a box plane gives
// (b - o) * inf = NaN, and the box is then culled); CUDA's fminf/fmaxf
// would drop the NaN.
//
// Work counters. A build with -DPT_MESH_COUNT adds up, per launch, the
// supercluster slab tests, cluster slab tests and triangle tests that the
// walk ran into work[0..2] (how its operations bound is counted), and the
// warp iterations that ran them into work[3..5] (tests over 32 x warp
// iterations is each level's SIMT efficiency); its results are the same as
// the production build's, which takes no counters.

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>

#define PT_SUPER 16
#define PT_ROWF 14
#define PT_MISS 1e30f
#define PT_BACKOFF 1e-4f
#define PT_MESH_THREADS 128
#define PT_WARP 0xffffffffu

// the kernel's launch bounds; a build with -DPT_MESH_BOUNDS= (empty) leaves
// them out, so that ptxas may take more registers (how the spill's cost is
// measured: scripts/torch_measure.py)
#ifndef PT_MESH_BOUNDS
#define PT_MESH_BOUNDS __launch_bounds__(PT_MESH_THREADS)
#endif

#ifdef PT_MESH_COUNT
#define PT_MESH_COUNTS true
#else
#define PT_MESH_COUNTS false
#endif

// Counting build: at each loop iteration a warp executes at `level` (0
// supercluster slab, 1 cluster slab, 2 triangle row), the lowest active lane
// adds the active lanes to cnt.lanes[level] and 1 to cnt.warps[level].
#define PT_COUNT(level)                                         \
  do {                                                          \
    if (PT_MESH_COUNTS) {                                       \
      const unsigned m_ = __activemask();                       \
      if ((int)(threadIdx.x & 31) == __ffs(m_) - 1) {           \
        cnt.lanes[level] += __popc(m_);                         \
        ++cnt.warps[level];                                     \
      }                                                         \
    }                                                           \
  } while (0)

namespace {

struct Ray {
  float ox, oy, oz, dx, dy, dz, ix, iy, iz;  // origin, direction, 1 / direction
  int octant;
};

// the nearest hit so far (the normal as stored, unnormalized)
struct Hit {
  float t;
  int i;
  float nx, ny, nz, mat;
};

struct Counts {
  unsigned int lanes[3], warps[3];
};

struct Out {
  float* t;
  int* i;
  float *nx, *ny, *nz, *mat;
};

__device__ __forceinline__ Hit miss() {
  Hit h;
  h.t = PT_MISS;
  h.i = -1;
  h.nx = h.ny = h.nz = h.mat = 0.0f;
  return h;
}

// a ray from its origin and direction: the inverse direction and the octant
__device__ __forceinline__ Ray make_ray(float ox, float oy, float oz, float dx, float dy,
                                        float dz) {
  Ray r;
  r.ox = ox;
  r.oy = oy;
  r.oz = oz;
  r.dx = dx;
  r.dy = dy;
  r.dz = dz;
  r.ix = 1.0f / dx;
  r.iy = 1.0f / dy;
  r.iz = 1.0f / dz;
  r.octant = (dx > 0.0f ? 1 : 0) + (dy > 0.0f ? 2 : 0) + (dz > 0.0f ? 4 : 0);
  return r;
}

template <bool FULL>
__device__ __forceinline__ void store(long long p, const Hit& h, const Out& o) {
  o.t[p] = h.t;
  if (FULL) {
    const float rn = 1.0f / sqrtf(fmaxf(h.nx * h.nx + h.ny * h.ny + h.nz * h.nz, 1e-30f));
    o.i[p] = h.i;
    o.nx[p] = h.nx * rn;
    o.ny[p] = h.ny * rn;
    o.nz[p] = h.nz * rn;
    o.mat[p] = h.mat;
  }
}

__device__ __forceinline__ float nan_min(float a, float b) {
  return (a != a || b != b) ? __int_as_float(0x7fc00000) : fminf(a, b);
}

__device__ __forceinline__ float nan_max(float a, float b) {
  return (a != a || b != b) ? __int_as_float(0x7fc00000) : fmaxf(a, b);
}

// _slab of the TPU kernel (mesh_kernel.py:291-306) for one AABB row: whether
// the ray's line meets the box, and its entry distance `tmin`. The ray
// enters the box iff both hold and tmin < best_t.
__device__ __forceinline__ bool slab(const float* __restrict__ box, const Ray& r,
                                     float& tmin) {
  const float4 lo = __ldg(reinterpret_cast<const float4*>(box));
  const float4 hi = __ldg(reinterpret_cast<const float4*>(box) + 1);
  // lo = (min x, min y, min z, max x), hi = (max y, max z, base row, free)
  const float t0x = (lo.x - r.ox) * r.ix;
  const float t1x = (lo.w - r.ox) * r.ix;
  const float t0y = (lo.y - r.oy) * r.iy;
  const float t1y = (hi.x - r.oy) * r.iy;
  const float t0z = (lo.z - r.oz) * r.iz;
  const float t1z = (hi.y - r.oz) * r.iz;
  const float lox = nan_min(t0x, t1x);
  const float hix = nan_max(t0x, t1x);
  const float loy = nan_min(t0y, t1y);
  const float hiy = nan_max(t0y, t1y);
  const float loz = nan_min(t0z, t1z);
  const float hiz = nan_max(t0z, t1z);
  tmin = nan_max(nan_max(lox, loy), nan_max(loz, 0.0f));
  const float tmax = nan_min(nan_min(hix, hiy), hiz);
  return tmax >= tmin;
}

// Moller-Trumbore of one packed row, the TPU kernel's order of operations:
// whether the ray hits it strictly nearer than best_t (and past the
// back-off), with the distance t and the determinant det.
__device__ __forceinline__ bool triangle(const float* __restrict__ row_, const Ray& r,
                                         float best_t, float& t, float& det) {
  const float2* row = reinterpret_cast<const float2*>(row_);
  const float2 r0 = __ldg(row + 0), r1 = __ldg(row + 1), r2 = __ldg(row + 2);
  const float2 r3 = __ldg(row + 3), r4 = __ldg(row + 4);
  const float v0x = r0.x, v0y = r0.y, v0z = r1.x;
  const float e1x = r1.y, e1y = r2.x, e1z = r2.y;
  const float e2x = r3.x, e2y = r3.y, e2z = r4.x;
  const float px = r.dy * e2z - r.dz * e2y;
  const float py = r.dz * e2x - r.dx * e2z;
  const float pz = r.dx * e2y - r.dy * e2x;
  det = e1x * px + e1y * py + e1z * pz;
  const bool big = fabsf(det) > 1e-9f;
  const float inv_det = big ? 1.0f / det : 0.0f;
  const float tx = r.ox - v0x;
  const float ty = r.oy - v0y;
  const float tz = r.oz - v0z;
  const float u = (tx * px + ty * py + tz * pz) * inv_det;
  const float qx = ty * e1z - tz * e1y;
  const float qy = tz * e1x - tx * e1z;
  const float qz = tx * e1y - ty * e1x;
  const float v = (r.dx * qx + r.dy * qy + r.dz * qz) * inv_det;
  t = (e2x * qx + e2y * qy + e2z * qz) * inv_det;
  return big && u >= 0.0f && v >= 0.0f && u + v <= 1.0f && t > PT_BACKOFF && t < best_t;
}

// The hit's outputs from its row: stored n = e1 x e2 faces the ray when
// det < 0 (d.n = -det), so it is flipped for det > 0.
__device__ __forceinline__ void record(const float* __restrict__ row_, float det, Hit& h) {
  const float2* row = reinterpret_cast<const float2*>(row_);
  const float2 r4 = __ldg(row + 4), r5 = __ldg(row + 5), r6 = __ldg(row + 6);
  const float fsign = det > 0.0f ? 1.0f : -1.0f;
  h.nx = r4.y * fsign;
  h.ny = r5.x * fsign;
  h.nz = r5.y * fsign;
  h.mat = r6.x;
  h.i = (int)r6.y;
}

// The whole warp serves ray q (lane `src`'s; every lane holds q and its
// running best `bt`) in the supercluster whose 16 cluster rows start at
// `clr`: lanes 0-15 slab-test the clusters, then each cluster that passes,
// in order, gets all 32 lanes on its rows and a reduction to the least
// (t, row). Lowers bt on every lane; in K7, lane src records the hit in h.
template <bool FULL>
__device__ __forceinline__ void serve_super(const float* __restrict__ tri,
                                            const float* __restrict__ clr, int cluster_size,
                                            const Ray& q, float& bt, int lane, int src, Hit& h,
                                            Counts& cnt) {
  float ctmin = 0.0f;
  bool cpass = false;
  int cbase = 0;
  if (lane < PT_SUPER) {
    PT_COUNT(1);
    cpass = slab(clr + lane * 8, q, ctmin) && ctmin < bt;
    cbase = (int)__ldg(clr + lane * 8 + 6);
  }
  unsigned c = __ballot_sync(PT_WARP, cpass);
  while (c) {
    const int k = __ffs(c) - 1;
    c &= c - 1;
    const float tk = __shfl_sync(PT_WARP, ctmin, k);
    const float* rows = tri + (size_t)__shfl_sync(PT_WARP, cbase, k) * PT_ROWF;
    // the walk's test of cluster k: its entry distance against best_t now
    if (!(tk < bt)) continue;
    // each lane: the first least t below bt among its rows
    float lt = bt, ldet = 0.0f;
    int lj = INT_MAX;
    for (int j0 = 0; j0 < cluster_size; j0 += 32) {
      const int j = j0 + lane;
      if (j < cluster_size) {
        PT_COUNT(2);
        float t, det;
        if (triangle(rows + (size_t)j * PT_ROWF, q, bt, t, det) && t < lt) {
          lt = t;
          lj = j;
          ldet = det;
        }
      }
    }
    // the warp's least (t, row): the row the serial loop keeps
    float wt = lt;
    int wj = lj;
    for (int off = 16; off > 0; off >>= 1) {
      const float ot = __shfl_xor_sync(PT_WARP, wt, off);
      const int oj = __shfl_xor_sync(PT_WARP, wj, off);
      if (ot < wt || (ot == wt && oj < wj)) {
        wt = ot;
        wj = oj;
      }
    }
    if (wj == INT_MAX) continue;
    bt = wt;
    if (FULL) {
      // lane wj % 32 holds row wj: its own first least
      const float wdet = __shfl_sync(PT_WARP, ldet, wj & 31);
      if (lane == src) record(rows + (size_t)wj * PT_ROWF, wdet, h);
    }
  }
}

// The lane walk: lane l of warp w walks ray 32 w + l alone. The lanes step
// through the superclusters together, so those whose rays enter the same
// cluster run its rows side by side and share its row loads.
template <bool FULL>
__device__ __forceinline__ void lane_walk(const float* __restrict__ tri,
                                          const float* __restrict__ sc,
                                          const float* __restrict__ cl, int num_super,
                                          int cluster_size, int n, const float* __restrict__ ox,
                                          const float* __restrict__ oy,
                                          const float* __restrict__ oz,
                                          const float* __restrict__ dx,
                                          const float* __restrict__ dy,
                                          const float* __restrict__ dz,
                                          const float* __restrict__ act, const Out& out,
                                          int warp, int lane, Counts& cnt) {
  const long long p = (long long)warp * 32 + lane;
  const bool active = p < n && act[p] > 0.5f;
  Hit h = miss();
  // a warp without an active ray skips the walk; every lane of one with
  // takes part in each supercluster's vote, an inactive one too
  if (__ballot_sync(PT_WARP, active)) {
    const Ray r = active ? make_ray(ox[p], oy[p], oz[p], dx[p], dy[p], dz[p])
                         : make_ray(0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f);
    const float* scb = sc + (size_t)r.octant * num_super * 8;
    const float* clb = cl + (size_t)r.octant * num_super * PT_SUPER * 8;
    for (int s = 0; s < num_super; ++s) {
      bool enter = false;
      if (active) {
        PT_COUNT(0);
        float tmin;
        enter = slab(scb + (size_t)s * 8, r, tmin) && tmin < h.t;
      }
      if (!__ballot_sync(PT_WARP, enter) || !enter) continue;
      const float* clr = clb + (size_t)s * PT_SUPER * 8;
      for (int k = 0; k < PT_SUPER; ++k) {
        PT_COUNT(1);
        float tmin;
        if (!(slab(clr + k * 8, r, tmin) && tmin < h.t)) continue;
        const float* rows = tri + (size_t)(int)__ldg(clr + k * 8 + 6) * PT_ROWF;
        for (int j = 0; j < cluster_size; ++j) {
          PT_COUNT(2);
          float t, det;
          if (triangle(rows + (size_t)j * PT_ROWF, r, h.t, t, det)) {
            h.t = t;
            if (FULL) record(rows + (size_t)j * PT_ROWF, det, h);
          }
        }
      }
    }
  }
  if (p < n) store<FULL>(p, h, out);
}

// The warp walk: warp w writes the misses of its inactive rays 32 w + l, and
// serves the live rays among slots w + l * warps, one at a time. Each lane
// keeps only its own ray's origin and direction; the served ray's inverse
// direction and octant are computed after the shuffle, the same numbers.
template <bool FULL>
__device__ __forceinline__ void warp_walk(const float* __restrict__ tri,
                                          const float* __restrict__ sc,
                                          const float* __restrict__ cl, int num_super,
                                          int cluster_size, int n, const float* __restrict__ ox,
                                          const float* __restrict__ oy,
                                          const float* __restrict__ oz,
                                          const float* __restrict__ dx,
                                          const float* __restrict__ dy,
                                          const float* __restrict__ dz,
                                          const float* __restrict__ act, const Out& out,
                                          int warp, int warps, int lane, Counts& cnt) {
  const long long p = (long long)warp * 32 + lane;
  if (p < n && !(act[p] > 0.5f)) store<FULL>(p, miss(), out);
  const long long ps = warp + (long long)lane * warps;
  const bool live = ps < n && act[ps] > 0.5f;
  float o[6] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  if (live) {
    o[0] = ox[ps];
    o[1] = oy[ps];
    o[2] = oz[ps];
    o[3] = dx[ps];
    o[4] = dy[ps];
    o[5] = dz[ps];
  }
  unsigned e = __ballot_sync(PT_WARP, live);
  while (e) {
    const int src = __ffs(e) - 1;
    e &= e - 1;
    const Ray q = make_ray(__shfl_sync(PT_WARP, o[0], src), __shfl_sync(PT_WARP, o[1], src),
                           __shfl_sync(PT_WARP, o[2], src), __shfl_sync(PT_WARP, o[3], src),
                           __shfl_sync(PT_WARP, o[4], src), __shfl_sync(PT_WARP, o[5], src));
    const float* scb = sc + (size_t)q.octant * num_super * 8;
    const float* clb = cl + (size_t)q.octant * num_super * PT_SUPER * 8;
    Hit h = miss();  // lane src's
    float bt = PT_MISS;
    for (int s0 = 0; s0 < num_super; s0 += 32) {
      const int s = s0 + lane;
      float stmin = 0.0f;
      bool spass = false;
      if (s < num_super) {
        PT_COUNT(0);
        spass = slab(scb + (size_t)s * 8, q, stmin) && stmin < bt;
      }
      unsigned m = __ballot_sync(PT_WARP, spass);
      while (m) {
        const int k = __ffs(m) - 1;
        m &= m - 1;
        // the walk's test of supercluster s0 + k against best_t now
        if (!(__shfl_sync(PT_WARP, stmin, k) < bt)) continue;
        serve_super<FULL>(tri, clb + (size_t)(s0 + k) * PT_SUPER * 8, cluster_size, q, bt,
                          lane, src, h, cnt);
      }
    }
    if (lane == src) {
      h.t = bt;
      store<FULL>(ps, h, out);
    }
  }
}

// every warp is whole (blocks of 128): its lanes past n are inactive rays
template <bool FULL>
__global__ void PT_MESH_BOUNDS
pt_mesh_intersect(const float* __restrict__ tri, const float* __restrict__ sc,
                  const float* __restrict__ cl, int num_super, int cluster_size, int n,
                  const float* __restrict__ ox, const float* __restrict__ oy,
                  const float* __restrict__ oz, const float* __restrict__ dx,
                  const float* __restrict__ dy, const float* __restrict__ dz,
                  const float* __restrict__ act, Out out, int warp_walk_,
                  unsigned long long* __restrict__ work) {
  const int lane = threadIdx.x & 31;
  const int warp = (int)((blockIdx.x * blockDim.x + threadIdx.x) >> 5);
  const int warps = (int)(gridDim.x * (blockDim.x >> 5));
  Counts cnt = {{0, 0, 0}, {0, 0, 0}};
  if (warp_walk_) {
    warp_walk<FULL>(tri, sc, cl, num_super, cluster_size, n, ox, oy, oz, dx, dy, dz, act, out,
                    warp, warps, lane, cnt);
  } else {
    lane_walk<FULL>(tri, sc, cl, num_super, cluster_size, n, ox, oy, oz, dx, dy, dz, act, out,
                    warp, lane, cnt);
  }
  if (PT_MESH_COUNTS) {
    for (int l = 0; l < 3; ++l) {
      if (cnt.lanes[l]) atomicAdd(work + l, (unsigned long long)cnt.lanes[l]);
      if (cnt.warps[l]) atomicAdd(work + 3 + l, (unsigned long long)cnt.warps[l]);
    }
  }
}

}  // namespace

// Launch K7 (full != 0) or K8 on `stream` over n rays, in the warp walk
// (warp_walk != 0) or the lane walk. The outputs are [n] device buffers the
// caller allocated (i_out, nx_out, ny_out, nz_out and m_out only for K7).
// `work` is six zeroed device counters in a PT_MESH_COUNT build and null
// otherwise. Returns the launch's CUDA error code (0 = launched).
extern "C" int pt_mesh_intersect_launch(
    int full, const float* tri, const float* sc, const float* cl, int num_super,
    int cluster_size, int n, const float* ox, const float* oy, const float* oz,
    const float* dx, const float* dy, const float* dz, const float* act, float* t_out,
    int* i_out, float* nx_out, float* ny_out, float* nz_out, float* m_out, int warp_walk,
    unsigned long long* work, void* stream) {
  if (n < 0 || num_super < 0 || cluster_size <= 0 || !tri || !sc || !cl ||
      (work != nullptr) != PT_MESH_COUNTS ||
      (n > 0 && (!ox || !oy || !oz || !dx || !dy || !dz || !act || !t_out)) ||
      (full && n > 0 && (!i_out || !nx_out || !ny_out || !nz_out || !m_out))) {
    return (int)cudaErrorInvalidValue;
  }
  if (n == 0) return 0;
  const dim3 grid((unsigned)((n + PT_MESH_THREADS - 1) / PT_MESH_THREADS));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Out out = {t_out, i_out, nx_out, ny_out, nz_out, m_out};
  if (full) {
    pt_mesh_intersect<true><<<grid, PT_MESH_THREADS, 0, s>>>(
        tri, sc, cl, num_super, cluster_size, n, ox, oy, oz, dx, dy, dz, act, out, warp_walk,
        work);
  } else {
    pt_mesh_intersect<false><<<grid, PT_MESH_THREADS, 0, s>>>(
        tri, sc, cl, num_super, cluster_size, n, ox, oy, oz, dx, dy, dz, act, out, warp_walk,
        work);
  }
  return (int)cudaGetLastError();
}
