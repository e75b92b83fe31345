// Cluster-culled nearest-hit triangle intersection for NVIDIA Hopper
// (sm_90a), one thread per ray.
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
// Design. The TPU kernel culls per tile of 2048 rays: it walks the tables
// in the tile's majority octant and enters a box when any lane's slab test
// passes, batching 8 boxes per scalar branch (its vector-to-scalar drains
// cost ~450 cycles). Here each thread walks its own ray's octant, front to
// back, slab-tests each supercluster and, on a pass, its 16 clusters against
// its own running best_t, and runs a passing cluster's rows with the TPU
// kernel's Moller-Trumbore arithmetic in the same order of operations
// (mesh_kernel.py:390-433). Culling per ray changes which triangles are
// tested, never which one wins: the strict `t < best_t` keeps the nearest,
// the first visited among equal distances (a tie on a shared edge may
// therefore pick another triangle than the plain version's cluster order).
// An inactive ray writes a miss (the TPU kernel tests every lane of an
// entered tile, so its inactive lanes carry their neighbours' hits).
//
// What bounds it on this card: the triangle tests (about 50 float
// operations each) of the clusters a ray enters, and warp divergence when
// the 32 rays of a warp enter different clusters (the mesh pipeline sorts
// its wavefront by origin cell and octant to keep warps coherent). Every
// table is a device tensor read with plain read-only loads: the rows of
// scenes/mesh1080p.txt are ~1000 clusters x 64 x 56 B = 3.6 MB, resident in
// the 50 MB L2. Memory traffic beyond that is 28 B of ray in and 24 B (K7)
// or 4 B (K8) out per ray. A BVH walk, a treelet stack, wgmma or TMA are
// left to later work.
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
// kernel ran into work[0..2] (how its operations bound is counted); the
// results are the same as the production build's, which takes no counters.

#include <cuda_runtime.h>
#include <math.h>

#define PT_SUPER 16
#define PT_ROWF 14
#define PT_MISS 1e30f
#define PT_BACKOFF 1e-4f
#define PT_MESH_THREADS 128

#ifdef PT_MESH_COUNT
#define PT_MESH_COUNTS true
#else
#define PT_MESH_COUNTS false
#endif

namespace {

__device__ __forceinline__ float nan_min(float a, float b) {
  return (a != a || b != b) ? __int_as_float(0x7fc00000) : fminf(a, b);
}

__device__ __forceinline__ float nan_max(float a, float b) {
  return (a != a || b != b) ? __int_as_float(0x7fc00000) : fmaxf(a, b);
}

// _slab of the TPU kernel (mesh_kernel.py:291-306) for one AABB row.
__device__ __forceinline__ bool slab(const float* __restrict__ box, float ox, float oy,
                                     float oz, float ix, float iy, float iz,
                                     float best_t) {
  const float4 lo = __ldg(reinterpret_cast<const float4*>(box));
  const float4 hi = __ldg(reinterpret_cast<const float4*>(box) + 1);
  // lo = (min x, min y, min z, max x), hi = (max y, max z, base row, free)
  const float t0x = (lo.x - ox) * ix;
  const float t1x = (lo.w - ox) * ix;
  const float t0y = (lo.y - oy) * iy;
  const float t1y = (hi.x - oy) * iy;
  const float t0z = (lo.z - oz) * iz;
  const float t1z = (hi.y - oz) * iz;
  const float lox = nan_min(t0x, t1x);
  const float hix = nan_max(t0x, t1x);
  const float loy = nan_min(t0y, t1y);
  const float hiy = nan_max(t0y, t1y);
  const float loz = nan_min(t0z, t1z);
  const float hiz = nan_max(t0z, t1z);
  const float tmin = nan_max(nan_max(lox, loy), nan_max(loz, 0.0f));
  const float tmax = nan_min(nan_min(hix, hiy), hiz);
  return (tmax >= tmin) && (tmin < best_t);
}

template <bool FULL>
__global__ void __launch_bounds__(PT_MESH_THREADS)
pt_mesh_intersect(const float* __restrict__ tri, const float* __restrict__ sc,
                  const float* __restrict__ cl, int num_super, int cluster_size, int n,
                  const float* __restrict__ ox_, const float* __restrict__ oy_,
                  const float* __restrict__ oz_, const float* __restrict__ dx_,
                  const float* __restrict__ dy_, const float* __restrict__ dz_,
                  const float* __restrict__ act_, float* __restrict__ t_out,
                  int* __restrict__ i_out, float* __restrict__ nx_out,
                  float* __restrict__ ny_out, float* __restrict__ nz_out,
                  float* __restrict__ m_out, unsigned long long* __restrict__ work) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= n) return;
  unsigned int n_sc = 0, n_cl = 0, n_tri = 0;  // work counters (PT_MESH_COUNT)
  float best_t = PT_MISS;
  int best_i = -1;
  float bnx = 0.0f, bny = 0.0f, bnz = 0.0f, bmat = 0.0f;
  if (act_[p] > 0.5f) {
    const float ox = ox_[p], oy = oy_[p], oz = oz_[p];
    const float dx = dx_[p], dy = dy_[p], dz = dz_[p];
    const float ix = 1.0f / dx;
    const float iy = 1.0f / dy;
    const float iz = 1.0f / dz;
    const int octant = (dx > 0.0f ? 1 : 0) + (dy > 0.0f ? 2 : 0) + (dz > 0.0f ? 4 : 0);
    const float* scb = sc + (size_t)octant * num_super * 8;
    const float* clb = cl + (size_t)octant * num_super * PT_SUPER * 8;
    for (int s = 0; s < num_super; ++s) {
      if (PT_MESH_COUNTS) ++n_sc;
      if (!slab(scb + (size_t)s * 8, ox, oy, oz, ix, iy, iz, best_t)) continue;
      for (int k = 0; k < PT_SUPER; ++k) {
        const float* box = clb + ((size_t)s * PT_SUPER + k) * 8;
        if (PT_MESH_COUNTS) ++n_cl;
        if (!slab(box, ox, oy, oz, ix, iy, iz, best_t)) continue;
        if (PT_MESH_COUNTS) n_tri += cluster_size;
        const int base = (int)__ldg(box + 6);
        for (int j = 0; j < cluster_size; ++j) {
          const float2* row =
              reinterpret_cast<const float2*>(tri + (size_t)(base + j) * PT_ROWF);
          const float2 r0 = __ldg(row + 0), r1 = __ldg(row + 1), r2 = __ldg(row + 2);
          const float2 r3 = __ldg(row + 3), r4 = __ldg(row + 4);
          const float v0x = r0.x, v0y = r0.y, v0z = r1.x;
          const float e1x = r1.y, e1y = r2.x, e1z = r2.y;
          const float e2x = r3.x, e2y = r3.y, e2z = r4.x;
          // Moller-Trumbore, the TPU kernel's order of operations
          const float px = dy * e2z - dz * e2y;
          const float py = dz * e2x - dx * e2z;
          const float pz = dx * e2y - dy * e2x;
          const float det = e1x * px + e1y * py + e1z * pz;
          const bool big = fabsf(det) > 1e-9f;
          const float inv_det = big ? 1.0f / det : 0.0f;
          const float tx = ox - v0x;
          const float ty = oy - v0y;
          const float tz = oz - v0z;
          const float u = (tx * px + ty * py + tz * pz) * inv_det;
          const float qx = ty * e1z - tz * e1y;
          const float qy = tz * e1x - tx * e1z;
          const float qz = tx * e1y - ty * e1x;
          const float v = (dx * qx + dy * qy + dz * qz) * inv_det;
          const float t = (e2x * qx + e2y * qy + e2z * qz) * inv_det;
          if (big && u >= 0.0f && v >= 0.0f && u + v <= 1.0f && t > PT_BACKOFF &&
              t < best_t) {
            best_t = t;
            if (FULL) {
              // stored n = e1 x e2 faces the ray when det < 0 (d.n = -det)
              const float2 r5 = __ldg(row + 5), r6 = __ldg(row + 6);
              const float fsign = det > 0.0f ? 1.0f : -1.0f;
              bnx = r4.y * fsign;
              bny = r5.x * fsign;
              bnz = r5.y * fsign;
              bmat = r6.x;
              best_i = (int)r6.y;
            }
          }
        }
      }
    }
  }
  t_out[p] = best_t;
  if (FULL) {
    const float rn = 1.0f / sqrtf(fmaxf(bnx * bnx + bny * bny + bnz * bnz, 1e-30f));
    i_out[p] = best_i;
    nx_out[p] = bnx * rn;
    ny_out[p] = bny * rn;
    nz_out[p] = bnz * rn;
    m_out[p] = bmat;
  }
  if (PT_MESH_COUNTS) {
    atomicAdd(work + 0, (unsigned long long)n_sc);
    atomicAdd(work + 1, (unsigned long long)n_cl);
    atomicAdd(work + 2, (unsigned long long)n_tri);
  }
}

}  // namespace

// Launch K7 (full != 0) or K8 on `stream` over n rays. The outputs are [n]
// device buffers the caller allocated (i_out, nx_out, ny_out, nz_out and
// m_out only for K7). `work` is three zeroed device counters in a
// PT_MESH_COUNT build and null otherwise. Returns the launch's CUDA error
// code (0 = launched).
extern "C" int pt_mesh_intersect_launch(
    int full, const float* tri, const float* sc, const float* cl, int num_super,
    int cluster_size, int n, const float* ox, const float* oy, const float* oz,
    const float* dx, const float* dy, const float* dz, const float* act, float* t_out,
    int* i_out, float* nx_out, float* ny_out, float* nz_out, float* m_out,
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
  if (full) {
    pt_mesh_intersect<true><<<grid, PT_MESH_THREADS, 0, s>>>(
        tri, sc, cl, num_super, cluster_size, n, ox, oy, oz, dx, dy, dz, act, t_out, i_out,
        nx_out, ny_out, nz_out, m_out, work);
  } else {
    pt_mesh_intersect<false><<<grid, PT_MESH_THREADS, 0, s>>>(
        tri, sc, cl, num_super, cluster_size, n, ox, oy, oz, dx, dy, dz, act, t_out, nullptr,
        nullptr, nullptr, nullptr, nullptr, work);
  }
  return (int)cudaGetLastError();
}
