// CPU stand-in for the parts of the CUDA runtime that csrc/megakernel.cu
// uses, so that g++ can build it (scripts/cpu_rehearsal.py): every block of
// a launch runs in turn, one std::thread per thread of the block, and a
// std::barrier per warp carries the warp intrinsics (ballot, any, shuffle,
// or-reduce, syncwarp). __shared__ arrays become static, which is right
// only because blocks run one at a time; the occupancy query reports one
// block on one SM, so the persistent grid is a single block of 4 warps.
#pragma once
#include <algorithm>
#include <atomic>
#include <barrier>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>
using std::max;
using std::min;

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __restrict__
#define __grid_constant__
#define __launch_bounds__(a, b)
#define __shared__ static

struct dim3 { unsigned x = 0, y = 0, z = 0; };
struct alignas(16) float4 { float x, y, z, w; };
inline thread_local dim3 threadIdx, blockIdx, blockDim;

typedef int cudaError_t;
typedef void* cudaStream_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
enum { cudaDevAttrMultiProcessorCount = 16 };
enum { cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };

struct ShimWarp {
  std::barrier<> bar{32};
  unsigned long long v[32];
};
inline ShimWarp* shim_warps = nullptr;
inline std::barrier<>* shim_block = nullptr;
inline std::vector<float> shim_dyn;

static inline ShimWarp& shim_w() { return shim_warps[threadIdx.x >> 5]; }
static inline unsigned long long shim_exchange_all(unsigned long long mine, int src, int op) {
  ShimWarp& w = shim_w();
  const int l = threadIdx.x & 31;
  w.v[l] = mine;
  w.bar.arrive_and_wait();
  unsigned long long r = 0;
  if (op == 0) {  // ballot
    for (int i = 0; i < 32; ++i) if (w.v[i]) r |= 1ull << i;
  } else if (op == 1) {  // shfl
    r = w.v[src];
  } else {  // or
    for (int i = 0; i < 32; ++i) r |= w.v[i];
  }
  w.bar.arrive_and_wait();
  return r;
}
static inline unsigned __ballot_sync(unsigned, int pred) {
  return (unsigned)shim_exchange_all(pred ? 1 : 0, 0, 0);
}
static inline int __any_sync(unsigned m, int pred) { return __ballot_sync(m, pred) != 0u; }
static inline int __shfl_sync(unsigned, int v, int src) {
  return (int)(unsigned)shim_exchange_all((unsigned)v, src, 1);
}
static inline float __shfl_sync(unsigned, float v, int src) {
  unsigned u;
  memcpy(&u, &v, 4);
  u = (unsigned)shim_exchange_all(u, src, 1);
  float f;
  memcpy(&f, &u, 4);
  return f;
}
static inline unsigned __reduce_or_sync(unsigned, unsigned v) {
  return (unsigned)shim_exchange_all(v, 0, 2);
}
static inline void __syncwarp(unsigned = 0xffffffffu) { shim_w().bar.arrive_and_wait(); }
static inline void __syncthreads() { shim_block->arrive_and_wait(); }
static inline int __popc(unsigned x) { return __builtin_popcount(x); }
static inline int __ffs(unsigned x) { return __builtin_ffs((int)x); }
static inline int __ffsll(long long x) { return __builtin_ffsll(x); }
static inline unsigned __brev(unsigned x) {
  unsigned r = 0;
  for (int i = 0; i < 32; ++i) r |= ((x >> i) & 1u) << (31 - i);
  return r;
}
template <typename T> static inline T __ldg(const T* p) { return *p; }
static inline unsigned atomicAdd(unsigned* p, unsigned v) { return __atomic_fetch_add(p, v, __ATOMIC_SEQ_CST); }
static inline unsigned long long atomicAdd(unsigned long long* p, unsigned long long v) {
  return __atomic_fetch_add(p, v, __ATOMIC_SEQ_CST);
}

static inline cudaError_t cudaGetDevice(int* d) { *d = 0; return 0; }
static inline cudaError_t cudaDeviceGetAttribute(int* v, int, int) { *v = 1; return 0; }
template <typename K> static inline cudaError_t cudaFuncSetAttribute(K, int, int) { return 0; }
template <typename K>
static inline cudaError_t cudaOccupancyMaxActiveBlocksPerMultiprocessor(int* n, K, int, int) {
  *n = 1;
  return 0;
}
static inline cudaError_t cudaMemsetAsync(void* p, int v, size_t n, cudaStream_t) {
  memset(p, v, n);
  return 0;
}
static inline cudaError_t cudaGetLastError() { return 0; }

template <typename K, typename... A>
static void shim_launch(K kernel, int blocks, int threads, int smem, cudaStream_t, A... args) {
  for (int b = 0; b < blocks; ++b) {
    std::vector<ShimWarp> warps(threads / 32);
    std::barrier<> block(threads);
    shim_warps = warps.data();
    shim_block = &block;
    shim_dyn.assign(smem / 4 + 1, 0.0f);
    std::vector<std::thread> ts;
    for (int t = 0; t < threads; ++t)
      ts.emplace_back([&, t, b]() {
        threadIdx.x = (unsigned)t;
        blockIdx.x = (unsigned)b;
        blockDim.x = (unsigned)threads;
        kernel(args...);
      });
    for (auto& t : ts) t.join();
  }
}
static inline float __int_as_float(int i) { float f; memcpy(&f, &i, 4); return f; }
static inline float __uint_as_float(unsigned i) { float f; memcpy(&f, &i, 4); return f; }
static inline int __float_as_int(float f) { int i; memcpy(&i, &f, 4); return i; }
