// Path-tracing megakernel for NVIDIA Hopper (sm_90a): persistent warps over
// a pixel queue, a lane per pixel at a time, with path regeneration.
//
// Replaces the TPU kernel built by
// cosc_4397_pathtracing_raytracing_project_tpu/ops/pallas/megakernel.py:
// _make_kernel -> kernel, as launched over the full frame by
// _render_samples_impl and over chosen tiles by _render_tiles_impl
// (pallas_call), for analytic scenes: light_only or throughput (legacy)
// gathering, the gradient sky scaled by sky_strength, Russian roulette past
// rr_start_depth, the Owen-scrambled Sobol sampler on the leading n_ld depths
// (or the counter-hash streams alone), a hoisted primary hit without
// antialiasing or lens and sub-pixel jitter with it, a thin-lens camera
// (DOF), dielectric refraction, next-event estimation (NEE) of the analytic
// emitters with the balance heuristic, and an equirectangular environment
// map (kernels K3-K5 of the TPU kernel's feature split).
//
// Compile-time variants: pt_megakernel<NEE, REFR, DOF, LEGACY, TILES, ENV,
// SAMPLES>, one instantiation per valid combination, so the main path's
// variant <false x5, 0, false> carries none of the others' registers. TILES renders K
// chosen tiles (the adaptive sampler's dispatch): pixel index p renders lane
// p % tile of grid step g = p / tile, whose pixel coordinates come from
// px/py, hash tile key and 1-based iteration base from the device table
// tiles[g] and tiles[K + g]. ENV is the environment:
//   0 none: the gradient sky scaled by sky_strength;
//   1 exact (K3, env_lookup/accumulate of the TPU kernel): a path's escape
//     records its throughput and direction, and one bilinear lookup of the
//     strength-folded map settles each sample. The TPU kernel holds the map
//     in VMEM and gathers with a one-hot matmul, which caps it at 256x512
//     texels; here it stays in device memory at any size whose floats take
//     32-bit offsets (h*w*4 < 2^31). Texel (y, x) is one float4 (r, g, b,
//     pdf), so a lookup is four 16-byte loads over two map rows, and env
//     NEE's pdf texel (the nearest, one of the four) comes with them. Past
//     the 50 MB L2 (a 2k x 4k map takes 134 MB) the incoherent escapes of
//     later bounces read device memory; the other resident warps hide the
//     latency. Plain global loads, no texture unit (its filtering's bilinear
//     weights have 8 fractional bits); PERF.md has the layouts measured
//     against this one;
//   2 exact + env NEE (K4): also, at every diffuse vertex, a visibility ray
//     along the (iteration, depth) row's shared alias-sampled direction,
//     weighted by the balance heuristic, and the escape weighted against the
//     sampler's nearest-texel pdf. The rows are a device table [num_samples
//     * trace_depth, 8 + 6 * num_geoms] that a kernel of its own builds
//     before the launch (pt_env_rows, below: the threefry draws, the alias
//     draw and the bilinear radiance of each row, then per geom the row
//     direction's object-space direction and its reciprocals, which every
//     lane's env ray of that row shares); each lane reads the row of its own
//     sample and depth, served from L1/L2, and its env ray transforms only
//     its origin (occluded_row);
//   3 split (K5): delta suns (a visibility ray toward each sun above the
//     normal at every diffuse vertex) and an SH-9 residual sky on misses;
//     with bg_external the depth-0 background is composited outside the
//     kernel. The suns' object-space directions and their reciprocals do
//     not depend on the vertex: each block computes them once per launch
//     into a shared-memory table (6 floats a sun and geom, at most 48 KB:
//     32 suns, 64 geoms), as the TPU kernel folds its compile-time sun
//     directions into its per-geom transforms.
// The valid set follows the JAX wrapper's raises: NEE excludes LEGACY; every
// ENV excludes LEGACY; exact (1, 2) excludes analytic NEE; env NEE (2) and
// split (3) exclude TILES.
//
// A launch without TILES renders a contiguous slice of the flat pixel array
// (the multi-device pixel tiling, parallel/shard.py): pixel p of the slice is
// global pixel pixel_offset + p (its LD lattice key and coordinates), and its
// hash stream is lane p % tile of tile tile_base + p / tile.
//
// Output: out[p*3 + c] = sum over samples iter_base .. iter_base+num_samples-1
// (ascending, f32) of the path radiance of pixel p (of its terminal
// throughput with LEGACY). The kernel writes the [N,3] buffer the wrapper
// allocates; it never adds into the accumulator.
//
// The tile dispatch's queue items. A launch ends when its last lane ends,
// and a lane that took a pixel renders all its samples in series: the
// adaptive sampler's rounds (162 tile slots x 16 samples, 2.8 pixels a
// resident lane) lost 15% a pixel-sample to that tail against a full-frame
// launch on an NVIDIA H100 80GB HBM3 at 700 W (PERF.md). So where a
// dispatch gives the resident lanes fewer than 8 pixels each, the wrapper
// picks SAMPLES, an instantiation of its own (the whole-pixel dispatch
// keeps its code): the queue hands out (pixel, sample group) items of
// `group` samples, a divisor of num_samples that gives every resident lane
// 8 items. Item i renders samples (i / pixels) * group .. of pixel
// i % pixels with their own iterations and streams, as before, and each
// sample settles into a unit of its own, units[(s * pixels + pixel) * 3]
// (with an exact environment 6 floats: the path's radiance, then its escape
// term), which pt_fold_samples then sums in ascending sample order: the adds
// of a lane's running sum, so the output stays bit for bit. A hoisted
// primary hit is traced once an item.
//
// Schedule. The grid holds as many blocks as the card keeps resident (fewer
// for a small frame). Each warp takes 32 pixels at a time from a queue (lane
// 0 adds 32 to a counter that the launcher zeroes on the stream before the
// launch) and hands them to its lanes in lane order as lanes come free. A
// lane renders its pixel's samples in ascending order and sums them itself,
// as a thread per pixel did. One iteration of the warp's loop is one vertex
// of each lane's own path: start a sample if one is pending (its primary
// ray), trace the ray if it has no hit yet, shade the hit (miss, emitter, or
// Russian roulette and the scatter), and settle the sample into the pixel's
// sum when its path ends. A lane whose path ends starts its pixel's next
// sample instead of waiting for the warp's longest path (path regeneration;
// under an environment map, 12 lanes start together, see kBatch), and takes
// another pixel when its own are done. With the primary hit hoisted, a path
// that ends at its first vertex before any draw (a miss or an emitter) does
// so in every sample: the lane settles all of them at once. The counting
// build (-DPT_MEGA_COUNT) counts the loop's warp iterations, active lanes
// and visibility rays and records which warp took each chunk;
// ops/cuda/megakernel.warp_schedule replays that exactly on the plain
// version's path lengths and visibility rays.
//
// Visibility rays. At a diffuse vertex NEE casts a ray toward a point on an
// area light, env NEE one along its row's direction and the split one
// toward each sun above the normal, all from the origin of the extension
// ray. The env ray is traced there, in its own loop over the primitives
// (occluded_any). The sun rays are not: shading records the mask of suns
// and the factors of their terms, and the next iteration's trace tests them
// in the loop over the primitives that traces the extension ray (trace),
// sharing its origin's transform, slab offsets and c, with each sun's
// object-space direction and reciprocals read from the launch's sun table;
// the terms are then added, suns 0 .. S-1, before anything the next vertex
// adds. A path whose last vertex (trace depth reached) cast sun rays tests
// them in one more iteration of its own, then settles. Each test keeps the
// float expressions of the JAX kernel's occluded_any, and a ray is occluded
// if any test says so.
//
// The light rays go through a queue. A quarter of a warp's lanes cast one in
// a typical iteration, so a loop over the primitives at the vertex ran at a
// SIMT efficiency of 0.28 (NVIDIA H100 80GB HBM3 at 700 W, PERF.md).
// Instead a lane that casts one stages the ray (origin, direction, limit)
// and its term (the throughput times the albedo, the MIS-weighted light
// factor and the light's radiance), and at the end of the iteration, after
// its samples have settled, the warp's new rays join a queue of 64 entries
// in shared memory in lane order (one ballot). While 32 or more are
// pending, the warp tests the 32 oldest in one pass, lane i ray i through
// occluded_any, the geom index uniform across the warp; each lane then adds
// the terms of its own unoccluded rays, oldest first: to its sum if it
// still renders the ray's pixel (with SAMPLES, its sample), else to out[p]
// (the sample's unit), which it wrote itself and which no other warp
// touches. A warp
// tests the rays still pending in one last pass before it exits. The term
// thus joins the pixel's sum after the path's later terms, not before them
// as in the plain version: a different float grouping of the same terms
// (within the kernel-vs-plain bound; ROADMAP Queue 3), and, since when a
// pass runs depends on the pixels the warp took from the queue, one that
// may differ between launches in the last bits. Every variant without NEE
// is unchanged, bit for bit.

// Random numbers are the same streams as the JAX package's interpret-mode
// oracle: the LD lattice (_ld_shift, _sobol_scalar_pair, _lk, _ld_u01,
// _ld_rev_components) keyed by the global pixel id, and everything else from
// the counter hash _HashPrng keyed by lane = p % tile and reseeded with
// _mix(seed, iteration, depth | 0xAA | 0xD0F, tile). Every draw is thus a
// function of (pixel, iteration, depth): which lane renders a pixel, and
// when, changes no draw, and the kernel stays bit for bit the plain
// version. That is also why RenderConfig.early_exit needs no code here: the
// JAX kernel's flag skips a bounce only when every lane of a tile is dead,
// and here a lane whose path ends starts its next one; the output is the
// same with the flag on or off.
//
// What bounds it on this card: neither bytes nor float operations. A
// 50-sample launch of the main variant at 800x800, depth 8 stores 12 bytes
// a pixel and needs 0.48 ms at the float32 peak; it took 12.0 ms on an
// NVIDIA H100 80GB HBM3 at 700 W (15.3 ms with a thread per pixel, same
// call; PERF.md). The time goes to issue slots: the per-geom loop,
// the Sobol and Owen-scrambling integer draws, and divergence inside an
// iteration. Regeneration keeps 95% of the loop's lane slots busy on the
// main configuration (56% with a thread per pixel), but a warp's lanes sit
// at different vertices of their paths, so one iteration runs the union of
// their branches: the sample start, the trace, the scatter, the escape,
// and in 98% of the iterations both draw streams. Under an environment map,
// where most paths end within two vertices, that union outweighs the saved
// slots; lanes there start samples 12 at a time (kBatch), and those
// variants still run 14-27% slower than with a thread per pixel. Which
// pixels a warp's lanes hold does not set that time: a warp that takes its
// next 32 pixels only once its lanes are done with the last (32 neighbours)
// measured no faster, and queue chunks of 128 neighbours 26-42% slower (the
// launch's tail; NVIDIA H100 80GB HBM3 at 700 W, PERF.md). The scene
// and light tables are __grid_constant__ kernel parameters: they travel
// with the launch, so no copy precedes it and launches on different streams
// cannot overwrite each other's tables; the geom rows, read uniformly by
// the per-geom loop, stay in the parameter bank, and each block copies the
// material and light rows, which a lane indexes by its own hit, into shared
// memory. wgmma and TMA have no role here (no matrix products, no bulk
// tiles).
//
// Floating point: exact IEEE division for every reciprocal (the TPU kernel's
// approx-reciprocal + Newton step is ~1e-5 off in interpret mode),
// 1/sqrtf for rsqrt, and the accurate sinf/cosf/sqrtf (no --use_fast_math).
// The library is built with -fmad=false, so no multiply-add is contracted:
// each expression rounds after every operation, in the order the JAX code
// and the plain PyTorch version write it. That keeps the kernel within
// last-ulp noise of the plain PyTorch version on the card (which runs each
// operation as its own kernel); with contraction on, those ulps grow and
// flip more discrete Russian-roulette / branch outcomes.

#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include <type_traits>

// the JAX megakernel's 1-64 analytic primitives; the host keeps only the
// materials the geoms reference, so they never outnumber the geoms
#define PT_MAX_GEOMS 64
#define PT_MAX_MATERIALS PT_MAX_GEOMS
#define PT_MAX_LIGHTS PT_MAX_GEOMS
#define PT_GF 21  // floats per geom: inverse transform rows (12) + inverse-transpose (9)
#define PT_MF 10  // floats per material: color(3) spec(3) refl refr emit ior
#define PT_LF 26  // floats per light row: A(9) translation(3) A^-T(9) |det A| Le(3) pdf
#define PT_MAX_SUNS 32
#define PT_BLOCK 128
#define PT_WARPS (PT_BLOCK / 32)
// a warp's queue of light rays (NEE): entries, and floats an entry (origin,
// direction, limit, term rgb); where the term goes is kept beside them
#define PT_QUEUE 64
#define PT_QF 10

// Work counters. A build with -DPT_MEGA_COUNT adds up, per launch, the warp
// iterations of the bounce loop (work[0]), the lanes active in them
// (work[1]) and the iterations in which both draw branches ran, the LD
// branch on some lanes and the hash branch on others (work[2]): the SIMT
// efficiency of the loop is work[1] / (32 work[0]). Then the visibility
// rays: the warp iterations in which some lane casts an area-light ray
// (work[3]) or an env NEE ray (work[4]) or tests sun rays (work[5]), the
// lanes that test sun rays in them (work[6]), and the rays of each kind,
// light, env and sun (work[7..9]); a lane casts at most one light and one
// env ray an iteration, so the env loop's SIMT efficiency is work[8] /
// (32 work[4]). The light rays' queue: the passes that test them (work[10])
// and the rays tested in them (work[11], the light passes' SIMT efficiency
// work[11] / (32 work[10])), the last passes of warps that exit with fewer
// than 32 pending (work[12]), and the rays tested after their lane wrote
// out their pixel (work[13]). The production build keeps none of it.
#ifdef PT_MEGA_COUNT
#define PT_MEGA_COUNTS true
#else
#define PT_MEGA_COUNTS false
#endif
#define PT_MEGA_WORK 14
// 7 resident blocks of PT_BLOCK threads an SM: at most 72 registers a
// thread. Against the compiler's own choice (64-96 registers, no spill) this
// measured 0-4% faster in every variant on an H100, though some variants
// spill up to 108 bytes (PERF.md).
#define PT_MIN_BLOCKS 7

constexpr float kMiss = 1e30f;
constexpr float kFmax = 3.402823466e38f;
constexpr float kBackoff = 1e-4f;
constexpr float kOriginOffset = 1e-3f;
constexpr float kPi = 3.14159265358979323846f;
constexpr float kHalfPi = 1.57079632679489661923f;
constexpr float kInvPi = 0.3183098861837907f;
constexpr float kInv2p24 = 5.9604644775390625e-08f;  // 2^-24
constexpr uint32_t kSobolMask = (1u << 21) - 1u;      // SOBOL_NBITS = 21

struct SceneTables {
  float cam[16];  // position, view, right, up, pixel_length(2), aperture, focal
  float geo[PT_MAX_GEOMS * PT_GF];
  float mats[PT_MAX_MATERIALS * PT_MF];
  int gmat[PT_MAX_GEOMS];
  int perm[PT_MAX_GEOMS * 3];  // axis-aligned column per row, -1 = generic
  int num_cubes;
  int num_geoms;
};

// One analytic emitter (megakernel._static_light_table row).
struct LightRow {
  float a[9];    // object-to-world linear part A, row-major
  float tr[3];   // translation
  float ait[9];  // A^-T, row-major
  float det;     // |det A|
  float le[3];   // emitted radiance (color x emittance)
  float pdf;     // float32(pdf_obj / L): object-space area pdf over the light count
  int kind;      // 0 cube, 1 sphere
  int mat;       // material id (unique per light)
};

struct LightTable {
  LightRow rows[PT_MAX_LIGHTS];
  int count;
};
struct NoLights {};

// K6's chosen tiles: tiles[0..k) hash tile keys, tiles[k..2k) 1-based
// iteration bases, px/py [k*tile] pixel coordinates (device memory).
struct TileArgs {
  const int* tiles;
  const float* px;
  const float* py;
  int k;
};
struct NoTiles {};

// ENV 1/2: the map's texels, tex[y*w + x] = (r, g, b, pdf), the
// strength-folded radiance and the sampler's pdf, and (ENV 2) env NEE's rows,
// row r = s*trace_depth + depth at rows[r * (8 + 6 * num_geoms)]: dir xyz,
// bilinear radiance rgb, pdf, 0, then geom k's entry of the direction
// (dir_entry) at 8 + 6k; all device memory.
struct EnvExact {
  const float4* tex;
  const float* rows;
  int h;
  int w;
};
// ENV 3, by value: suns (dx, dy, dz, Er, Eg, Eb) and the 3 x 9 SH
// coefficients (sh[c*9], the first term, already multiplied by Y00).
struct EnvSplit {
  float sun[PT_MAX_SUNS * 6];
  float sh[27];
  int num_suns;
  int bg_external;
};
struct NoEnv {};

template <bool NEE>
using LightsArg = typename std::conditional<NEE, LightTable, NoLights>::type;
template <bool TILES>
using TilesArg = typename std::conditional<TILES, TileArgs, NoTiles>::type;
template <int ENV>
using EnvArg = typename std::conditional<
    ENV == 0, NoEnv, typename std::conditional<ENV == 3, EnvSplit, EnvExact>::type>::type;

struct Options {
  int n;       // queue items: pixels, or with SAMPLES (pixel, sample group) pairs
  int pixels;  // pixels of the launch
  int group;   // samples an item renders (SAMPLES; num_samples elsewhere)
  int width;
  int height;
  uint32_t seed;
  int iter_base;
  int pixel_offset;  // global id of the slice's first pixel (0 with TILES)
  int tile_base;     // hash tile of the slice's first pixel (0 with TILES)
  int tile;
  int num_samples;
  int trace_depth;
  int rr_start_depth;
  int antialias;
  int use_ld;
  int n_ld;
  float sky_strength;
};

// The parameter block passes 4 KB (about 9 KB of scene tables, 17 KB with
// the 64-row light table): kernel parameters up to 32764 bytes need CUDA
// 12.1 or later and a Volta or later card.
static_assert(sizeof(Options) + sizeof(SceneTables) + sizeof(LightTable) + sizeof(TileArgs) +
                      sizeof(EnvSplit) + sizeof(float*) + 64 <=
                  32764,
              "kernel parameter block exceeds the 32764-byte limit");
#if defined(CUDART_VERSION) && CUDART_VERSION < 12010
static_assert(sizeof(Options) + sizeof(SceneTables) + sizeof(LightTable) + sizeof(TileArgs) +
                      sizeof(EnvSplit) + sizeof(float*) <=
                  4096,
              "kernel parameters above 4 KB need CUDA 12.1 or later");
#endif

// jnp.minimum / jnp.maximum semantics: a NaN operand propagates.
static __device__ __forceinline__ float jmin(float a, float b) {
  return (a < b || a != a) ? a : b;
}
static __device__ __forceinline__ float jmax(float a, float b) {
  return (a > b || a != a) ? a : b;
}
static __device__ __forceinline__ float sel3(int i, float a, float b, float c) {
  return i == 0 ? a : (i == 1 ? b : c);
}
static __device__ __forceinline__ float rsqrt_exact(float x) { return 1.0f / sqrtf(x); }

// megakernel._mix over four uint32 words
static __device__ __forceinline__ uint32_t mix4(uint32_t a, uint32_t b, uint32_t c, uint32_t d) {
  const uint32_t h = 0x9E3779B9u;
  uint32_t out = 0u;
  out ^= a * (h + 1u); out *= 0x85EBCA6Bu; out ^= out >> 13;
  out ^= b * (h + 3u); out *= 0x85EBCA6Bu; out ^= out >> 13;
  out ^= c * (h + 5u); out *= 0x85EBCA6Bu; out ^= out >> 13;
  out ^= d * (h + 7u); out *= 0x85EBCA6Bu; out ^= out >> 13;
  return out;
}

// megakernel._HashPrng: uniforms are a function of (seed, draw counter, lane)
struct HashPrng {
  uint32_t lane;
  uint32_t seed_mul;
  uint32_t counter;

  __device__ __forceinline__ void reseed(uint32_t s) {
    seed_mul = s * 0x9E3779B9u;
    counter = 0u;
  }
  __device__ __forceinline__ float u01() {
    counter += 1u;
    uint32_t x = lane ^ seed_mul;
    x += counter * 0x85EBCA6Bu;
    x = (x ^ (x >> 16)) * 0x7FEB352Du;
    x = (x ^ (x >> 15)) * 0x846CA68Bu;
    x ^= x >> 16;
    return (float)(x >> 8) * kInv2p24;
  }
};

// megakernel._ld_shift: per-(pixel, tag, seed) Owen-scramble seed
static __device__ __forceinline__ uint32_t ld_shift(uint32_t pid, uint32_t seed, uint32_t tag) {
  uint32_t x = pid ^ ((0x5D000000u + tag) ^ (seed * 0x9E3779B9u));
  x = (x ^ (x >> 16)) * 0x7FEB352Du;
  x = (x ^ (x >> 15)) * 0x846CA68Bu;
  return x ^ (x >> 16);
}

// megakernel._lk: Laine-Karras rounds (seed pre-added by the caller)
static __device__ __forceinline__ uint32_t lk(uint32_t x) {
  x ^= x * 0x6C50B47Cu;
  x ^= x * 0xB82F1E52u;
  x ^= x * 0xC7AFE638u;
  x ^= x * 0x8D22F6E6u;
  return x;
}

// megakernel._ld_u01: Owen-scrambled reversed Sobol bits -> [0, 1)
static __device__ __forceinline__ float ld_u01(uint32_t rev_bits, uint32_t seed) {
  return (float)(__brev(lk(rev_bits + seed)) >> 8) * kInv2p24;
}

// Bit-reversed (0,2) components of sample index idx (low 21 bits): component
// 0 reversed is the index itself, component 1 reversed is the reversal of
// the XOR of the x+1 direction numbers v_k = m_k << (31-k) over set bits.
static __device__ __forceinline__ void sobol_rev_pair(uint32_t idx, uint32_t* r0, uint32_t* r1) {
  uint32_t m = 1u;
  uint32_t x1 = 0u;
#pragma unroll
  for (int k = 0; k < 21; ++k) {
    x1 ^= ((idx >> k) & 1u) * (m << (31 - k));
    m = (m << 1) ^ m;
  }
  *r0 = idx & kSobolMask;
  *r1 = __brev(x1);
}

// megakernel._ld_rev_components: raw index at depth 0, the per-(pixel,
// depth) Owen-shuffled index (ops.rng.ld_shuffled_index) past it
static __device__ __forceinline__ void ld_rev_components(uint32_t it, int depth, uint32_t pid,
                                                  uint32_t seed, uint32_t* r0, uint32_t* r1) {
  uint32_t idx = it;
  if (depth > 0) {
    const uint32_t j = __brev(it) >> 11;
    const uint32_t jp = lk(j + ld_shift(pid, seed, 256u + (uint32_t)depth)) & kSobolMask;
    idx = __brev(jp) >> 11;
  }
  sobol_rev_pair(idx, r0, r1);
}

// ops.rng.ld_bounce_tags / ld_nee_tags
static __device__ __forceinline__ uint32_t ld_bounce_tag(int depth, int which) {
  if (depth == 0) return 4u + (uint32_t)which;
  return 10u + (uint32_t)(depth - 1) * 6u + (uint32_t)which;
}
static __device__ __forceinline__ uint32_t ld_nee_tag(int depth, int which) {
  if (depth == 0) return 7u + (uint32_t)which;
  return 13u + (uint32_t)(depth - 1) * 6u + (uint32_t)which;
}

struct Hit {
  float t, nx, ny, nz;
  int mat;
};
// With refraction the hit also says whether the ray entered its primitive
// from outside (n1/n2 of Snell's law).
struct HitOut : Hit {
  bool out;
};
template <bool OUT>
using HitT = typename std::conditional<OUT, HitOut, Hit>::type;

// Pinhole raygen (generateRayFromCamera, `pathtrace.cu:270-286`)
static __device__ __forceinline__ void raygen(const Options& o, const SceneTables& sc,
                                              float fx, float fy,
                                              float* dx, float* dy, float* dz) {
  const float* cam = sc.cam;
  const float sx = cam[12] * (fx - 0.5f * (float)o.width);
  const float sy = cam[13] * (fy - 0.5f * (float)o.height);
  const float x = cam[3] - cam[6] * sx - cam[9] * sy;
  const float y = cam[4] - cam[7] * sx - cam[10] * sy;
  const float z = cam[5] - cam[8] * sx - cam[11] * sy;
  const float rn = rsqrt_exact(x * x + y * y + z * z);
  *dx = x * rn;
  *dy = y * rn;
  *dz = z * rn;
}

// Gradient sky (`pathtrace.cu:358-362`) in the escaping ray's direction.
static __device__ __forceinline__ void sky(float dy, float* r, float* g, float* b) {
  const float t_sky = 0.5f * (dy + 1.0f);
  *r = ((1.0f - t_sky) + t_sky * 0.5f) * 0.5f;
  *g = ((1.0f - t_sky) + t_sky * 0.7f) * 0.5f;
  *b = ((1.0f - t_sky) + t_sky * 1.0f) * 0.5f;
}

// Geom k's object-space origin q[0..2] (object_ray's first three terms).
static __device__ __forceinline__ void object_origin(const SceneTables& sc, int k, float ox,
                                                     float oy, float oz, float* q) {
  const float* iv = sc.geo + k * PT_GF;
  const int c0 = sc.perm[k * 3 + 0];
  const int c1 = sc.perm[k * 3 + 1];
  const int c2 = sc.perm[k * 3 + 2];
  if (c0 < 0) {
    q[0] = iv[0] * ox + iv[1] * oy + iv[2] * oz + iv[3];
    q[1] = iv[4] * ox + iv[5] * oy + iv[6] * oz + iv[7];
    q[2] = iv[8] * ox + iv[9] * oy + iv[10] * oz + iv[11];
  } else {
    // one nonzero per row of M^-1 (column perm[r]): 3 mul + 3 add
    q[0] = iv[c0] * sel3(c0, ox, oy, oz) + iv[3];
    q[1] = iv[4 + c1] * sel3(c1, ox, oy, oz) + iv[7];
    q[2] = iv[8 + c2] * sel3(c2, ox, oy, oz) + iv[11];
  }
}

// Geom k's object-space ray (unnormalized direction, so the slab/quadratic
// parameter is the world distance): the origin, then the direction q[3..5].
static __device__ __forceinline__ void object_ray(const SceneTables& sc, int k, float ox, float oy,
                                                  float oz, float dx, float dy, float dz,
                                                  float* q) {
  object_origin(sc, k, ox, oy, oz, q);
  const float* iv = sc.geo + k * PT_GF;
  const int c0 = sc.perm[k * 3 + 0];
  const int c1 = sc.perm[k * 3 + 1];
  const int c2 = sc.perm[k * 3 + 2];
  if (c0 < 0) {
    q[3] = iv[0] * dx + iv[1] * dy + iv[2] * dz;
    q[4] = iv[4] * dx + iv[5] * dy + iv[6] * dz;
    q[5] = iv[8] * dx + iv[9] * dy + iv[10] * dz;
  } else {
    q[3] = iv[c0] * sel3(c0, dx, dy, dz);
    q[4] = iv[4 + c1] * sel3(c1, dx, dy, dz);
    q[5] = iv[8 + c2] * sel3(c2, dx, dy, dz);
  }
}

// What a visibility ray's test against geom k reads that no origin changes
// (the sun table's and env NEE's row table's entry, 6 floats): the
// direction's object-space direction (object_ray's) and, for a cube, its
// three reciprocals, for a sphere |q_d|^2 and its reciprocal.
static __device__ __forceinline__ void dir_entry(const SceneTables& sc, int k, float dx, float dy,
                                                 float dz, float* e) {
  float q[6];
  object_ray(sc, k, 0.0f, 0.0f, 0.0f, dx, dy, dz, q);
  e[0] = q[3];
  e[1] = q[4];
  e[2] = q[5];
  if (k < sc.num_cubes) {
    e[3] = 1.0f / q[3];
    e[4] = 1.0f / q[4];
    e[5] = 1.0f / q[5];
  } else {
    const float nq2 = q[3] * q[3] + q[4] * q[4] + q[5] * q[5];
    e[3] = nq2;
    e[4] = 1.0f / nq2;
    e[5] = 0.0f;
  }
}

// A visibility ray's test against one cube (megakernel.occluded_any's slab
// branch): lo = -0.5 - q_o and hi = 0.5 - q_o, shared by every ray from
// the origin, and the reciprocals of its object-space direction. Does the
// cube block it at a backoff-adjusted t in (0, limit)?
static __device__ __forceinline__ bool cube_blocks(float lox, float loy, float loz, float hix,
                                                   float hiy, float hiz, float ix, float iy,
                                                   float iz, float limit) {
  const float t1x = lox * ix;
  const float t2x = hix * ix;
  const float t1y = loy * iy;
  const float t2y = hiy * iy;
  const float t1z = loz * iz;
  const float t2z = hiz * iz;
  float ax = jmin(t1x, t2x), ay = jmin(t1y, t2y), az = jmin(t1z, t2z);
  float bx = jmax(t1x, t2x), by = jmax(t1y, t2y), bz = jmax(t1z, t2z);
  ax = ax > 0.0f ? ax : -kFmax;
  ay = ay > 0.0f ? ay : -kFmax;
  az = az > 0.0f ? az : -kFmax;
  bx = bx < kFmax ? bx : kFmax;
  by = by < kFmax ? by : kFmax;
  bz = bz < kFmax ? bz : kFmax;
  const float s_min = jmax(ax, jmax(ay, az));
  const float s_max = jmin(bx, jmin(by, bz));
  const bool hit = (s_max >= s_min) && (s_max > 0.0f);
  const float t_world = (s_min > 0.0f ? s_min : s_max) - kBackoff;
  return hit && (t_world > 0.0f) && (t_world < limit);
}

// The same against one sphere (the quadratic branch): c = |q_o|^2 - 0.25
// shared by every ray from the origin, the object-space direction, its
// squared length and that length's reciprocal.
static __device__ __forceinline__ bool sphere_blocks(float qox, float qoy, float qoz, float c,
                                                     float qdx, float qdy, float qdz, float nq2,
                                                     float inv_a, float limit) {
  const float b = qox * qdx + qoy * qdy + qoz * qdz;
  const float disc = b * b - nq2 * c;
  const float sq = sqrtf(jmax(disc, 0.0f));
  const float s1 = (-b + sq) * inv_a;
  const float s2 = (-b - sq) * inv_a;
  const bool both_neg = (s1 < 0.0f) && (s2 < 0.0f);
  const bool both_pos = (s1 > 0.0f) && (s2 > 0.0f);
  const bool hit = (disc >= 0.0f) && !both_neg;
  const float t_world = (both_pos ? jmin(s1, s2) : jmax(s1, s2)) - kBackoff;
  return hit && (t_world > 0.0f) && (t_world < limit);
}

// The sun rays a lane casts at a diffuse vertex, traced with the next ray
// that leaves the vertex (see the note on visibility rays above): the mask
// of suns above the normal (a bit set says the ray is cast and, after the
// trace, unoccluded) and the factors of their terms, which the kernel
// multiplies out in the vertex's own expressions: the post-roulette
// throughput times the albedo, the diffuse probability and the normal.
struct SunVis {
  unsigned mask;
  float pr, pg, pb, diffuse, nx, ny, nz;
};
struct NoSunVis {
  unsigned mask;
};
template <int ENV>
using SunVisT = typename std::conditional<ENV == 3, SunVis, NoSunVis>::type;

// One loop over the primitives for a lane's rays from one origin: the
// nearest hit of the extension ray (megakernel.intersect_all: object-space
// slab test for cubes, quadratic for spheres; with OUT, whether the nearest
// hit entered its primitive from outside) where ``ext`` is set, and with
// SUNS the occlusion tests of the pending sun rays (megakernel.occluded_any:
// any primitive with a backoff-adjusted t in (0, limit)), each in the same
// float expressions as those functions. Each geom row is read once, and the
// origin's object-space transform, a cube's slab offsets and a sphere's c are
// computed once for all the rays. A sun ray's tests stop at its first
// occluder; it reads its object-space direction and reciprocals from the
// launch's table (tab[(k * num_suns + j) * 6], see fill_sun_table), and the
// sun loop runs over the warp's union of pending sun masks (sun_union), so
// every lane reads the same row.
template <bool OUT, bool SUNS>
static __device__ __forceinline__ HitT<OUT> trace(const SceneTables& sc, float ox, float oy,
                                                  float oz, float dx, float dy, float dz,
                                                  bool ext, unsigned& suns, const float* tab,
                                                  int num_suns, unsigned sun_union) {
  float best_t = kMiss, bnx = 0.0f, bny = 0.0f, bnz = 0.0f;
  int best_mat = 0;
  bool best_out = true;
  const int num_geoms = sc.num_geoms;
  const int num_cubes = sc.num_cubes;
  for (int k = 0; k < num_geoms; ++k) {
    // the object-space ray written out as object_ray computes it: calling
    // object_ray here costs the main variant a 4-byte spill (ptxas, H100)
    const float* iv = sc.geo + k * PT_GF;
    const float* it = iv + 12;
    const int c0 = sc.perm[k * 3 + 0];
    const int c1 = sc.perm[k * 3 + 1];
    const int c2 = sc.perm[k * 3 + 2];
    const bool aligned = c0 >= 0;
    float qox, qoy, qoz, qdx, qdy, qdz;
    if (!aligned) {
      qox = iv[0] * ox + iv[1] * oy + iv[2] * oz + iv[3];
      qoy = iv[4] * ox + iv[5] * oy + iv[6] * oz + iv[7];
      qoz = iv[8] * ox + iv[9] * oy + iv[10] * oz + iv[11];
      qdx = iv[0] * dx + iv[1] * dy + iv[2] * dz;
      qdy = iv[4] * dx + iv[5] * dy + iv[6] * dz;
      qdz = iv[8] * dx + iv[9] * dy + iv[10] * dz;
    } else {
      // one nonzero per row of M^-1 (column perm[r]): 6 mul + 3 add
      qox = iv[c0] * sel3(c0, ox, oy, oz) + iv[3];
      qoy = iv[4 + c1] * sel3(c1, ox, oy, oz) + iv[7];
      qoz = iv[8 + c2] * sel3(c2, ox, oy, oz) + iv[11];
      qdx = iv[c0] * sel3(c0, dx, dy, dz);
      qdy = iv[4 + c1] * sel3(c1, dx, dy, dz);
      qdz = iv[8 + c2] * sel3(c2, dx, dy, dz);
    }
    bool hit = false;
    bool hit_out = true;  // read only with OUT
    float t_world = 0.0f, nox = 0.0f, noy = 0.0f, noz = 0.0f;
    if (k < num_cubes) {
      const float lox = -0.5f - qox, hix = 0.5f - qox;
      const float loy = -0.5f - qoy, hiy = 0.5f - qoy;
      const float loz = -0.5f - qoz, hiz = 0.5f - qoz;
      if (ext) {
        const float ix = 1.0f / qdx;
        const float iy = 1.0f / qdy;
        const float iz = 1.0f / qdz;
        const float t1x = lox * ix;
        const float t2x = hix * ix;
        const float t1y = loy * iy;
        const float t2y = hiy * iy;
        const float t1z = loz * iz;
        const float t2z = hiz * iz;
        const float tax = jmin(t1x, t2x), tbx = jmax(t1x, t2x);
        const float tay = jmin(t1y, t2y), tby = jmax(t1y, t2y);
        const float taz = jmin(t1z, t2z), tbz = jmax(t1z, t2z);
        const float sgx = t2x < t1x ? 1.0f : -1.0f;
        const float sgy = t2y < t1y ? 1.0f : -1.0f;
        const float sgz = t2z < t1z ? 1.0f : -1.0f;
        const float ax = tax > 0.0f ? tax : -kFmax;
        const float ay = tay > 0.0f ? tay : -kFmax;
        const float az = taz > 0.0f ? taz : -kFmax;
        const float bx = tbx < kFmax ? tbx : kFmax;
        const float by = tby < kFmax ? tby : kFmax;
        const float bz = tbz < kFmax ? tbz : kFmax;
        const float s_min = jmax(ax, jmax(ay, az));
        const float s_max = jmin(bx, jmin(by, bz));
        const bool min_is_x = (ax >= ay) && (ax >= az);
        const bool min_is_y = !min_is_x && (ay >= az);
        const bool max_is_x = (bx <= by) && (bx <= bz);
        const bool max_is_y = !max_is_x && (by <= bz);
        const bool outside = s_min > 0.0f;
        hit = (s_max >= s_min) && (s_max > 0.0f);
        const float sparam = outside ? s_min : s_max;
        const bool use_x = (outside && min_is_x) || (!outside && max_is_x);
        const bool use_y = (outside && min_is_y) || (!outside && max_is_y);
        t_world = sparam - kBackoff;
        if constexpr (OUT) hit_out = outside;
        if (aligned) {
          // face a lands on world row perm[a]; world row r reads face inv_p[r]
          const bool sels[3] = {use_x, use_y, !(use_x || use_y)};
          const float sgs[3] = {sgx, sgy, sgz};
          float wn[3];
#pragma unroll
          for (int r = 0; r < 3; ++r) {
            const int a = (c0 == r) ? 0 : ((c1 == r) ? 1 : 2);
            const bool sa = a == 0 ? sels[0] : (a == 1 ? sels[1] : sels[2]);
            const float ga = a == 0 ? sgs[0] : (a == 1 ? sgs[1] : sgs[2]);
            wn[r] = sa ? ga * it[r * 3 + a] : 0.0f;
          }
          nox = wn[0];
          noy = wn[1];
          noz = wn[2];
        } else {
          const float sfx = use_x ? 1.0f : 0.0f;
          const float sfy = use_y ? 1.0f : 0.0f;
          const float gx = sgx * sfx;
          const float gy = sgy * sfy;
          const float gz = sgz * (1.0f - sfx - sfy);
          nox = gx * it[0] + gy * it[1] + gz * it[2];
          noy = gx * it[3] + gy * it[4] + gz * it[5];
          noz = gx * it[6] + gy * it[7] + gz * it[8];
        }
      }
      if constexpr (SUNS) {
        for (unsigned todo = sun_union; todo != 0u; todo &= todo - 1u) {
          const int j = __ffs(todo) - 1;
          const float* e = tab + (k * num_suns + j) * 6;
          if (((suns >> j) & 1u) &&
              cube_blocks(lox, loy, loz, hix, hiy, hiz, e[3], e[4], e[5], 1e7f))
            suns &= ~(1u << j);
        }
      }
    } else {
      const float c = qox * qox + qoy * qoy + qoz * qoz - 0.25f;
      if (ext) {
        const float nq2 = qdx * qdx + qdy * qdy + qdz * qdz;
        const float b = qox * qdx + qoy * qdy + qoz * qdz;
        const float disc = b * b - nq2 * c;
        const float sq = sqrtf(jmax(disc, 0.0f));
        const float inv_a = 1.0f / nq2;
        const float s1 = (-b + sq) * inv_a;
        const float s2 = (-b - sq) * inv_a;
        const bool both_neg = (s1 < 0.0f) && (s2 < 0.0f);
        const bool both_pos = (s1 > 0.0f) && (s2 > 0.0f);
        if constexpr (OUT) hit_out = both_pos;
        const float sparam = both_pos ? jmin(s1, s2) : jmax(s1, s2);
        hit = (disc >= 0.0f) && !both_neg;
        t_world = sparam - kBackoff;
        const float flip = both_pos ? 1.0f : -1.0f;
        const float sx = (qox + t_world * qdx) * flip;
        const float sy = (qoy + t_world * qdy) * flip;
        const float sz = (qoz + t_world * qdz) * flip;
        if (aligned) {
          const int p0 = (c0 == 0) ? 0 : ((c1 == 0) ? 1 : 2);
          const int p1 = (c0 == 1) ? 0 : ((c1 == 1) ? 1 : 2);
          const int p2 = (c0 == 2) ? 0 : ((c1 == 2) ? 1 : 2);
          nox = it[0 * 3 + p0] * sel3(p0, sx, sy, sz);
          noy = it[1 * 3 + p1] * sel3(p1, sx, sy, sz);
          noz = it[2 * 3 + p2] * sel3(p2, sx, sy, sz);
        } else {
          nox = it[0] * sx + it[1] * sy + it[2] * sz;
          noy = it[3] * sx + it[4] * sy + it[5] * sz;
          noz = it[6] * sx + it[7] * sy + it[8] * sz;
        }
      }
      if constexpr (SUNS) {
        for (unsigned todo = sun_union; todo != 0u; todo &= todo - 1u) {
          const int j = __ffs(todo) - 1;
          const float* e = tab + (k * num_suns + j) * 6;
          if (((suns >> j) & 1u) &&
              sphere_blocks(qox, qoy, qoz, c, e[0], e[1], e[2], e[3], e[4], 1e7f))
            suns &= ~(1u << j);
        }
      }
    }
    if (hit && (t_world > 0.0f) && (t_world < best_t)) {
      best_t = t_world;
      bnx = nox;
      bny = noy;
      bnz = noz;
      best_mat = sc.gmat[k];
      if constexpr (OUT) best_out = hit_out;
    }
  }
  const float rw = rsqrt_exact(jmax(bnx * bnx + bny * bny + bnz * bnz, 1e-30f));
  HitT<OUT> h;
  h.t = best_t;
  h.nx = bnx * rw;
  h.ny = bny * rw;
  h.nz = bnz * rw;
  h.mat = best_mat;
  if constexpr (OUT) h.out = best_out;
  return h;
}

// Shadow test (megakernel.occluded_any): does any primitive hit with a
// backoff-adjusted t in (0, limit)? The same per-geom arithmetic and
// positivity gate as trace; returns at the first occluder.
static __device__ bool occluded_any(const SceneTables& sc, float ox, float oy, float oz, float dx,
                                    float dy, float dz, float limit) {
  const int num_geoms = sc.num_geoms;
  const int num_cubes = sc.num_cubes;
  for (int k = 0; k < num_geoms; ++k) {
    float q[6];
    object_ray(sc, k, ox, oy, oz, dx, dy, dz, q);
    const float qox = q[0], qoy = q[1], qoz = q[2], qdx = q[3], qdy = q[4], qdz = q[5];
    bool blocked;
    if (k < num_cubes) {
      blocked = cube_blocks(-0.5f - qox, -0.5f - qoy, -0.5f - qoz, 0.5f - qox, 0.5f - qoy,
                            0.5f - qoz, 1.0f / qdx, 1.0f / qdy, 1.0f / qdz, limit);
    } else {
      const float nq2 = qdx * qdx + qdy * qdy + qdz * qdz;
      const float c = qox * qox + qoy * qoy + qoz * qoz - 0.25f;
      blocked = sphere_blocks(qox, qoy, qoz, c, qdx, qdy, qdz, nq2, 1.0f / nq2, limit);
    }
    if (blocked) return true;
  }
  return false;
}

// The env NEE ray's test (K4): occluded_any along a row's direction, whose
// per-geom terms come from the row's table (tab[6k], dir_entry's, device
// memory); only the origin is transformed here. The same float expressions
// as occluded_any, so the same answer.
static __device__ bool occluded_row(const SceneTables& sc, float ox, float oy, float oz,
                                    const float* __restrict__ tab, float limit) {
  const int num_geoms = sc.num_geoms;
  const int num_cubes = sc.num_cubes;
  for (int k = 0; k < num_geoms; ++k) {
    float q[3];
    object_origin(sc, k, ox, oy, oz, q);
    const float* e = tab + 6 * k;
    bool blocked;
    if (k < num_cubes) {
      blocked = cube_blocks(-0.5f - q[0], -0.5f - q[1], -0.5f - q[2], 0.5f - q[0], 0.5f - q[1],
                            0.5f - q[2], __ldg(e + 3), __ldg(e + 4), __ldg(e + 5), limit);
    } else {
      const float c = q[0] * q[0] + q[1] * q[1] + q[2] * q[2] - 0.25f;
      blocked = sphere_blocks(q[0], q[1], q[2], c, __ldg(e + 0), __ldg(e + 1), __ldg(e + 2),
                              __ldg(e + 3), __ldg(e + 4), limit);
    }
    if (blocked) return true;
  }
  return false;
}

// The launch's sun table in shared memory (ENV 3): per (geom k, sun j), at
// (k * num_suns + j) * 6, the sun's dir_entry.
static __device__ void fill_sun_table(const SceneTables& sc, const EnvSplit& env, float* tab) {
  const int ns = env.num_suns;
  for (int i = threadIdx.x; i < ns * sc.num_geoms; i += PT_BLOCK) {
    const float* sd = env.sun + 6 * (i % ns);
    dir_entry(sc, i / ns, sd[0], sd[1], sd[2], tab + i * 6);
  }
}

// Balance-heuristic weight of a BRDF-sampled emissive hit against NEE having
// sampled the same point (the JAX kernel's emissive branch, ops/shade.py):
// the hit light is identified by material id (unique per light); its area
// pdf at the hit follows from its transform and the world normal:
// n_obj ~ A^T n_w, s = |det A| |A^-T n_obj|, pdf_A = pdf / s.
static __device__ float emit_mis_weight(const LightTable& lt, const Hit& h, float dx, float dy,
                                        float dz, float prev_pdf) {
  if (prev_pdf < 0.0f) return 1.0f;  // primary ray or a delta lobe
  for (int i = 0; i < lt.count; ++i) {
    const LightRow& l = lt.rows[i];
    if (l.mat != h.mat) continue;
    const float* a = l.a;
    const float* ai = l.ait;
    float o0 = a[0] * h.nx + a[3] * h.ny + a[6] * h.nz;
    float o1 = a[1] * h.nx + a[4] * h.ny + a[7] * h.nz;
    float o2 = a[2] * h.nx + a[5] * h.ny + a[8] * h.nz;
    const float rn = rsqrt_exact(jmax(o0 * o0 + o1 * o1 + o2 * o2, 1e-20f));
    o0 = o0 * rn;
    o1 = o1 * rn;
    o2 = o2 * rn;
    const float t0 = ai[0] * o0 + ai[1] * o1 + ai[2] * o2;
    const float t1 = ai[3] * o0 + ai[4] * o1 + ai[5] * o2;
    const float t2 = ai[6] * o0 + ai[7] * o1 + ai[8] * o2;
    const float s = l.det * sqrtf(jmax(t0 * t0 + t1 * t1 + t2 * t2, 1e-40f));
    const float p_l = l.pdf * (1.0f / jmax(s, 1e-20f));
    const float cos_l = jmax(-(dx * h.nx + dy * h.ny + dz * h.nz), 1e-6f);
    const float p_nee_dir = p_l * h.t * h.t * (1.0f / cos_l);
    return prev_pdf * (1.0f / jmax(prev_pdf + p_nee_dir, 1e-20f));
  }
  return 1.0f;  // an emitter outside the light table
}

// A point on one emitter, uniform by object-space area (the JAX kernel's
// sample_light): world point, world unit normal, world-area pdf (with the
// 1/L pick).
static __device__ __forceinline__ void sample_light(const LightRow& l, float u_l1, float u_l2,
                                                    float* lp, float* ln, float* pdf_a) {
  float sp0, sp1, sp2, sn0, sn1, sn2;
  if (l.kind == 1) {  // sphere: uniform direction, r = 0.5
    const float z = 1.0f - 2.0f * u_l1;
    const float rxy = sqrtf(jmax(1.0f - z * z, 0.0f));
    const float ph = 2.0f * kPi * u_l2;
    sn0 = rxy * cosf(ph);
    sn1 = z;
    sn2 = rxy * sinf(ph);
    sp0 = 0.5f * sn0;
    sp1 = 0.5f * sn1;
    sp2 = 0.5f * sn2;
  } else {  // cube: uniform over the 6 unit faces
    const float f6 = u_l1 * 6.0f;
    const int face = min((int)f6, 5);
    const float u_f = f6 - (float)face;
    const int axis = face / 2;
    const float sgn = (face % 2 == 0) ? 1.0f : -1.0f;
    const float cu = u_f - 0.5f;
    const float cv = u_l2 - 0.5f;
    sp0 = axis == 0 ? sgn * 0.5f : cu;
    sp1 = axis == 1 ? sgn * 0.5f : (axis == 0 ? cu : cv);
    sp2 = axis == 2 ? sgn * 0.5f : cv;
    sn0 = axis == 0 ? sgn : 0.0f;
    sn1 = axis == 1 ? sgn : 0.0f;
    sn2 = axis == 2 ? sgn : 0.0f;
  }
  const float* a = l.a;
  const float* ai = l.ait;
  lp[0] = a[0] * sp0 + a[1] * sp1 + a[2] * sp2 + l.tr[0];
  lp[1] = a[3] * sp0 + a[4] * sp1 + a[5] * sp2 + l.tr[1];
  lp[2] = a[6] * sp0 + a[7] * sp1 + a[8] * sp2 + l.tr[2];
  const float un0 = ai[0] * sn0 + ai[1] * sn1 + ai[2] * sn2;
  const float un1 = ai[3] * sn0 + ai[4] * sn1 + ai[5] * sn2;
  const float un2 = ai[6] * sn0 + ai[7] * sn1 + ai[8] * sn2;
  const float nn = sqrtf(jmax(un0 * un0 + un1 * un1 + un2 * un2, 1e-40f));
  const float rnn = 1.0f / nn;
  *pdf_a = l.pdf * (1.0f / jmax(l.det * nn, 1e-20f));
  ln[0] = un0 * rnn;
  ln[1] = un1 * rnn;
  ln[2] = un2 * rnn;
}

// The TPU kernel's polynomial atan2 (_patan2, megakernel.py:76-104): a
// degree-9 fit of atan(t)/t in t^2, Horner from the top coefficient, with
// the octant reduction; (0, 0) -> 0. Each constant is the float nearest the
// double the JAX code writes (a cast of the double literal, as jnp.float32).
static __device__ __forceinline__ float patan2(float y, float x) {
  const float ax = fabsf(x);
  const float ay = fabsf(y);
  const bool swap = ay > ax;
  const float num = swap ? ax : ay;
  const float den = jmax(swap ? ay : ax, 1e-30f);
  const float t = num / den;
  const float s = t * t;
  float p = (float)-0.0017213223616973183;
  p = p * s + (float)0.010544175519843985;
  p = p * s + (float)-0.030384225558022983;
  p = p * s + (float)0.05703403618375145;
  p = p * s + (float)-0.08340029963538047;
  p = p * s + (float)0.1092607635073435;
  p = p * s + (float)-0.14257992653960597;
  p = p * s + (float)0.199977505037471;
  p = p * s + (float)-0.33333254080432473;
  p = p * s + (float)0.9999999930825906;
  float r = p * t;
  r = swap ? (float)(3.14159265358979323846 * 0.5) - r : r;
  r = x < 0.0f ? (float)3.14159265358979323846 - r : r;
  return y < 0.0f ? -r : r;
}

// (u, v) of a direction: u = 0.5 + atan2(x, -z) / 2pi, v = acos(y) / pi,
// acos through patan2 (_pacos).
static __device__ __forceinline__ void env_uv(float dx, float dy, float dz, float* u, float* v) {
  *u = 0.5f + patan2(dx, -dz) * (float)(1.0 / 6.283185307179586);
  const float c = jmin(jmax(dy, -1.0f), 1.0f);
  *v = patan2(sqrtf(jmax((1.0f - c) * (1.0f + c), 0.0f)), c) * (float)(1.0 / 3.14159265358979323846);
}

// Bilinear radiance at an escape direction (K3; the TPU kernel's env_lookup):
// wrap in azimuth, clamp at the poles. Its one-hot rows sum the weights of
// equal indices, so at the pole clamp (y0 == y1) the row weight is
// (1-ty)+ty; its matrix product becomes two-term sums per column and row.
// With PDF (K4) also the sampler's pdf of the direction (its
// env_pdf_lookup): the nearest texel, no -0.5 offset, clamped, from the
// same (u, v). That texel is one of the four: u*w - 0.5 is exact in f32, so
// floor(u*w) is x0 or x0 + 1 (x1 at the wrap, x0 past the map's right edge,
// x1 = 0 left of the first texel centre), and the same holds in v against
// the clamped rows.
template <bool PDF>
static __device__ __forceinline__ void env_lookup(const EnvExact& e, float dx, float dy, float dz,
                                                  float* rgb, float* pdf) {
  float u, v;
  env_uv(dx, dy, dz, &u, &v);
  const int w = e.w, h = e.h;
  const float fx = u * (float)w - 0.5f;
  const float fy = v * (float)h - 0.5f;
  const float x0 = floorf(fx);
  const float y0 = floorf(fy);
  const float tx = fx - x0;
  const float ty = fy - y0;
  int x0i = (int)x0;
  x0i = x0i < 0 ? w - 1 : min(x0i, w - 1);
  const int x1i = x0i + 1 > w - 1 ? 0 : x0i + 1;
  const int y0i = min(max((int)y0, 0), h - 1);
  const int y1i = min(y0i + 1, h - 1);
  const bool same_y = y0i == y1i;
  const bool same_x = x0i == x1i;
  const float wy0 = same_y ? (1.0f - ty) + ty : 1.0f - ty;
  const float wx0 = same_x ? (1.0f - tx) + tx : 1.0f - tx;
  const float4* row0 = e.tex + y0i * w;
  const float4* row1 = e.tex + y1i * w;
  const float4 t00 = __ldg(row0 + x0i);
  const float4 t01 = __ldg(row0 + x1i);
  const float4 t10 = __ldg(row1 + x0i);
  const float4 t11 = __ldg(row1 + x1i);
  const float c00[3] = {t00.x, t00.y, t00.z};
  const float c01[3] = {t01.x, t01.y, t01.z};
  const float c10[3] = {t10.x, t10.y, t10.z};
  const float c11[3] = {t11.x, t11.y, t11.z};
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    float col0 = c00[c] * wy0;
    float col1 = c01[c] * wy0;
    if (!same_y) {
      col0 = col0 + c10[c] * ty;
      col1 = col1 + c11[c] * ty;
    }
    const float left = wx0 * col0;
    rgb[c] = same_x ? left : left + tx * col1;
  }
  if constexpr (PDF) {
    const int xi = min(max((int)(u * (float)w), 0), w - 1);
    const int yi = min(max((int)(v * (float)h), 0), h - 1);
    *pdf = (yi != y0i ? (xi != x0i ? t11 : t10) : (xi != x0i ? t01 : t00)).w;
  }
}

// SH-9 residual sky of the split mode (ops.envmap.sh9_eval): the shared
// basis, then 8 multiply-adds per channel after the first term.
static __device__ __forceinline__ float sh9_channel(const float* c, const float* b) {
  float acc = c[0];
#pragma unroll
  for (int i = 1; i < 9; ++i) acc = acc + c[i] * b[i];
  return acc;
}
static __device__ __forceinline__ void sh9_eval(const EnvSplit& e, float x, float y, float z,
                                                float* rgb) {
  const float c1 = (float)0.4886025119029199;
  const float c2 = (float)1.0925484305920792;
  const float c3 = (float)0.31539156525252005;
  const float c4 = (float)0.5462742152960396;
  float b[9];
  b[0] = 0.0f;  // the first term is folded into the coefficient
  b[1] = c1 * y;
  b[2] = c1 * z;
  b[3] = c1 * x;
  b[4] = c2 * x * y;
  b[5] = c2 * y * z;
  b[6] = c3 * (3.0f * z * z - 1.0f);
  b[7] = c2 * x * z;
  b[8] = c4 * (x * x - y * y);
#pragma unroll
  for (int c = 0; c < 3; ++c) rgb[c] = sh9_channel(e.sh + 9 * c, b);
}

template <bool NEE, bool REFR, bool DOF, bool LEGACY, bool TILES, int ENV, bool SAMPLES>
__global__ void __launch_bounds__(PT_BLOCK, PT_MIN_BLOCKS)
    pt_megakernel(const __grid_constant__ Options o, const __grid_constant__ SceneTables sc,
                  const __grid_constant__ LightsArg<NEE> lt, const __grid_constant__ TilesArg<TILES> ta,
                  const __grid_constant__ EnvArg<ENV> env, float* __restrict__ out,
                  unsigned int* __restrict__ queue, unsigned long long* __restrict__ work,
                  int* __restrict__ owners) {
  static_assert(!(NEE && LEGACY), "nee requires gather_mode='light_only'");
  static_assert(ENV == 0 || !LEGACY, "an environment requires gather_mode='light_only'");
  static_assert(!(NEE && (ENV == 1 || ENV == 2)), "exact env excludes analytic NEE");
  static_assert(!(TILES && ENV >= 2), "the tile dispatch carries only exact env");
  static_assert(TILES || !SAMPLES, "sample-group items are the tile dispatch's");
  constexpr bool kExact = ENV == 1 || ENV == 2;
  constexpr bool kCarryPdf = NEE || ENV == 2;
  constexpr unsigned kFull = 0xffffffffu;
  // Under an environment map most paths end within two vertices: a lane
  // that starts its next sample at once leaves the warp's lanes at every
  // phase of the short path in every iteration, so each iteration runs every
  // branch (the primary hit, the scatter, the escape and its lookup). There
  // lanes wait until 12 of them start a sample together, which measured
  // 8-20% faster on the full-frame environment variants, and 4-14% slower on
  // the analytic ones and 6% slower on the tile dispatch, which start at
  // once (PERF.md).
  constexpr int kBatch = (ENV != 0 && !TILES) ? 12 : 1;
  const int lane_id = (int)(threadIdx.x & 31u);
  const unsigned lanes_below = (1u << lane_id) - 1u;
  const float* cam = sc.cam;
  const bool hoisted = !DOF && !o.antialias;
  // The material rows (and NEE's light rows) in shared memory: the lanes of
  // a warp read the rows of their own materials and light picks, which the
  // parameter bank serves one address at a time.
  __shared__ float s_mats[PT_MAX_MATERIALS * PT_MF];
  __shared__ LightRow s_lights[NEE ? PT_MAX_LIGHTS : 1];
  for (int i = threadIdx.x; i < PT_MAX_MATERIALS * PT_MF; i += PT_BLOCK) s_mats[i] = sc.mats[i];
  if constexpr (NEE) {
    for (int i = threadIdx.x; i < lt.count; i += PT_BLOCK) s_lights[i] = lt.rows[i];
  }
  // NEE: each warp's queue of light rays, field f of entry e at
  // lq[f * PT_QUEUE + e]; lqp[e] where its term goes, the pixel index p (with
  // SAMPLES its sample's unit; -1 - p once the ray is found occluded); per
  // lane, the entries it owns (bit e)
  constexpr int kQueue = NEE ? PT_QUEUE : 1;
  __shared__ float s_lq[PT_WARPS * PT_QF * kQueue];
  __shared__ int s_lqp[PT_WARPS * kQueue];
  __shared__ unsigned long long s_lown[NEE ? PT_BLOCK : 1];
  // ENV 3: the sun table, sized by the launcher (6 floats a sun and geom)
  extern __shared__ float s_sun[];
  if constexpr (ENV == 3) fill_sun_table(sc, env, s_sun);
  __syncthreads();
  const float* mats = s_mats;

  // the warp's chunk of the pixel queue: pixels q_next .. q_end-1 are still
  // to be handed out; drained once the queue has run past the last pixel
  int q_next = 0, q_end = 0;
  bool drained = false;

  // the lane's pixel: index p in the kernel's pixel order, its keys, the
  // sample s it is on and the sum of its settled samples; with SAMPLES the
  // end of the item's samples (s_end)
  bool has_px = false;
  int p = 0, s = 0, iter_base = 0, s_end = 0;
  uint32_t pid = 0u, tile_id = 0u;  // global pixel id py*W + px (LD lattice), hash tile
  HashPrng prng;
  prng.lane = 0u;
  prng.seed_mul = 0u;
  prng.counter = 0u;
  float acc_r = 0.0f, acc_g = 0.0f, acc_b = 0.0f;
  // Without jitter or lens the primary ray, and so its hit, is the same for
  // every sample of a pixel: traced once, at its first sample (the TPU
  // kernel's hoisted pre0).
  float bdx = 0.0f, bdy = 0.0f, bdz = 0.0f;
  HitT<REFR> h0{};
  h0.t = kMiss;

  // the lane's path: its ray, the hit in hand, the bounce it is at
  bool start = false;       // a sample of the lane's pixel is pending
  bool need_trace = false;  // the ray has no hit yet
  int depth = 0;
  float ox = 0.0f, oy = 0.0f, oz = 0.0f, dx = 0.0f, dy = 0.0f, dz = 0.0f;
  float cr = 1.0f, cg = 1.0f, cb = 1.0f;
  float rad_r = 0.0f, rad_g = 0.0f, rad_b = 0.0f;
  // solid-angle pdf of the lobe that produced the current ray (NEE's MIS
  // partner); -1 = primary ray or delta lobe
  float prev_pdf = -1.0f;
  HitT<REFR> h{};
  h.t = kMiss;
  // the sun rays cast at the lane's last vertex, traced with the next ray
  // from it
  SunVisT<ENV> vs{};

  unsigned long long cnt[PT_MEGA_WORK] = {};

  // SAMPLES: the tile dispatch's queue items are (pixel, sample group)
  // pairs, and each sample settles into a unit of its own, s * pixels +
  // pixel, which pt_fold_samples sums in sample order after the launch
  // the lane's sample is the first of its item
  auto first_sample = [&]() -> bool {
    if constexpr (SAMPLES) {
      return s == s_end - o.group;
    } else {
      return s == 0;
    }
  };
  // where the lane's current terms settle: its pixel, or its sample's unit
  auto unit = [&]() -> int { return SAMPLES ? s * o.pixels + p : p; };

  // NEE: the light ray the lane cast this iteration, staged in registers
  // until the warp queues it: direction, limit, term rgb and (SAMPLES) the
  // unit its term goes to, taken before the sample settles; its origin is
  // the lane's next origin, ox/oy/oz. (Staged in shared memory instead, it
  // measured 2% slower on K2, NVIDIA H100 80GB HBM3 at 700 W, PERF.md.)
  // Then the warp's queue: its oldest entry and the entries pending.
  bool l_cast = false;
  float lst[8] = {};
  int lq_head = 0, lq_count = 0;
  float* const lq = s_lq + (threadIdx.x >> 5) * PT_QF * kQueue;
  int* const lqp = s_lqp + (threadIdx.x >> 5) * kQueue;
  if constexpr (NEE) s_lown[threadIdx.x] = 0ull;

  // Test the n oldest queued light rays, lane i ray i, then add each lane's
  // unoccluded terms, oldest first: to its sum while it still renders the
  // ray's pixel (with SAMPLES, its sample), else to out[] at the entry's
  // index, which the lane wrote out itself. Every lane of the warp calls
  // it, with the same n (1-32).
  auto test_lights = [&](int n) {
    if (lane_id < n) {
      const int e = (lq_head + lane_id) & (PT_QUEUE - 1);
      if (occluded_any(sc, lq[0 * PT_QUEUE + e], lq[1 * PT_QUEUE + e], lq[2 * PT_QUEUE + e],
                       lq[3 * PT_QUEUE + e], lq[4 * PT_QUEUE + e], lq[5 * PT_QUEUE + e],
                       lq[6 * PT_QUEUE + e]))
        lqp[e] = -1 - lqp[e];
    }
    __syncwarp();
    // the pass's entries lq_head .. lq_head+n-1 (mod 64), rotated so that
    // bit i is entry lq_head + i
    const unsigned long long window = (1ull << n) - 1ull;
    const unsigned long long mine = s_lown[threadIdx.x];
    const unsigned long long rot =
        lq_head == 0 ? mine : ((mine >> lq_head) | (mine << (PT_QUEUE - lq_head)));
    s_lown[threadIdx.x] =
        mine & ~(lq_head == 0 ? window
                              : ((window << lq_head) | (window >> (PT_QUEUE - lq_head))));
    const int held = has_px ? unit() : -1;
    for (unsigned long long todo = rot & window; todo != 0ull; todo &= todo - 1ull) {
      const int e = (lq_head + __ffsll((long long)todo) - 1) & (PT_QUEUE - 1);
      const int pe = lqp[e];
      const int pix = pe >= 0 ? pe : -1 - pe;
      const bool late = pix != held;
      if (PT_MEGA_COUNTS && late) cnt[13] += 1ull;
      if (pe >= 0) {
        const float tr = lq[7 * PT_QUEUE + e], tg = lq[8 * PT_QUEUE + e],
                    tb = lq[9 * PT_QUEUE + e];
        if (late) {
          out[pix * 3 + 0] = out[pix * 3 + 0] + tr;
          out[pix * 3 + 1] = out[pix * 3 + 1] + tg;
          out[pix * 3 + 2] = out[pix * 3 + 2] + tb;
        } else {
          acc_r = acc_r + tr;
          acc_g = acc_g + tg;
          acc_b = acc_b + tb;
        }
      }
    }
    if (PT_MEGA_COUNTS && lane_id == 0) {
      cnt[10] += 1ull;
      cnt[11] += (unsigned long long)n;
      if (n < 32) cnt[12] += 1ull;
    }
    __syncwarp();
    lq_head = (lq_head + n) & (PT_QUEUE - 1);
    lq_count -= n;
  };

  // Lanes without a pixel take the next ones of the warp's chunk, in lane
  // order; when the chunk runs out, lane 0 takes the next 32 pixels of the
  // queue with one atomic. Every lane of the warp calls it.
  auto refill = [&]() {
    unsigned need = __ballot_sync(kFull, !has_px);
    while (need != 0u && !drained) {
      if (q_next == q_end) {
        int base = 0;
        if (lane_id == 0) base = (int)atomicAdd(queue, 32u);
        base = __shfl_sync(kFull, base, 0);
        if (base >= o.n) {
          drained = true;
          break;
        }
        if (PT_MEGA_COUNTS && lane_id == 0)
          owners[base >> 5] = (int)((blockIdx.x * PT_BLOCK + threadIdx.x) >> 5);
        q_next = base;
        q_end = min(base + 32, o.n);
      }
      const int avail = q_end - q_next;
      const int rank = __popc(need & lanes_below);
      if (((need >> lane_id) & 1u) && rank < avail) {
        p = q_next + rank;
        has_px = true;
        start = true;
        s = 0;
        acc_r = 0.0f;
        acc_g = 0.0f;
        acc_b = 0.0f;
        if constexpr (TILES) {
          if constexpr (SAMPLES) {
            // queue item i: pixel i % pixels, samples (i / pixels) * group ..
            const int item = p;
            p = item % o.pixels;
            s = (item / o.pixels) * o.group;
            s_end = s + o.group;
          }
          const int g = p / o.tile;
          pid = (uint32_t)((int)ta.py[p] * o.width + (int)ta.px[p]);
          tile_id = (uint32_t)ta.tiles[g];
          iter_base = ta.tiles[ta.k + g];
          prng.lane = (uint32_t)(p % o.tile);
        } else {
          pid = (uint32_t)(o.pixel_offset + p);
          tile_id = (uint32_t)(o.tile_base + p / o.tile);
          iter_base = o.iter_base;
          prng.lane = (uint32_t)(p % o.tile);
        }
      }
      q_next += min(__popc(need), avail);
      need = __ballot_sync(kFull, !has_px);
    }
  };

  refill();
  while (__any_sync(kFull, has_px)) {
    // lanes whose next sample is pending start it together, once kBatch of
    // them wait or no lane of the warp is inside a path
    const unsigned waiting = __ballot_sync(kFull, has_px && start);
    const bool go = __popc(waiting) >= kBatch ||
                    __ballot_sync(kFull, has_px && !start) == 0u;
    const bool active = has_px && (!start || go);
    // the counting build's visibility rays of this iteration: the light and
    // env rays that the lanes' vertices cast in it, and the sun rays that
    // their last vertices cast
    bool c_light = false, c_env = false;
    const unsigned c_sun = vs.mask;
    // the suns that some lane of the warp still has to test
    unsigned sun_union = 0u;
    if constexpr (ENV == 3) sun_union = __reduce_or_sync(kFull, vs.mask);
    if (active) {
      if (start) {
        // a new sample of the lane's pixel: its primary ray
        start = false;
        const uint32_t it = (uint32_t)(iter_base + s);
        depth = 0;
        // with the primary hit hoisted, only the item's first sample traces it
        need_trace = !hoisted || first_sample();
        if (need_trace) {
          float fx, fy;  // the pixel's coordinates
          if constexpr (TILES) {
            fx = ta.px[p];
            fy = ta.py[p];
          } else {
            fx = (float)((int)pid % o.width);
            fy = (float)((int)pid / o.width);
          }
          if (hoisted) {
            raygen(o, sc, fx, fy, &bdx, &bdy, &bdz);
          } else if (o.antialias) {
            float jx, jy;
            if (o.use_ld) {
              uint32_t s0, s1;
              sobol_rev_pair(it, &s0, &s1);
              jx = ld_u01(s0, ld_shift(pid, o.seed, 0u));
              jy = ld_u01(s1, ld_shift(pid, o.seed, 1u));
            } else {
              prng.reseed(mix4(o.seed, it, 0xAAu, tile_id));
              jx = prng.u01();
              jy = prng.u01();
            }
            raygen(o, sc, fx + jx, fy + jy, &dx, &dy, &dz);
          } else {
            // DOF: the lens stream; with antialias the 0xAA stream continues
            if (!o.use_ld) prng.reseed(mix4(o.seed, it, 0xD0Fu, tile_id));
            raygen(o, sc, fx, fy, &dx, &dy, &dz);
          }
        } else {
          h = h0;
        }
        if (hoisted) {
          dx = bdx;
          dy = bdy;
          dz = bdz;
        }
        ox = cam[0];
        oy = cam[1];
        oz = cam[2];
        if constexpr (DOF) {
          // thin lens (ops.camera.thin_lens): trace the pinhole ray to the
          // focal plane, move the origin to a concentric lens-disk sample,
          // re-aim at that point
          const float ct = dx * cam[3] + dy * cam[4] + dz * cam[5];
          const float ft = cam[15] / jmax(ct, 1e-6f);
          const float fpx = ox + dx * ft;
          const float fpy = oy + dy * ft;
          const float fpz = oz + dz * ft;
          float u1, u2;
          if (o.use_ld) {
            uint32_t s0, s1;
            sobol_rev_pair(it, &s0, &s1);
            u1 = ld_u01(s0, ld_shift(pid, o.seed, 2u));
            u2 = ld_u01(s1, ld_shift(pid, o.seed, 3u));
          } else {
            u1 = prng.u01();
            u2 = prng.u01();
          }
          const float rl = cam[14] * sqrtf(u1);
          const float th = 2.0f * kPi * u2;
          const float lx = rl * cosf(th);
          const float ly = rl * sinf(th);
          ox = ox + cam[6] * lx + cam[9] * ly;
          oy = oy + cam[7] * lx + cam[10] * ly;
          oz = oz + cam[8] * lx + cam[11] * ly;
          dx = fpx - ox;
          dy = fpy - oy;
          dz = fpz - oz;
          const float rn = rsqrt_exact(jmax(dx * dx + dy * dy + dz * dz, 1e-20f));
          dx = dx * rn;
          dy = dy * rn;
          dz = dz * rn;
        }
        cr = 1.0f;
        cg = 1.0f;
        cb = 1.0f;
        rad_r = 0.0f;
        rad_g = 0.0f;
        rad_b = 0.0f;
        prev_pdf = -1.0f;
      }
      if constexpr (ENV != 3) {
        if (need_trace) {
          h = trace<REFR, false>(sc, ox, oy, oz, dx, dy, dz, true, vs.mask, nullptr, 0, 0u);
          if (hoisted && depth == 0 && first_sample()) h0 = h;
        }
      } else {
        // the extension ray from the lane's vertex (if it has one) and the
        // sun rays that vertex cast, in one loop over the primitives; then
        // the terms of the unoccluded ones, suns 0 .. S-1, before anything
        // this vertex adds
        const unsigned cast = vs.mask;
        if (need_trace || cast != 0u) {
          const HitT<REFR> hit = trace<REFR, true>(sc, ox, oy, oz, dx, dy, dz, need_trace,
                                                   vs.mask, s_sun, env.num_suns, sun_union);
          if (need_trace) {
            h = hit;
            if (hoisted && depth == 0 && first_sample()) h0 = h;
          }
        }
        if (cast != 0u) {
          for (int k = 0; k < env.num_suns; ++k) {
            if ((vs.mask >> k) & 1u) {
              const float* sd = env.sun + 6 * k;
              const float cos_sun = vs.nx * sd[0] + vs.ny * sd[1] + vs.nz * sd[2];
              const float k_sun = vs.diffuse * kInvPi * jmax(cos_sun, 0.0f);
              rad_r = rad_r + vs.pr * k_sun * sd[3];
              rad_g = rad_g + vs.pg * k_sun * sd[4];
              rad_b = rad_b + vs.pb * k_sun * sd[5];
            }
          }
        }
        vs.mask = 0u;
      }
    }
    // the lane shades the hit in hand at its own depth; with the hit's
    // material read here, the counting build sees which lanes reach the
    // draws, and which of the two draw branches each takes
    const float* m = mats + h.mat * PT_MF;
    const float m_emit = m[8];
    // (ENV 3: the step that only tests a last vertex's sun rays reaches
    // nothing; the other variants leave the term out, as the tile variants
    // measured slower with it on an H100, PERF.md)
    const bool reach = active && (ENV != 3 || depth < o.trace_depth) && h.t < kMiss &&
                       !(m_emit > 0.0f);
    const bool ld_draws = o.use_ld && depth < o.n_ld;
    if (PT_MEGA_COUNTS) {
      const unsigned busy = __ballot_sync(kFull, active);
      const unsigned ld = __ballot_sync(kFull, reach && ld_draws);
      const unsigned hs = __ballot_sync(kFull, reach && !ld_draws);
      if (lane_id == 0) {
        cnt[0] += 1ull;
        cnt[1] += (unsigned long long)__popc(busy);
        if (ld != 0u && hs != 0u) cnt[2] += 1ull;
      }
    }
    if (active) {
      bool ended = true;  // the path ends at this vertex
      if (ENV == 3 && depth == o.trace_depth) {
        // the sun rays of the path's last vertex, traced above: the path
        // ends with them
      } else if (h.t >= kMiss) {
        if constexpr (kExact) {
          // the escape is settled with the sample, below, from the path's
          // throughput, direction and lobe pdf as they stand here
        } else if constexpr (ENV == 3) {
          // SH-9 residual sky, clamped at 0; with the background composited
          // outside the kernel, depth-0 misses add nothing
          if (!(env.bg_external && depth == 0)) {
            float s3[3];
            sh9_eval(env, dx, dy, dz, s3);
            rad_r = rad_r + cr * jmax(s3[0], 0.0f);
            rad_g = rad_g + cg * jmax(s3[1], 0.0f);
            rad_b = rad_b + cb * jmax(s3[2], 0.0f);
          }
        } else if constexpr (LEGACY) {
          // reference quirk (megakernel.py:1338-1341 has no alive mask): an
          // escaped path re-misses on its kept ray at every later depth and
          // takes the sky's tint again each time, one multiply per depth
          float sky_r, sky_g, sky_b;
          sky(dy, &sky_r, &sky_g, &sky_b);
          for (int k = depth; k < o.trace_depth; ++k) {
            cr = cr * sky_r;
            cg = cg * sky_g;
            cb = cb * sky_b;
          }
        } else if (o.sky_strength != 0.0f) {
          float sky_r, sky_g, sky_b;
          sky(dy, &sky_r, &sky_g, &sky_b);
          rad_r = rad_r + cr * sky_r * o.sky_strength;
          rad_g = rad_g + cg * sky_g * o.sky_strength;
          rad_b = rad_b + cb * sky_b * o.sky_strength;
        }
      } else if (m_emit > 0.0f) {  // emissive termination
        const float m_cr = m[0], m_cg = m[1], m_cb = m[2];
        if constexpr (LEGACY) {
          cr = cr * m_cr * m_emit;
          cg = cg * m_cg * m_emit;
          cb = cb * m_cb * m_emit;
        } else if constexpr (NEE) {
          const float w_emit = emit_mis_weight(lt, h, dx, dy, dz, prev_pdf);
          rad_r = rad_r + cr * m_cr * m_emit * w_emit;
          rad_g = rad_g + cg * m_cg * m_emit * w_emit;
          rad_b = rad_b + cb * m_cb * m_emit * w_emit;
        } else {
          rad_r = rad_r + cr * m_cr * m_emit;
          rad_g = rad_g + cg * m_cg * m_emit;
          rad_b = rad_b + cb * m_cb * m_emit;
        }
      } else {
        const float m_cr = m[0], m_cg = m[1], m_cb = m[2];
        // draws: u_rr (past rr_start_depth, hash stream), branch, u_a, u_b,
        // then NEE's light pick (only with several lights) and surface pair
        float u_rr = 0.0f, u_branch, u_a, u_b;
        float u_l0 = 0.0f, u_l1 = 0.0f, u_l2 = 0.0f;
        const bool rr = depth > o.rr_start_depth;
        const uint32_t it = (uint32_t)(iter_base + s);
        if (ld_draws) {
          uint32_t s0, s1;
          ld_rev_components(it, depth, pid, o.seed, &s0, &s1);
          if (rr) {
            prng.reseed(mix4(o.seed, it, (uint32_t)depth, tile_id));
            u_rr = prng.u01();
          }
          u_branch = ld_u01(s0, ld_shift(pid, o.seed, ld_bounce_tag(depth, 0)));
          u_a = ld_u01(s0, ld_shift(pid, o.seed, ld_bounce_tag(depth, 1)));
          u_b = ld_u01(s1, ld_shift(pid, o.seed, ld_bounce_tag(depth, 2)));
          if constexpr (NEE) {
            if (lt.count > 1) u_l0 = ld_u01(s0, ld_shift(pid, o.seed, ld_nee_tag(depth, 0)));
            u_l1 = ld_u01(s0, ld_shift(pid, o.seed, ld_nee_tag(depth, 1)));
            u_l2 = ld_u01(s1, ld_shift(pid, o.seed, ld_nee_tag(depth, 2)));
          }
        } else {
          prng.reseed(mix4(o.seed, it, (uint32_t)depth, tile_id));
          if (rr) u_rr = prng.u01();
          u_branch = prng.u01();
          u_a = prng.u01();
          u_b = prng.u01();
          if constexpr (NEE) {
            if (lt.count > 1) u_l0 = prng.u01();
            u_l1 = prng.u01();
            u_l2 = prng.u01();
          }
        }

        // Russian roulette with the 1/p boost
        const float p_cont = jmax(m_cr, jmax(m_cg, m_cb));
        if (!(rr && u_rr > p_cont)) {
          ended = false;
          if (rr) {
            const float boost = 1.0f / jmax(p_cont, 1e-12f);
            cr = cr * boost;
            cg = cg * boost;
            cb = cb * boost;
          }
          // scatter: one shared azimuth, one frame around the selected axis
          const float nx = h.nx, ny = h.ny, nz = h.nz;
          const float m_refl = m[6], m_refr = m[7];
          const bool spec = (m_refl > 0.0f) && (u_branch < m_refl);
          const float ddn = dx * nx + dy * ny + dz * nz;
          const float ph2 = 2.0f * kPi * u_b;
          const float cp2 = cosf(ph2);
          const float sp2 = sinf(ph2);
          float vax, vay, vaz, s_pol, c_pol, t_r, t_g, t_b;
          if (spec) {
            vax = dx - 2.0f * ddn * nx;
            vay = dy - 2.0f * ddn * ny;
            vaz = dz - 2.0f * ddn * nz;
            const float ang = (1.0f - m_refr) * u_a * kHalfPi;
            s_pol = sinf(ang);
            c_pol = cosf(ang);
            t_r = m[3];
            t_g = m[4];
            t_b = m[5];
          } else {
            vax = nx;
            vay = ny;
            vaz = nz;
            s_pol = sqrtf(u_a);
            c_pol = sqrtf(jmax(1.0f - u_a, 0.0f));
            t_r = m_cr;
            t_g = m_cg;
            t_b = m_cb;
          }
          const bool use_a = fabsf(vax) > fabsf(vay);
          float tx = use_a ? vaz : 0.0f;
          float ty = use_a ? 0.0f : -vaz;
          float tz = use_a ? -vax : vay;
          const float rt = rsqrt_exact(jmax(tx * tx + ty * ty + tz * tz, 1e-20f));
          tx = tx * rt;
          ty = ty * rt;
          tz = tz * rt;
          const float bxv = vay * tz - vaz * ty;
          const float byv = vaz * tx - vax * tz;
          const float bzv = vax * ty - vay * tx;
          const float scp = s_pol * cp2;
          const float ssp = s_pol * sp2;
          float ndx = tx * scp + vax * c_pol + bxv * ssp;
          float ndy = ty * scp + vay * c_pol + byv * ssp;
          float ndz = tz * scp + vaz * c_pol + bzv * ssp;

          float off = kOriginOffset;
          bool glass = false;
          if constexpr (REFR) {
            // dielectric transmission (Snell + Schlick), as ops.fast.shade_soa
            const float m_ior = m[9];
            if ((m_ior > 0.0f) && (m_refr > 0.0f)) {
              glass = true;
              const float cos_i = jmin(jmax(-ddn, 0.0f), 1.0f);
              const float n1 = h.out ? 1.0f : m_ior;
              const float n2 = h.out ? m_ior : 1.0f;
              const float eta = n1 * (1.0f / jmax(n2, 1e-6f));
              const float sin2_t = eta * eta * jmax(1.0f - cos_i * cos_i, 0.0f);
              const bool tir = sin2_t > 1.0f;
              const float cos_t = sqrtf(jmax(1.0f - sin2_t, 0.0f));
              float r0 = (n1 - n2) * (1.0f / (n1 + n2));
              r0 = r0 * r0;
              const float omc = 1.0f - cos_i;
              const float omc2 = omc * omc;
              const float fres = r0 + (1.0f - r0) * omc2 * omc2 * omc;
              if (!tir && (u_branch >= fres)) {  // transmit
                const float coef = eta * cos_i - cos_t;
                const float fxr = eta * dx + coef * nx;
                const float fyr = eta * dy + coef * ny;
                const float fzr = eta * dz + coef * nz;
                const float rnr = rsqrt_exact(jmax(fxr * fxr + fyr * fyr + fzr * fzr, 1e-20f));
                ndx = fxr * rnr;
                ndy = fyr * rnr;
                ndz = fzr * rnr;
                t_r = m_cr;
                t_g = m_cg;
                t_b = m_cb;
                off = -kOriginOffset;
              } else {  // reflect
                ndx = dx - 2.0f * ddn * nx;
                ndy = dy - 2.0f * ddn * ny;
                ndz = dz - 2.0f * ddn * nz;
                t_r = m[3];
                t_g = m[4];
                t_b = m[5];
              }
            }
          }

          const float hx = ox + h.t * dx + nx * off;
          const float hy = oy + h.t * dy + ny * off;
          const float hz = oz + h.t * dz + nz * off;

          if constexpr (NEE) {
            // direct light at this vertex: the diffuse lobe (1 - P_spec) albedo/pi
            // with the post-RR, pre-tint throughput, MIS-weighted against the
            // BRDF sample (w_emit above); glass is opaque to the shadow ray
            if (!glass) {
              const int nl = lt.count;
              const int pick = nl > 1 ? min((int)(u_l0 * (float)nl), nl - 1) : 0;
              const LightRow& l = s_lights[pick];
              float lp[3], ln[3], pdf_a;
              sample_light(l, u_l1, u_l2, lp, ln, &pdf_a);
              const float tox = lp[0] - hx, toy = lp[1] - hy, toz = lp[2] - hz;
              const float d2 = tox * tox + toy * toy + toz * toz;
              const float dist = sqrtf(jmax(d2, 1e-24f));
              const float rdist = 1.0f / dist;
              const float wix = tox * rdist, wiy = toy * rdist, wiz = toz * rdist;
              const float cos_s = nx * wix + ny * wiy + nz * wiz;
              const float cos_l2 = -(ln[0] * wix + ln[1] * wiy + ln[2] * wiz);
              if ((cos_s > 0.0f) && (cos_l2 > 0.0f) && (dist > 1e-4f)) {
                // the ray and its term wait in the warp's queue (above)
                const float diffuse_prob = 1.0f - m_refl;
                const float p_brdf_area = diffuse_prob * jmax(cos_s, 0.0f) * kInvPi *
                                          jmax(cos_l2, 0.0f) * (1.0f / jmax(d2, 1e-12f));
                const float w_mis = pdf_a * (1.0f / jmax(pdf_a + p_brdf_area, 1e-20f));
                const float geomf = cos_s * cos_l2 * (1.0f / jmax(d2 * pdf_a, 1e-20f));
                const float k_d = diffuse_prob * kInvPi * geomf * w_mis;
                l_cast = true;
                c_light = true;
                lst[0] = wix;
                lst[1] = wiy;
                lst[2] = wiz;
                lst[3] = dist - jmax(1e-3f, 1e-3f * dist);
                lst[4] = cr * m_cr * k_d * l.le[0];
                lst[5] = cg * m_cg * k_d * l.le[1];
                lst[6] = cb * m_cb * k_d * l.le[2];
                if constexpr (SAMPLES) lst[7] = __int_as_float(unit());
              }
            }
          }

          if constexpr (ENV == 2) {
            // environment light at this vertex (K4): the shared alias-sampled
            // direction of row (sample, depth), a shadow ray to 1e7 and the
            // balance heuristic against the diffuse lobe
            if (!glass) {
              const float* row = env.rows + (s * o.trace_depth + depth) * (8 + 6 * sc.num_geoms);
              const float ewx = __ldg(row + 0), ewy = __ldg(row + 1), ewz = __ldg(row + 2);
              const float ecos = nx * ewx + ny * ewy + nz * ewz;
              if (PT_MEGA_COUNTS) c_env = ecos > 0.0f;
              if ((ecos > 0.0f) && !occluded_row(sc, hx, hy, hz, row + 8, 1e7f)) {
                const float e_pdf = __ldg(row + 6);
                const float ediff = 1.0f - m_refl;
                const float e_pb = ediff * jmax(ecos, 0.0f) * kInvPi;
                const float e_w = e_pdf / jmax(e_pdf + e_pb, 1e-20f);
                const float e_k = ediff * kInvPi * jmax(ecos, 0.0f) / jmax(e_pdf, 1e-20f) * e_w;
                rad_r = rad_r + cr * m_cr * e_k * __ldg(row + 3);
                rad_g = rad_g + cg * m_cg * e_k * __ldg(row + 4);
                rad_b = rad_b + cb * m_cb * e_k * __ldg(row + 5);
              }
            }
          }

          if constexpr (kCarryPdf) {
            // diffuse extension rays carry (1 - P) cos/pi, delta lobes -1
            const float cos_new = jmax(ndx * nx + ndy * ny + ndz * nz, 0.0f);
            prev_pdf = (!spec && !glass) ? (1.0f - m_refl) * cos_new * kInvPi : -1.0f;
          }

          if constexpr (ENV == 3) {
            // delta suns (K5) at the diffuse lobe: a visibility ray toward
            // each sun above the normal, tested with the next ray from this
            // vertex (the trace slot above); no draw, no MIS
            if (!glass) {
              unsigned mask = 0u;
              for (int k = 0; k < env.num_suns; ++k) {
                const float* sd = env.sun + 6 * k;
                if (nx * sd[0] + ny * sd[1] + nz * sd[2] > 0.0f) mask |= 1u << k;
              }
              vs.mask = mask;
              vs.pr = cr * m_cr;
              vs.pg = cg * m_cg;
              vs.pb = cb * m_cb;
              vs.diffuse = 1.0f - m_refl;
              vs.nx = nx;
              vs.ny = ny;
              vs.nz = nz;
            }
          }

          cr = cr * t_r;
          cg = cg * t_g;
          cb = cb * t_b;
          ox = hx;
          oy = hy;
          oz = hz;
          dx = ndx;
          dy = ndy;
          dz = ndz;
        }
      }
      if (!ended) {
        depth += 1;
        if constexpr (ENV == 3) {
          need_trace = depth < o.trace_depth;
          // sun rays cast at the path's last vertex take one more iteration
          ended = !need_trace && vs.mask == 0u;
        } else {
          need_trace = true;
          ended = depth == o.trace_depth;
        }
      }
      if (ended) {
        // settle the sample: acc + rad (LEGACY: + the terminal throughput,
        // `pathtrace.cu:439-444`), then, for a path that ended by escaping
        // the exact environment, + throughput * L(escape), with the path's
        // throughput, direction and lobe pdf as they stood at the miss
        float sr, sg, sb;
        if constexpr (LEGACY) {
          sr = cr;
          sg = cg;
          sb = cb;
        } else {
          sr = rad_r;
          sg = rad_g;
          sb = rad_b;
        }
        const bool escaped = kExact && h.t >= kMiss;
        float er = 0.0f, eg = 0.0f, eb = 0.0f;
        if constexpr (kExact) {
          if (escaped) {
            float le[3], pe = 0.0f;
            env_lookup<ENV == 2>(env, dx, dy, dz, le, &pe);
            if constexpr (ENV == 2) {
              // balance heuristic against env NEE (prev_pdf < 0: primary,
              // specular or glass escape); an exact reciprocal where the TPU
              // kernel takes its approximate one
              float wmis = 1.0f;
              if (prev_pdf >= 0.0f) wmis = prev_pdf * (1.0f / jmax(prev_pdf + pe, 1e-20f));
              er = cr * le[0] * wmis;
              eg = cg * le[1] * wmis;
              eb = cb * le[2] * wmis;
            } else {
              er = cr * le[0];
              eg = cg * le[1];
              eb = cb * le[2];
            }
          }
        }
        // With the primary hit hoisted, a path that ends at depth 0 (a miss
        // or an emitter, before any draw) ends so in every sample of the
        // pixel, with the same radiance: the lane settles them all here, one
        // after the other in the same expressions, and its pixel is done.
        const int s_last = SAMPLES ? s_end : o.num_samples;
        const int repeat = (hoisted && depth == 0 && !reach) ? s_last - s : 1;
        if constexpr (SAMPLES) {
          // each sample's unit: the terms the light queue added while it
          // ran, then its path's; beside them, an exact environment's
          // escape term, which the fold adds next
          for (int k = 0; k < repeat; ++k) {
            const int u = (s + k) * o.pixels + p;
            if constexpr (kExact) {
              out[u * 6 + 0] = acc_r + sr;
              out[u * 6 + 1] = acc_g + sg;
              out[u * 6 + 2] = acc_b + sb;
              out[u * 6 + 3] = escaped ? er : 0.0f;
              out[u * 6 + 4] = escaped ? eg : 0.0f;
              out[u * 6 + 5] = escaped ? eb : 0.0f;
            } else {
              out[u * 3 + 0] = acc_r + sr;
              out[u * 3 + 1] = acc_g + sg;
              out[u * 3 + 2] = acc_b + sb;
            }
            acc_r = 0.0f;
            acc_g = 0.0f;
            acc_b = 0.0f;
          }
        } else {
          for (int k = 0; k < repeat; ++k) {
            acc_r = acc_r + sr;
            acc_g = acc_g + sg;
            acc_b = acc_b + sb;
            if (escaped) {
              acc_r = acc_r + er;
              acc_g = acc_g + eg;
              acc_b = acc_b + eb;
            }
          }
        }
        s += repeat;
        if (s == s_last) {
          if constexpr (!SAMPLES) {
            out[p * 3 + 0] = acc_r;
            out[p * 3 + 1] = acc_g;
            out[p * 3 + 2] = acc_b;
          }
          has_px = false;
        } else {
          start = true;
        }
      }
    }
    if (PT_MEGA_COUNTS && (NEE || ENV >= 2)) {
      const unsigned bl = __ballot_sync(kFull, c_light);
      const unsigned be = __ballot_sync(kFull, c_env);
      const unsigned bs = __ballot_sync(kFull, c_sun != 0u);
      if (lane_id == 0) {
        cnt[3] += bl != 0u ? 1ull : 0ull;
        cnt[4] += be != 0u ? 1ull : 0ull;
        cnt[5] += bs != 0u ? 1ull : 0ull;
        cnt[6] += (unsigned long long)__popc(bs);
      }
      cnt[7] += c_light ? 1ull : 0ull;
      cnt[8] += c_env ? 1ull : 0ull;
      cnt[9] += (unsigned long long)__popc(c_sun);
    }
    if constexpr (NEE) {
      // the iteration's light rays join the warp's queue in lane order, from
      // the vertex that cast them (the lane's origin now); a full pass's
      // worth of pending rays is tested at once
      const unsigned cast = __ballot_sync(kFull, l_cast);
      if (cast != 0u) {
        if (l_cast) {
          const int e = (lq_head + lq_count + __popc(cast & lanes_below)) & (PT_QUEUE - 1);
          lq[0 * PT_QUEUE + e] = ox;
          lq[1 * PT_QUEUE + e] = oy;
          lq[2 * PT_QUEUE + e] = oz;
#pragma unroll
          for (int f = 0; f < 7; ++f) lq[(3 + f) * PT_QUEUE + e] = lst[f];
          lqp[e] = SAMPLES ? __float_as_int(lst[7]) : p;
          s_lown[threadIdx.x] |= 1ull << e;
          l_cast = false;
        }
        lq_count += __popc(cast);
        __syncwarp();
        if (lq_count >= 32) test_lights(32);
      }
    }
    refill();
  }
  // the light rays still queued, in one last pass
  if constexpr (NEE) {
    if (lq_count > 0) test_lights(lq_count);
  }
  if (PT_MEGA_COUNTS) {
    for (int k = 0; k < PT_MEGA_WORK; ++k)
      if (cnt[k]) atomicAdd(work + k, cnt[k]);
  }
}

// The tile dispatch with its samples split over items: each pixel's sum of
// its per-sample units (3 floats, or 6 with the exact environment's escape
// term after the path's), in ascending sample order: the adds of a lane's
// running sum, and of the plain version's, in the same order.
__global__ void pt_fold_samples(const float* __restrict__ units, float* __restrict__ out,
                                int pixels, int samples, int stride) {
  const int i = (int)(blockIdx.x * blockDim.x + threadIdx.x);
  if (i >= pixels * 3) return;
  const int q = i / 3, c = i - 3 * q;
  float acc = 0.0f;
  for (int s = 0; s < samples; ++s) {
    const float* u = units + ((size_t)s * pixels + q) * stride;
    acc = acc + u[c];
    if (stride == 6) acc = acc + u[3 + c];
  }
  out[i] = acc;
}

// The launch's scratch: the pixel queue's counter (zeroed on the stream
// before each launch), and in the counting build its counters and the warp
// that took each chunk of 32 pixels.
struct Queue {
  unsigned int* queue;
  unsigned long long* work;
  int* owners;
};

template <bool NEE, bool REFR, bool DOF, bool LEGACY, bool TILES, int ENV, bool SAMPLES>
static int launch_variant(const Options& o, const SceneTables& t, const LightTable& lights,
                          const TileArgs& tiles, const EnvExact& exact, const EnvSplit& split,
                          float* out, float* units, const Queue& q, cudaStream_t stream) {
  LightsArg<NEE> lt;
  TilesArg<TILES> ta;
  EnvArg<ENV> env;
  if constexpr (NEE) lt = lights;
  if constexpr (TILES) ta = tiles;
  if constexpr (ENV == 1 || ENV == 2) env = exact;
  if constexpr (ENV == 3) env = split;
  // a persistent grid: as many blocks as the card holds at once (fewer for a
  // small frame), each warp taking pixels from the queue until it runs dry
  auto kernel = pt_megakernel<NEE, REFR, DOF, LEGACY, TILES, ENV, SAMPLES>;
  // ENV 3: the sun table in dynamic shared memory (48 KB at 32 suns and 64
  // geoms; past the default 48 KB a block only by opting in, which fails,
  // and the launch with it, where the card cannot hold the table)
  const int smem = ENV == 3 ? (int)sizeof(float) * 6 * split.num_suns * t.num_geoms : 0;
  int device = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess && ENV == 3)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, PT_BLOCK, smem);
  if (err == cudaSuccess) err = cudaMemsetAsync(q.queue, 0, sizeof(unsigned int), stream);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidValue;
  const int blocks = min(per_sm * sms, (o.n + PT_BLOCK - 1) / PT_BLOCK);
  kernel<<<blocks, PT_BLOCK, smem, stream>>>(o, t, lt, ta, env, SAMPLES ? units : out, q.queue,
                                             q.work, q.owners);
  err = cudaGetLastError();
  if (err != cudaSuccess || !SAMPLES) return (int)err;
  const int stride = (ENV == 1 || ENV == 2) ? 6 : 3;
  pt_fold_samples<<<(o.pixels * 3 + 255) / 256, 256, 0, stream>>>(units, out, o.pixels,
                                                                  o.num_samples, stride);
  return (int)cudaGetLastError();
}

// Variant bits: 1 NEE, 2 REFR, 4 DOF, 8 LEGACY, 16 TILES, ENV in bits 5-6;
// a tile variant comes twice, with whole-pixel and with sample-group items
// (SAMPLES).
constexpr bool valid_variant(int f) {
  const bool nee = (f & 1) != 0, legacy = (f & 8) != 0, tiles = (f & 16) != 0;
  const int env = f >> 5;
  return !(nee && legacy) && !(env != 0 && legacy) && !(nee && (env == 1 || env == 2)) &&
         !(tiles && env >= 2);
}

template <int F>
static int launch_flags(int flags, bool samples, const Options& o, const SceneTables& t,
                        const LightTable& lights, const TileArgs& tiles, const EnvExact& exact,
                        const EnvSplit& split, float* out, float* units, const Queue& q,
                        cudaStream_t stream) {
  if constexpr (valid_variant(F)) {
    if (flags == F) {
      if constexpr ((F & 16) != 0) {
        if (samples)
          return launch_variant<(F & 1) != 0, (F & 2) != 0, (F & 4) != 0, (F & 8) != 0, true,
                                (F >> 5), true>(o, t, lights, tiles, exact, split, out, units,
                                                q, stream);
      }
      return launch_variant<(F & 1) != 0, (F & 2) != 0, (F & 4) != 0, (F & 8) != 0,
                            (F & 16) != 0, (F >> 5), false>(o, t, lights, tiles, exact, split,
                                                            out, units, q, stream);
    }
  }
  if constexpr (F + 1 < 128) {
    return launch_flags<F + 1>(flags, samples, o, t, lights, tiles, exact, split, out, units, q,
                               stream);
  } else {
    return (int)cudaErrorInvalidValue;
  }
}

// The blocks of the variant the flags name that one SM holds at once
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor) with `smem` bytes of
// dynamic shared memory; -1 on an error.
template <int F>
static int blocks_flags(int flags, int smem) {
  if constexpr (valid_variant(F)) {
    if (flags == F) {
      auto kernel = pt_megakernel<(F & 1) != 0, (F & 2) != 0, (F & 4) != 0, (F & 8) != 0,
                                  (F & 16) != 0, (F >> 5), false>;
      int per_sm = 0;
      if (cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem) !=
              cudaSuccess ||
          cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, PT_BLOCK, smem) !=
              cudaSuccess)
        return -1;
      return per_sm;
    }
  }
  if constexpr (F + 1 < 128) {
    return blocks_flags<F + 1>(flags, smem);
  } else {
    return -1;
  }
}

extern "C" int pt_megakernel_blocks_per_sm(int flags, int smem) {
  return blocks_flags<0>(flags, smem);
}

// Packs the scene and light tables into the kernel's by-value parameters and
// launches the variant the flags name on `stream`; returns the CUDA error
// code (0 = launched). Host pointers, read before this returns: cam[16],
// geo[num_geoms*21], mats[num_materials*10], gmat[num_geoms],
// perm[num_geoms*3], lights[num_lights*26], light_ids[num_lights*2]
// (kind, material), suns[num_suns*6], sh[27]. Without tiles the launch
// renders the n pixels pixel_offset .. pixel_offset+n-1 of the frame, their
// hash tiles numbered from tile_base (both 0 with tiles). Device pointers, with
// num_tiles > 0 (then n = num_tiles * tile): tiles[2*num_tiles], px[n],
// py[n], and with group < num_samples (a divisor of it: the samples of a
// queue item) units[num_samples*n*3] (*6 with env_mode 1), which the kernel
// writes and pt_fold_samples sums into out; with env_mode 1-2 (exact, exact
// + env NEE): env_tex[env_h*env_w*4] (the texels, EnvExact; 16-byte
// aligned, env_h*env_w*4 < 2^31), with 2 also
// env_rows[num_samples*trace_depth*(8 + 6*num_geoms)] (pt_env_rows_launch's).
// env_mode 3 is the split mode (suns, SH, bg_external). `queue` is one
// device counter that no launch on another stream uses meanwhile (zeroed on
// `stream` here); `work` (PT_MEGA_WORK counters, zeroed by the caller) and
// `owners[ceil(items/32)]` (items: the queue's, n or n * num_samples /
// group) are the counting build's and null in any other.
extern "C" int pt_megakernel_launch(
    float* out, int n, int width, int height, int seed, int iter_base, int pixel_offset,
    int tile_base, int tile, int num_samples, int trace_depth,
    int rr_start_depth, int antialias, int use_ld, int n_ld, float sky_strength,
    int nee, int refraction, int dof, int legacy,
    const float* cam, const float* geo, const float* mats, const int* gmat,
    const int* perm, int num_cubes, int num_geoms, int num_materials,
    const float* lights, const int* light_ids, int num_lights,
    const int* tiles, const float* px, const float* py, int num_tiles, int group,
    float* units, int env_mode, const float* env_tex, const float* env_rows, int env_h,
    int env_w, const float* suns, int num_suns, const float* sh, int bg_external,
    unsigned int* queue, unsigned long long* work, int* owners, void* stream) {
  if (n < 0 || width <= 0 || height <= 0 || tile <= 0 || num_geoms < 0 ||
      num_geoms > PT_MAX_GEOMS || num_materials <= 0 ||
      num_materials > PT_MAX_MATERIALS || num_cubes < 0 || num_cubes > num_geoms ||
      (nee && legacy) || (nee && (num_lights <= 0 || num_lights > PT_MAX_LIGHTS || !lights ||
                                  !light_ids)) ||
      num_tiles < 0 || (num_tiles > 0 && (!tiles || !px || !py || n != num_tiles * tile)) ||
      pixel_offset < 0 || tile_base < 0 ||
      (num_tiles > 0 && (pixel_offset != 0 || tile_base != 0)) ||
      (num_tiles == 0 && (long long)pixel_offset + n > (long long)width * height) ||
      (num_tiles > 0 && num_samples > 0 &&
       (group <= 0 || group > num_samples || num_samples % group != 0 ||
        (group < num_samples && (!units || (long long)n * num_samples > 0x7fffffffLL)))) ||
      env_mode < 0 || env_mode > 3 ||
      ((env_mode == 1 || env_mode == 2) &&
       (!env_tex || ((uintptr_t)env_tex & 15u) != 0 || env_h <= 0 || env_w <= 0 ||
        (long long)env_h * env_w * 4 > 0x7fffffffLL)) ||
      (env_mode == 2 && !env_rows) ||
      (env_mode == 3 && (num_suns < 0 || num_suns > PT_MAX_SUNS || (num_suns > 0 && !suns) ||
                         !sh)) ||
      trace_depth < 1 || !queue || (work != nullptr) != PT_MEGA_COUNTS ||
      (owners != nullptr) != PT_MEGA_COUNTS) {
    return (int)cudaErrorInvalidValue;
  }
  const int flags = (nee ? 1 : 0) | (refraction ? 2 : 0) | (dof ? 4 : 0) | (legacy ? 8 : 0) |
                    (num_tiles > 0 ? 16 : 0) | (env_mode << 5);
  const bool samples = num_tiles > 0 && group < num_samples;
  if (n == 0 || num_samples <= 0) return 0;
  SceneTables t;
  memset(&t, 0, sizeof(t));
  memcpy(t.cam, cam, sizeof(t.cam));
  memcpy(t.geo, geo, sizeof(float) * (size_t)num_geoms * PT_GF);
  memcpy(t.mats, mats, sizeof(float) * (size_t)num_materials * PT_MF);
  memcpy(t.gmat, gmat, sizeof(int) * (size_t)num_geoms);
  memcpy(t.perm, perm, sizeof(int) * (size_t)num_geoms * 3);
  t.num_cubes = num_cubes;
  t.num_geoms = num_geoms;
  LightTable lt;
  memset(&lt, 0, sizeof(lt));
  if (nee) {
    for (int i = 0; i < num_lights; ++i) {
      const float* f = lights + i * PT_LF;
      LightRow& r = lt.rows[i];
      memcpy(r.a, f, sizeof(r.a));
      memcpy(r.tr, f + 9, sizeof(r.tr));
      memcpy(r.ait, f + 12, sizeof(r.ait));
      r.det = f[21];
      memcpy(r.le, f + 22, sizeof(r.le));
      r.pdf = f[25];
      r.kind = light_ids[i * 2 + 0];
      r.mat = light_ids[i * 2 + 1];
    }
    lt.count = num_lights;
  }
  TileArgs ta = {tiles, px, py, num_tiles};
  EnvExact exact = {reinterpret_cast<const float4*>(env_tex), env_rows, env_h, env_w};
  EnvSplit split;
  memset(&split, 0, sizeof(split));
  if (env_mode == 3) {
    if (num_suns > 0) memcpy(split.sun, suns, sizeof(float) * (size_t)num_suns * 6);
    memcpy(split.sh, sh, sizeof(split.sh));
    split.num_suns = num_suns;
    split.bg_external = bg_external;
  }
  Options o;
  o.n = num_tiles > 0 ? n * (num_samples / group) : n;
  o.pixels = n;
  o.group = num_tiles > 0 ? group : num_samples;
  o.width = width;
  o.height = height;
  o.seed = (uint32_t)seed;
  o.iter_base = iter_base;
  o.pixel_offset = pixel_offset;
  o.tile_base = tile_base;
  o.tile = tile;
  o.num_samples = num_samples;
  o.trace_depth = trace_depth;
  o.rr_start_depth = rr_start_depth;
  o.antialias = antialias;
  o.use_ld = use_ld;
  o.n_ld = n_ld;
  o.sky_strength = sky_strength;
  const Queue q = {queue, work, owners};
  return launch_flags<0>(flags, samples, o, t, lt, ta, exact, split, out, units, q,
                         (cudaStream_t)stream);
}

// Env NEE's rows (K4's row table; the TPU path computes them in one jitted
// XLA function, _build_env_nee_rows, megakernel.py:2200-2225, which the
// port first ran as some 250 eager torch kernels a step). One thread per
// row r = s * depth + d, in uint32 and f32 as ops.cuda.megakernel
// .build_env_nee_rows computes it with torch on the card:
//   - the uniforms of jax.random.uniform(fold_in(PRNGKey(seed ^
//     0xE17B0075), iter_base + s), (depth, 2)) at counters 2d and 2d + 1
//     (threefry-2x32, the jax_threefry_partitionable layout);
//   - past 2^15 texels the alias cell's words, rng.cell_words of that key;
//   - the alias draw of ops.envmap.sample_env and the bilinear
//     ops.envmap.env_radiance of the drawn direction, each operation rounded
//     on its own (-fmad=false) with the same CUDA math library's acosf,
//     atan2f, sinf and cosf as torch; where torch divides by a Python
//     number it multiplies by that number's float reciprocal, and so does
//     this kernel;
//   - then per geom the direction's dir_entry, which the env ray's test
//     reads (occluded_row).
// Bound: a few hundred integer and float operations and 32-128 bytes a row,
// so at 400-1,600 rows a launch the launch itself, microseconds, sets the
// time; the point is one launch where torch needed hundreds.
struct EnvRowArgs {
  const float* img;         // [h, w, 3] radiance, not strength-folded
  const float* alias_prob;  // [h * w]
  const int* alias_idx;     // [h * w]
  const float* pdf;         // [h * w]
  const float* strength;    // the map's strength, a device scalar
  int h, w, rows, depth;
  uint32_t key;        // uint32(seed) ^ 0xE17B0075
  uint32_t iter_base;  // absolute iteration of sample 0
  // the Python constants of the torch code, rounded to float as torch does
  float f_max;       // 1 - 1e-7
  float x_max;       // 1 - 1e-6
  float inv_w;       // 1 / float(w): torch's x / w on the card
  float pi_h;        // pi / h
  float two_pi;      // 2 pi
  float inv_two_pi;  // 1 / (2 pi)
  float inv_pi;      // 1 / pi
};

// ops.envmap.ENV_CELL_SPLIT and ops.rng.ENV_CELL_TAG
#define PT_ENV_CELL_SPLIT (1 << 15)
#define PT_ENV_CELL_TAG 0xCE11u

// Threefry-2x32 with 20 rounds (jax.random's threefry2x32_p): key (k0, k1)
// and counter words (x0, x1), in place.
static __device__ __forceinline__ void threefry2x32(uint32_t k0, uint32_t k1, uint32_t& x0,
                                                   uint32_t& x1) {
  const uint32_t ks[3] = {k0, k1, k0 ^ k1 ^ 0x1BD11BDAu};
  const int rot[2][4] = {{13, 15, 26, 6}, {17, 29, 16, 24}};
  x0 += ks[0];
  x1 += ks[1];
#pragma unroll
  for (int g = 0; g < 5; ++g) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = rot[g & 1][i];
      x0 += x1;
      x1 = ((x1 << r) | (x1 >> (32 - r))) ^ x0;
    }
    x0 += ks[(g + 1) % 3];
    x1 += ks[(g + 2) % 3] + (uint32_t)(g + 1);
  }
}

// jax.random.uniform's float of one word of bits: [1, 2) minus 1.
static __device__ __forceinline__ float bits_u01(uint32_t bits) {
  return jmax(__uint_as_float((bits >> 9) | 0x3F800000u) - 1.0f, 0.0f);
}

__global__ void pt_env_rows(const __grid_constant__ SceneTables sc,
                            const __grid_constant__ EnvRowArgs a, float* __restrict__ out) {
  const int r = (int)(blockIdx.x * blockDim.x + threadIdx.x);
  if (r >= a.rows) return;
  const int s = r / a.depth;
  const int d = r - s * a.depth;
  // the sample's key: fold_in(key, iteration), the counter (0, iteration)
  uint32_t k0 = 0u, k1 = a.iter_base + (uint32_t)s;
  threefry2x32(0u, a.key, k0, k1);
  uint32_t b0 = 0u, b1 = (uint32_t)(2 * d);
  threefry2x32(k0, k1, b0, b1);
  uint32_t c0 = 0u, c1 = (uint32_t)(2 * d + 1);
  threefry2x32(k0, k1, c0, c1);
  const float u1 = bits_u01(b0 ^ b1);
  const float u2 = bits_u01(c0 ^ c1);

  // sample_env: up to PT_ENV_CELL_SPLIT texels the alias cell from u1's
  // integer part, stay or alias from its fraction, whose leftover is the
  // azimuth offset in the texel; past it the cell from a 64-bit word of
  // its own (rng.cell_words: the sample's key folded with PT_ENV_CELL_TAG,
  // counters 2d and 2d + 1 its high and low halves), floor(word * n / 2^64),
  // and all of u1 the fraction
  const int n_tex = a.h * a.w;
  int cell;
  float f;
  if (n_tex > PT_ENV_CELL_SPLIT) {
    uint32_t q0 = 0u, q1 = PT_ENV_CELL_TAG;
    threefry2x32(k0, k1, q0, q1);
    uint32_t h0 = 0u, h1 = (uint32_t)(2 * d);
    threefry2x32(q0, q1, h0, h1);
    uint32_t l0 = 0u, l1 = (uint32_t)(2 * d + 1);
    threefry2x32(q0, q1, l0, l1);
    const uint64_t n = (uint64_t)n_tex;
    cell = (int)(((uint64_t)(h0 ^ h1) * n + (((uint64_t)(l0 ^ l1) * n) >> 32)) >> 32);
    f = jmin(jmax(u1, 0.0f), a.f_max);
  } else {
    const float scaled = u1 * (float)n_tex;
    cell = min(max((int)scaled, 0), n_tex - 1);
    f = jmin(jmax(scaled - (float)cell, 0.0f), a.f_max);
  }
  const float p_stay = __ldg(a.alias_prob + cell);
  const bool take_alias = f >= p_stay;
  const int idx = take_alias ? __ldg(a.alias_idx + cell) : cell;
  float xfrac = take_alias ? (f - p_stay) / jmax(1.0f - p_stay, 1e-12f)
                           : f / jmax(p_stay, 1e-12f);
  xfrac = jmin(jmax(xfrac, 0.0f), a.x_max);
  const int y = idx / a.w;
  const int x = idx - y * a.w;
  const float u = ((float)x + xfrac) * a.inv_w;
  const float yf = (float)y;
  const float cos0 = cosf(yf * a.pi_h);
  const float cos1 = cosf((yf + 1.0f) * a.pi_h);
  const float cos_t = cos0 + u2 * (cos1 - cos0);
  const float theta = acosf(jmin(jmax(cos_t, -1.0f), 1.0f));
  const float phi = (u - 0.5f) * a.two_pi;
  const float st = sinf(theta);
  const float dx = st * sinf(phi);
  const float dy = cos_t;
  const float dz = -st * cosf(phi);

  // env_radiance: bilinear, wrapped in azimuth, clamped at the poles
  const float ue = 0.5f + atan2f(dx, -dz) * a.inv_two_pi;
  const float ve = acosf(jmin(jmax(dy, -1.0f), 1.0f)) * a.inv_pi;
  const float fx = ue * (float)a.w - 0.5f;
  const float fy = ve * (float)a.h - 0.5f;
  const float x0 = floorf(fx);
  const float y0 = floorf(fy);
  const float tx = fx - x0;
  const float ty = fy - y0;
  int x0i = (int)x0 % a.w;
  x0i = x0i < 0 ? x0i + a.w : x0i;
  const int x1i = (x0i + 1) % a.w;
  const int y0i = min(max((int)y0, 0), a.h - 1);
  const int y1i = min(y0i + 1, a.h - 1);
  const float strength = __ldg(a.strength);
  float* row = out + (size_t)r * (8 + 6 * sc.num_geoms);
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float c00 = __ldg(a.img + (y0i * a.w + x0i) * 3 + c);
    const float c01 = __ldg(a.img + (y0i * a.w + x1i) * 3 + c);
    const float c10 = __ldg(a.img + (y1i * a.w + x0i) * 3 + c);
    const float c11 = __ldg(a.img + (y1i * a.w + x1i) * 3 + c);
    const float top = c00 + (c01 - c00) * tx;
    const float bot = c10 + (c11 - c10) * tx;
    row[3 + c] = (top + (bot - top) * ty) * strength;
  }
  row[0] = dx;
  row[1] = dy;
  row[2] = dz;
  row[6] = __ldg(a.pdf + idx);
  row[7] = 0.0f;
  for (int k = 0; k < sc.num_geoms; ++k) dir_entry(sc, k, dx, dy, dz, row + 8 + 6 * k);
}

// Builds env NEE's rows of iterations iter_base .. iter_base + num_samples -
// 1 on `stream`: out[num_samples * depth * (8 + 6 * num_geoms)] (device),
// from the map's device tables (img[h*w*3], alias_prob/alias_idx/pdf[h*w],
// strength[1]) and the host scene tables geo[num_geoms*21], perm[num_geoms*3];
// returns the CUDA error code (0 = launched).
extern "C" int pt_env_rows_launch(float* out, int num_samples, int depth, int iter_base, int seed,
                                  const float* img, const float* alias_prob, const int* alias_idx,
                                  const float* pdf, const float* strength, int h, int w,
                                  const float* geo, const int* perm, int num_cubes, int num_geoms,
                                  void* stream) {
  if (!out || num_samples < 0 || depth < 1 || h <= 0 || w <= 0 ||
      (long long)h * w * 3 > 0x7fffffffLL || !img || !alias_prob || !alias_idx || !pdf ||
      !strength || num_geoms < 0 || num_geoms > PT_MAX_GEOMS ||
      num_cubes < 0 || num_cubes > num_geoms || (long long)num_samples * depth > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const int rows = num_samples * depth;
  if (rows == 0) return 0;
  SceneTables t;
  memset(&t, 0, sizeof(t));
  memcpy(t.geo, geo, sizeof(float) * (size_t)num_geoms * PT_GF);
  memcpy(t.perm, perm, sizeof(int) * (size_t)num_geoms * 3);
  t.num_cubes = num_cubes;
  t.num_geoms = num_geoms;
  EnvRowArgs a;
  a.img = img;
  a.alias_prob = alias_prob;
  a.alias_idx = alias_idx;
  a.pdf = pdf;
  a.strength = strength;
  a.h = h;
  a.w = w;
  a.rows = rows;
  a.depth = depth;
  a.key = (uint32_t)seed ^ 0xE17B0075u;
  a.iter_base = (uint32_t)iter_base;
  a.f_max = (float)(1.0 - 1e-7);
  a.x_max = (float)(1.0 - 1e-6);
  a.inv_w = 1.0f / (float)w;
  a.pi_h = (float)(3.14159265358979323846 / (double)h);
  a.two_pi = (float)6.283185307179586;
  a.inv_two_pi = (float)(1.0 / 6.283185307179586);
  a.inv_pi = (float)(1.0 / 3.14159265358979323846);
  pt_env_rows<<<(rows + PT_BLOCK - 1) / PT_BLOCK, PT_BLOCK, 0, (cudaStream_t)stream>>>(t, a, out);
  return (int)cudaGetLastError();
}
