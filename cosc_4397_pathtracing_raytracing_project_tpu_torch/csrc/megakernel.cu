// Path-tracing megakernel for NVIDIA Hopper (sm_90a), one thread per pixel.
//
// Replaces the TPU kernel built by
// cosc_4397_pathtracing_raytracing_project_tpu/ops/pallas/megakernel.py:
// _make_kernel -> kernel, as launched by _render_samples_impl (pallas_call),
// restricted to the options of the main path: light_only gathering, the
// gradient sky scaled by sky_strength, Russian roulette past rr_start_depth,
// the Owen-scrambled Sobol sampler on the leading n_ld depths (or the
// counter-hash streams alone), a hoisted primary hit without antialiasing
// and sub-pixel jitter with it. No NEE, environment map, depth of field,
// refraction or throughput gathering.
//
// Output: out[p*3 + c] = sum over samples iter_base .. iter_base+num_samples-1
// (ascending, f32) of the path radiance of pixel p. The kernel writes the
// [N,3] buffer the wrapper allocates; it never adds into the accumulator.
//
// Random numbers are the same streams as the JAX package's interpret-mode
// oracle: the LD lattice (_ld_shift, _sobol_scalar_pair, _lk, _ld_u01,
// _ld_rev_components) keyed by the global pixel id, and everything else from
// the counter hash _HashPrng keyed by lane = p % tile and reseeded with
// _mix(seed, iteration, depth | 0xAA, p / tile). Every depth
// reseeds, so a thread whose path has ended leaves its bounce loop early
// without shifting any later draw.
//
// What bounds it on this card: per-thread registers and warp divergence at
// the emissive / Russian-roulette / specular-vs-diffuse branches and at path
// termination; memory traffic is one 12-byte store per pixel per launch, and
// the scene tables are a __grid_constant__ kernel parameter (the card's
// counterpart of the TPU kernel's SMEM tables): they live in the parameter
// constant bank, are read uniformly across a warp, and travel with the
// launch itself, so no copy precedes it and launches with different scenes
// on different streams cannot overwrite each other's tables. wgmma and TMA have
// no role here (no matrix products, no bulk tiles). A later performance
// change may try ray reordering by material or persistent threads.
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

#define PT_MAX_GEOMS 16
#define PT_MAX_MATERIALS 16
#define PT_GF 21  // floats per geom: inverse transform rows (12) + inverse-transpose (9)
#define PT_MF 10  // floats per material: color(3) spec(3) refl refr emit ior
#define PT_BLOCK 128

constexpr float kMiss = 1e30f;
constexpr float kFmax = 3.402823466e38f;
constexpr float kBackoff = 1e-4f;
constexpr float kOriginOffset = 1e-3f;
constexpr float kPi = 3.14159265358979323846f;
constexpr float kHalfPi = 1.57079632679489661923f;
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

struct Options {
  int n;
  int width;
  int height;
  uint32_t seed;
  int iter_base;
  int tile;
  int num_samples;
  int trace_depth;
  int rr_start_depth;
  int antialias;
  int use_ld;
  int n_ld;
  float sky_strength;
};

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

// ops.rng.ld_bounce_tags
static __device__ __forceinline__ uint32_t ld_bounce_tag(int depth, int which) {
  if (depth == 0) return 4u + (uint32_t)which;
  return 10u + (uint32_t)(depth - 1) * 6u + (uint32_t)which;
}

struct Hit {
  float t, nx, ny, nz;
  int mat;
};

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

// Nearest hit over every primitive (megakernel.intersect_all): object-space
// slab test for cubes, quadratic for spheres, with the unnormalized
// object-space direction so the parameter is the world distance.
static __device__ Hit intersect_all(const SceneTables& sc, float ox, float oy, float oz,
                                    float dx, float dy, float dz) {
  float best_t = kMiss, bnx = 0.0f, bny = 0.0f, bnz = 0.0f;
  int best_mat = 0;
  const int num_geoms = sc.num_geoms;
  const int num_cubes = sc.num_cubes;
  for (int k = 0; k < num_geoms; ++k) {
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
    bool hit;
    float t_world, nox, noy, noz;
    if (k < num_cubes) {
      const float ix = 1.0f / qdx;
      const float iy = 1.0f / qdy;
      const float iz = 1.0f / qdz;
      const float t1x = (-0.5f - qox) * ix;
      const float t2x = (0.5f - qox) * ix;
      const float t1y = (-0.5f - qoy) * iy;
      const float t2y = (0.5f - qoy) * iy;
      const float t1z = (-0.5f - qoz) * iz;
      const float t2z = (0.5f - qoz) * iz;
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
    } else {
      const float nq2 = qdx * qdx + qdy * qdy + qdz * qdz;
      const float b = qox * qdx + qoy * qdy + qoz * qdz;
      const float c = qox * qox + qoy * qoy + qoz * qoz - 0.25f;
      const float disc = b * b - nq2 * c;
      const float sq = sqrtf(jmax(disc, 0.0f));
      const float inv_a = 1.0f / nq2;
      const float s1 = (-b + sq) * inv_a;
      const float s2 = (-b - sq) * inv_a;
      const bool both_neg = (s1 < 0.0f) && (s2 < 0.0f);
      const bool both_pos = (s1 > 0.0f) && (s2 > 0.0f);
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
    if (hit && (t_world > 0.0f) && (t_world < best_t)) {
      best_t = t_world;
      bnx = nox;
      bny = noy;
      bnz = noz;
      best_mat = sc.gmat[k];
    }
  }
  const float rw = rsqrt_exact(jmax(bnx * bnx + bny * bny + bnz * bnz, 1e-30f));
  Hit h;
  h.t = best_t;
  h.nx = bnx * rw;
  h.ny = bny * rw;
  h.nz = bnz * rw;
  h.mat = best_mat;
  return h;
}

__global__ void __launch_bounds__(PT_BLOCK)
    pt_megakernel(const __grid_constant__ Options o, const __grid_constant__ SceneTables sc,
                  float* __restrict__ out) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= o.n) return;
  const float fx = (float)(p % o.width);
  const float fy = (float)(p / o.width);
  const uint32_t pid = (uint32_t)p;  // global pixel id py*W + px
  const uint32_t tile_id = (uint32_t)(p / o.tile);
  HashPrng prng;
  prng.lane = (uint32_t)(p % o.tile);
  prng.seed_mul = 0u;
  prng.counter = 0u;
  const float* cam = sc.cam;

  // Without jitter the primary ray, and so its hit, is the same for every
  // sample: trace it once per thread (the TPU kernel's hoisted pre0).
  float bdx = 0.0f, bdy = 0.0f, bdz = 0.0f;
  Hit h0 = {kMiss, 0.0f, 0.0f, 0.0f, 0};
  if (!o.antialias) {
    raygen(o, sc, fx, fy, &bdx, &bdy, &bdz);
    h0 = intersect_all(sc, cam[0], cam[1], cam[2], bdx, bdy, bdz);
  }

  float acc_r = 0.0f, acc_g = 0.0f, acc_b = 0.0f;
  for (int s = 0; s < o.num_samples; ++s) {
    const uint32_t it = (uint32_t)(o.iter_base + s);
    float dx = bdx, dy = bdy, dz = bdz;
    if (o.antialias) {
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
    }
    float ox = cam[0], oy = cam[1], oz = cam[2];
    float cr = 1.0f, cg = 1.0f, cb = 1.0f;
    float rad_r = 0.0f, rad_g = 0.0f, rad_b = 0.0f;

    for (int depth = 0; depth < o.trace_depth; ++depth) {
      const Hit h = (depth == 0 && !o.antialias) ? h0 : intersect_all(sc, ox, oy, oz, dx, dy, dz);
      if (h.t >= kMiss) {
        if (o.sky_strength != 0.0f) {  // gradient sky (`pathtrace.cu:358-362`)
          const float t_sky = 0.5f * (dy + 1.0f);
          const float sky_r = ((1.0f - t_sky) + t_sky * 0.5f) * 0.5f;
          const float sky_g = ((1.0f - t_sky) + t_sky * 0.7f) * 0.5f;
          const float sky_b = ((1.0f - t_sky) + t_sky * 1.0f) * 0.5f;
          rad_r = rad_r + cr * sky_r * o.sky_strength;
          rad_g = rad_g + cg * sky_g * o.sky_strength;
          rad_b = rad_b + cb * sky_b * o.sky_strength;
        }
        break;
      }
      const float* m = sc.mats + h.mat * PT_MF;
      const float m_cr = m[0], m_cg = m[1], m_cb = m[2];
      const float m_emit = m[8];
      if (m_emit > 0.0f) {  // emissive termination, light_only gathering
        rad_r = rad_r + cr * m_cr * m_emit;
        rad_g = rad_g + cg * m_cg * m_emit;
        rad_b = rad_b + cb * m_cb * m_emit;
        break;
      }

      // draws: u_rr (past rr_start_depth, hash stream), branch, u_a, u_b
      float u_rr = 0.0f, u_branch, u_a, u_b;
      const bool rr = depth > o.rr_start_depth;
      if (o.use_ld && depth < o.n_ld) {
        uint32_t s0, s1;
        ld_rev_components(it, depth, pid, o.seed, &s0, &s1);
        if (rr) {
          prng.reseed(mix4(o.seed, it, (uint32_t)depth, tile_id));
          u_rr = prng.u01();
        }
        u_branch = ld_u01(s0, ld_shift(pid, o.seed, ld_bounce_tag(depth, 0)));
        u_a = ld_u01(s0, ld_shift(pid, o.seed, ld_bounce_tag(depth, 1)));
        u_b = ld_u01(s1, ld_shift(pid, o.seed, ld_bounce_tag(depth, 2)));
      } else {
        prng.reseed(mix4(o.seed, it, (uint32_t)depth, tile_id));
        if (rr) u_rr = prng.u01();
        u_branch = prng.u01();
        u_a = prng.u01();
        u_b = prng.u01();
      }

      if (rr) {  // Russian roulette with the 1/p boost
        const float p_cont = jmax(m_cr, jmax(m_cg, m_cb));
        if (u_rr > p_cont) break;
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
      const float ndx = tx * scp + vax * c_pol + bxv * ssp;
      const float ndy = ty * scp + vay * c_pol + byv * ssp;
      const float ndz = tz * scp + vaz * c_pol + bzv * ssp;

      const float hx = ox + h.t * dx + nx * kOriginOffset;
      const float hy = oy + h.t * dy + ny * kOriginOffset;
      const float hz = oz + h.t * dz + nz * kOriginOffset;
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
    acc_r = acc_r + rad_r;
    acc_g = acc_g + rad_g;
    acc_b = acc_b + rad_b;
  }
  out[p * 3 + 0] = acc_r;
  out[p * 3 + 1] = acc_g;
  out[p * 3 + 2] = acc_b;
}

// Packs the scene tables into the kernel's by-value parameter and launches
// the kernel on `stream`; returns the CUDA error code (0 = launched). Host
// pointers, read before this returns: cam[16], geo[num_geoms*21],
// mats[num_materials*10], gmat[num_geoms], perm[num_geoms*3].
extern "C" int pt_megakernel_launch(
    float* out, int n, int width, int height, int seed, int iter_base,
    int tile, int num_samples, int trace_depth,
    int rr_start_depth, int antialias, int use_ld, int n_ld, float sky_strength,
    const float* cam, const float* geo, const float* mats, const int* gmat,
    const int* perm, int num_cubes, int num_geoms, int num_materials,
    void* stream) {
  if (n < 0 || width <= 0 || height <= 0 || tile <= 0 || num_geoms < 0 ||
      num_geoms > PT_MAX_GEOMS || num_materials <= 0 ||
      num_materials > PT_MAX_MATERIALS || num_cubes < 0 || num_cubes > num_geoms) {
    return (int)cudaErrorInvalidValue;
  }
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
  Options o;
  o.n = n;
  o.width = width;
  o.height = height;
  o.seed = (uint32_t)seed;
  o.iter_base = iter_base;
  o.tile = tile;
  o.num_samples = num_samples;
  o.trace_depth = trace_depth;
  o.rr_start_depth = rr_start_depth;
  o.antialias = antialias;
  o.use_ld = use_ld;
  o.n_ld = n_ld;
  o.sky_strength = sky_strength;
  const int blocks = (n + PT_BLOCK - 1) / PT_BLOCK;
  pt_megakernel<<<blocks, PT_BLOCK, 0, (cudaStream_t)stream>>>(o, t, out);
  return (int)cudaGetLastError();
}
