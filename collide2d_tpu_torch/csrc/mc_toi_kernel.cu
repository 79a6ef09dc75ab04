// Fused trajectory Monte Carlo counts for rectangle configurations (kernel
// 13) on Hopper.
//
// Replaces the TPU kernel collide2d_tpu/ops/mc_toi_pallas.py::_mc_toi_kernel
// (:170). For each configuration row c it returns the int32 number of
// samples among n whose noisy obstacle the moving robot hits over the unit
// horizon. Per sample:
//
//   1. 5 standard normals (3 without shape noise) from kernel 1's Philox
//      stream and erf_inv (mc_kernel.cu): words dx, dy, dtheta, dw of draw
//      block 0, dh of block 1;
//   2. the noisy static obstacle: centre (z_dx sx, z_dy sy), angle
//      phi = z_th sth, half extents |ow/2 + z_dw sw/2|, |oh/2 + z_dh sh/2|;
//   3. a non-rotating row (omega == 0, or ca_iters == 0) takes the exact
//      translation window of the obstacle moving by -v t relative to the
//      robot (obb_distance.cuh::obb_translation_window): a hit when
//      entry <= exit, entry <= 1 and exit >= 0;
//   4. a rotating row runs conservative advancement on the closed-form box
//      distance (obb_distance.cuh::obb_signed_distance) at the robot's
//      advanced centre p + t v and angle theta + t w: t <- t + max(d, 0) /
//      bound until d(t) <= tol or t > 1, at most ca_iters steps; a hit when
//      d(t) <= tol and t <= 1.
//
// Design, as kernel 1's: the grid is (configuration, 4,096-sample chunk),
// a block of 256 threads takes 4,096 consecutive samples of ONE
// configuration (16 a thread), a warp shuffle and one int32 atomicAdd per
// warp land the hits. Because omega is per configuration, the rotating
// branch is uniform across the block: translation-only rows never enter
// the advancement loop, and no warp mixes the two paths. Each thread leaves
// its loop when its sample converges (a converged lane never changes again
// in the fixed-trip loop, so the result is the fixed-trip loop's); a warp
// still runs until its slowest lane, so rotating rows cost the warps'
// maximum steps, not the mean (chip_smoke.py reports both).
//
// What bounds it on this card: operations. A round reads 64 bytes a row and
// writes 4; a sample costs 1-2 Philox, 3-5 erf_inv, one sincosf and the
// window (~100 operations), and a rotating sample ~209 operations and a
// sincosf per advancement step.
//
// Rounding. Products and sums of the window, the distance and the
// advancement are __fmul_rn / __fadd_rn / __fsub_rn in the torch order,
// divisions IEEE, angles through sincosf: the kernel and its plain version
// (ops/mc_toi_cuda.py) differ only where sincosf or log1pf round unlike
// torch's cos/sin/log1p, which moves a sample only within an ulp of a
// boundary or of tol.
//
// The wrapper allocates `counts` zeroed; the kernel only accumulates.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "obb_distance.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kSamplesPerThread = 16;
constexpr long long kSamplesPerBlock =
    static_cast<long long>(kThreads) * kSamplesPerThread;

struct Philox4 {
  uint32_t v[4];
};

// Philox4x32-10, the same function as mc_kernel.cu's.
__device__ __forceinline__ Philox4 philox4x32_10(uint32_t c0, uint32_t c1,
                                                 uint32_t c2, uint32_t c3,
                                                 uint32_t k0, uint32_t k1) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r > 0) {
      k0 += 0x9E3779B9u;
      k1 += 0xBB67AE85u;
    }
    const uint32_t hi0 = __umulhi(0xD2511F53u, c0);
    const uint32_t lo0 = 0xD2511F53u * c0;
    const uint32_t hi1 = __umulhi(0xCD9E8D57u, c2);
    const uint32_t lo1 = 0xCD9E8D57u * c2;
    const uint32_t n0 = hi1 ^ c1 ^ k0;
    const uint32_t n2 = hi0 ^ c3 ^ k1;
    c0 = n0;
    c1 = lo1;
    c2 = n2;
    c3 = lo0;
  }
  Philox4 out = {{c0, c1, c2, c3}};
  return out;
}

// XLA's float32 erf_inv, as mc_kernel.cu's.
__device__ __forceinline__ float erfinv_f32(float x) {
  float w = -log1pf(x * -x);
  const bool lt = w < 5.0f;
  w = lt ? w - 2.5f : sqrtf(w) - 3.0f;
  float p = lt ? 2.81022636e-08f : -0.000200214257f;
  p = (lt ? 3.43273939e-07f : 0.000100950558f) + p * w;
  p = (lt ? -3.5233877e-06f : 0.00134934322f) + p * w;
  p = (lt ? -4.39150654e-06f : -0.00367342844f) + p * w;
  p = (lt ? 0.00021858087f : 0.00573950773f) + p * w;
  p = (lt ? -0.00125372503f : -0.0076224613f) + p * w;
  p = (lt ? -0.00417768164f : 0.00943887047f) + p * w;
  p = (lt ? 0.246640727f : 1.00167406f) + p * w;
  p = (lt ? 1.50140941f : 2.83297682f) + p * w;
  return p * x;
}

__device__ __forceinline__ float normal_from_word(uint32_t word) {
  const float u =
      (static_cast<float>(word >> 9) + 0.5f) * 2.384185791015625e-07f - 1.0f;
  return 1.41421356f * erfinv_f32(u);
}

// Parameter columns of one configuration (ops/mc_toi_cuda.py::
// pack_mc_toi_params).
struct Params {
  float px, py, theta, hx1, hy1, ow_h, oh_h, sx, sy, sth, swh, shh, vx, vy, w,
      bound;
};

// The noisy obstacle of one sample.
struct Obstacle {
  float ox, oy, cphi, sphi, a, b;
};

// Signed distance of the obstacle from the robot advanced to time t.
__device__ __forceinline__ float distance_at(const Params& q,
                                             const Obstacle& o, float t) {
  float sa, ca;
  sincosf(__fadd_rn(q.theta, __fmul_rn(t, q.w)), &sa, &ca);
  const float dx = __fsub_rn(o.ox, __fadd_rn(q.px, __fmul_rn(t, q.vx)));
  const float dy = __fsub_rn(o.oy, __fadd_rn(q.py, __fmul_rn(t, q.vy)));
  return collide2d::obb_signed_distance(dx, dy, ca, sa, q.hx1, q.hy1, o.cphi,
                                        o.sphi, o.a, o.b);
}

template <bool kShapeNoise>
__global__ void __launch_bounds__(kThreads)
    mc_toi_counts_kernel(const float* __restrict__ params,
                         const int32_t* __restrict__ uids,
                         int32_t* __restrict__ counts, long long n,
                         long long offset, uint32_t seed0, uint32_t seed1,
                         int ca_iters, float tol) {
  const int c = blockIdx.x;
  const float* row = params + static_cast<long long>(c) * 16;
  Params q;
  q.px = __ldg(row + 0);
  q.py = __ldg(row + 1);
  q.theta = __ldg(row + 2);
  q.hx1 = __ldg(row + 3);
  q.hy1 = __ldg(row + 4);
  q.ow_h = __ldg(row + 5);
  q.oh_h = __ldg(row + 6);
  q.sx = __ldg(row + 7);
  q.sy = __ldg(row + 8);
  q.sth = __ldg(row + 9);
  q.swh = __ldg(row + 10);
  q.shh = __ldg(row + 11);
  q.vx = __ldg(row + 12);
  q.vy = __ldg(row + 13);
  q.w = __ldg(row + 14);
  q.bound = __ldg(row + 15);
  const uint32_t uid = static_cast<uint32_t>(__ldg(uids + c));
  // uniform across the block: omega is per configuration
  const bool rotating = q.w != 0.0f && ca_iters > 0;
  float s1, c1;
  sincosf(q.theta, &s1, &c1);

  int hits = 0;
  const long long begin = static_cast<long long>(blockIdx.y) * kSamplesPerBlock;
  long long end = begin + kSamplesPerBlock;
  if (end > n) end = n;
  for (long long j = begin + threadIdx.x; j < end; j += kThreads) {
    const unsigned long long idx = static_cast<unsigned long long>(offset + j);
    const uint32_t lo = static_cast<uint32_t>(idx);
    const uint32_t hi = static_cast<uint32_t>(idx >> 32);
    const Philox4 r = philox4x32_10(lo, hi, uid, 0u, seed0, seed1);
    Obstacle o;
    o.ox = __fmul_rn(normal_from_word(r.v[0]), q.sx);
    o.oy = __fmul_rn(normal_from_word(r.v[1]), q.sy);
    const float phi = __fmul_rn(normal_from_word(r.v[2]), q.sth);
    if (kShapeNoise) {
      const Philox4 r2 = philox4x32_10(lo, hi, uid, 1u, seed0, seed1);
      o.a = fabsf(__fadd_rn(q.ow_h, __fmul_rn(normal_from_word(r.v[3]), q.swh)));
      o.b = fabsf(__fadd_rn(q.oh_h, __fmul_rn(normal_from_word(r2.v[0]), q.shh)));
    } else {
      o.a = fabsf(q.ow_h);
      o.b = fabsf(q.oh_h);
    }
    sincosf(phi, &o.sphi, &o.cphi);
    bool hit;
    if (!rotating) {
      float entry, exit;
      collide2d::obb_translation_window(
          __fsub_rn(o.ox, q.px), __fsub_rn(o.oy, q.py), c1, s1, q.hx1, q.hy1,
          o.cphi, o.sphi, o.a, o.b, -q.vx, -q.vy, entry, exit);
      hit = entry <= exit && entry <= 1.0f && exit >= 0.0f;
    } else {
      float t = 0.0f;
      float d = 0.0f;
      bool stopped = false;
      for (int i = 0; i < ca_iters; ++i) {
        d = distance_at(q, o, t);
        if (d <= tol || t > 1.0f) {
          stopped = true;  // converged or past the horizon: t is final
          break;
        }
        t = __fadd_rn(t, __fdiv_rn(fmaxf(d, 0.0f), q.bound));
      }
      if (!stopped) d = distance_at(q, o, t);  // the budget ran out: check t
      hit = d <= tol && t <= 1.0f;
    }
    hits += hit ? 1 : 0;
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    hits += __shfl_down_sync(0xffffffffu, hits, o);
  }
  if ((threadIdx.x & 31) == 0 && hits != 0) {
    atomicAdd(counts + c, hits);
  }
}

}  // namespace

// Plain C entry point (bound with ctypes). Launches on `stream`, does not
// synchronise, and returns cudaGetLastError() after the launch (0 = ok).
extern "C" int mc_toi_counts_launch(const float* params, const int32_t* uids,
                                    int32_t* counts, int num_configs,
                                    long long n, long long offset,
                                    uint32_t seed0, uint32_t seed1,
                                    int shape_noise, int ca_iters, float tol,
                                    void* stream) {
  if (num_configs <= 0 || n <= 0) return static_cast<int>(cudaSuccess);
  if (ca_iters < 0) return static_cast<int>(cudaErrorInvalidValue);
  const long long chunks = (n + kSamplesPerBlock - 1) / kSamplesPerBlock;
  if (chunks > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(num_configs),
                  static_cast<unsigned>(chunks));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (shape_noise) {
    mc_toi_counts_kernel<true><<<grid, kThreads, 0, s>>>(
        params, uids, counts, n, offset, seed0, seed1, ca_iters, tol);
  } else {
    mc_toi_counts_kernel<false><<<grid, kThreads, 0, s>>>(
        params, uids, counts, n, offset, seed0, seed1, ca_iters, tol);
  }
  return static_cast<int>(cudaGetLastError());
}

// Launch-free constant the wrapper checks against its own sample cap.
extern "C" long long mc_toi_max_samples_per_round() {
  return 65535LL * kSamplesPerBlock;
}
