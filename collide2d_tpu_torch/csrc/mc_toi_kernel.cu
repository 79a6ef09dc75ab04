// Fused trajectory Monte Carlo counts for rectangle configurations (kernel
// 13) on Hopper.
//
// Replaces the TPU kernel collide2d_tpu/ops/mc_toi_pallas.py::_mc_toi_kernel
// (:170). For each configuration row c it returns the int32 number of
// samples among n whose noisy obstacle the moving robot hits over the unit
// horizon. Per sample:
//
//   1. 5 standard normals (3 without shape noise) from the shared stream
//      (csrc/mc_stream.cuh, kernel 1's): words dx, dy, dtheta, dw of draw
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
// What bounds it on this card: instruction issue. A round reads 64 bytes a
// row and writes 4; a translating sample costs 1-2 Philox, 3-5 erf_inv, one
// sincosf and the window (~90 operations, 2 IEEE divisions), and a rotating
// sample ~209 operations and a sincosf per advancement step.
//
// Design, kernel 1's (csrc/mc_kernel.cu): the grid is (configuration,
// 4,096-sample chunk), a block of 256 threads takes 4,096 consecutive
// samples of ONE configuration (16 a thread, index first + thread + 256 m),
// the stream's round keys from the launcher and its counter words 1-3 once
// a block, 32-bit sample indices when the launch's indices share their high
// word, a warp shuffle and one int32 atomicAdd per warp. Beside that:
// - omega is per configuration, so the path is uniform across a block:
//   the window loop and the advancement loop are two loops, and a launch
//   with ca_iters == 0 (every launch of translation-only `movelabel`)
//   takes an instantiation without the advancement loop at all;
// - the window loop evaluates S = 2 samples a thread at once (see the note
//   at `S`), a warp leaves it together (erf_inv's vote names the whole
//   warp), and the robot's two axis speeds -v . (c1, s1), -v . (-s1, c1)
//   with their IEEE reciprocals, which depend on the row alone, are computed
//   once a block (obb_distance.cuh::box_axis_speeds: the same operations, so
//   the same bits): a sample divides only on the obstacle's two axes;
// - the advancement loop takes one sample at a time: each thread leaves it
//   when its sample converges (a converged lane never changes again in the
//   fixed-trip loop, so the result is the fixed-trip loop's); a warp still
//   runs until its slowest lane, so rotating rows cost the warps' maximum
//   steps, not the mean (chip_smoke.py reports both).
//
// Rounding. Products and sums of the window, the distance and the
// advancement are __fmul_rn / __fadd_rn / __fsub_rn in the torch order,
// divisions IEEE, angles through sincosf: the kernel and its plain version
// (ops/mc_toi_cuda.py) differ only where sincosf or log1pf round unlike
// torch's cos/sin/log1p, which moves a sample only within an ulp of a
// boundary or of tol. Counts do not depend on S, the grid or the
// instantiation.
//
// The wrapper allocates `counts` zeroed; the kernel only accumulates.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mc_stream.cuh"
#include "obb_distance.cuh"

namespace {

using namespace collide2d::mc_stream;

constexpr int kThreads = 256;
constexpr int kSamplesPerThread = 16;
constexpr long long kSamplesPerBlock =
    static_cast<long long>(kThreads) * kSamplesPerThread;
// Samples a thread evaluates at once in the window loop. At 100,000
// translation rows x 4,096 samples on an H100 (one call, each against
// S = 2 in turns): with shape noise, the main path's case, S = 1 8.27 ms
// against 7.95 and S = 4 8.71 against 7.97; without it S = 1 5.78 against
// 5.58 and S = 4 5.57 against 5.60.
constexpr int S = 2;
static_assert(kSamplesPerThread % S == 0, "S must divide 16");

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

template <bool kShapeNoise, bool kWide>
__device__ __forceinline__ Obstacle sample_obstacle(
    const Params& q, const SampleStream<kWide>& draw0,
    const SampleStream<kWide>& draw1, int k, const PhiloxKey& key,
    unsigned lanes) {
  const Philox4 r = draw0(k, key);
  Obstacle o;
  o.ox = __fmul_rn(normal_from_word(r.v[0], lanes), q.sx);
  o.oy = __fmul_rn(normal_from_word(r.v[1], lanes), q.sy);
  const float phi = __fmul_rn(normal_from_word(r.v[2], lanes), q.sth);
  if (kShapeNoise) {
    const Philox4 r2 = draw1(k, key);
    o.a = fabsf(__fadd_rn(q.ow_h, __fmul_rn(normal_from_word(r.v[3], lanes), q.swh)));
    o.b = fabsf(__fadd_rn(q.oh_h, __fmul_rn(normal_from_word(r2.v[0], lanes), q.shh)));
  } else {
    o.a = fabsf(q.ow_h);
    o.b = fabsf(q.oh_h);
  }
  sincosf(phi, &o.sphi, &o.cphi);
  return o;
}

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

// Hits of a translating row among the block's `count` samples.
template <bool kShapeNoise, bool kWide>
__device__ __forceinline__ int window_hits(const Params& q,
                                           const SampleStream<kWide>& draw0,
                                           const SampleStream<kWide>& draw1,
                                           const PhiloxKey& key, int count,
                                           float c1, float s1) {
  const collide2d::BoxAxisSpeeds robot =
      collide2d::box_axis_speeds(c1, s1, -q.vx, -q.vy);
  int hits = 0;
  // a warp leaves the loop together (as kernel 1's)
  const int warp0 = static_cast<int>(threadIdx.x) & ~31;
#pragma unroll 1
  for (int m = 0; m < kSamplesPerThread; m += S) {
    if (warp0 + kThreads * m >= count) break;
    const int k0 = static_cast<int>(threadIdx.x) + kThreads * m;
    bool hit[S];
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const Obstacle o = sample_obstacle<kShapeNoise>(q, draw0, draw1,
                                                      k0 + kThreads * s, key, kWarp);
      float entry, exit;
      collide2d::obb_translation_window(
          __fsub_rn(o.ox, q.px), __fsub_rn(o.oy, q.py), c1, s1, q.hx1, q.hy1,
          o.cphi, o.sphi, o.a, o.b, -q.vx, -q.vy, robot, entry, exit);
      hit[s] = entry <= exit && entry <= 1.0f && exit >= 0.0f;
    }
#pragma unroll
    for (int s = 0; s < S; ++s) {
      hits += (k0 + kThreads * s < count && hit[s]) ? 1 : 0;
    }
  }
  return hits;
}

// Hits of a rotating row among the block's `count` samples.
template <bool kShapeNoise, bool kWide>
__device__ __forceinline__ int advancement_hits(const Params& q,
                                                const SampleStream<kWide>& draw0,
                                                const SampleStream<kWide>& draw1,
                                                const PhiloxKey& key, int count,
                                                int ca_iters, float tol) {
  int hits = 0;
#pragma unroll 1
  for (int k = threadIdx.x; k < count; k += kThreads) {
    // lanes leave this loop and the advancement loop one by one
    const Obstacle o =
        sample_obstacle<kShapeNoise>(q, draw0, draw1, k, key, __activemask());
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
    hits += (d <= tol && t <= 1.0f) ? 1 : 0;
  }
  return hits;
}

// kAdvance: rows with omega != 0 run the advancement loop (the launcher
// takes it when ca_iters > 0); without it every row takes the window.
template <bool kShapeNoise, bool kAdvance, bool kWide>
__global__ void __launch_bounds__(kThreads)
    mc_toi_counts_kernel(const float* __restrict__ params,
                         const int32_t* __restrict__ uids,
                         int32_t* __restrict__ counts, long long n,
                         long long offset, const __grid_constant__ PhiloxKey key,
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

  const long long first = static_cast<long long>(blockIdx.y) * kSamplesPerBlock;
  const unsigned long long base = static_cast<unsigned long long>(offset + first);
  const SampleStream<kWide> draw0(base, uid, 0u, key);
  const SampleStream<kWide> draw1(base, uid, 1u, key);
  const long long left = n - first;
  const int count = left < kSamplesPerBlock ? static_cast<int>(left)
                                            : static_cast<int>(kSamplesPerBlock);

  int hits;
  if (kAdvance && q.w != 0.0f) {  // uniform across the block
    hits = advancement_hits<kShapeNoise>(q, draw0, draw1, key, count, ca_iters,
                                         tol);
  } else {
    float s1, c1;
    sincosf(q.theta, &s1, &c1);
    hits = window_hits<kShapeNoise>(q, draw0, draw1, key, count, c1, s1);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    hits += __shfl_down_sync(0xffffffffu, hits, o);
  }
  if ((threadIdx.x & 31) == 0 && hits != 0) {
    atomicAdd(counts + c, hits);
  }
}

template <bool kShapeNoise, bool kAdvance>
void launch(const dim3& grid, cudaStream_t s, bool wide, const float* params,
            const int32_t* uids, int32_t* counts, long long n, long long offset,
            const PhiloxKey& key, int ca_iters, float tol) {
  if (wide) {
    mc_toi_counts_kernel<kShapeNoise, kAdvance, true><<<grid, kThreads, 0, s>>>(
        params, uids, counts, n, offset, key, ca_iters, tol);
  } else {
    mc_toi_counts_kernel<kShapeNoise, kAdvance, false><<<grid, kThreads, 0, s>>>(
        params, uids, counts, n, offset, key, ca_iters, tol);
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
  const bool wide = !narrow_indices(offset, n);
  const PhiloxKey key = philox_key(seed0, seed1);
  if (shape_noise && ca_iters > 0) {
    launch<true, true>(grid, s, wide, params, uids, counts, n, offset, key,
                       ca_iters, tol);
  } else if (shape_noise) {
    launch<true, false>(grid, s, wide, params, uids, counts, n, offset, key,
                        ca_iters, tol);
  } else if (ca_iters > 0) {
    launch<false, true>(grid, s, wide, params, uids, counts, n, offset, key,
                        ca_iters, tol);
  } else {
    launch<false, false>(grid, s, wide, params, uids, counts, n, offset, key,
                         ca_iters, tol);
  }
  return static_cast<int>(cudaGetLastError());
}

// Launch-free constant the wrapper checks against its own sample cap.
extern "C" long long mc_toi_max_samples_per_round() {
  return 65535LL * kSamplesPerBlock;
}

// Samples a thread evaluates at once in the window loop (S): one iteration
// of that loop.
extern "C" int mc_toi_batch_samples() { return S; }
