// Fused Monte Carlo collision counts for rectangle configurations, on Hopper.
//
// Replaces the TPU kernel collide2d_tpu/ops/mc_pallas.py::_mc_kernel. For
// each configuration row c it returns the int32 number of colliding samples
// among n noise draws: per sample, 3 standard normals (dx, dy, dtheta) or 5
// with shape noise (+ dw, dh) from the shared stream (csrc/mc_stream.cuh:
// words dx, dy, dtheta, dw of draw block 0, dh of block 1), then the
// relative-angle 4-axis oriented-box test of `_obb_separated`
// (mc_pallas.py:159-204). A build with -DMC_BOX_MULLER=1 draws the normals
// as Box-Muller pairs instead (the TPU kernel's normal_method="box_muller";
// mc_stream.cuh::box_muller_pair: words 0-3 of block 0, with shape noise
// also words 0-1 of block 1); without the define the kernel is unchanged.
//
// What bounds it on this card: instruction issue, not memory. A round reads
// 64 bytes of parameters per configuration and writes 4, while every sample
// costs one Philox4x32-10 (two with shape noise), 3-5 erf_inv (a log1pf and
// a degree-8 polynomial each), one sincosf and ~40 FP32 operations.
//
// Design:
// - the grid is (configuration, 4,096-sample chunk), so the adaptive tail's
//   256 rows x 100,000 samples still fill the card; a block of 256 threads
//   keeps its row in registers;
// - each thread evaluates S = 4 samples at once: their Philox rounds,
//   polynomials and sincosf are independent chains that hide each other's
//   latency. A thread's 16 samples are index first + thread + 256 m,
//   m < 16, in batches of S, so S changes no sample's owner or order.
//   S = 4 against 1 and 2: see the note at `S`;
// - the stream's round keys from the launcher, in the constant bank, and
//   its counter words 1-3 folded once a block (mc_stream.cuh); the sample
//   index in 32 bits when the launch's indices share their high word
//   (every launch of the main path), a second instantiation with 64-bit
//   indices otherwise;
// - a warp leaves the sample loop together, so erf_inv's vote names the
//   whole warp;
// - the four axis tests as one predicate, with no short-circuit branch.
// Hits are summed in a register, a warp shuffle reduces them, and one int32
// atomicAdd per warp lands the warp's sum in counts[c]. Integer sums do not
// depend on order, and each sample's operations are fixed (the expressions
// below keep the parent's shapes, so nvcc contracts the same products), so
// counts are a pure function of (key, uid, round tag, sample index): they do
// not change with S, the grid, repacking, row order or cross-batch overlap.
//
// The wrapper (ops/mc_cuda.py) allocates `counts` zeroed; the kernel only
// accumulates into it and allocates nothing.

#include <cuda_runtime.h>
#include <stdint.h>

#include "mc_stream.cuh"

namespace {

using namespace collide2d::mc_stream;

constexpr int kThreads = 256;
constexpr int kSamplesPerThread = 16;
constexpr long long kSamplesPerBlock =
    static_cast<long long>(kThreads) * kSamplesPerThread;
// Samples a thread evaluates at once. At 100,000 rows x 4,096 samples on an
// H100 (one call, each against S = 2 in turns): without shape noise, the
// main path's case, S = 4 4.18 ms against 4.37 (32 registers, 8 blocks an
// SM, against 40 and 6) and S = 1 4.66 against 4.35; the adaptive tail
// (256 x 100,000) S = 4 0.273 against 0.284; with shape noise S = 4 6.96
// against 6.71 (40 and 42 registers, 6 blocks an SM either way) and S = 1
// 6.97 against 6.70.
constexpr int S = 4;
static_assert(kSamplesPerThread % S == 0, "S must divide 16");
// The normals: erf_inv, or Box-Muller pairs in a build with -DMC_BOX_MULLER=1
// (mc_stream.cuh::box_muller_pair; the TPU kernel's normal_method).
#if defined(MC_BOX_MULLER) && MC_BOX_MULLER
constexpr bool kBoxMuller = true;
#else
constexpr bool kBoxMuller = false;
#endif

// Parameter columns of one configuration (ops/mc_cuda.py::pack_mc_params).
struct Params {
  float px, py, cos_a, sin_a, theta, hx1, hy1, ow_h, oh_h, sx, sy, sth, swh,
      shh;
};

// True when the sampled obstacle does NOT touch the robot: the
// relative-angle form of the oriented-box test (mc_pallas.py:159-204).
__device__ __forceinline__ bool obb_separated(const Params& q, float z_dx,
                                              float z_dy, float z_th,
                                              float a, float b) {
  const float dx = z_dx * q.sx;
  const float dy = z_dy * q.sy;
  const float delta = q.theta - z_th * q.sth;
  float sd_raw, cd_raw;
  sincosf(delta, &sd_raw, &cd_raw);
  const float cd = fabsf(cd_raw);
  const float sd = fabsf(sd_raw);
  const float dxv = q.px - dx;
  const float dyv = q.py - dy;
  const float u = dxv * q.cos_a + dyv * q.sin_a;
  const float v = -dxv * q.sin_a + dyv * q.cos_a;
  return (fabsf(u) > q.hx1 + a * cd + b * sd) |
         (fabsf(v) > q.hy1 + a * sd + b * cd) |
         (fabsf(u * cd_raw - v * sd_raw) > a + q.hx1 * cd + q.hy1 * sd) |
         (fabsf(u * sd_raw + v * cd_raw) > b + q.hx1 * sd + q.hy1 * cd);
}

template <bool kShapeNoise, bool kWide>
__global__ void __launch_bounds__(kThreads)
    mc_counts_kernel(const float* __restrict__ params,
                     const int32_t* __restrict__ uids,
                     int32_t* __restrict__ counts, long long n,
                     long long offset, const __grid_constant__ PhiloxKey key) {
  const int c = blockIdx.x;
  const float* row = params + static_cast<long long>(c) * 16;
  Params q;
  q.px = __ldg(row + 0);
  q.py = __ldg(row + 1);
  q.cos_a = __ldg(row + 2);
  q.sin_a = __ldg(row + 3);
  q.hx1 = __ldg(row + 4);
  q.hy1 = __ldg(row + 5);
  q.ow_h = __ldg(row + 6);
  q.oh_h = __ldg(row + 7);
  q.sx = __ldg(row + 8);
  q.sy = __ldg(row + 9);
  q.sth = __ldg(row + 10);
  q.swh = __ldg(row + 11);
  q.shh = __ldg(row + 12);
  q.theta = __ldg(row + 13);
  const uint32_t uid = static_cast<uint32_t>(__ldg(uids + c));

  const long long first = static_cast<long long>(blockIdx.y) * kSamplesPerBlock;
  const unsigned long long base = static_cast<unsigned long long>(offset + first);
  const SampleStream<kWide> draw0(base, uid, 0u, key);
  const SampleStream<kWide> draw1(base, uid, 1u, key);
  const long long left = n - first;
  const int count = left < kSamplesPerBlock ? static_cast<int>(left)
                                            : static_cast<int>(kSamplesPerBlock);

  int hits = 0;
  // a warp leaves the loop together, when its first lane's batch starts past
  // the end; lanes past it evaluate samples that are not counted
  const int warp0 = static_cast<int>(threadIdx.x) & ~31;
#pragma unroll 1
  for (int m = 0; m < kSamplesPerThread; m += S) {
    if (warp0 + kThreads * m >= count) break;
    const int k0 = static_cast<int>(threadIdx.x) + kThreads * m;
    bool sep[S];
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const int k = k0 + kThreads * s;
      const Philox4 r = draw0(k, key);
      if constexpr (kBoxMuller) {
        // pairs (words 0, 1), (2, 3) and, with shape noise, block 1's (0, 1)
        const NormalPair p0 = box_muller_pair(r.v[0], r.v[1]);
        const NormalPair p1 = box_muller_pair(r.v[2], r.v[3]);
        float a, b;
        if (kShapeNoise) {
          const Philox4 r2 = draw1(k, key);
          const NormalPair p2 = box_muller_pair(r2.v[0], r2.v[1]);
          a = fabsf(q.ow_h + p1.s * q.swh);
          b = fabsf(q.oh_h + p2.c * q.shh);
        } else {
          a = fabsf(q.ow_h);
          b = fabsf(q.oh_h);
        }
        sep[s] = obb_separated(q, p0.c, p0.s, p1.c, a, b);
        continue;
      }
      const float z_dx = normal_from_word(r.v[0], kWarp);
      const float z_dy = normal_from_word(r.v[1], kWarp);
      const float z_th = normal_from_word(r.v[2], kWarp);
      float a, b;
      if (kShapeNoise) {
        const Philox4 r2 = draw1(k, key);
        a = fabsf(q.ow_h + normal_from_word(r.v[3], kWarp) * q.swh);
        b = fabsf(q.oh_h + normal_from_word(r2.v[0], kWarp) * q.shh);
      } else {
        a = fabsf(q.ow_h);
        b = fabsf(q.oh_h);
      }
      sep[s] = obb_separated(q, z_dx, z_dy, z_th, a, b);
    }
#pragma unroll
    for (int s = 0; s < S; ++s) {
      hits += (k0 + kThreads * s < count && !sep[s]) ? 1 : 0;
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    hits += __shfl_down_sync(0xffffffffu, hits, o);
  }
  if ((threadIdx.x & 31) == 0 && hits != 0) {
    atomicAdd(counts + c, hits);
  }
}

template <bool kShapeNoise>
void launch(const dim3& grid, cudaStream_t s, bool wide, const float* params,
            const int32_t* uids, int32_t* counts, long long n, long long offset,
            const PhiloxKey& key) {
  if (wide) {
    mc_counts_kernel<kShapeNoise, true><<<grid, kThreads, 0, s>>>(
        params, uids, counts, n, offset, key);
  } else {
    mc_counts_kernel<kShapeNoise, false><<<grid, kThreads, 0, s>>>(
        params, uids, counts, n, offset, key);
  }
}

}  // namespace

// Plain C entry point (bound with ctypes). Launches on `stream`, does not
// synchronise, and returns cudaGetLastError() after the launch (0 = ok).
extern "C" int mc_counts_launch(const float* params, const int32_t* uids,
                                int32_t* counts, int num_configs, long long n,
                                long long offset, uint32_t seed0,
                                uint32_t seed1, int shape_noise,
                                void* stream) {
  if (num_configs <= 0 || n <= 0) return static_cast<int>(cudaSuccess);
  const long long chunks = (n + kSamplesPerBlock - 1) / kSamplesPerBlock;
  if (chunks > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(num_configs),
                  static_cast<unsigned>(chunks));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool wide = !narrow_indices(offset, n);
  const PhiloxKey key = philox_key(seed0, seed1);
  if (shape_noise) {
    launch<true>(grid, s, wide, params, uids, counts, n, offset, key);
  } else {
    launch<false>(grid, s, wide, params, uids, counts, n, offset, key);
  }
  return static_cast<int>(cudaGetLastError());
}

// Launch-free constant the wrapper checks against its own sample cap.
extern "C" long long mc_max_samples_per_round() {
  return 65535LL * kSamplesPerBlock;
}

// Samples a thread evaluates at once (S): one iteration of the sample loop.
extern "C" int mc_batch_samples() { return S; }
