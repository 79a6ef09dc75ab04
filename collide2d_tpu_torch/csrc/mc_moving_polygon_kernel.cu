// Fused trajectory Monte Carlo counts for translation-only convex k-gons
// (kernel 14) on Hopper.
//
// Replaces the TPU kernel collide2d_tpu/ops/mc_moving_polygon_pallas.py::
// _mc_moving_poly_kernel (:182). For each configuration row c it returns
// the int32 number of samples among n whose noisy obstacle the robot,
// translating by v t over the unit horizon (omega == 0, the caller's
// contract), touches. Per sample: kernel 7's 3 standard normals (dx, dy,
// dtheta; erf_inv, or Box-Muller in a -DMC_BOX_MULLER=1 build) and table
// blends (mc_polygon_kernel.cu), then the EXACT
// first-contact window per SAT axis (`_axis_window`, mc_moving_polygon_
// pallas.py:102-113), the obstacle moving by t v_rel (v_rel = -v t_max, the
// table's last two rows):
//
//   robot axis i:     [rmin_i, rmax_i] static, obstacle [mn + at, mx + at]
//                     moving at s = ax_i vx + ay_i vy (sample-invariant);
//   obstacle normal j: robot [mn, mx] static, obstacle [nmin_j + bt,
//                     nmax_j + bt] moving at s = nx_j w1 + ny_j w2, with
//                     (w1, w2) = R(dtheta)^T v_rel;
//   window: s == 0 gives every t when the intervals overlap, else none;
//           otherwise [min(ta, tb), max(ta, tb)], ta = (M1 - m2) / s,
//           tb = (m1 - M2) / s;
//   hit:    max lo <= min hi, max lo <= 1, min hi >= 0.
//
// At zero velocity every s is 0 and each window is kernel 7's interval test
// on the same table entries: the counts equal kernel 7's bit for bit on the
// same stream.
//
// What bounds it on this card: instruction issue. A round reads a row's
// table once and writes 4 bytes; a sample costs one Philox4x32-10, 3
// erf_inv, one sincosf and, per kept robot axis, 5K + 10 operations plus a
// division, per obstacle normal 5 K2 + 10 plus a division (chip_smoke.py
// counts them).
//
// Design, kernel 7's (one library per shape, the (configuration, 4,096-
// sample chunk) grid, the row's table staged in 16-byte shared-memory slots,
// S samples a thread at once sharing every broadcast load; csrc/
// mc_polygon.cuh; the stream of csrc/mc_stream.cuh with 32-bit indices
// unless a launch crosses 2^32), plus: the robot axes' speeds and their IEEE reciprocals
// depend only on the row, so the block computes them once while it stages
// the table (the same operations, so the same bits) and a sample divides
// only on the K obstacle normals. S is 2, as in kernel 7: a sample carries
// its window and relative velocity besides kernel 7's state, and at S = 4
// the kernel needs 85 registers, which leaves 2 blocks an SM; at S = 2 it
// needs 59 and 4 fit (11.87 against 12.54 ms at 100k x 4,096, K = 8, on an
// H100).
//
// Rounding. Every blend, projection, speed and window term is __fmul_rn /
// __fadd_rn / __fsub_rn, divisions IEEE (__fdiv_rn): the kernel and its
// plain version (ops/mc_moving_polygon_cuda.py) differ only where sincosf
// and log1pf round unlike torch.
//
// The wrapper allocates `counts` zeroed; the kernel only accumulates.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mc_polygon.cuh"
#include "mc_stream.cuh"

#if !defined(MC_POLY_K) || !defined(MC_POLY_K2) || !defined(MC_POLY_K2A)
#error "build one library per shape: -DMC_POLY_K=k -DMC_POLY_K2=k2 -DMC_POLY_K2A=k2a"
#endif

namespace {

using namespace collide2d;
using namespace collide2d::mc_polygon;
using collide2d::mc_stream::PhiloxKey;
using collide2d::mc_stream::SampleStream;

constexpr int K = MC_POLY_K, K2 = MC_POLY_K2, K2A = MC_POLY_K2A;
constexpr int S = 2;
constexpr int kThreads = 256;
constexpr int kSamplesPerThread = 16;
constexpr long long kSamplesPerBlock =
    static_cast<long long>(kThreads) * kSamplesPerThread;
constexpr int kDefaultSharedBytes = 48 * 1024;
static_assert(kSamplesPerThread % S == 0, "S must divide 16");
using T = Table<K, K2, K2A>;
// kernel 7's row, then v_rel (x, y), padded to 8 floats
constexpr int kVel = T::kWidth;
constexpr int kRows = (T::kWidth + 2 + 7) / 8 * 8;
// after kernel 7's slots: one (s, 1 / s, 0, 0) slot per robot axis
constexpr int kSpeed = T::kSlots;
constexpr int kSlots = T::kSlots + K2A;

// The reciprocal of an axis's speed s, 1 where s == 0 (its window is then
// the static interval test).
__device__ __forceinline__ float speed_inverse(float s) {
  return __fdiv_rn(1.0f, s == 0.0f ? 1.0f : s);
}

// Intersect the running window [entry, exit] with one axis's window: body 1
// [m1, M1] static, body 2 [m2, M2] moving at speed s, inv = speed_inverse(s).
__device__ __forceinline__ void axis_window(float m1, float big_m1, float m2,
                                            float big_m2, float s, float inv,
                                            float& entry, float& exit) {
  const bool zero = s == 0.0f;
  const float ta = __fmul_rn(__fsub_rn(big_m1, m2), inv);
  const float tb = __fmul_rn(__fsub_rn(m1, big_m2), inv);
  const bool inside = m2 <= big_m1 && m1 <= big_m2;
  const float lo = zero ? (inside ? -INFINITY : INFINITY) : fminf(ta, tb);
  const float hi = zero ? (inside ? INFINITY : -INFINITY) : fmaxf(ta, tb);
  entry = fmaxf(entry, lo);
  exit = fminf(exit, hi);
}

template <bool kWide>
__global__ void __launch_bounds__(kThreads, 2)
    mc_moving_poly_counts_kernel(const float* __restrict__ params,
                                 const int32_t* __restrict__ uids,
                                 int32_t* __restrict__ counts, long long n,
                                 long long offset,
                                 const __grid_constant__ PhiloxKey key) {
  extern __shared__ float4 table[];
  const int c = blockIdx.x;
  const float* row = params + static_cast<long long>(c) * kRows;
  const float vx = __ldg(row + kVel), vy = __ldg(row + kVel + 1);
  for (int e = threadIdx.x; e < kSlots; e += kThreads) {
    if (e < T::kSlots) {
      table[e] = table_slot<K, K2, K2A>(row, e);
    } else {  // robot axis i's speed, sample-invariant
      const int i = e - kSpeed;
      const float s = dot2(__ldg(row + T::kAx + i), vx, __ldg(row + T::kAy + i), vy);
      table[e] = make_float4(s, speed_inverse(s), 0.0f, 0.0f);
    }
  }
  const float sigma_x = __ldg(row), sigma_y = __ldg(row + 1);
  const float sigma_th = __ldg(row + 2);
  const uint32_t uid = static_cast<uint32_t>(__ldg(uids + c));
  const SampleStream<kWide> draw(
      static_cast<unsigned long long>(offset) +
          static_cast<unsigned long long>(blockIdx.y) * kSamplesPerBlock,
      uid, 0u, key);
  __syncthreads();

  int hits = 0;
  const long long begin =
      static_cast<long long>(blockIdx.y) * kSamplesPerBlock + threadIdx.x;
  long long end = static_cast<long long>(blockIdx.y) * kSamplesPerBlock +
                  kSamplesPerBlock;
  if (end > n) end = n;
#pragma unroll 1
  for (int b = 0; b < kSamplesPerThread / S; ++b) {
    if (begin + static_cast<long long>(kThreads) * (b * S) >= end) break;
    Pose p[S];
    float w1[S], w2[S], entry[S], exit[S];
#pragma unroll
    for (int s = 0; s < S; ++s) {
      p[s] = sample_pose(draw(threadIdx.x + kThreads * (b * S + s), key), sigma_x,
                         sigma_y, sigma_th);
      w1[s] = dot2(p[s].ct, vx, p[s].st, vy);  // (R^T v_rel)
      w2[s] = __fsub_rn(__fmul_rn(p[s].ct, vy), __fmul_rn(p[s].st, vx));
      entry[s] = -INFINITY;
      exit[s] = INFINITY;
    }
#pragma unroll
    for (int i = 0; i < K2A; ++i) {
      const float4 a = table[T::kRobot + i];  // (ax, ay, rmin, rmax)
      const float4 v = table[kSpeed + i];     // (s, 1 / s)
      float mn[S], mx[S];
      blend_min_max<K>(table + T::kP + i * T::kPSlots, p, mn, mx);
#pragma unroll
      for (int s = 0; s < S; ++s) {
        const float at = dot2(a.x, p[s].dx, a.y, p[s].dy);
        axis_window(a.z, a.w, __fadd_rn(mn[s], at), __fadd_rn(mx[s], at), v.x,
                    v.y, entry[s], exit[s]);
      }
    }
#pragma unroll
    for (int j = 0; j < K; ++j) {
      const float4 nv = table[T::kNormal + j];  // (nx, ny, nmin, nmax)
      float mn[S], mx[S];
      blend_min_max<K2>(table + T::kQ + j * T::kQSlots, p, mn, mx);
#pragma unroll
      for (int s = 0; s < S; ++s) {
        const float bt = dot2(nv.x, p[s].u1, nv.y, p[s].u2);
        const float speed = dot2(nv.x, w1[s], nv.y, w2[s]);
        axis_window(mn[s], mx[s], __fadd_rn(nv.z, bt), __fadd_rn(nv.w, bt), speed,
                    speed_inverse(speed), entry[s], exit[s]);
      }
    }
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const long long j = begin + static_cast<long long>(kThreads) * (b * S + s);
      const bool hit =
          entry[s] <= exit[s] && entry[s] <= 1.0f && exit[s] >= 0.0f;
      hits += (j < end && hit) ? 1 : 0;
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

template <bool kWide>
int launch(const dim3& grid, size_t shared, cudaStream_t s, const float* params,
           const int32_t* uids, int32_t* counts, long long n, long long offset,
           const PhiloxKey& key) {
  if (shared > kDefaultSharedBytes) {
    const cudaError_t err =
        cudaFuncSetAttribute(mc_moving_poly_counts_kernel<kWide>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(shared));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  mc_moving_poly_counts_kernel<kWide><<<grid, kThreads, shared, s>>>(
      params, uids, counts, n, offset, key);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry point (bound with ctypes). (rows, k, k2, k2a) must be the
// shape this library was built for. Launches on `stream`, does not
// synchronise, and returns the first CUDA error (0 = ok).
extern "C" int mc_moving_poly_counts_launch(const float* params,
                                            const int32_t* uids,
                                            int32_t* counts, int num_configs,
                                            int rows, int k, int k2, int k2a,
                                            long long n, long long offset,
                                            uint32_t seed0, uint32_t seed1,
                                            void* stream) {
  if (num_configs <= 0 || n <= 0) return static_cast<int>(cudaSuccess);
  if (k != K || k2 != K2 || k2a != K2A || rows != kRows)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long chunks = (n + kSamplesPerBlock - 1) / kSamplesPerBlock;
  if (chunks > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const size_t shared = static_cast<size_t>(kSlots) * sizeof(float4);
  const dim3 grid(static_cast<unsigned>(num_configs),
                  static_cast<unsigned>(chunks));
  const PhiloxKey key = collide2d::mc_stream::philox_key(seed0, seed1);
  // 32-bit sample indices unless the launch crosses 2^32 (mc_stream.cuh)
  return collide2d::mc_stream::narrow_indices(offset, n)
             ? launch<false>(grid, shared, static_cast<cudaStream_t>(stream),
                             params, uids, counts, n, offset, key)
             : launch<true>(grid, shared, static_cast<cudaStream_t>(stream),
                            params, uids, counts, n, offset, key);
}

// Launch-free constant the wrapper checks against its own sample cap.
extern "C" long long mc_moving_poly_max_samples_per_round() {
  return 65535LL * kSamplesPerBlock;
}

// Samples a thread evaluates at once (S): one iteration of the sample loop.
extern "C" int mc_moving_poly_batch_samples() { return S; }
