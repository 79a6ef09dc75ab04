// Fused Monte Carlo collision counts for convex k-gon configurations, on
// Hopper (kernel 7).
//
// Replaces the TPU kernel collide2d_tpu/ops/mc_polygon_pallas.py::
// _mc_poly_kernel. For each configuration row c it returns the int32 number
// of colliding samples among n noise draws: per sample 3 standard normals
// (dx, dy, dtheta) from 23-bit codes through XLA's float32 erf_inv (in a
// build with -DMC_BOX_MULLER=1, two Box-Muller pairs: mc_polygon.cuh::
// sample_pose, the TPU kernel's normal_method="box_muller"), then the
// separation test `_poly_separated` (mc_polygon_pallas.py:199-251) over the
// row's precomputed tables (ops/mc_polygon_cuda.py::pack_polygon_mc_params):
//
//   robot axis i (K2A kept):  at = ax_i dx + ay_i dy,
//     obstacle interval = min/max_j (ct P1[i,j] + st P2[i,j]),
//     separated if  max + at < rmin_i  or  rmax_i < min + at;
//   obstacle normal j (K):    bt = nx_j u1 + ny_j u2,
//     robot interval = min/max_i (ct Q1[j,i] + st Q2[j,i]),
//     separated if  max < nmin_j + bt  or  nmax_j + bt < min,
//
// with (ct, st) = sincos(dtheta) and (u1, u2) = R(dtheta)^T (dx, dy).
//
// What bounds it on this card: instruction issue. A round reads a row's
// table once (144 floats at K = 8, K2 = 4, K2A = 2) and writes 4 bytes,
// while each sample costs one Philox4x32-10, 3 erf_inv (a log1pf and a
// degree-8 polynomial each), one sincosf and the test's K2A (5K + 5) +
// K (5 K2 + 5) + 9 FP32 operations (299 at that shape). Every blend,
// projection and translation term is __fmul_rn / __fadd_rn, so the kernel
// and its plain version differ only where sincosf and log1pf round
// differently from torch; that forbids FMA contraction there, and each of
// those operations costs a full instruction.
//
// Design (csrc/mc_polygon.cuh has the parts it shares with kernel 14,
// csrc/mc_stream.cuh the sample stream of kernels 1, 7, 13 and 14):
// - one library per shape: K, K2 and K2A come from the build's -D defines,
//   so every vertex and axis loop unrolls and every table offset is a
//   constant; any shape builds (K > 16 and K2A = 0 too);
// - the grid is (configuration, 4,096-sample chunk), so the adaptive
//   tail's 256 rows still fill the card; a block of 256 threads stages its
//   row's table in shared memory once, in 16-byte slots;
// - each thread evaluates S = 2 samples at once: every slot it loads, a
//   broadcast, serves S samples, and the S independent chains hide each
//   other's latency; a thread's 16 samples are index begin + thread + 256 m,
//   m < 16, in batches of S, so S changes no sample's owner or order. S = 2
//   takes 46 registers, 5 blocks an SM, and beat S = 4 (69 registers, 3
//   blocks: 8.75 against 8.43 ms at 100k x 4,096, K = 8, on an H100) and
//   S = 8 (spills); asking the launch bound for 3 or 4 blocks an SM instead
//   of 2 cost 4-7%;
// - the stream's round keys from the launcher and 32-bit sample indices
//   unless a launch crosses 2^32, as kernel 1's (a second instantiation
//   takes 64-bit indices);
// - hits are summed in a register, a warp shuffle reduces them and one
//   int32 atomicAdd per warp lands the warp's sum in counts[c]. Integer sums
//   do not depend on order, and each sample's operations and their order
//   are fixed, so counts are the same whatever S, grid or block size.
// Every axis is tested for every sample (no early exit), as the TPU kernel
// does, so the work does not depend on the data.
//
// The wrapper allocates `counts` zeroed; the kernel only accumulates into it
// and allocates nothing.

#include <cuda_runtime.h>
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
// the wrapper's table width: the unpadded row padded to 8 floats
constexpr int kRows = (T::kWidth + 7) / 8 * 8;

template <bool kWide>
__global__ void __launch_bounds__(kThreads, 2)
    mc_poly_counts_kernel(const float* __restrict__ params,
                          const int32_t* __restrict__ uids,
                          int32_t* __restrict__ counts, long long n,
                          long long offset,
                          const __grid_constant__ PhiloxKey key) {
  extern __shared__ float4 table[];
  const int c = blockIdx.x;
  const float* row = params + static_cast<long long>(c) * kRows;
  for (int e = threadIdx.x; e < T::kSlots; e += kThreads) {
    table[e] = table_slot<K, K2, K2A>(row, e);
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
    bool sep[S];
#pragma unroll
    for (int s = 0; s < S; ++s) {
      p[s] = sample_pose(draw(threadIdx.x + kThreads * (b * S + s), key), sigma_x,
                         sigma_y, sigma_th);
      sep[s] = false;
    }
#pragma unroll
    for (int i = 0; i < K2A; ++i) {
      const float4 a = table[T::kRobot + i];  // (ax, ay, rmin, rmax)
      float mn[S], mx[S];
      blend_min_max<K>(table + T::kP + i * T::kPSlots, p, mn, mx);
#pragma unroll
      for (int s = 0; s < S; ++s) {
        const float at = dot2(a.x, p[s].dx, a.y, p[s].dy);
        sep[s] = sep[s] | (__fadd_rn(mx[s], at) < a.z) |
                 (a.w < __fadd_rn(mn[s], at));
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
        sep[s] = sep[s] | (mx[s] < __fadd_rn(nv.z, bt)) |
                 (__fadd_rn(nv.w, bt) < mn[s]);
      }
    }
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const long long j = begin + static_cast<long long>(kThreads) * (b * S + s);
      hits += (j < end && !sep[s]) ? 1 : 0;
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
        cudaFuncSetAttribute(mc_poly_counts_kernel<kWide>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(shared));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  mc_poly_counts_kernel<kWide><<<grid, kThreads, shared, s>>>(
      params, uids, counts, n, offset, key);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry point (bound with ctypes). (rows, k, k2, k2a) must be the
// shape this library was built for. Launches on `stream`, does not
// synchronise, and returns the first CUDA error (0 = ok).
extern "C" int mc_poly_counts_launch(const float* params, const int32_t* uids,
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
  const size_t shared = static_cast<size_t>(T::kSlots) * sizeof(float4);
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
extern "C" long long mc_poly_max_samples_per_round() {
  return 65535LL * kSamplesPerBlock;
}

// Samples a thread evaluates at once (S): one iteration of the sample loop.
extern "C" int mc_poly_batch_samples() { return S; }
