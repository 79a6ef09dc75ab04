// Fused Monte Carlo collision counts for convex k-gon configurations, on
// Hopper.
//
// Replaces the TPU kernel collide2d_tpu/ops/mc_polygon_pallas.py::
// _mc_poly_kernel. For each configuration row c it returns the int32 number
// of colliding samples among n noise draws: per sample 3 standard normals
// (dx, dy, dtheta) from 23-bit codes through XLA's float32 erf_inv, then the
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
// What bounds it on this card: operations, not memory. A round reads a
// row's table once (ROWS floats: 144 at K = 8, K2 = 4, K2A = 2) and writes
// 4 bytes, while each sample costs one Philox4x32-10, 3 erf_inv (a log1pf
// and a degree-8 polynomial each), one sincosf and the test's
// K2A (5K + 5) + K (5 K2 + 5) + 9 FP32 operations: 299 at K = 8, K2 = 4,
// K2A = 2, against ~40 for the rectangle kernel (mc_kernel.cu). Every
// blend, projection and translation term is __fmul_rn / __fadd_rn, so the
// kernel and its plain version differ only where sincosf and log1pf round
// differently from torch; that forbids FMA contraction there, and each of
// those operations costs a full instruction.
//
// Design, as kernel 1's: the grid is (configuration, 4,096-sample chunk), so
// the adaptive tail's 256 rows still fill the card. A block of 256 threads
// stages its row's table in shared memory once (ROWS x 4 bytes, 4.6 KB at
// K = K2 = 16; dynamic, raised above 48 KB when a large K needs it), each
// thread loops over 16 samples reading the table as broadcasts, sums its
// hits in a register, a warp shuffle reduces them and one int32 atomicAdd
// per warp lands the warp's sum in counts[c]. Integer sums do not depend on
// order, so counts are deterministic. Every axis is tested for every sample
// (no early exit), as the TPU kernel does, so the work does not depend on
// the data.
//
// Randomness: kernel 1's stream with shape noise off. Philox4x32-10 keyed by
// the round's two seed words (the folded threefry key), counter (sample
// index low, sample index high, uid, 0), words 0-2. Counts are a pure
// function of (key, uid, round tag, sample index): they do not change with
// grid shape, repacking, row order or cross-batch overlap.
//
// The wrapper allocates `counts` zeroed; the kernel only accumulates into it
// and allocates nothing.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kSamplesPerThread = 16;
constexpr long long kSamplesPerBlock =
    static_cast<long long>(kThreads) * kSamplesPerThread;
constexpr int kDefaultSharedBytes = 48 * 1024;

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

// XLA's float32 erf_inv, as mc_kernel.cu's (log1pf stands in for XLA's
// Cephes log1p; 23-bit codes keep |x| <= 1 - 2^-23).
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

// One standard normal from a Philox word: its top 23 bits b give
// z = sqrt(2) * erfinv((b + 0.5) * 2^-22 - 1), finite by construction.
__device__ __forceinline__ float normal_from_word(uint32_t word) {
  const float u =
      (static_cast<float>(word >> 9) + 0.5f) * 2.384185791015625e-07f - 1.0f;
  return 1.41421356f * erfinv_f32(u);
}

// a*b + c*d with both products and the sum rounded on their own.
__device__ __forceinline__ float dot2(float a, float b, float c, float d) {
  return __fadd_rn(__fmul_rn(a, b), __fmul_rn(c, d));
}

// First row of each table block (mc_polygon_cuda.py::_offsets).
struct Layout {
  int k, k2, k2a;
  int ax, ay, rmin, rmax, nx, ny, nmin, nmax, p1, p2, q1, q2;
};

__device__ __forceinline__ Layout make_layout(int k, int k2, int k2a) {
  Layout L;
  L.k = k;
  L.k2 = k2;
  L.k2a = k2a;
  L.ax = 3;
  L.ay = 3 + k2a;
  L.rmin = 3 + 2 * k2a;
  L.rmax = 3 + 3 * k2a;
  L.nx = 3 + 4 * k2a;
  L.ny = L.nx + k;
  L.nmin = L.nx + 2 * k;
  L.nmax = L.nx + 3 * k;
  L.p1 = L.nx + 4 * k;
  L.p2 = L.p1 + k2a * k;
  L.q1 = L.p2 + k2a * k;
  L.q2 = L.q1 + k * k2;
  return L;
}

// True when the sampled obstacle does NOT touch the robot (`_poly_separated`).
__device__ __forceinline__ bool poly_separated(const float* __restrict__ t,
                                               const Layout& L, float z_dx,
                                               float z_dy, float z_th) {
  const float dx = __fmul_rn(z_dx, t[0]);
  const float dy = __fmul_rn(z_dy, t[1]);
  const float th = __fmul_rn(z_th, t[2]);
  float st, ct;
  sincosf(th, &st, &ct);
  const float u1 = dot2(ct, dx, st, dy);
  const float u2 = __fsub_rn(__fmul_rn(ct, dy), __fmul_rn(st, dx));
  bool sep = false;
  for (int i = 0; i < L.k2a; ++i) {
    const float at = dot2(t[L.ax + i], dx, t[L.ay + i], dy);
    const float* p1 = t + L.p1 + i * L.k;
    const float* p2 = t + L.p2 + i * L.k;
    float mn = dot2(ct, p1[0], st, p2[0]);
    float mx = mn;
    for (int j = 1; j < L.k; ++j) {
      const float p = dot2(ct, p1[j], st, p2[j]);
      mn = fminf(mn, p);
      mx = fmaxf(mx, p);
    }
    sep = sep | (__fadd_rn(mx, at) < t[L.rmin + i]) |
          (t[L.rmax + i] < __fadd_rn(mn, at));
  }
  for (int j = 0; j < L.k; ++j) {
    const float bt = dot2(t[L.nx + j], u1, t[L.ny + j], u2);
    const float* q1 = t + L.q1 + j * L.k2;
    const float* q2 = t + L.q2 + j * L.k2;
    float mn = dot2(ct, q1[0], st, q2[0]);
    float mx = mn;
    for (int i = 1; i < L.k2; ++i) {
      const float p = dot2(ct, q1[i], st, q2[i]);
      mn = fminf(mn, p);
      mx = fmaxf(mx, p);
    }
    sep = sep | (mx < __fadd_rn(t[L.nmin + j], bt)) |
          (__fadd_rn(t[L.nmax + j], bt) < mn);
  }
  return sep;
}

__global__ void __launch_bounds__(kThreads)
    mc_poly_counts_kernel(const float* __restrict__ params,
                          const int32_t* __restrict__ uids,
                          int32_t* __restrict__ counts, int rows, int k,
                          int k2, int k2a, long long n, long long offset,
                          uint32_t seed0, uint32_t seed1) {
  extern __shared__ float table[];
  const int c = blockIdx.x;
  const float* row = params + static_cast<long long>(c) * rows;
  for (int i = threadIdx.x; i < rows; i += kThreads) table[i] = __ldg(row + i);
  __syncthreads();
  const Layout L = make_layout(k, k2, k2a);
  const uint32_t uid = static_cast<uint32_t>(__ldg(uids + c));

  int hits = 0;
  const long long begin = static_cast<long long>(blockIdx.y) * kSamplesPerBlock;
  long long end = begin + kSamplesPerBlock;
  if (end > n) end = n;
  for (long long j = begin + threadIdx.x; j < end; j += kThreads) {
    const unsigned long long idx = static_cast<unsigned long long>(offset + j);
    const Philox4 r = philox4x32_10(static_cast<uint32_t>(idx),
                                    static_cast<uint32_t>(idx >> 32), uid, 0u,
                                    seed0, seed1);
    hits += poly_separated(table, L, normal_from_word(r.v[0]),
                           normal_from_word(r.v[1]), normal_from_word(r.v[2]))
                ? 0
                : 1;
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

// Plain C entry point (bound with ctypes). `rows` is the table width the
// wrapper checked against (k, k2, k2a). Launches on `stream`, does not
// synchronise, and returns the first CUDA error (0 = ok).
extern "C" int mc_poly_counts_launch(const float* params, const int32_t* uids,
                                     int32_t* counts, int num_configs,
                                     int rows, int k, int k2, int k2a,
                                     long long n, long long offset,
                                     uint32_t seed0, uint32_t seed1,
                                     void* stream) {
  if (num_configs <= 0 || n <= 0) return static_cast<int>(cudaSuccess);
  if (k < 1 || k2 < 1 || k2a < 0 || k2a > k2 || rows < 3)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long chunks = (n + kSamplesPerBlock - 1) / kSamplesPerBlock;
  if (chunks > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const size_t shared = static_cast<size_t>(rows) * sizeof(float);
  if (shared > kDefaultSharedBytes) {
    const cudaError_t err = cudaFuncSetAttribute(
        mc_poly_counts_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(shared));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid(static_cast<unsigned>(num_configs),
                  static_cast<unsigned>(chunks));
  mc_poly_counts_kernel<<<grid, kThreads, shared,
                          static_cast<cudaStream_t>(stream)>>>(
      params, uids, counts, rows, k, k2, k2a, n, offset, seed0, seed1);
  return static_cast<int>(cudaGetLastError());
}

// Launch-free constant the wrapper checks against its own sample cap.
extern "C" long long mc_poly_max_samples_per_round() {
  return 65535LL * kSamplesPerBlock;
}
