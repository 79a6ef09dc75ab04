// Fused trajectory Monte Carlo counts for translation-only convex k-gons
// (kernel 14) on Hopper.
//
// Replaces the TPU kernel collide2d_tpu/ops/mc_moving_polygon_pallas.py::
// _mc_moving_poly_kernel (:182). For each configuration row c it returns
// the int32 number of samples among n whose noisy obstacle the robot,
// translating by v t over the unit horizon (omega == 0, the caller's
// contract), touches. Per sample: kernel 7's 3 standard normals (dx, dy,
// dtheta) and table blends (mc_polygon_kernel.cu), then the EXACT
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
// Design, kernel 7's: the grid is (configuration, 4,096-sample chunk), a
// block of 256 threads stages its row's table (kernel 7's rows + 2, padded
// to 8) in shared memory once and each thread loops over 16 samples,
// reading the table as broadcasts; a warp shuffle and one int32 atomicAdd
// per warp land the hits. Every axis of every sample is evaluated (no
// early exit), so the work does not depend on the data.
//
// What bounds it on this card: operations. A round reads a row's table once
// and writes 4 bytes; a sample costs one Philox4x32-10, 3 erf_inv, one
// sincosf and, per kept robot axis, 5K + 10 operations plus a division,
// per obstacle normal 5 K2 + 10 plus a division (chip_smoke.py counts them).
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

// a*b + c*d with both products and the sum rounded on their own.
__device__ __forceinline__ float dot2(float a, float b, float c, float d) {
  return __fadd_rn(__fmul_rn(a, b), __fmul_rn(c, d));
}

// First row of each table block (mc_polygon_cuda.py::_offsets, then the
// relative-velocity rows).
struct Layout {
  int k, k2, k2a;
  int ax, ay, rmin, rmax, nx, ny, nmin, nmax, p1, p2, q1, q2, v;
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
  L.v = L.q2 + k * k2;
  return L;
}

// Intersect the running window [entry, exit] with one axis's window: body 1
// [m1, M1] static, body 2 [m2, M2] moving at speed s.
__device__ __forceinline__ void axis_window(float m1, float big_m1, float m2,
                                            float big_m2, float s,
                                            float& entry, float& exit) {
  const bool zero = s == 0.0f;
  const float inv = __fdiv_rn(1.0f, zero ? 1.0f : s);
  const float ta = __fmul_rn(__fsub_rn(big_m1, m2), inv);
  const float tb = __fmul_rn(__fsub_rn(m1, big_m2), inv);
  const bool inside = m2 <= big_m1 && m1 <= big_m2;
  const float lo = zero ? (inside ? -INFINITY : INFINITY) : fminf(ta, tb);
  const float hi = zero ? (inside ? INFINITY : -INFINITY) : fmaxf(ta, tb);
  entry = fmaxf(entry, lo);
  exit = fminf(exit, hi);
}

// True when the translating robot touches the sampled obstacle.
__device__ __forceinline__ bool poly_window_hit(const float* __restrict__ t,
                                                const Layout& L, float z_dx,
                                                float z_dy, float z_th) {
  const float dx = __fmul_rn(z_dx, t[0]);
  const float dy = __fmul_rn(z_dy, t[1]);
  const float th = __fmul_rn(z_th, t[2]);
  float st, ct;
  sincosf(th, &st, &ct);
  const float u1 = dot2(ct, dx, st, dy);
  const float u2 = __fsub_rn(__fmul_rn(ct, dy), __fmul_rn(st, dx));
  const float vx = t[L.v], vy = t[L.v + 1];
  const float w1 = dot2(ct, vx, st, vy);
  const float w2 = __fsub_rn(__fmul_rn(ct, vy), __fmul_rn(st, vx));
  float entry = -INFINITY, exit = INFINITY;
  for (int i = 0; i < L.k2a; ++i) {
    const float ax = t[L.ax + i], ay = t[L.ay + i];
    const float at = dot2(ax, dx, ay, dy);
    const float* p1 = t + L.p1 + i * L.k;
    const float* p2 = t + L.p2 + i * L.k;
    float mn = dot2(ct, p1[0], st, p2[0]);
    float mx = mn;
    for (int j = 1; j < L.k; ++j) {
      const float p = dot2(ct, p1[j], st, p2[j]);
      mn = fminf(mn, p);
      mx = fmaxf(mx, p);
    }
    axis_window(t[L.rmin + i], t[L.rmax + i], __fadd_rn(mn, at),
                __fadd_rn(mx, at), dot2(ax, vx, ay, vy), entry, exit);
  }
  for (int j = 0; j < L.k; ++j) {
    const float nx = t[L.nx + j], ny = t[L.ny + j];
    const float bt = dot2(nx, u1, ny, u2);
    const float* q1 = t + L.q1 + j * L.k2;
    const float* q2 = t + L.q2 + j * L.k2;
    float mn = dot2(ct, q1[0], st, q2[0]);
    float mx = mn;
    for (int i = 1; i < L.k2; ++i) {
      const float p = dot2(ct, q1[i], st, q2[i]);
      mn = fminf(mn, p);
      mx = fmaxf(mx, p);
    }
    axis_window(mn, mx, __fadd_rn(t[L.nmin + j], bt), __fadd_rn(t[L.nmax + j], bt),
                dot2(nx, w1, ny, w2), entry, exit);
  }
  return entry <= exit && entry <= 1.0f && exit >= 0.0f;
}

__global__ void __launch_bounds__(kThreads)
    mc_moving_poly_counts_kernel(const float* __restrict__ params,
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
    hits += poly_window_hit(table, L, normal_from_word(r.v[0]),
                            normal_from_word(r.v[1]), normal_from_word(r.v[2]))
                ? 1
                : 0;
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
extern "C" int mc_moving_poly_counts_launch(const float* params,
                                            const int32_t* uids,
                                            int32_t* counts, int num_configs,
                                            int rows, int k, int k2, int k2a,
                                            long long n, long long offset,
                                            uint32_t seed0, uint32_t seed1,
                                            void* stream) {
  if (num_configs <= 0 || n <= 0) return static_cast<int>(cudaSuccess);
  if (k < 1 || k2 < 1 || k2a < 0 || k2a > k2 || rows < 5)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long chunks = (n + kSamplesPerBlock - 1) / kSamplesPerBlock;
  if (chunks > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const size_t shared = static_cast<size_t>(rows) * sizeof(float);
  if (shared > kDefaultSharedBytes) {
    const cudaError_t err = cudaFuncSetAttribute(
        mc_moving_poly_counts_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(shared));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid(static_cast<unsigned>(num_configs),
                  static_cast<unsigned>(chunks));
  mc_moving_poly_counts_kernel<<<grid, kThreads, shared,
                                 static_cast<cudaStream_t>(stream)>>>(
      params, uids, counts, rows, k, k2, k2a, n, offset, seed0, seed1);
  return static_cast<int>(cudaGetLastError());
}

// Launch-free constant the wrapper checks against its own sample cap.
extern "C" long long mc_moving_poly_max_samples_per_round() {
  return 65535LL * kSamplesPerBlock;
}
