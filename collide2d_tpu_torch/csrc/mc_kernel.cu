// Fused Monte Carlo collision counts for rectangle configurations, on Hopper.
//
// Replaces the TPU kernel collide2d_tpu/ops/mc_pallas.py::_mc_kernel. For
// each configuration row c it returns the int32 number of colliding samples
// among n noise draws: per sample, 3 standard normals (dx, dy, dtheta) or 5
// with shape noise (+ dw, dh) from 23-bit codes through XLA's float32
// erf_inv polynomial, then the relative-angle 4-axis oriented-box test of
// `_obb_separated` (mc_pallas.py:159-204).
//
// What bounds it on this card: not memory. A round reads 64 bytes of
// parameters per configuration and writes 4, while every sample costs one
// Philox4x32-10 (two with shape noise), 3-5 erf_inv (a log1pf, a sqrtf and
// a degree-8 polynomial each), one sincosf and ~40 FP32 operations. It is
// bound by instruction issue and by how many SMs have work.
//
// The trap is the adaptive tail: after repacks the buffer holds as few as
// 256 configurations (min_active), yet each round still draws 100,000
// samples per configuration. A thread per configuration would leave most of
// the 132 SMs idle. So the grid is (configuration, sample chunk): a block
// of 256 threads takes 4096 consecutive samples of one configuration, each
// thread sums its hits in a register, a warp shuffle reduces them, and one
// int32 atomicAdd per warp lands the warp's sum in counts[c]. Integer sums
// do not depend on order, so the counts are deterministic.
//
// Randomness: Philox4x32-10 keyed by the round's two seed words (the folded
// threefry key, as mc_pallas.py:375-378), with the counter (sample index
// low, sample index high, uid, draw block). Counts are therefore a pure
// function of (key, uid, round tag, sample index): they do not change with
// grid shape, repacking, row order or cross-batch overlap.
//
// The wrapper (ops/mc_cuda.py) allocates `counts` zeroed; the kernel only
// accumulates into it and allocates nothing.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kSamplesPerThread = 16;
constexpr long long kSamplesPerBlock =
    static_cast<long long>(kThreads) * kSamplesPerThread;

struct Philox4 {
  uint32_t v[4];
};

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

// XLA's float32 erf_inv (the polynomial jax.lax.erf_inv lowers to and
// collide2d_tpu_torch/mc/prng.py::erf_inv evaluates in torch). log1pf
// stands in for XLA's Cephes log1p there; the two differ by an ulp on a
// few inputs, which moves a count only for a sample within an ulp of
// touching. The edge case |x| == 1 never occurs: 23-bit codes keep
// |x| <= 1 - 2^-23.
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
  return (fabsf(u) > q.hx1 + a * cd + b * sd) ||
         (fabsf(v) > q.hy1 + a * sd + b * cd) ||
         (fabsf(u * cd_raw - v * sd_raw) > a + q.hx1 * cd + q.hy1 * sd) ||
         (fabsf(u * sd_raw + v * cd_raw) > b + q.hx1 * sd + q.hy1 * cd);
}

template <bool kShapeNoise>
__global__ void __launch_bounds__(kThreads)
    mc_counts_kernel(const float* __restrict__ params,
                     const int32_t* __restrict__ uids,
                     int32_t* __restrict__ counts, long long n,
                     long long offset, uint32_t seed0, uint32_t seed1) {
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

  int hits = 0;
  const long long begin = static_cast<long long>(blockIdx.y) * kSamplesPerBlock;
  long long end = begin + kSamplesPerBlock;
  if (end > n) end = n;
  for (long long j = begin + threadIdx.x; j < end; j += kThreads) {
    const unsigned long long idx = static_cast<unsigned long long>(offset + j);
    const uint32_t lo = static_cast<uint32_t>(idx);
    const uint32_t hi = static_cast<uint32_t>(idx >> 32);
    const Philox4 r = philox4x32_10(lo, hi, uid, 0u, seed0, seed1);
    const float z_dx = normal_from_word(r.v[0]);
    const float z_dy = normal_from_word(r.v[1]);
    const float z_th = normal_from_word(r.v[2]);
    float a, b;
    if (kShapeNoise) {
      const Philox4 r2 = philox4x32_10(lo, hi, uid, 1u, seed0, seed1);
      a = fabsf(q.ow_h + normal_from_word(r.v[3]) * q.swh);
      b = fabsf(q.oh_h + normal_from_word(r2.v[0]) * q.shh);
    } else {
      a = fabsf(q.ow_h);
      b = fabsf(q.oh_h);
    }
    hits += obb_separated(q, z_dx, z_dy, z_th, a, b) ? 0 : 1;
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
  if (shape_noise) {
    mc_counts_kernel<true><<<grid, kThreads, 0, s>>>(params, uids, counts, n,
                                                     offset, seed0, seed1);
  } else {
    mc_counts_kernel<false><<<grid, kThreads, 0, s>>>(params, uids, counts, n,
                                                      offset, seed0, seed1);
  }
  return static_cast<int>(cudaGetLastError());
}

// Launch-free constant the wrapper checks against its own sample cap.
extern "C" long long mc_max_samples_per_round() {
  return 65535LL * kSamplesPerBlock;
}
