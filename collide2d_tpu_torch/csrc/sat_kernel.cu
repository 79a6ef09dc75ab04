// Rectangle-pair SAT and parametric oriented-box tests, labels and counts,
// on Hopper.
//
// Replaces the four TPU kernels of collide2d_tpu/ops/sat_pallas.py:
//   sat_label  <- _label_kernel      (4-axis vertex SAT, `_sat_body`)
//   sat_count  <- _count_kernel      (the same, summed)
//   obb_label  <- _obb_label_kernel  (closed-form OBB test, `_obb_body`)
//   obb_count  <- _obb_count_kernel  (the same, summed)
//
// Layout. A vertex batch is the (8, 8, M) SoA of `pack_rects`: in memory 8
// coordinate planes (x0..x3, y0..y3) of n = 8M contiguous values, pair
// p = s*M + l at plane[c][p]. A box batch is the (6, 8, M) SoA of
// `pack_obbs`: planes cx, cy, cos, sin, |w|/2, |h|/2. One thread takes one
// pair and reads plane[c][p], so neighbouring threads read neighbouring
// addresses of every plane and each load is coalesced without repacking.
// Labels are written as float32 (n,), 1 = collide.
//
// What bounds it on this card: bytes. A vertex pair reads 2 rectangles x 8
// coordinates x 4 bytes = 64 bytes (32 in bf16) and writes a 4-byte label;
// a box pair reads 2 x 6 x 4 = 48 and writes 4, against ~110 and ~35 float
// operations. (The Pallas kernel's cost estimate counts 128 bytes in for a
// vertex pair: the (8, 8, M) array holds 8 coordinates of 8M pairs, i.e. 32
// bytes a rectangle.) At the H100 SXM's 3.35 TB/s, 68 B/pair caps the
// vertex label kernel near 4.9e10 pairs/s and 52 B/pair the box label
// kernel near 6.4e10; the count kernels drop the 4-byte store. The design
// therefore spends nothing on reuse or shared memory: plain coalesced
// loads, no intermediate in device memory, and for the counts one
// warp-shuffle plus shared-memory reduction per block and one 64-bit
// atomicAdd per block.
//
// Parity. Labels must equal the JAX functions bit for bit, so every
// product, sum and difference is an explicitly rounded __fmul_rn /
// __fadd_rn / __fsub_rn: nvcc would otherwise contract a*b + c*d into an
// FMA. The association is the JAX one, e.g. (hx1 + hx2*cd) + hy2*sd and
// v2 + shift on every r2 coordinate. fminf/fmaxf equal jnp.minimum /
// jnp.maximum on finite inputs; non-finite coordinates are outside the
// contract. bf16 inputs are upcast exactly with __bfloat162float, so the
// test itself always runs in float32.
//
// The wrapper (ops/sat_cuda.py) allocates the output (and zeroes the count
// accumulator); the kernels allocate nothing and do not synchronise.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// ax*x + ay*y with both products and the sum rounded on their own.
__device__ __forceinline__ float proj(float ax, float ay, float x, float y) {
  return __fadd_rn(__fmul_rn(ax, x), __fmul_rn(ay, y));
}

// `_sat_body` for pair p: true when the rectangles collide.
template <typename T>
__device__ __forceinline__ bool sat_collide(const T* __restrict__ r1,
                                            const T* __restrict__ r2,
                                            long long n, long long p,
                                            float shift) {
  float x1[4], y1[4], x2[4], y2[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    x1[k] = to_f32(r1[k * n + p]);
    y1[k] = to_f32(r1[(4 + k) * n + p]);
    x2[k] = __fadd_rn(to_f32(r2[k * n + p]), shift);
    y2[k] = __fadd_rn(to_f32(r2[(4 + k) * n + p]), shift);
  }
  // The 4 unique axes: the first two edges of each rectangle.
  const float ax[4] = {__fsub_rn(x1[1], x1[0]), __fsub_rn(x1[2], x1[1]),
                       __fsub_rn(x2[1], x2[0]), __fsub_rn(x2[2], x2[1])};
  const float ay[4] = {__fsub_rn(y1[1], y1[0]), __fsub_rn(y1[2], y1[1]),
                       __fsub_rn(y2[1], y2[0]), __fsub_rn(y2[2], y2[1])};
  bool separated = false;
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    float mn1 = proj(ax[a], ay[a], x1[0], y1[0]);
    float mx1 = mn1;
    float mn2 = proj(ax[a], ay[a], x2[0], y2[0]);
    float mx2 = mn2;
#pragma unroll
    for (int k = 1; k < 4; ++k) {
      const float q1 = proj(ax[a], ay[a], x1[k], y1[k]);
      mn1 = fminf(mn1, q1);
      mx1 = fmaxf(mx1, q1);
      const float q2 = proj(ax[a], ay[a], x2[k], y2[k]);
      mn2 = fminf(mn2, q2);
      mx2 = fmaxf(mx2, q2);
    }
    separated = separated || (mx1 < mn2) || (mx2 < mn1);
  }
  return !separated;
}

// (h + a*p) + b*q, each step rounded on its own.
__device__ __forceinline__ float reach(float h, float a, float p, float b,
                                       float q) {
  return __fadd_rn(__fadd_rn(h, __fmul_rn(a, p)), __fmul_rn(b, q));
}

// `_obb_body` for pair p: true when the boxes collide.
__device__ __forceinline__ bool obb_collide(const float* __restrict__ b1,
                                            const float* __restrict__ b2,
                                            long long n, long long p,
                                            float shift) {
  const float dx = __fsub_rn(b1[p], __fadd_rn(b2[p], shift));
  const float dy = __fsub_rn(b1[n + p], __fadd_rn(b2[n + p], shift));
  const float c1 = b1[2 * n + p], s1 = b1[3 * n + p];
  const float hx1 = b1[4 * n + p], hy1 = b1[5 * n + p];
  const float c2 = b2[2 * n + p], s2 = b2[3 * n + p];
  const float hx2 = b2[4 * n + p], hy2 = b2[5 * n + p];
  const float cd = fabsf(__fadd_rn(__fmul_rn(c1, c2), __fmul_rn(s1, s2)));
  const float sd = fabsf(__fsub_rn(__fmul_rn(s1, c2), __fmul_rn(c1, s2)));
  const float d_a1 = fabsf(__fadd_rn(__fmul_rn(dx, c1), __fmul_rn(dy, s1)));
  const float d_a2 = fabsf(__fadd_rn(__fmul_rn(-dx, s1), __fmul_rn(dy, c1)));
  const float d_b1 = fabsf(__fadd_rn(__fmul_rn(dx, c2), __fmul_rn(dy, s2)));
  const float d_b2 = fabsf(__fadd_rn(__fmul_rn(-dx, s2), __fmul_rn(dy, c2)));
  const bool sep = (d_a1 > reach(hx1, hx2, cd, hy2, sd)) ||
                   (d_a2 > reach(hy1, hx2, sd, hy2, cd)) ||
                   (d_b1 > reach(hx2, hx1, cd, hy1, sd)) ||
                   (d_b2 > reach(hy2, hx1, sd, hy1, cd));
  return !sep;
}

__device__ __forceinline__ long long pair_index() {
  return static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
}

// Adds the block's hits to *total: warp shuffles, then the first warp
// reduces the per-warp sums, then one atomicAdd. Every thread of the block
// must call it (threads past the ragged edge with hit = 0).
__device__ __forceinline__ void block_count(unsigned hit,
                                            unsigned long long* total) {
  __shared__ unsigned warp_sums[kThreads / 32];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    hit += __shfl_down_sync(0xffffffffu, hit, o);
  }
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) warp_sums[warp] = hit;
  __syncthreads();
  if (warp == 0) {
    unsigned v = lane < kThreads / 32 ? warp_sums[lane] : 0u;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      v += __shfl_down_sync(0xffffffffu, v, o);
    }
    if (lane == 0 && v != 0u) {
      atomicAdd(total, static_cast<unsigned long long>(v));
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    sat_label_kernel(const T* __restrict__ r1, const T* __restrict__ r2,
                     float* __restrict__ out, long long n, float shift) {
  const long long p = pair_index();
  if (p < n) out[p] = sat_collide(r1, r2, n, p, shift) ? 1.0f : 0.0f;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    sat_count_kernel(const T* __restrict__ r1, const T* __restrict__ r2,
                     unsigned long long* __restrict__ total, long long n,
                     float shift) {
  const long long p = pair_index();
  block_count(p < n && sat_collide(r1, r2, n, p, shift) ? 1u : 0u, total);
}

__global__ void __launch_bounds__(kThreads)
    obb_label_kernel(const float* __restrict__ b1,
                     const float* __restrict__ b2, float* __restrict__ out,
                     long long n, float shift) {
  const long long p = pair_index();
  if (p < n) out[p] = obb_collide(b1, b2, n, p, shift) ? 1.0f : 0.0f;
}

__global__ void __launch_bounds__(kThreads)
    obb_count_kernel(const float* __restrict__ b1,
                     const float* __restrict__ b2,
                     unsigned long long* __restrict__ total, long long n,
                     float shift) {
  const long long p = pair_index();
  block_count(p < n && obb_collide(b1, b2, n, p, shift) ? 1u : 0u, total);
}

// Blocks for n pairs, or 0 when n does not fit one grid dimension.
unsigned grid_for(long long n) {
  const long long blocks = (n + kThreads - 1) / kThreads;
  return blocks > INT_MAX ? 0u : static_cast<unsigned>(blocks);
}

}  // namespace

// Plain C entry points (bound with ctypes). `n` is the number of pairs
// (8M); each launches on `stream`, does not synchronise, and returns
// cudaGetLastError() after the launch (0 = ok).

extern "C" int sat_label_launch(const void* r1, const void* r2, float* out,
                                long long n, float shift, int bf16,
                                void* stream) {
  if (n <= 0) return static_cast<int>(cudaSuccess);
  const unsigned grid = grid_for(n);
  if (grid == 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16) {
    sat_label_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(r1),
        static_cast<const __nv_bfloat16*>(r2), out, n, shift);
  } else {
    sat_label_kernel<float><<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(r1), static_cast<const float*>(r2), out, n,
        shift);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int sat_count_launch(const void* r1, const void* r2,
                                unsigned long long* total, long long n,
                                float shift, int bf16, void* stream) {
  if (n <= 0) return static_cast<int>(cudaSuccess);
  const unsigned grid = grid_for(n);
  if (grid == 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16) {
    sat_count_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(r1),
        static_cast<const __nv_bfloat16*>(r2), total, n, shift);
  } else {
    sat_count_kernel<float><<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(r1), static_cast<const float*>(r2), total,
        n, shift);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int obb_label_launch(const float* b1, const float* b2, float* out,
                                long long n, float shift, void* stream) {
  if (n <= 0) return static_cast<int>(cudaSuccess);
  const unsigned grid = grid_for(n);
  if (grid == 0) return static_cast<int>(cudaErrorInvalidValue);
  obb_label_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      b1, b2, out, n, shift);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int obb_count_launch(const float* b1, const float* b2,
                                unsigned long long* total, long long n,
                                float shift, void* stream) {
  if (n <= 0) return static_cast<int>(cudaSuccess);
  const unsigned grid = grid_for(n);
  if (grid == 0) return static_cast<int>(cudaErrorInvalidValue);
  obb_count_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      b1, b2, total, n, shift);
  return static_cast<int>(cudaGetLastError());
}
