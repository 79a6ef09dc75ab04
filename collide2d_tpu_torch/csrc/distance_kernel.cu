// Signed distances of oriented-box pairs (kernel 8) and convex k-gon pairs
// (kernel 9) on Hopper.
//
// Replaces the TPU kernels of collide2d_tpu/ops/distance_pallas.py:
//   obb_distance      <- _distance_kernel (:125; body :113, tile :58)
//   polygon_distance  <- _make_polygon_distance_kernel (:229; body :164)
// Positive = separation distance, negative = -(penetration depth).
//
// Layout. One thread takes one pair and reads plane[c][p] of n = 8M
// contiguous values per plane, so each load is coalesced without repacking:
// boxes are the (6, 8, M) SoA of `sat_cuda.pack_obbs` (cx, cy, cos, sin,
// |w|/2, |h|/2), k-gons the (2K, 8, M) SoA of `polygon_cuda.pack_polygons`
// (polygon_soa.cuh). Distances are written as float32 (n,).
//
// Kernel 8 (obb_distance.cuh::obb_signed_distance): 48 bytes in and 4 out
// per pair against ~170 FP32 operations, so it is bound by bytes on this
// card (52 B at 3.35 TB/s: 0.130 ms for 2^23 pairs); the design is kernel
// 4's: plain coalesced loads, nothing in device memory but the result.
// Its gap expressions are kernel 4's, so `distance <= 0` is bitwise the
// obb_label kernel's label.
//
// Kernel 9: for each of the K1 + K2 true edge normals the two projection
// intervals (2 (K1 + K2) projections of 3 operations, their min/max) and
// the gap scaled by 1 / |normal|; then every (vertex, edge segment) pair of
// both bodies (2 K1 K2 point-segment tests of ~17 operations). At K = 8
// that is ~3,600 FP32 operations against 132 bytes a pair: bound by
// operations (0.22 ms for 2^22 pairs at 67 TFLOP/s), which the design
// meets with everything in registers and no shared memory. K is a run-time
// value: the build carries buckets 4, 8 and 16 for each polygon and pads
// in registers (polygon_soa.cuh). The padding is exact for the sign: a
// zero edge is masked to -inf in the gap max and a duplicate vertex adds no
// projection; it can move the separation distance by rounding (a
// zero-length segment's point distance against the closing edge's clamped
// one), so the plain version pads to the same bucket. K above 16 is refused.
//
// Rounding. Every product, sum and difference is __fmul_rn / __fadd_rn /
// __fsub_rn in the JAX order (no FMA contraction), so `distance <= 0` of
// kernel 9 is bitwise kernel 6's label (the scale 1/|normal| is positive).
// The scale is 1 / sqrt(nn) in two IEEE operations, not the TPU's rsqrt:
// torch.reciprocal(torch.sqrt(.)) in the plain version rounds the same, so
// kernel and plain version run the same arithmetic; against the Pallas
// kernel's rsqrt the values differ by ulps (tests hold them to 2e-5).
//
// The wrapper (ops/distance_cuda.py) allocates the output; the kernels
// allocate nothing and do not synchronise.

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>

#include "obb_distance.cuh"
#include "polygon_soa.cuh"

namespace {

using collide2d::dot2;
using collide2d::inv_norm;

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
    obb_distance_kernel(const float* __restrict__ b1,
                        const float* __restrict__ b2, float* __restrict__ out,
                        long long n, float shift) {
  const long long p = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (p >= n) return;
  const float dx = __fsub_rn(__fadd_rn(b2[p], shift), b1[p]);  // c2 - c1
  const float dy = __fsub_rn(__fadd_rn(b2[n + p], shift), b1[n + p]);
  out[p] = collide2d::obb_signed_distance(
      dx, dy, b1[2 * n + p], b1[3 * n + p], b1[4 * n + p], b1[5 * n + p],
      b2[2 * n + p], b2[3 * n + p], b2[4 * n + p], b2[5 * n + p]);
}

// [min, max] of the projections of a K-gon onto (ax, ay).
template <int K>
__device__ __forceinline__ void interval(float ax, float ay,
                                         const float (&x)[K],
                                         const float (&y)[K], float& mn,
                                         float& mx) {
  mn = dot2(ax, x[0], ay, y[0]);
  mx = mn;
#pragma unroll
  for (int i = 1; i < K; ++i) {
    const float q = dot2(ax, x[i], ay, y[i]);
    mn = fminf(mn, q);
    mx = fmaxf(mx, q);
  }
}

// gap = max(gap, the scaled support gaps over the edge normals of (xs, ys)).
template <int KA, int K1, int K2>
__device__ __forceinline__ void gaps_over_normals(
    const float (&xs)[KA], const float (&ys)[KA], const float (&x1)[K1],
    const float (&y1)[K1], const float (&x2)[K2], const float (&y2)[K2],
    float& gap) {
#pragma unroll
  for (int i = 0; i < KA; ++i) {
    const int j = (i + 1) % KA;
    const float ax = __fsub_rn(ys[j], ys[i]);  // true normal of edge i -> j
    const float ay = __fsub_rn(xs[i], xs[j]);
    const float nn = dot2(ax, ax, ay, ay);
    float mn1, mx1, mn2, mx2;
    interval<K1>(ax, ay, x1, y1, mn1, mx1);
    interval<K2>(ax, ay, x2, y2, mn2, mx2);
    const float g = __fmul_rn(fmaxf(__fsub_rn(mn2, mx1), __fsub_rn(mn1, mx2)),
                              inv_norm(nn > 0.0f ? nn : 1.0f));
    gap = fmaxf(gap, nn > 0.0f ? g : -INFINITY);
  }
}

// d2 = min(d2, squared distances of every vertex of p to every closed edge
// segment of q); a zero-length segment gives the point distance.
template <int KP, int KQ>
__device__ __forceinline__ void vertex_segment_min(const float (&px)[KP],
                                                   const float (&py)[KP],
                                                   const float (&qx)[KQ],
                                                   const float (&qy)[KQ],
                                                   float& d2) {
#pragma unroll
  for (int j = 0; j < KQ; ++j) {
    const int j2 = (j + 1) % KQ;
    const float ex = __fsub_rn(qx[j2], qx[j]);
    const float ey = __fsub_rn(qy[j2], qy[j]);
    const float ee = dot2(ex, ex, ey, ey);
    const bool live = ee > 0.0f;
    const float inv = __fdiv_rn(1.0f, live ? ee : 1.0f);
#pragma unroll
    for (int i = 0; i < KP; ++i) {
      const float dx = __fsub_rn(px[i], qx[j]);
      const float dy = __fsub_rn(py[i], qy[j]);
      const float tc = fminf(fmaxf(__fmul_rn(dot2(dx, ex, dy, ey), inv), 0.0f), 1.0f);
      const float t = live ? tc : 0.0f;
      const float cx = __fsub_rn(dx, __fmul_rn(t, ex));
      const float cy = __fsub_rn(dy, __fmul_rn(t, ey));
      d2 = fminf(d2, dot2(cx, cx, cy, cy));
    }
  }
}

template <int K1, int K2>
__global__ void __launch_bounds__(kThreads)
    polygon_distance_kernel(const float* __restrict__ p1,
                            const float* __restrict__ p2,
                            float* __restrict__ out, long long n, int k1,
                            int k2) {
  const long long p = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (p >= n) return;
  float x1[K1], y1[K1], x2[K2], y2[K2];
  collide2d::load_polygon<K1>(p1, n, p, k1, x1, y1);
  collide2d::load_polygon<K2>(p2, n, p, k2, x2, y2);
  float gap = -INFINITY;
  gaps_over_normals<K1>(x1, y1, x1, y1, x2, y2, gap);
  gaps_over_normals<K2>(x2, y2, x1, y1, x2, y2, gap);
  float d2 = INFINITY;
  vertex_segment_min<K1, K2>(x1, y1, x2, y2, d2);
  vertex_segment_min<K2, K1>(x2, y2, x1, y1, d2);
  out[p] = gap < 0.0f ? gap : sqrtf(d2);
}

// Blocks for n pairs, or 0 when n does not fit one grid dimension.
unsigned grid_for(long long n) {
  const long long blocks = (n + kThreads - 1) / kThreads;
  return blocks > INT_MAX ? 0u : static_cast<unsigned>(blocks);
}

template <int K1>
bool launch_k2(const float* p1, const float* p2, float* out, long long n,
               int k1, int k2, unsigned grid, cudaStream_t s) {
  switch (collide2d::k_bucket(k2)) {
    case 4: polygon_distance_kernel<K1, 4><<<grid, kThreads, 0, s>>>(p1, p2, out, n, k1, k2); return true;
    case 8: polygon_distance_kernel<K1, 8><<<grid, kThreads, 0, s>>>(p1, p2, out, n, k1, k2); return true;
    case 16: polygon_distance_kernel<K1, 16><<<grid, kThreads, 0, s>>>(p1, p2, out, n, k1, k2); return true;
    default: return false;
  }
}

}  // namespace

// Plain C entry points (bound with ctypes). `n` is the number of pairs
// (8M); each launches on `stream`, does not synchronise, and returns
// cudaGetLastError() after the launch (0 = ok).

extern "C" int obb_distance_launch(const float* b1, const float* b2,
                                   float* out, long long n, float shift,
                                   void* stream) {
  if (n <= 0) return static_cast<int>(cudaSuccess);
  const unsigned grid = grid_for(n);
  if (grid == 0) return static_cast<int>(cudaErrorInvalidValue);
  obb_distance_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      b1, b2, out, n, shift);
  return static_cast<int>(cudaGetLastError());
}

// `k1`/`k2`: the vertices of each polygon (1..16).
extern "C" int polygon_distance_launch(const float* p1, const float* p2,
                                       float* out, long long n, int k1, int k2,
                                       void* stream) {
  if (n <= 0) return static_cast<int>(cudaSuccess);
  const unsigned grid = grid_for(n);
  if (grid == 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  bool ok = false;
  switch (collide2d::k_bucket(k1)) {
    case 4: ok = launch_k2<4>(p1, p2, out, n, k1, k2, grid, s); break;
    case 8: ok = launch_k2<8>(p1, p2, out, n, k1, k2, grid, s); break;
    case 16: ok = launch_k2<16>(p1, p2, out, n, k1, k2, grid, s); break;
    default: ok = false;
  }
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
