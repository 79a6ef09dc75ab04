// Kernel 9's arithmetic on one k-gon pair, as __device__ functions on the
// pair's vertices in registers (csrc/distance_kernel.cu drives them).
//
// The signed distance is `gap < 0 ? gap : sqrt(d2)`: `gap` the largest
// support gap over the true edge normals of both polygons, each scaled by
// 1 / |normal| (`support_gap`), `d2` the smallest squared distance from a
// vertex of either polygon to a closed edge segment of the other
// (`vertex_segment_min`). The output reads `gap` only on a pair that
// overlaps and `d2` only on one that does not, so the kernel splits them:
// `edge_separates` proves a pair separated from one edge normal's
// unscaled gap, and such a pair needs `d2` alone.
//
// Exactness. Every value is the one the plain version
// (ops/distance_cuda.py::polygon_distance_plain) rounds: products and sums
// are __fmul_rn / __fadd_rn / __fsub_rn in its order (no contraction), the
// scale is 1 / sqrt(nn) in two IEEE operations, the reciprocal of |e|^2
// IEEE. min and max do not depend on the order of their inputs here (d2 is
// never below +0, and gap is read only below 0), so any order of axes and
// tests gives the same bits. `edge_separates` is exact in float: an
// unscaled gap g >= 0 (or -0) on a nonzero normal (nn > 0) times the
// positive finite scale is >= 0 or -0, so the pair's gap, a max over a set
// that holds it, is not below 0 and the output is sqrt(d2).
//
// A zero-length segment (ee == 0) gives the point distance: its reciprocal
// is taken as 0, so the projection's parameter saturates from +-0 (or NaN)
// to exactly 0, as the plain version's `t * live` makes it; a parameter of
// -0 against +0 moves cx = dx - t ex only in the sign of a zero, which
// squaring removes.
//
// Compiled for the card (csrc/distance_kernel.cu) and with g++ on the host
// (tests/test_torch_polygon_distance.py), where the rounded intrinsics are
// plain float operations under -ffp-contract=off.

#pragma once

#include <math.h>

#include "fp32_rn.cuh"
#include "polygon_soa.cuh"

namespace collide2d {
namespace polydist {

// The edge normals of polygon 1 `edge_separates` tests first, every
// K1 / 4-th edge (all four of a 4-gon): on the bench's regular 8-gons they
// settle 0.9865 of the separated pairs.
constexpr int kFirstEdges = 4;

// min(max(a * b, 0), 1) of the rounded product, NaN to 0: the projection
// parameter's clamp in one instruction.
__device__ __forceinline__ float mul_sat(float a, float b) {
#ifdef __CUDA_ARCH__
  float r;
  asm("mul.rn.sat.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
#else
  const float r = __fmul_rn(a, b);
  return r >= 0.0f ? (r <= 1.0f ? r : 1.0f) : 0.0f;
#endif
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

// The unscaled support gap of the pair along the normal of edge i -> i+1
// of (xs, ys), and the normal's squared length.
template <int KA, int K1, int K2>
__device__ __forceinline__ float unscaled_gap(
    int i, const float (&xs)[KA], const float (&ys)[KA], const float (&x1)[K1],
    const float (&y1)[K1], const float (&x2)[K2], const float (&y2)[K2],
    float& nn) {
  const int j = (i + 1) % KA;
  const float ax = __fsub_rn(ys[j], ys[i]);  // true normal of edge i -> j
  const float ay = __fsub_rn(xs[i], xs[j]);
  nn = dot2(ax, ax, ay, ay);
  float mn1, mx1, mn2, mx2;
  interval<K1>(ax, ay, x1, y1, mn1, mx1);
  interval<K2>(ax, ay, x2, y2, mn2, mx2);
  return fmaxf(__fsub_rn(mn2, mx1), __fsub_rn(mn1, mx2));
}

// Whether one of polygon 1's first edge normals (every K1 / 4-th edge)
// proves the pair separated (see the header's note).
template <int K1, int K2>
__device__ __forceinline__ bool edge_separates(const float (&x1)[K1],
                                               const float (&y1)[K1],
                                               const float (&x2)[K2],
                                               const float (&y2)[K2]) {
  bool sep = false;
#pragma unroll
  for (int s = 0; s < kFirstEdges; ++s) {
    float nn;
    const float g = unscaled_gap<K1>(s * (K1 / kFirstEdges), x1, y1, x1, y1,
                                     x2, y2, nn);
    sep |= nn > 0.0f && g >= 0.0f;
  }
  return sep;
}

// gap = max(gap, the scaled support gaps over the edge normals of (xs, ys));
// a zero normal is masked to -inf.
template <int KA, int K1, int K2>
__device__ __forceinline__ void gaps_over_normals(
    const float (&xs)[KA], const float (&ys)[KA], const float (&x1)[K1],
    const float (&y1)[K1], const float (&x2)[K2], const float (&y2)[K2],
    float& gap) {
#pragma unroll
  for (int i = 0; i < KA; ++i) {
    float nn;
    const float raw = unscaled_gap<KA>(i, xs, ys, x1, y1, x2, y2, nn);
    const float g = __fmul_rn(raw, inv_norm(nn > 0.0f ? nn : 1.0f));
    gap = fmaxf(gap, nn > 0.0f ? g : -INFINITY);
  }
}

// The pair's signed support gap over every true edge normal of both.
template <int K1, int K2>
__device__ __forceinline__ float support_gap(const float (&x1)[K1],
                                             const float (&y1)[K1],
                                             const float (&x2)[K2],
                                             const float (&y2)[K2]) {
  float gap = -INFINITY;
  gaps_over_normals<K1>(x1, y1, x1, y1, x2, y2, gap);
  gaps_over_normals<K2>(x2, y2, x1, y1, x2, y2, gap);
  return gap;
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
    const float inv = ee > 0.0f ? __fdiv_rn(1.0f, ee) : 0.0f;
#pragma unroll
    for (int i = 0; i < KP; ++i) {
      const float dx = __fsub_rn(px[i], qx[j]);
      const float dy = __fsub_rn(py[i], qy[j]);
      const float t = mul_sat(dot2(dx, ex, dy, ey), inv);
      const float cx = __fsub_rn(dx, __fmul_rn(t, ex));
      const float cy = __fsub_rn(dy, __fmul_rn(t, ey));
      d2 = fminf(d2, dot2(cx, cx, cy, cy));
    }
  }
}

// The pair's squared distance when it does not overlap.
template <int K1, int K2>
__device__ __forceinline__ float separation_d2(const float (&x1)[K1],
                                               const float (&y1)[K1],
                                               const float (&x2)[K2],
                                               const float (&y2)[K2]) {
  float d2 = INFINITY;
  vertex_segment_min<K1, K2>(x1, y1, x2, y2, d2);
  vertex_segment_min<K2, K1>(x2, y2, x1, y1, d2);
  return d2;
}

}  // namespace polydist
}  // namespace collide2d
