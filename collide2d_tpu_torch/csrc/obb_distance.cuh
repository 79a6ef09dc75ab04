// The closed-form oriented-box signed distance and the exact translation
// window, as __device__ functions on one pair's scalars.
//
// Shared by csrc/distance_kernel.cu (kernel 8, the static distance) and
// csrc/toi_kernel.cu (kernel 12, which re-evaluates the distance at every
// conservative-advancement step and takes the window for non-rotating
// pairs), and by the trajectory kernels 13 (csrc/mc_toi_kernel.cu) and 15
// (csrc/screen_kernel.cu). Their plain PyTorch versions are
// ops/distance_cuda.py::obb_signed_distance_tile and
// ops/toi.py::obb_translation_toi_parts.
//
// Replaces, on the TPU side, collide2d_tpu/ops/distance_pallas.py::
// obb_signed_distance_tile (:58-110) and collide2d_tpu/ops/toi.py::
// _axis_interval / obb_translation_toi_parts (:76-125).
//
// Rounding. Every product, sum and difference is an explicitly rounded
// __fmul_rn / __fadd_rn / __fsub_rn in the JAX expression's order: nvcc
// would otherwise contract a*b + c*d into an FMA. The overlap side's gap
// expressions are kernel 4's (csrc/sat_kernel.cu::obb_collide) operation
// for operation, so `distance <= 0` is bitwise that kernel's label (f32
// subtraction keeps the sign of a comparison, and |-x| = |x| exactly for
// the offset c2 - c1 against kernel 4's c1 - c2). sqrtf and '/' stay
// IEEE-rounded (nvcc's default; never --use_fast_math).

#pragma once

#include <math.h>

#include "fp32_rn.cuh"

namespace collide2d {

// (h + a*p) + b*q: a projection radius, each step rounded on its own.
__device__ __forceinline__ float radius(float h, float a, float p, float b,
                                        float q) {
  return __fadd_rn(__fadd_rn(h, __fmul_rn(a, p)), __fmul_rn(b, q));
}

// Squared distance from (px, py) to the axis-aligned box of half extents
// (hx, hy) at the origin.
__device__ __forceinline__ float point_box_d2(float px, float py, float hx,
                                              float hy) {
  const float qx = fmaxf(__fsub_rn(fabsf(px), hx), 0.0f);
  const float qy = fmaxf(__fsub_rn(fabsf(py), hy), 0.0f);
  return __fadd_rn(__fmul_rn(qx, qx), __fmul_rn(qy, qy));
}

// Signed distance of box 2 (centre offset (dx, dy) = c2 - c1, cos/sin c2,
// s2, half extents hx2, hy2) from box 1 (c1, s1, hx1, hy1): the largest
// signed gap over the 4 unit SAT axes when it is negative (minus the
// penetration depth), else the smallest vertex-to-box distance over both
// boxes' vertices in the other's frame.
__device__ __forceinline__ float obb_signed_distance(float dx, float dy,
                                                     float c1, float s1,
                                                     float hx1, float hy1,
                                                     float c2, float s2,
                                                     float hx2, float hy2) {
  const float cb = dot2(c1, c2, s1, s2);                   // cos(th2 - th1)
  const float cd = fabsf(cb);
  const float sd = fabsf(__fsub_rn(__fmul_rn(s1, c2), __fmul_rn(c1, s2)));
  const float pax = dot2(dx, c1, dy, s1);                  // B's centre in A's frame
  const float pay = dot2(-dx, s1, dy, c1);
  const float qbx = dot2(dx, c2, dy, s2);                  // -(A's centre in B's frame)
  const float qby = dot2(-dx, s2, dy, c2);
  float gap = fmaxf(__fsub_rn(fabsf(pax), radius(hx1, hx2, cd, hy2, sd)),
                    __fsub_rn(fabsf(pay), radius(hy1, hx2, sd, hy2, cd)));
  gap = fmaxf(gap, __fsub_rn(fabsf(qbx), radius(hx2, hx1, cd, hy1, sd)));
  gap = fmaxf(gap, __fsub_rn(fabsf(qby), radius(hy2, hx1, sd, hy1, cd)));

  // Disjoint side: each box's vertices against the other box in its frame.
  const float sb = __fsub_rn(__fmul_rn(c1, s2), __fmul_rn(s1, c2));  // sin(th2 - th1)
  const float pbx = -qbx;
  const float pby = -qby;
  float d2 = INFINITY;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float sx = (i < 2) ? 1.0f : -1.0f;
    const float sy = (i & 1) ? -1.0f : 1.0f;
    const float ax = sx * hx2, ay = sy * hy2;  // exact: sx, sy are +-1
    const float bx = sx * hx1, by = sy * hy1;
    // vertex of B in A's frame: p + ax (cB, sB) + ay (-sB, cB)
    const float vx = __fsub_rn(__fadd_rn(pax, __fmul_rn(ax, cb)), __fmul_rn(ay, sb));
    const float vy = __fadd_rn(__fadd_rn(pay, __fmul_rn(ax, sb)), __fmul_rn(ay, cb));
    // vertex of A in B's frame: rotation by -(th2 - th1)
    const float wx = __fadd_rn(__fadd_rn(pbx, __fmul_rn(bx, cb)), __fmul_rn(by, sb));
    const float wy = __fadd_rn(__fsub_rn(pby, __fmul_rn(bx, sb)), __fmul_rn(by, cb));
    d2 = fminf(d2, fminf(point_box_d2(vx, vy, hx1, hy1),
                         point_box_d2(wx, wy, hx2, hy2)));
  }
  return gap < 0.0f ? gap : sqrtf(d2);
}

// A speed s along an axis with its IEEE reciprocal (1 where s == 0).
struct AxisSpeed {
  float s, inv;
};

__device__ __forceinline__ AxisSpeed axis_speed(float s) {
  AxisSpeed a;
  a.s = s;
  a.inv = __fdiv_rn(1.0f, s == 0.0f ? 1.0f : s);
  return a;
}

// Hit window (lo, hi) of |p0 + t s| <= r; s == 0 gives every t (|p0| <= r)
// or the empty window (+inf, -inf).
__device__ __forceinline__ void axis_interval(float p0, const AxisSpeed& v,
                                              float r, float& lo, float& hi) {
  const bool zero = v.s == 0.0f;
  const float t1 = __fmul_rn(__fsub_rn(-r, p0), v.inv);
  const float t2 = __fmul_rn(__fsub_rn(r, p0), v.inv);
  const bool inside = fabsf(p0) <= r;
  lo = zero ? (inside ? -INFINITY : INFINITY) : fminf(t1, t2);
  hi = zero ? (inside ? INFINITY : -INFINITY) : fmaxf(t1, t2);
}

// The relative velocity (vx, vy) along box 1's axes (c1, s1) and (-s1, c1).
// They depend on box 1's angle and the velocity alone, so a caller with
// many boxes 2 against one box 1 (kernel 13: a row's samples) computes them
// once.
struct BoxAxisSpeeds {
  AxisSpeed x, y;
};

__device__ __forceinline__ BoxAxisSpeeds box_axis_speeds(float c1, float s1,
                                                         float vx, float vy) {
  BoxAxisSpeeds b;
  b.x = axis_speed(dot2(vx, c1, vy, s1));
  b.y = axis_speed(dot2(-vx, s1, vy, c1));
  return b;
}

// (entry, exit) of the pair's hit window when box 2 translates by t (vx, vy)
// relative to box 1 and neither rotates: the intersection of the 4 unit SAT
// axes' windows (exact: they are the Minkowski sum's edge normals). `axes1`
// is box_axis_speeds(c1, s1, vx, vy).
__device__ __forceinline__ void obb_translation_window(
    float dx, float dy, float c1, float s1, float hx1, float hy1, float c2,
    float s2, float hx2, float hy2, float vx, float vy,
    const BoxAxisSpeeds& axes1, float& entry, float& exit) {
  const float cd = fabsf(dot2(c1, c2, s1, s2));
  const float sd = fabsf(__fsub_rn(__fmul_rn(s1, c2), __fmul_rn(c1, s2)));
  float lo, hi, l, h;
  axis_interval(dot2(dx, c1, dy, s1), axes1.x, radius(hx1, hx2, cd, hy2, sd),
                lo, hi);
  axis_interval(dot2(-dx, s1, dy, c1), axes1.y, radius(hy1, hx2, sd, hy2, cd),
                l, h);
  lo = fmaxf(lo, l);
  hi = fminf(hi, h);
  axis_interval(dot2(dx, c2, dy, s2), axis_speed(dot2(vx, c2, vy, s2)),
                radius(hx2, hx1, cd, hy1, sd), l, h);
  lo = fmaxf(lo, l);
  hi = fminf(hi, h);
  axis_interval(dot2(-dx, s2, dy, c2), axis_speed(dot2(-vx, s2, vy, c2)),
                radius(hy2, hx1, sd, hy1, cd), l, h);
  entry = fmaxf(lo, l);
  exit = fminf(hi, h);
}

// The same window with box 1's axis speeds computed here.
__device__ __forceinline__ void obb_translation_window(
    float dx, float dy, float c1, float s1, float hx1, float hy1, float c2,
    float s2, float hx2, float hy2, float vx, float vy, float& entry,
    float& exit) {
  obb_translation_window(dx, dy, c1, s1, hx1, hy1, c2, s2, hx2, hy2, vx, vy,
                         box_axis_speeds(c1, s1, vx, vy), entry, exit);
}

}  // namespace collide2d
