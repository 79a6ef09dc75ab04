// One lane of stage A of the rotating rectangle cascade (kernel 15), split
// into what depends on the configuration alone and what each lane computes.
//
// Used by csrc/screen_kernel.cu. The functions are plain arithmetic on
// scalars: every product, sum and difference is an explicitly rounded
// __fmul_rn / __fadd_rn / __fsub_rn in the order of the plain version
// (ops/screen_cuda.py::rotating_screen_plain, which composes
// mc/moving.py::_paired_segment_screen), divisions IEEE. The cos/sin values
// come in as arguments, so tests/test_torch_screen_lane.py compiles this
// header with g++ (CUDA's rounded intrinsics stubbed as plain float
// operations, -ffp-contract=off), hands it torch's cos/sin and holds the
// flags and warm starts to the plain version bit for bit.
//
// The per-configuration part (ScreenConfig) and the per-segment part
// (ScreenSegment: the midpoint angle's cos/sin, the rotating axes' speeds
// and their products with the segment's bounds) are computed once per
// configuration; a lane then reads them and does the rest. The segment
// count is a template argument, so the segment loop unrolls and the bounds
// a, b and tm are constants: a = i (1 / n), b = a + 1 / n, tm = a + 0.5 / n,
// each one rounded operation on f32(1 / n), as the plain version computes
// them. The tests combine with & and |, never && and ||: every operand is
// cheap and pure, and a short-circuit makes nvcc carry each bool through a
// register (SEL, PRMT, ISETP) where it can chain predicates instead.

#pragma once

#include <math.h>

#include "obb_distance.cuh"

namespace collide2d {
namespace screen {

constexpr int kMaxSeg = 32;

template <int NSEG>
struct Bounds {
  static constexpr float inv_n = 1.0f / NSEG;
  static constexpr float half_inv_n = 0.5f / NSEG;
  __host__ __device__ static constexpr float a(int i) {
    return static_cast<float>(i) * inv_n;
  }
  __host__ __device__ static constexpr float b(int i) { return a(i) + inv_n; }
  __host__ __device__ static constexpr float tm(int i) { return a(i) + half_inv_n; }
};

// What every lane of a configuration shares.
struct ScreenConfig {
  float sd[5];
  float wh_x, wh_y, px, py, vrx, vry;  // (vrx, vry) = -(vx, vy)
  float c1, s1, hx1, hy1;
  AxisSpeed ax1, ay1;  // the window's speeds along the robot's axes
  float ex_in, ey_in, ex_er, ey_er;
};

// What every lane shares in one segment: cos/sin of its midpoint angle and
// the speeds along the two rotating axes times a, b and tm.
struct ScreenSegment {
  float cm, sm;
  float a_sv0, b_sv0, tm_sv0, a_sv1, b_sv1, tm_sv1;
};

// The argument of delta's sine: min(|w| (0.5 / n), pi) * 0.5, from the
// configuration's packed row `p` (ops/screen_cuda.py::pack_screen_params).
template <int NSEG>
__device__ __forceinline__ float delta_angle(const float* p, float pi_f) {
  return __fmul_rn(fminf(__fmul_rn(fabsf(p[12]), Bounds<NSEG>::half_inv_n), pi_f),
                   0.5f);
}

// Segment i's midpoint angle th0 + (i + 0.5) (w (1 / n)).
template <int NSEG>
__device__ __forceinline__ float segment_angle(const float* p, int i) {
  return __fadd_rn(p[11], __fmul_rn(static_cast<float>(i) + 0.5f,
                                    __fmul_rn(p[12], Bounds<NSEG>::inv_n)));
}

// The configuration's scalars that come straight from its packed row.
__device__ __forceinline__ void set_row_scalars(ScreenConfig& q, const float* p) {
  for (int i = 0; i < 5; ++i) q.sd[i] = p[i];
  q.wh_x = p[5];
  q.wh_y = p[6];
  q.px = p[7];
  q.py = p[8];
  q.vrx = -p[9];
  q.vry = -p[10];
  q.hx1 = p[13];
  q.hy1 = p[14];
}

// cos/sin of the start angle and the window's speeds along the robot's
// axes (two IEEE divisions).
__device__ __forceinline__ void set_rotation(ScreenConfig& q, const float* p,
                                             float c1, float s1) {
  q.c1 = c1;
  q.s1 = s1;
  const BoxAxisSpeeds axes1 = box_axis_speeds(c1, s1, -p[9], -p[10]);
  q.ax1 = axes1.x;
  q.ay1 = axes1.y;
}

// The inflated and eroded robot extents from sin(delta_angle).
__device__ __forceinline__ void set_radii(ScreenConfig& q, const float* p,
                                          float sin_delta, float tol) {
  const float hx1 = p[13], hy1 = p[14], r_rob = p[15];
  // delta = 2 r sin(min(|w| (0.5 / n), pi) * 0.5)
  const float delta = __fmul_rn(__fmul_rn(2.0f, r_rob), sin_delta);
  const float d_in = __fadd_rn(delta, tol);
  const float hmin = fminf(hx1, hy1);
  const float qh = __fmul_rn(hmin, 0.7071067f);  // inscribed-square half
  const bool valid_er = delta < hmin;
  q.ex_er = valid_er ? __fsub_rn(hx1, delta) : qh;
  q.ey_er = valid_er ? __fsub_rn(hy1, delta) : qh;
  q.ex_in = __fadd_rn(hx1, d_in);
  q.ey_in = __fadd_rn(hy1, d_in);
}

// Segment i's shared values from cos/sin of its midpoint angle.
template <int NSEG>
__device__ __forceinline__ ScreenSegment screen_segment(const float* p, float cm,
                                                        float sm, int i) {
  using B = Bounds<NSEG>;
  const float vrx = -p[9], vry = -p[10];
  const float sv0 = dot2(vrx, cm, vry, sm);
  const float sv1 = dot2(-vrx, sm, vry, cm);
  const float a = B::a(i), b = B::b(i), tm = B::tm(i);
  ScreenSegment g;
  g.cm = cm;
  g.sm = sm;
  g.a_sv0 = __fmul_rn(a, sv0);
  g.b_sv0 = __fmul_rn(b, sv0);
  g.tm_sv0 = __fmul_rn(tm, sv0);
  g.a_sv1 = __fmul_rn(a, sv1);
  g.b_sv1 = __fmul_rn(b, sv1);
  g.tm_sv1 = __fmul_rn(tm, sv1);
  return g;
}

// The draw's angle offset z2 sd2, whose cos/sin the lane takes.
__device__ __forceinline__ float lane_angle(const ScreenConfig& q, float z2) {
  return __fmul_rn(z2, q.sd[2]);
}

// One axis of one segment: whether the inflated pair may touch over [a, b]
// (min |p0 + t s| against r_sh + r_in) and whether the eroded pair touches
// at tm (|p0 + tm s| against r_sh + r_er), from p0 + a s, p0 + b s and
// p0 + tm s.
__device__ __forceinline__ void segment_axis(float pa, float pb, float pm,
                                             float r_sh, float r_in, float r_er,
                                             bool& maybe, bool& hit) {
  const float mn = __fmul_rn(pa, pb) <= 0.0f ? 0.0f : fminf(fabsf(pa), fabsf(pb));
  maybe = maybe & (mn <= __fadd_rn(r_sh, r_in));
  hit = hit & (fabsf(pm) <= __fadd_rn(r_sh, r_er));
}

// L lanes of one configuration: the draws z[l] (z[l][2] unused) and cos/sin
// of lane_angle -> flags (bit 0 maybe, bit 1 certified hit or t = 0
// overlap, bit 2 the window's verdict) and the warm start t0. `seg` holds
// the NSEG segments; each segment's shared values are read once for the L
// lanes.
template <int NSEG, int L>
__device__ __forceinline__ void screen_lanes(const ScreenConfig& q,
                                             const ScreenSegment* seg,
                                             const float (&z)[L][5],
                                             const float (&c2)[L],
                                             const float (&s2)[L], int (&flags)[L],
                                             float (&t0)[L]) {
  using B = Bounds<NSEG>;
  const float c1 = q.c1, s1 = q.s1, hx1 = q.hx1, hy1 = q.hy1;
  const float vrx = q.vrx, vry = q.vry;
  float dx[L], dy[L], hx2[L], hy2[L], p3[L], v3[L], p4[L], v4[L], t_first[L];
  bool maybe[L], hit_cert[L];
#pragma unroll
  for (int l = 0; l < L; ++l) {
    const float ox = __fmul_rn(z[l][0], q.sd[0]);
    const float oy = __fmul_rn(z[l][1], q.sd[1]);
    hx2[l] = __fmul_rn(fabsf(__fadd_rn(q.wh_x, __fmul_rn(z[l][3], q.sd[3]))), 0.5f);
    hy2[l] = __fmul_rn(fabsf(__fadd_rn(q.wh_y, __fmul_rn(z[l][4], q.sd[4]))), 0.5f);
    const float c = c2[l], s = s2[l], hx = hx2[l], hy = hy2[l];

    // the exact t = 0 SAT test
    const float cd0 = fabsf(dot2(c1, c, s1, s));
    const float sd0 = fabsf(__fsub_rn(__fmul_rn(s1, c), __fmul_rn(c1, s)));
    const float ddx = __fsub_rn(ox, q.px);
    const float ddy = __fsub_rn(oy, q.py);
    const bool hit_at_0 =
        (fabsf(dot2(ddx, c1, ddy, s1)) <= radius(hx1, hx, cd0, hy, sd0)) &
        (fabsf(dot2(-ddx, s1, ddy, c1)) <= radius(hy1, hx, sd0, hy, cd0)) &
        (fabsf(dot2(ddx, c, ddy, s)) <= radius(hx, hx1, cd0, hy1, sd0)) &
        (fabsf(dot2(-ddx, s, ddy, c)) <= radius(hy, hx1, sd0, hy1, cd0));

    // the exact translation window (the obstacle moves by -v t)
    BoxAxisSpeeds axes1;
    axes1.x = q.ax1;
    axes1.y = q.ay1;
    float entry, exit;
    obb_translation_window(ddx, ddy, c1, s1, hx1, hy1, c, s, hx, hy, vrx, vry,
                           axes1, entry, exit);
    const bool hit_exact = (entry <= exit) & (entry <= 1.0f) & (exit >= 0.0f);
    flags[l] = (hit_at_0 ? 2 : 0) | (hit_exact ? 4 : 0);

    // the segment screen's terms that do not rotate: axes 3 and 4 are the
    // obstacle's
    dx[l] = ddx;
    dy[l] = ddy;
    p3[l] = dot2(ddx, c, ddy, s);
    v3[l] = dot2(vrx, c, vry, s);
    p4[l] = dot2(-ddx, s, ddy, c);
    v4[l] = dot2(-vrx, s, vry, c);
    maybe[l] = false;
    hit_cert[l] = false;
    t_first[l] = INFINITY;
  }
  // the paired segment screen, last segment first: the first segment that
  // may collide sets t_first
#pragma unroll
  for (int i = NSEG - 1; i >= 0; --i) {
    const ScreenSegment g = seg[i];
    const float a = B::a(i), b = B::b(i), tm = B::tm(i);
#pragma unroll
    for (int l = 0; l < L; ++l) {
      const float c = c2[l], s = s2[l], hx = hx2[l], hy = hy2[l];
      const float cd = fabsf(dot2(g.cm, c, g.sm, s));
      const float sd = fabsf(__fsub_rn(__fmul_rn(g.sm, c), __fmul_rn(g.cm, s)));
      const float p0 = dot2(dx[l], g.cm, dy[l], g.sm);
      const float p1 = dot2(-dx[l], g.sm, dy[l], g.cm);
      bool seg_maybe = true, seg_hit = true;
      segment_axis(__fadd_rn(p0, g.a_sv0), __fadd_rn(p0, g.b_sv0),
                   __fadd_rn(p0, g.tm_sv0), dot2(hx, cd, hy, sd), q.ex_in, q.ex_er,
                   seg_maybe, seg_hit);
      segment_axis(__fadd_rn(p1, g.a_sv1), __fadd_rn(p1, g.b_sv1),
                   __fadd_rn(p1, g.tm_sv1), dot2(hx, sd, hy, cd), q.ey_in, q.ey_er,
                   seg_maybe, seg_hit);
      segment_axis(__fadd_rn(p3[l], __fmul_rn(a, v3[l])),
                   __fadd_rn(p3[l], __fmul_rn(b, v3[l])),
                   __fadd_rn(p3[l], __fmul_rn(tm, v3[l])), hx,
                   dot2(q.ex_in, cd, q.ey_in, sd), dot2(q.ex_er, cd, q.ey_er, sd),
                   seg_maybe, seg_hit);
      segment_axis(__fadd_rn(p4[l], __fmul_rn(a, v4[l])),
                   __fadd_rn(p4[l], __fmul_rn(b, v4[l])),
                   __fadd_rn(p4[l], __fmul_rn(tm, v4[l])), hy,
                   dot2(q.ex_in, sd, q.ey_in, cd), dot2(q.ex_er, sd, q.ey_er, cd),
                   seg_maybe, seg_hit);
      maybe[l] = maybe[l] | seg_maybe;
      hit_cert[l] = hit_cert[l] | seg_hit;
      t_first[l] = seg_maybe ? a : t_first[l];
    }
  }
#pragma unroll
  for (int l = 0; l < L; ++l) {
    const float t = isfinite(t_first[l]) ? t_first[l] : 2.0f;
    t0[l] = fminf(fmaxf(t, 0.0f), 2.0f);
    flags[l] |= (maybe[l] ? 1 : 0) | (hit_cert[l] ? 2 : 0);
  }
}

}  // namespace screen
}  // namespace collide2d
