// Stage A of the rotating rectangle trajectory cascade (kernel 15) on Hopper.
//
// Replaces the TPU kernel collide2d_tpu/ops/screen_pallas.py::_screen_kernel
// (:99). For each lane (configuration c, sample s) of a threefry step it
// reads the five raw normals z[c, s, :] and its configuration's 16 scalars
// (ops/screen_cuda.py::pack_screen_params) and computes, with the formulas
// of its plain version (ops/screen_cuda.py::rotating_screen_plain, which
// composes mc/moving.py::_paired_segment_screen):
//
//   1. the noisy obstacle: offset z0 sd0, z1 sd1, angle z2 sd2 (cos, sin),
//      half extents |wh + z3 sd3| / 2, |wh + z4 sd4| / 2;
//   2. the exact SAT test at t = 0 (the 4 unit axes);
//   3. the exact translation window of the unit-horizon motion
//      (obb_distance.cuh::obb_translation_window);
//   4. the paired inflated/eroded screen over n_seg horizon segments: per
//      segment and SAT axis the offset p0 and speed s of the frozen proxy,
//      min |p0 + t s| over [a, b] against the (delta + tol)-inflated radius
//      (a miss certificate when an axis separates) and |p0 + tm s| against
//      the eroded radius (a hit certificate when no axis separates);
//
// and writes flags (bit 0 maybe, bit 1 certified hit or t = 0 overlap,
// bit 2 window verdict) and the warm start t0 = clip(first maybe segment's
// start, else 2, 0, 2).
//
// Design. A block takes 256 lanes of ONE configuration (grid (C, ceil(S /
// 256))). Everything that depends only on the configuration, the cos/sin of
// its n_seg midpoint angles, of its start angle, the chord bound delta and
// the inflated and eroded robot extents, is computed once per block into
// shared memory; the per-lane transcendentals are then only the sincosf of
// the angle draw. Loads: 5 floats a lane from a (C, S, 5) row, so a warp
// reads 640 contiguous bytes; stores: 8 bytes a lane, coalesced.
//
// What bounds it on this card: 20 bytes in and 8 out a lane against ~40
// operations for the obstacle, t = 0 test and window and ~90 a segment, so
// at 8 segments operations bound it (chip_smoke.py counts them).
//
// Rounding. Every product and sum is __fmul_rn / __fadd_rn / __fsub_rn in
// the torch expression's order, divisions IEEE, cos/sin through sincosf and
// sinf: on the card the kernel equals its plain version bit for bit where
// sincosf rounds as torch's cos/sin do.
//
// The wrapper allocates the outputs; the kernel allocates nothing.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "obb_distance.cuh"

namespace {

using collide2d::dot2;
using collide2d::radius;

constexpr int kThreads = 256;
constexpr int kMaxSeg = 32;

// Per-configuration values, computed once per block.
struct ConfigScalars {
  float sd[5];
  float wh_x, wh_y, px, py, vx, vy;
  float c1, s1, hx1, hy1;
  float ex_in, ey_in, ex_er, ey_er;
  float cm[kMaxSeg], sm[kMaxSeg];
};

__global__ void __launch_bounds__(kThreads)
    rotating_screen_kernel(const float* __restrict__ z,
                           const float* __restrict__ params,
                           int32_t* __restrict__ flags,
                           float* __restrict__ t0_out, int num_lanes,
                           int n_seg, float inv_n, float half_inv_n, float tol,
                           float pi_f) {
  __shared__ ConfigScalars q;
  const int c = blockIdx.x;
  const float* p = params + static_cast<long long>(c) * 16;
  const float th0 = __ldg(p + 11);
  const float w = __ldg(p + 12);
  if (threadIdx.x < n_seg) {
    // thm = th0 + (i + 0.5) * (w * (1 / n_seg))
    const float ii = static_cast<float>(threadIdx.x);
    const float thm = __fadd_rn(th0, __fmul_rn(__fadd_rn(ii, 0.5f),
                                               __fmul_rn(w, inv_n)));
    float sm, cm;
    sincosf(thm, &sm, &cm);
    q.cm[threadIdx.x] = cm;
    q.sm[threadIdx.x] = sm;
  }
  if (threadIdx.x == kThreads - 1) {
    for (int i = 0; i < 5; ++i) q.sd[i] = __ldg(p + i);
    q.wh_x = __ldg(p + 5);
    q.wh_y = __ldg(p + 6);
    q.px = __ldg(p + 7);
    q.py = __ldg(p + 8);
    q.vx = __ldg(p + 9);
    q.vy = __ldg(p + 10);
    const float hx1 = __ldg(p + 13);
    const float hy1 = __ldg(p + 14);
    const float r_rob = __ldg(p + 15);
    q.hx1 = hx1;
    q.hy1 = hy1;
    sincosf(th0, &q.s1, &q.c1);
    // delta = 2 r sin(min(|w| (0.5 / n_seg), pi) * 0.5)
    const float delta = __fmul_rn(
        __fmul_rn(2.0f, r_rob),
        sinf(__fmul_rn(fminf(__fmul_rn(fabsf(w), half_inv_n), pi_f), 0.5f)));
    const float d_in = __fadd_rn(delta, tol);
    const float hmin = fminf(hx1, hy1);
    const float qh = __fmul_rn(hmin, 0.7071067f);  // inscribed-square half
    const bool valid_er = delta < hmin;
    q.ex_er = valid_er ? __fsub_rn(hx1, delta) : qh;
    q.ey_er = valid_er ? __fsub_rn(hy1, delta) : qh;
    q.ex_in = __fadd_rn(hx1, d_in);
    q.ey_in = __fadd_rn(hy1, d_in);
  }
  __syncthreads();

  const int s = blockIdx.y * kThreads + threadIdx.x;
  if (s >= num_lanes) return;
  const long long lane = static_cast<long long>(c) * num_lanes + s;
  const float* zl = z + lane * 5;
  const float ox = __fmul_rn(__ldg(zl + 0), q.sd[0]);
  const float oy = __fmul_rn(__ldg(zl + 1), q.sd[1]);
  const float d2 = __fmul_rn(__ldg(zl + 2), q.sd[2]);
  float s2, c2;
  sincosf(d2, &s2, &c2);
  const float hx2 =
      __fmul_rn(fabsf(__fadd_rn(q.wh_x, __fmul_rn(__ldg(zl + 3), q.sd[3]))), 0.5f);
  const float hy2 =
      __fmul_rn(fabsf(__fadd_rn(q.wh_y, __fmul_rn(__ldg(zl + 4), q.sd[4]))), 0.5f);
  const float c1 = q.c1, s1 = q.s1, hx1 = q.hx1, hy1 = q.hy1;

  // the exact t = 0 SAT test
  const float cd0 = fabsf(dot2(c1, c2, s1, s2));
  const float sd0 = fabsf(__fsub_rn(__fmul_rn(s1, c2), __fmul_rn(c1, s2)));
  const float dx = __fsub_rn(ox, q.px);
  const float dy = __fsub_rn(oy, q.py);
  const bool hit_at_0 =
      fabsf(dot2(dx, c1, dy, s1)) <= radius(hx1, hx2, cd0, hy2, sd0) &&
      fabsf(dot2(-dx, s1, dy, c1)) <= radius(hy1, hx2, sd0, hy2, cd0) &&
      fabsf(dot2(dx, c2, dy, s2)) <= radius(hx2, hx1, cd0, hy1, sd0) &&
      fabsf(dot2(-dx, s2, dy, c2)) <= radius(hy2, hx1, sd0, hy1, cd0);

  // the exact translation window (the obstacle moves by -v t)
  const float vrx = -q.vx, vry = -q.vy;
  float entry, exit;
  collide2d::obb_translation_window(dx, dy, c1, s1, hx1, hy1, c2, s2, hx2, hy2,
                                    vrx, vry, entry, exit);
  const bool hit_exact = entry <= exit && entry <= 1.0f && exit >= 0.0f;

  // the paired segment screen; axes 3 and 4 (the obstacle's) do not rotate
  const float p3 = dot2(dx, c2, dy, s2);
  const float v3 = dot2(vrx, c2, vry, s2);
  const float p4 = dot2(-dx, s2, dy, c2);
  const float v4 = dot2(-vrx, s2, vry, c2);
  bool maybe = false, hit_cert = false;
  float t_first = INFINITY;
  for (int i = 0; i < n_seg; ++i) {
    const float a = __fmul_rn(static_cast<float>(i), inv_n);
    const float b = __fadd_rn(a, inv_n);
    const float tm = __fadd_rn(a, half_inv_n);
    const float cm = q.cm[i], sm = q.sm[i];
    const float cd = fabsf(dot2(cm, c2, sm, s2));
    const float sd = fabsf(__fsub_rn(__fmul_rn(sm, c2), __fmul_rn(cm, s2)));
    const float p0[4] = {dot2(dx, cm, dy, sm), dot2(-dx, sm, dy, cm), p3, p4};
    const float sv[4] = {dot2(vrx, cm, vry, sm), dot2(-vrx, sm, vry, cm), v3, v4};
    const float r_sh[4] = {dot2(hx2, cd, hy2, sd), dot2(hx2, sd, hy2, cd), hx2, hy2};
    const float r_in[4] = {q.ex_in, q.ey_in, dot2(q.ex_in, cd, q.ey_in, sd),
                           dot2(q.ex_in, sd, q.ey_in, cd)};
    const float r_er[4] = {q.ex_er, q.ey_er, dot2(q.ex_er, cd, q.ey_er, sd),
                           dot2(q.ex_er, sd, q.ey_er, cd)};
    bool seg_maybe = true, seg_hit = true;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float pa = __fadd_rn(p0[k], __fmul_rn(a, sv[k]));
      const float pb = __fadd_rn(p0[k], __fmul_rn(b, sv[k]));
      const float mn =
          __fmul_rn(pa, pb) <= 0.0f ? 0.0f : fminf(fabsf(pa), fabsf(pb));
      seg_maybe = seg_maybe && mn <= __fadd_rn(r_sh[k], r_in[k]);
      seg_hit = seg_hit &&
                fabsf(__fadd_rn(p0[k], __fmul_rn(tm, sv[k]))) <=
                    __fadd_rn(r_sh[k], r_er[k]);
    }
    maybe = maybe || seg_maybe;
    hit_cert = hit_cert || seg_hit;
    if (seg_maybe) t_first = fminf(t_first, a);
  }
  flags[lane] = (maybe ? 1 : 0) | ((hit_cert || hit_at_0) ? 2 : 0) |
                (hit_exact ? 4 : 0);
  const float t0 = isfinite(t_first) ? t_first : 2.0f;
  t0_out[lane] = fminf(fmaxf(t0, 0.0f), 2.0f);
}

}  // namespace

// Plain C entry point (bound with ctypes). z (C, S, 5), params (C, 16),
// flags and t0 (C, S). Launches on `stream`, does not synchronise, and
// returns cudaGetLastError() after the launch (0 = ok).
extern "C" int rotating_screen_launch(const float* z, const float* params,
                                      int32_t* flags, float* t0,
                                      int num_configs, int num_lanes,
                                      int n_seg, float inv_n, float half_inv_n,
                                      float tol, float pi_f, void* stream) {
  if (num_configs <= 0 || num_lanes <= 0) return static_cast<int>(cudaSuccess);
  if (n_seg < 1 || n_seg > kMaxSeg) return static_cast<int>(cudaErrorInvalidValue);
  const long long chunks = (num_lanes + kThreads - 1) / kThreads;
  if (chunks > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(num_configs),
                  static_cast<unsigned>(chunks));
  rotating_screen_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      z, params, flags, t0, num_lanes, n_seg, inv_n, half_inv_n, tol, pi_f);
  return static_cast<int>(cudaGetLastError());
}
