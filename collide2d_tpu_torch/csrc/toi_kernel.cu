// Time of impact of moving oriented boxes (kernel 12) on Hopper.
//
// Replaces the TPU kernel collide2d_tpu/ops/toi_pallas.py::_make_toi_kernel
// (:81). Each box moves rigidly (centre c + t v, angle th + t w). A pair
// whose boxes both have w == 0 takes the EXACT translation window
// (obb_distance.cuh::obb_translation_window): t = max(entry, 0) when the
// window meets [0, t_max], else +inf. A rotating pair runs conservative
// advancement: from t = 0, t <- t + max(d(t), 0) / bound with
// bound = |v2 - v1| + |w1| r1 + |w2| r2 (ri the circumradius), until
// d(t) <= tol or t > t_max or `iters` steps; the result is t when
// d(t) <= tol and t <= t_max, else +inf. d(t) is the closed-form box
// signed distance of kernel 8 (obb_distance.cuh::obb_signed_distance).
//
// Layout: the (8, 8, M) SoA of `toi_cuda.pack_moving_obbs`, planes cx, cy,
// theta, |w|/2, |h|/2, vx, vy, omega of n = 8M values, pair p at
// plane[c][p]; one thread a pair, coalesced loads, one float32 written.
//
// Early exit. The TPU stops a whole tile once all its lanes have converged
// (a while loop on "any lane live"). Here each thread leaves its own loop
// when its pair converges: a converged lane never changes again in the
// fixed-trip loop (d(t) and t are frozen), so each result equals the
// fixed-trip loop's. A warp still runs until its slowest lane, so the cost
// is the warps' maximum steps, not the mean (chip_smoke.py reports both).
//
// What bounds it on this card. A pair reads 64 bytes and writes 4; a step
// evaluates the distance (~170 FP32 operations, kernel 8's) plus the
// advanced angles and centres and two sincosf, ~200 operations, so at the
// bench shape (2^21 pairs, 64 iterations) the work depends on the steps
// the lanes take: operations bound it (0.52 ms if every lane took 64
// steps), and the bound is taken at the steps this run's data needs.
//
// Rounding. Products and sums are __fmul_rn / __fadd_rn / __fsub_rn in
// the JAX order, divisions and sqrtf IEEE, and the evolved angles go
// through sincosf (never __sinf/__cosf); the plain version
// (ops/toi_cuda.py) uses torch's cos/sin, which may differ by an ulp and
// move a lane whose d(t) lies within rounding of `tol`.
//
// The wrapper allocates the output; the kernel allocates nothing and does
// not synchronise.

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>

#include "obb_distance.cuh"

namespace {

using collide2d::dot2;

constexpr int kThreads = 256;

struct Box {
  float cx, cy, th, hx, hy, vx, vy, w;
};

__device__ __forceinline__ Box load_box(const float* __restrict__ b,
                                        long long n, long long p) {
  return Box{b[p],         b[n + p],     b[2 * n + p], b[3 * n + p],
             b[4 * n + p], b[5 * n + p], b[6 * n + p], b[7 * n + p]};
}

// Signed distance of the pair at time t.
__device__ __forceinline__ float distance_at(const Box& a, const Box& b,
                                             float t) {
  float s1, c1, s2, c2;
  sincosf(__fadd_rn(a.th, __fmul_rn(t, a.w)), &s1, &c1);
  sincosf(__fadd_rn(b.th, __fmul_rn(t, b.w)), &s2, &c2);
  const float dx = __fsub_rn(__fadd_rn(b.cx, __fmul_rn(t, b.vx)),
                             __fadd_rn(a.cx, __fmul_rn(t, a.vx)));
  const float dy = __fsub_rn(__fadd_rn(b.cy, __fmul_rn(t, b.vy)),
                             __fadd_rn(a.cy, __fmul_rn(t, a.vy)));
  return collide2d::obb_signed_distance(dx, dy, c1, s1, a.hx, a.hy, c2, s2,
                                        b.hx, b.hy);
}

__global__ void __launch_bounds__(kThreads)
    moving_obb_toi_kernel(const float* __restrict__ b1,
                          const float* __restrict__ b2,
                          float* __restrict__ out, long long n, float t_max,
                          int iters, float tol) {
  const long long p = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (p >= n) return;
  const Box a = load_box(b1, n, p);
  const Box b = load_box(b2, n, p);
  const float rvx = __fsub_rn(b.vx, a.vx);
  const float rvy = __fsub_rn(b.vy, a.vy);

  if (a.w == 0.0f && b.w == 0.0f) {
    // Translation only: the exact window, no iteration.
    float s1, c1, s2, c2, entry, exit;
    sincosf(a.th, &s1, &c1);
    sincosf(b.th, &s2, &c2);
    collide2d::obb_translation_window(__fsub_rn(b.cx, a.cx),
                                      __fsub_rn(b.cy, a.cy), c1, s1, a.hx,
                                      a.hy, c2, s2, b.hx, b.hy, rvx, rvy,
                                      entry, exit);
    const bool hit = entry <= exit && entry <= t_max && exit >= 0.0f;
    out[p] = hit ? fmaxf(entry, 0.0f) : INFINITY;
    return;
  }

  const float r1 = sqrtf(dot2(a.hx, a.hx, a.hy, a.hy));  // circumradius
  const float r2 = sqrtf(dot2(b.hx, b.hx, b.hy, b.hy));
  const float bound = fmaxf(
      __fadd_rn(__fadd_rn(sqrtf(dot2(rvx, rvx, rvy, rvy)),
                          __fmul_rn(fabsf(a.w), r1)),
                __fmul_rn(fabsf(b.w), r2)),
      1e-30f);
  float t = 0.0f;
  float d = 0.0f;
  bool stopped = false;
  for (int i = 0; i < iters; ++i) {
    d = distance_at(a, b, t);
    if (d <= tol || t > t_max) {
      stopped = true;  // converged or past the horizon: t is final
      break;
    }
    t = __fadd_rn(t, __fdiv_rn(fmaxf(d, 0.0f), bound));
  }
  if (!stopped) d = distance_at(a, b, t);  // the budget ran out: check t
  out[p] = (d <= tol && t <= t_max) ? t : INFINITY;
}

unsigned grid_for(long long n) {
  const long long blocks = (n + kThreads - 1) / kThreads;
  return blocks > INT_MAX ? 0u : static_cast<unsigned>(blocks);
}

}  // namespace

// Plain C entry point (bound with ctypes). `n` is the number of pairs (8M).
// Launches on `stream`, does not synchronise, and returns
// cudaGetLastError() after the launch (0 = ok).
extern "C" int moving_obb_toi_launch(const float* b1, const float* b2,
                                     float* out, long long n, float t_max,
                                     int iters, float tol, void* stream) {
  if (n <= 0) return static_cast<int>(cudaSuccess);
  const unsigned grid = grid_for(n);
  if (grid == 0 || iters < 0) return static_cast<int>(cudaErrorInvalidValue);
  moving_obb_toi_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      b1, b2, out, n, t_max, iters, tol);
  return static_cast<int>(cudaGetLastError());
}
