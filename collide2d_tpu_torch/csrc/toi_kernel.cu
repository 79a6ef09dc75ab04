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
// plane[c][p]; one float32 written a pair.
//
// Lanes refilled as they converge. A pair's sequence of t depends on its
// own 16 floats alone, so the pair a lane holds can change at any step
// without changing any result. Each warp walks its own contiguous range of
// kPairsPerLane x 32 pairs. A lane holds one rotating pair and evaluates
// its distance once an iteration; the evaluation that stops the pair
// (d <= tol, t > t_max, or its `iters` steps taken: the same formula then
// reads the final t) writes the result and frees the lane. When at least
// kRefillAt lanes are free (any, near the range's end), the free lanes take
// the range's next pairs in order (a ballot and a popc prefix): a
// translating pair is settled there through its exact window and never
// occupies a stepping lane; a rotating one loads its 64 bytes (scattered
// within the range: the first fill is coalesced) and its bound. So a warp
// iterates about (the evaluations of its pairs) / 32 times plus the end of
// its range, where the earlier design (one pair a thread, run to its own
// convergence) ran 32 x its slowest lane's evaluations: at the bench shape
// 52.7 evaluations a warp-slot against 19.8 a pair (chip_smoke.py phase
// 14), and 0.937-0.940 ms against this design's 0.546-0.547.
//
// A pair takes steps + 1 evaluations whatever the lane: the `iters`
// budget counts its own steps (`e`), and a pair that exhausts it is
// evaluated once more at its last t, as the fixed-trip loop checks it.
//
// What bounds it on this card. A pair reads 64 bytes and writes 4; an
// evaluation is ~209 FP32 operations (kernel 8's distance, the advanced
// angles and centres, the stop tests and the step) and two sincosf, so
// operations bound it at the evaluations this run's data needs; beside the
// bound, chip_smoke.py reads the kernel's issue floor from its SASS
// (`toi_issue_floor`). ptxas: 56 registers, no spill, a 32-byte stack
// frame that sincosf's Payne-Hanek reduction keeps (a path the bench's
// angles never take; the earlier design had the same frame).
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
constexpr int kWarps = kThreads / 32;
constexpr unsigned kAll = 0xffffffffu;
// Pairs a warp walks, per lane. At the bench shape (2^21 rotating pairs,
// an NVIDIA H100 80GB HBM3, utils/query_ab.py in turns against a csrc copy
// with one constant edited) 16 ran 0.571-0.572 ms, 8 0.600-0.605 and 32
// 0.609-0.611: a shorter range pays its tail more often, a longer one
// leaves the card fewer warps.
constexpr int kPairsPerLane = 16;
constexpr int kWarpPairs = 32 * kPairsPerLane;
// Free lanes that start a refill (near the range's end, any): each refill
// round issues the loads and set-up once for the whole warp, while free
// lanes idle until it. Against 8 (0.566-0.577 ms), 1 ran 0.660-0.663, 4
// 0.583-0.584, 6 0.572-0.573, 12 0.586-0.589 and 16 0.617.
constexpr int kRefillAt = 8;

struct Box {
  float cx, cy, th, hx, hy, vx, vy, w;
};

__device__ __forceinline__ Box load_box(const float* __restrict__ b,
                                        long long n, int p) {
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

// The first impact time of a translating pair: its exact window.
__device__ __forceinline__ float window_toi(const Box& a, const Box& b,
                                            float t_max) {
  float s1, c1, s2, c2, entry, exit;
  sincosf(a.th, &s1, &c1);
  sincosf(b.th, &s2, &c2);
  collide2d::obb_translation_window(
      __fsub_rn(b.cx, a.cx), __fsub_rn(b.cy, a.cy), c1, s1, a.hx, a.hy, c2, s2,
      b.hx, b.hy, __fsub_rn(b.vx, a.vx), __fsub_rn(b.vy, a.vy), entry, exit);
  const bool hit = entry <= exit && entry <= t_max && exit >= 0.0f;
  return hit ? fmaxf(entry, 0.0f) : INFINITY;
}

// The advancement's divisor of a rotating pair.
__device__ __forceinline__ float motion_bound(const Box& a, const Box& b) {
  const float rvx = __fsub_rn(b.vx, a.vx);
  const float rvy = __fsub_rn(b.vy, a.vy);
  const float r1 = sqrtf(dot2(a.hx, a.hx, a.hy, a.hy));  // circumradius
  const float r2 = sqrtf(dot2(b.hx, b.hx, b.hy, b.hy));
  return fmaxf(__fadd_rn(__fadd_rn(sqrtf(dot2(rvx, rvx, rvy, rvy)),
                                   __fmul_rn(fabsf(a.w), r1)),
                         __fmul_rn(fabsf(b.w), r2)),
               1e-30f);
}

__global__ void __launch_bounds__(kThreads)
    moving_obb_toi_kernel(const float* __restrict__ b1,
                          const float* __restrict__ b2,
                          float* __restrict__ out, long long n, float t_max,
                          int iters, float tol) {
  const int lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1u;
  const long long first =
      (static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5)) * kWarpPairs;
  if (first >= n) return;  // warp-uniform
  // The warp's range and the pairs' offsets in it.
  const int count = static_cast<int>(min(n - first, static_cast<long long>(kWarpPairs)));
  const float* __restrict__ r1 = b1 + first;
  const float* __restrict__ r2 = b2 + first;
  float* __restrict__ r_out = out + first;

  Box a, b;
  float bound = 1.0f, t = 0.0f;
  float* dst = r_out;  // the held pair's result
  int e = 0;           // the held pair's steps
  int held = -1;       // the held pair, -1 for none
  int next = 0;        // the range's next pair
  for (;;) {
    // Free lanes take the range's next pairs; translating ones settle here.
    unsigned idle = __ballot_sync(kAll, held < 0);
    while (idle != 0u && next < count) {
      const int q = next + __popc(idle & below);
      next += __popc(idle);
      if (held < 0 && q < count) {
        a = load_box(r1, n, q);
        b = load_box(r2, n, q);
        if (a.w == 0.0f && b.w == 0.0f) {
          r_out[q] = window_toi(a, b, t_max);
        } else {
          bound = motion_bound(a, b);
          t = 0.0f;
          e = 0;
          held = q;
          dst = r_out + q;
        }
      }
      idle = __ballot_sync(kAll, held < 0);
    }
    if (idle == kAll) break;  // the range is drained and every pair settled
    // Step the held pairs until enough lanes are free for a refill (any
    // lane near the range's end; all of them once it is drained). The
    // shuffle keeps nvcc from recomputing the warp-uniform threshold from
    // the range's bounds at every step.
    const int refill_at = __shfl_sync(
        kAll, next >= count ? 33 : count - next < 32 ? 1 : kRefillAt, 0);
    do {
      if (held >= 0) {
        const float d = distance_at(a, b, t);
        if (d <= tol || t > t_max || e == iters) {
          *dst = (d <= tol && t <= t_max) ? t : INFINITY;
          held = -1;
        } else {
          t = __fadd_rn(t, __fdiv_rn(fmaxf(d, 0.0f), bound));
          ++e;
        }
      }
      idle = __ballot_sync(kAll, held < 0);
    } while (idle != kAll && __popc(idle) < refill_at);
  }
}

unsigned grid_for(long long n) {
  const long long per_block = static_cast<long long>(kWarpPairs) * kWarps;
  const long long blocks = (n + per_block - 1) / per_block;
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
