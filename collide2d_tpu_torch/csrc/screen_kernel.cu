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
// start, else 2, 0, 2). The lane's arithmetic is csrc/screen_lane.cuh.
//
// What bounds it on this card: 20 bytes in and 8 out a lane against ~1,070
// FP32 operations at 8 segments, each its own instruction (no contraction),
// so the instructions a lane issues bound it (chip_smoke.py counts them and
// reads the SASS for the issue floor).
//
// Design. The segment count is a compile-time constant (-DSCREEN_NSEG, one
// library per count, 8 by default): the segment loop unrolls and the bounds
// a, b, tm are immediates. A block takes the 512 lanes of one configuration
// (grid (C, ceil(S / 512))), two lanes a thread (s and s + 256, so a warp's
// loads stay contiguous), and every value that does not depend on the lane
// is computed once a block into shared memory, spread over three warps:
// warp 0 the segments (cos/sin of the midpoint angle, the rotating axes'
// speeds and their products with a, b and tm), one thread of warp 1 the
// start angle's cos/sin and the window's two robot-axis speeds (their IEEE
// divisions), one thread of warp 2 delta and the inflated and eroded
// extents, one of warp 3 the row's scalars. A lane then does only what
// depends on its draws, and reads each segment's shared values once for
// both of its thread's lanes. The launch bound holds four blocks an SM.
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

#include "screen_lane.cuh"

#ifndef SCREEN_NSEG
#define SCREEN_NSEG 8
#endif

namespace {

using namespace collide2d::screen;

constexpr int kNSeg = SCREEN_NSEG;
static_assert(kNSeg >= 1 && kNSeg <= kMaxSeg, "SCREEN_NSEG must be in [1, 32]");
constexpr int kThreads = 256;
constexpr int kLanes = 2;  // lanes a thread
constexpr int kBlockLanes = kThreads * kLanes;
// Blocks an SM must hold: caps a thread at 64 registers, no spill. On an
// NVIDIA H100 80GB HBM3 at 8,192 x 512 lanes (utils/screen_raycast_ab.py,
// in turns) this ran 0.131-0.134 ms, against 0.136-0.138 at 3 blocks (80
// registers), 0.244-0.246 at 1 (179) and 0.140 with one lane a thread.
constexpr int kMinBlocks = 4;

__global__ void __launch_bounds__(kThreads, kMinBlocks)
    rotating_screen_kernel(const float* __restrict__ z,
                           const float* __restrict__ params,
                           int32_t* __restrict__ flags,
                           float* __restrict__ t0_out, int num_lanes, float tol,
                           float pi_f) {
  __shared__ ScreenConfig q_sh;
  __shared__ ScreenSegment seg_sh[kNSeg];
  const int c = blockIdx.x;
  const float* p = params + static_cast<long long>(c) * 16;
  const int tid = threadIdx.x;
  if (tid < kNSeg) {
    float sm, cm;
    sincosf(segment_angle<kNSeg>(p, tid), &sm, &cm);
    seg_sh[tid] = screen_segment<kNSeg>(p, cm, sm, tid);
  } else if (tid == 32) {
    float s1, c1;
    sincosf(p[11], &s1, &c1);
    set_rotation(q_sh, p, c1, s1);
  } else if (tid == 64) {
    set_radii(q_sh, p, sinf(delta_angle<kNSeg>(p, pi_f)), tol);
  } else if (tid == 96) {
    set_row_scalars(q_sh, p);
  }
  __syncthreads();

  const ScreenConfig q = q_sh;
  const int s0 = blockIdx.y * kBlockLanes + tid;
  if (s0 >= num_lanes) return;
  const long long base = static_cast<long long>(c) * num_lanes;
  float zl[kLanes][5], c2[kLanes], s2[kLanes];
  bool live[kLanes];
#pragma unroll
  for (int l = 0; l < kLanes; ++l) {
    const int s = s0 + l * kThreads;
    live[l] = s < num_lanes;
    const float* zp = z + (base + (live[l] ? s : s0)) * 5;
#pragma unroll
    for (int k = 0; k < 5; ++k) zl[l][k] = __ldg(zp + k);
    sincosf(lane_angle(q, zl[l][2]), &s2[l], &c2[l]);
  }
  int f[kLanes];
  float t0[kLanes];
  screen_lanes<kNSeg, kLanes>(q, seg_sh, zl, c2, s2, f, t0);
#pragma unroll
  for (int l = 0; l < kLanes; ++l) {
    if (live[l]) {
      const long long lane = base + s0 + l * kThreads;
      flags[lane] = f[l];
      t0_out[lane] = t0[l];
    }
  }
}

}  // namespace

// The segment count this library was built for, and the lanes a thread takes.
extern "C" int rotating_screen_segments() { return kNSeg; }
extern "C" int rotating_screen_thread_lanes() { return kLanes; }

// Plain C entry point (bound with ctypes). z (C, S, 5), params (C, 16),
// flags and t0 (C, S). n_seg must be the library's (rotating_screen_segments)
// and inv_n, half_inv_n f32(1 / n_seg), f32(0.5 / n_seg). Launches on
// `stream`, does not synchronise, and returns cudaGetLastError() after the
// launch (0 = ok).
extern "C" int rotating_screen_launch(const float* z, const float* params,
                                      int32_t* flags, float* t0,
                                      int num_configs, int num_lanes,
                                      int n_seg, float inv_n, float half_inv_n,
                                      float tol, float pi_f, void* stream) {
  if (num_configs <= 0 || num_lanes <= 0) return static_cast<int>(cudaSuccess);
  if (n_seg != kNSeg || inv_n != Bounds<kNSeg>::inv_n ||
      half_inv_n != Bounds<kNSeg>::half_inv_n) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long chunks = (num_lanes + kBlockLanes - 1) / kBlockLanes;
  if (chunks > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(num_configs),
                  static_cast<unsigned>(chunks));
  rotating_screen_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      z, params, flags, t0, num_lanes, tol, pi_f);
  return static_cast<int>(cudaGetLastError());
}
