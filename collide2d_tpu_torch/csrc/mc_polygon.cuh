// What the fused k-gon Monte Carlo kernels share (kernel 7,
// csrc/mc_polygon_kernel.cu, and kernel 14, csrc/mc_moving_polygon_kernel.cu):
// a sample's pose, the per-row table as it is staged in shared memory, and
// the blended projections, for one shape fixed at build time.
//
// Shape. K obstacle vertices, K2 robot vertices and K2A kept robot axes are
// template arguments, which each kernel instantiates from the -D defines of
// its build (ops/mc_polygon_cuda.py::shape_defines; one library per shape,
// utils/cuda_build.py). Every loop over vertices and axes then unrolls and
// every table read has a constant offset, as the TPU kernel is specialised
// per static shape.
//
// Stream. Kernel 1's with shape noise off (csrc/mc_stream.cuh): words 0-2
// of draw block 0 as the normals dx, dy, dtheta; in a build with
// -DMC_BOX_MULLER=1, words 0-3 as two Box-Muller pairs, whose first three
// outputs are dx, dy, dtheta (mc_stream.cuh::box_muller_pair).
//
// Staged table. The packed row (C, ROWS) of ops/mc_polygon_cuda.py::
// _offsets keeps its layout in device memory; a block rearranges its row
// into float4 slots so that one 16-byte broadcast load feeds two blends or
// one axis:
//   robot axis i:      (ax_i, ay_i, rmin_i, rmax_i)
//   obstacle normal j: (nx_j, ny_j, nmin_j, nmax_j)
//   P row i, slot m:   (P1[i,2m], P2[i,2m], P1[i,2m+1], P2[i,2m+1])
//   Q row j, slot m:   (Q1[j,2m], Q2[j,2m], Q1[j,2m+1], Q2[j,2m+1])
// (an odd row's last slot carries zeros it never reads).
//
// Rounding. Every blend, projection and translation term is __fmul_rn /
// __fadd_rn / __fsub_rn, in the order of the plain versions, and the
// minima and maxima run over the vertices in their order, so a sample's
// verdict does not depend on how many samples a thread evaluates at once.

#pragma once

#include <stdint.h>

#include "fp32_rn.cuh"
#include "mc_stream.cuh"

namespace collide2d {
namespace mc_polygon {

// One sample's pose: the translation (dx, dy), cos/sin of the rotation and
// the translation in the rotated obstacle's frame, (u1, u2) = R^T (dx, dy).
struct Pose {
  float dx, dy, ct, st, u1, u2;
};

__device__ __forceinline__ Pose sample_pose(const mc_stream::Philox4& r,
                                            float sigma_x, float sigma_y,
                                            float sigma_th) {
  Pose p;
#if defined(MC_BOX_MULLER) && MC_BOX_MULLER
  // a Box-Muller build: pairs (words 0, 1) and (2, 3), normals c0, s0, c1
  const mc_stream::NormalPair n01 = mc_stream::box_muller_pair(r.v[0], r.v[1]);
  const mc_stream::NormalPair n23 = mc_stream::box_muller_pair(r.v[2], r.v[3]);
  p.dx = __fmul_rn(n01.c, sigma_x);
  p.dy = __fmul_rn(n01.s, sigma_y);
  const float th = __fmul_rn(n23.c, sigma_th);
#else
  using mc_stream::normal_from_word;
  const unsigned lanes = __activemask();  // the kernels' loops exit by lane
  p.dx = __fmul_rn(normal_from_word(r.v[0], lanes), sigma_x);
  p.dy = __fmul_rn(normal_from_word(r.v[1], lanes), sigma_y);
  const float th = __fmul_rn(normal_from_word(r.v[2], lanes), sigma_th);
#endif
  sincosf(th, &p.st, &p.ct);
  p.u1 = dot2(p.ct, p.dx, p.st, p.dy);
  p.u2 = __fsub_rn(__fmul_rn(p.ct, p.dy), __fmul_rn(p.st, p.dx));
  return p;
}

// Offsets of the packed row (ops/mc_polygon_cuda.py::_offsets) and of the
// staged float4 slots, for one shape.
template <int K, int K2, int K2A>
struct Table {
  static_assert(K >= 1 && K2 >= 1 && K2A >= 0 && K2A <= K2, "bad shape");
  static constexpr int kAx = 3, kAy = 3 + K2A, kRmin = 3 + 2 * K2A;
  static constexpr int kRmax = 3 + 3 * K2A, kNx = 3 + 4 * K2A;
  static constexpr int kNy = kNx + K, kNmin = kNx + 2 * K, kNmax = kNx + 3 * K;
  static constexpr int kP1 = kNx + 4 * K, kP2 = kP1 + K2A * K;
  static constexpr int kQ1 = kP2 + K2A * K, kQ2 = kQ1 + K * K2;
  // unpadded width of the packed row; kernel 14 appends (vx, vy) here
  static constexpr int kWidth = kQ2 + K * K2;
  // float4 slots a blend row takes (two vertices a slot)
  static constexpr int kPSlots = (K + 1) / 2, kQSlots = (K2 + 1) / 2;
  static constexpr int kRobot = 0, kNormal = K2A, kP = K2A + K;
  static constexpr int kQ = kP + K2A * kPSlots;
  static constexpr int kSlots = kQ + K * kQSlots;
};

// Slot e of the staged table, from the packed row in device memory.
template <int K, int K2, int K2A>
__device__ __forceinline__ float4 table_slot(const float* __restrict__ row,
                                             int e) {
  using T = Table<K, K2, K2A>;
  if (e < T::kNormal) {
    return make_float4(__ldg(row + T::kAx + e), __ldg(row + T::kAy + e),
                       __ldg(row + T::kRmin + e), __ldg(row + T::kRmax + e));
  }
  if (e < T::kP) {
    const int j = e - T::kNormal;
    return make_float4(__ldg(row + T::kNx + j), __ldg(row + T::kNy + j),
                       __ldg(row + T::kNmin + j), __ldg(row + T::kNmax + j));
  }
  // a blend slot: vertices m and m + 1 of one P row (K vertices, cos and
  // sin tables P1, P2) or one Q row (K2 vertices, Q1, Q2)
  const bool q = e >= T::kQ;
  const int width = q ? K2 : K;
  const int slots = q ? T::kQSlots : T::kPSlots;
  const int r = q ? e - T::kQ : e - T::kP;
  const int m = 2 * (r % slots);
  const float* t1 = row + (q ? T::kQ1 : T::kP1) + (r / slots) * width;
  const float* t2 = row + (q ? T::kQ2 : T::kP2) + (r / slots) * width;
  const bool last = m + 1 >= width;
  return make_float4(__ldg(t1 + m), __ldg(t2 + m),
                     last ? 0.0f : __ldg(t1 + m + 1),
                     last ? 0.0f : __ldg(t2 + m + 1));
}

// min / max over a blend row of M vertices of ct * T1 + st * T2 for each of
// S samples, vertex 0 first, as the plain versions take them.
template <int M, int S>
__device__ __forceinline__ void blend_min_max(const float4* __restrict__ slots,
                                              const Pose (&p)[S],
                                              float (&mn)[S], float (&mx)[S]) {
#pragma unroll
  for (int m = 0; m < (M + 1) / 2; ++m) {
    const float4 v = slots[m];
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const float a = dot2(p[s].ct, v.x, p[s].st, v.y);
      if (m == 0) {
        mn[s] = a;
        mx[s] = a;
      } else {
        mn[s] = fminf(mn[s], a);
        mx[s] = fmaxf(mx[s], a);
      }
      if (2 * m + 1 < M) {
        const float b = dot2(p[s].ct, v.z, p[s].st, v.w);
        mn[s] = fminf(mn[s], b);
        mx[s] = fmaxf(mx[s], b);
      }
    }
  }
}

}  // namespace mc_polygon
}  // namespace collide2d
