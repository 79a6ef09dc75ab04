// What the fused k-gon Monte Carlo kernels share (kernel 7,
// csrc/mc_polygon_kernel.cu, and kernel 14, csrc/mc_moving_polygon_kernel.cu):
// the sample stream, the per-row table as it is staged in shared memory, and
// the blended projections, for one shape fixed at build time.
//
// Shape. K obstacle vertices, K2 robot vertices and K2A kept robot axes are
// template arguments, which each kernel instantiates from the -D defines of
// its build (ops/mc_polygon_cuda.py::shape_defines; one library per shape,
// utils/cuda_build.py). Every loop over vertices and axes then unrolls and
// every table read has a constant offset, as the TPU kernel is specialised
// per static shape.
//
// Stream. Kernel 1's Philox4x32-10 with shape noise off: keyed by the
// round's two seed words, counter (sample index low, sample index high,
// uid, 0), words 0-2 as 23-bit codes through XLA's float32 erf_inv.
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

namespace collide2d {
namespace mc_polygon {

struct Philox4 {
  uint32_t v[4];
};

// Philox4x32-10, the same function as mc_kernel.cu's.
__device__ __forceinline__ Philox4 philox4x32_10(uint32_t c0, uint32_t c1,
                                                 uint32_t c2, uint32_t c3,
                                                 uint32_t k0, uint32_t k1) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r > 0) {
      k0 += 0x9E3779B9u;
      k1 += 0xBB67AE85u;
    }
    const uint32_t hi0 = __umulhi(0xD2511F53u, c0);
    const uint32_t lo0 = 0xD2511F53u * c0;
    const uint32_t hi1 = __umulhi(0xCD9E8D57u, c2);
    const uint32_t lo1 = 0xCD9E8D57u * c2;
    const uint32_t n0 = hi1 ^ c1 ^ k0;
    const uint32_t n2 = hi0 ^ c3 ^ k1;
    c0 = n0;
    c1 = lo1;
    c2 = n2;
    c3 = lo0;
  }
  Philox4 out = {{c0, c1, c2, c3}};
  return out;
}

// XLA's float32 erf_inv, as mc_kernel.cu's (log1pf stands in for XLA's
// Cephes log1p; 23-bit codes keep |x| <= 1 - 2^-23). The central branch
// (w < 5, |z| below ~2.9) holds for ~99.6% of draws; when it holds for every
// active lane of the warp, the warp evaluates that branch's polynomial alone,
// its coefficients immediates: the same operations on the same values as
// the general form, which selects each coefficient and costs a select and a
// register move per step (kernel 7 at S = 4: 8.75 against 9.06 ms at 100k x
// 4,096, K = 8, on an H100, counts equal).
__device__ __forceinline__ float erfinv_f32(float x) {
  float w = -log1pf(x * -x);
  const bool lt = w < 5.0f;
  if (__all_sync(__activemask(), lt)) {
    w = w - 2.5f;
    float p = 2.81022636e-08f;
    p = 3.43273939e-07f + p * w;
    p = -3.5233877e-06f + p * w;
    p = -4.39150654e-06f + p * w;
    p = 0.00021858087f + p * w;
    p = -0.00125372503f + p * w;
    p = -0.00417768164f + p * w;
    p = 0.246640727f + p * w;
    p = 1.50140941f + p * w;
    return p * x;
  }
  w = lt ? w - 2.5f : sqrtf(w) - 3.0f;
  float p = lt ? 2.81022636e-08f : -0.000200214257f;
  p = (lt ? 3.43273939e-07f : 0.000100950558f) + p * w;
  p = (lt ? -3.5233877e-06f : 0.00134934322f) + p * w;
  p = (lt ? -4.39150654e-06f : -0.00367342844f) + p * w;
  p = (lt ? 0.00021858087f : 0.00573950773f) + p * w;
  p = (lt ? -0.00125372503f : -0.0076224613f) + p * w;
  p = (lt ? -0.00417768164f : 0.00943887047f) + p * w;
  p = (lt ? 0.246640727f : 1.00167406f) + p * w;
  p = (lt ? 1.50140941f : 2.83297682f) + p * w;
  return p * x;
}

// One standard normal from a Philox word: its top 23 bits b give
// z = sqrt(2) * erfinv((b + 0.5) * 2^-22 - 1), finite by construction.
__device__ __forceinline__ float normal_from_word(uint32_t word) {
  const float u =
      (static_cast<float>(word >> 9) + 0.5f) * 2.384185791015625e-07f - 1.0f;
  return 1.41421356f * erfinv_f32(u);
}

// One sample's pose: the translation (dx, dy), cos/sin of the rotation and
// the translation in the rotated obstacle's frame, (u1, u2) = R^T (dx, dy).
struct Pose {
  float dx, dy, ct, st, u1, u2;
};

__device__ __forceinline__ Pose sample_pose(unsigned long long idx,
                                            uint32_t uid, uint32_t seed0,
                                            uint32_t seed1, float sigma_x,
                                            float sigma_y, float sigma_th) {
  const Philox4 r = philox4x32_10(static_cast<uint32_t>(idx),
                                  static_cast<uint32_t>(idx >> 32), uid, 0u,
                                  seed0, seed1);
  Pose p;
  p.dx = __fmul_rn(normal_from_word(r.v[0]), sigma_x);
  p.dy = __fmul_rn(normal_from_word(r.v[1]), sigma_y);
  const float th = __fmul_rn(normal_from_word(r.v[2]), sigma_th);
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
