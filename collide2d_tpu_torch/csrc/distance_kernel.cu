// Signed distances of oriented-box pairs (kernel 8) and convex k-gon pairs
// (kernel 9) on Hopper.
//
// Replaces the TPU kernels of collide2d_tpu/ops/distance_pallas.py:
//   obb_distance      <- _distance_kernel (:125; body :113, tile :58)
//   polygon_distance  <- _make_polygon_distance_kernel (:229; body :164)
// Positive = separation distance, negative = -(penetration depth).
//
// Layout. A thread takes a pair and reads plane[c][p] of n = 8M contiguous
// values per plane, so neighbouring pairs' loads are coalesced without
// repacking:
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
// Kernel 9 (polygon_distance.cuh) writes `gap < 0 ? gap : sqrt(d2)`:
// `gap` the largest support gap over the K1 + K2 true edge normals (2 (K1 +
// K2) projections of 3 operations and their min/max an axis, scaled by
// 1 / |normal|), `d2` the smallest of the 2 K1 K2 point-segment tests. All
// of it is 3,714 FP32 operations a pair at K = 8 against 132 bytes: bound
// by operations (0.233 ms for 2^22 pairs at 67 TFLOP/s). The output reads
// `gap` only on overlapping pairs and `d2` only on separated ones, and a
// per-lane or warp-vote exit cannot keep that saving (at 5.8% overlap 85%
// of warps hold an overlapping lane), so a block splits its 256 pairs
// exactly, with lists of them in shared memory:
//   1. a pair a thread: polygon 1's edge normals every K1 / 4-th edge,
//      unscaled (`edge_separates`, exact in float); a pair one of them
//      separates joins the `separated` list, the others `undecided`;
//   2. after the block's barrier, both lists packed onto the block's
//      lanes, the undecided pairs first: every axis (`support_gap`), an
//      overlapping pair writing its gap, the others going on to
//   3. every vertex against every segment (`separation_d2`) and sqrt,
//      which a separated pair starts with.
// Pass 2 reloads a pair's vertices (L1 or L2: the tile was just read). So
// a separated pair pays 4 axes and the tests, an overlapping one 4 + K1 +
// K2 axes, one that only every axis shows separated both, and a warp
// idles only where the lists meet. On the bench's 8-gons (5.8% overlap,
// 98.65% of the separated pairs settled in pass 1) that is ~2,250 of the
// 3,714 operations a pair. At 2^22 k = 8 pairs on an NVIDIA H100 80GB
// HBM3 this ran 0.532-0.535 ms (one pair a thread before: 0.689-0.693);
// in the same turns against the same parent, a barrier between the two
// lists 0.553-0.562, the separated pairs' tests in place in pass 1 (the
// listed lanes idle, no reload) 0.646-0.689, and this design at 3 blocks
// an SM (80 registers) 0.593-0.594: occupancy moves the time more than
// the instructions do (utils/query_ab.py; PERF.md section 6). A
// point-segment test clamps its parameter with one saturating multiply
// (14 operations, was 17). K is a run-time value: the default build
// carries buckets 4, 8 and 16 for each polygon and pads in registers
// (polygon_soa.cuh); a K above 16 pads to the next power of two in a build
// for that one pair of buckets (`POLY_KB1` / `POLY_KB2`), the same body.
// The padding is exact for the sign: a zero edge is masked to -inf in the
// gap max and a duplicate vertex adds no projection; it can move the
// separation distance by rounding (a zero-length segment's point distance
// against the closing edge's clamped one), so the plain version pads to
// the same bucket. With
// -DPOLYDIST_COUNT=1 the library also counts the pairs through every axis
// and through the segment tests (polygon_distance_counts); the default
// build does not.
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
#include "polygon_distance.cuh"
#include "polygon_soa.cuh"

#ifndef POLYDIST_COUNT
#define POLYDIST_COUNT 0
#endif

namespace {

namespace polydist = collide2d::polydist;

constexpr int kThreads = 256;
// Blocks of kernel 9 an SM, by the pair's vertex slots: 4 (at most 64
// registers a thread) up to K1 + K2 = 16, where 3 ran 11% slower at
// k = 8 and 9% at 4 against 8; the larger shapes keep the registers that
// one pair a thread took before (128 at 16 + 8, 188 at 16 + 16).
template <int K1, int K2>
constexpr int kMinBlocks = K1 + K2 <= 16 ? 4 : K1 + K2 <= 24 ? 2 : 1;

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

#if POLYDIST_COUNT
// Pairs through the full axes and through the segment tests, since the
// last read (polygon_distance_counts).
__device__ unsigned long long g_counts[2] = {0, 0};
#endif

// Appends `item` to `list` where `take` holds, warp by warp (one shared
// atomicAdd a warp); lanes of a warp that reach it together.
__device__ __forceinline__ void append(bool take, int item, int* list,
                                       int* count) {
  const unsigned active = __activemask();
  const unsigned mask = __ballot_sync(active, take);
  const int leader = __ffs(active) - 1;
  int base = 0;
  if ((threadIdx.x & 31) == leader && mask != 0u) base = atomicAdd(count, __popc(mask));
  base = __shfl_sync(active, base, leader);
  if (take) list[base + __popc(mask & ((1u << (threadIdx.x & 31)) - 1u))] = item;
}

// Vertices of pair p (polygon_soa.cuh::load_polygon): a polygon that fills
// its bucket (k == K, warp-uniform) loads every plane straight, without the
// padding's per-slot tests.
template <int K>
__device__ __forceinline__ void load_vertices(const float* __restrict__ src,
                                              long long n, long long p, int k,
                                              float (&x)[K], float (&y)[K]) {
  if (k == K) {
    const float* __restrict__ q = src + p;
#pragma unroll
    for (int i = 0; i < K; ++i) {
      x[i] = q[i * n];
      y[i] = q[(K + i) * n];
    }
  } else {
    collide2d::load_polygon<K>(src, n, p, k, x, y);
  }
}

template <int K1, int K2>
__global__ void __launch_bounds__(kThreads, kMinBlocks<K1, K2>)
    polygon_distance_kernel(const float* __restrict__ p1,
                            const float* __restrict__ p2,
                            float* __restrict__ out, long long n, int k1,
                            int k2) {
  __shared__ int separated[kThreads];  // the tile's pairs that need d2 alone
  __shared__ int undecided[kThreads];  // and those that need every axis
  __shared__ int counts[2];
  const long long base = static_cast<long long>(blockIdx.x) * kThreads;
  if (threadIdx.x < 2) counts[threadIdx.x] = 0;
  __syncthreads();
  // Pass 1, a pair a thread: polygon 1's first edge normals.
  {
    const long long p = base + threadIdx.x;
    if (p < n) {
      float x1[K1], y1[K1], x2[K2], y2[K2];
      load_vertices<K1>(p1, n, p, k1, x1, y1);
      load_vertices<K2>(p2, n, p, k2, x2, y2);
      const bool sep = polydist::edge_separates<K1, K2>(x1, y1, x2, y2);
      append(sep, threadIdx.x, separated, &counts[0]);
      append(!sep, threadIdx.x, undecided, &counts[1]);
    }
  }
  __syncthreads();
  // Passes 2 and 3 over both lists, packed onto the block's lanes, the
  // undecided pairs first: every axis, then (an overlapping pair writes its
  // gap) every segment test, which a separated pair starts with.
  const int n_undecided = counts[1];
  const int n_listed = n_undecided + counts[0];
  for (int i = threadIdx.x; i < n_listed; i += kThreads) {
    const bool decided = i >= n_undecided;
    const long long p = base + (decided ? separated[i - n_undecided] : undecided[i]);
    float x1[K1], y1[K1], x2[K2], y2[K2];
    load_vertices<K1>(p1, n, p, k1, x1, y1);
    load_vertices<K2>(p2, n, p, k2, x2, y2);
    if (!decided) {
      const float gap = polydist::support_gap<K1, K2>(x1, y1, x2, y2);
      if (gap < 0.0f) {
        out[p] = gap;
        continue;
      }
#if POLYDIST_COUNT
      atomicAdd(&g_counts[1], 1ull);
#endif
    }
    out[p] = sqrtf(polydist::separation_d2<K1, K2>(x1, y1, x2, y2));
  }
#if POLYDIST_COUNT
  if (threadIdx.x == 0) {
    atomicAdd(&g_counts[0], static_cast<unsigned long long>(n_undecided));
    atomicAdd(&g_counts[1], static_cast<unsigned long long>(n_listed - n_undecided));
  }
#endif
}

// Blocks of `per_block` pairs for n pairs, or 0 when n does not fit one
// grid dimension.
unsigned grid_for(long long n, long long per_block) {
  const long long blocks = (n + per_block - 1) / per_block;
  return blocks > INT_MAX ? 0u : static_cast<unsigned>(blocks);
}

#if !POLY_KB1
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
#endif

}  // namespace

// Plain C entry points (bound with ctypes). `n` is the number of pairs
// (8M); each launches on `stream`, does not synchronise, and returns
// cudaGetLastError() after the launch (0 = ok).

extern "C" int obb_distance_launch(const float* b1, const float* b2,
                                   float* out, long long n, float shift,
                                   void* stream) {
  if (n <= 0) return static_cast<int>(cudaSuccess);
  const unsigned grid = grid_for(n, kThreads);
  if (grid == 0) return static_cast<int>(cudaErrorInvalidValue);
  obb_distance_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      b1, b2, out, n, shift);
  return static_cast<int>(cudaGetLastError());
}

// `k1`/`k2`: the vertices of each polygon (>= 1; a pair of buckets the
// build carries, else cudaErrorInvalidValue).
extern "C" int polygon_distance_launch(const float* p1, const float* p2,
                                       float* out, long long n, int k1, int k2,
                                       void* stream) {
  if (n <= 0) return static_cast<int>(cudaSuccess);
  const unsigned grid = grid_for(n, kThreads);
  if (grid == 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  bool ok = false;
#if POLY_KB1
  if (collide2d::build_carries(k1, k2)) {
    polygon_distance_kernel<POLY_KB1, POLY_KB2><<<grid, kThreads, 0, s>>>(p1, p2, out, n, k1, k2);
    ok = true;
  }
#else
  switch (collide2d::k_bucket(k1)) {
    case 4: ok = launch_k2<4>(p1, p2, out, n, k1, k2, grid, s); break;
    case 8: ok = launch_k2<8>(p1, p2, out, n, k1, k2, grid, s); break;
    case 16: ok = launch_k2<16>(p1, p2, out, n, k1, k2, grid, s); break;
    default: ok = false;
  }
#endif
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

#if POLYDIST_COUNT
// The pairs kernel 9 took through every axis (out[0]) and through the
// segment tests (out[1]) since the last call (synchronises).
extern "C" int polygon_distance_counts(unsigned long long* out) {
  const unsigned long long zero[2] = {0, 0};
  cudaError_t err = cudaMemcpyFromSymbol(out, g_counts, sizeof(zero));
  if (err == cudaSuccess) err = cudaMemcpyToSymbol(g_counts, zero, sizeof(zero));
  return static_cast<int>(err);
}
#endif
