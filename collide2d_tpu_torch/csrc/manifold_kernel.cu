// Contact manifolds of convex k-gon pairs (kernel 10) on Hopper.
//
// Replaces the TPU kernel collide2d_tpu/ops/manifold_pallas.py::
// _make_manifold_kernel (:181; body `_manifold_body` :41). For each pair it
// finds the reference face (the largest face separation over both bodies),
// the incident face (the other body's face most anti-parallel to the
// reference normal), clips the incident edge against the reference face's
// two side planes and keeps the points within `margin` of the face.
// Output is the (9, 8, M) float32 SoA of the Pallas kernel: planes count,
// p0x, p0y, p1x, p1y, d0, d1, nx, ny of n = 8M values, pair p at
// plane[r][p] (ops/manifold_cuda.py unpacks it).
//
// What bounds it on this card. At K = 8 a pair reads 2 x 16 coordinates (128
// bytes) and writes 9 floats (36 bytes): 0.205 ms for 2^22 pairs at 3.35
// TB/s. It does ~1,000 FP32 operations (2 bodies x 8 faces x (a normal, its
// 1/|n|, 8 projections of 3, the min, the winner's selects), 8 incident
// faces x ~12, two clips and the depth filter), 0.06 ms at 67 TFLOP/s, so
// bytes bound it. The design keeps every winner in registers: the
// reference face's normal and endpoints and the incident edge's endpoints
// are carried through the unrolled face loops as select-updated values,
// updated on STRICT improvement only, so the first max and the first min
// win (jnp.argmax / argmin order). No gathers, no shared memory, no
// intermediate in device memory; the 9 stores are coalesced.
//
// K at run time. Up to 16 vertices a polygon (`polygon_manifold_kernel`)
// the build carries buckets 4, 8 and 16 for each polygon and pads in
// registers by repeating the last vertex (polygon_soa.cuh). The padding is
// exact for every face choice: a zero edge has separation -inf in the
// reference max and alignment +inf in the incident min, a duplicate vertex
// moves no minimum, and the real faces keep their order and their
// arithmetic; the incident loop runs over the common bucket max(K1, K2), as
// the Pallas kernel's runs over the common max(K1, K2). Above 16 vertices in
// either polygon (`polygon_manifold_big_k_kernel`): run-time loops over the
// true K1 and K2, the pairs' vertices staged in shared memory and 8 faces a
// vertex walk (polygon_big_k.cuh, with its argument that the outputs are
// the same bits).
//
// Rounding. Products and sums are __fmul_rn / __fadd_rn / __fsub_rn in the
// Pallas body's order, the reference-body bias is the literal
// s1 >= s2 - 1e-6 * max(|s2|, 1), and the unit normal is ax * (1 / sqrt(nn))
// in two IEEE operations (polygon_soa.cuh::inv_norm) where the TPU has
// rsqrt: the plain version (ops/manifold_cuda.py) rounds the same way, so
// the two choose the same faces; against the Pallas kernel values differ by
// ulps and face choices only at exact separation ties. `margin` is a kernel
// argument, not a compile-time constant.
//
// The wrapper allocates the output; the kernel allocates nothing and does
// not synchronise.

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>

#include "polygon_big_k.cuh"
#include "polygon_soa.cuh"

namespace {

using collide2d::dot2;
using collide2d::inv_norm;
using collide2d::big_k::clip_halfplane;

constexpr int kThreads = 256;

struct Face {
  float sep, nx, ny, ax, ay, bx, by;  // separation, unit normal, endpoints
};

// The max-separation face of (xs, ys) against the other body's vertices,
// carried as select-updated values (strict: the first max wins).
template <int K, int KO>
__device__ __forceinline__ Face best_face(const float (&xs)[K],
                                          const float (&ys)[K],
                                          const float (&oxs)[KO],
                                          const float (&oys)[KO]) {
  Face f{-INFINITY, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
  for (int i = 0; i < K; ++i) {
    const int j = (i + 1) % K;
    const float ax = __fsub_rn(ys[j], ys[i]);  // outward normal of edge i -> j
    const float ay = __fsub_rn(xs[i], xs[j]);
    const float nn = dot2(ax, ax, ay, ay);
    const float r = inv_norm(nn > 0.0f ? nn : 1.0f);
    const float ux = __fmul_rn(ax, r);
    const float uy = __fmul_rn(ay, r);
    const float off = dot2(ux, xs[i], uy, ys[i]);
    float m = dot2(ux, oxs[0], uy, oys[0]);
#pragma unroll
    for (int v = 1; v < KO; ++v) m = fminf(m, dot2(ux, oxs[v], uy, oys[v]));
    const float s = nn > 0.0f ? __fsub_rn(m, off) : -INFINITY;
    if (s > f.sep) f = Face{s, ux, uy, xs[i], ys[i], xs[j], ys[j]};
  }
  return f;
}

template <int K1, int K2>
__global__ void __launch_bounds__(kThreads)
    polygon_manifold_kernel(const float* __restrict__ p1,
                            const float* __restrict__ p2,
                            float* __restrict__ out, long long n, int k1,
                            int k2, float margin) {
  const long long p = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (p >= n) return;
  float x1[K1], y1[K1], x2[K2], y2[K2];
  collide2d::load_polygon<K1>(p1, n, p, k1, x1, y1);
  collide2d::load_polygon<K2>(p2, n, p, k2, x2, y2);

  const Face f1 = best_face<K1, K2>(x1, y1, x2, y2);
  const Face f2 = best_face<K2, K1>(x2, y2, x1, y1);
  // Reference body: small relative bias toward body 1 (the JAX expression).
  const bool ref1 =
      f1.sep >= __fsub_rn(f2.sep, __fmul_rn(1e-6f, fmaxf(fabsf(f2.sep), 1.0f)));
  const Face f = ref1 ? f1 : f2;  // a copy: selects, not a stack slot
  const float best_sep = f.sep;
  const float nx = f.nx, ny = f.ny;

  // Incident face over the common K: the most anti-parallel valid face of
  // the other body (zero edges at +inf; strict: the first min wins).
  constexpr int K = K1 > K2 ? K1 : K2;
  float best_a = INFINITY;
  float v1x = 0.0f, v1y = 0.0f, v2x = 0.0f, v2y = 0.0f;
#pragma unroll
  for (int j = 0; j < K; ++j) {
    const int jn = (j + 1) % K;
    const float ixj = ref1 ? x2[j < K2 ? j : K2 - 1] : x1[j < K1 ? j : K1 - 1];
    const float iyj = ref1 ? y2[j < K2 ? j : K2 - 1] : y1[j < K1 ? j : K1 - 1];
    const float ixn = ref1 ? x2[jn < K2 ? jn : K2 - 1] : x1[jn < K1 ? jn : K1 - 1];
    const float iyn = ref1 ? y2[jn < K2 ? jn : K2 - 1] : y1[jn < K1 ? jn : K1 - 1];
    const float ax = __fsub_rn(iyn, iyj);
    const float ay = __fsub_rn(ixj, ixn);
    const float nn = dot2(ax, ax, ay, ay);
    const float r = inv_norm(nn > 0.0f ? nn : 1.0f);
    const float align = nn > 0.0f ? __fmul_rn(dot2(ax, nx, ay, ny), r) : INFINITY;
    if (align < best_a) {
      best_a = align;
      v1x = ixj;
      v1y = iyj;
      v2x = ixn;
      v2y = iyn;
    }
  }

  // Side-plane clips against the reference face's tangent.
  const float tx = -ny, ty = nx;
  clip_halfplane(v1x, v1y, v2x, v2y, -tx, -ty, -dot2(tx, f.ax, ty, f.ay));
  clip_halfplane(v1x, v1y, v2x, v2y, tx, ty, dot2(tx, f.bx, ty, f.by));

  const float off = dot2(nx, f.ax, ny, f.ay);
  const float d1 = __fsub_rn(off, dot2(nx, v1x, ny, v1y));
  const float d2 = __fsub_rn(off, dot2(nx, v2x, ny, v2y));
  const bool pair_ok = best_sep <= margin && best_sep > -INFINITY;
  const bool keep1 = d1 >= -margin && pair_ok;
  const bool keep2 = d2 >= -margin && pair_ok;
  const bool swap = !keep1 && keep2;
  out[p] = static_cast<float>(keep1) + static_cast<float>(keep2);
  out[n + p] = swap ? v2x : v1x;
  out[2 * n + p] = swap ? v2y : v1y;
  out[3 * n + p] = swap ? v1x : v2x;
  out[4 * n + p] = swap ? v1y : v2y;
  out[5 * n + p] = swap ? d2 : d1;
  out[6 * n + p] = swap ? d1 : d2;
  out[7 * n + p] = ref1 ? nx : -nx;
  out[8 * n + p] = ref1 ? ny : -ny;
}

unsigned grid_for(long long n) {
  const long long blocks = (n + kThreads - 1) / kThreads;
  return blocks > INT_MAX ? 0u : static_cast<unsigned>(blocks);
}

template <int K1>
bool launch_k2(const float* p1, const float* p2, float* out, long long n,
               int k1, int k2, float margin, unsigned grid, cudaStream_t s) {
  switch (collide2d::k_bucket(k2)) {
    case 4: polygon_manifold_kernel<K1, 4><<<grid, kThreads, 0, s>>>(p1, p2, out, n, k1, k2, margin); return true;
    case 8: polygon_manifold_kernel<K1, 8><<<grid, kThreads, 0, s>>>(p1, p2, out, n, k1, k2, margin); return true;
    case 16: polygon_manifold_kernel<K1, 16><<<grid, kThreads, 0, s>>>(p1, p2, out, n, k1, k2, margin); return true;
    default: return false;
  }
}

// Above 16 vertices: one pair a thread at the true K1 and K2, a block's P
// pairs staged in shared memory, or (P == 0) read in device memory where a
// 32-pair tile does not fit (polygon_big_k.cuh).
template <int P>
__global__ void __launch_bounds__(collide2d::big_k::kMaxPairs)
    polygon_manifold_big_k_kernel(const float* __restrict__ p1,
                                  const float* __restrict__ p2,
                                  float* __restrict__ out, long long n, int k1,
                                  int k2, float margin, bool vec) {
  using collide2d::big_k::Polygon;
  const long long p = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  float r[9];
  if constexpr (P > 0) {
    const float* tile = collide2d::big_k::stage_pairs<P>(p1, p2, n, k1, k2, p - threadIdx.x,
                                                         vec);
    if (p >= n) return;
    collide2d::big_k::manifold(Polygon<float, P>{tile + threadIdx.x, 0, k1},
                               Polygon<float, P>{tile + 2 * k1 * P + threadIdx.x, 0, k2},
                               margin, r);
  } else {
    if (p >= n) return;
    collide2d::big_k::manifold(Polygon<float, 0>{p1 + p, n, k1},
                               Polygon<float, 0>{p2 + p, n, k2}, margin, r);
  }
#pragma unroll
  for (int c = 0; c < 9; ++c) out[c * n + p] = r[c];
}

cudaError_t launch_big_k(const float* p1, const float* p2, float* out, long long n,
                         int k1, int k2, float margin, cudaStream_t s) {
  namespace big_k = collide2d::big_k;
  const bool vec = big_k::planes_aligned(p1, p2, n);
  return big_k::launch_tiled(n, k1, k2, sizeof(float), [&](auto tile, unsigned grid,
                                                           size_t bytes) {
    constexpr int P = decltype(tile)::value;
    const cudaError_t err = big_k::allow_tile(polygon_manifold_big_k_kernel<P>, bytes);
    if (err != cudaSuccess) return err;
    polygon_manifold_big_k_kernel<P><<<grid, P > 0 ? P : big_k::kMaxPairs, bytes, s>>>(
        p1, p2, out, n, k1, k2, margin, P > 0 && vec);
    return cudaSuccess;
  });
}

}  // namespace

// Plain C entry point (bound with ctypes). `n` is the number of pairs (8M),
// `k1`/`k2` the vertices of each polygon (>= 1; any K: above 16 in either
// polygon the run-time-K body), `out` 9 planes of n floats. Launches on
// `stream`, does not synchronise, and returns cudaGetLastError() after the
// launch (0 = ok).
extern "C" int polygon_manifold_launch(const float* p1, const float* p2,
                                       float* out, long long n, int k1, int k2,
                                       float margin, void* stream) {
  if (n <= 0) return static_cast<int>(cudaSuccess);
  if (k1 < 1 || k2 < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (k1 > 16 || k2 > 16) {
    const cudaError_t err = launch_big_k(p1, p2, out, n, k1, k2, margin, s);
    if (err != cudaSuccess) return static_cast<int>(err);
    return static_cast<int>(cudaGetLastError());
  }
  const unsigned grid = grid_for(n);
  if (grid == 0) return static_cast<int>(cudaErrorInvalidValue);
  bool ok = false;
  switch (collide2d::k_bucket(k1)) {
    case 4: ok = launch_k2<4>(p1, p2, out, n, k1, k2, margin, grid, s); break;
    case 8: ok = launch_k2<8>(p1, p2, out, n, k1, k2, margin, grid, s); break;
    case 16: ok = launch_k2<16>(p1, p2, out, n, k1, k2, margin, grid, s); break;
    default: ok = false;
  }
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
