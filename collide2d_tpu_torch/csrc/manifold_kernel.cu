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
// K at run time: the default build carries buckets 4, 8 and 16 for each
// polygon and pads in registers by repeating the last vertex
// (polygon_soa.cuh); a K above 16 pads to the next power of two in a build
// for that one pair of buckets (`POLY_KB1` / `POLY_KB2`), the same body.
// The padding is exact for every face choice: a zero edge has separation
// -inf in the reference max and alignment +inf in the incident min, a
// duplicate vertex moves no minimum, and the real faces keep their order
// and their arithmetic; the incident loop runs over the common bucket
// max(K1, K2), as the Pallas kernel's runs over the common max(K1, K2).
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

#include "polygon_soa.cuh"

namespace {

using collide2d::dot2;
using collide2d::inv_norm;

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

// Clip [w1, w2] to the half-plane pn . x <= off (manifold._clip_segment).
__device__ __forceinline__ void clip_halfplane(float& w1x, float& w1y,
                                               float& w2x, float& w2y,
                                               float pnx, float pny,
                                               float off) {
  const float d1 = __fsub_rn(dot2(w1x, pnx, w1y, pny), off);
  const float d2 = __fsub_rn(dot2(w2x, pnx, w2y, pny), off);
  const float denom = __fsub_rn(d1, d2);
  const float t = fminf(fmaxf(__fdiv_rn(d1, denom == 0.0f ? 1.0f : denom), 0.0f), 1.0f);
  const bool crossing = (d1 > 0.0f) != (d2 > 0.0f);
  const float mx = __fadd_rn(w1x, __fmul_rn(t, __fsub_rn(w2x, w1x)));
  const float my = __fadd_rn(w1y, __fmul_rn(t, __fsub_rn(w2y, w1y)));
  float o1x = (d1 > 0.0f && crossing) ? mx : w1x;
  float o1y = (d1 > 0.0f && crossing) ? my : w1y;
  float o2x = (d2 > 0.0f && crossing) ? mx : w2x;
  float o2y = (d2 > 0.0f && crossing) ? my : w2y;
  if (d1 > 0.0f && d2 > 0.0f) {  // both outside: collapse to the closer one
    const bool use1 = d1 <= d2;
    o1x = o2x = use1 ? w1x : w2x;
    o1y = o2y = use1 ? w1y : w2y;
  }
  w1x = o1x;
  w1y = o1y;
  w2x = o2x;
  w2y = o2y;
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

#if !POLY_KB1
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
#endif

}  // namespace

// Plain C entry point (bound with ctypes). `n` is the number of pairs (8M),
// `k1`/`k2` the vertices of each polygon (>= 1; a pair of buckets the build
// carries, else cudaErrorInvalidValue), `out` 9 planes of n floats. Launches on `stream`, does not synchronise, and returns
// cudaGetLastError() after the launch (0 = ok).
extern "C" int polygon_manifold_launch(const float* p1, const float* p2,
                                       float* out, long long n, int k1, int k2,
                                       float margin, void* stream) {
  if (n <= 0) return static_cast<int>(cudaSuccess);
  const unsigned grid = grid_for(n);
  if (grid == 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  bool ok = false;
#if POLY_KB1
  if (collide2d::build_carries(k1, k2)) {
    polygon_manifold_kernel<POLY_KB1, POLY_KB2><<<grid, kThreads, 0, s>>>(
        p1, p2, out, n, k1, k2, margin);
    ok = true;
  }
#else
  switch (collide2d::k_bucket(k1)) {
    case 4: ok = launch_k2<4>(p1, p2, out, n, k1, k2, margin, grid, s); break;
    case 8: ok = launch_k2<8>(p1, p2, out, n, k1, k2, margin, grid, s); break;
    case 16: ok = launch_k2<16>(p1, p2, out, n, k1, k2, margin, grid, s); break;
    default: ok = false;
  }
#endif
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
