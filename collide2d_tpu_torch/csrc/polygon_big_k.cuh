// Kernels 6, 9 and 10 on pairs in which either polygon has more than 16
// vertices: run-time loops over the true K, one library for every K.
//
// The K <= 16 bodies (polygon_kernel.cu, distance_kernel.cu,
// manifold_kernel.cu) hold every vertex in registers, unrolled over the K
// bucket. Above 16 that does not fit the card: at (32, 32) kernel 6's body
// is some 20,000 instructions, far past the SM's instruction caches; the
// vertices take 168-255 registers a thread and spill at (4, 64); a 17-gon
// pays for 32. Here instead:
//
// - One pair a thread, its vertices staged in shared memory. A block takes P
//   pairs and copies the 2 (k1 + k2) coordinate planes of its P columns from
//   the `pack_polygons` SoA into a [plane][pair] tile (`stage`: cp.async, 16
//   bytes a thread, each plane's P columns one contiguous run), then one
//   barrier. Thread t reads column t, so every read is free of bank
//   conflicts. The tile keeps the input type: bf16 planes (kernel 6) are
//   upcast exactly on the read. P comes from (k1, k2) (`tile_pairs`) and is
//   a template argument, so every load is a constant offset; past what a
//   32-pair tile holds, the same body reads the planes in device memory
//   through the same view (`Polygon`).
// - Run-time loops over the true K: axes, faces and segments i -> (i + 1) %
//   k and projections over the k real vertices, never over a bucket.
// - Register blocking, so shared memory stays off the critical path: kernel
//   6 takes `kAxes` consecutive edges of one polygon at once (kernel 9
//   `kGapAxes`; their normals from the kAxes + 1 vertices they span) and
//   walks the k1 + k2 vertices once for them, two vertices an iteration
//   (four loads feed 2 kAxes x 5 instructions: 2 __fmul_rn, __fadd_rn,
//   fminf, fmaxf); kernel 10 takes `kFaces` faces at once (a face's normal,
//   1 / |n| and offset once, then 4 instructions a vertex of the other
//   polygon); kernel 9 takes `kSegments` segments of one polygon at once
//   (edge, 1 / |e|^2 and start vertex once, then the 14-instruction
//   point-segment test a vertex of the other). The edges left over run in
//   blocks of half the size, down to one, so none is evaluated twice.
// - Kernels 6 and 9 in two passes: first 8 edge normals spread around both
//   polygons for every pair, which separate most of the pairs that any axis
//   separates (phase 24 of chip_smoke.py prints the pairs left,
//   `kernel6_undecided`, `kernel9_undecided`); the pairs are listed in
//   shared memory and the rest of the work runs packed onto the block's
//   first lanes, so a warp runs the full test only for pairs that need it.
//   Kernel 9 lists both kinds, the undecided first: an undecided pair takes
//   every axis and writes its gap where it overlaps, then (as a pair the
//   first pass separated starts) every point-segment test.
//
// Measured in turns against this design's variants (utils/query_ab.py on
// phase 24's cases, NVIDIA H100 80GB HBM3, 700 W; PERF.md section 6, PR
// 17): the one-pass design on a grid of the blocks the card holds at once
// was 1.03-1.28x slower in kernel 6 f32, 1.36-1.68x in bf16 and 1.03-1.15x
// in kernel 10; asking L2 for a block's next tile there was up to 7%
// slower again.
//
// Neither TMA nor the tensor cores help here. The kernels are bound by the
// instructions they issue: the copy is under 5% of them, and cp.async does
// it without registers. Each projection must round both products and the
// sum on their own, which an MMA does not, and `wgmma` takes no FP32
// inputs.
//
// Bitwise equality with the padded bodies and the plain versions:
// - kernel 6: fminf / fmaxf are exact, and a vertex's interval is folded
//   in the same order (0 .. k-1), so the duplicate vertices of the padding
//   moved no interval; the zero axes of the padding never separate ([0, 0]
//   on both bodies); the OR over the axes does not depend on their order;
// - kernel 10: the real faces keep their order (0 .. k-2, then the closing
//   face k-1 -> 0, as in the padded loop, whose zero faces sat at -inf in
//   the reference max and +inf in the incident min and never won under the
//   strict `>` / `<`); the blocks of faces fold into the running winner in
//   face order with strict `>`, so the first max still wins; the incident
//   loop runs over the incident body's faces, which are the real faces of
//   the padded loop over the common max(k1, k2), in the same order;
// - kernels 6's and 9's two passes test every axis of a pair the first does
//   not settle (kernel 6's second skips only a polygon of at most 4
//   vertices, whose edges were all in the first), so the label is the OR
//   over all of them and kernel 9's gap the max over all of them;
// - kernel 9 (polygon_distance.cuh): its output reads a max or a min over a
//   set, so the order is free; the padding's zero axes sit at -inf and its
//   duplicate vertices move no interval, but its zero-length segments at
//   q_{k-1} give the point distance of each vertex of the other polygon to
//   q_{k-1}, which the real segments at q_{k-1} can miss by rounding (one
//   clamps its parameter at 1 after other subtractions, the other takes a
//   parameter just above 0 and can round a coordinate away): where k is
//   below its bucket (`k_bucket`), the body takes that point distance too
//   (`pad1`, `pad2`), and the plain version, which pads, stays the
//   definition;
// - every product and sum stays explicitly rounded (`dot2`, __fsub_rn,
//   __fmul_rn, `inv_norm`), and comparisons combine with `&` and `|`.
//
// The header compiles with g++ for the host test
// (tests/test_torch_polygon_big_k_body.py) given stubs of __device__,
// __forceinline__ and the rounded intrinsics; the staging code is CUDA only.

#pragma once

#include <math.h>

#include "polygon_distance.cuh"
#include "polygon_soa.cuh"

namespace collide2d {
namespace big_k {

// Axes of kernel 6, faces of kernel 10, and axes and segments of kernel 9,
// a vertex walk serves. In turns on phase 24's cases (utils/query_ab.py
// against a copy with the constant edited; NVIDIA H100 80GB HBM3, 700 W):
// 16 axes or faces, kernel 6 f32 5-6% faster at (4, 64) and (32, 32) but 9%
// slower at (20, 20), bf16 5-26% slower everywhere, kernel 10 5% faster at
// (32, 32), 15-21% slower at (4, 17) to (4, 32). Kernel 9: 4 segments
// against 8, 0.5-19% faster at (4, 17), (4, 20), (4, 32), (4, 64) and (20,
// 20), 3% slower at (32, 32), the same 80 registers (16: 127 registers,
// 4-15% slower in five of the six); then 4 axes against 8, 5-16% faster at
// (4, 17), (4, 20), (4, 32) and (20, 20), 4% slower at (4, 64) and (32,
// 32). Where k is not a multiple of the block, the walk's remainder blocks
// also run, more code in flight. The k = 20 routes take (4, 20) and (20,
// 20).
constexpr int kAxes = 8;
constexpr int kFaces = 8;
constexpr int kGapAxes = 4;
constexpr int kSegments = 4;
// Pairs a block (and threads a block) at most, and the tile rule: the
// largest P of 128, 64 and 32 whose tile leaves room for three blocks an SM
// (3 x (tile + kernel 6's list of P pairs + 1 KB reserved) <= 228 KB),
// else 32 while a tile fits the 227 KB a block may hold less 1 KB for the
// lists (kernel 9's two take 2 P + 2 ints), else no tile.
constexpr int kMaxPairs = 128;
constexpr int kMinPairs = 32;
constexpr long long kTileBytes = 75776;
constexpr long long kMaxTileBytes = 231424;

// The pairs a block stages at (k1, k2) with `elem_bytes`-byte coordinates,
// or 0: the body reads the planes in device memory
// (ops/polygon_cuda.py::tile_pairs).
inline int tile_pairs(int k1, int k2, int elem_bytes) {
  const long long column = 2LL * (k1 + k2) * elem_bytes;
  for (int p = kMaxPairs; p > kMinPairs; p /= 2)
    if (column * p <= kTileBytes) return p;
  return column * kMinPairs <= kMaxTileBytes ? kMinPairs : 0;
}

__device__ __forceinline__ float to_f32(float v) { return v; }
template <typename B>
__device__ __forceinline__ float to_f32(B v) {
  return __bfloat162float(v);
}

// One polygon of one pair: vertex i at p[i * stride] (x) and
// p[(k + i) * stride] (y). In a tile the stride is the compile-time P, so
// every load is a constant offset from a pointer; in device memory (P == 0)
// it is n.
template <typename T, int P>
struct Polygon {
  const T* p;
  long long n;  // the stride where P == 0
  int k;
  __device__ __forceinline__ const T* at(int i) const {
    if constexpr (P > 0) {
      return p + i * P;
    } else {
      return p + i * n;
    }
  }
  __device__ __forceinline__ float x(int i) const { return to_f32(*at(i)); }
  __device__ __forceinline__ float y(int i) const { return to_f32(*at(k + i)); }
};

// b's vertices i0 .. i0 + A - 1 and the one after them (vertex (i0 + A) % k).
template <int A, class V>
__device__ __forceinline__ void span(const V& b, int i0, float (&xs)[A + 1],
                                     float (&ys)[A + 1]) {
#pragma unroll
  for (int u = 0; u < A; ++u) {
    xs[u] = b.x(i0 + u);
    ys[u] = b.y(i0 + u);
  }
  const int last = i0 + A == b.k ? 0 : i0 + A;
  xs[A] = b.x(last);
  ys[A] = b.y(last);
}

// The true normals (ey, -ex) of b's edges i0 .. i0 + A - 1 (edge i: vertex
// i -> (i + 1) % k), from the A + 1 vertices they span.
template <int A, class V>
__device__ __forceinline__ void edge_normals(const V& b, int i0, float (&ax)[A],
                                             float (&ay)[A]) {
  float xs[A + 1], ys[A + 1];
  span<A>(b, i0, xs, ys);
#pragma unroll
  for (int u = 0; u < A; ++u) {
    ax[u] = __fsub_rn(ys[u + 1], ys[u]);
    ay[u] = __fsub_rn(xs[u], xs[u + 1]);
  }
}

// ---- kernel 6: SAT over the true edge normals ----

// Fold vertex (x, y)'s projections onto A axes into [mn, mx].
template <int A>
__device__ __forceinline__ void fold(const float (&ax)[A], const float (&ay)[A], float x,
                                     float y, float (&mn)[A], float (&mx)[A]) {
#pragma unroll
  for (int u = 0; u < A; ++u) {
    const float q = dot2(ax[u], x, ay[u], y);
    mn[u] = fminf(mn[u], q);
    mx[u] = fmaxf(mx[u], q);
  }
}

// [mn, mx] of b's projections onto A axes, vertices folded in order, two a
// loop iteration.
template <int A, class V>
__device__ __forceinline__ void intervals(const V& b, const float (&ax)[A],
                                          const float (&ay)[A], float (&mn)[A],
                                          float (&mx)[A]) {
  const float x0 = b.x(0), y0 = b.y(0);
#pragma unroll
  for (int u = 0; u < A; ++u) mn[u] = mx[u] = dot2(ax[u], x0, ay[u], y0);
  int v = 1;
#pragma unroll 1
  for (; v + 2 <= b.k; v += 2) {
    const float xa = b.x(v), ya = b.y(v), xb = b.x(v + 1), yb = b.y(v + 1);
    fold(ax, ay, xa, ya, mn, mx);
    fold(ax, ay, xb, yb, mn, mx);
  }
  if (v < b.k) fold(ax, ay, b.x(v), b.y(v), mn, mx);
}

// Whether one of e's edge normals i0 .. i0 + A - 1 separates b1 and b2.
template <int A, class V>
__device__ __forceinline__ bool axes_separate(const V& e, int i0, const V& b1,
                                              const V& b2) {
  float ax[A], ay[A];
  edge_normals(e, i0, ax, ay);
  float mn1[A], mx1[A], mn2[A], mx2[A];
  intervals<A>(b1, ax, ay, mn1, mx1);
  intervals<A>(b2, ax, ay, mn2, mx2);
  bool sep = false;
#pragma unroll
  for (int u = 0; u < A; ++u) sep = sep | (mx1[u] < mn2[u]) | (mx2[u] < mn1[u]);
  return sep;
}

// e's edge normals i0 .. k-1 in blocks of A, the rest in blocks of A / 2,
// ... 1.
template <int A, class V>
__device__ __forceinline__ bool edges_separate(const V& e, int i0, const V& b1,
                                               const V& b2) {
  bool sep = false;
#pragma unroll 1
  for (; i0 + A <= e.k; i0 += A) sep = sep | axes_separate<A>(e, i0, b1, b2);
  if constexpr (A > 1) sep = sep | edges_separate<A / 2>(e, i0, b1, b2);
  return sep;
}

// The first pass's 8 edge normals spread around both polygons (polygon 1's
// edges u k1 / 4 and polygon 2's u k2 / 4, u < 4), and both polygons'
// intervals on them.
template <class V>
__device__ __forceinline__ void spread_intervals(const V& b1, const V& b2, float (&ax)[8],
                                                 float (&ay)[8], float (&mn1)[8],
                                                 float (&mx1)[8], float (&mn2)[8],
                                                 float (&mx2)[8]) {
#pragma unroll
  for (int u = 0; u < 8; ++u) {
    const V& e = u < 4 ? b1 : b2;
    const int i = (u % 4) * e.k / 4;
    const int j = i + 1 == e.k ? 0 : i + 1;
    ax[u] = __fsub_rn(e.y(j), e.y(i));
    ay[u] = __fsub_rn(e.x(i), e.x(j));
  }
  intervals<8>(b1, ax, ay, mn1, mx1);
  intervals<8>(b2, ax, ay, mn2, mx2);
}

// Kernel 6's first pass: whether one of the 8 spread edge normals
// separates the pair.
template <class V>
__device__ __forceinline__ bool spread_axes_separate(const V& b1, const V& b2) {
  float ax[8], ay[8], mn1[8], mx1[8], mn2[8], mx2[8];
  spread_intervals(b1, b2, ax, ay, mn1, mx1, mn2, mx2);
  bool sep = false;
#pragma unroll
  for (int u = 0; u < 8; ++u) sep = sep | (mx1[u] < mn2[u]) | (mx2[u] < mn1[u]);
  return sep;
}

// Kernel 6's second pass, for a pair the first did not separate: every
// edge normal of each polygon with more than 4 vertices (a polygon of at
// most 4 had each of its edges in the first pass).
template <class V>
__device__ __forceinline__ bool rest_separate(const V& b1, const V& b2) {
  bool sep = false;
  if (b1.k > 4) sep = sep | edges_separate<kAxes>(b1, 0, b1, b2);
  if (b2.k > 4) sep = sep | edges_separate<kAxes>(b2, 0, b1, b2);
  return sep;
}

// Kernel 6's label: 1 when the pair collides, 0 when an edge normal of
// either polygon separates it (strict `<`: touching polygons collide).
template <class V>
__device__ __forceinline__ float sat_label(const V& b1, const V& b2) {
  return spread_axes_separate(b1, b2) || rest_separate(b1, b2) ? 0.0f : 1.0f;
}

// ---- kernel 10: contact manifolds ----

// The running reference face: separation, unit normal, index (-1: none).
struct Face {
  float sep, nx, ny;
  int i;
};

// Fold vertex (x, y)'s projections onto F unit normals into their minima.
template <int F>
__device__ __forceinline__ void fold_min(const float (&ux)[F], const float (&uy)[F],
                                         float x, float y, float (&m)[F]) {
#pragma unroll
  for (int u = 0; u < F; ++u) m[u] = fminf(m[u], dot2(ux[u], x, uy[u], y));
}

// Faces f0 .. f0 + F - 1 of b against the vertices of o, folded into `best`
// in face order (strict `>`: the first max wins).
template <int F, class V>
__device__ __forceinline__ void face_block(const V& b, const V& o, int f0, Face& best) {
  float ax[F], ay[F], ux[F], uy[F], off[F], m[F];
  bool ok[F];
  edge_normals(b, f0, ax, ay);  // outward normals of edges i -> i + 1
#pragma unroll
  for (int u = 0; u < F; ++u) {
    const float nn = dot2(ax[u], ax[u], ay[u], ay[u]);
    const float r = inv_norm(nn > 0.0f ? nn : 1.0f);
    ux[u] = __fmul_rn(ax[u], r);
    uy[u] = __fmul_rn(ay[u], r);
    off[u] = dot2(ux[u], b.x(f0 + u), uy[u], b.y(f0 + u));
    ok[u] = nn > 0.0f;
  }
  const float x0 = o.x(0), y0 = o.y(0);
#pragma unroll
  for (int u = 0; u < F; ++u) m[u] = dot2(ux[u], x0, uy[u], y0);
  int v = 1;
#pragma unroll 1
  for (; v + 2 <= o.k; v += 2) {
    const float xa = o.x(v), ya = o.y(v), xb = o.x(v + 1), yb = o.y(v + 1);
    fold_min(ux, uy, xa, ya, m);
    fold_min(ux, uy, xb, yb, m);
  }
  if (v < o.k) fold_min(ux, uy, o.x(v), o.y(v), m);
#pragma unroll
  for (int u = 0; u < F; ++u) {
    const float s = ok[u] ? __fsub_rn(m[u], off[u]) : -INFINITY;
    if (s > best.sep) best = Face{s, ux[u], uy[u], f0 + u};
  }
}

// The max-separation face of b against o: faces f0 .. k-1 in blocks of F,
// the rest in blocks of F / 2, ... 1.
template <int F, class V>
__device__ __forceinline__ void best_face_from(const V& b, const V& o, int f0, Face& best) {
#pragma unroll 1
  for (; f0 + F <= b.k; f0 += F) face_block<F>(b, o, f0, best);
  if constexpr (F > 1) best_face_from<F / 2>(b, o, f0, best);
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

// Kernel 10's 9 outputs of one pair: count, p0x, p0y, p1x, p1y, d0, d1, nx, ny.
template <class V>
__device__ __forceinline__ void manifold(const V& b1, const V& b2, float margin,
                                         float (&out)[9]) {
  Face f1{-INFINITY, 0.0f, 0.0f, -1}, f2{-INFINITY, 0.0f, 0.0f, -1};
  best_face_from<kFaces>(b1, b2, 0, f1);
  best_face_from<kFaces>(b2, b1, 0, f2);
  // Reference body: small relative bias toward body 1 (the JAX expression).
  const bool ref1 =
      f1.sep >= __fsub_rn(f2.sep, __fmul_rn(1e-6f, fmaxf(fabsf(f2.sep), 1.0f)));
  const Face f = ref1 ? f1 : f2;
  const V& rb = ref1 ? b1 : b2;
  const V& ib = ref1 ? b2 : b1;
  const float nx = f.nx, ny = f.ny;
  float rax = 0.0f, ray = 0.0f, rbx = 0.0f, rby = 0.0f;  // the face's endpoints
  if (f.i >= 0) {
    const int j = f.i + 1 == rb.k ? 0 : f.i + 1;
    rax = rb.x(f.i);
    ray = rb.y(f.i);
    rbx = rb.x(j);
    rby = rb.y(j);
  }

  // Incident face: the most anti-parallel valid face of the other body
  // (zero edges at +inf; strict: the first min wins).
  float best_a = INFINITY;
  int bi = -1;
  float xj = ib.x(0), yj = ib.y(0);
#pragma unroll 1
  for (int j = 0; j < ib.k; ++j) {
    const int jn = j + 1 == ib.k ? 0 : j + 1;
    const float xn = ib.x(jn), yn = ib.y(jn);
    const float ax = __fsub_rn(yn, yj);
    const float ay = __fsub_rn(xj, xn);
    const float nn = dot2(ax, ax, ay, ay);
    const float r = inv_norm(nn > 0.0f ? nn : 1.0f);
    const float align = nn > 0.0f ? __fmul_rn(dot2(ax, nx, ay, ny), r) : INFINITY;
    if (align < best_a) {
      best_a = align;
      bi = j;
    }
    xj = xn;
    yj = yn;
  }
  float v1x = 0.0f, v1y = 0.0f, v2x = 0.0f, v2y = 0.0f;
  if (bi >= 0) {
    const int jn = bi + 1 == ib.k ? 0 : bi + 1;
    v1x = ib.x(bi);
    v1y = ib.y(bi);
    v2x = ib.x(jn);
    v2y = ib.y(jn);
  }

  // Side-plane clips against the reference face's tangent.
  const float tx = -ny, ty = nx;
  clip_halfplane(v1x, v1y, v2x, v2y, -tx, -ty, -dot2(tx, rax, ty, ray));
  clip_halfplane(v1x, v1y, v2x, v2y, tx, ty, dot2(tx, rbx, ty, rby));

  const float off = dot2(nx, rax, ny, ray);
  const float d1 = __fsub_rn(off, dot2(nx, v1x, ny, v1y));
  const float d2 = __fsub_rn(off, dot2(nx, v2x, ny, v2y));
  const bool pair_ok = (f.sep <= margin) & (f.sep > -INFINITY);
  const bool keep1 = (d1 >= -margin) & pair_ok;
  const bool keep2 = (d2 >= -margin) & pair_ok;
  const bool swap = !keep1 & keep2;
  out[0] = static_cast<float>(keep1) + static_cast<float>(keep2);
  out[1] = swap ? v2x : v1x;
  out[2] = swap ? v2y : v1y;
  out[3] = swap ? v1x : v2x;
  out[4] = swap ? v1y : v2y;
  out[5] = swap ? d2 : d1;
  out[6] = swap ? d1 : d2;
  out[7] = ref1 ? nx : -nx;
  out[8] = ref1 ? ny : -ny;
}

// ---- kernel 9: signed distance ----
//
// `gap < 0 ? gap : sqrt(d2)` as polygon_distance.cuh defines it, over the
// true K: `gap` the largest scaled support gap over every edge normal of
// both polygons (a zero normal masked to -inf), `d2` the smallest squared
// distance from a vertex of either polygon to a closed edge segment of the
// other.

// Kernel 9's first pass: whether one of the 8 spread edge normals (kernel
// 6's) proves the pair separated, unscaled: g >= 0 (or -0) on a normal with
// nn > 0 (polygon_distance.cuh's note), not kernel 6's strict test, which
// ignores nn: a normal whose |n|^2 underflows to 0 sits at -inf in the gap,
// so it proves nothing.
template <class V>
__device__ __forceinline__ bool spread_normals_settle(const V& b1, const V& b2) {
  float ax[8], ay[8], mn1[8], mx1[8], mn2[8], mx2[8];
  spread_intervals(b1, b2, ax, ay, mn1, mx1, mn2, mx2);
  bool sep = false;
#pragma unroll
  for (int u = 0; u < 8; ++u) {
    const float nn = dot2(ax[u], ax[u], ay[u], ay[u]);
    const float g = fmaxf(__fsub_rn(mn2[u], mx1[u]), __fsub_rn(mn1[u], mx2[u]));
    sep = sep | ((nn > 0.0f) & (g >= 0.0f));
  }
  return sep;
}

// gap = max(gap, the scaled support gaps of b1 and b2 on e's edge normals
// i0 .. i0 + A - 1).
template <int A, class V>
__device__ __forceinline__ void axes_gap(const V& e, int i0, const V& b1, const V& b2,
                                         float& gap) {
  float ax[A], ay[A];
  edge_normals(e, i0, ax, ay);
  float mn1[A], mx1[A], mn2[A], mx2[A];
  intervals<A>(b1, ax, ay, mn1, mx1);
  intervals<A>(b2, ax, ay, mn2, mx2);
#pragma unroll
  for (int u = 0; u < A; ++u) {
    const float nn = dot2(ax[u], ax[u], ay[u], ay[u]);
    const float raw = fmaxf(__fsub_rn(mn2[u], mx1[u]), __fsub_rn(mn1[u], mx2[u]));
    const float g = __fmul_rn(raw, inv_norm(nn > 0.0f ? nn : 1.0f));
    gap = fmaxf(gap, nn > 0.0f ? g : -INFINITY);
  }
}

// e's edge normals i0 .. k-1 in blocks of A, the rest in blocks of A / 2,
// ... 1.
template <int A, class V>
__device__ __forceinline__ void edges_gap(const V& e, int i0, const V& b1, const V& b2,
                                          float& gap) {
#pragma unroll 1
  for (; i0 + A <= e.k; i0 += A) axes_gap<A>(e, i0, b1, b2, gap);
  if constexpr (A > 1) edges_gap<A / 2>(e, i0, b1, b2, gap);
}

// The pair's signed support gap over every true edge normal of both.
template <class V>
__device__ __forceinline__ float support_gap(const V& b1, const V& b2) {
  float gap = -INFINITY;
  edges_gap<kGapAxes>(b1, 0, b1, b2, gap);
  edges_gap<kGapAxes>(b2, 0, b1, b2, gap);
  return gap;
}

// Fold vertex (x, y)'s squared distances to S segments (start (qx, qy),
// edge (ex, ey), 1 / |e|^2 or 0 for a zero-length one) into their minima:
// polydist::vertex_segment_min's test, the parameter clamped by one
// saturating multiply.
template <int S>
__device__ __forceinline__ void fold_segments(const float (&qx)[S + 1],
                                              const float (&qy)[S + 1],
                                              const float (&ex)[S], const float (&ey)[S],
                                              const float (&inv)[S], float x, float y,
                                              float (&m)[S]) {
#pragma unroll
  for (int u = 0; u < S; ++u) {
    const float dx = __fsub_rn(x, qx[u]);
    const float dy = __fsub_rn(y, qy[u]);
    const float t = polydist::mul_sat(dot2(dx, ex[u], dy, ey[u]), inv[u]);
    const float cx = __fsub_rn(dx, __fmul_rn(t, ex[u]));
    const float cy = __fsub_rn(dy, __fmul_rn(t, ey[u]));
    m[u] = fminf(m[u], dot2(cx, cx, cy, cy));
  }
}

// d2 = min(d2, the squared distances of p's vertices to q's closed edge
// segments j0 .. j0 + S - 1), p's vertices walked once, two an iteration.
template <int S, class V>
__device__ __forceinline__ void segment_block(const V& q, int j0, const V& p, float& d2) {
  float qx[S + 1], qy[S + 1], ex[S], ey[S], inv[S], m[S];
  span<S>(q, j0, qx, qy);
#pragma unroll
  for (int u = 0; u < S; ++u) {
    ex[u] = __fsub_rn(qx[u + 1], qx[u]);
    ey[u] = __fsub_rn(qy[u + 1], qy[u]);
    const float ee = dot2(ex[u], ex[u], ey[u], ey[u]);
    inv[u] = ee > 0.0f ? __fdiv_rn(1.0f, ee) : 0.0f;
    m[u] = INFINITY;
  }
  int v = 0;
#pragma unroll 1
  for (; v + 2 <= p.k; v += 2) {
    const float xa = p.x(v), ya = p.y(v), xb = p.x(v + 1), yb = p.y(v + 1);
    fold_segments<S>(qx, qy, ex, ey, inv, xa, ya, m);
    fold_segments<S>(qx, qy, ex, ey, inv, xb, yb, m);
  }
  if (v < p.k) fold_segments<S>(qx, qy, ex, ey, inv, p.x(v), p.y(v), m);
#pragma unroll
  for (int u = 0; u < S; ++u) d2 = fminf(d2, m[u]);
}

// q's segments j0 .. k-1 in blocks of S, the rest in blocks of S / 2, ... 1.
template <int S, class V>
__device__ __forceinline__ void segments_from(const V& q, int j0, const V& p, float& d2) {
#pragma unroll 1
  for (; j0 + S <= q.k; j0 += S) segment_block<S>(q, j0, p, d2);
  if constexpr (S > 1) segments_from<S / 2>(q, j0, p, d2);
}

// d2 = min(d2, the squared distance of each of p's vertices to (x, y)): a
// zero-length segment's value, `t` being 0.
template <class V>
__device__ __forceinline__ void point_min(const V& p, float x, float y, float& d2) {
#pragma unroll 1
  for (int v = 0; v < p.k; ++v) {
    const float dx = __fsub_rn(p.x(v), x);
    const float dy = __fsub_rn(p.y(v), y);
    d2 = fminf(d2, dot2(dx, dx, dy, dy));
  }
}

// The pair's squared distance when it does not overlap: every vertex of
// each polygon against every segment of the other; and, for a polygon below
// its K bucket (`pad1`, `pad2`: collide2d::k_bucket(k) > k), every vertex of
// the other against its last vertex, the padding's zero-length segments.
template <class V>
__device__ __forceinline__ float separation_d2(const V& b1, const V& b2, bool pad1,
                                               bool pad2) {
  float d2 = INFINITY;
  segments_from<kSegments>(b2, 0, b1, d2);
  segments_from<kSegments>(b1, 0, b2, d2);
  if (pad2) point_min(b1, b2.x(b2.k - 1), b2.y(b2.k - 1), d2);
  if (pad1) point_min(b2, b1.x(b1.k - 1), b1.y(b1.k - 1), d2);
  return d2;
}

#if defined(__CUDACC__)

}  // namespace big_k
}  // namespace collide2d

#include <limits.h>
#include <stdint.h>

#include <type_traits>

namespace collide2d {
namespace big_k {

// Copy `planes` planes of the block's P columns, from column p0 of `src`
// (planes of n values), into the [plane][pair] tile: cp.async, 16 bytes a
// thread (blockDim == P), where `full` (16-byte aligned planes and a whole
// tile); else plain loads of the columns below n.
template <int P, typename T>
__device__ __forceinline__ void stage(T* tile, const T* __restrict__ src, int planes,
                                      long long n, long long p0, bool full) {
  const int t = threadIdx.x;
  if (full) {
    constexpr int kPer = 16 / sizeof(T);  // values a 16-byte copy moves
    constexpr int kChunks = P / kPer;     // of a plane
    const int q = (t % kChunks) * kPer;
    for (int c = t / kChunks; c < planes; c += kPer) {
      const unsigned dst =
          static_cast<unsigned>(__cvta_generic_to_shared(tile + c * P + q));
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
                   "l"(src + c * n + p0 + q));
    }
  } else if (p0 + t < n) {
    for (int c = 0; c < planes; ++c) tile[c * P + t] = src[c * n + p0 + t];
  }
}

// Stage the block's P pairs (polygon 1's 2 k1 planes, then polygon 2's 2
// k2) in dynamic shared memory; returns the tile, after the block's barrier.
template <int P, typename T>
__device__ __forceinline__ T* stage_pairs(const T* __restrict__ p1, const T* __restrict__ p2,
                                          long long n, int k1, int k2, long long p0,
                                          bool vec) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* tile = reinterpret_cast<T*>(smem);
  const bool full = vec && p0 + P <= n;
  stage<P>(tile, p1, 2 * k1, n, p0, full);
  stage<P>(tile + 2 * k1 * P, p2, 2 * k2, n, p0, full);
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
  __syncthreads();
  return tile;
}

// Appends `item` to `list` where `take` holds, warp by warp (one shared
// atomicAdd a warp; every lane of the warp calls it).
__device__ __forceinline__ void append(bool take, int item, int* list, int* count) {
  const unsigned mask = __ballot_sync(0xffffffffu, take);
  const int lane = threadIdx.x & 31;
  int base = 0;
  if (lane == 0 && mask != 0u) base = atomicAdd(count, __popc(mask));
  base = __shfl_sync(0xffffffffu, base, 0);
  if (take) list[base + __popc(mask & ((1u << lane) - 1u))] = item;
}

// Whether every plane of both inputs starts on 16 bytes.
template <typename T>
inline bool planes_aligned(const T* p1, const T* p2, long long n) {
  return reinterpret_cast<uintptr_t>(p1) % 16 == 0 &&
         reinterpret_cast<uintptr_t>(p2) % 16 == 0 && (n * sizeof(T)) % 16 == 0;
}

// Let `kernel` take `bytes` of dynamic shared memory (above 48 KB only
// after this), on the current device.
template <typename K>
inline cudaError_t allow_tile(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

// Launches a run-time-K kernel over n pairs at (k1, k2) with `elem_bytes`
// coordinates: `launch(tile, grid, bytes)`, `tile` a
// std::integral_constant of the tile rule's P (`tile_pairs`: P threads a
// block and `bytes` of dynamic shared memory for their tile; the caller
// passes them to `allow_tile`), or of 0 (the planes in device memory,
// kMaxPairs threads a block, no tile); cudaErrorInvalidValue where the grid
// does not fit.
template <class Launch>
inline cudaError_t launch_tiled(long long n, int k1, int k2, int elem_bytes,
                                Launch&& launch) {
  const auto with = [&](auto tile) -> cudaError_t {
    constexpr int threads = decltype(tile)::value > 0 ? decltype(tile)::value : kMaxPairs;
    const long long blocks = (n + threads - 1) / threads;
    if (blocks > INT_MAX) return cudaErrorInvalidValue;
    return launch(tile, static_cast<unsigned>(blocks),
                  static_cast<size_t>(2ull * (k1 + k2) * decltype(tile)::value * elem_bytes));
  };
  switch (tile_pairs(k1, k2, elem_bytes)) {
    case 128: return with(std::integral_constant<int, 128>{});
    case 64: return with(std::integral_constant<int, 64>{});
    case 32: return with(std::integral_constant<int, 32>{});
    default: return with(std::integral_constant<int, 0>{});
  }
}

#endif  // __CUDACC__

}  // namespace big_k
}  // namespace collide2d
