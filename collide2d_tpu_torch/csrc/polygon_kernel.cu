// Convex k-gon pair SAT on true edge normals, labels, on Hopper.
//
// Replaces the TPU kernel collide2d_tpu/ops/polygon_pallas.py::_make_kernel
// (body `_polygon_sat_body`). For each pair p of a K1-gon and a K2-gon it
// writes 1.0f when the two collide and 0.0f when an edge normal of either
// separates them (strict `<`, so touching polygons collide).
//
// Layout. A K-gon batch is the (2K, 8, M) SoA of `pack_polygons`: in memory
// 2K coordinate planes (x0..x_{K-1}, y0..y_{K-1}) of n = 8M contiguous
// values, pair p at plane[c][p]. One thread takes one pair and reads
// plane[c][p], so neighbouring threads read neighbouring addresses of every
// plane: each load is coalesced without repacking. bf16 planes are upcast
// exactly on load (__bfloat162float); the test always runs in float32.
//
// Two bodies. Up to 16 vertices a polygon (`polygon_sat_kernel`, below):
// polygons are padded to a fixed K by repeating their last vertex. A
// repeated vertex never moves a projection interval, the edge between two
// copies is the zero axis (its intervals are [0, 0] on both bodies, which
// never separate), and the edge from the last slot back to vertex 0 is the
// real closing edge. So the kernel needs no masks, and the same holds for
// the padding it adds itself: the build carries K = 4, 8 and 16 for each
// polygon, and a K1-gon with K1 <= 4 runs the K = 4 body with slots K1..3
// copied from slot K1-1 in registers (likewise 8 and 16). The labels equal
// the unpadded test's bit for bit, since every real projection is computed
// by the same operations. Above 16 vertices in either polygon
// (`polygon_sat_big_k_kernel`): run-time loops over the true K1 and K2,
// the pairs' vertices staged in shared memory, 8 axes a vertex walk, and a
// first pass over 8 spread axes that settles most separated pairs before
// the rest (polygon_big_k.cuh, with its argument that the labels are the
// same bits).
//
// What bounds it on this card. At K1 = K2 = 8 a f32 pair reads 2 x 16
// coordinates x 4 bytes and writes a 4-byte label, 132 bytes: 0.33 ms for
// 2^23 pairs at 3.35 TB/s. It does 5 (K1+K2)^2 = 1,280 FP32 operations
// (16 axes x (2 for the axis, 16 projections of 2 mul + 1 add, 28 min/max,
// 2 compares)), 0.16 ms at 67 TFLOP/s; but the products and sums must not
// fuse (below), so each costs a full instruction and the instruction bound
// is about 0.32 ms. Bytes and instructions are therefore about even at
// K = 8 in f32; bf16 halves the bytes and leaves the instructions. The
// design spends nothing on reuse: plain coalesced loads, vertices and axes
// in registers, no shared memory, nothing in device memory but the label.
//
// Parity. Labels must equal `ops.sat.sat_polygons` and the Pallas kernel
// bit for bit, so every product, sum and difference is an explicitly
// rounded __fmul_rn / __fadd_rn / __fsub_rn: nvcc would otherwise contract
// ax*x + ay*y into an FMA and flip touching pairs. fminf/fmaxf equal
// jnp.minimum/jnp.maximum on finite inputs; non-finite coordinates are
// outside the contract.
//
// The wrapper (ops/polygon_cuda.py) allocates the output; the kernel
// allocates nothing and does not synchronise.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include "polygon_big_k.cuh"
#include "polygon_soa.cuh"

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// ax*x + ay*y with both products and the sum rounded on their own.
__device__ __forceinline__ float proj(float ax, float ay, float x, float y) {
  return __fadd_rn(__fmul_rn(ax, x), __fmul_rn(ay, y));
}

// Vertices 0..k-1 of pair p from the planes of `src`; slots k..K-1 repeat
// vertex k-1 (`K` is the compile-time bucket, `k` the batch's K).
template <int K, typename T>
__device__ __forceinline__ void load_polygon(const T* __restrict__ src,
                                             long long n, long long p, int k,
                                             float (&x)[K], float (&y)[K]) {
#pragma unroll
  for (int i = 0; i < K; ++i) {
    if (i < k) {
      x[i] = to_f32(src[static_cast<long long>(i) * n + p]);
      y[i] = to_f32(src[static_cast<long long>(k + i) * n + p]);
    } else {
      x[i] = x[i > 0 ? i - 1 : 0];
      y[i] = y[i > 0 ? i - 1 : 0];
    }
  }
}

// [min, max] of the projections of a K-gon onto (ax, ay).
template <int K>
__device__ __forceinline__ void interval(float ax, float ay,
                                         const float (&x)[K],
                                         const float (&y)[K], float& mn,
                                         float& mx) {
  mn = proj(ax, ay, x[0], y[0]);
  mx = mn;
#pragma unroll
  for (int i = 1; i < K; ++i) {
    const float q = proj(ax, ay, x[i], y[i]);
    mn = fminf(mn, q);
    mx = fmaxf(mx, q);
  }
}

// True when an edge normal of the polygon (xs, ys) separates the pair.
template <int KA, int K1, int K2>
__device__ __forceinline__ bool separated_by(const float (&xs)[KA],
                                             const float (&ys)[KA],
                                             const float (&x1)[K1],
                                             const float (&y1)[K1],
                                             const float (&x2)[K2],
                                             const float (&y2)[K2]) {
  bool sep = false;
#pragma unroll
  for (int i = 0; i < KA; ++i) {
    const int j = (i + 1) % KA;
    // True perpendicular normal of edge i -> j: (ey, -ex).
    const float ax = __fsub_rn(ys[j], ys[i]);
    const float ay = __fsub_rn(xs[i], xs[j]);
    float mn1, mx1, mn2, mx2;
    interval<K1>(ax, ay, x1, y1, mn1, mx1);
    interval<K2>(ax, ay, x2, y2, mn2, mx2);
    sep = sep | (mx1 < mn2) | (mx2 < mn1);
  }
  return sep;
}

template <int K1, int K2, typename T>
__global__ void __launch_bounds__(kThreads)
    polygon_sat_kernel(const T* __restrict__ p1, const T* __restrict__ p2,
                       float* __restrict__ out, long long n, int k1, int k2) {
  const long long p = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (p >= n) return;
  float x1[K1], y1[K1], x2[K2], y2[K2];
  load_polygon<K1>(p1, n, p, k1, x1, y1);
  load_polygon<K2>(p2, n, p, k2, x2, y2);
  // `|`, not `||`: every axis is tested, as the TPU kernel does, so the
  // work per pair does not depend on the data.
  const bool sep = separated_by<K1>(x1, y1, x1, y1, x2, y2) |
                   separated_by<K2>(x2, y2, x1, y1, x2, y2);
  out[p] = sep ? 0.0f : 1.0f;
}

template <int K1, int K2, typename T>
void launch(const void* p1, const void* p2, float* out, long long n, int k1,
            int k2, unsigned grid, cudaStream_t s) {
  polygon_sat_kernel<K1, K2, T><<<grid, kThreads, 0, s>>>(
      static_cast<const T*>(p1), static_cast<const T*>(p2), out, n, k1, k2);
}

template <int K1, typename T>
bool launch_k2(const void* p1, const void* p2, float* out, long long n, int k1,
               int k2, unsigned grid, cudaStream_t s) {
  switch (collide2d::k_bucket(k2)) {
    case 4: launch<K1, 4, T>(p1, p2, out, n, k1, k2, grid, s); return true;
    case 8: launch<K1, 8, T>(p1, p2, out, n, k1, k2, grid, s); return true;
    case 16: launch<K1, 16, T>(p1, p2, out, n, k1, k2, grid, s); return true;
    default: return false;
  }
}

template <typename T>
bool launch_k1(const void* p1, const void* p2, float* out, long long n, int k1,
               int k2, unsigned grid, cudaStream_t s) {
  switch (collide2d::k_bucket(k1)) {
    case 4: return launch_k2<4, T>(p1, p2, out, n, k1, k2, grid, s);
    case 8: return launch_k2<8, T>(p1, p2, out, n, k1, k2, grid, s);
    case 16: return launch_k2<16, T>(p1, p2, out, n, k1, k2, grid, s);
    default: return false;
  }
}

// Above 16 vertices: one pair a thread at the true K1 and K2, a block's P
// pairs staged in shared memory, or (P == 0) read in device memory where a
// 32-pair tile does not fit (polygon_big_k.cuh). In a tile each pair takes
// the first pass's spread axes; the pairs it leaves undecided are listed
// and take the second pass packed onto the block's first lanes, so a warp
// runs every axis only for pairs that need it.
template <typename T, int P>
__global__ void __launch_bounds__(collide2d::big_k::kMaxPairs)
    polygon_sat_big_k_kernel(const T* __restrict__ p1, const T* __restrict__ p2,
                             float* __restrict__ out, long long n, int k1, int k2,
                             bool vec) {
  using collide2d::big_k::Polygon;
  const long long p0 = static_cast<long long>(blockIdx.x) * blockDim.x;
  const int t = threadIdx.x;
  if constexpr (P > 0) {
    __shared__ int undecided[P];
    __shared__ int count;
    if (t == 0) count = 0;
    const T* tile = collide2d::big_k::stage_pairs<P>(p1, p2, n, k1, k2, p0, vec);
    const T* tile2 = tile + 2 * k1 * P;
    bool open = false;
    if (p0 + t < n) {
      open = !collide2d::big_k::spread_axes_separate(Polygon<T, P>{tile + t, 0, k1},
                                                     Polygon<T, P>{tile2 + t, 0, k2});
      if (!open) out[p0 + t] = 0.0f;
    }
    collide2d::big_k::append(open, t, undecided, &count);
    __syncthreads();
    for (int i = t; i < count; i += P) {
      const int u = undecided[i];
      out[p0 + u] = collide2d::big_k::rest_separate(Polygon<T, P>{tile + u, 0, k1},
                                                    Polygon<T, P>{tile2 + u, 0, k2})
                        ? 0.0f
                        : 1.0f;
    }
  } else {
    if (p0 + t >= n) return;
    out[p0 + t] = collide2d::big_k::sat_label(Polygon<T, 0>{p1 + p0 + t, n, k1},
                                              Polygon<T, 0>{p2 + p0 + t, n, k2});
  }
}

template <typename T>
cudaError_t launch_big_k(const void* p1v, const void* p2v, float* out, long long n,
                         int k1, int k2, cudaStream_t s) {
  namespace big_k = collide2d::big_k;
  const T* p1 = static_cast<const T*>(p1v);
  const T* p2 = static_cast<const T*>(p2v);
  const bool vec = big_k::planes_aligned(p1, p2, n);
  return big_k::launch_tiled(n, k1, k2, sizeof(T), [&](auto tile, unsigned grid,
                                                       size_t bytes) {
    constexpr int P = decltype(tile)::value;
    const cudaError_t err = big_k::allow_tile(polygon_sat_big_k_kernel<T, P>, bytes);
    if (err != cudaSuccess) return err;
    polygon_sat_big_k_kernel<T, P><<<grid, P > 0 ? P : big_k::kMaxPairs, bytes, s>>>(
        p1, p2, out, n, k1, k2, P > 0 && vec);
    return cudaSuccess;
  });
}

}  // namespace

// Plain C entry point (bound with ctypes). `n` is the number of pairs (8M);
// `k1`/`k2` the vertices of each polygon (>= 1; any K: above 16 in either
// polygon the run-time-K body); `bf16` selects bfloat16 planes. Launches on
// `stream`, does not synchronise, and returns cudaGetLastError() after the
// launch (0 = ok).
extern "C" int polygon_sat_launch(const void* p1, const void* p2, float* out,
                                  long long n, int k1, int k2, int bf16,
                                  void* stream) {
  if (n <= 0) return static_cast<int>(cudaSuccess);
  if (k1 < 1 || k2 < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (k1 > 16 || k2 > 16) {
    const cudaError_t err =
        bf16 ? launch_big_k<__nv_bfloat16>(p1, p2, out, n, k1, k2, s)
             : launch_big_k<float>(p1, p2, out, n, k1, k2, s);
    if (err != cudaSuccess) return static_cast<int>(err);
    return static_cast<int>(cudaGetLastError());
  }
  const long long blocks = (n + kThreads - 1) / kThreads;
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  const unsigned grid = static_cast<unsigned>(blocks);
  const bool ok =
      bf16 ? launch_k1<__nv_bfloat16>(p1, p2, out, n, k1, k2, grid, s)
           : launch_k1<float>(p1, p2, out, n, k1, k2, grid, s);
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
