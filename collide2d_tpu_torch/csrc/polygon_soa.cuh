// Loading one k-gon pair from the `pack_polygons` SoA planes, padded to the
// build's K buckets in registers.
//
// Shared by csrc/distance_kernel.cu (kernel 9) and csrc/manifold_kernel.cu
// (kernel 10); csrc/polygon_kernel.cu (kernel 6) carries the same loader.
// A K-gon batch is the (2K, 8, M) SoA of `pack_polygons`: 2K coordinate
// planes (x0..x_{K-1}, y0..y_{K-1}) of n = 8M contiguous values, pair p at
// plane[c][p]. One thread takes one pair, so neighbouring threads read
// neighbouring addresses of every plane and each load is coalesced.
//
// The register bodies are compiled for K buckets 4, 8 and 16. A polygon of
// k <= K vertices fills slots k..K-1 with copies of vertex k-1 (the
// repeat-last padding of `ops.sat.sat_polygons`), which adds only
// zero-length edges and duplicate vertices. Above 16 vertices in either
// polygon, kernels 6, 9 and 10 loop over the true K instead
// (polygon_big_k.cuh), in the same library; kernel 9's plain version still
// pads to the bucket (`k_bucket`), which that body reproduces.

#pragma once

#include "fp32_rn.cuh"

namespace collide2d {

// The K bucket of a polygon of k vertices: 4, 8 or 16 up to 16, else the
// next power of two (ops/polygon_cuda.py::k_bucket); 0 for k < 1.
inline int k_bucket(int k) {
  if (k < 1) return 0;
  if (k <= 4) return 4;
  if (k <= 8) return 8;
  if (k <= 16) return 16;
  int b = 32;
  while (b < k) b *= 2;
  return b;
}

// Vertices 0..k-1 of pair p from the float32 planes of `src`; slots
// k..K-1 repeat vertex k-1.
template <int K>
__device__ __forceinline__ void load_polygon(const float* __restrict__ src,
                                             long long n, long long p, int k,
                                             float (&x)[K], float (&y)[K]) {
#pragma unroll
  for (int i = 0; i < K; ++i) {
    if (i < k) {
      x[i] = src[static_cast<long long>(i) * n + p];
      y[i] = src[static_cast<long long>(k + i) * n + p];
    } else {
      x[i] = x[i > 0 ? i - 1 : 0];
      y[i] = y[i > 0 ? i - 1 : 0];
    }
  }
}

// 1 / sqrt(nn) as two IEEE-rounded operations: the same value torch's
// reciprocal(sqrt(.)) gives in the plain versions, on the card and the CPU.
__device__ __forceinline__ float inv_norm(float nn) {
  return __fdiv_rn(1.0f, __fsqrt_rn(nn));
}

}  // namespace collide2d
