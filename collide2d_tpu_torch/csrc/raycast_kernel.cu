// Scene raycast (kernel 11) on Hopper: the first hit of R rays over one
// scene of N convex k-gons.
//
// Replaces the TPU kernel collide2d_tpu/ops/raycast_pallas.py::
// _make_raycast_kernel (:48; pallas_call :119). The scene is the (N, KP, 4)
// float32 half-plane table of ops/raycast_cuda.py::pack_scene_tables: per
// face the unit outward normal (nx, ny) and offset off = un . p, in .w the
// shape's any-face flag (read from face 0); KP is k rounded up to 4 with
// all-zero faces, which never clip and never enter. Per (ray, face):
// no = nx*ox + ny*oy, nd = nx*dx + ny*dy, num = off - no, ratio = num / (nd
// == 0 ? 1 : nd); a parallel face with num < 0 empties the window; the
// entry is a max updated on STRICT > (the first face wins and carries its
// normal), the exit a min. Per shape, a hit is entry <= exit, entry <=
// t_max, exit >= 0 and any face; t = max(entry, 0) on a hit, +inf
// otherwise; the normal is zero on a miss and on an inside start. Over the
// shapes, the first-index argmin of t: ties and all-miss rays take the
// smallest index (a miss of everything gives index 0 and a zero normal).
//
// What bounds it on this card. A ray reads 16 bytes (origin, direction)
// and writes 16 (t 4, index 4, normal 8): 0.040 ms for 2^22 rays at 3.35
// TB/s. Every (ray, face) costs 23 FP32 operations written here (the
// division counted as one; its IEEE fast path is 7 instructions) and every
// (ray, shape) 13 more: at N = 64, k = 8 that is 12,608 a ray, ~0.79 ms
// for 2^22 rays at 67 TFLOP/s, so operations bound it (chip_smoke.py::
// raycast_ops). The design keeps everything but the rays on chip:
// one thread a ray, the face table staged in shared memory in tiles of
// whole shapes, every thread reading the same face at the same time (a
// broadcast: no bank conflicts, one 16-byte load a face), and (best t,
// index, normal) carried in registers across shapes and tiles under the
// same strict < rule, so the result does not depend on the tile size. A
// scene larger than one tile (48 KB, 3,072 faces) walks its tiles in order.
//
// Rounding. Products and sums are __fmul_rn / __fadd_rn / __fsub_rn in the
// torch order and the division is IEEE (__fdiv_rn), so the kernel is
// bitwise its plain version (ops/raycast_cuda.py::scene_raycast_plain).
//
// The wrapper allocates the outputs; the kernel allocates nothing and does
// not synchronise.

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>

#include "fp32_rn.cuh"

namespace {

using collide2d::dot2;

constexpr int kThreads = 256;
constexpr int kMaxTileFaces = 3072;  // 48 KB of float4 faces

__global__ void __launch_bounds__(kThreads)
    scene_raycast_kernel(const float2* __restrict__ origin,
                         const float2* __restrict__ direction,
                         const float4* __restrict__ table,
                         float* __restrict__ out_t, int* __restrict__ out_idx,
                         float2* __restrict__ out_n, long long r, int n_shapes,
                         int kp, float t_max, int tile_shapes) {
  extern __shared__ float4 tab[];
  const long long ray = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  const bool live = ray < r;
  float ox = 0.0f, oy = 0.0f, dx = 0.0f, dy = 0.0f;
  if (live) {
    const float2 o = origin[ray];
    const float2 d = direction[ray];
    ox = o.x;
    oy = o.y;
    dx = d.x;
    dy = d.y;
  }
  float best_t = INFINITY, best_nx = 0.0f, best_ny = 0.0f;
  int best_i = 0;
  for (int s0 = 0; s0 < n_shapes; s0 += tile_shapes) {
    const int ns = min(tile_shapes, n_shapes - s0);
    const int nf = ns * kp;
    __syncthreads();  // every thread is done with the previous tile
    for (int f = threadIdx.x; f < nf; f += kThreads) {
      tab[f] = table[static_cast<long long>(s0) * kp + f];
    }
    __syncthreads();
    for (int s = 0; s < ns; ++s) {
      const float4* faces = tab + s * kp;
      float entry = -INFINITY, exit_ = INFINITY, bnx = 0.0f, bny = 0.0f;
      for (int j = 0; j < kp; j += 4) {
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const float4 f = faces[j + u];
          const float no = dot2(f.x, ox, f.y, oy);
          const float nd = dot2(f.x, dx, f.y, dy);
          const float num = __fsub_rn(f.z, no);  // constraint: t * nd <= num
          const float ratio = __fdiv_rn(num, nd == 0.0f ? 1.0f : nd);
          const bool pm = nd == 0.0f && num < 0.0f;  // parallel, outside
          const float lo = nd < 0.0f ? ratio : (pm ? INFINITY : -INFINITY);
          const float hi = nd > 0.0f ? ratio : (pm ? -INFINITY : INFINITY);
          if (lo > entry) {  // strict: the first max wins
            entry = lo;
            bnx = f.x;
            bny = f.y;
          }
          exit_ = fminf(exit_, hi);
        }
      }
      const bool hit = entry <= exit_ && entry <= t_max && exit_ >= 0.0f &&
                       faces[0].w > 0.0f;
      const bool inside = hit && entry < 0.0f;
      const float t = hit ? fmaxf(entry, 0.0f) : INFINITY;
      if (t < best_t) {  // strict: the first shape at the minimum wins
        const bool keep_n = hit && !inside;
        best_t = t;
        best_i = s0 + s;
        best_nx = keep_n ? bnx : 0.0f;
        best_ny = keep_n ? bny : 0.0f;
      }
    }
  }
  if (live) {
    out_t[ray] = best_t;
    out_idx[ray] = best_i;
    out_n[ray] = make_float2(best_nx, best_ny);
  }
}

}  // namespace

// Plain C entry point (bound with ctypes). `origin`, `direction`: (r, 2)
// float32; `table`: (n_shapes, kp, 4) float32, kp a multiple of 4 and at
// most 3,072; outputs t (r,), idx (r,) int32, normal (r, 2). `tile_shapes`
// caps the shapes staged at once (<= 0: as many as 48 KB hold). Launches on
// `stream`, does not synchronise, and returns cudaGetLastError() after the
// launch (0 = ok).
extern "C" int scene_raycast_launch(const float* origin, const float* direction,
                                    const float* table, float* out_t, int* out_idx,
                                    float* out_n, long long r, int n_shapes, int kp,
                                    float t_max, int tile_shapes, void* stream) {
  if (r <= 0) return static_cast<int>(cudaSuccess);
  if (n_shapes <= 0 || kp <= 0 || kp % 4 != 0 || kp > kMaxTileFaces) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long blocks = (r + kThreads - 1) / kThreads;
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  int tile = kMaxTileFaces / kp;
  if (tile_shapes > 0 && tile_shapes < tile) tile = tile_shapes;
  if (tile > n_shapes) tile = n_shapes;
  const size_t smem = static_cast<size_t>(tile) * kp * sizeof(float4);
  scene_raycast_kernel<<<static_cast<unsigned>(blocks), kThreads, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const float2*>(origin),
      reinterpret_cast<const float2*>(direction),
      reinterpret_cast<const float4*>(table), out_t, out_idx,
      reinterpret_cast<float2*>(out_n), r, n_shapes, kp, t_max, tile);
  return static_cast<int>(cudaGetLastError());
}
