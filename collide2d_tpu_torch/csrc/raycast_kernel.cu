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
// entry is a max updated on STRICT > (the first face wins and gives the
// normal), the exit a min. Per shape, a hit is entry <= exit, entry <=
// t_max, exit >= 0 and any face; t = max(entry, 0) on a hit, +inf
// otherwise; the normal is zero on a miss and on an inside start. Over the
// shapes, the first-index argmin of t: ties and all-miss rays take the
// smallest index (a miss of everything gives index 0 and a zero normal).
// The per-shape arithmetic is csrc/raycast_shape.cuh.
//
// What bounds it on this card. A ray reads 16 bytes (origin, direction)
// and writes 16 (t 4, index 4, normal 8): 0.040 ms for 2^22 rays at 3.35
// TB/s. Every (ray, face) costs 23 FP32 operations as the plain version
// writes them (the division counted as one) and every (ray, shape) 13 more:
// at N = 64, k = 8 that is 12,608 a ray, ~0.79 ms for 2^22 rays at 67
// TFLOP/s. No product may be contracted into an FMA and the IEEE division's
// fast path is 7 instructions, so what the card must issue a (ray, face)
// bounds it (chip_smoke.py reads the SASS for the issue floor).
//
// Design, to issue fewer instructions a (ray, face):
// - one library per face count (-DRAYCAST_KP = 4, 8, 16; 0 builds the
//   generic form for any multiple of 4, unrolled by 4): a shape's faces
//   unroll fully and the table offsets are constants;
// - two rays a thread (ray and ray + 128 in a block of 128 threads) from
//   2^22 rays on, so one broadcast 16-byte shared-memory load of a face
//   serves both and their two division chains overlap; a smaller launch
//   takes one ray a thread, which ran faster there (a template argument);
// - the window carries the entering face's index, not its normal; the
//   winner's normal is read back from the table once a ray, at the end;
// - the parallel-face case folds into the exit's min (raycast_shape.cuh);
// - an exact warp-uniform exit from a shape once every ray of the warp is
//   settled (raycast_shape.cuh), voted on after every kCheck faces.
// The face table is staged in shared memory in tiles of whole shapes
// (48 KB, 3,072 faces), every thread reading the same face at the same time
// (a broadcast), and (best t, index, face) is carried in registers across
// shapes and tiles under the same strict < rule, so the result does not
// depend on the tile size. A scene larger than one tile walks its tiles in
// order.
//
// Rounding. Products and sums are __fmul_rn / __fadd_rn / __fsub_rn in the
// torch order and the division is IEEE (__fdiv_rn), so the kernel is
// bitwise its plain version (ops/raycast_cuda.py::scene_raycast_plain).
//
// With -DRAYCAST_COUNT_FACES=1 the library also counts the (ray, face)
// pairs it evaluates (scene_raycast_faces); the default build does not.
//
// The wrapper allocates the outputs; the kernel allocates nothing and does
// not synchronise.

#include <cuda_runtime.h>
#include <float.h>
#include <limits.h>
#include <math.h>

#include "raycast_shape.cuh"

#ifndef RAYCAST_KP
#define RAYCAST_KP 0
#endif
#ifndef RAYCAST_COUNT_FACES
#define RAYCAST_COUNT_FACES 0
#endif

namespace {

using namespace collide2d::raycast;

constexpr int kKP = RAYCAST_KP;
static_assert(kKP >= 0 && kKP % 4 == 0, "RAYCAST_KP must be 0 or a multiple of 4");
constexpr int kThreads = 128;
// Rays a thread: two from this many rays on, else one. On the bench's
// scene (64 8-gons) one ray a thread ran 0.138-0.139 ms at 2^18 rays
// against 0.148-0.152 for two, 0.485 at 2^20 against 0.492-0.497, and
// 1.869-1.883 at 2^22 against 1.860-1.867; at 2^16 rays over 4,096 shapes
// 2.36 against 3.22 (an NVIDIA H100 80GB HBM3, utils/screen_raycast_ab.py
// in turns). Four rays a thread ran slower than two (PERF.md section 6).
constexpr long long kTwoRaysFrom = 1 << 22;
constexpr int kMaxTileFaces = 3072;  // 48 KB of float4 faces
// Faces between the exit's votes (0: no exit): at 2^22 rays x 64 8-gons a
// vote after every second face ran 1.86-1.87 ms, every face 2.02-2.04,
// every fourth 2.12 and none 2.11-2.12 (an NVIDIA H100 80GB HBM3,
// utils/screen_raycast_ab.py against a copy of this file with kCheck
// edited). A library without a face count of its own votes after every 4.
constexpr int kCheck = 2;

#if RAYCAST_COUNT_FACES
__device__ unsigned long long g_faces = 0;
#endif

template <int RAYS>
__global__ void __launch_bounds__(kThreads)
    scene_raycast_kernel(const float2* __restrict__ origin,
                         const float2* __restrict__ direction,
                         const float4* __restrict__ table,
                         float* __restrict__ out_t, int* __restrict__ out_idx,
                         float2* __restrict__ out_n, long long r, int n_shapes,
                         int kp_arg, float t_max, int tile_shapes) {
  extern __shared__ float4 tab[];
  const int kp = kKP > 0 ? kKP : kp_arg;
  const long long first =
      static_cast<long long>(blockIdx.x) * (kThreads * RAYS) + threadIdx.x;
  const float tcap = t_max >= 0.0f ? t_max : INFINITY;
  Ray ray[RAYS];
  bool live[RAYS];
  float best_t[RAYS], lim[RAYS];
  int best_i[RAYS], best_f[RAYS];
#pragma unroll
  for (int l = 0; l < RAYS; ++l) {
    const long long i = first + l * kThreads;
    live[l] = i < r;
    float2 o = make_float2(0.0f, 0.0f), d = make_float2(0.0f, 0.0f);
    if (live[l]) {
      o = origin[i];
      d = direction[i];
    }
    ray[l] = Ray{o.x, o.y, d.x, d.y};
    best_t[l] = INFINITY;
    best_i[l] = 0;
    best_f[l] = -1;
    lim[l] = live[l] ? fminf(FLT_MAX, tcap) : -INFINITY;
  }
#if RAYCAST_COUNT_FACES
  unsigned long long faces_done = 0;
  int live_rays = 0;
#pragma unroll
  for (int l = 0; l < RAYS; ++l) live_rays += static_cast<int>(live[l]);
#endif
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
      Window w[RAYS];
      const int done = shape_windows<kKP, RAYS, kCheck>(faces, kp, ray, lim, w);
#if RAYCAST_COUNT_FACES
      faces_done += static_cast<unsigned long long>(done) * live_rays;
#endif
      if (kCheck > 0 && done < kp) continue;  // every ray of the warp settled
      const bool any_face = faces[0].w > 0.0f;
#pragma unroll
      for (int l = 0; l < RAYS; ++l) {
        if (take_shape(w[l], any_face, t_max, s0 + s, best_t[l], best_i[l],
                       best_f[l]) &&
            kCheck > 0) {
          lim[l] = settle_limit(best_t[l], tcap);
        }
      }
    }
  }
#if RAYCAST_COUNT_FACES
  atomicAdd(&g_faces, faces_done);
#endif
#pragma unroll
  for (int l = 0; l < RAYS; ++l) {
    if (!live[l]) continue;
    const long long i = first + l * kThreads;
    float2 n = make_float2(0.0f, 0.0f);
    if (best_f[l] >= 0) {
      const float4 f = table[static_cast<long long>(best_i[l]) * kp + best_f[l]];
      n = make_float2(f.x, f.y);
    }
    out_t[i] = best_t[l];
    out_idx[i] = best_i[l];
    out_n[i] = n;
  }
}

int rays_per_thread(long long r) { return r >= kTwoRaysFrom ? 2 : 1; }

template <int RAYS>
int launch_rays(const float* origin, const float* direction,
                const float* table, float* out_t, int* out_idx, float* out_n,
                long long r, int n_shapes, int kp, float t_max, int tile,
                cudaStream_t st) {
  const long long blocks = (r + kThreads * RAYS - 1) / (kThreads * RAYS);
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = static_cast<size_t>(tile) * kp * sizeof(float4);
  const auto o = reinterpret_cast<const float2*>(origin);
  const auto d = reinterpret_cast<const float2*>(direction);
  const auto tb = reinterpret_cast<const float4*>(table);
  const auto n = reinterpret_cast<float2*>(out_n);
  scene_raycast_kernel<RAYS><<<static_cast<unsigned>(blocks), kThreads, smem, st>>>(
      o, d, tb, out_t, out_idx, n, r, n_shapes, kp, t_max, tile);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The rays a thread takes in a launch of r rays.
extern "C" int scene_raycast_thread_rays(long long r) { return rays_per_thread(r); }

// Plain C entry point (bound with ctypes). `origin`, `direction`: (r, 2)
// float32; `table`: (n_shapes, kp, 4) float32, kp a multiple of 4, at most
// 3,072, and the library's own where it was built for one; outputs t (r,),
// idx (r,) int32, normal (r, 2). `tile_shapes` caps the shapes staged at
// once (<= 0: as many as 48 KB hold). Launches on `stream`, does not
// synchronise, and returns cudaGetLastError() after the launch (0 = ok).
extern "C" int scene_raycast_launch(const float* origin, const float* direction,
                                    const float* table, float* out_t, int* out_idx,
                                    float* out_n, long long r, int n_shapes, int kp,
                                    float t_max, int tile_shapes, void* stream) {
  if (r <= 0) return static_cast<int>(cudaSuccess);
  if (n_shapes <= 0 || kp <= 0 || kp % 4 != 0 || kp > kMaxTileFaces ||
      (kKP > 0 && kp != kKP)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int tile = kMaxTileFaces / kp;
  if (tile_shapes > 0 && tile_shapes < tile) tile = tile_shapes;
  if (tile > n_shapes) tile = n_shapes;
  const auto st = static_cast<cudaStream_t>(stream);
  return rays_per_thread(r) == 2
             ? launch_rays<2>(origin, direction, table, out_t, out_idx, out_n, r,
                              n_shapes, kp, t_max, tile, st)
             : launch_rays<1>(origin, direction, table, out_t, out_idx, out_n, r,
                              n_shapes, kp, t_max, tile, st);
}

#if RAYCAST_COUNT_FACES
// The (ray, face) pairs evaluated since the last call (synchronises).
extern "C" int scene_raycast_faces(unsigned long long* out) {
  const unsigned long long zero = 0;
  cudaError_t err = cudaMemcpyFromSymbol(out, g_faces, sizeof(zero));
  if (err == cudaSuccess) err = cudaMemcpyToSymbol(g_faces, &zero, sizeof(zero));
  return static_cast<int>(err);
}
#endif
