// One shape of the scene raycast (kernel 11) for the rays of one thread:
// the window each ray's faces clip, the warp's early exit, and the first-hit
// update.
//
// Used by csrc/raycast_kernel.cu. Every product, sum and difference is an
// explicitly rounded __fmul_rn / __fadd_rn / __fsub_rn in the order of the
// plain version (ops/raycast_cuda.py::scene_raycast_plain) and the division
// is IEEE (__fdiv_rn), so tests/test_torch_raycast_shape.py compiles this
// header with g++ (the intrinsics as plain float operations under
// -ffp-contract=off, __all_sync as a switch) and holds it to the plain
// version bit for bit, with the exit on and off.
//
// What the window keeps, against the plain version's per-face form:
//
// - the entry is a max updated on STRICT > (the first face at the maximum
//   wins) and carries the entering face's index, not its normal: the
//   caller reads the normal back from the table once, for the winning
//   shape;
// - the exit is a min over the faces the ray leaves through (nd > 0);
// - a face the ray runs along from outside (nd == 0, num < 0) lowers the
//   exit to num < 0 where the plain version sets it to -inf and the entry
//   to +inf. Both make the shape a miss (the exit is negative), so the
//   results are the same, and the entry keeps being a max over the
//   entering faces alone.
//
// The early exit. Inside a shape the entry only grows and the exit only
// shrinks, so t_e = max(entry, 0) only grows. A ray is settled, the rest of
// the shape's faces cannot change its result, once exit < t_e (the window
// is empty or lies behind the origin), once t_e >= best_t (the hit could
// not win the strict t < best_t), or once t_e > t_max >= 0 (the entry is
// past t_max). With lim = min(prev(best_t), t_max or +inf where t_max < 0)
// (prev: the next float down) all three read min(exit, lim) < t_e. The
// check needs no margin, so skipping the faces after it is exact; it runs
// after every CHECK faces, and the warp stops only when every ray of every
// lane is settled (__all_sync over the full warp, in a loop whose trip
// count is the same for the whole warp).

#pragma once

#include <math.h>

#include "fp32_rn.cuh"

namespace collide2d {
namespace raycast {

constexpr unsigned kFullWarp = 0xffffffffu;

// One ray: origin and direction.
struct Ray {
  float ox, oy, dx, dy;
};

// A ray's window in the shape being clipped, and the face it entered by.
struct Window {
  float entry, exit;
  int face;
};

__device__ __forceinline__ Window open_window() {
  Window w;
  w.entry = -INFINITY;
  w.exit = INFINITY;
  w.face = 0;
  return w;
}

// Clip `w` by face j: the half-plane nx x + ny y <= off.
__device__ __forceinline__ void clip(float nx, float ny, float off, int j,
                                     const Ray& r, Window& w) {
  const float no = dot2(nx, r.ox, ny, r.oy);
  const float nd = dot2(nx, r.dx, ny, r.dy);
  const float num = __fsub_rn(off, no);  // constraint: t * nd <= num
  const bool parallel = nd == 0.0f;
  const float ratio = __fdiv_rn(num, parallel ? 1.0f : nd);
  if (nd < 0.0f && ratio > w.entry) {  // strict: the first max wins
    w.entry = ratio;
    w.face = j;
  }
  // nd == 0: ratio is num, negative exactly when the ray runs outside
  if (nd > 0.0f || (parallel && num < 0.0f)) w.exit = fminf(w.exit, ratio);
}

// Whether the window can no longer change the ray's result (see above).
__device__ __forceinline__ bool settled(const Window& w, float lim) {
  return fminf(w.exit, lim) < fmaxf(w.entry, 0.0f);
}

// lim for a ray whose best hit so far is best_t; tcap is t_max where
// t_max >= 0, else +inf.
__device__ __forceinline__ float settle_limit(float best_t, float tcap) {
  return fminf(nextafterf(best_t, -INFINITY), tcap);
}

// The R rays' windows in one shape whose faces (nx, ny, off, any-face) are
// `faces`: KP of them (KP > 0), or kp at run time (KP == 0, kp a multiple
// of 4). With CHECK > 0 the warp stops after a multiple of CHECK faces
// (of 4 when KP == 0) once every ray of the warp is settled against its
// `lim`. Returns the faces evaluated.
template <int KP, int R, int CHECK, typename Face>
__device__ __forceinline__ int shape_windows(const Face* faces, int kp,
                                             const Ray (&ray)[R],
                                             const float (&lim)[R],
                                             Window (&w)[R]) {
#pragma unroll
  for (int l = 0; l < R; ++l) w[l] = open_window();
  if (KP > 0) {
#pragma unroll
    for (int j = 0; j < KP; ++j) {
      const Face f = faces[j];
#pragma unroll
      for (int l = 0; l < R; ++l) clip(f.x, f.y, f.z, j, ray[l], w[l]);
      if (CHECK > 0 && (j + 1) % (CHECK > 0 ? CHECK : 1) == 0 && j + 1 < KP) {
        bool done = true;
#pragma unroll
        for (int l = 0; l < R; ++l) done = done && settled(w[l], lim[l]);
        if (__all_sync(kFullWarp, done)) return j + 1;
      }
    }
    return KP;
  }
  for (int j = 0; j < kp; j += 4) {
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const Face f = faces[j + u];
#pragma unroll
      for (int l = 0; l < R; ++l) clip(f.x, f.y, f.z, j + u, ray[l], w[l]);
    }
    if (CHECK > 0 && j + 4 < kp) {
      bool done = true;
#pragma unroll
      for (int l = 0; l < R; ++l) done = done && settled(w[l], lim[l]);
      if (__all_sync(kFullWarp, done)) return j + 4;
    }
  }
  return kp;
}

// The first-hit update after a shape's faces: a hit is entry <= exit, entry
// <= t_max, exit >= 0 and a shape with any face; t = max(entry, 0) replaces
// best_t on STRICT < (the first shape at the minimum wins), with the entry
// face, or -1 (a zero normal) for a ray that starts inside. Returns whether
// it did.
__device__ __forceinline__ bool take_shape(const Window& w, bool any_face,
                                           float t_max, int shape, float& best_t,
                                           int& best_i, int& best_f) {
  const bool hit = w.entry <= w.exit && w.entry <= t_max && w.exit >= 0.0f &&
                   any_face;
  const float t = fmaxf(w.entry, 0.0f);
  if (hit && t < best_t) {
    best_t = t;
    best_i = shape;
    best_f = w.entry < 0.0f ? -1 : w.face;
    return true;
  }
  return false;
}

}  // namespace raycast
}  // namespace collide2d
