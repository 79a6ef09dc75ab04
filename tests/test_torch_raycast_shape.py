"""Kernel 11's per-shape arithmetic (``csrc/raycast_shape.cuh``) on the host.

The header holds what kernel 11 does for one shape and the rays of one
thread: the window each face clips (the entering face's index carried, a
parallel face folded into the exit), the early exit once every ray is
settled, and the first-hit update. Here it is compiled with g++
(``__device__`` defined away, CUDA's rounded intrinsics as plain float
operations under ``-ffp-contract=off``, ``__all_sync`` as a switch: on, a
thread's rays stop as soon as they are all settled, as a warp whose lanes
all are; off, never) and driven over the shapes as the kernel drives it,
the winner's normal read back from the table. Held to
``ops/raycast_cuda.py::scene_raycast_plain`` bit for bit (t, index,
normal) at face counts 4, 8, 12 and 16, both through the face-count
specialised form and the generic one (12 only generic), one and two rays a
call, the exit after every 1, 2 or 4 faces and none, on scenes with
masked and empty shapes, rays that start inside a shape, rays along
faces, and t_max inf, 4, 0 and -1. The exit must skip faces where it is
on and a vote can come before the last face. It skips only where g++ is
absent.
"""

import shutil
import subprocess

import numpy as np
import pytest
import torch

from collide2d_tpu_torch.ops import raycast_cuda
from collide2d_tpu_torch.utils import cuda_build

torch.set_num_threads(1)

_PROGRAM = r"""
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <vector>
#include <math.h>

#define __host__
#define __device__
#define __forceinline__ inline

struct float4 { float x, y, z, w; };
static bool g_vote = true;
static inline bool __all_sync(unsigned, bool p) { return g_vote && p; }
static inline float __fmul_rn(float a, float b) { return a * b; }
static inline float __fadd_rn(float a, float b) { return a + b; }
static inline float __fsub_rn(float a, float b) { return a - b; }
static inline float __fdiv_rn(float a, float b) { return a / b; }

#include "raycast_shape.cuh"

using namespace collide2d::raycast;

// IN: int32 N, KP, R; float32 t_max; table (N, KP, 4); rays (R, 4).
// OUT: float32 t (R), int32 index (R), float32 normal (R, 2), uint64 faces
// evaluated.
template <int KP, int L, int CHECK>
static int run(FILE* in, FILE* out) {
  int hdr[3];
  float t_max;
  if (fread(hdr, 4, 3, in) != 3 || fread(&t_max, 4, 1, in) != 1) return 3;
  const int n = hdr[0], kp = hdr[1], r = hdr[2];
  if (KP > 0 && kp != KP) return 4;
  std::vector<float4> table(static_cast<size_t>(n) * kp);
  std::vector<Ray> rays(r);
  if (fread(table.data(), 16, table.size(), in) != table.size()) return 3;
  if (fread(rays.data(), 16, rays.size(), in) != rays.size()) return 3;
  std::vector<float> t(r), nrm(2 * r);
  std::vector<int> idx(r);
  unsigned long long faces = 0;
  const float tcap = t_max >= 0.0f ? t_max : INFINITY;
  for (int r0 = 0; r0 < r; r0 += L) {
    Ray ray[L];
    float best_t[L], lim[L];
    int best_i[L], best_f[L];
    bool live[L];
    for (int l = 0; l < L; ++l) {
      live[l] = r0 + l < r;
      ray[l] = live[l] ? rays[r0 + l] : Ray{0.0f, 0.0f, 0.0f, 0.0f};
      best_t[l] = INFINITY;
      best_i[l] = 0;
      best_f[l] = -1;
      lim[l] = live[l] ? fminf(3.402823466e38f, tcap) : -INFINITY;
    }
    for (int s = 0; s < n; ++s) {
      const float4* f = &table[static_cast<size_t>(s) * kp];
      Window w[L];
      const int done = shape_windows<KP, L, CHECK>(f, kp, ray, lim, w);
      faces += static_cast<unsigned long long>(done) * (live[0] + (L > 1 && live[L - 1]));
      if (CHECK > 0 && done < kp) continue;
      for (int l = 0; l < L; ++l) {
        if (take_shape(w[l], f[0].w > 0.0f, t_max, s, best_t[l], best_i[l], best_f[l]) &&
            CHECK > 0) {
          lim[l] = settle_limit(best_t[l], tcap);
        }
      }
    }
    for (int l = 0; l < L && r0 + l < r; ++l) {
      t[r0 + l] = best_t[l];
      idx[r0 + l] = best_i[l];
      const float4 g = best_f[l] >= 0 ? table[static_cast<size_t>(best_i[l]) * kp + best_f[l]]
                                      : float4{0.0f, 0.0f, 0.0f, 0.0f};
      nrm[2 * (r0 + l)] = g.x;
      nrm[2 * (r0 + l) + 1] = g.y;
    }
  }
  fwrite(t.data(), 4, r, out);
  fwrite(idx.data(), 4, r, out);
  fwrite(nrm.data(), 4, 2 * r, out);
  fwrite(&faces, 8, 1, out);
  return 0;
}

template <int KP, int L>
static int by_check(int check, FILE* in, FILE* out) {
  switch (check) {
    case 0: return run<KP, L, 0>(in, out);
    case 1: return run<KP, L, 1>(in, out);
    case 2: return run<KP, L, 2>(in, out);
    case 4: return run<KP, L, 4>(in, out);
  }
  return 2;
}

template <int KP>
static int by_lanes(int lanes, int check, FILE* in, FILE* out) {
  return lanes == 1 ? by_check<KP, 1>(check, in, out) : by_check<KP, 2>(check, in, out);
}

// argv: KP (0 = generic) lanes check vote in out
int main(int argc, char** argv) {
  if (argc != 7) return 2;
  const int kp = atoi(argv[1]), lanes = atoi(argv[2]), check = atoi(argv[3]);
  g_vote = atoi(argv[4]) != 0;
  FILE* in = fopen(argv[5], "rb");
  FILE* out = fopen(argv[6], "wb");
  int rc = 2;
  switch (kp) {
    case 0: rc = by_lanes<0>(lanes, check, in, out); break;
    case 4: rc = by_lanes<4>(lanes, check, in, out); break;
    case 8: rc = by_lanes<8>(lanes, check, in, out); break;
    case 16: rc = by_lanes<16>(lanes, check, in, out); break;
  }
  fclose(in);
  fclose(out);
  return rc;
}
"""


@pytest.fixture(scope="module")
def shape_program(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to compile csrc/raycast_shape.cuh on the host")
    work = tmp_path_factory.mktemp("raycast_shape")
    src = work / "raycast_shape_host.cc"
    src.write_text(_PROGRAM)
    exe = work / "raycast_shape_host"
    subprocess.run([gxx, "-O2", "-std=c++17", "-ffp-contract=off", "-I",
                    str(cuda_build.CSRC_DIR), "-o", str(exe), str(src)], check=True,
                   capture_output=True, timeout=300)
    return exe


def _scene(rng, n, k):
    """n convex shapes of up to k vertices (regular polygons, some masked
    down to 3..k vertices, one down to a single point, and a few axis-aligned
    squares when k >= 4) in a 30-side box, and their mask."""
    centre = rng.uniform(-15, 15, (n, 1, 2))
    radius = rng.uniform(0.5, 4.0, (n, 1, 1))
    ang = rng.uniform(0, 2 * np.pi, (n, 1)) + 2 * np.pi * np.arange(k) / k
    polys = centre + radius * np.stack([np.cos(ang), np.sin(ang)], -1)
    if k >= 4:  # squares with axis-aligned faces, for rays along a face
        sq = np.array([[-1, -1], [1, -1], [1, 1], [-1, 1]] + [[-1, 1]] * (k - 4), float)
        polys[:4] = centre[:4] + radius[:4] * sq
    keep = rng.integers(3, k + 1, (n, 1))
    keep[:4] = 4 if k >= 4 else k
    keep[4] = 1  # a point: no face, never hit
    mask = np.arange(k)[None] < keep
    return polys.astype(np.float32), mask


def _rays(rng, polys, r):
    """r rays: origins across the box, some at shape centres (inside
    starts), some along the squares' faces; directions standard normal, the
    axis-aligned ones exact."""
    o = rng.uniform(-20, 20, (r, 2))
    d = rng.normal(size=(r, 2))
    inside = rng.integers(0, polys.shape[0], r // 8)
    o[: r // 8] = polys[inside, :3].mean(1)
    m = r // 16
    o[r // 8: r // 8 + m] = polys[np.arange(m) % 4, 0] + [0.0, 0.0]  # on a corner
    d[r // 8: r // 8 + m] = [[1.0, 0.0], [0.0, 1.0], [-1.0, 0.0], [0.0, -1.0]][0]
    o[r // 8 + m: r // 8 + 2 * m, 1] = polys[np.arange(m) % 4, 2, 1] + 0.25  # above a square
    d[r // 8 + m: r // 8 + 2 * m] = [1.0, 0.0]
    return o.astype(np.float32), d.astype(np.float32)


def _run(program, tmp_path, table, o, d, t_max, kp_build, lanes, check, vote):
    n, kp = table.shape[0], table.shape[1]
    r = o.shape[0]
    inp, out = tmp_path / "in.bin", tmp_path / "out.bin"
    with open(inp, "wb") as f:
        np.array([n, kp, r], np.int32).tofile(f)
        np.array([t_max], np.float32).tofile(f)
        table.numpy().astype(np.float32).tofile(f)
        np.concatenate([o, d], 1).astype(np.float32).tofile(f)
    subprocess.run([str(program), str(kp_build), str(lanes), str(check), str(int(vote)),
                    str(inp), str(out)], check=True, timeout=120)
    raw = np.fromfile(out, np.uint8)
    assert raw.size == 16 * r + 8
    t = torch.from_numpy(raw[:4 * r].view(np.float32).copy())
    idx = torch.from_numpy(raw[4 * r:8 * r].view(np.int32).copy())
    nrm = torch.from_numpy(raw[8 * r:16 * r].view(np.float32).copy()).view(r, 2)
    return (t, idx, nrm), int(raw[16 * r:].view(np.uint64)[0])


@pytest.mark.parametrize("k,kp_build", [(4, 4), (4, 0), (7, 8), (8, 8), (8, 0),
                                        (11, 0), (12, 0), (16, 16), (13, 16)])
def test_shapes_are_the_plain_raycast_bit_for_bit(shape_program, tmp_path, k, kp_build):
    rng = np.random.default_rng(10 * k + kp_build)
    polys, mask = _scene(rng, 40, k)
    table = raycast_cuda.pack_scene_tables(torch.from_numpy(polys), torch.from_numpy(mask))
    assert table.shape[1] == max(kp_build, -(-k // 4) * 4)
    o, d = _rays(rng, polys, 301)  # odd: the last ray of a pair goes alone
    for t_max in (np.inf, 4.0, 0.0, -1.0):
        want = raycast_cuda.scene_raycast_plain(torch.from_numpy(o), torch.from_numpy(d),
                                                table, t_max=t_max)
        if t_max == np.inf:
            hit = torch.isfinite(want[0])
            assert 0 < int(hit.sum()) < o.shape[0]
            assert int((want[0] == 0).sum()) > 0  # inside starts
        faces = {}
        for lanes in (1, 2):
            for check in (0, 1, 2, 4):
                for vote in (False, True):
                    got, faces[lanes, check, vote] = _run(
                        shape_program, tmp_path, table, o, d, t_max, kp_build, lanes,
                        check, vote)
                    for a, b in zip(got, want):
                        assert torch.equal(a, b), (t_max, lanes, check, vote)
        every = o.shape[0] * table.shape[0] * table.shape[1]
        assert faces[2, 0, True] == faces[1, 2, False] == every
        if kp_build or table.shape[1] > 4:  # the generic form votes after 4, 8, ...
            assert faces[1, 1, True] < every


def test_rays_along_faces_and_parallel_outside(shape_program, tmp_path):
    # an axis-aligned square: rays along its top face (num == 0), inside
    # its slab and outside it (num < 0: the window empties) in both senses
    sq = np.float32([[[0, 0], [2, 0], [2, 2], [0, 2]]])
    table = raycast_cuda.pack_scene_tables(torch.from_numpy(sq))
    o = np.float32([[-1, 2], [-1, 1], [-1, 3], [3, 1], [3, 2.5], [1, 1], [-1, 0]])
    d = np.float32([[1, 0], [1, 0], [1, 0], [-1, 0], [-1, 0], [0, 1], [1, 0]])
    want = raycast_cuda.scene_raycast_plain(torch.from_numpy(o), torch.from_numpy(d), table)
    assert torch.isfinite(want[0]).tolist() == [True, True, False, True, False, True, True]
    for kp_build in (4, 0):
        for check in (0, 1):
            got, _ = _run(shape_program, tmp_path, table, o, d, np.inf, kp_build, 2,
                          check, True)
            for a, b in zip(got, want):
                assert torch.equal(a, b)
