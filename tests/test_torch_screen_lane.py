"""Kernel 15's lane arithmetic (``csrc/screen_lane.cuh``) on the host.

The header holds everything kernel 15 computes but its cos/sin: the
configuration's scalars, each segment's shared values, and the lanes. Here
it is compiled with g++ (``__device__`` defined away, CUDA's rounded
intrinsics ``__fmul_rn``, ``__fadd_rn``, ``__fsub_rn`` and ``__fdiv_rn`` as
plain float operations under ``-ffp-contract=off``), given the cos/sin torch
computes for the angles the plain version forms, and held to
``ops/screen_cuda.py::rotating_screen_plain`` bit for bit: flags and warm
starts of every lane, at segment counts 1 to 32 (odd ones among them),
with one and with two lanes a call (the kernel's), on lane counts that are
not a multiple of two. The angles the header forms (the segments' midpoint
angles, delta's sine argument, the draw's angle offset) must equal torch's
bit for bit too, so the cos/sin handed in are the ones the kernel's would
be. It skips only where g++ is absent.
"""

import math
import shutil
import subprocess

import numpy as np
import pytest
import torch

from collide2d_tpu_torch.mc import moving
from collide2d_tpu_torch.ops import screen_cuda
from collide2d_tpu_torch.utils import cuda_build

torch.set_num_threads(1)

ROBOT = (4.07, 1.74)
SEGMENTS = (1, 3, 7, 8, 32)

_PROGRAM = r"""
#include <cstdio>
#include <cstdlib>
#include <vector>
#include <math.h>

#define __host__
#define __device__
#define __forceinline__ inline

static inline float __fmul_rn(float a, float b) { return a * b; }
static inline float __fadd_rn(float a, float b) { return a + b; }
static inline float __fsub_rn(float a, float b) { return a - b; }
static inline float __fdiv_rn(float a, float b) { return a / b; }

#include "screen_lane.cuh"

using namespace collide2d::screen;

static std::vector<float> take(FILE* f, size_t n) {
  std::vector<float> v(n);
  if (fread(v.data(), sizeof(float), n, f) != n) exit(3);
  return v;
}

// IN: int32 C, S, then float32 params (C, 16), cm and sm (C, NSEG), c1, s1,
// sin_delta (C), tol, pi, z (C, S, 5), c2 and s2 (C, S).
// OUT: float32 segment angles (C, NSEG), delta angles (C), lane angles
// (C, S), int32 flags (C, S), float32 t0 (C, S).
template <int NSEG>
static int run(int lanes_a_call, FILE* in, FILE* out) {
  int cs[2];
  if (fread(cs, sizeof(int), 2, in) != 2) return 3;
  const int C = cs[0], S = cs[1];
  const auto params = take(in, C * 16L), cm = take(in, C * NSEG), sm = take(in, C * NSEG);
  const auto c1 = take(in, C), s1 = take(in, C), sin_delta = take(in, C);
  const auto scal = take(in, 2);
  const auto z = take(in, C * S * 5L), c2 = take(in, C * (long)S), s2 = take(in, C * (long)S);
  std::vector<float> thm(C * NSEG), darg(C), lang(C * (long)S), t0(C * (long)S);
  std::vector<int> flags(C * (long)S);
  for (int c = 0; c < C; ++c) {
    const float* p = &params[c * 16L];
    ScreenConfig q;
    set_row_scalars(q, p);
    set_rotation(q, p, c1[c], s1[c]);
    set_radii(q, p, sin_delta[c], scal[0]);
    ScreenSegment seg[NSEG];
    for (int i = 0; i < NSEG; ++i) {
      thm[c * NSEG + i] = segment_angle<NSEG>(p, i);
      seg[i] = screen_segment<NSEG>(p, cm[c * NSEG + i], sm[c * NSEG + i], i);
    }
    darg[c] = delta_angle<NSEG>(p, scal[1]);
    for (int s = 0; s < S;) {
      const long lane = c * (long)S + s;
      if (lanes_a_call == 2 && s + 1 < S) {
        float zz[2][5], cc[2], ss[2], tt[2];
        int ff[2];
        for (int l = 0; l < 2; ++l) {
          for (int k = 0; k < 5; ++k) zz[l][k] = z[(lane + l) * 5 + k];
          cc[l] = c2[lane + l];
          ss[l] = s2[lane + l];
          lang[lane + l] = lane_angle(q, zz[l][2]);
        }
        screen_lanes<NSEG, 2>(q, seg, zz, cc, ss, ff, tt);
        for (int l = 0; l < 2; ++l) {
          flags[lane + l] = ff[l];
          t0[lane + l] = tt[l];
        }
        s += 2;
      } else {
        float zz[1][5], cc[1] = {c2[lane]}, ss[1] = {s2[lane]}, tt[1];
        int ff[1];
        for (int k = 0; k < 5; ++k) zz[0][k] = z[lane * 5 + k];
        lang[lane] = lane_angle(q, zz[0][2]);
        screen_lanes<NSEG, 1>(q, seg, zz, cc, ss, ff, tt);
        flags[lane] = ff[0];
        t0[lane] = tt[0];
        s += 1;
      }
    }
  }
  fwrite(thm.data(), sizeof(float), thm.size(), out);
  fwrite(darg.data(), sizeof(float), darg.size(), out);
  fwrite(lang.data(), sizeof(float), lang.size(), out);
  fwrite(flags.data(), sizeof(int), flags.size(), out);
  fwrite(t0.data(), sizeof(float), t0.size(), out);
  return 0;
}

int main(int argc, char** argv) {
  if (argc != 5) return 2;
  const int nseg = atoi(argv[1]), lanes = atoi(argv[2]);
  FILE* in = fopen(argv[3], "rb");
  FILE* out = fopen(argv[4], "wb");
  int rc = 2;
  switch (nseg) {
    case 1: rc = run<1>(lanes, in, out); break;
    case 3: rc = run<3>(lanes, in, out); break;
    case 7: rc = run<7>(lanes, in, out); break;
    case 8: rc = run<8>(lanes, in, out); break;
    case 32: rc = run<32>(lanes, in, out); break;
  }
  fclose(in);
  fclose(out);
  return rc;
}
"""


@pytest.fixture(scope="module")
def lane_program(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to compile csrc/screen_lane.cuh on the host")
    work = tmp_path_factory.mktemp("screen_lane")
    src = work / "screen_lane_host.cc"
    src.write_text(_PROGRAM)
    exe = work / "screen_lane_host"
    subprocess.run([gxx, "-O2", "-std=c++17", "-ffp-contract=off", "-I",
                    str(cuda_build.CSRC_DIR), "-o", str(exe), str(src)], check=True,
                   capture_output=True, timeout=300)
    return exe


def _configs(seed, c, omega_scale):
    rng = np.random.default_rng(seed)
    rows = [np.asarray(a, np.float32) for a in (
        rng.uniform(-6, 6, (c, 2)), rng.uniform(0, 2 * np.pi, c),
        rng.uniform(0.5, 5, (c, 2)), rng.uniform(0, 0.4, (c, 5)),
        rng.uniform(-3, 3, (c, 2)), rng.uniform(-1, 1, c) * omega_scale,
        rng.uniform(0.5, 3, c))]
    rows[5][::7] = 0.0  # some rows translate only
    return screen_cuda.pack_screen_params(moving.moving_configs(*rows), ROBOT)


def _run(program, tmp_path, params, z, n_seg, lanes_a_call, tol=1e-4):
    """The header's outputs on these inputs, with torch's cos/sin."""
    c, s = z.shape[0], z.shape[1]
    th0, w = params[:, 11:12], params[:, 12:13]
    ii = torch.arange(n_seg, dtype=torch.float32)
    thm = th0 + (ii + 0.5) * (w * (1.0 / n_seg))  # as _paired_segment_screen
    darg = torch.clamp(w.abs() * (0.5 / n_seg), max=np.float32(math.pi)) * 0.5
    d2 = z[..., 2] * params[:, 2:3]
    inp, out = tmp_path / f"in{n_seg}.bin", tmp_path / f"out{n_seg}.bin"
    with open(inp, "wb") as f:
        np.array([c, s], np.int32).tofile(f)
        for a in (params, torch.cos(thm), torch.sin(thm), torch.cos(th0), torch.sin(th0),
                  torch.sin(darg), torch.tensor([tol, math.pi]), z, torch.cos(d2),
                  torch.sin(d2)):
            np.ascontiguousarray(a.numpy(), np.float32).tofile(f)
    subprocess.run([str(program), str(n_seg), str(lanes_a_call), str(inp), str(out)],
                   check=True, timeout=120)
    raw = np.fromfile(out, np.uint8)
    sizes = [c * n_seg, c, c * s, c * s, c * s]
    parts, at = [], 0
    for n, dt in zip(sizes, (np.float32, np.float32, np.float32, np.int32, np.float32)):
        parts.append(torch.from_numpy(raw[at:at + 4 * n].view(dt).copy()))
        at += 4 * n
    assert at == raw.size
    got_thm, got_darg, got_d2, flags, t0 = parts
    assert torch.equal(got_thm.view(c, n_seg), thm)
    assert torch.equal(got_darg, darg[:, 0])
    assert torch.equal(got_d2.view(c, s), d2)
    return flags.view(c, s), t0.view(c, s)


@pytest.mark.parametrize("lanes_a_call", [1, 2])
@pytest.mark.parametrize("n_seg", SEGMENTS)
def test_lanes_are_the_plain_screen_bit_for_bit(lane_program, tmp_path, n_seg,
                                                lanes_a_call):
    c, s = 48, 37  # an odd lane count: the last lane goes alone
    params = _configs(n_seg, c, omega_scale=2.0)
    gen = torch.Generator().manual_seed(100 + n_seg)
    z = torch.randn((c, s, 5), generator=gen)
    flags, t0 = _run(lane_program, tmp_path, params, z, n_seg, lanes_a_call)
    want_f, want_t = screen_cuda.rotating_screen_plain(z, params, n_seg=n_seg)
    assert torch.equal(flags, want_f)
    assert torch.equal(t0, want_t)
    for bit in (1, 2, 4):
        assert 0 < int(((want_f & bit) != 0).sum()) < c * s
    # lanes whose warm start is a segment's start, and lanes with none
    assert bool((want_t < 1).any()) and bool((want_t == 2).any())


def test_fast_spin_erodes_to_the_inscribed_square(lane_program, tmp_path):
    # omega large enough that delta exceeds the robot's half extent: the
    # eroded proxy becomes the inscribed square (set_radii's other branch)
    c, s, n_seg = 32, 16, 8
    params = _configs(3, c, omega_scale=40.0)
    w = params[:, 12]
    delta = 2 * params[:, 15] * torch.sin(torch.clamp(w.abs() * (0.5 / n_seg),
                                                      max=np.float32(math.pi)) * 0.5)
    assert bool((delta >= torch.minimum(params[:, 13], params[:, 14])).any())
    z = torch.randn((c, s, 5), generator=torch.Generator().manual_seed(7))
    flags, t0 = _run(lane_program, tmp_path, params, z, n_seg, 2)
    want_f, want_t = screen_cuda.rotating_screen_plain(z, params, n_seg=n_seg)
    assert torch.equal(flags, want_f) and torch.equal(t0, want_t)
