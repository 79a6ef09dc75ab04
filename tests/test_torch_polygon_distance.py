"""Kernel 9's per-pair arithmetic (``csrc/polygon_distance.cuh``) on the host.

The header holds what kernel 9 computes for one pair: the early test on
polygon 1's first edge normals (`edge_separates`), the full support gap
over every edge normal (`support_gap`) and the vertex-segment minimum
(`separation_d2`). Here it is compiled with g++ (``__device__`` defined
away, CUDA's rounded intrinsics as plain float operations under
``-ffp-contract=off``, the saturating multiply as its clamp) and driven as
the kernel drives a pair: a pair the early test settles takes ``sqrt(d2)``
alone, any other its gap first and ``sqrt(d2)`` only when the gap is not
below 0. Held to ``ops/distance_cuda.py::polygon_distance_plain`` bit for
bit at every (K1, K2) bucket pair of 4, 8 and 16 and at vertex counts that
pad (zero-length edges), on batches that mix overlapping and separated
pairs, that all overlap and that are all separated; every pair the early
test settles must have a gap that is not below 0, and the test must settle
most separated pairs. It skips only where g++ is absent.
"""

import shutil
import subprocess

import numpy as np
import pytest
import torch

from collide2d_tpu_torch.ops import distance_cuda, polygon_cuda
from collide2d_tpu_torch.utils import cuda_build

torch.set_num_threads(1)

_PROGRAM = r"""
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <unordered_map>
#include <vector>
#include <math.h>

#define __host__
#define __device__
#define __forceinline__ inline

static inline float __fmul_rn(float a, float b) { return a * b; }
static inline float __fadd_rn(float a, float b) { return a + b; }
static inline float __fsub_rn(float a, float b) { return a - b; }
static inline float __fdiv_rn(float a, float b) { return a / b; }
// torch's square roots of the values the header takes them of
static std::unordered_map<uint32_t, float> g_sqrt;
static inline float __fsqrt_rn(float a) {
  uint32_t bits;
  memcpy(&bits, &a, 4);
  const auto it = g_sqrt.find(bits);
  if (it == g_sqrt.end()) exit(5);
  return it->second;
}

#include "polygon_distance.cuh"

using namespace collide2d::polydist;

// IN: int32 N, int32 S; S float32 values and S float32 square roots;
// polygon 1 (N, K1, 2), polygon 2 (N, K2, 2), each padded to its bucket.
// OUT: float32 gap or d2 (N), uint8 whether it is the gap (N), uint8
// settled early (N), float32 full gap (N).
template <int K1, int K2>
static int run(FILE* in, FILE* out) {
  int n, s;
  if (fread(&n, 4, 1, in) != 1 || fread(&s, 4, 1, in) != 1) return 3;
  std::vector<uint32_t> keys(s);
  std::vector<float> roots(s);
  if (fread(keys.data(), 4, s, in) != static_cast<size_t>(s)) return 3;
  if (fread(roots.data(), 4, s, in) != static_cast<size_t>(s)) return 3;
  for (int i = 0; i < s; ++i) g_sqrt[keys[i]] = roots[i];
  std::vector<float> a(static_cast<size_t>(n) * K1 * 2), b(static_cast<size_t>(n) * K2 * 2);
  if (fread(a.data(), 4, a.size(), in) != a.size()) return 3;
  if (fread(b.data(), 4, b.size(), in) != b.size()) return 3;
  std::vector<float> value(n), gaps(n);
  std::vector<unsigned char> is_gap(n), early(n);
  for (int p = 0; p < n; ++p) {
    float x1[K1], y1[K1], x2[K2], y2[K2];
    for (int i = 0; i < K1; ++i) {
      x1[i] = a[(static_cast<size_t>(p) * K1 + i) * 2];
      y1[i] = a[(static_cast<size_t>(p) * K1 + i) * 2 + 1];
    }
    for (int i = 0; i < K2; ++i) {
      x2[i] = b[(static_cast<size_t>(p) * K2 + i) * 2];
      y2[i] = b[(static_cast<size_t>(p) * K2 + i) * 2 + 1];
    }
    const bool sep = edge_separates<K1, K2>(x1, y1, x2, y2);
    const float gap = support_gap<K1, K2>(x1, y1, x2, y2);
    early[p] = sep;
    gaps[p] = gap;
    is_gap[p] = !sep && gap < 0.0f;
    value[p] = is_gap[p] ? gap : separation_d2<K1, K2>(x1, y1, x2, y2);
  }
  fwrite(value.data(), 4, n, out);
  fwrite(is_gap.data(), 1, n, out);
  fwrite(early.data(), 1, n, out);
  fwrite(gaps.data(), 4, n, out);
  return 0;
}

template <int K1>
static int by_k2(int k2, FILE* in, FILE* out) {
  switch (k2) {
    case 4: return run<K1, 4>(in, out);
    case 8: return run<K1, 8>(in, out);
    case 16: return run<K1, 16>(in, out);
  }
  return 2;
}

// argv: K1 K2 (buckets) in out
int main(int argc, char** argv) {
  if (argc != 5) return 2;
  const int k1 = atoi(argv[1]), k2 = atoi(argv[2]);
  FILE* in = fopen(argv[3], "rb");
  FILE* out = fopen(argv[4], "wb");
  int rc = 2;
  switch (k1) {
    case 4: rc = by_k2<4>(k2, in, out); break;
    case 8: rc = by_k2<8>(k2, in, out); break;
    case 16: rc = by_k2<16>(k2, in, out); break;
  }
  fclose(in);
  fclose(out);
  return rc;
}
"""


@pytest.fixture(scope="module")
def pair_program(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to compile csrc/polygon_distance.cuh on the host")
    work = tmp_path_factory.mktemp("polygon_distance")
    src = work / "polygon_distance_host.cc"
    src.write_text(_PROGRAM)
    exe = work / "polygon_distance_host"
    subprocess.run([gxx, "-O2", "-std=c++17", "-ffp-contract=off", "-I",
                    str(cuda_build.CSRC_DIR), "-o", str(exe), str(src)], check=True,
                   capture_output=True, timeout=300)
    return exe


def _bucket(k: int) -> int:
    return 4 if k <= 4 else 8 if k <= 8 else 16


def _polygons(rng, n, k, side):
    """n regular k-gons of radius U(0.5, 1) at a random rotation, centres
    U(0, side)^2 (the JAX bench's k-gons at side 10), a few with a vertex
    repeated (a zero-length edge inside the polygon)."""
    c = rng.uniform(0, side, (n, 1, 2))
    r = rng.uniform(0.5, 1.0, (n, 1, 1))
    ang = rng.uniform(0, 2 * np.pi, (n, 1)) + 2 * np.pi * np.arange(k) / k
    polys = c + r * np.stack([np.cos(ang), np.sin(ang)], -1)
    if k >= 4:
        polys[: n // 16, 1] = polys[: n // 16, 0]
    return polys.astype(np.float32)


def _edge_norms(p: torch.Tensor) -> torch.Tensor:
    """|normal|^2 of every edge of padded (N, K, 2) polygons, as the plain
    version forms them."""
    q = torch.roll(p, -1, dims=1)
    ax, ay = q[..., 1] - p[..., 1], p[..., 0] - q[..., 0]
    return ax * ax + ay * ay


def _run(program, tmp_path, a, b):
    """The header's (distance, settled early, gap) on repeat-padded inputs,
    its square roots torch's (the plain version's, which on the CPU may
    differ from IEEE's by an ulp): the header's scales take them from a
    table of torch's roots of the edges' |normal|^2, and the distance of a
    separated pair is torch's root of the header's d2."""
    n, k1, k2 = a.shape[0], _bucket(a.shape[1]), _bucket(b.shape[1])
    pa = polygon_cuda.pad_polygons(torch.from_numpy(a), k1)
    pb = polygon_cuda.pad_polygons(torch.from_numpy(b), k2)
    keys = torch.unique(torch.cat([_edge_norms(pa).reshape(-1), _edge_norms(pb).reshape(-1),
                                   torch.ones(1)]))
    inp, out = tmp_path / "in.bin", tmp_path / "out.bin"
    with open(inp, "wb") as f:
        np.array([n, keys.numel()], np.int32).tofile(f)
        keys.numpy().view(np.uint32).tofile(f)
        torch.sqrt(keys).numpy().tofile(f)
        pa.numpy().astype(np.float32).tofile(f)
        pb.numpy().astype(np.float32).tofile(f)
    subprocess.run([str(program), str(k1), str(k2), str(inp), str(out)], check=True,
                   timeout=120)
    raw = np.fromfile(out, np.uint8)
    assert raw.size == 10 * n
    value = torch.from_numpy(raw[: 4 * n].view(np.float32).copy())
    is_gap = torch.from_numpy(raw[4 * n: 5 * n].astype(bool))
    early = torch.from_numpy(raw[5 * n: 6 * n].astype(bool))
    gap = torch.from_numpy(raw[6 * n:].view(np.float32).copy())
    return torch.where(is_gap, value, torch.sqrt(value)), early, gap


def _plain(a, b):
    n = a.shape[0]
    pad = -(-n // 8) * 8
    ta = torch.from_numpy(np.concatenate([a, np.repeat(a[-1:], pad - n, 0)]))
    tb = torch.from_numpy(np.concatenate([b, np.repeat(b[-1:], pad - n, 0)]))
    out = distance_cuda.polygon_distance_plain(polygon_cuda.pack_polygons(ta),
                                               polygon_cuda.pack_polygons(tb),
                                               a.shape[1], b.shape[1])
    return out.reshape(-1)[:n]


@pytest.mark.parametrize("k1,k2", [(4, 4), (4, 8), (4, 16), (8, 4), (8, 8), (8, 16),
                                   (16, 4), (16, 8), (16, 16), (3, 5), (6, 12), (8, 13)])
def test_pairs_are_the_plain_distance_bit_for_bit(pair_program, tmp_path, k1, k2):
    rng = np.random.default_rng(100 * k1 + k2)
    n = 3001
    a, b = _polygons(rng, n, k1, 10.0), _polygons(rng, n, k2, 10.0)
    got, early, gap = _run(pair_program, tmp_path, a, b)
    want = _plain(a, b)
    assert torch.equal(got, want)
    overlap = want < 0
    assert 0 < int(overlap.sum()) < n
    assert not bool((early & (gap < 0)).any())  # the early test is never wrong
    # it settles most separated pairs (0.9865 of them on the bench's 8-gons)
    assert float(early.float().sum()) >= 0.9 * float((~overlap).float().sum())


@pytest.mark.parametrize("side,overlapping", [(0.0, True), (1000.0, False)])
@pytest.mark.parametrize("k1,k2", [(8, 8), (4, 16)])
def test_all_overlapping_and_all_separated_batches(pair_program, tmp_path, side,
                                                   overlapping, k1, k2):
    rng = np.random.default_rng(7 + k1 + int(side))
    n = 1024
    a, b = _polygons(rng, n, k1, side), _polygons(rng, n, k2, side)
    got, early, _ = _run(pair_program, tmp_path, a, b)
    want = _plain(a, b)
    assert torch.equal(got, want)
    assert bool((want < 0).all()) == overlapping
    assert bool((want > 0).all()) == (not overlapping)
    assert int(early.sum()) == (0 if overlapping else n)


def test_degenerate_pairs(pair_program, tmp_path):
    # a point against a square, a segment touching a square's corner, two
    # polygons sharing an edge, and two identical triangles
    sq = [[0, 0], [2, 0], [2, 2], [0, 2]]
    a = np.float32([[[5, 5]] * 4, [[2, 2], [3, 3], [3, 3], [3, 3]], sq,
                    [[0, 0], [1, 0], [0, 1], [0, 1]]])
    b = np.float32([sq, sq, [[2, 0], [4, 0], [4, 2], [2, 2]],
                    [[0, 0], [1, 0], [0, 1], [0, 1]]])
    got, _, _ = _run(pair_program, tmp_path, a, b)
    want = _plain(a, b)
    assert torch.equal(got, want)
    assert float(want[1]) == 0.0 and float(want[3]) < 0
