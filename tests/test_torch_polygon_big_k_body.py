"""Kernels 6, 9 and 10 above 16 vertices: their run-time-K bodies on the host.

``csrc/polygon_big_k.cuh`` holds what kernels 6 (k-gon SAT labels), 9
(signed distances) and 10 (contact manifolds) compute for one pair when
either polygon has more than 16 vertices: loops over the true K1 and K2,
axes, segments and faces in register blocks, the vertices read through a
pointer-and-stride view (a shared-memory tile of P pairs on the card, or
the planes in device memory). Here it is compiled with g++ (``__device__``
defined away, CUDA's rounded intrinsics as plain float operations under
``-ffp-contract=off``, the saturating multiply as its clamp, bf16 as its 16
high bits) and driven through both views: the tile as the kernels stage it
(`polygon_cuda.tile_pairs` pairs a block, planes [plane][pair]) and the
packed planes themselves; kernel 9's pairs as the kernel takes them (its
first pass, every axis where that does not settle the pair, the segment
tests where the gap is not below 0). On packed rows that numpy makes from a
seed, the labels are held bit for bit to ``sat_polygons_plain`` (float32
and bf16-rounded planes; kernel 6's first pass to
``chip_smoke.sat_first_pass``, the count of the work it leaves), the
distances to ``polygon_distance_plain`` (which pads to the K bucket; kernel
9's first pass to a numpy version of its 8 normals and to
``chip_smoke.distance_first_pass``) and the manifolds to
``polygon_manifold_plain`` (every output's bits, margins 0 and 0.1), at
(K1, K2) = (4, 17), (4, 20), (20, 20), (32, 32), (4, 64) and (17, 4), and on
degenerate polygons (one and two vertices, repeated consecutive vertices);
kernel 9 also on a normal whose |n|^2 underflows to 0 (which its first pass
must not take as proof of separation, as kernel 6's test would) and on
pairs where the padding's point distance to a polygon's last vertex is the
strict minimum (found by a seeded search here: the body must take it). The
header's tile rule (`tile_pairs`) is the wrapper's. It skips only where g++
is absent. The wrappers of kernels 6, 9 and 10 load one library for every
K.

This is the only place the new loop order runs before the card:
tests/test_torch_gpu.py and ``chip_smoke.py`` phase 24 hold the kernels to
the same plain versions there.
"""

import inspect
import shutil
import subprocess
import types

import numpy as np
import pytest
import torch

import chip_smoke
from collide2d_tpu_torch.ops import distance_cuda, manifold_cuda, polygon_cuda
from collide2d_tpu_torch.utils import cuda_build

# The suite runs one xdist worker per core: one torch thread each keeps
# the workers from oversubscribing the host.
torch.set_num_threads(1)

_PROGRAM = r"""
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <unordered_map>
#include <vector>
#include <math.h>

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
struct __nv_bfloat16 {
  uint16_t bits;
};
static inline float __bfloat162float(__nv_bfloat16 v) {
  const uint32_t u = static_cast<uint32_t>(v.bits) << 16;
  float f;
  memcpy(&f, &u, 4);
  return f;
}

#include "polygon_big_k.cuh"

using namespace collide2d::big_k;

// Every pair through the tile the kernels stage ([plane][pair], P pairs a
// block, polygon 2's planes after polygon 1's), or through the packed
// planes (P == 0).
template <int P, typename T, class Fn>
static void each_pair(const std::vector<T>& a, const std::vector<T>& b, long long n,
                      int k1, int k2, Fn fn) {
  if constexpr (P == 0) {
    for (long long p = 0; p < n; ++p)
      fn(p, Polygon<T, 0>{a.data() + p, n, k1}, Polygon<T, 0>{b.data() + p, n, k2});
  } else {
    std::vector<T> tile(static_cast<size_t>(2 * (k1 + k2)) * P);
    for (long long p0 = 0; p0 < n; p0 += P) {
      for (int c = 0; c < 2 * k1; ++c)
        for (int q = 0; q < P && p0 + q < n; ++q) tile[c * P + q] = a[c * n + p0 + q];
      for (int c = 0; c < 2 * k2; ++c)
        for (int q = 0; q < P && p0 + q < n; ++q)
          tile[(2 * k1 + c) * P + q] = b[c * n + p0 + q];
      for (int t = 0; t < P && p0 + t < n; ++t)
        fn(p0 + t, Polygon<T, P>{tile.data() + t, 0, k1},
           Polygon<T, P>{tile.data() + 2 * k1 * P + t, 0, k2});
    }
  }
}

template <typename T, class Fn>
static void each_pair(const std::vector<T>& a, const std::vector<T>& b, long long n,
                      int k1, int k2, int pairs, Fn fn) {
  switch (pairs) {
    case 128: return each_pair<128>(a, b, n, k1, k2, fn);
    case 64: return each_pair<64>(a, b, n, k1, k2, fn);
    case 32: return each_pair<32>(a, b, n, k1, k2, fn);
    case 0: return each_pair<0>(a, b, n, k1, k2, fn);
  }
  exit(4);
}

template <typename T>
static bool read(FILE* in, std::vector<T>& v, size_t count) {
  v.resize(count);
  return fread(v.data(), sizeof(T), count, in) == count;
}

// argv: mode (sat | sat_first | sat_bf16 | manifold | dist | dist_unpadded |
// tile_pairs) k1 k2 n pairs margin in out
// IN: int32 S, S float32 values and their S float32 square roots, then the
// (2 k1, n) and (2 k2, n) planes (float32, or bf16 bits for sat_bf16).
// OUT: float32 labels (n; sat_first: 1 where kernel 6's first pass
// separates the pair), the 9 float32 manifold planes (9, n), or kernel 9's
// (3, n): the gap where the pair overlaps else d2, 1 where that is the gap,
// 1 where the first pass settles the pair (dist_unpadded: without the
// padding's point distances).
int main(int argc, char** argv) {
  const char* mode = argv[1];
  if (!strcmp(mode, "tile_pairs")) {  // argv: tile_pairs max_k
    const int top = atoi(argv[2]);
    for (int e : {2, 4})
      for (int k1 = 1; k1 <= top; ++k1)
        for (int k2 = 1; k2 <= top; k2 += 7)
          printf("%d %d %d %d\n", e, k1, k2, tile_pairs(k1, k2, e));
    return 0;
  }
  if (argc != 9) return 2;
  const int k1 = atoi(argv[2]), k2 = atoi(argv[3]);
  const long long n = atoll(argv[4]);
  const int pairs = atoi(argv[5]);
  const float margin = static_cast<float>(atof(argv[6]));
  FILE* in = fopen(argv[7], "rb");
  FILE* out = fopen(argv[8], "wb");
  int s;
  std::vector<uint32_t> keys;
  std::vector<float> roots;
  if (fread(&s, 4, 1, in) != 1 || !read(in, keys, s) || !read(in, roots, s)) return 3;
  for (int i = 0; i < s; ++i) g_sqrt[keys[i]] = roots[i];
  if (!strcmp(mode, "sat_bf16")) {
    std::vector<__nv_bfloat16> a, b;
    if (!read(in, a, 2 * k1 * n) || !read(in, b, 2 * k2 * n)) return 3;
    std::vector<float> label(n);
    each_pair(a, b, n, k1, k2, pairs,
              [&](long long p, const auto& b1, const auto& b2) { label[p] = sat_label(b1, b2); });
    fwrite(label.data(), 4, n, out);
  } else {
    std::vector<float> a, b;
    if (!read(in, a, 2 * k1 * n) || !read(in, b, 2 * k2 * n)) return 3;
    if (!strcmp(mode, "sat") || !strcmp(mode, "sat_first")) {
      const bool first = !strcmp(mode, "sat_first");
      std::vector<float> label(n);
      each_pair(a, b, n, k1, k2, pairs, [&](long long p, const auto& b1, const auto& b2) {
        label[p] = first ? static_cast<float>(spread_axes_separate(b1, b2)) : sat_label(b1, b2);
      });
      fwrite(label.data(), 4, n, out);
    } else if (!strncmp(mode, "dist", 4)) {
      // as kernel 9 takes a pair: the first pass; every axis where it does
      // not settle the pair; the segment tests where the gap is not below 0
      const bool padded = !strcmp(mode, "dist");
      const bool pad1 = padded && collide2d::k_bucket(k1) > k1;
      const bool pad2 = padded && collide2d::k_bucket(k2) > k2;
      std::vector<float> planes(3 * n);
      each_pair(a, b, n, k1, k2, pairs, [&](long long p, const auto& b1, const auto& b2) {
        const bool first = spread_normals_settle(b1, b2);
        const float gap = first ? 0.0f : support_gap(b1, b2);
        const bool is_gap = !first && gap < 0.0f;
        planes[p] = is_gap ? gap : separation_d2(b1, b2, pad1, pad2);
        planes[n + p] = is_gap;
        planes[2 * n + p] = first;
      });
      fwrite(planes.data(), 4, 3 * n, out);
    } else {
      std::vector<float> planes(9 * n);
      each_pair(a, b, n, k1, k2, pairs, [&](long long p, const auto& b1, const auto& b2) {
        float r[9];
        manifold(b1, b2, margin, r);
        for (int c = 0; c < 9; ++c) planes[c * n + p] = r[c];
      });
      fwrite(planes.data(), 4, 9 * n, out);
    }
  }
  fclose(in);
  fclose(out);
  return 0;
}
"""

SHAPES = [(4, 17), (4, 20), (20, 20), (32, 32), (4, 64), (17, 4)]
N = 4096  # pairs of a case: (8, 512), the block the wrappers take


@pytest.fixture(scope="module")
def program(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to compile csrc/polygon_big_k.cuh on the host")
    work = tmp_path_factory.mktemp("polygon_big_k")
    src = work / "polygon_big_k_host.cc"
    src.write_text(_PROGRAM)
    exe = work / "polygon_big_k_host"
    subprocess.run([gxx, "-O2", "-std=c++17", "-ffp-contract=off", "-I",
                    str(cuda_build.CSRC_DIR), "-o", str(exe), str(src)], check=True,
                   capture_output=True, timeout=300)
    return exe


def _polygons(rng, n, k, spread=3.0, repeat=False):
    """(n, k, 2) float32 convex CCW k-gons: ellipse points at sorted angles,
    shifted by up to ``spread`` (tests/test_torch_polygon_k_above_16.py's);
    with ``repeat``, a quarter of them with runs of repeated consecutive
    vertices (zero-length edges)."""
    ang = np.sort(rng.uniform(0, 2 * np.pi, (n, k)), axis=-1)
    ab = rng.uniform(0.3, 2.5, (n, 1, 2))
    shift = rng.uniform(-spread, spread, (n, 1, 2))
    p = (np.stack([np.cos(ang), np.sin(ang)], -1) * ab + shift).astype(np.float32)
    if repeat and k >= 3:
        rows = rng.random(n) < 0.25
        p[rows, 1] = p[rows, 0]
        p[rows, k - 1] = p[rows, k - 2]
        p[rows, k // 2 + 1] = p[rows, k // 2]
    return p


def _packed(rng, k1, k2, repeat=False):
    """A case's packed (2 K1, 8, M) and (2 K2, 8, M) float32 planes."""
    return (polygon_cuda.pack_polygons(torch.from_numpy(_polygons(rng, N, k1, repeat=repeat))),
            polygon_cuda.pack_polygons(torch.from_numpy(_polygons(rng, N, k2, repeat=repeat))))


def _edge_norms(pt: torch.Tensor, k: int) -> torch.Tensor:
    """|normal|^2 of every edge i -> (i + 1) % k of packed polygons, as the
    plain version forms them."""
    x, y = pt[:k], pt[k:]
    ax = torch.roll(y, -1, 0) - y
    ay = x - torch.roll(x, -1, 0)
    return (ax * ax + ay * ay).reshape(-1)


def _run(program, tmp_path, mode, a, b, k1, k2, pairs, margin=0.0):
    """The header's labels (n,) or manifold planes (9, 8, M) of packed
    pairs; its square roots are torch's (the plain versions', which on the
    CPU may differ from IEEE's by an ulp), from a table of torch's roots of
    the edges' |normal|^2."""
    n = a.shape[1] * a.shape[2]
    keys = torch.unique(torch.cat([_edge_norms(a.float(), k1), _edge_norms(b.float(), k2),
                                   torch.ones(1)]))
    inp, out = tmp_path / "in.bin", tmp_path / "out.bin"
    with open(inp, "wb") as f:
        np.array([keys.numel()], np.int32).tofile(f)
        keys.numpy().view(np.uint32).tofile(f)
        torch.sqrt(keys).numpy().tofile(f)
        for x in (a, b):
            if x.dtype == torch.bfloat16:
                x.contiguous().view(torch.int16).numpy().tofile(f)
            else:
                x.contiguous().numpy().tofile(f)
    subprocess.run([str(program), mode, str(k1), str(k2), str(n), str(pairs), repr(margin),
                    str(inp), str(out)], check=True, timeout=300)
    raw = torch.from_numpy(np.fromfile(out, np.float32))
    if mode.startswith("sat"):
        return raw
    return raw.reshape(3, -1) if mode.startswith("dist") else raw.reshape(9, *a.shape[1:])


def _bits(x: torch.Tensor) -> torch.Tensor:
    return x.contiguous().view(torch.int32)


def _views(k1, k2, elem_bytes):
    """The views a case runs through: the kernels' tile (P pairs a block)
    and the packed planes themselves (the body's device-memory view)."""
    return (polygon_cuda.tile_pairs(k1, k2, elem_bytes), 0)


@pytest.mark.parametrize("k1,k2", SHAPES)
def test_sat_body_is_the_plain_version(program, tmp_path, k1, k2):
    a, b = _packed(np.random.default_rng(100 * k1 + k2), k1, k2)
    want = polygon_cuda.sat_polygons_plain(a, b, k1, k2).reshape(-1).to(torch.float32)
    for pairs in _views(k1, k2, 4):
        got = _run(program, tmp_path, "sat", a, b, k1, k2, pairs)
        assert torch.equal(_bits(got), _bits(want)), pairs
    assert 0 < float(want.mean()) < 1
    # the first pass's spread axes: what chip_smoke counts as the work left
    first = _run(program, tmp_path, "sat_first", a, b, k1, k2, 0)
    settled = chip_smoke.sat_first_pass(a, b, k1, k2)
    assert torch.equal(first.bool(), settled)
    assert not (settled & want.bool()).any() and 0 < float(settled.float().mean()) < 1
    # bf16 planes: the tile keeps them and the body upcasts on the read
    a16, b16 = a.to(torch.bfloat16), b.to(torch.bfloat16)
    want16 = polygon_cuda.sat_polygons_plain(a16, b16, k1, k2).reshape(-1).to(torch.float32)
    for pairs in _views(k1, k2, 2):
        got16 = _run(program, tmp_path, "sat_bf16", a16, b16, k1, k2, pairs)
        assert torch.equal(_bits(got16), _bits(want16)), pairs


@pytest.mark.parametrize("margin", [0.0, 0.1])
@pytest.mark.parametrize("k1,k2", SHAPES)
def test_manifold_body_is_the_plain_version(program, tmp_path, k1, k2, margin):
    a, b = _packed(np.random.default_rng(200 * k1 + k2), k1, k2)
    want = manifold_cuda.polygon_manifold_plain(a, b, k1, k2, margin)
    for pairs in _views(k1, k2, 4):
        got = _run(program, tmp_path, "manifold", a, b, k1, k2, pairs, margin)
        assert torch.equal(_bits(got), _bits(want)), pairs
    counts = want[0].reshape(-1)
    assert (counts == 0).any() and (counts == 2).any()


def _distance(program, tmp_path, a, b, k1, k2, pairs, mode="dist"):
    """Kernel 9's body on packed pairs: (distances (n,), whether its first
    pass settles each pair (n,)); the square root of d2 is torch's (the plain
    version's)."""
    value, is_gap, first = _run(program, tmp_path, mode, a, b, k1, k2, pairs)
    return torch.where(is_gap.bool(), value, torch.sqrt(value)), first.bool()


def _distance_first_pass_numpy(a, b, k1, k2):
    """Kernel 9's first pass in numpy float32: the 8 spread edge normals
    (polygon 1's edges u k1 / 4, polygon 2's u k2 / 4), settled where one has
    |n|^2 > 0 and an unscaled gap >= 0; bool (n,)."""
    x1, y1 = (c.numpy().reshape(k1, -1) for c in (a[:k1], a[k1:]))
    x2, y2 = (c.numpy().reshape(k2, -1) for c in (b[:k2], b[k2:]))
    sep = np.zeros(x1.shape[1], bool)
    for x, y, k in ((x1, y1, k1), (x2, y2, k2)):
        for u in range(4):
            i = u * k // 4
            j = (i + 1) % k
            ax, ay = y[j] - y[i], x[i] - x[j]
            q1, q2 = ax * x1 + ay * y1, ax * x2 + ay * y2
            g = np.maximum(q2.min(0) - q1.max(0), q1.min(0) - q2.max(0))
            sep |= (ax * ax + ay * ay > 0) & (g >= 0)
    return torch.from_numpy(sep)


@pytest.mark.parametrize("k1,k2", SHAPES)
def test_distance_body_is_the_plain_version(program, tmp_path, k1, k2):
    a, b = _packed(np.random.default_rng(500 * k1 + k2), k1, k2)
    want = distance_cuda.polygon_distance_plain(a, b, k1, k2).reshape(-1)
    for pairs in _views(k1, k2, 4):
        got, first = _distance(program, tmp_path, a, b, k1, k2, pairs)
        assert torch.equal(_bits(got), _bits(want)), pairs
    assert 0 < int((want < 0).sum()) < N
    # the first pass: its 8 normals in numpy and in chip_smoke's count of the
    # work it leaves; a pair it settles does not overlap, and it settles most
    # of the separated pairs
    assert torch.equal(first, _distance_first_pass_numpy(a, b, k1, k2))
    assert torch.equal(first, chip_smoke.distance_first_pass(a, b, k1, k2))
    assert not (first & (want < 0)).any()
    assert int(first.sum()) >= 0.5 * int((want >= 0).sum())


@pytest.mark.parametrize("k1,k2", [(1, 20), (20, 1), (2, 17), (17, 2), (20, 24), (33, 3)])
def test_distance_body_on_degenerate_polygons(program, tmp_path, k1, k2):
    # a point, a segment, runs of repeated consecutive vertices (zero-length
    # edges and segments), and K1, K2 below, at and far from their buckets
    a, b = _packed(np.random.default_rng(600 * k1 + k2), k1, k2, repeat=True)
    want = distance_cuda.polygon_distance_plain(a, b, k1, k2).reshape(-1)
    for pairs in _views(k1, k2, 4):
        got, first = _distance(program, tmp_path, a, b, k1, k2, pairs)
        assert torch.equal(_bits(got), _bits(want)), pairs
    assert torch.equal(first, _distance_first_pass_numpy(a, b, k1, k2))
    assert 0 < int((want < 0).sum()) < N


def _needles(rng, n, k, tiny, shift):
    """(n, k, 2) float32 k-gons: a needle from (-1, 0) to a vertical edge of
    length 2 ``tiny`` at x = 0 (vertices 0 and 1: edge 0, whose |normal|^2
    underflows to 0), the other vertices on its two long sides; mirrored
    (pointing right, the short edge at x = 0) where ``shift`` is not 0, and
    moved right by it."""
    top = (k - 3) // 2
    xs_top = -np.sort(rng.uniform(0.05, 0.95, (n, top)), axis=1)
    xs_bot = np.sort(-rng.uniform(0.05, 0.95, (n, k - 3 - top)), axis=1)
    t = tiny[:, None]
    x = np.concatenate([np.zeros((n, 2)), xs_top, -np.ones((n, 1)), xs_bot], 1)
    y = np.concatenate([-t, t, t * (1 + xs_top), np.zeros((n, 1)), -t * (1 + xs_bot)], 1)
    if np.any(shift):
        x = shift[:, None] - x  # mirrored: still counter-clockwise with y negated
        y = -y
    return np.stack([x, y], -1).astype(np.float32)


def test_distance_first_pass_needs_a_nonzero_normal(program, tmp_path):
    # two needles tip to tip, a gap of `shift` apart along x: their only
    # normals along x are their tips' tiny edges (edge 0 of each, a spread
    # normal), where |n|^2 underflows to 0, so the plain version masks them
    # and every other normal shows overlap: the distance is the (negative)
    # gap. Kernel 6's strict test on the tiny edge would take the pair as
    # separated and give sqrt(d2) instead
    rng = np.random.default_rng(700)
    k1 = k2 = 20
    tiny = 10.0 ** rng.uniform(-30, -24, N)
    shift = rng.uniform(0.05, 1.0, N)
    p1 = _needles(rng, N, k1, tiny, np.zeros(N))
    p2 = _needles(rng, N, k2, tiny, shift)
    a, b = (polygon_cuda.pack_polygons(torch.from_numpy(p)) for p in (p1, p2))
    want = distance_cuda.polygon_distance_plain(a, b, k1, k2).reshape(-1)
    for pairs in _views(k1, k2, 4):
        got, first = _distance(program, tmp_path, a, b, k1, k2, pairs)
        assert torch.equal(_bits(got), _bits(want)), pairs
    assert bool((want < 0).all())
    assert not first.any() and not _distance_first_pass_numpy(a, b, k1, k2).any()
    assert bool(chip_smoke.sat_first_pass(a, b, k1, k2).all())  # kernel 6's test
    assert bool((_edge_norms(a, k1).reshape(k1, -1)[0] == 0).all())  # edge 0's |n|^2


def _touching(rng, n, k):
    """Pairs of (n, k, 2) float32 k-gons a seeded search takes: polygon 2
    an ellipse polygon, polygon 1 its reflection through its last vertex
    q_{k-1}, moved out along the closing edge's outward normal by s and along
    the edge by a little (10^-7 to 10^-3 of s), so that polygon 1's last
    vertex lies just outside q_{k-1}, its projection on the closing edge
    just above 0."""
    q = _polygons(rng, n, k).astype(np.float64)
    last, first = q[:, -1], q[:, 0]
    e = first - last
    length = np.linalg.norm(e, axis=1, keepdims=True)
    normal = np.stack([e[:, 1], -e[:, 0]], 1) / length
    s = 10.0 ** rng.uniform(-4, -1, (n, 1))
    along = s * 10.0 ** rng.uniform(-7, -3, (n, 1)) / length
    p = 2 * last[:, None] - q + (s * normal + along * e / length)[:, None]
    return p.astype(np.float32), q.astype(np.float32)


def test_distance_body_takes_the_padding_point_distance(program, tmp_path):
    # 20-gons pad to 32: the padding's zero-length segments at each
    # polygon's last vertex give the point distances to it, which the real
    # segments there can miss by rounding. On these near-touching pairs the
    # body with those point distances is the plain version; without them
    # some pairs come out larger (the point distance was the strict minimum)
    k1 = k2 = 20
    p1, p2 = _touching(np.random.default_rng(18), N, k1)
    a, b = (polygon_cuda.pack_polygons(torch.from_numpy(p)) for p in (p1, p2))
    want = distance_cuda.polygon_distance_plain(a, b, k1, k2).reshape(-1)
    for pairs in _views(k1, k2, 4):
        got, _ = _distance(program, tmp_path, a, b, k1, k2, pairs)
        assert torch.equal(_bits(got), _bits(want)), pairs
    unpadded, _ = _distance(program, tmp_path, a, b, k1, k2, 0, mode="dist_unpadded")
    assert bool((unpadded >= want).all()) and int((unpadded > want).sum()) > 0
    assert bool((want > 0).all())


# Degenerate polygons: a point, a segment, and k-gons with runs of repeated
# consecutive vertices, against polygons above 16 vertices.
DEGENERATE = [(1, 20), (20, 1), (2, 17), (17, 2), (20, 24), (33, 3)]


@pytest.mark.parametrize("k1,k2", DEGENERATE)
def test_bodies_on_degenerate_polygons(program, tmp_path, k1, k2):
    a, b = _packed(np.random.default_rng(300 * k1 + k2), k1, k2, repeat=True)
    want = polygon_cuda.sat_polygons_plain(a, b, k1, k2).reshape(-1).to(torch.float32)
    a16, b16 = a.to(torch.bfloat16), b.to(torch.bfloat16)
    want16 = polygon_cuda.sat_polygons_plain(a16, b16, k1, k2).reshape(-1).to(torch.float32)
    for pairs in _views(k1, k2, 4):
        assert torch.equal(_bits(_run(program, tmp_path, "sat", a, b, k1, k2, pairs)),
                           _bits(want))
        for margin in (0.0, 0.1):
            got = _run(program, tmp_path, "manifold", a, b, k1, k2, pairs, margin)
            assert torch.equal(_bits(got), _bits(manifold_cuda.polygon_manifold_plain(
                a, b, k1, k2, margin)))
    for pairs in _views(k1, k2, 2):
        assert torch.equal(_bits(_run(program, tmp_path, "sat_bf16", a16, b16, k1, k2,
                                      pairs)), _bits(want16))
    assert 0 < float(want.mean()) < 1


def _lattice_rectangles(rng, n, w, h):
    """(n, 2 (w + h), 2) float32 axis-aligned w x h rectangles with a vertex
    at every integer point of their boundary (CCW from a corner), shifted by
    integers: every projection is exact, so collinear edges tie exactly in
    the reference max and the incident min."""
    edge = [(x, 0) for x in range(w)] + [(w, y) for y in range(h)]
    edge += [(w - x, h) for x in range(w)] + [(0, h - y) for y in range(h)]
    shift = rng.integers(-w - 2, w + 3, (n, 1, 2))
    return (np.asarray(edge, np.float32)[None] + shift).astype(np.float32)


@pytest.mark.parametrize("k1,k2", [(24, 24), (24, 4), (4, 24)])
def test_bodies_keep_the_first_of_tied_faces(program, tmp_path, k1, k2):
    # collinear edges of equal separation and alignment: the first face wins
    # (strict `>` / `<`), and touching pairs collide (strict `<`)
    rng = np.random.default_rng(400 + k1 + k2)
    dims = {24: (8, 4), 4: (1, 1)}
    a, b = (polygon_cuda.pack_polygons(torch.from_numpy(_lattice_rectangles(rng, N, *dims[k])))
            for k in (k1, k2))
    want = polygon_cuda.sat_polygons_plain(a, b, k1, k2).reshape(-1).to(torch.float32)
    for pairs in _views(k1, k2, 4):
        assert torch.equal(_bits(_run(program, tmp_path, "sat", a, b, k1, k2, pairs)),
                           _bits(want))
        for margin in (0.0, 0.1):
            got = _run(program, tmp_path, "manifold", a, b, k1, k2, pairs, margin)
            assert torch.equal(_bits(got), _bits(manifold_cuda.polygon_manifold_plain(
                a, b, k1, k2, margin)))
    assert 0 < float(want.mean()) < 1


def test_tile_rule_is_the_wrappers(program):
    # csrc/polygon_big_k.cuh::tile_pairs against polygon_cuda.tile_pairs,
    # for f32 and bf16 planes, across the rule's every step
    out = subprocess.run([str(program), "tile_pairs", "1000"], check=True,
                         capture_output=True, text=True, timeout=60).stdout.split("\n")[:-1]
    seen = set()
    for line in out:
        e, k1, k2, p = (int(x) for x in line.split())
        assert p == polygon_cuda.tile_pairs(k1, k2, e), (e, k1, k2)
        seen.add(p)
    assert seen == {128, 64, 32, 0}
    # (32, 32) and (4, 64) f32 tiles of 128 pairs, 64 KB and 68 KB; (4, 17)
    # bf16 128 pairs; past k1 + k2 = 904 in f32 no tile (the body reads
    # device memory)
    assert polygon_cuda.tile_pairs(32, 32) == polygon_cuda.tile_pairs(4, 64) == 128
    assert polygon_cuda.tile_pairs(4, 17, 2) == 128
    assert polygon_cuda.tile_pairs(4, 900) == 32 and polygon_cuda.tile_pairs(4, 901) == 0


# ---- the wrappers' libraries: one for every K ----


def _loaded(monkeypatch, module):
    """The library path ``module._kernel_lib()`` loads (no build: the load
    is recorded and a stand-in library returned)."""
    asked = []

    def load(name, defines=()):
        asked.append(cuda_build.library_path(name, defines))
        return types.SimpleNamespace(**{f: types.SimpleNamespace() for f in (
            "polygon_sat_launch", "polygon_manifold_launch", "obb_distance_launch",
            "polygon_distance_launch")})

    monkeypatch.setattr(cuda_build, "load", load)
    module._kernel_lib()
    return asked


@pytest.mark.parametrize("module,name", [(polygon_cuda, "polygon_kernel"),
                                         (distance_cuda, "distance_kernel"),
                                         (manifold_cuda, "manifold_kernel")])
def test_kernels_6_9_and_10_take_every_k_in_one_library(monkeypatch, module, name):
    # the launcher's library takes no shape (kernel 9's: only whether it
    # counts its passes): the default build, whatever K
    assert [*inspect.signature(module._kernel_lib).parameters] == (
        ["count"] if module is distance_cuda else [])
    assert _loaded(monkeypatch, module) == [cuda_build.library_path(name)]
    # its source reads no bucket-pair define, and neither do the headers
    assert "POLY_KB" not in (cuda_build.CSRC_DIR / f"{name}.cu").read_text()
    assert not any("POLY_KB" in h.read_text() for h in cuda_build.CSRC_DIR.glob("*.cuh"))
    assert distance_cuda.distance_defines() == ()
    assert distance_cuda.distance_defines(count=True) == (("POLYDIST_COUNT", 1),)
    # chip_smoke's phase 1 builds no library of its own above 16
    assert not hasattr(chip_smoke, "big_k_builds") and not hasattr(polygon_cuda,
                                                                   "kernel_defines")
