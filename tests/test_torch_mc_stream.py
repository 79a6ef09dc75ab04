"""The Monte Carlo kernels' stream header (``csrc/mc_stream.cuh``) on the
host.

The header holds the sample stream of kernels 1, 7, 13 and 14. Here it is
compiled with g++, with the CUDA builtins it uses stubbed (``__activemask``
as all lanes; ``__all_sync`` as a switch the program sets, so that one run
takes the warp-uniform central branch of erf_inv wherever a code is
central and another run the general form everywhere), and held to:

- Random123's Philox4x32-10 as ``mc/prng.py::philox4x32`` computes it, bit
  for bit, through both `SampleStream` paths (counter words 1-3 folded once,
  and once a sample from the 64-bit index) on a few thousand counters, keys
  and sample offsets, including indices that cross 2^32;
- over all 2^23 codes, the central-branch erf_inv equal to the general form
  bit for bit: the Horner steps are written as ``fmaf`` (the instruction
  nvcc contracts them into), and the only other contractible expression,
  ``(b + 0.5) * 2^-22 - 1``, is exact, so ``-ffp-contract=off`` computes
  the device's bits;
- the normals within 1e-6 (absolute) of ``prng.normal_from_codes``: the two
  differ only where the host's ``log1pf`` and torch's ``log1p`` round
  differently by an ulp (on 55,878 codes with glibc; at most 4.8e-7, in
  erf_inv's tails);
- the Box-Muller pair (`box_muller_pair`, the normals of the kernels'
  Box-Muller builds) within 4 ulp of the pair's radius r (absolute) of
  ``prng.box_muller_from_codes`` on the words' top 24 bits, every code's
  extremes included: the two take the host's ``logf`` and ``sincosf``
  against torch's ``log``, ``cos`` and ``sin``, an ulp or two apart.

It skips only where g++ is absent.
"""

import shutil
import subprocess

import numpy as np
import pytest
import torch

from collide2d_tpu_torch.mc import prng
from collide2d_tpu_torch.utils import cuda_build

torch.set_num_threads(1)

_PROGRAM = r"""
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <math.h>

#define __host__
#define __device__
#define __forceinline__ inline

static bool g_vote = true;
static inline unsigned __activemask() { return 0xffffffffu; }
static inline bool __all_sync(unsigned, bool p) { return g_vote && p; }

#include "mc_stream.cuh"

using namespace collide2d::mc_stream;

// philox IN OUT: records (base lo, base hi, uid, block, seed0, seed1, k) ->
// the words of SampleStream<false> and of SampleStream<true>.
// normals OUT: every code's normal with the vote, then without it; prints
// the codes on the central branch and the codes whose bits differ.
// boxmuller IN OUT: word pairs -> the Box-Muller pair (c, s) of each.
int main(int argc, char** argv) {
  if (argc == 4 && !strcmp(argv[1], "philox")) {
    FILE* in = fopen(argv[2], "rb");
    FILE* out = fopen(argv[3], "wb");
    uint32_t r[7];
    while (fread(r, 4, 7, in) == 7) {
      const unsigned long long base = (static_cast<unsigned long long>(r[1]) << 32) | r[0];
      const PhiloxKey key = philox_key(r[4], r[5]);
      const Philox4 a = SampleStream<false>(base, r[2], r[3], key)(static_cast<int>(r[6]), key);
      const Philox4 b = SampleStream<true>(base, r[2], r[3], key)(static_cast<int>(r[6]), key);
      fwrite(a.v, 4, 4, out);
      fwrite(b.v, 4, 4, out);
    }
    fclose(in);
    fclose(out);
    return 0;
  }
  if (argc == 3 && !strcmp(argv[1], "normals")) {
    const uint32_t codes = 1u << 23;
    float* z = static_cast<float*>(malloc(sizeof(float) * codes));
    long central = 0, differ = 0;
    for (uint32_t b = 0; b < codes; ++b) {
      const uint32_t word = b << 9;
      g_vote = true;
      z[b] = normal_from_word(word, kWarp);
      g_vote = false;
      const float general = normal_from_word(word, kWarp);
      const float x = (static_cast<float>(b) + 0.5f) * 2.384185791015625e-07f - 1.0f;
      central += -log1pf(x * -x) < 5.0f;
      differ += memcmp(&z[b], &general, sizeof(float)) != 0;
    }
    FILE* out = fopen(argv[2], "wb");
    fwrite(z, sizeof(float), codes, out);
    fclose(out);
    printf("%ld %ld\n", central, differ);
    return 0;
  }
  if (argc == 4 && !strcmp(argv[1], "boxmuller")) {
    FILE* in = fopen(argv[2], "rb");
    FILE* out = fopen(argv[3], "wb");
    uint32_t w[2];
    while (fread(w, 4, 2, in) == 2) {
      const NormalPair p = box_muller_pair(w[0], w[1]);
      fwrite(&p.c, 4, 1, out);
      fwrite(&p.s, 4, 1, out);
    }
    fclose(in);
    fclose(out);
    return 0;
  }
  return 2;
}
"""


@pytest.fixture(scope="module")
def stream_program(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to compile csrc/mc_stream.cuh on the host")
    work = tmp_path_factory.mktemp("mc_stream")
    src = work / "mc_stream_host.cc"
    src.write_text(_PROGRAM)
    exe = work / "mc_stream_host"
    subprocess.run([gxx, "-O2", "-std=c++17", "-ffp-contract=off", "-I",
                    str(cuda_build.CSRC_DIR), "-o", str(exe), str(src)], check=True,
                   capture_output=True, timeout=300)
    return exe


def test_philox_words_match_prng_through_both_stream_paths(stream_program, tmp_path):
    rng = np.random.default_rng(0)
    m = 4096
    rec = rng.integers(0, 1 << 32, (m, 7), dtype=np.uint64)
    rec[:, 3] = rng.integers(0, 2, m)               # draw block 0 or 1
    rec[:, 6] = rng.integers(0, 4096, m)            # sample offset in a block
    rec[:64, 0] = 0xFFFFFFFF - rec[:64, 6] // 2     # base + k crosses 2^32
    rec[64:96, :6] = np.array([0, 0xFFFFFFFF])[rng.integers(0, 2, (32, 6))]
    rec[64:96, 3] &= 1
    inp, out = tmp_path / "in.bin", tmp_path / "out.bin"
    rec.astype(np.uint32).tofile(inp)
    subprocess.run([str(stream_program), "philox", str(inp), str(out)], check=True,
                   timeout=60)
    got = np.fromfile(out, np.uint32).reshape(m, 2, 4).astype(np.int64)

    idx = (rec[:, 1] << np.uint64(32)) + rec[:, 0] + rec[:, 6]  # wraps mod 2^64
    t = lambda a: torch.from_numpy(np.asarray(a, np.uint64).astype(np.int64))  # noqa: E731
    want = torch.stack(prng.philox4x32(
        t(idx & np.uint64(prng.MASK32)), t(idx >> np.uint64(32)), t(rec[:, 2]),
        t(rec[:, 3]), t(rec[:, 4]), t(rec[:, 5])), dim=1).numpy()
    # the 64-bit path: every record
    np.testing.assert_array_equal(got[:, 1], want)
    # the folded path: every record whose block does not cross 2^32 (the
    # kernels take it only then)
    narrow = (rec[:, 0] + rec[:, 6]) < (1 << 32)
    assert 0 < (~narrow).sum() < m
    np.testing.assert_array_equal(got[narrow, 0], want[narrow])


def test_erfinv_central_branch_is_the_general_form_on_every_code(stream_program,
                                                                 tmp_path):
    out = tmp_path / "z.bin"
    proc = subprocess.run([str(stream_program), "normals", str(out)], check=True,
                          capture_output=True, text=True, timeout=120)
    central, differ = map(int, proc.stdout.split())
    codes = 1 << 23
    assert differ == 0
    # the vote took the central branch on ~99.66% of codes (|z| < ~2.93)
    assert 0.996 * codes < central < 0.997 * codes
    z = torch.from_numpy(np.fromfile(out, np.float32))
    want = prng.normal_from_codes(torch.arange(codes, dtype=torch.int32))
    assert torch.isfinite(z).all()
    assert float((z - want).abs().max()) <= 1e-6


def test_box_muller_pair_matches_prng(stream_program, tmp_path):
    rng = np.random.default_rng(1)
    m = 1 << 18
    w = rng.integers(0, 1 << 32, (m, 2), dtype=np.uint64)
    # the codes' extremes: u1 = 2^-24 (the largest radius), u1 = 1 (r = 0),
    # u2 at 1/4, 1/2 and 1 of the turn
    w[:8, 0] = np.array([0, 255, 0xFFFFFF00, 0xFFFFFFFF, 0, 0, 0, 0], np.uint64)
    w[:8, 1] = np.array([0, 0x3FFFFF00, 0x7FFFFF00, 0xFFFFFFFF] * 2, np.uint64)
    inp, out = tmp_path / "in.bin", tmp_path / "out.bin"
    w.astype(np.uint32).tofile(inp)
    subprocess.run([str(stream_program), "boxmuller", str(inp), str(out)], check=True,
                   timeout=60)
    got = np.fromfile(out, np.float32).reshape(m, 2)
    codes = torch.from_numpy((w >> np.uint64(8)).astype(np.int64))
    c, s = prng.box_muller_from_codes(codes[:, 0], codes[:, 1])
    want = np.stack([c.numpy(), s.numpy()], axis=1)
    assert np.isfinite(got).all()
    u1 = (codes[:, 0].numpy().astype(np.float64) + 1) * 2.0**-24
    r = np.sqrt(-2 * np.log(u1)).astype(np.float32)
    ulp = np.spacing(np.maximum(r, np.float32(2.0**-24)))[:, None]
    assert np.abs(got - want).max(initial=0) <= 4 * ulp.max()
    assert (np.abs(got - want) <= 4 * ulp).all()
    print(f"bitwise on {(got == want).mean():.2%} of normals")
    assert (got == want).mean() > 0.5

