// The sample stream of the fused Monte Carlo kernels: kernel 1
// (csrc/mc_kernel.cu), kernel 7 (csrc/mc_polygon_kernel.cu), kernel 13
// (csrc/mc_toi_kernel.cu) and kernel 14 (csrc/mc_moving_polygon_kernel.cu).
//
// Philox4x32-10 keyed by the round's two seed words (the folded threefry
// key, as mc_pallas.py:375-378), counter (sample index low, sample index
// high, row uid, draw block); each word's top 23 bits become a standard
// normal through XLA's float32 erf_inv, or, in a Box-Muller build, pairs of
// words one pair of normals (`box_muller_pair`, below). The plain versions
// draw the same words (collide2d_tpu_torch/mc/prng.py::philox4x32) and
// normals (prng.py::normal_from_codes, prng.py::box_muller_from_codes);
// tests/test_torch_mc_stream.py compiles this header on the host and holds
// it to them.
//
// What a sample does not repeat:
// - the 10 round keys: the launcher computes them on the host (`philox_key`)
//   and passes them as a __grid_constant__ kernel argument, so each round
//   reads its key from the constant bank as an operand of its XOR (when
//   the kernel computed them from the two seed words, nvcc recomputed 15
//   uniform adds a sample inside the loop);
// - counter words 1-3: within a block they are the same for every sample
//   unless its indices cross 2^32, so `philox_prefix` folds what rounds 0
//   and 1 compute from them alone (round 0's product of the uid, round 1's
//   product of round 0's first word) into 4 words, and a sample runs only
//   the parts that read its low index word. `SampleStream<false>` folds
//   them once a block; `SampleStream<true>` once a sample, from the 64-bit
//   index, for launches whose indices cross 2^32.
// The words are bit for bit Random123's philox4x32_R(10, ...).
//
// erf_inv. The Horner steps are written as fmaf, the one instruction nvcc
// contracts `c + p * w` into, so a host compiler computes the same bits.
// The central branch (w < 5, |z| below ~2.9) holds for ~99.6% of draws;
// when it holds for every active lane of the warp, the warp evaluates that
// branch's polynomial alone, its coefficients immediates: the same
// operations on the same values as the general form, which selects each
// coefficient and costs a select and a register move per step. Which form a
// lane takes never changes its bits. `lanes` names the lanes that reach the
// call together: the full warp where a loop's trip count is uniform across
// the warp (one VOTE.ALL), else __activemask() (which costs two instructions
// more).

#pragma once

#include <math.h>
#include <stdint.h>

namespace collide2d {
namespace mc_stream {

struct Philox4 {
  uint32_t v[4];
};

constexpr uint32_t kPhiloxM0 = 0xD2511F53u, kPhiloxM1 = 0xCD9E8D57u;
constexpr uint32_t kPhiloxW0 = 0x9E3779B9u, kPhiloxW1 = 0xBB67AE85u;

// The 10 round keys of a seed: round r adds r Weyl steps to each word.
struct PhiloxKey {
  uint32_t k0[10], k1[10];
};

__host__ __device__ __forceinline__ PhiloxKey philox_key(uint32_t seed0,
                                                         uint32_t seed1) {
  PhiloxKey k;
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    k.k0[r] = seed0 + static_cast<uint32_t>(r) * kPhiloxW0;
    k.k1[r] = seed1 + static_cast<uint32_t>(r) * kPhiloxW1;
  }
  return k;
}

// The high and low words of m * c, as one 32 x 32 -> 64-bit multiply
// (IMAD.WIDE.U32; __umulhi and * apart may become two instructions).
__device__ __forceinline__ void mulhilo(uint32_t m, uint32_t c, uint32_t& hi,
                                        uint32_t& lo) {
  const unsigned long long p = static_cast<unsigned long long>(m) * c;
  hi = static_cast<uint32_t>(p >> 32);
  lo = static_cast<uint32_t>(p);
}

// Counter words c1, c2, c3 folded through rounds 0 and 1. With c0 the
// low index word, round 0 gives (A, B, umulhi(M0, c0) ^ x2, M0 c0) where
// A = umulhi(M1, c2) ^ c1 ^ k0[0] and B = M1 c2; round 1 then needs of A
// and B only y0 = B ^ k0[1], y2 = umulhi(M0, A) ^ k1[1] and z = M0 A.
struct PhiloxPrefix {
  uint32_t x2, y0, y2, z;
};

__device__ __forceinline__ PhiloxPrefix philox_prefix(uint32_t c1, uint32_t c2,
                                                      uint32_t c3,
                                                      const PhiloxKey& key) {
  uint32_t hi, lo;
  mulhilo(kPhiloxM1, c2, hi, lo);
  const uint32_t a = hi ^ c1 ^ key.k0[0];
  PhiloxPrefix p;
  p.x2 = c3 ^ key.k1[0];
  p.y0 = lo ^ key.k0[1];
  mulhilo(kPhiloxM0, a, hi, p.z);
  p.y2 = hi ^ key.k1[1];
  return p;
}

// Philox4x32-10 of the counter (c0, c1, c2, c3) whose words 1-3 `prefix`
// holds.
__device__ __forceinline__ Philox4 philox4x32_10(uint32_t c0,
                                                 const PhiloxPrefix& prefix,
                                                 const PhiloxKey& key) {
  // rounds 0 and 1
  uint32_t hi0, lo0, hi1, lo1;
  mulhilo(kPhiloxM0, c0, hi0, lo0);
  mulhilo(kPhiloxM1, hi0 ^ prefix.x2, hi1, lo1);
  c0 = hi1 ^ prefix.y0;
  uint32_t c1 = lo1;
  uint32_t c2 = lo0 ^ prefix.y2;
  uint32_t c3 = prefix.z;
#pragma unroll
  for (int r = 2; r < 10; ++r) {
    mulhilo(kPhiloxM0, c0, hi0, lo0);
    mulhilo(kPhiloxM1, c2, hi1, lo1);
    c0 = hi1 ^ c1 ^ key.k0[r];
    c2 = hi0 ^ c3 ^ key.k1[r];
    c1 = lo1;
    c3 = lo0;
  }
  Philox4 out = {{c0, c1, c2, c3}};
  return out;
}

// The words of draw block `block` for a block's samples base + k,
// 0 <= k < 2^31, of the row `uid`.
template <bool kWide>
class SampleStream {
 public:
  __device__ __forceinline__ SampleStream(unsigned long long base, uint32_t uid,
                                          uint32_t block, const PhiloxKey& key)
      : base_(base), uid_(uid), block_(block) {
    if (!kWide) {
      prefix_ = philox_prefix(static_cast<uint32_t>(base >> 32), uid, block, key);
    }
  }

  __device__ __forceinline__ Philox4 operator()(int k, const PhiloxKey& key) const {
    if (kWide) {
      const unsigned long long idx = base_ + static_cast<unsigned long long>(k);
      return philox4x32_10(
          static_cast<uint32_t>(idx),
          philox_prefix(static_cast<uint32_t>(idx >> 32), uid_, block_, key), key);
    }
    return philox4x32_10(static_cast<uint32_t>(base_) + static_cast<uint32_t>(k),
                         prefix_, key);
  }

 private:
  unsigned long long base_;
  uint32_t uid_, block_;
  PhiloxPrefix prefix_;
};

// Whether the sample indices [first, first + count) of a launch, count >= 1,
// share one high word, so that `SampleStream<false>` may serve it.
inline bool narrow_indices(long long first, long long count) {
  return (static_cast<unsigned long long>(first) >> 32) ==
         (static_cast<unsigned long long>(first + count - 1) >> 32);
}

// XLA's float32 erf_inv (the polynomial jax.lax.erf_inv lowers to and
// prng.py::erf_inv evaluates in torch). log1pf stands in for XLA's Cephes
// log1p there; the two differ by an ulp on a few inputs, which moves a count
// only for a sample within an ulp of touching. The edge case |x| == 1 never
// occurs: 23-bit codes keep |x| <= 1 - 2^-23.
__device__ __forceinline__ float erfinv_f32(float x, unsigned lanes) {
  float w = -log1pf(x * -x);
  const bool lt = w < 5.0f;
  if (__all_sync(lanes, lt)) {
    w = w - 2.5f;
    float p = 2.81022636e-08f;
    p = fmaf(p, w, 3.43273939e-07f);
    p = fmaf(p, w, -3.5233877e-06f);
    p = fmaf(p, w, -4.39150654e-06f);
    p = fmaf(p, w, 0.00021858087f);
    p = fmaf(p, w, -0.00125372503f);
    p = fmaf(p, w, -0.00417768164f);
    p = fmaf(p, w, 0.246640727f);
    p = fmaf(p, w, 1.50140941f);
    return p * x;
  }
  w = lt ? w - 2.5f : sqrtf(w) - 3.0f;
  float p = lt ? 2.81022636e-08f : -0.000200214257f;
  p = fmaf(p, w, lt ? 3.43273939e-07f : 0.000100950558f);
  p = fmaf(p, w, lt ? -3.5233877e-06f : 0.00134934322f);
  p = fmaf(p, w, lt ? -4.39150654e-06f : -0.00367342844f);
  p = fmaf(p, w, lt ? 0.00021858087f : 0.00573950773f);
  p = fmaf(p, w, lt ? -0.00125372503f : -0.0076224613f);
  p = fmaf(p, w, lt ? -0.00417768164f : 0.00943887047f);
  p = fmaf(p, w, lt ? 0.246640727f : 1.00167406f);
  p = fmaf(p, w, lt ? 1.50140941f : 2.83297682f);
  return p * x;
}

// One standard normal from a Philox word: its top 23 bits b give
// z = sqrt(2) * erfinv((b + 0.5) * 2^-22 - 1), finite by construction
// ((b + 0.5) * 2^-22 is exact, so contracting the - 1 changes nothing).
__device__ __forceinline__ float normal_from_word(uint32_t word, unsigned lanes) {
  const float u =
      (static_cast<float>(word >> 9) + 0.5f) * 2.384185791015625e-07f - 1.0f;
  return 1.41421356f * erfinv_f32(u, lanes);
}

// Every lane of the warp (the `lanes` of a warp-uniform loop).
constexpr unsigned kWarp = 0xffffffffu;

// Box-Muller normals, the other draw of kernels 1, 7 and 14 (the TPU
// kernels' normal_method="box_muller", mc_pallas.py:125-131). A build takes
// them instead of erf_inv when it is compiled with -DMC_BOX_MULLER=1 (its own
// library: ops/mc_cuda.py::normal_defines); without the define no kernel
// reads this function and the erf_inv builds compile as before.
//
// One pair from two Philox words: each word's top 24 bits b give
// u = (b + 1) * 2^-24 in (0, 1] (exact), then r = sqrt(-2 log u1),
// a = 2 pi u2 and the pair (r cos a, r sin a). IEEE logf, sqrtf and sincosf,
// never the __logf / __sinf intrinsics or fast math, so the plain version
// (prng.py::box_muller_from_codes) follows it to an ulp or two. u1 >= 2^-24
// keeps r <= 5.77: always finite.
//
// Pairing. The TPU kernel pairs across two samples of a tile row (its
// layout's doing); here a sample takes its own pairs, so its normals stay a
// function of (seed, uid, sample index) alone and counts keep invariant
// under compaction, offsets and resumes. A sample's normals are the pairs'
// outputs in order (c0, s0, c1, s1, c2): 3 normals take words 0-3 of draw
// block 0 (two pairs, s1 unused), 5 normals also words 0-1 of block 1.
struct NormalPair {
  float c, s;
};

__device__ __forceinline__ NormalPair box_muller_pair(uint32_t w1, uint32_t w2) {
  const float u1 = (static_cast<float>(w1 >> 8) + 1.0f) * 5.9604644775390625e-08f;
  const float u2 = (static_cast<float>(w2 >> 8) + 1.0f) * 5.9604644775390625e-08f;
  const float r = sqrtf(-2.0f * logf(u1));
  float s, c;
  sincosf(6.28318548f * u2, &s, &c);
  NormalPair p = {r * c, r * s};
  return p;
}

}  // namespace mc_stream
}  // namespace collide2d
