// The adaptive loop's per-row round update: the stopping rule and the
// label freeze of mc/estimator.py::_fused_round, one row at a time.
//
// Kept apart from round_epilogue.cu so that the host test
// (tests/test_torch_round_epilogue.py) compiles the same arithmetic with
// g++ and holds it bit for bit to mc/stats.py::is_converged and the
// freeze. Everything is float32 in mc/stats.py's operation order, each
// operation rounded on its own (__fdiv_rn / __fmul_rn / __fsub_rn; nothing
// here could contract into an FMA, but the explicit forms say so), the
// square root IEEE sqrtf:
//
//   slack  = ln(1/alpha) / n                      if k == 0 or k == n
//          = z / n * sqrt(max(k - k*k/n, 0))      otherwise
//   bin    = the LAST i with edge[i] <= k/n <= edge[i+1] (0 if none)
//   conv   = slack <= target[bin]
//
// with n the round's cumulative sample count and k the row's running
// collision count, both as float32. k*k is float32 too, as in the JAX
// package (the reference computes it in int32 and overflows past 46,340).

#pragma once

#include <cstdint>

namespace collide2d {
namespace round_epilogue {

// Accuracy bins a launch takes (the reference has 3).
constexpr int kMaxBins = 16;

// The stopping rule's constants, each a float32 rounding of mc/stats.py's
// Python value, passed by value as a kernel argument.
struct StopRule {
  float z;              // Z_SCORE
  float log_inv_alpha;  // ln(1 / ALPHA), the rule-of-three numerator
  int n_bins;           // 1 <= n_bins <= kMaxBins
  float edge[kMaxBins + 1];
  float target[kMaxBins];
};

// mc/stats.py::calc_slack on float32 (n, k).
__device__ __forceinline__ float calc_slack(float n, float k, const StopRule& r) {
  if (k == n || k == 0.0f) return __fdiv_rn(r.log_inv_alpha, n);
  float v = __fsub_rn(k, __fdiv_rn(__fmul_rn(k, k), n));
  v = v < 0.0f ? 0.0f : v;
  return __fmul_rn(__fdiv_rn(r.z, n), sqrtf(v));
}

// mc/stats.py::get_bin: the reference's last-match-wins inclusive scan.
__device__ __forceinline__ int get_bin(float p, const StopRule& r) {
  int last = 0;
  for (int i = 0; i < r.n_bins; ++i) {
    if (p >= r.edge[i] && p <= r.edge[i + 1]) last = i;
  }
  return last;
}

// mc/stats.py::is_converged at n samples (already float32) and k hits.
__device__ __forceinline__ bool is_converged(float n, int32_t k_hits, const StopRule& r) {
  const float k = static_cast<float>(k_hits);
  const float slack = calc_slack(n, k, r);
  return slack <= r.target[get_bin(__fdiv_rn(k, n), r)];
}

// One row's round: n_true += counts, then the freeze at the first round
// the rule holds (generate_dataset.cu:455-464). `n_after` is the round's
// cumulative sample count, `n_f` its float32 rounding. Returns whether the
// row's state changed beyond n_true (so the kernel writes only then).
__device__ __forceinline__ bool update_row(int32_t& n_true, bool& done, int32_t& k_frozen,
                                           int32_t& n_frozen, int32_t counts, int32_t n_after,
                                           float n_f, const StopRule& r) {
  n_true += counts;
  const bool conv = is_converged(n_f, n_true, r);
  const bool newly = conv && !done;
  if (newly) {
    done = true;
    k_frozen = n_true;
    n_frozen = n_after;
  }
  return newly;
}

}  // namespace round_epilogue
}  // namespace collide2d
