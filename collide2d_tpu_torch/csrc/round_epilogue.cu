// The round epilogue: the adaptive loop's stopping rule and label freeze
// after each round's counts, on Hopper.
//
// Replaces no TPU kernel: the JAX package leaves this step of its fused
// round (collide2d_tpu/mc/estimator.py::_fused_round) to XLA's fusion. The
// port ran it as about 46 small torch operations a round
// (mc/stats.py::is_converged and the freeze); this kernel runs it in one
// launch. For each buffer row i, one thread:
//
//   n_true[i] += counts[i]          (skipped when counts is null: the fused
//                                    counting kernel added into n_true)
//   conv       = the stopping rule (round_epilogue.cuh) at n_after samples
//   newly      = conv && !done[i];  done[i] |= conv
//   newly: k_frozen[i] = n_true[i], n_frozen[i] = n_after
//
// and on the last round of a same-plan run (num_done not null) the done
// real rows (uids >= 0) are summed into *num_done: a warp ballot, one
// int32 atomicAdd a warp; the launcher zeroes *num_done first with one
// cudaMemsetAsync on the same stream.
//
// In place: the state's four tensors are updated where they are. The
// driver holds no other reference to them: every repack gathers a new
// buffer, and the checkpoint writer copies them to the host first.
//
// What bounds it: bytes. A row reads n_true, done, k_frozen, n_frozen and
// (with counts) 4 more bytes, (on the last round) its uid, and writes
// n_true, and done, k_frozen and n_frozen only at its freeze: about 20 B
// read and written a row a round. At the adaptive tail's 256 rows that is
// 5 KB, far below any bound: the launch costs what a launch costs.
//
// Same bits as the plain path (mc/stats.py and the freeze in torch): the
// per-row arithmetic of round_epilogue.cuh; integer sums do not depend on
// order.

#include <cuda_runtime.h>

#include <cstdint>

#include "round_epilogue.cuh"

namespace {

using collide2d::round_epilogue::kMaxBins;
using collide2d::round_epilogue::StopRule;
using collide2d::round_epilogue::update_row;

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
    round_epilogue_kernel(const int32_t* __restrict__ counts,
                          const int32_t* __restrict__ uids, int32_t* __restrict__ n_true,
                          bool* __restrict__ done, int32_t* __restrict__ k_frozen,
                          int32_t* __restrict__ n_frozen, int32_t* __restrict__ num_done,
                          int num_rows, int32_t n_after, float n_f, StopRule rule) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  bool counted = false;
  if (i < num_rows) {
    int32_t nt = n_true[i];
    bool d = done[i];
    int32_t kf = 0, nf = 0;
    if (update_row(nt, d, kf, nf, counts ? counts[i] : 0, n_after, n_f, rule)) {
      done[i] = true;
      k_frozen[i] = kf;
      n_frozen[i] = nf;
    }
    if (counts) n_true[i] = nt;
    counted = num_done && d && uids[i] >= 0;
  }
  if (num_done) {  // the same for every thread of the grid
    const unsigned votes = __ballot_sync(0xffffffffu, counted);
    if ((threadIdx.x & 31) == 0 && votes) atomicAdd(num_done, __popc(votes));
  }
}

}  // namespace

// Plain C entry point (bound with ctypes). `counts` may be null (the
// counts are already in n_true); `num_done` null on every round but a
// run's last. `edges` holds n_bins + 1 floats, `targets` n_bins, on the
// host. Launches on `stream`, does not synchronise, and returns the first
// CUDA error (0 = ok).
extern "C" int round_epilogue_launch(const int32_t* counts, const int32_t* uids,
                                     int32_t* n_true, bool* done, int32_t* k_frozen,
                                     int32_t* n_frozen, int32_t* num_done, int num_rows,
                                     int32_t n_after, float n_f, float z,
                                     float log_inv_alpha, int n_bins, const float* edges,
                                     const float* targets, void* stream) {
  if (n_bins < 1 || n_bins > kMaxBins || num_rows < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  StopRule rule;
  rule.z = z;
  rule.log_inv_alpha = log_inv_alpha;
  rule.n_bins = n_bins;
  for (int i = 0; i < kMaxBins + 1; ++i) rule.edge[i] = i <= n_bins ? edges[i] : 0.0f;
  for (int i = 0; i < kMaxBins; ++i) rule.target[i] = i < n_bins ? targets[i] : 0.0f;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (num_done) {
    const cudaError_t err = cudaMemsetAsync(num_done, 0, sizeof(int32_t), s);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (num_rows > 0) {
    const unsigned blocks = static_cast<unsigned>((num_rows + kThreads - 1) / kThreads);
    round_epilogue_kernel<<<blocks, kThreads, 0, s>>>(counts, uids, n_true, done, k_frozen,
                                                       n_frozen, num_done, num_rows, n_after,
                                                       n_f, rule);
  }
  return static_cast<int>(cudaGetLastError());
}

// Accuracy bins a launch takes.
extern "C" int round_epilogue_max_bins() { return kMaxBins; }
