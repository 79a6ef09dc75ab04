// The streaming-bandwidth probe on Hopper: two float32 streams read once,
// summed, one float32 out.
//
// Replaces the TPU kernel of collide2d_tpu/utils/benchmarks.py::
// bench_stream_bandwidth_pallas (the kernel body at :990, its pallas_call
// at :1010), which computes sum over (8, 8, 4096) tiles of
// sum(r1_tile) * s + sum(r2_tile) for two `pack_rects` batches: the SAT
// count kernel's exact memory pattern with trivial math, the ceiling that
// the bench headline's implied bandwidth is checked against.
//
// What it computes here: s * sum(r1) + sum(r2) over all n = 64M floats of
// each (8, 8, M) stream, the same value as the tile form up to rounding.
// On the TPU the grid ran in order and carried the sum from tile to tile;
// here blocks run in parallel, so the sum is split as below.
//
// What bounds it on this card: bytes. Each stream element is read once
// and added once (2 float operations per 8 bytes), so at 3.35 TB/s the
// 2 x 268 MB of 2^23 pairs take at least 0.160 ms. The design spends
// nothing but the loads:
// - a grid-stride loop over both flat streams with 16-byte (float4) loads,
//   kUnroll of each stream in flight per thread, accumulated in float32
//   registers; the grid is a fixed number of blocks per SM (the wrapper
//   asks `stream_sum_blocks`), so every block streams many tiles;
// - elements past the last whole float4 (n % 4) are read one at a time;
// - each block reduces its two sums by warp shuffles, then across its
//   warps in shared memory, and writes them to `partials`;
// - the last block to finish (an atomic ticket) adds the partials in a
//   fixed order, writes s * A + B and resets the ticket to 0. No float
//   atomicAdd: the same inputs give the same value on every launch.
//
// The wrapper (ops/stream_cuda.py) allocates `partials` (2 x blocks), the
// ticket (zeroed) and the output; the kernel allocates nothing and does
// not synchronise. The pointers must be 16-byte aligned.

#include <cuda_runtime.h>
#include <limits.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 2;       // float4 loads of each stream in flight
constexpr int kBlocksPerSm = 8;  // 8 x 256 threads fill an SM

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) v += __shfl_xor_sync(0xffffffffu, v, d);
  return v;
}

__device__ __forceinline__ float sum4(float4 v) {
  return (v.x + v.y) + (v.z + v.w);
}

// Sums of a and b over the block's threads, in thread 0 (a fixed order).
__device__ __forceinline__ void block_sum2(float& a, float& b) {
  __shared__ float sa[kWarps], sb[kWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  a = warp_sum(a);
  b = warp_sum(b);
  if (lane == 0) {
    sa[warp] = a;
    sb[warp] = b;
  }
  __syncthreads();
  if (warp == 0) {
    a = lane < kWarps ? sa[lane] : 0.0f;
    b = lane < kWarps ? sb[lane] : 0.0f;
    a = warp_sum(a);
    b = warp_sum(b);
  }
  __syncthreads();  // sa/sb are free again
}

__global__ void __launch_bounds__(kThreads)
    stream_sum_kernel(const float* __restrict__ r1,
                      const float* __restrict__ r2, long long n, float s,
                      float* __restrict__ partials,
                      unsigned int* __restrict__ ticket,
                      float* __restrict__ out) {
  const float4* a4 = reinterpret_cast<const float4*>(r1);
  const float4* b4 = reinterpret_cast<const float4*>(r2);
  const long long n4 = n / 4;
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  float a = 0.0f, b = 0.0f;
  for (; i + (kUnroll - 1) * stride < n4; i += kUnroll * stride) {
    float4 va[kUnroll], vb[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      va[u] = __ldg(a4 + i + u * stride);
      vb[u] = __ldg(b4 + i + u * stride);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      a += sum4(va[u]);
      b += sum4(vb[u]);
    }
  }
  for (; i < n4; i += stride) {
    a += sum4(__ldg(a4 + i));
    b += sum4(__ldg(b4 + i));
  }
  // the tail past the last whole float4
  const long long t = 4 * n4 + static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (t < n) {
    a += __ldg(r1 + t);
    b += __ldg(r2 + t);
  }

  block_sum2(a, b);
  __shared__ bool last;
  if (threadIdx.x == 0) {
    partials[blockIdx.x] = a;
    partials[gridDim.x + blockIdx.x] = b;
    __threadfence();  // the partials are visible before the ticket moves
    last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;

  // The last block: thread j adds partials j, j + 256, ... in order, then
  // the block reduces as above. __ldcg reads through L2, where the other
  // blocks' stores landed.
  a = 0.0f;
  b = 0.0f;
  for (unsigned j = threadIdx.x; j < gridDim.x; j += kThreads) {
    a += __ldcg(partials + j);
    b += __ldcg(partials + gridDim.x + j);
  }
  block_sum2(a, b);
  if (threadIdx.x == 0) {
    *out = a * s + b;
    *ticket = 0u;
  }
}

}  // namespace

// Plain C entry points (bound with ctypes).

// Blocks of a launch over n floats a stream on a card with `sms` SMs.
extern "C" int stream_sum_blocks(long long n, int sms) {
  const long long per_block = static_cast<long long>(kThreads) * kUnroll * 4;
  long long blocks = (n + per_block - 1) / per_block;
  const long long cap = static_cast<long long>(sms > 0 ? sms : 1) * kBlocksPerSm;
  if (blocks > cap) blocks = cap;
  return blocks < 1 ? 1 : static_cast<int>(blocks);
}

// s * sum(r1[0:n]) + sum(r2[0:n]) into *out. `partials` holds 2 x blocks
// floats, `ticket` one zeroed unsigned int (left at 0). Launches on
// `stream`, does not synchronise, returns cudaGetLastError() (0 = ok).
extern "C" int stream_sum_launch(const float* r1, const float* r2, long long n,
                                 float s, int blocks, float* partials,
                                 unsigned int* ticket, float* out,
                                 cudaStream_t stream) {
  if (n < 0 || blocks < 1) return static_cast<int>(cudaErrorInvalidValue);
  stream_sum_kernel<<<blocks, kThreads, 0, stream>>>(r1, r2, n, s, partials,
                                                     ticket, out);
  return static_cast<int>(cudaGetLastError());
}
