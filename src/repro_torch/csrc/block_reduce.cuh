// Fixed-order block reductions shared by the kernels of csrc/.
//
// CUDA blocks run in no fixed order, so a sum across blocks is two-pass:
// each block writes one partial per (row, tile), then reduce_partials_kernel
// sums each row of partials in a fixed order. No atomics: a distance that
// feeds the eq. 3 min and the s_min floor is bit-identical from run to run.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace block_reduce {
namespace {  // internal linkage: each library gets its own copy

constexpr int kThreads = 256;  // 8 warps per block
constexpr int kWarps = kThreads / 32;

// Sum over the block in a fixed order (shuffle tree, then warp 0 over the
// kWarps warp sums). The result is valid in thread 0 only.
__device__ __forceinline__ float block_sum(float v, float* smem) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  if (lane == 0) smem[warp] = v;
  __syncthreads();
  float r = 0.f;
  if (warp == 0) {
    r = lane < kWarps ? smem[lane] : 0.f;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) r += __shfl_down_sync(0xffffffffu, r, off);
  }
  __syncthreads();  // smem may be reused by the caller's next block_sum
  return r;
}

// Sum of one partials row in a fixed order (each thread strides the row,
// then block_sum). Valid in thread 0 only.
__device__ __forceinline__ float row_sum(const float* __restrict__ row, int64_t tiles,
                                         float* smem) {
  float acc = 0.f;
  for (int64_t t = threadIdx.x; t < tiles; t += kThreads) acc += row[t];
  return block_sum(acc, smem);
}

// Second pass: one block per row k reduces partials[k, :] into out[k].
__global__ void __launch_bounds__(kThreads)
reduce_partials_kernel(const float* __restrict__ partials, float* __restrict__ out,
                       int64_t tiles) {
  __shared__ float smem[kWarps];
  const float r = row_sum(partials + (int64_t)blockIdx.x * tiles, tiles, smem);
  if (threadIdx.x == 0) out[blockIdx.x] = r;
}

}  // namespace
}  // namespace block_reduce
