// Fixed-order block reductions and the cooperative-launch helpers shared by
// the kernels of csrc/.
//
// CUDA blocks run in no fixed order, so a sum across blocks is two-pass:
// each block writes one partial per (row, tile), then each row of partials
// is summed in a fixed order -- by the block that draws a row group's last
// arrival ticket (K2, weighted_agg.cu), or after a grid-wide barrier inside
// one cooperative launch (K1, K4: grid_barrier, sum_rows). An atomic is used
// only as K2's arrival ticket, never in a sum, so a distance that feeds the
// eq. 3 min and the s_min floor is bit-identical from run to run.
#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace block_reduce {
namespace {  // internal linkage: each library gets its own copy

constexpr int kThreads = 256;  // 8 warps per block
constexpr int kWarps = kThreads / 32;

// Sum over one warp in a fixed order (shuffle tree); valid in lane 0.
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

// Second stage of block_sum, run by one whole warp: the kWarps warp sums of
// `sums`, in a fixed order. Valid in lane 0.
__device__ __forceinline__ float warp_sums_total(const float* sums) {
  const int lane = threadIdx.x & 31;
  return warp_sum(lane < kWarps ? sums[lane] : 0.f);
}

// Sum over the block in a fixed order (shuffle tree, then warp 0 over the
// kWarps warp sums). The result is valid in thread 0 only.
__device__ __forceinline__ float block_sum(float v, float* smem) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  v = warp_sum(v);
  if (lane == 0) smem[warp] = v;
  __syncthreads();
  float r = 0.f;
  if (warp == 0) r = warp_sums_total(smem);
  __syncthreads();  // smem may be reused by the caller's next block_sum
  return r;
}

// Sum of one partials row in a fixed order (each thread strides the row,
// then block_sum). Valid in thread 0 only. The loads go through L2
// (__ldcg), never the non-coherent path: inside a cooperative launch the
// row was written by other blocks of the same kernel.
__device__ __forceinline__ float row_sum(const float* row, int64_t tiles, float* smem) {
  float acc = 0.f;
  for (int64_t t = threadIdx.x; t < tiles; t += kThreads) acc += __ldcg(row + t);
  return block_sum(acc, smem);
}

// a / b for 0 <= a, 0 < b; 32-bit where both fit (64-bit division is a
// long subroutine, and a task's first index waits on it).
__device__ __forceinline__ int64_t div_index(int64_t a, int64_t b) {
  return ((a | b) >> 32) == 0 ? (int64_t)((uint32_t)a / (uint32_t)b) : a / b;
}

// Every block of a cooperative launch waits here until all have arrived;
// the writes made before it are visible to every block after it.
__device__ __forceinline__ void grid_barrier() { cooperative_groups::this_grid().sync(); }

// Inside a cooperative launch, after a grid_barrier: block b sums rows
// b, b + gridDim.x, ... of partials (K, tiles) into out, each by row_sum.
__device__ __forceinline__ void sum_rows(const float* partials, float* __restrict__ out,
                                         int64_t k_rows, int64_t tiles, float* smem) {
  for (int64_t k = blockIdx.x; k < k_rows; k += gridDim.x) {
    const float r = row_sum(partials + k * tiles, tiles, smem);
    if (threadIdx.x == 0) out[k] = r;
  }
}

// How many kThreads-blocks of one kernel fit on the current device at once
// (occupancy x SMs), cached per device and dynamic shared-memory size: a
// cooperative grid larger than that is refused at launch.
struct Residency {
  static constexpr int kMaxDevices = 64;
  std::atomic<uint64_t> entry[kMaxDevices] = {};  // smem << 32 | blocks
};

template <typename Kernel>
cudaError_t resident_blocks(Kernel kernel, uint32_t smem, Residency& cache, int* blocks) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess && dev >= Residency::kMaxDevices) err = cudaErrorInvalidDevice;
  if (err != cudaSuccess) return err;
  const uint64_t seen = cache.entry[dev].load(std::memory_order_relaxed);
  if (seen != 0 && (seen >> 32) == smem) {
    *blocks = (int)(seen & 0xffffffffu);
    return cudaSuccess;
  }
  if (smem > 48 * 1024)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
  int per_sm = 0, sms = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess && per_sm < 1) err = cudaErrorCooperativeLaunchTooLarge;
  if (err != cudaSuccess) {
    cudaGetLastError();  // reported to the caller; not left for the next launch
    return err;
  }
  *blocks = per_sm * sms;
  cache.entry[dev].store((uint64_t)smem << 32 | (uint32_t)*blocks,
                         std::memory_order_relaxed);
  return cudaSuccess;
}

// Launch `kernel` cooperatively with min(work, co-resident) blocks of
// kThreads on `stream`. A refused launch returns its error; nothing falls
// back to another launch form.
template <typename Kernel>
cudaError_t launch_cooperative(Kernel kernel, int64_t work, uint32_t smem,
                               Residency& cache, void** args, void* stream) {
  int resident = 0;
  cudaError_t err = resident_blocks(kernel, smem, cache, &resident);
  if (err == cudaSuccess) {
    const int64_t grid = work < resident ? (work < 1 ? 1 : work) : resident;
    err = cudaLaunchCooperativeKernel((const void*)kernel, dim3((unsigned)grid),
                                      dim3(kThreads), args, smem,
                                      static_cast<cudaStream_t>(stream));
  }
  // the caller gets the error; the runtime's last-error slot is cleared, so
  // the next launch of any library (PyTorch's too) does not report it again
  if (err != cudaSuccess) cudaGetLastError();
  return err;
}

}  // namespace
}  // namespace block_reduce
