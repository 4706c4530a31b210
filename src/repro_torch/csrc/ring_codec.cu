// Hand-written Hopper (sm_90a) kernel K4: fused int8 dequantize + eq. 3
// squared distance against the rows of the compressed version ring.
//
// It replaces the Pallas TPU kernel of the JAX package's
// src/repro/kernels/ring_codec/kernel.py:
//
//   K4 int8_sq_dists_pallas (:51, body _int8_sq_dist_kernel :35)
//        -> rc_int8_sq_dist_partials + rc_reduce_partials.
//
// It computes, for int8 codes q (K, N), f32 scale and zero (K, N / qblock)
// and f32 x (N,):
//
//   d_k = sum_n (q[k, n] * scale[k, n / qblock] + zero[k, n / qblock] - x[n])^2
//
// without ever writing the K decoded f32 rows to memory.
//
// Bound on an H100 SXM (3.35 TB/s HBM3): bytes. The kernel reads each code
// once (K*N B), each scale and zero once (8*K*N/qblock B) and x once (4*N B),
// against ~5 flops per code, so it sits far below the card's flops line. What
// the design does about it: one block per (k, tile of kTile elements), k
// fastest, so the K blocks of one tile run close together and read that tile
// of x from L2 (x costs one pass from HBM); each thread loads its kVec codes
// as one 16-byte load and its kVec x values as four 16-byte loads; scale and
// zero are read once per qblock run, not once per element.
//
// Decoding uses __fmul_rn / __fadd_rn: nvcc would otherwise contract
// q * scale + zero into one FMA, and the decoded values would drift from the
// plain version's (product and sum rounded separately, as in the JAX
// package's dequant_ref).
//
// Determinism: the TPU kernel carries a (K, 1) accumulator across its
// sequential grid. CUDA blocks run in no fixed order, so each block writes one
// partial per (k, tile) and a second launch sums each row of partials in a
// fixed order (block_reduce.cuh). No atomics: the distances feed the eq. 3 min
// and the s_min floor, so they are bit-identical from run to run.
//
// Shapes: any N with N % qblock == 0; the ragged last tile is masked. The
// 16-byte loads need N % 16 == 0 and 16-byte aligned bases; otherwise the
// kernel loads element by element.
//
// Interface: plain C, loaded with ctypes. Every entry point launches on the
// stream it is given, allocates nothing and returns cudaGetLastError().
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -I csrc -o libring_codec.so ring_codec.cu

#include <cuda_runtime.h>
#include <stdint.h>

#include "block_reduce.cuh"

namespace {

using block_reduce::block_sum;
using block_reduce::kThreads;
using block_reduce::kWarps;
using block_reduce::reduce_partials_kernel;

constexpr int kVec = 16;                  // codes per thread: one 16-byte load
constexpr int kTile = kThreads * kVec;    // 4096 elements per block

// Sum over one thread's chunk q[0..count), x[0..count) starting at element
// `start` of the row; (scale, zero) reloaded only where a qblock run begins.
__device__ __forceinline__ float chunk_sq_dist(const int8_t* q, const float* xv,
                                               int count, int64_t start,
                                               const float* __restrict__ srow,
                                               const float* __restrict__ zrow,
                                               int64_t qblock) {
  int64_t b = start / qblock;
  int64_t next = (b + 1) * qblock;  // first element of the next qblock run
  float s = __ldg(srow + b);
  float z = __ldg(zrow + b);
  float acc = 0.f;
#pragma unroll
  for (int i = 0; i < kVec; ++i) {
    if (i < count) {
      if (start + i == next) {
        ++b;
        next += qblock;
        s = __ldg(srow + b);
        z = __ldg(zrow + b);
      }
      const float deq = __fadd_rn(__fmul_rn(static_cast<float>(q[i]), s), z);
      const float d = __fsub_rn(deq, xv[i]);
      acc = fmaf(d, d, acc);
    }
  }
  return acc;
}

// Phase 0: partials[k * tiles + t] = sum over tile t of row k's squared
// differences. Block b handles (k = b % K, t = b / K).
template <bool kVectorLoads>
__global__ void __launch_bounds__(kThreads)
int8_sq_dist_partials_kernel(const float* __restrict__ x, const int8_t* __restrict__ codes,
                             const float* __restrict__ scale, const float* __restrict__ zero,
                             float* __restrict__ partials, int64_t k_rows, int64_t n,
                             int64_t qblock, int64_t tiles) {
  __shared__ float smem[kWarps];
  const int64_t k = blockIdx.x % k_rows;
  const int64_t t = blockIdx.x / k_rows;
  const int64_t nb = n / qblock;
  const int8_t* row = codes + k * n;
  const int64_t start = t * kTile + (int64_t)threadIdx.x * kVec;
  float acc = 0.f;
  if (start < n) {
    alignas(16) int8_t q[kVec];
    alignas(16) float xv[kVec];
    int count = kVec;
    if (kVectorLoads) {
      // n % kVec == 0: a chunk lies wholly inside the row or wholly past it
      *reinterpret_cast<int4*>(q) = __ldg(reinterpret_cast<const int4*>(row + start));
      const float4* x4 = reinterpret_cast<const float4*>(x + start);
#pragma unroll
      for (int i = 0; i < kVec / 4; ++i) reinterpret_cast<float4*>(xv)[i] = __ldg(x4 + i);
    } else {
      const int64_t rest = n - start;  // ragged edge of the last tile
      count = rest < kVec ? (int)rest : kVec;
#pragma unroll
      for (int i = 0; i < kVec; ++i) {
        q[i] = i < count ? __ldg(row + start + i) : (int8_t)0;
        xv[i] = i < count ? __ldg(x + start + i) : 0.f;
      }
    }
    acc = chunk_sq_dist(q, xv, count, start, scale + k * nb, zero + k * nb, qblock);
  }
  acc = block_sum(acc, smem);
  if (threadIdx.x == 0) partials[k * tiles + t] = acc;
}

}  // namespace

extern "C" {

int64_t rc_dist_tiles(int64_t n) { return (n + kTile - 1) / kTile; }

const char* rc_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

int rc_int8_sq_dist_partials(const float* x, const int8_t* codes, const float* scale,
                             const float* zero, float* partials, int64_t k_rows,
                             int64_t n, int64_t qblock, void* stream) {
  const int64_t tiles = rc_dist_tiles(n);
  const bool vec = n % kVec == 0 && reinterpret_cast<uintptr_t>(codes) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(x) % 16 == 0;
  if (k_rows * tiles > INT32_MAX) return (int)cudaErrorInvalidConfiguration;
  const unsigned blocks = (unsigned)(k_rows * tiles);
  if (vec) {
    int8_sq_dist_partials_kernel<true><<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
        x, codes, scale, zero, partials, k_rows, n, qblock, tiles);
  } else {
    int8_sq_dist_partials_kernel<false><<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
        x, codes, scale, zero, partials, k_rows, n, qblock, tiles);
  }
  return (int)cudaGetLastError();
}

int rc_reduce_partials(const float* partials, float* out, int64_t k_rows, int64_t tiles,
                       void* stream) {
  reduce_partials_kernel<<<(unsigned)k_rows, kThreads, 0, (cudaStream_t)stream>>>(
      partials, out, tiles);
  return (int)cudaGetLastError();
}

}  // extern "C"
