// Hand-written Hopper (sm_90a) kernel K4: fused int8 dequantize + eq. 3
// squared distance against the rows of the compressed version ring.
//
// It replaces the Pallas TPU kernel of the JAX package's
// src/repro/kernels/ring_codec/kernel.py:
//
//   K4 int8_sq_dists_pallas (:51, body _int8_sq_dist_kernel :35)
//        -> rc_int8_sq_dists: int8_sq_dist_kernel, one cooperative launch.
//
// It computes, for int8 codes q (K, N), f32 scale and zero (K, N / qblock)
// and f32 x (N,):
//
//   d_k = sum_n (q[k, n] * scale[k, n / qblock] + zero[k, n / qblock] - x[n])^2
//
// without ever writing the K decoded f32 rows to memory.
//
// Bound on an H100 SXM (3.35 TB/s HBM3): bytes. The kernel must read each
// code once (K*N B), each scale and zero once (8*K*N/qblock B) and x once
// (4*N B), against ~5 flops per code, so it sits far below the card's flops
// line. x is 4 B an element against 1 B of code, so x read again for every
// row would cost four times the codes.
//
// Design, as the Pallas kernel's (K, block_n) tile: a task is one tile of
// kTile = 4096 elements of x, 16 per thread, loaded once into registers,
// against a chunk of rows; the blocks grid-stride over the tasks. Where the
// tiles alone fill the card's co-resident blocks (N = 16.8M: 4,096 tiles) a
// chunk is all K rows and x crosses L2 once. Where they do not (the main
// path's N = 49,152: 12 tiles) the rows are split into chunks until the
// tasks do: 12 blocks walking 10 rows each are bound by their own
// instruction latency. For a group of kRowGroup rows a thread issues the
// rows' 16-byte code loads and their first scale and zero before any
// arithmetic, so one round trip serves the group. Where qblock % 16 == 0 a
// thread's 16 codes lie in one qblock run and the per-element run check is
// compiled out; else scale and zero are reloaded where a run begins. Each
// row's block sum is block_reduce's: a shuffle tree per warp, the kWarps
// warp sums to shared memory, one barrier for the whole group, then warp j
// finishes row j of the group as block_sum's second stage does. After a
// grid-wide barrier, block b sums row b of the (K, tiles) partials in K2's
// fixed order (block_reduce.cuh::sum_rows). One launch in all; every
// (k, tile) partial and every row sum is the value a block per (k, tile)
// and a second reduction launch give.
// Measured (chip_smoke.py, NVIDIA H100 80GB HBM3, 700.00 W): (10, 49,152,
// 256) 4.5 us of profiled device time in one device operation; (16,
// 16,777,216, 256) 0.15 ms, 68% of its 0.10 ms bytes bound.
//
// Decoding uses __fmul_rn / __fadd_rn: nvcc would otherwise contract
// q * scale + zero into one FMA, and the decoded values would drift from the
// plain version's (product and sum rounded separately, as in the JAX
// package's dequant_ref).
//
// Determinism: the TPU kernel carries a (K, 1) accumulator across its
// sequential grid. CUDA blocks run in no fixed order, so each (k, tile)
// partial is written to memory and each row of partials is summed in a fixed
// order (block_reduce.cuh). No atomics: the distances feed the eq. 3 min and
// the s_min floor, so they are bit-identical from run to run.
//
// Shapes: any N with N % qblock == 0; the ragged last tile is masked. The
// 16-byte loads need N % 16 == 0 and 16-byte aligned codes and x; otherwise
// the kernel loads element by element. Indexing is 64-bit and the grid is at
// most the co-resident blocks, so N and K have no limit of the launch's.
//
// Interface: plain C, loaded with ctypes. Every entry point launches on the
// stream it is given, allocates nothing and returns a cudaError_t as an int.
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -I csrc -o libring_codec.so ring_codec.cu

#include <cuda_runtime.h>
#include <stdint.h>

#include "block_reduce.cuh"

namespace {

using block_reduce::div_index;
using block_reduce::grid_barrier;
using block_reduce::kThreads;
using block_reduce::kWarps;
using block_reduce::launch_cooperative;
using block_reduce::Residency;
using block_reduce::resident_blocks;
using block_reduce::sum_rows;
using block_reduce::warp_sum;
using block_reduce::warp_sums_total;

constexpr int kVec = 16;                  // codes per thread: one 16-byte load
constexpr int kTile = kThreads * kVec;    // 4096 elements per tile
constexpr int kRowGroup = 8;              // rows whose loads go out together
constexpr int kMinBlocks = 2;             // co-resident blocks an SM must hold
static_assert(kRowGroup <= kWarps, "warp j finishes row j of a group");

// Sum over one thread's chunk q[0..count), x[0..count) starting at element
// `start` of the row, whose qblock run b has scale s and zero z. kOneRun
// (qblock % kVec == 0, and chunks start on a multiple of kVec): the chunk
// lies inside run b. Otherwise (s, z) is reloaded where the next run begins.
template <bool kOneRun>
__device__ __forceinline__ float chunk_sq_dist(const int8_t* q, const float* xv,
                                               int count, int64_t start, int64_t b,
                                               float s, float z,
                                               const float* __restrict__ srow,
                                               const float* __restrict__ zrow,
                                               int64_t qblock) {
  int64_t next = (b + 1) * qblock;  // first element of the next qblock run
  float acc = 0.f;
#pragma unroll
  for (int i = 0; i < kVec; ++i) {
    if (i < count) {
      if (!kOneRun && start + i == next) {
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

// One cooperative launch. Phase 0 grid-strides over tasks (tile t, chunk c
// of row_chunk rows), c fastest: a block loads its tile of x once and walks
// the chunk's rows against it, writing partials[k * tiles + t]. Then a grid
// barrier and the fixed-order row sums into out (K,).
template <bool kVectorLoads, bool kOneRun>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
int8_sq_dist_kernel(const float* __restrict__ x, const int8_t* __restrict__ codes,
                    const float* __restrict__ scale, const float* __restrict__ zero,
                    float* partials, float* __restrict__ out, int64_t k_rows, int64_t n,
                    int64_t qblock, int64_t tiles, int64_t row_chunk) {
  __shared__ float sums[2][kRowGroup][kWarps];  // double-buffered: one barrier a group
  __shared__ float smem[kWarps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t nb = div_index(n, qblock);
  const int64_t chunks = div_index(k_rows + row_chunk - 1, row_chunk);
  // task = t * chunks + c, walked without a division per task
  const int64_t step_t = div_index(gridDim.x, chunks);
  const int64_t step_c = gridDim.x - step_t * chunks;
  int64_t t = div_index(blockIdx.x, chunks);
  int64_t c = blockIdx.x - t * chunks;
  int buf = 0;
  for (int64_t task = blockIdx.x; task < tiles * chunks; task += gridDim.x) {
    const int64_t k_begin = c * row_chunk;
    const int64_t k_end = k_begin + row_chunk < k_rows ? k_begin + row_chunk : k_rows;
    const int64_t start = t * kTile + (int64_t)threadIdx.x * kVec;
    const bool live = start < n;
    alignas(16) float xv[kVec];
    int count = kVec;
    int64_t b0 = 0;
    if (live) {
      if (kVectorLoads) {
        // n % kVec == 0: a chunk lies wholly inside the row or wholly past it
        const float4* x4 = reinterpret_cast<const float4*>(x + start);
#pragma unroll
        for (int i = 0; i < kVec / 4; ++i) reinterpret_cast<float4*>(xv)[i] = __ldg(x4 + i);
      } else {
        const int64_t rest = n - start;  // ragged edge of the last tile
        count = rest < kVec ? (int)rest : kVec;
#pragma unroll
        for (int i = 0; i < kVec; ++i) xv[i] = i < count ? __ldg(x + start + i) : 0.f;
      }
      b0 = div_index(start, qblock);
    }
    for (int64_t k0 = k_begin; k0 < k_end; k0 += kRowGroup) {
      // every load of the group first ...
      int4 qv[kRowGroup];
      float s0[kRowGroup], z0[kRowGroup];
#pragma unroll
      for (int j = 0; j < kRowGroup; ++j) {
        if (!live || k0 + j >= k_end) continue;
        const int8_t* row = codes + (k0 + j) * n + start;
        if (kVectorLoads) {
          qv[j] = __ldg(reinterpret_cast<const int4*>(row));
        } else {
          alignas(16) int8_t q[kVec];
#pragma unroll
          for (int i = 0; i < kVec; ++i) q[i] = i < count ? __ldg(row + i) : (int8_t)0;
          qv[j] = *reinterpret_cast<const int4*>(q);
        }
        s0[j] = __ldg(scale + (k0 + j) * nb + b0);
        z0[j] = __ldg(zero + (k0 + j) * nb + b0);
      }
      // ... then each row's chunk and its warp sum
#pragma unroll
      for (int j = 0; j < kRowGroup; ++j) {
        if (k0 + j >= k_end) continue;
        float acc = 0.f;
        if (live)
          acc = chunk_sq_dist<kOneRun>(reinterpret_cast<const int8_t*>(&qv[j]), xv, count,
                                       start, b0, s0[j], z0[j], scale + (k0 + j) * nb,
                                       zero + (k0 + j) * nb, qblock);
        acc = warp_sum(acc);
        if (lane == 0) sums[buf][j][warp] = acc;
      }
      __syncthreads();
      // warp j finishes row k0 + j, as block_sum's second stage
      if (warp < kRowGroup && k0 + warp < k_end) {
        const float r = warp_sums_total(sums[buf][warp]);
        if (lane == 0) partials[(k0 + warp) * tiles + t] = r;
      }
      buf ^= 1;
    }
    c += step_c;
    t += step_t;
    if (c >= chunks) {
      c -= chunks;
      ++t;
    }
  }
  grid_barrier();
  sum_rows(partials, out, k_rows, tiles, smem);
}

// The kernel's four instances: [16-byte loads][one qblock run a chunk].
using Kernel = void (*)(const float*, const int8_t*, const float*, const float*, float*,
                        float*, int64_t, int64_t, int64_t, int64_t, int64_t);
const Kernel kInstances[2][2] = {
    {int8_sq_dist_kernel<false, false>, int8_sq_dist_kernel<false, true>},
    {int8_sq_dist_kernel<true, false>, int8_sq_dist_kernel<true, true>}};
Residency residency[2][2];

bool vector_loads(const float* x, const int8_t* codes, int64_t n) {
  return n % kVec == 0 &&
         ((reinterpret_cast<uintptr_t>(codes) | reinterpret_cast<uintptr_t>(x)) % 16) == 0;
}

}  // namespace

extern "C" {

int64_t rc_dist_tiles(int64_t n) { return (n + kTile - 1) / kTile; }

const char* rc_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// K4 in one cooperative launch; partials is (K, rc_dist_tiles(n)) scratch
// and out (K,). A refused launch returns its error.
int rc_int8_sq_dists(const float* x, const int8_t* codes, const float* scale,
                     const float* zero, float* partials, float* out, int64_t k_rows,
                     int64_t n, int64_t qblock, void* stream) {
  if (k_rows < 1 || n < 1 || qblock < 1 || n % qblock) return (int)cudaErrorInvalidValue;
  const bool vec = vector_loads(x, codes, n);
  const bool one_run = qblock % kVec == 0;
  const Kernel kernel = kInstances[vec][one_run];
  Residency& cache = residency[vec][one_run];
  int resident = 0;
  cudaError_t err = resident_blocks(kernel, 0, cache, &resident);
  if (err != cudaSuccess) return (int)err;
  // Rows per task: all K (x read once) where the tiles alone fill the
  // card's resident blocks; fewer where they do not, so that the (tile,
  // chunk) tasks do.
  int64_t tiles = rc_dist_tiles(n);
  int64_t row_chunk = (k_rows * tiles + resident - 1) / resident;
  if (row_chunk > k_rows) row_chunk = k_rows;
  const int64_t chunks = (k_rows + row_chunk - 1) / row_chunk;
  const int64_t tasks = tiles * chunks;
  const int64_t work = tasks > k_rows ? tasks : k_rows;  // row sums: a block a row
  void* args[] = {&x,     &codes, &scale,  &zero,  &partials, &out,
                  &k_rows, &n,    &qblock, &tiles, &row_chunk};
  err = launch_cooperative(kernel, work, 0, cache, args, stream);
  return (int)err;
}

// Co-resident blocks of K4's 16-byte (vec = 1) or element-load instance for
// qblock % 16 == 0: the most blocks its cooperative grid takes. Negative:
// -(cudaError_t).
int rc_int8_resident(int vec) {
  int blocks = 0;
  const cudaError_t err = resident_blocks(kInstances[vec != 0][1], 0,
                                          residency[vec != 0][1], &blocks);
  return err == cudaSuccess ? blocks : -(int)err;
}

}  // extern "C"
