// Hand-written Hopper (sm_90a) kernels for the contribution-aware server pass.
//
// They replace the three Pallas TPU kernels of the JAX package's
// src/repro/kernels/weighted_agg/kernel.py:
//
//   K1 fused_server_pallas (:131, body _fused_server_kernel :61)
//        -> wa_fused_server: fused_server_kernel<vec>, one cooperative launch;
//   K2 sq_dists_pallas     (:208, body _sq_dist_kernel :190)
//        -> wa_sq_dists: sq_dist_kernel<group>, one ordinary launch;
//   K3 weighted_sum_pallas (:41, body _weighted_sum_kernel :34)
//        -> wa_weighted_sum.
//
// Bound on an H100 SXM (3.35 TB/s HBM3): every kernel here is a stream over
// (K, N) f32 rows with O(1) arithmetic per element, so bytes bound it:
//   K1 reads x, bases, deltas and writes upd: (2K+2)*N*4 B;
//   K2 reads x and bases:                     (K+1)*N*4 B;
//   K3 reads deltas and writes the output:    (K+1)*N*4 B.
// Each element is loaded once, by neighbouring threads at neighbouring
// addresses (coalesced along N), with several independent loads per thread
// in flight.
//
// K2 (sq_dist_kernel<group>) is one ordinary launch of a block per task; a
// task is K1's phase-0 task (dist_task): one 2048-element tile of x against
// a group of 1 or 4 rows, x loaded once for the group and all of the
// group's loads in flight before any arithmetic. Tasks run the group
// fastest, so the blocks of one tile share it through L2. A block writes its
// group's partials, fences, and takes an arrival ticket on the group's
// counter (atomicInc, which wraps to 0 on the last ticket, so the counters
// are zero again for the next call). The block that draws the last ticket
// sums each row of the group in row_sum's order (group_row_sums) and writes
// dists; the others exit at once: no grid barrier, no second launch. The
// group size is the wrapper's, from the shape (kernel.py): 4 rows where
// those tasks give every SM a block, else 1. Groups of 2 rows and a
// cooperative form (K1's front half) were measured and not kept (PERF.md
// §6, PR 17).
//
// K1 (fused_server_kernel) is one cooperative launch of min(work,
// co-resident) 256-thread blocks (block_reduce.cuh::launch_cooperative);
// every phase is a grid-stride loop:
//   phase 0  the (k, tile) distance partials, each thread's share by K2's
//            own code (tile_load, dist_thread_sum); a task is one tile of x
//            against 4 rows: x loaded once, all 5 rows' loads in flight
//            together, the 4 block sums behind one block barrier;
//   barrier
//   rows     block b sums row b of the partials in K2's fixed order
//            (block_reduce.cuh::sum_rows) and writes dists[b];
//   barrier
//   weights  every block holds the K distances, p, tau and mask in shared
//            memory (p, tau, mask loaded before phase 0) and its warp 0 runs
//            the weights step (weights_step), so every block has the same
//            w_scaled without a third barrier; block 0 writes w;
//   phase 1  K3's tiles (weighted_sum_tile, the code K3 runs, 16-row load
//            groups), four 64-thread tiles a block, tile s * gridDim.x + b in
//            sub-block s, so the first gridDim.x tiles land on distinct blocks.
// __launch_bounds__(256, 2): up to 128 registers, 2 blocks an SM. Both
// phases stream HBM, and the bytes a thread keeps in flight weigh more there
// than the threads an SM holds: 4 blocks an SM at 64 registers (4-row eq. 5
// groups, one row per phase-0 task) were slower at N = 16.8M and no faster
// at the main path. One launch also spares the host three dispatches; a
// null mask means "every slot arrived", so no all-ones mask is filled
// either. K1's distances are K2's and its update is K3's on w_scaled, bit
// for bit: each partial, the row sums and each element's fmaf chain run the
// same code, and the weights step computes every value as a serial walk
// over k does.
// Measured (chip_smoke.py, NVIDIA H100 80GB HBM3, 700.00 W): see PERF.md §6;
// at (10, 49,152) most of the time is the two grid barriers, the row sums
// between them and the dependent steps of each phase.
//
// K3 (weighted_sum_kernel, 64 threads x 4 elements a block). At the main
// path's shape (K = 10, N = 49,152: 1.97 MB) the bytes take 0.6 us, so what
// bounds it in practice is latency: how many dependent memory round trips a
// thread waits for, and how many SMs have loads in flight. So:
//   - 192 blocks at N = 49,152, so every SM has loads in flight;
//   - k walked in groups of kGroup rows (16 for K3), unrolled, the tail
//     group masked: a thread issues all loads of a group back to back and
//     pays one round trip per group, not one per row;
//   - a thread's 4 elements load as one float4 where every row start and the
//     output are 16-byte aligned (N % 4 == 0 and aligned pointers); otherwise
//     4 scalar loads spaced kSumThreads apart, each coalesced across a warp;
//   - each output element is owned by one thread: no atomics.
// Op order: out[n] = fmaf(w[K-1], d[K-1, n], ... fmaf(w[0], d[0, n], 0.f)),
// k in order 0..K-1, one FMA chain per element, whatever the group size.
// Measured (chip_smoke.py, NVIDIA H100 80GB HBM3, 700.00 W): at (10, 49,152)
// 1.62 us of profiled device time (torch.matmul 3.43 us); at
// (16, 16,777,219) 0.44 ms a call, 77% of its 0.34 ms bytes bound.
//
// Determinism: the TPU kernels carry the distance sums across a sequential
// grid. CUDA blocks run in no fixed order, so every cross-block sum here is
// two-pass -- per-block partials, then a reduction in a fixed order
// (block_reduce.cuh, shared with ring_codec.cu). An atomic is used only as
// K2's arrival ticket, never in a sum: it picks which block sums the rows,
// not the order of the sum. The eq. 3 distances feed a min and the s_min
// floor, so they are bit-identical from run to run, and K2's equal K1's.
//
// Interface: plain C, loaded with ctypes. Every entry point launches on the
// stream it is given, allocates nothing and returns a cudaError_t as an int.
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -I csrc -o libweighted_agg.so weighted_agg.cu

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

constexpr int kDistElems = 8;              // K2: elements per thread per tile
constexpr int kDistTile = kThreads * kDistElems;   // 2048 elements
constexpr int kSumThreads = 64;            // K3: threads per tile
constexpr int kSumElems = 4;               // K3: elements per thread
constexpr int kSumTile = kSumThreads * kSumElems;  // 256 elements
constexpr int kSumGroup = 16;              // K3: rows whose loads go out together
constexpr int kDistGroup = 4;              // K1 phase 0: rows of one x tile per task
constexpr int kFusedMinBlocks = 2;         // K1: co-resident blocks an SM must hold
constexpr int kSubTiles = kThreads / kSumThreads;  // K1: K3 tiles a block runs at once
constexpr int kFusedVectors = 6;           // K1: K-vectors in shared memory

// Policy codes; kernel.py maps the policy names onto them.
enum Policy : int {
  kPaper = 0,           // w = p / max(s, s_min)
  kMultiplicative = 1,  // w = p * s
  kConstant = 2,        // fedbuff, fedasync_constant: w = 1
  kHinge = 3,           // fedasync_hinge
  kPoly = 4,            // polynomial, fedasync, fedasync_poly: (1+tau)^-a
};

// Tile t of one row (x or a row of bases): each thread takes kDistElems
// elements spaced kThreads apart; zeros past the ragged edge of the last tile.
__device__ __forceinline__ void tile_load(const float* __restrict__ row, int64_t n,
                                          int64_t t, float* v) {
  const int64_t base = t * kDistTile + threadIdx.x;
#pragma unroll
  for (int i = 0; i < kDistElems; ++i) {
    const int64_t idx = base + (int64_t)i * kThreads;
    v[i] = idx < n ? __ldg(row + idx) : 0.f;
  }
}

// One thread's share of the tile's sum of (row[n] - x[n])^2.
__device__ __forceinline__ float dist_thread_sum(const float* xs, const float* bs) {
  float acc = 0.f;
#pragma unroll
  for (int i = 0; i < kDistElems; ++i) {
    const float d = bs[i] - xs[i];
    acc += d * d;
  }
  return acc;
}

// One phase-0 task of K1 and K2: tile t of x against rows k0 .. k0 +
// kGroup - 1. x is loaded once for the group, every load of the group goes
// out before any arithmetic, and the group's block sums share one block
// barrier: block_sum's two stages, each row's warp sums in gsums[j], then
// warp j finishes row k0 + j and its lane 0 writes the (row, tile) partial.
// A caller running tasks back to back alternates two gsums buffers.
template <int kGroup>
__device__ __forceinline__ void dist_task(const float* __restrict__ x,
                                          const float* __restrict__ bases, float* partials,
                                          int64_t k_rows, int64_t n, int64_t tiles, int64_t t,
                                          int64_t k0, float (*gsums)[kWarps]) {
  static_assert(kGroup <= kWarps, "warp j finishes row j of a group");
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  float xs[kDistElems], bs[kGroup][kDistElems];
  tile_load(x, n, t, xs);
#pragma unroll
  for (int j = 0; j < kGroup; ++j)
    if (k0 + j < k_rows) tile_load(bases + (k0 + j) * n, n, t, bs[j]);
#pragma unroll
  for (int j = 0; j < kGroup; ++j) {
    if (k0 + j >= k_rows) continue;
    const float v = warp_sum(dist_thread_sum(xs, bs[j]));
    if (lane == 0) gsums[j][warp] = v;
  }
  __syncthreads();
  if (warp < kGroup && k0 + warp < k_rows) {
    const float r = warp_sums_total(gsums[warp]);
    if (lane == 0) partials[(k0 + warp) * tiles + t] = r;
  }
}

// Rows k0 .. k0 + kGroup - 1 of partials (K, tiles) into dists, each summed
// as block_reduce.cuh::row_sum does (thread i adds elements i, i + kThreads,
// ... in order, then block_sum's two stages), so the sums equal K1's
// sum_rows' bit for bit. kUnroll elements of each
// row go out before their adds (an add of 0.f past the row's end leaves a
// sum of squares unchanged). The partials were written by other blocks of
// this launch: loads through L2 (__ldcg).
template <int kGroup>
__device__ __forceinline__ void group_row_sums(const float* partials, float* __restrict__ dists,
                                               int64_t k_rows, int64_t tiles, int64_t k0,
                                               float (*gsums)[kWarps]) {
  constexpr int kUnroll = 4;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  float acc[kGroup];
#pragma unroll
  for (int j = 0; j < kGroup; ++j) acc[j] = 0.f;
  for (int64_t t0 = threadIdx.x; t0 < tiles; t0 += (int64_t)kUnroll * kThreads) {
    float v[kGroup][kUnroll];
#pragma unroll
    for (int j = 0; j < kGroup; ++j)
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int64_t t = t0 + (int64_t)u * kThreads;
        v[j][u] = (k0 + j < k_rows && t < tiles) ? __ldcg(partials + (k0 + j) * tiles + t)
                                                 : 0.f;
      }
#pragma unroll
    for (int j = 0; j < kGroup; ++j)
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) acc[j] += v[j][u];
  }
#pragma unroll
  for (int j = 0; j < kGroup; ++j) {
    const float s = warp_sum(acc[j]);
    if (lane == 0) gsums[j][warp] = s;
  }
  __syncthreads();
  if (warp < kGroup && k0 + warp < k_rows) {
    const float r = warp_sums_total(gsums[warp]);
    if (lane == 0) dists[k0 + warp] = r;
  }
}

// K2: block b runs task (t = b / groups, g = b % groups), then takes a
// ticket on counters[g]; the block that draws the group's last ticket
// (tiles - 1) sums the group's rows. atomicInc wraps the counter to 0 on
// that ticket, ready for the next call on this stream.
template <int kGroup>
__global__ void __launch_bounds__(kThreads)
sq_dist_kernel(const float* __restrict__ x, const float* __restrict__ bases, float* partials,
               unsigned int* counters, float* __restrict__ dists, int64_t k_rows, int64_t n,
               int64_t tiles, int64_t groups) {
  __shared__ float gsums[kGroup][kWarps];
  __shared__ bool last;
  const int64_t t = div_index(blockIdx.x, groups);
  const int64_t g = blockIdx.x - t * groups;
  dist_task<kGroup>(x, bases, partials, k_rows, n, tiles, t, g * kGroup, gsums);
  // lane 0 of warp j wrote row j's partial: visible before the ticket
  if ((threadIdx.x & 31) == 0 && (threadIdx.x >> 5) < kGroup) __threadfence();
  if (kGroup > 1) __syncthreads();  // at 1 row the writer is thread 0 itself
  if (threadIdx.x == 0) {
    last = atomicInc(counters + g, (unsigned int)(tiles - 1)) == (unsigned int)(tiles - 1);
    if (last) __threadfence();  // the other blocks' partials after the ticket
  }
  __syncthreads();
  if (!last) return;
  group_row_sums<kGroup>(partials, dists, k_rows, tiles, g * kGroup, gsums);
}

// Where K3's body reads the weights: global memory (K3) or shared (K1).
struct GlobalWeights {
  const float* __restrict__ w;
  __device__ __forceinline__ float operator()(int64_t k) const { return __ldg(w + k); }
};
struct SharedWeights {
  const float* w;
  __device__ __forceinline__ float operator()(int64_t k) const { return w[k]; }
};

// K3's body for one tile of kSumTile elements starting at `tile`, run by
// kSumThreads threads (lane 0..kSumThreads-1): out[n] = sum_k w[k] * d[k, n],
// k in order 0..K-1 (see the note above). kVec: each thread owns the 4
// consecutive elements of one float4; else 4 elements spaced kSumThreads
// apart.
template <bool kVec, int kGroup, typename Weights>
__device__ __forceinline__ void weighted_sum_tile(const float* __restrict__ deltas,
                                                  Weights weight, float* __restrict__ out,
                                                  int64_t k_rows, int64_t n, int64_t tile,
                                                  int lane) {
  int64_t idx[kSumElems];
#pragma unroll
  for (int i = 0; i < kSumElems; ++i)
    idx[i] = kVec ? tile + (int64_t)lane * kSumElems + i
                  : tile + lane + (int64_t)i * kSumThreads;
  float acc[kSumElems];
#pragma unroll
  for (int i = 0; i < kSumElems; ++i) acc[i] = 0.f;
  for (int64_t k0 = 0; k0 < k_rows; k0 += kGroup) {
    float wk[kGroup];
    float v[kGroup][kSumElems];
    // every load of the group first ...
#pragma unroll
    for (int j = 0; j < kGroup; ++j) {
      if (k0 + j >= k_rows) continue;
      wk[j] = weight(k0 + j);
      const float* row = deltas + (k0 + j) * n;
      if (kVec) {
        if (idx[0] < n) {
          const float4 q = __ldg(reinterpret_cast<const float4*>(row + idx[0]));
          v[j][0] = q.x;
          v[j][1] = q.y;
          v[j][2] = q.z;
          v[j][3] = q.w;
        }
      } else {
#pragma unroll
        for (int i = 0; i < kSumElems; ++i)
          if (idx[i] < n) v[j][i] = __ldg(row + idx[i]);
      }
    }
    // ... then the FMAs, in k order
#pragma unroll
    for (int j = 0; j < kGroup; ++j) {
      if (k0 + j >= k_rows) continue;
#pragma unroll
      for (int i = 0; i < kSumElems; ++i) acc[i] = fmaf(wk[j], v[j][i], acc[i]);
    }
  }
  if (kVec) {
    if (idx[0] < n)
      *reinterpret_cast<float4*>(out + idx[0]) =
          make_float4(acc[0], acc[1], acc[2], acc[3]);
  } else {
#pragma unroll
    for (int i = 0; i < kSumElems; ++i)
      if (idx[i] < n) out[idx[i]] = acc[i];
  }
}

// K3: one block per tile.
template <bool kVec>
__global__ void __launch_bounds__(kSumThreads)
weighted_sum_kernel(const float* __restrict__ deltas, const float* __restrict__ w,
                    float* __restrict__ out, int64_t k_rows, int64_t n) {
  weighted_sum_tile<kVec, kSumGroup>(deltas, GlobalWeights{w}, out, k_rows, n,
                                     (int64_t)blockIdx.x * kSumTile, threadIdx.x);
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ float warp_min(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = fminf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

// K1's weights step over shared memory, run by one warp, as
// _fused_server_kernel's `_weights` phase: eq. 3 staleness, the policy
// weight, the arrival mask, the mean normalization. Writes w (K,) and
// w_scaled = w * eta_g / k_eff (K,). The max and the min are exact in any
// order and each weight depends only on its own slot, so lanes take slots
// k = lane, lane + 32, ...; the two sums (mask, weights) stay serial in
// k order, in lane 0. Every value is the one a single thread walking the
// slots in order computes.
__device__ void weights_step(const float* d, const float* p, const float* tau,
                             const float* mask, float* w, float* w_scaled, int64_t k_rows,
                             int policy, int normalize_mean, float eta_g, float s_min,
                             float poly_a, float hinge_a, float hinge_b, float eps) {
  const int lane = threadIdx.x & 31;
  float dmax = 0.f;
  for (int64_t k = lane; k < k_rows; k += 32) dmax = fmaxf(dmax, fmaxf(d[k], 0.f));
  dmax = warp_max(dmax);
  float mn = dmax;  // absent slots park on max(d)
  for (int64_t k = lane; k < k_rows; k += 32)
    mn = fminf(mn, mask[k] > 0.f ? fmaxf(d[k], 0.f) : dmax);
  mn = warp_min(mn);
  for (int64_t k = lane; k < k_rows; k += 32) {
    const float dk = fmaxf(d[k], 0.f);
    const float s = fminf(fmaxf((mn + eps) / (dk + eps), 0.f), 1.f);
    float wk;
    switch (policy) {
      case kPaper: wk = p[k] / fmaxf(s, s_min); break;
      case kMultiplicative: wk = p[k] * s; break;
      case kConstant: wk = 1.f; break;
      case kHinge: {
        const float t = tau[k];
        wk = t <= hinge_b ? 1.f : 1.f / fmaxf(hinge_a * (t - hinge_b), 1e-12f);
        break;
      }
      default: wk = powf(1.f + tau[k], -poly_a); break;
    }
    w[k] = wk * mask[k];
  }
  __syncwarp();
  float msum = 0.f, wsum = 0.f;
  if (lane == 0)
    for (int64_t k = 0; k < k_rows; ++k) {
      msum += mask[k];
      wsum += w[k];
    }
  msum = __shfl_sync(0xffffffffu, msum, 0);
  wsum = __shfl_sync(0xffffffffu, wsum, 0);
  const float denom_n = fmaxf(msum, 1.f);
  const float scale = eta_g / fmaxf(msum, 1.f);  // eta_g / k_eff
  const float inv = fmaxf(wsum, 1e-12f);
  for (int64_t k = lane; k < k_rows; k += 32) {
    float wk = w[k];
    if (normalize_mean) wk = wk * denom_n / inv;
    w[k] = wk;
    w_scaled[k] = wk * scale;
  }
}

// K1: eq. 3 + weighting + eq. 5 in one cooperative launch (see the note
// above). mask may be null: every slot arrived. partials (K, tiles) is
// scratch; dists (K,), w (K,) and upd (N,) are the outputs. Dynamic shared
// memory: kFusedVectors * K floats.
template <bool kVec>
__global__ void __launch_bounds__(kThreads, kFusedMinBlocks)
fused_server_kernel(const float* __restrict__ x, const float* __restrict__ bases,
                    const float* __restrict__ deltas, const float* __restrict__ p,
                    const float* __restrict__ tau, const float* __restrict__ mask,
                    float* partials, float* dists, float* __restrict__ w_out,
                    float* __restrict__ upd, int64_t k_rows, int64_t n, int64_t tiles,
                    int policy, int normalize_mean, float eta_g, float s_min,
                    float poly_a, float hinge_a, float hinge_b, float eps) {
  __shared__ float smem[kWarps];
  extern __shared__ float vectors[];
  float* sd = vectors;
  float* sp = sd + k_rows;
  float* st = sp + k_rows;
  float* sm = st + k_rows;
  float* sw = sm + k_rows;
  float* sws = sw + k_rows;
  // the inputs of the weights step, loaded while phase 0 runs
  for (int64_t k = threadIdx.x; k < k_rows; k += kThreads) {
    sp[k] = __ldg(p + k);
    st[k] = __ldg(tau + k);
    sm[k] = mask ? __ldg(mask + k) : 1.f;
  }
  // phase 0: the distance partials, K2's tasks (dist_task) of kDistGroup
  // rows (task = t * groups + g), the warp sums double-buffered in shared
  // memory
  __shared__ float gsums[2][kDistGroup][kWarps];
  const int warp = threadIdx.x >> 5;
  const int64_t groups = div_index(k_rows + kDistGroup - 1, kDistGroup);
  const int64_t tasks = tiles * groups;
  const int64_t step_t = div_index(gridDim.x, groups);
  const int64_t step_g = gridDim.x - step_t * groups;
  int64_t t = div_index(blockIdx.x, groups);
  int64_t g = blockIdx.x - t * groups;
  int buf = 0;
  for (int64_t task = blockIdx.x; task < tasks; task += gridDim.x) {
    dist_task<kDistGroup>(x, bases, partials, k_rows, n, tiles, t, g * kDistGroup,
                          gsums[buf]);
    buf ^= 1;
    g += step_g;
    t += step_t;
    if (g >= groups) {
      g -= groups;
      ++t;
    }
  }
  grid_barrier();
  sum_rows(partials, dists, k_rows, tiles, smem);
  grid_barrier();
  for (int64_t r = threadIdx.x; r < k_rows; r += kThreads)
    sd[r] = __ldcg(dists + r);  // written by this launch: through L2
  __syncthreads();

  // weights: the same step in every block, over its own shared copy
  if (warp == 0)
    weights_step(sd, sp, st, sm, sw, sws, k_rows, policy, normalize_mean, eta_g, s_min,
                 poly_a, hinge_a, hinge_b, eps);
  __syncthreads();
  if (blockIdx.x == 0)
    for (int64_t r = threadIdx.x; r < k_rows; r += kThreads) w_out[r] = sw[r];

  // phase 1: K3's tiles, kSubTiles at once per block
  const int64_t sub = threadIdx.x / kSumThreads;
  const int64_t sum_tiles = (n + kSumTile - 1) / kSumTile;
  for (int64_t s = sub * gridDim.x + blockIdx.x; s < sum_tiles;
       s += (int64_t)kSubTiles * gridDim.x)
    weighted_sum_tile<kVec, kSumGroup>(deltas, SharedWeights{sws}, upd, k_rows, n,
                                         s * kSumTile, threadIdx.x % kSumThreads);
}

Residency fused_residency[2];  // per instance: scalar, float4

// float4 loads need every row start (rows + k * n) and out 16-byte aligned
bool aligned4(const float* rows, const float* out, int64_t n) {
  return n % kSumElems == 0 &&
         ((reinterpret_cast<uintptr_t>(rows) | reinterpret_cast<uintptr_t>(out)) % 16) ==
             0;
}

uint32_t fused_smem(int64_t k_rows) {
  return (uint32_t)(kFusedVectors * k_rows * sizeof(float));
}

}  // namespace

extern "C" {

int64_t wa_dist_tiles(int64_t n) { return (n + kDistTile - 1) / kDistTile; }

const char* wa_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// K2 in one launch: dists (K,) = ||x - b_k||^2 from tasks of `group` rows
// (1 or 4). partials is (K, wa_dist_tiles(n)) scratch; counters holds
// ceil(K / group) arrival tickets, zero before the call and zero again after
// it, used by one stream at a time.
int wa_sq_dists(const float* x, const float* bases, float* partials, unsigned int* counters,
                float* dists, int64_t k_rows, int64_t n, int group, void* stream) {
  if (k_rows < 1 || n < 1) return (int)cudaErrorInvalidValue;
  const int64_t tiles = wa_dist_tiles(n);
  const int64_t groups = (k_rows + group - 1) / group;
  const unsigned blocks = (unsigned)(tiles * groups);
  const cudaStream_t s = (cudaStream_t)stream;
  switch (group) {
    case 1:
      sq_dist_kernel<1><<<blocks, kThreads, 0, s>>>(x, bases, partials, counters, dists,
                                                     k_rows, n, tiles, groups);
      break;
    case 4:
      sq_dist_kernel<4><<<blocks, kThreads, 0, s>>>(x, bases, partials, counters, dists,
                                                     k_rows, n, tiles, groups);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

int wa_weighted_sum(const float* deltas, const float* w, float* out, int64_t k_rows,
                    int64_t n, void* stream) {
  const unsigned blocks = (unsigned)((n + kSumTile - 1) / kSumTile);
  if (aligned4(deltas, out, n))
    weighted_sum_kernel<true><<<blocks, kSumThreads, 0, (cudaStream_t)stream>>>(
        deltas, w, out, k_rows, n);
  else
    weighted_sum_kernel<false><<<blocks, kSumThreads, 0, (cudaStream_t)stream>>>(
        deltas, w, out, k_rows, n);
  return (int)cudaGetLastError();
}

// K1 in one cooperative launch. mask may be null (every slot arrived);
// partials is (K, wa_dist_tiles(n)) scratch. A refused launch (a grid the
// card cannot hold at once, or too much shared memory for K) returns its
// error.
int wa_fused_server(const float* x, const float* bases, const float* deltas,
                    const float* p, const float* tau, const float* mask, float* partials,
                    float* dists, float* w, float* upd, int64_t k_rows, int64_t n,
                    int policy, int normalize_mean, float eta_g, float s_min,
                    float poly_a, float hinge_a, float hinge_b, float eps,
                    void* stream) {
  int64_t tiles = wa_dist_tiles(n);
  const int64_t sum_tiles = (n + kSumTile - 1) / kSumTile;
  const int64_t tasks = k_rows * tiles;
  const int64_t work = tasks > sum_tiles ? tasks : sum_tiles;
  void* args[] = {&x,     &bases,  &deltas, &p,      &tau,    &mask,   &partials,
                  &dists, &w,      &upd,    &k_rows, &n,      &tiles,  &policy,
                  &normalize_mean, &eta_g,  &s_min,  &poly_a, &hinge_a, &hinge_b,
                  &eps};
  const bool vec = aligned4(deltas, upd, n);
  const cudaError_t err =
      vec ? launch_cooperative(fused_server_kernel<true>, work, fused_smem(k_rows),
                               fused_residency[1], args, stream)
          : launch_cooperative(fused_server_kernel<false>, work, fused_smem(k_rows),
                               fused_residency[0], args, stream);
  return (int)err;
}

// Co-resident blocks of K1's float4 (vec = 1) or scalar instance at K rows:
// the most blocks its cooperative grid takes. Negative: -(cudaError_t).
int wa_fused_resident(int64_t k_rows, int vec) {
  int blocks = 0;
  const cudaError_t err =
      vec ? resident_blocks(fused_server_kernel<true>, fused_smem(k_rows),
                            fused_residency[1], &blocks)
          : resident_blocks(fused_server_kernel<false>, fused_smem(k_rows),
                            fused_residency[0], &blocks);
  return err == cudaSuccess ? blocks : -(int)err;
}

}  // extern "C"
