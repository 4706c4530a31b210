// Hand-written Hopper (sm_90a) kernels for the contribution-aware server pass.
//
// They replace the three Pallas TPU kernels of the JAX package's
// src/repro/kernels/weighted_agg/kernel.py:
//
//   K1 fused_server_pallas (:131, body _fused_server_kernel :61)
//        -> wa_fused_weights, launched between the K2 partial pass and the
//           K3 pass by kernel.py::fused_server (three launches, one call);
//   K2 sq_dists_pallas     (:208, body _sq_dist_kernel :190)
//        -> wa_sq_dist_partials + wa_reduce_partials;
//   K3 weighted_sum_pallas (:41, body _weighted_sum_kernel :34)
//        -> wa_weighted_sum.
//
// Bound on an H100 SXM (3.35 TB/s HBM3): every kernel here is a stream over
// (K, N) f32 rows with O(1) arithmetic per element, so bytes bound it:
//   K1 reads x, bases, deltas and writes upd: (2K+2)*N*4 B;
//   K2 reads x and bases:                     (K+1)*N*4 B;
//   K3 reads deltas and writes the output:    (K+1)*N*4 B.
// What the design does about it (K1, K2): each element is loaded once, by
// neighbouring threads at neighbouring addresses (coalesced along N), with
// ELEMS independent loads per thread in flight; the K2 grid runs k fastest
// so the K blocks of one N-tile share that tile of x through L2 and x costs
// one pass from HBM; the K1 weights step touches only the (K, tiles)
// partials and (K,) vectors, so bases and deltas are each read once and no
// intermediate leaves the device.
//
// K3 (weighted_sum_kernel; also K1's third launch). At the main path's shape
// (K = 10, N = 49,152: 1.97 MB) the bytes take 0.6 us, so what bounds it in
// practice is latency: how many dependent memory round trips a thread waits
// for, and how many SMs have loads in flight. The first design took 256
// threads x 4 elements per block (48 blocks for 132 SMs) and walked k in a
// loop whose trip count was known only at run time, so each row's loads
// were consumed before the next row's were issued: up to K round trips per
// thread. This design:
//   - takes kSumThreads = 64 threads x 4 elements per block, 192 blocks at
//     N = 49,152, so every SM has loads in flight;
//   - walks k in groups of kSumGroup = 16 rows, unrolled, with the tail group
//     masked: a thread issues all loads of a group back to back and pays one
//     round trip per group (one for every K <= 16, two for K = 32), not one
//     per row;
//   - loads a thread's 4 elements as one float4 where every row start and
//     the output are 16-byte aligned (N % 4 == 0 and aligned pointers);
//     otherwise (odd rows at N = 44,426, 130,007, 16,777,219) 4 scalar loads
//     spaced kSumThreads apart, each coalesced across the warp;
//   - owns each output element in one thread: no atomics, no shared memory.
// Op order: out[n] = fmaf(w[K-1], d[K-1, n], ... fmaf(w[0], d[0, n], 0.f)),
// k in order 0..K-1, one FMA chain per element, as the first design's
// contracted `acc += w * d`; the update of eq. 5 is bit-for-bit unchanged.
// Measured (chip_smoke.py, NVIDIA H100 80GB HBM3, 700.00 W; PERF.md has
// both runs): at (10, 49,152) 1.62 us of profiled device time, against
// 3.65 us for the first design and 3.43 us for torch.matmul(w, deltas); at
// (32, 130,007) 5.7 us (matmul 4.8 us: two row groups); at
// (16, 16,777,219) 0.44 ms a call, 77% of its 0.34 ms bytes bound.
// 32-row groups measured slower at the main and largest shapes; 128-thread
// blocks (96 blocks at the main shape) about the same.
//
// Determinism: the TPU kernels carry the distance sums across a sequential
// grid. CUDA blocks run in no fixed order, so every cross-block sum here is
// two-pass -- per-block partials, then a reduction in a fixed order
// (block_reduce.cuh, shared with ring_codec.cu) -- and no kernel uses
// atomics. The eq. 3 distances feed a min and the s_min floor,
// so they are bit-identical from run to run.
//
// Interface: plain C, loaded with ctypes. Every entry point launches on the
// stream it is given, allocates nothing and returns cudaGetLastError().
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -I csrc -o libweighted_agg.so weighted_agg.cu

#include <cuda_runtime.h>
#include <stdint.h>

#include "block_reduce.cuh"

namespace {

using block_reduce::block_sum;
using block_reduce::kThreads;
using block_reduce::kWarps;
using block_reduce::reduce_partials_kernel;
using block_reduce::row_sum;

constexpr int kDistElems = 8;              // K2: elements per thread per tile
constexpr int kDistTile = kThreads * kDistElems;   // 2048 elements
constexpr int kSumThreads = 64;            // K3: threads per block
constexpr int kSumElems = 4;               // K3: elements per thread
constexpr int kSumTile = kSumThreads * kSumElems;  // 256 elements
constexpr int kSumGroup = 16;              // K3: rows whose loads go out together

// Policy codes; kernel.py maps the policy names onto them.
enum Policy : int {
  kPaper = 0,           // w = p / max(s, s_min)
  kMultiplicative = 1,  // w = p * s
  kConstant = 2,        // fedbuff, fedasync_constant: w = 1
  kHinge = 3,           // fedasync_hinge
  kPoly = 4,            // polynomial, fedasync, fedasync_poly: (1+tau)^-a
};

// K2 phase 0: partials[k * tiles + t] = sum over tile t of (b[k, n] - x[n])^2.
// Block b handles (k = b % K, t = b / K): k runs fastest, so the K blocks of
// one tile run close together and share the tile of x through L2.
__global__ void __launch_bounds__(kThreads)
sq_dist_partials_kernel(const float* __restrict__ x, const float* __restrict__ bases,
                        float* __restrict__ partials, int64_t k_rows, int64_t n,
                        int64_t tiles) {
  __shared__ float smem[kWarps];
  const int64_t k = blockIdx.x % k_rows;
  const int64_t t = blockIdx.x / k_rows;
  const float* row = bases + k * n;
  const int64_t base = t * kDistTile + threadIdx.x;
  float xs[kDistElems], bs[kDistElems];
#pragma unroll
  for (int i = 0; i < kDistElems; ++i) {
    const int64_t idx = base + (int64_t)i * kThreads;
    const bool ok = idx < n;  // ragged edge of the last tile
    xs[i] = ok ? __ldg(x + idx) : 0.f;
    bs[i] = ok ? __ldg(row + idx) : 0.f;
  }
  float acc = 0.f;
#pragma unroll
  for (int i = 0; i < kDistElems; ++i) {
    const float d = bs[i] - xs[i];
    acc += d * d;
  }
  acc = block_sum(acc, smem);
  if (threadIdx.x == 0) partials[k * tiles + t] = acc;
}

// K1's boundary step, one block: reduce the distance partials, then eq. 3
// staleness, the policy weight, the arrival mask and the mean normalization,
// exactly as _fused_server_kernel's `_weights` phase. Writes dists (K,),
// w (K,) and w_scaled = w * eta_g / k_eff (K,) for the K3 pass.
__global__ void __launch_bounds__(kThreads)
fused_weights_kernel(const float* __restrict__ partials, const float* __restrict__ p,
                     const float* __restrict__ tau, const float* __restrict__ mask,
                     float* __restrict__ dists, float* __restrict__ w,
                     float* __restrict__ w_scaled, int k_rows, int64_t tiles, int policy,
                     int normalize_mean, float eta_g, float s_min, float poly_a,
                     float hinge_a, float hinge_b, float eps) {
  __shared__ float smem[kWarps];
  for (int k = 0; k < k_rows; ++k) {
    const float r = row_sum(partials + (int64_t)k * tiles, tiles, smem);
    if (threadIdx.x == 0) dists[k] = r;
  }
  if (threadIdx.x != 0) return;
  // From here on one thread walks the K-vector in order: K is the buffer
  // size (tens), and a serial walk fixes every summation order.
  float dmax = 0.f;
  for (int k = 0; k < k_rows; ++k) dmax = fmaxf(dmax, fmaxf(dists[k], 0.f));
  float mn = dmax;  // absent slots park on max(d)
  float msum = 0.f;
  for (int k = 0; k < k_rows; ++k) {
    const float d = fmaxf(dists[k], 0.f);
    mn = fminf(mn, mask[k] > 0.f ? d : dmax);
    msum += mask[k];
  }
  float wsum = 0.f;
  for (int k = 0; k < k_rows; ++k) {
    const float d = fmaxf(dists[k], 0.f);
    const float s = fminf(fmaxf((mn + eps) / (d + eps), 0.f), 1.f);
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
    wk *= mask[k];
    w[k] = wk;
    wsum += wk;
  }
  const float denom_n = fmaxf(msum, 1.f);
  const float scale = eta_g / fmaxf(msum, 1.f);  // eta_g / k_eff
  const float inv = fmaxf(wsum, 1e-12f);
  for (int k = 0; k < k_rows; ++k) {
    float wk = w[k];
    if (normalize_mean) wk = wk * denom_n / inv;
    w[k] = wk;
    w_scaled[k] = wk * scale;
  }
}

// K3: out[n] = sum_k w[k] * d[k, n], k in order 0..K-1 (see the note above).
// kVec: each thread owns the 4 consecutive elements of one float4; else 4
// elements spaced kSumThreads apart. Both cover a tile of kSumTile elements.
template <bool kVec>
__global__ void __launch_bounds__(kSumThreads)
weighted_sum_kernel(const float* __restrict__ deltas, const float* __restrict__ w,
                    float* __restrict__ out, int64_t k_rows, int64_t n) {
  const int64_t tile = (int64_t)blockIdx.x * kSumTile;
  int64_t idx[kSumElems];
#pragma unroll
  for (int i = 0; i < kSumElems; ++i)
    idx[i] = kVec ? tile + (int64_t)threadIdx.x * kSumElems + i
                  : tile + threadIdx.x + (int64_t)i * kSumThreads;
  float acc[kSumElems];
#pragma unroll
  for (int i = 0; i < kSumElems; ++i) acc[i] = 0.f;
  for (int64_t k0 = 0; k0 < k_rows; k0 += kSumGroup) {
    float wk[kSumGroup];
    float v[kSumGroup][kSumElems];
    // every load of the group first ...
#pragma unroll
    for (int j = 0; j < kSumGroup; ++j) {
      if (k0 + j >= k_rows) continue;
      wk[j] = __ldg(w + k0 + j);
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
    for (int j = 0; j < kSumGroup; ++j) {
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

}  // namespace

extern "C" {

int64_t wa_dist_tiles(int64_t n) { return (n + kDistTile - 1) / kDistTile; }

const char* wa_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

int wa_sq_dist_partials(const float* x, const float* bases, float* partials,
                        int64_t k_rows, int64_t n, void* stream) {
  const int64_t tiles = wa_dist_tiles(n);
  sq_dist_partials_kernel<<<(unsigned)(k_rows * tiles), kThreads, 0,
                            (cudaStream_t)stream>>>(x, bases, partials, k_rows, n, tiles);
  return (int)cudaGetLastError();
}

int wa_reduce_partials(const float* partials, float* out, int64_t k_rows, int64_t tiles,
                       void* stream) {
  reduce_partials_kernel<<<(unsigned)k_rows, kThreads, 0, (cudaStream_t)stream>>>(
      partials, out, tiles);
  return (int)cudaGetLastError();
}

int wa_fused_weights(const float* partials, const float* p, const float* tau,
                     const float* mask, float* dists, float* w, float* w_scaled,
                     int k_rows, int64_t tiles, int policy, int normalize_mean,
                     float eta_g, float s_min, float poly_a, float hinge_a,
                     float hinge_b, float eps, void* stream) {
  fused_weights_kernel<<<1, kThreads, 0, (cudaStream_t)stream>>>(
      partials, p, tau, mask, dists, w, w_scaled, k_rows, tiles, policy,
      normalize_mean, eta_g, s_min, poly_a, hinge_a, hinge_b, eps);
  return (int)cudaGetLastError();
}

int wa_weighted_sum(const float* deltas, const float* w, float* out, int64_t k_rows,
                    int64_t n, void* stream) {
  const unsigned blocks = (unsigned)((n + kSumTile - 1) / kSumTile);
  // float4 loads need every row start (deltas + k * n) and out 16-byte aligned
  const bool vec = n % kSumElems == 0 &&
                   ((reinterpret_cast<uintptr_t>(deltas) |
                     reinterpret_cast<uintptr_t>(out)) % 16) == 0;
  if (vec)
    weighted_sum_kernel<true><<<blocks, kSumThreads, 0, (cudaStream_t)stream>>>(
        deltas, w, out, k_rows, n);
  else
    weighted_sum_kernel<false><<<blocks, kSumThreads, 0, (cudaStream_t)stream>>>(
        deltas, w, out, k_rows, n);
  return (int)cudaGetLastError();
}

}  // extern "C"
