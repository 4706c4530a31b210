// Hand-written Hopper (sm_90a) kernel K5: causal / sliding-window attention
// with an online softmax, reading grouped-query K/V heads directly.
//
// It replaces the Pallas TPU kernel of the JAX package's
// src/repro/kernels/flash_attn/kernel.py:
//
//   K5 flash_attention_pallas (:70, body _flash_kernel :27) -> fa_forward.
//
// It computes, for q (B, S, H, D) and k, v (B, S, Hkv, D), H % Hkv == 0:
//
//   o[b, i, h] = sum_j softmax_j(scale * q[b, i, h] . k[b, j, h / n_rep]) v[b, j, h / n_rep]
//
// with scale = D^-0.5, n_rep = H / Hkv (the JAX package's _repeat_kv maps
// expanded head kvh * n_rep + r to kv head kvh, so head h reads h / n_rep and
// the repeat is never built), key j visible to query i where
// (!causal || i >= j) && (window <= 0 || j > i - window). Scores, running
// max m, running sum l and the accumulator are f32; masked scores count as
// -inf (the Pallas body's -1e30) and their p is 0; l is floored at 1e-20; o
// is written in q's dtype. Where the caller passes an lse buffer (the
// training path always does), each row's log-sum-exp of its scaled scores,
//
//   lse[b, h, i] = m_i + log(max(l_i, 1e-20))      (f32, (B, H, S)),
//
// is written beside o (B * H * S * 4 bytes, 2 / D of o's bytes at bf16),
// so the backward (csrc/flash_attn_bwd.cu) need not recompute it.
//
// Bound on an H100 SXM at the serving path's shape (Hymba-1.5B prefill, B = 2,
// S = 4096, H = 25, Hkv = 5, D = 64, window 1024, bf16): operations. The
// visible (query, key) pairs number 3,670,528 per (b, h), so 4 * D * pairs *
// B * H = 46.98 GFLOP, 47.5 us at 989 TFLOP/s (bf16 dense), against 62.9 MB
// of q, k, v, o (18.8 us at 3.35 TB/s).
//
// Two instances, picked by the input type alone:
//
// bf16: flash_fwd_sm90<D>, on the tensor cores. A CTA takes 128 query rows of
// one (b, h): two consumer warpgroups of 64 rows each and one producer warp.
// The producer loads the CTA's q tile once and then the (Bc = 64)-key K and V
// tiles of the band with TMA (cp.async.bulk.tensor over 3-d tensor maps of
// the (B, S, H*D) and (B, S, Hkv*D) views: rows past S arrive as zeros) into
// a ring of 4 shared-memory stages, each guarded by a "full" mbarrier (bytes
// landed) and an "empty" one (all 8 consumer warps done with it). Each
// consumer warpgroup computes, per kv tile t:
//   S_t = Q K_t^T   wgmma m64n64k16, Q and K from shared memory, K-major;
//   online softmax on the S fragment: each thread holds two rows; row max by
//                   partial maxima and the quad's shuffles; p = exp2(s *
//                   scale * log2(e) - m), one FFMA and one exp2 per score;
//                   the mask arithmetic runs only on tiles that cross the
//                   diagonal, the window's lower edge or S;
//   O += P_t V_t    wgmma m64nDk16, P from registers (the S fragment is
//                   already wgmma's A-register layout), V from shared memory
//                   read MN-major (the transpose bit).
// The loop is software-pipelined inside the warpgroup: S_t and P_{t-1} V_{t-1}
// go out together, the softmax of S_t runs while P_{t-1} V_{t-1} is still
// on the tensor cores, and the accumulator is rescaled after that product
// has landed; the two warpgroups overlap each other besides.
// P is carried as two bf16 terms, P = P_hi + P_lo, and P V is computed for
// both: one rounding of P to bf16 (2^-9 relative) moves outputs near zero by
// more than the bf16 tolerance against the f32 plain version. P_hi is p
// truncated (a byte permute), P_lo the exact remainder rounded to bf16, so
// the pair is p within 2^-16 relative, unbiased (truncating P_lo as well
// biases the sum low by up to 2^-14, which broke the bf16 tolerance on the
// card). The tensor-core work is therefore 1.5x the 4 * D FLOP per
// visible pair of the bound, on 64 x 64 tiles of the band.
// Shared tiles use the swizzle that TMA writes and the wgmma descriptors
// read: 128-byte for rows of 64 bf16 (D = 64; D = 128 and 256 as two and
// four 64-column panels), 64-byte for rows of 32 (D = 32; D = 160 as five
// 32-column panels). At D = 160 and 256, P V is one wgmma per panel (n32 or
// n64) on that panel's slice of the accumulator. D = 256 runs one consumer
// warpgroup (64 query rows a CTA, 160 threads, so up to 255 registers a
// thread for its 128-register accumulator) and 3 stages (225 KB of shared
// memory); D = 160 two consumers and 4 stages (201 KB). The band skip is
// per tile: the CTA walks only the kv tiles of [q0 - window + 1, q0 + rows
// - 1] (18 of 64 at window 1024, S = 4096, D = 64), and a warpgroup skips the products of a tile none of its rows can
// see. Query tiles run longest-first (the grid's slowest axis walks them in
// reverse), so a causal triangle's long tiles do not form the tail. No
// atomics: launches are bit-identical.
//
// f32: flash_fwd_kernel<D>, the first design, on the CUDA cores (TF32
// tensor cores would not keep the f32 parity checks). One block per (64
// query rows, head, batch), one thread per query row holding its scaled q row
// and its f32 accumulator in registers; K/V tiles staged in shared memory and
// read as a broadcast; kv tiles outside the band never loaded; inside a tile
// a thread skips each chunk of kChunk keys it cannot see. Online softmax per
// chunk in the Pallas body's order: m_new = max(m, max_j s_j); p_j = visible ?
// exp(s_j - m_new) : 0; alpha = exp(m - m_new); l = alpha * l + sum_j p_j;
// acc = acc * alpha + sum_j p_j v_j; at the end o = acc / max(l, 1e-20).
//
// Both: D in {32, 64, 128, 160, 256} (the f32 instance holds a q row and
// its accumulator in registers and spills part of them from D = 128 on; its
// K/V tiles are 64, 32 and 16 rows at D <= 64, D <= 160 and D = 256, to stay
// in 48 KB of static shared memory); ragged S is masked in-kernel (rows past
// S are never visible and never written).
//
// Interface: plain C, loaded with ctypes. fa_forward launches on the stream
// it is given, allocates nothing (lse may be null: then it is not written)
// and returns cudaGetLastError() (or the error of the tensor-map encode or
// of the shared-memory attribute). The tensor maps come from
// cuTensorMapEncodeTiled, reached through cudaGetDriverEntryPoint(ByVersion)
// (csrc/hopper.cuh), so the library needs no -lcuda.
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -I csrc -o libflash_attn.so flash_attn.cu

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

// ---- f32: CUDA-core instance ---------------------------------------------

constexpr int kBlockQ = 64;     // query rows per block, one per thread
constexpr int kChunk = 16;      // keys per online-softmax update
constexpr float kNegInf = -1e30f;

template <int D>
struct KvTile {
  // K and V tiles: 32 KB at D <= 128, 40 KB at D = 160, 32 KB at D = 256,
  // within the 48 KB of static shared memory
  static constexpr int kRows = D <= 64 ? 64 : D <= 160 ? 32 : 16;
};

template <int D>
__global__ void __launch_bounds__(kBlockQ)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o,
                 float* __restrict__ lse, int64_t seq, int heads, int kv_heads,
                 int causal, int64_t window, float scale) {
  constexpr int kRows = KvTile<D>::kRows;
  __shared__ __align__(16) float ks[kRows][D];
  __shared__ __align__(16) float vs[kRows][D];

  const int64_t q0 = (int64_t)blockIdx.x * kBlockQ;
  const int h = blockIdx.y;
  const int64_t b = blockIdx.z;
  const int hk = h / (heads / kv_heads);
  const int64_t qpos = q0 + threadIdx.x;
  const bool active = qpos < seq;

  float qr[D];
  float acc[D];
  if (active) {
    const float* qrow = q + ((b * seq + qpos) * heads + h) * D;
#pragma unroll
    for (int d = 0; d < D; ++d) qr[d] = qrow[d] * scale;
  } else {
#pragma unroll
    for (int d = 0; d < D; ++d) qr[d] = 0.f;
  }
#pragma unroll
  for (int d = 0; d < D; ++d) acc[d] = 0.f;
  float m = kNegInf;
  float l = 0.f;

  // keys this thread can see, and the kv tiles the whole block can see
  const int64_t vis_lo = window > 0 ? qpos - window + 1 : 0;
  const int64_t vis_hi = causal ? qpos : seq - 1;
  const int64_t q_last = (q0 + kBlockQ < seq ? q0 + kBlockQ : seq) - 1;
  int64_t lo = window > 0 ? q0 - window + 1 : 0;
  if (lo < 0) lo = 0;
  const int64_t hi = causal ? q_last : seq - 1;

  for (int64_t t = lo / kRows; t <= hi / kRows; ++t) {
    const int64_t k0 = t * kRows;
    __syncthreads();  // every thread is done with the previous tile
    for (int idx = threadIdx.x; idx < kRows * D; idx += kBlockQ) {
      const int r = idx / D;
      const int c = idx % D;
      const int64_t kp = k0 + r;
      float kval = 0.f;
      float vval = 0.f;
      if (kp < seq) {
        const int64_t off = ((b * seq + kp) * kv_heads + hk) * D + c;
        kval = k[off];
        vval = v[off];
      }
      ks[r][c] = kval;
      vs[r][c] = vval;
    }
    __syncthreads();
    if (!active) continue;
    for (int c0 = 0; c0 < kRows; c0 += kChunk) {
      const int64_t kc = k0 + c0;
      if (kc > vis_hi || kc + kChunk - 1 < vis_lo || kc >= seq) continue;
      float s[kChunk];
      float m_new = m;
#pragma unroll
      for (int j = 0; j < kChunk; ++j) {
        const int64_t kp = kc + j;
        const bool visible = kp < seq && kp >= vis_lo && kp <= vis_hi;
        float dot = 0.f;
#pragma unroll
        for (int d = 0; d < D; ++d) dot = fmaf(qr[d], ks[c0 + j][d], dot);
        s[j] = visible ? dot : kNegInf;
        m_new = fmaxf(m_new, s[j]);
      }
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < kChunk; ++j) {
        const int64_t kp = kc + j;
        const bool visible = kp < seq && kp >= vis_lo && kp <= vis_hi;
        s[j] = visible ? expf(s[j] - m_new) : 0.f;
        psum += s[j];
      }
      const float alpha = expf(m - m_new);
      l = alpha * l + psum;
#pragma unroll
      for (int d = 0; d < D; ++d) {
        float a = acc[d] * alpha;
#pragma unroll
        for (int j = 0; j < kChunk; ++j) a = fmaf(s[j], vs[c0 + j][d], a);
        acc[d] = a;
      }
      m = m_new;
    }
  }

  if (active) {
    const float denom = fmaxf(l, 1e-20f);
    float* orow = o + ((b * seq + qpos) * heads + h) * D;
#pragma unroll
    for (int d = 0; d < D; ++d) orow[d] = acc[d] / denom;
    if (lse != nullptr) lse[(b * heads + h) * seq + qpos] = m + logf(denom);
  }
}

// ---- bf16: tensor-core instance -------------------------------------------

constexpr int kRowsWg = 64;                      // query rows per warpgroup
constexpr int kKeys = 64;                        // keys per kv tile (Bc)
using hopper::ex2;
using hopper::kLn2;
using hopper::kLog2e;
using hopper::neg_inf;
using hopper::pack_bf16;

// D = 256 takes one consumer warpgroup and 3 stages: its accumulator is 128
// f32 registers a thread, which two consumers (288 threads, at most 224
// registers each) would spill, and two warpgroups' q (64 KB) leave room for
// 2 stages only.
template <int D>
struct Sm90 {
  static constexpr int kPanelCols = hopper::Panels<D>::kCols;  // columns per swizzle row
  static constexpr int kPanels = hopper::Panels<D>::kCount;
  static constexpr int kRowBytes = hopper::Panels<D>::kRowBytes;  // 128 or 64
  static constexpr int kConsumers = D > 160 ? 1 : 2;      // consumer warpgroups
  static constexpr int kStages = D > 160 ? 3 : 4;         // K/V ring depth
  static constexpr int kRowsCta = kRowsWg * kConsumers;   // query rows per CTA
  static constexpr int kThreads = kConsumers * 128 + 32;  // + one producer warp
  static constexpr int kQBytes = kRowsWg * D * 2;         // one warpgroup's q
  static constexpr int kTileBytes = kKeys * D * 2;        // one K or V tile
  static constexpr int kSmem = 1024 /* alignment slack */ + kConsumers * kQBytes +
                               2 * kStages * kTileBytes + (2 * kStages + 1) * 8;
  static_assert(kSmem <= 232448, "above the 227 KB a CTA may have");
};

// the upper halves of two f32 words (each truncated to bf16), packed
__device__ __forceinline__ uint32_t pack_upper(float lo, float hi) {
  return __byte_perm(__float_as_uint(lo), __float_as_uint(hi), 0x7632);
}

__device__ __forceinline__ float upper_f32(float x) {
  return __uint_as_float(__float_as_uint(x) & 0xffff0000u);
}

// O += P V for one warpgroup, P = P_hi + P_lo, over the tile's keys in steps
// of 16 (hi then lo at each step); V is read MN-major.
template <int D>
__device__ __forceinline__ void mma_pv(float (&acc)[D / 2],
                                         const uint32_t (&p_hi)[kKeys / 4],
                                         const uint32_t (&p_lo)[kKeys / 4],
                                         uint32_t v_addr) {
#pragma unroll
  for (int kk = 0; kk < kKeys / 16; ++kk) {
    hopper::mma_rs_k16<D>(acc, &p_hi[4 * kk], v_addr, kk);
    hopper::mma_rs_k16<D>(acc, &p_lo[4 * kk], v_addr, kk);
  }
}

// Online softmax on one S fragment (two rows per thread: row_a in the
// entries with bit 1 of the index clear, row_a + 8 in the others), in the
// log2 domain: mask the raw scores when the tile is not wholly visible,
// update the running max m (of scale * log2(e) * s) and this thread's share
// of the running sum l, and leave p = exp2(s * scale_log2 - m) in sc, one
// FFMA and one exp2 per score. Returns the rows' rescale factors
// exp2(m_old - m_new) in alpha.
template <int N>
__device__ __forceinline__ void softmax_step(float (&sc)[N], float (&m)[2],
                                             float (&l)[2], float (&alpha)[2],
                                             float scale_log2, bool inside, int k0,
                                             int col, int row_a, int seq, int causal,
                                             int window) {
  if (!inside) {
#pragma unroll
    for (int j = 0; j < N; ++j) {
      const int kpos = k0 + (j / 4) * 8 + col + (j & 1);
      const int qpos = row_a + ((j & 2) ? 8 : 0);
      const bool visible = kpos < seq && (!causal || kpos <= qpos) &&
                           (window <= 0 || kpos > qpos - window);
      sc[j] = visible ? sc[j] : neg_inf();
    }
  }
  // row max: four partial maxima per row, then the quad's shuffles
  float mx[2][4];
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int g = 0; g < 4; ++g) mx[r][g] = neg_inf();
#pragma unroll
  for (int j = 0; j < N; ++j)
    mx[(j >> 1) & 1][(j >> 2) & 3] = fmaxf(mx[(j >> 1) & 1][(j >> 2) & 3], sc[j]);
  float neg_m[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float v = fmaxf(fmaxf(mx[r][0], mx[r][1]), fmaxf(mx[r][2], mx[r][3]));
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
    // scale_log2 > 0, so the max of the scaled scores is the scaled max
    v = fmaxf(m[r], v * scale_log2);
    alpha[r] = ex2(m[r] - v);  // both -1e30 (nothing seen yet): 1
    m[r] = v;
    neg_m[r] = -v;
  }
  float sum[2][4] = {};
#pragma unroll
  for (int j = 0; j < N; ++j) {
    const float p = ex2(fmaf(sc[j], scale_log2, neg_m[(j >> 1) & 1]));  // masked: 0
    sc[j] = p;
    sum[(j >> 1) & 1][(j >> 2) & 3] += p;
  }
#pragma unroll
  for (int r = 0; r < 2; ++r)
    l[r] = l[r] * alpha[r] + ((sum[r][0] + sum[r][1]) + (sum[r][2] + sum[r][3]));
}

// p (f32) -> P_hi + P_lo (bf16 pairs) in wgmma's A-register order. P_hi is
// p truncated to its upper 16 bits (a byte permute, no conversion unit);
// the remainder p - P_hi is exact in f32 and below 2^-7 p, and P_lo is it
// rounded to bf16, so P_hi + P_lo is p within 2^-16 relative, unbiased.
template <int N>
__device__ __forceinline__ void split_p(const float (&sc)[N], uint32_t (&p_hi)[N / 2],
                                        uint32_t (&p_lo)[N / 2]) {
#pragma unroll
  for (int j = 0; j < N / 2; ++j) {
    const float x0 = sc[2 * j], x1 = sc[2 * j + 1];
    p_hi[j] = pack_upper(x0, x1);
    p_lo[j] = pack_bf16(x0 - upper_f32(x0), x1 - upper_f32(x1));
  }
}

template <int D>
__global__ void __launch_bounds__(Sm90<D>::kThreads, 1)
flash_fwd_sm90(const __grid_constant__ CUtensorMap tm_q,
               const __grid_constant__ CUtensorMap tm_k,
               const __grid_constant__ CUtensorMap tm_v,
               __nv_bfloat16* __restrict__ o, float* __restrict__ lse, int seq,
               int heads, int n_rep, int causal, int window, float scale_log2) {
  using C = Sm90<D>;
  using namespace hopper;
  constexpr int kConsumers = C::kConsumers;
  constexpr int kStages = C::kStages;
  constexpr int kRowsCta = C::kRowsCta;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  // the swizzle patterns repeat every 1024 bytes of the shared address
  uint8_t* sq = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  uint8_t* sk = sq + kConsumers * C::kQBytes;
  uint8_t* sv = sk + kStages * C::kTileBytes;
  uint64_t* full = reinterpret_cast<uint64_t*>(sv + kStages * C::kTileBytes);
  uint64_t* empty = full + kStages;
  uint64_t* q_full = empty + kStages;

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int q0 = (int)(gridDim.z - 1 - blockIdx.z) * kRowsCta;  // longest first
  const int hk = h / n_rep;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  // kv tiles of the CTA's band
  const int q_last = min(q0 + kRowsCta, seq) - 1;
  const int t_lo = (window > 0 ? max(0, q0 - window + 1) : 0) / kKeys;
  const int t_hi = (causal ? q_last : seq - 1) / kKeys;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumers * 4);
    }
    mbar_init(q_full, 1);
    fence_barrier_init();
  }
  __syncthreads();

  if (warp == kConsumers * 4) {
    // producer: q once, then the band's K/V tiles through the ring
    if (lane == 0) {
      const int n_wg = min(kConsumers, (seq - q0 + kRowsWg - 1) / kRowsWg);
      mbar_arrive_expect_tx(q_full, n_wg * C::kQBytes);
      for (int g = 0; g < n_wg; ++g)
        for (int p = 0; p < C::kPanels; ++p)
          tma_load_3d(sq + g * C::kQBytes + p * kRowsWg * C::kRowBytes, &tm_q, q_full,
                      h * D + p * C::kPanelCols, q0 + g * kRowsWg, b);
      for (int t = t_lo, i = 0; t <= t_hi; ++t, ++i) {
        const int s = i % kStages;
        mbar_wait(&empty[s], ((i / kStages) & 1) ^ 1);
        mbar_arrive_expect_tx(&full[s], 2 * C::kTileBytes);
        for (int p = 0; p < C::kPanels; ++p) {
          const int off = s * C::kTileBytes + p * kKeys * C::kRowBytes;
          tma_load_3d(sk + off, &tm_k, &full[s], hk * D + p * C::kPanelCols,
                      t * kKeys, b);
          tma_load_3d(sv + off, &tm_v, &full[s], hk * D + p * C::kPanelCols,
                      t * kKeys, b);
        }
      }
    }
    return;
  }

  // consumer warpgroup wg: query rows r0 .. r0 + 63; this thread holds rows
  // row_a and row_a + 8 of the accumulator fragments
  const int wg = warp / 4;
  const int r0 = q0 + wg * kRowsWg;
  const int row_a = r0 + (warp % 4) * 16 + lane / 4;
  const int col = 2 * (lane % 4);  // this thread's first column in each 8
  // this warpgroup's tiles [wt_lo, wt_hi] (none past S); it waits for and
  // releases the CTA's other tiles without reading them
  int wt_lo = t_hi + 1, wt_hi = t_hi;
  if (r0 < seq) {
    wt_lo = (window > 0 ? max(0, r0 - window + 1) : 0) / kKeys;
    wt_hi = (causal ? min(r0 + kRowsWg, seq) - 1 : seq - 1) / kKeys;
  }
  const uint32_t q_addr = smem_addr(sq + wg * C::kQBytes);
  auto stage = [&](int t) { return (t - t_lo) % kStages; };
  auto wait_tile = [&](int t) {
    mbar_wait(&full[stage(t)], ((t - t_lo) / kStages) & 1);
  };
  auto release = [&](int t) {
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[stage(t)]);  // this warp is done with it
  };
  auto inside = [&](int k0) {  // every (row, key) pair of the tile visible
    return k0 + kKeys <= seq && (!causal || k0 + kKeys - 1 <= r0) &&
           (window <= 0 || k0 > r0 + kRowsWg - 1 - window);
  };

  for (int t = t_lo; t < wt_lo; ++t) {
    wait_tile(t);
    release(t);
  }

  float acc[D / 2];
#pragma unroll
  for (int j = 0; j < D / 2; ++j) acc[j] = 0.f;
  float m[2] = {kNegInf, kNegInf};  // running max per row, log2 domain
  float l[2] = {0.f, 0.f};          // this thread's share of the row sums
  float alpha[2];
  float sc[kKeys / 2];
  uint32_t p_hi[kKeys / 4], p_lo[kKeys / 4];

  if (wt_lo <= wt_hi) {
    mbar_wait(q_full, 0);
    // first tile: scores and softmax
    wait_tile(wt_lo);
    wgmma_fence();
    mma_ss<D>(sc, q_addr, smem_addr(sk + stage(wt_lo) * C::kTileBytes));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(sc);
    softmax_step(sc, m, l, alpha, scale_log2, inside(wt_lo * kKeys), wt_lo * kKeys,
                 col, row_a, seq, causal, window);
    split_p(sc, p_hi, p_lo);
    // steady state: tile t's scores run beside tile t-1's P V, and t's
    // softmax runs while that P V finishes
    for (int t = wt_lo + 1; t <= wt_hi; ++t) {
      wait_tile(t);
      wgmma_fence();
      mma_ss<D>(sc, q_addr, smem_addr(sk + stage(t) * C::kTileBytes));
      wgmma_commit();
      mma_pv<D>(acc, p_hi, p_lo, smem_addr(sv + stage(t - 1) * C::kTileBytes));
      wgmma_commit();
      wgmma_wait<1>();  // the scores
      fence_regs(sc);
      softmax_step(sc, m, l, alpha, scale_log2, inside(t * kKeys), t * kKeys, col,
                   row_a, seq, causal, window);
      wgmma_wait<0>();  // P V of tile t - 1
      fence_regs(acc);
      fence_regs(p_hi);
      fence_regs(p_lo);
      release(t - 1);
#pragma unroll
      for (int j = 0; j < D / 2; ++j) acc[j] *= alpha[(j >> 1) & 1];
      split_p(sc, p_hi, p_lo);
    }
    wgmma_fence();
    mma_pv<D>(acc, p_hi, p_lo, smem_addr(sv + stage(wt_hi) * C::kTileBytes));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
    fence_regs(p_hi);
    fence_regs(p_lo);
    release(wt_hi);
  }

  for (int t = max(wt_hi + 1, wt_lo); t <= t_hi; ++t) {
    wait_tile(t);
    release(t);
  }
  if (wt_lo > wt_hi) return;  // no rows below S

  // o = acc / max(l, 1e-20) and lse = m ln 2 + ln(max(l, 1e-20)), rows
  // below S only
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    l[r] = fmaxf(l[r], 1e-20f);
    if (lse != nullptr && (lane & 3) == 0 && row_a + 8 * r < seq)
      lse[((int64_t)b * heads + h) * seq + row_a + 8 * r] = m[r] * kLn2 + logf(l[r]);
  }
  const int64_t stride = (int64_t)heads * D;
  __nv_bfloat16* o_a = o + ((int64_t)b * seq + row_a) * stride + (int64_t)h * D + col;
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int r = 0; r < 2; ++r)
      if (row_a + 8 * r < seq)
        *reinterpret_cast<uint32_t*>(o_a + 8 * r * stride + 8 * j) =
            pack_bf16(acc[4 * j + 2 * r] / l[r], acc[4 * j + 2 * r + 1] / l[r]);
}

template <int D>
cudaError_t launch_f32(const void* q, const void* k, const void* v, void* o, float* lse,
                       int64_t batch, int64_t seq, int64_t heads, int64_t kv_heads,
                       int causal, int64_t window, float scale, cudaStream_t stream) {
  const dim3 grid((unsigned)((seq + kBlockQ - 1) / kBlockQ), (unsigned)heads,
                  (unsigned)batch);
  flash_fwd_kernel<D><<<grid, kBlockQ, 0, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), lse, seq, (int)heads,
      (int)kv_heads, causal, window, scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_bf16(const void* q, const void* k, const void* v, void* o,
                        float* lse, int64_t batch, int64_t seq, int64_t heads, int64_t kv_heads,
                        int causal, int64_t window, float scale, cudaStream_t stream) {
  using C = Sm90<D>;
  CUtensorMap tm_q, tm_k, tm_v;
  if (!hopper::tensor_map(&tm_q, q, batch, seq, heads * D, C::kPanelCols, kRowsWg) ||
      !hopper::tensor_map(&tm_k, k, batch, seq, kv_heads * D, C::kPanelCols, kKeys) ||
      !hopper::tensor_map(&tm_v, v, batch, seq, kv_heads * D, C::kPanelCols, kKeys))
    return cudaErrorInvalidValue;
  const cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_sm90<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmem);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)heads, (unsigned)batch,
                  (unsigned)((seq + C::kRowsCta - 1) / C::kRowsCta));
  flash_fwd_sm90<D><<<grid, C::kThreads, C::kSmem, stream>>>(
      tm_q, tm_k, tm_v, static_cast<__nv_bfloat16*>(o), lse, (int)seq, (int)heads,
      (int)(heads / kv_heads), causal, (int)window, scale * kLog2e);
  return cudaGetLastError();
}

cudaError_t forward(const void* q, const void* k, const void* v, void* o, float* lse,
                    int64_t batch, int64_t seq, int64_t heads, int64_t kv_heads,
                    int64_t dim, int dtype, int causal, int64_t window, float scale,
                    cudaStream_t s) {
  if (dtype == 0)
    return hopper::by_dim(dim, [&](auto d) {
      return launch_f32<decltype(d)::value>(q, k, v, o, lse, batch, seq, heads, kv_heads,
                                            causal, window, scale, s);
    });
  if (dtype == 1)
    return hopper::by_dim(dim, [&](auto d) {
      return launch_bf16<decltype(d)::value>(q, k, v, o, lse, batch, seq, heads, kv_heads,
                                             causal, window, scale, s);
    });
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

const char* fa_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// dtype: 0 = float32, 1 = bfloat16. Returns cudaErrorInvalidValue for a
// shape or type the kernel does not take (the Python wrapper checks first).
// The bf16 instance needs 16-byte aligned q, k, v (TMA), S below 2^22 (the
// grid's query-tile axis, 64 rows a tile at D = 256) and a window below 2^31.
int fa_forward(const void* q, const void* k, const void* v, void* o, void* lse,
               int64_t batch, int64_t seq, int64_t heads, int64_t kv_heads, int64_t dim,
               int dtype, int causal, int64_t window, float scale, void* stream) {
  if (batch < 1 || seq < 1 || kv_heads < 1 || heads % kv_heads || heads > 65535 ||
      batch > 65535)
    return (int)cudaErrorInvalidValue;
  if (dtype == 1 && ((seq + kRowsWg - 1) / kRowsWg > 65535 || window > 0x7fffffff ||
                     ((uintptr_t)q | (uintptr_t)k | (uintptr_t)v) % 16))
    return (int)cudaErrorInvalidValue;
  return (int)forward(q, k, v, o, static_cast<float*>(lse), batch, seq, heads, kv_heads,
                      dim, dtype, causal, window, scale, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
