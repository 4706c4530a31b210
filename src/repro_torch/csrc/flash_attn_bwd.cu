// Hand-written Hopper (sm_90a) kernels: the backward of K5 (causal /
// sliding-window attention with grouped-query K/V heads).
//
// The JAX package has no TPU kernel for this: it trains through the plain
// jnp attention of src/repro/models/attention.py (_full_attention and
// _sliding_window_attention, :86-166) and lets jax.grad differentiate it.
// The port's forward is the CUDA kernel of csrc/flash_attn.cu, so its
// gradient is a kernel too: fa_backward here.
//
// For q (B, S, H, D), k, v (B, S, Hkv, D), the forward's output o, its
// row log-sum-exps lse (B, H, S) f32 (written by K5's forward) and the
// cotangent do (B, S, H, D), with scale = D^-0.5, head h reading kv head
// h / n_rep (n_rep = H / Hkv), key j visible to query i where
// (!causal || i >= j) && (window <= 0 || j > i - window):
//
//   s_ij   = scale * q_i . k_j                     (visible pairs only)
//   p_ij   = exp(s_ij - lse_i)
//   D_i    = sum_d do_i[d] * o_i[d]
//   ds_ij  = p_ij * (do_i . v_j - D_i)
//   dq_i   = scale * sum_j ds_ij k_j
//   dk_j   = scale * sum_{h in j's group} sum_i ds_ij q_i
//   dv_j   = sum_{h in j's group} sum_i p_ij do_i
//
// Every sum is f32; the outputs are written in q's dtype. Masked pairs have
// p = 0. Two kernels a call (three at bf16 D 160 / 256), no float atomics
// anywhere, so two launches give the same bits:
//   dQ     a block per query tile of one (b, h): D_i of its rows into an
//          f32 scratch (B, H, S), then the visible key tiles: S = Q K^T,
//          dP = dO V^T, dS, and dQ += dS K in registers, written once.
//   dK/dV  a block per key tile of one (b, kv head): it loops over the
//          n_rep query heads of its group and, for each, over only the
//          query tiles that can see its keys, reading lse and D; dK and dV
//          stay in registers and are written once, so the GQA sum is inside
//          the block. Key tiles run in order: under the causal mask the
//          first see the most queries, so the longest blocks start first
//          (the dQ grid walks its query tiles in reverse for the same
//          reason).
// Both skip the tiles outside the band (per tile, not per pair).
//
// bf16: fa_bwd_dq_sm90<D> and fa_bwd_dkdv_sm90<D, mode>, on the tensor
// cores, built like the forward's flash_fwd_sm90 (helpers in
// csrc/hopper.cuh): a CTA of n consumer warpgroups of 64 rows each and a
// producer warpgroup, one warp of which loads the CTA's own tiles once with
// TMA (Q and dO in dQ; K and V in dK/dV) and streams the walked 64-row tiles
// (K and V; Q and dO with their 64 lse and D values, which its lanes store)
// through a ring of mbarrier-guarded stages. Per walked tile, a consumer
// warpgroup runs
//   dQ:    S = Q K^T and dP = dO V^T   wgmma SS, both K-major;
//          P = exp2(S scale log2(e) - lse_i log2(e)), one FFMA and one exp2
//          a score, the mask arithmetic only on tiles that cross the
//          diagonal, the window's edge or S; dS = P (dP - D_i) in registers;
//          dQ += dS K                  wgmma RS: the dS fragment is already
//                                      wgmma's A-register layout, K is read
//                                      MN-major (the transpose bit).
//   dK/dV: S^T = K Q^T                 SS; P^T from the column's lse;
//          dV += P^T dO                RS, dO MN-major;
//          dP^T = V dO^T               SS;
//          dS^T = P^T (dP^T - D_col);
//          dK += dS^T Q                RS, Q MN-major.
// The operands are swapped (S^T, not S), so P^T and dS^T come out of the
// accumulator in the A-register layout and nothing goes through shared
// memory. P^T and dS^T enter the tensor cores rounded to bf16 once (dS^T from
// the rounded P^T, dQ's dS from the f32 P): unlike the forward's P, one
// rounding keeps the bf16 tolerance, because a gradient is held at 4e-3 of
// the largest one (tests/test_torch_flash_attn.py emulates these roundings
// on the CPU). A tile's last product (dQ += dS K; dK += dS^T Q) runs on the
// tensor cores while the next tile's scores are issued; the two warpgroups
// overlap each other besides.
// Panels as in the forward: 128-byte swizzle for rows of 64 bf16 (D = 64;
// 128 and 256 as two and four panels), 64-byte for 32 (D = 32; 160 as five
// 32-column panels). Registers a consumer thread holds, the reason for the
// shapes: dQ D / 2 f32, S and dP 32 each, dS 16; dK/dV D / 2 each for dK
// and dV, S^T and dP^T 32 each, P^T and dS^T 16 each. A CTA of 384 threads
// is held to 168 registers a thread (an SM sub-partition hosts three of its
// warps), which spilled dK/dV's 64 + 64 accumulators at D = 128: with two
// consumers the producer warpgroup drops to 32 registers (setmaxnreg) and
// the consumers rise to 232. D <= 128: two consumer warpgroups (128 query
// rows or keys a CTA), 4 stages, dK and dV in one walk. D = 160: two
// consumers, 3 stages, and dV and dK in two launches of the dK/dV kernel
// (mode 1, then 2: 80 + 80 accumulators would not fit beside the scores).
// D = 256: one consumer warpgroup (255 registers), 2 stages, dV and dK in
// two launches. Each such launch walks the same tiles; dK's recomputes S^T.
//
// f32: fa_bwd_dq_kernel<D> and fa_bwd_dkdv_kernel<D>, on the CUDA cores
// (TF32 tensor cores would not keep the f32 parity checks). 256 threads a
// block, all f32 in shared memory: tiles of 64 rows x D, rows padded to D +
// 4 floats. Products that reduce over d (S = Q K^T, dP = dO V^T) give each
// thread a 4 x 4 block of strided rows (row = ty + 16 r, column = tx + 16 c)
// and read float4s along d: the 8 lanes of a quarter warp read 8
// consecutive padded rows, which fall in 8 distinct 4-bank groups. Products
// that reduce over rows (dV += P^T dO, dK += dS^T Q, dQ += dS K) give each
// thread 4 consecutive output rows x D / 16 columns, split in output
// panels: 4 consecutive columns of each 64-column panel where 64 divides D
// (64, 128, 256), else 2 of each 32-column panel (32, 160: five panels, 10
// columns a thread), read as float4s (float2s) along the output columns.
// Shared memory, not the FMA pipes, is the limit. D = 256 does not fit
// whole: four padded 64 x 256 f32 tiles alone are 266,240 B, over the
// 232,448 B a block may opt into. There the tiles a block walks (K and V in
// the dQ kernel, Q and dO in the dK/dV kernel) are staged in 64-column
// chunks, one output panel each, while the block's own rows stay whole: S
// and dP add up the chunks' partial products in d order (the same chain of
// FMAs as a whole tile), and dQ, dK, dV accumulate panel by panel as each
// chunk is loaded again. Shared memory, D = 160 (whole) and 256 (chunks):
// 185,600 B (dQ) and 203,264 B (dK/dV) each.
//
// Bound on an H100 SXM at Hymba-1.5B's training shape (B = 4 x 1, S = 2048,
// H = 25, Hkv = 5, D = 64, window 1024, bf16): operations. 10 * D FLOP a
// visible pair (S and dP, 4 D, and dV, dK, dQ, 6 D) at 989 TFLOP/s bf16;
// against q, k, v, o, dO read and dq, dk, dv written once. The bf16
// kernels do 14 D on 64 x 64 tiles of the band: S and dP once in each
// kernel (16 D at D 160 / 256, whose dK launch recomputes S^T).
//
// Shapes: any B (<= 65535), S, H, Hkv with H % Hkv == 0; D in {32, 64, 128,
// 160, 256} (32: the smoke configs' head dim; 160: stablelm-12b; 256:
// gemma-7b). bf16: q, k, v, o, do 16-byte aligned (TMA, 16-byte loads) and
// S below 2^22 (the grid's tile axis).
//
// Interface: plain C, loaded with ctypes. fa_backward launches its kernels
// on the stream it is given, allocates nothing (the caller passes the (B,
// H, S) f32 D scratch) and returns the first CUDA error; fa_bwd_smem_bytes
// reports each kernel's shared memory a block.
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -I csrc -o libflash_attn_bwd.so flash_attn_bwd.cu

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

// ---- f32: CUDA-core instance ---------------------------------------------

constexpr int kTile = 64;       // query rows of a q-tile, keys of a k-tile
constexpr int kThreads = 256;   // 16 x 16 threads
constexpr int kLdp = kTile + 4;  // padded row of a 64 x 64 score tile

template <int D>
struct Smem {
  // output panels: a thread holds kPer consecutive columns of each
  static constexpr int kPanel = D % 64 == 0 ? 64 : 32;
  static constexpr int kPer = kPanel / 16;
  static constexpr int kPanels = D / kPanel;
  // the walked tiles are staged kChunk columns at a time (D = 256 only)
  static constexpr int kChunk = D > 160 ? 64 : D;
  static constexpr int kChunks = D / kChunk;
  static_assert(kChunks == 1 || kChunk == kPanel, "a staged chunk is one panel");
  static constexpr int kLd = D + 4;            // padded row of a 64 x D tile
  static constexpr int kLdc = kChunk + 4;      // padded row of a staged chunk
  static constexpr int kTileF = kTile * kLd;   // floats of a 64 x D tile
  static constexpr int kChunkF = kTile * kLdc;  // floats of a staged chunk
  static constexpr int kScoreF = kTile * kLdp;  // floats of a 64 x 64 tile
  // dq kernel: Q, dO tiles, K, V chunks, dS^T, D of the rows
  static constexpr size_t kDqBytes =
      sizeof(float) * (2 * kTileF + 2 * kChunkF + kScoreF + kTile);
  // dkdv kernel: K, V tiles, Q, dO chunks, P, dS, lse and D of the rows
  static constexpr size_t kDkdvBytes =
      sizeof(float) * (2 * kTileF + 2 * kChunkF + 2 * kScoreF + 2 * kTile);
};

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}

// Columns col0 .. col0 + W - 1 of rows row0 .. row0 + 63 of one head (src
// points at its (b, 0, head, 0); consecutive positions are `stride`
// elements apart) into a 64 x W f32 tile whose rows are LD floats apart;
// rows past S read as zeros.
template <int W, int LD>
__device__ __forceinline__ void load_cols(float* dst, const float* src, int64_t row0,
                                          int64_t seq, int64_t stride, int col0) {
  constexpr int kQuads = W / 4;
  for (int e = threadIdx.x; e < kTile * kQuads; e += kThreads) {
    const int r = e / kQuads, c = (e % kQuads) * 4;
    const int64_t s = row0 + r;
    const float4 v =
        s < seq ? load4(src + s * stride + col0 + c) : make_float4(0.f, 0.f, 0.f, 0.f);
    store4(dst + r * LD + c, v);
  }
}

// A whole padded 64 x D tile
template <int D>
__device__ __forceinline__ void load_tile(float* dst, const float* src, int64_t row0,
                                          int64_t seq, int64_t stride) {
  load_cols<D, Smem<D>::kLd>(dst, src, row0, seq, stride, 0);
}

// Chunk cc of a 64 x D tile, into a padded 64 x kChunk buffer
template <int D>
__device__ __forceinline__ void load_chunk(float* dst, const float* src, int64_t row0,
                                           int64_t seq, int64_t stride, int cc) {
  using L = Smem<D>;
  load_cols<L::kChunk, L::kLdc>(dst, src, row0, seq, stride, cc * L::kChunk);
}

template <int R, int C>
__device__ __forceinline__ void zero(float (&acc)[R][C]) {
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int c = 0; c < C; ++c) acc[r][c] = 0.f;
}

// acc[r][c] += A[ty + 16 r] . B[tx + 16 c] over W columns (rows LDA and LDB
// floats apart); over the chunks of d in order, the same chain of FMAs as
// one whole tile
template <int W, int LDA, int LDB>
__device__ __forceinline__ void rows_dot(float (&acc)[4][4], const float* a,
                                         const float* b, int ty, int tx) {
#pragma unroll 4
  for (int d = 0; d < W; d += 4) {
    float4 av[4], bv[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) av[r] = load4(a + (ty + 16 * r) * LDA + d);
#pragma unroll
    for (int c = 0; c < 4; ++c) bv[c] = load4(b + (tx + 16 * c) * LDB + d);
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        float s = acc[r][c];
        s = fmaf(av[r].x, bv[c].x, s);
        s = fmaf(av[r].y, bv[c].y, s);
        s = fmaf(av[r].z, bv[c].z, s);
        s = fmaf(av[r].w, bv[c].w, s);
        acc[r][c] = s;
      }
  }
}

// acc[u][kPer * c + e] += sum_i P[i][4 ty + u] * M[i][col] for the output
// panels c in [lo, hi), col = kPer * tx + kPanel * c + e: P a 64 x 64 tile
// (rows i), M (rows i, LDM floats apart) holds those panels from its column
// 0 on; the thread's output rows are 4 ty .. 4 ty + 3.
template <int D, int LDM>
__device__ __forceinline__ void cols_accumulate(float (&acc)[4][D / 16],
                                                const float* p, const float* m,
                                                int lo, int hi, int ty, int tx) {
  using L = Smem<D>;
  constexpr int kPer = L::kPer;
#pragma unroll 4
  for (int i = 0; i < kTile; ++i) {
    const float4 pv = load4(p + i * kLdp + 4 * ty);
    const float pu[4] = {pv.x, pv.y, pv.z, pv.w};
#pragma unroll
    for (int c = 0; c < L::kPanels; ++c) {
      if (c < lo || c >= hi) continue;
      const float* row = m + i * LDM + kPer * tx + L::kPanel * (c - lo);
      float mv[kPer];
      if constexpr (kPer == 4) {
        const float4 q = load4(row);
        mv[0] = q.x;
        mv[1] = q.y;
        mv[2] = q.z;
        mv[3] = q.w;
      } else {
        const float2 q = *reinterpret_cast<const float2*>(row);
        mv[0] = q.x;
        mv[1] = q.y;
      }
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int e = 0; e < kPer; ++e)
          acc[u][kPer * c + e] = fmaf(pu[u], mv[e], acc[u][kPer * c + e]);
    }
  }
}

// Writes rows row0 + 4 ty + u (those below S) of one head: acc * mul.
template <int D>
__device__ __forceinline__ void store_rows(float* dst, const float (&acc)[4][D / 16],
                                           int64_t row0, int64_t seq, int64_t stride,
                                           float mul, int ty, int tx) {
  using L = Smem<D>;
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const int64_t s = row0 + 4 * ty + u;
    if (s >= seq) continue;
#pragma unroll
    for (int c = 0; c < L::kPanels; ++c) {
      float* const out = dst + s * stride + L::kPer * tx + L::kPanel * c;
      const float* a = acc[u] + L::kPer * c;
      if constexpr (L::kPer == 4) {
        store4(out, make_float4(a[0] * mul, a[1] * mul, a[2] * mul, a[3] * mul));
      } else {
        out[0] = a[0] * mul;
        out[1] = a[1] * mul;
      }
    }
  }
}

__device__ __forceinline__ bool visible(int64_t i, int64_t j, int64_t seq,
                                        int causal, int64_t window) {
  return i < seq && j < seq && (!causal || i >= j) && (window <= 0 || j > i - window);
}

template <int D>
__global__ void __launch_bounds__(kThreads)
fa_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const float* __restrict__ o,
                 const float* __restrict__ dout, const float* __restrict__ lse_in,
                 float* __restrict__ delta_out, float* __restrict__ dq, int64_t seq,
                 int heads, int kv_heads, int causal, int64_t window, float scale) {
  using L = Smem<D>;
  constexpr int kLd = L::kLd, kLdc = L::kLdc, kChunk = L::kChunk, kChunks = L::kChunks;
  extern __shared__ __align__(16) float smem[];
  float* const qs = smem;
  float* const dos = qs + L::kTileF;
  float* const ks = dos + L::kTileF;  // K (or o) chunk
  float* const vs = ks + L::kChunkF;  // V chunk
  float* const dst = vs + L::kChunkF;  // dS^T: [key][query]
  float* const del_s = dst + L::kScoreF;

  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  // longest query tiles first: a causal tile at the end sees the most keys
  const int64_t q0 = (int64_t)(gridDim.x - 1 - blockIdx.x) * kTile;
  const int h = blockIdx.y;
  const int64_t b = blockIdx.z;
  const int hk = h / (heads / kv_heads);
  const int64_t qstride = (int64_t)heads * D, kstride = (int64_t)kv_heads * D;
  const float* const qh = q + (b * seq * heads + h) * D;
  const float* const oh = o + (b * seq * heads + h) * D;
  const float* const doh = dout + (b * seq * heads + h) * D;
  const float* const kh = k + (b * seq * kv_heads + hk) * D;
  const float* const vh = v + (b * seq * kv_heads + hk) * D;

  load_tile<D>(qs, qh, q0, seq, qstride);
  load_tile<D>(dos, doh, q0, seq, qstride);
  {  // D_i = do_i . o_i: 4 threads a row, each a quarter of d, then 2
     // shuffles; o is staged chunk by chunk in ks
    const int row = tid / 4, part = tid % 4;
    float acc = 0.f;
#pragma unroll
    for (int cc = 0; cc < kChunks; ++cc) {
      if (cc) __syncthreads();  // the previous chunk is read
      load_chunk<D>(ks, oh, q0, seq, qstride, cc);
      __syncthreads();
      const int lo = part * (D / 4) > cc * kChunk ? part * (D / 4) : cc * kChunk;
      const int hi = (part + 1) * (D / 4) < (cc + 1) * kChunk ? (part + 1) * (D / 4)
                                                              : (cc + 1) * kChunk;
      for (int d = lo; d < hi; ++d)
        acc = fmaf(dos[row * kLd + d], ks[row * kLdc + d - cc * kChunk], acc);
    }
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    acc += __shfl_xor_sync(0xffffffffu, acc, 2);
    if (part == 0) del_s[row] = acc;
  }

  const int64_t j_lo = window > 0 ? (q0 - window + 1 > 0 ? q0 - window + 1 : 0) : 0;
  const int64_t j_end = causal ? (q0 + kTile < seq ? q0 + kTile : seq) : seq;
  const int64_t t_lo = j_lo / kTile, t_end = (j_end + kTile - 1) / kTile;

  __syncthreads();  // del_s complete for every row
  float lse[4], delta[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int64_t i = q0 + ty + 16 * r;
    const int64_t at = (b * heads + h) * seq + i;
    lse[r] = i < seq ? lse_in[at] : 0.f;
    delta[r] = del_s[ty + 16 * r];
    if (tx == 0 && i < seq) delta_out[at] = delta[r];
  }

  // dQ += dS K over the visible key tiles
  float acc[4][D / 16];
  zero(acc);
  float s[4][4], dp[4][4];
  for (int64_t t = t_lo; t < t_end; ++t) {
    const int64_t k0 = t * kTile;
    zero(s);
    zero(dp);
#pragma unroll
    for (int cc = 0; cc < kChunks; ++cc) {
      __syncthreads();  // ks, vs, dst free
      load_chunk<D>(ks, kh, k0, seq, kstride, cc);
      load_chunk<D>(vs, vh, k0, seq, kstride, cc);
      __syncthreads();
      rows_dot<kChunk, kLd, kLdc>(s, qs + cc * kChunk, ks, ty, tx);
      rows_dot<kChunk, kLd, kLdc>(dp, dos + cc * kChunk, vs, ty, tx);
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int64_t i = q0 + ty + 16 * r;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int64_t j = k0 + tx + 16 * c;
        const float p = visible(i, j, seq, causal, window) ? expf(s[r][c] * scale - lse[r]) : 0.f;
        dst[(tx + 16 * c) * kLdp + ty + 16 * r] = p * (dp[r][c] - delta[r]);
      }
    }
    __syncthreads();
    if constexpr (kChunks == 1) {
      cols_accumulate<D, kLdc>(acc, dst, ks, 0, L::kPanels, ty, tx);
    } else {  // ks holds K's last chunk; then the others, one panel each
#pragma unroll
      for (int cc = kChunks - 1; cc >= 0; --cc) {
        if (cc != kChunks - 1) {
          __syncthreads();
          load_chunk<D>(ks, kh, k0, seq, kstride, cc);
          __syncthreads();
        }
        cols_accumulate<D, kLdc>(acc, dst, ks, cc, cc + 1, ty, tx);
      }
    }
  }
  store_rows<D>(dq + (b * seq * heads + h) * D, acc, q0, seq, qstride, scale, ty, tx);
}

template <int D>
__global__ void __launch_bounds__(kThreads)
fa_bwd_dkdv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                   const float* __restrict__ v, const float* __restrict__ dout,
                   const float* __restrict__ lse_in, const float* __restrict__ delta_in,
                   float* __restrict__ dk, float* __restrict__ dv, int64_t seq, int heads,
                   int kv_heads, int causal, int64_t window, float scale) {
  using L = Smem<D>;
  constexpr int kLd = L::kLd, kLdc = L::kLdc, kChunk = L::kChunk, kChunks = L::kChunks;
  extern __shared__ __align__(16) float smem[];
  float* const ks = smem;
  float* const vs = ks + L::kTileF;
  float* const qs = vs + L::kTileF;    // Q chunk
  float* const dos = qs + L::kChunkF;  // dO chunk
  float* const ps = dos + L::kChunkF;  // P:  [query][key]
  float* const dss = ps + L::kScoreF;  // dS: [query][key]
  float* const lse_s = dss + L::kScoreF;
  float* const del_s = lse_s + kTile;

  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int64_t k0 = (int64_t)blockIdx.x * kTile;  // early keys see the most queries
  const int hk = blockIdx.y;
  const int64_t b = blockIdx.z;
  const int n_rep = heads / kv_heads;
  const int64_t qstride = (int64_t)heads * D, kstride = (int64_t)kv_heads * D;

  load_tile<D>(ks, k + (b * seq * kv_heads + hk) * D, k0, seq, kstride);
  load_tile<D>(vs, v + (b * seq * kv_heads + hk) * D, k0, seq, kstride);

  // the queries that can see keys k0 .. k0 + 63: i >= k0 (causal) and
  // i < j_max + window
  const int64_t j_max = (k0 + kTile < seq ? k0 + kTile : seq) - 1;
  const int64_t i_lo = causal ? k0 : 0;
  const int64_t i_end = window > 0 ? (j_max + window < seq ? j_max + window : seq) : seq;
  const int64_t t_lo = i_lo / kTile, t_end = (i_end + kTile - 1) / kTile;

  float acc_k[4][D / 16], acc_v[4][D / 16];
  zero(acc_k);
  zero(acc_v);

  float s[4][4], dp[4][4];
  for (int rep = 0; rep < n_rep; ++rep) {
    const int h = hk * n_rep + rep;
    const float* const qh = q + (b * seq * heads + h) * D;
    const float* const doh = dout + (b * seq * heads + h) * D;
    const int64_t stats = (b * heads + h) * seq;
    for (int64_t t = t_lo; t < t_end; ++t) {
      const int64_t q0 = t * kTile;
      zero(s);
      zero(dp);
#pragma unroll
      for (int cc = 0; cc < kChunks; ++cc) {
        __syncthreads();  // qs, dos, ps, dss free
        load_chunk<D>(qs, qh, q0, seq, qstride, cc);
        load_chunk<D>(dos, doh, q0, seq, qstride, cc);
        if (cc == 0 && tid < kTile) {
          const int64_t i = q0 + tid;
          lse_s[tid] = i < seq ? lse_in[stats + i] : 0.f;
          del_s[tid] = i < seq ? delta_in[stats + i] : 0.f;
        }
        __syncthreads();
        rows_dot<kChunk, kLdc, kLd>(s, qs, ks + cc * kChunk, ty, tx);
        rows_dot<kChunk, kLdc, kLd>(dp, dos, vs + cc * kChunk, ty, tx);
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int64_t i = q0 + ty + 16 * r;
        const float lse = lse_s[ty + 16 * r], delta = del_s[ty + 16 * r];
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int64_t j = k0 + tx + 16 * c;
          const float p = visible(i, j, seq, causal, window) ? expf(s[r][c] * scale - lse) : 0.f;
          ps[(ty + 16 * r) * kLdp + tx + 16 * c] = p;
          dss[(ty + 16 * r) * kLdp + tx + 16 * c] = p * (dp[r][c] - delta);
        }
      }
      __syncthreads();
      if constexpr (kChunks == 1) {
        cols_accumulate<D, kLdc>(acc_v, ps, dos, 0, L::kPanels, ty, tx);
        cols_accumulate<D, kLdc>(acc_k, dss, qs, 0, L::kPanels, ty, tx);
      } else {  // qs, dos hold the last chunk; then the others, a panel each
#pragma unroll
        for (int cc = kChunks - 1; cc >= 0; --cc) {
          if (cc != kChunks - 1) {
            __syncthreads();
            load_chunk<D>(qs, qh, q0, seq, qstride, cc);
            load_chunk<D>(dos, doh, q0, seq, qstride, cc);
            __syncthreads();
          }
          cols_accumulate<D, kLdc>(acc_v, ps, dos, cc, cc + 1, ty, tx);
          cols_accumulate<D, kLdc>(acc_k, dss, qs, cc, cc + 1, ty, tx);
        }
      }
    }
  }
  store_rows<D>(dk + (b * seq * kv_heads + hk) * D, acc_k, k0, seq, kstride, scale, ty, tx);
  store_rows<D>(dv + (b * seq * kv_heads + hk) * D, acc_v, k0, seq, kstride, 1.f, ty, tx);
}

template <int D>
cudaError_t launch_f32(const void* q, const void* k, const void* v, const void* o,
                       const void* dout, const float* lse, void* dq, void* dk, void* dv,
                       float* delta, int64_t batch, int64_t seq, int heads, int kv_heads,
                       int causal, int64_t window, float scale, cudaStream_t stream) {
  using L = Smem<D>;
  cudaError_t err = cudaFuncSetAttribute(fa_bwd_dq_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)L::kDqBytes);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(fa_bwd_dkdv_kernel<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)L::kDkdvBytes);
  if (err != cudaSuccess) return err;
  const float* qf = static_cast<const float*>(q);
  const float* kf = static_cast<const float*>(k);
  const float* vf = static_cast<const float*>(v);
  const float* dof = static_cast<const float*>(dout);
  const unsigned tiles = (unsigned)((seq + kTile - 1) / kTile);
  fa_bwd_dq_kernel<D><<<dim3(tiles, heads, (unsigned)batch), kThreads, L::kDqBytes,
                        stream>>>(qf, kf, vf, static_cast<const float*>(o), dof, lse,
                                  delta, static_cast<float*>(dq), seq, heads, kv_heads,
                                  causal, window, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  fa_bwd_dkdv_kernel<D><<<dim3(tiles, kv_heads, (unsigned)batch), kThreads,
                          L::kDkdvBytes, stream>>>(qf, kf, vf, dof, lse, delta,
                                                   static_cast<float*>(dk),
                                                   static_cast<float*>(dv), seq, heads,
                                                   kv_heads, causal, window, scale);
  return cudaGetLastError();
}

// ---- bf16: tensor-core instance -------------------------------------------

using hopper::bf16_hi;
using hopper::bf16_lo;
using hopper::ex2;
using hopper::kLog2e;
using hopper::neg_inf;
using hopper::pack_bf16;

constexpr int kRowsWg = 64;  // a warpgroup's rows: queries (dQ), keys (dK/dV)
constexpr int kWalk = 64;    // rows of a walked tile: keys (dQ), queries (dK/dV)

// what a launch of the dK/dV kernel computes
constexpr int kDvOnly = 1, kDkOnly = 2, kBoth = 3;

template <int D>
struct Bwd90 {
  static constexpr int kTileBytes = hopper::Panels<D>::kBytes;  // a 64 x D tile
  static constexpr int kConsumers = D > 160 ? 1 : 2;             // warpgroups
  static constexpr int kStages = D > 160 ? 2 : D > 128 ? 3 : 4;  // ring depth
  static constexpr int kRowsCta = kRowsWg * kConsumers;
  // + a producer warpgroup: one warp issues the loads; with two consumers
  // it hands its registers to them (a 288-thread CTA would be held to 168 a
  // thread: an SM sub-partition hosts three of its warps)
  static constexpr int kThreads = (kConsumers + 1) * 128;
  static constexpr int kProducerRegs = 32, kConsumerRegs = 232;
  static constexpr bool kOneWalk = D <= 128;  // dK and dV in one dK/dV launch
  static constexpr int kStatFloats = 2 * kWalk;  // lse (log2 domain) and D of a tile
  // dQ: Q and dO of each consumer, K and V of each stage, the barriers
  static constexpr int kDqSmem = 1024 /* alignment slack */ + 2 * kConsumers * kTileBytes +
                                 2 * kStages * kTileBytes + (2 * kStages + 1) * 8;
  // dK/dV: K and V of each consumer; Q, dO and the stats of each stage
  static constexpr int kKvSmem = 1024 + 2 * kConsumers * kTileBytes +
                                 kStages * (2 * kTileBytes + kStatFloats * 4) +
                                 (2 * kStages + 1) * 8;
  static_assert(kDqSmem <= 232448 && kKvSmem <= 232448,
                "above the 227 KB a CTA may have");
};

// Writes a warpgroup's 64 x D f32 accumulator fragment times mul as bf16:
// this thread's rows row and row + 8 (those below S), columns 8 j + col and
// + 1; base points at row 0 of the head, rows stride elements apart.
template <int D>
__device__ __forceinline__ void store_rows_bf16(__nv_bfloat16* base, int64_t stride,
                                                const float (&acc)[D / 2], int row, int col,
                                                int seq, float mul) {
  __nv_bfloat16* const out = base + (int64_t)row * stride + col;
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int r = 0; r < 2; ++r)
      if (row + 8 * r < seq)
        *reinterpret_cast<uint32_t*>(out + 8 * r * stride + 8 * j) =
            pack_bf16(acc[4 * j + 2 * r] * mul, acc[4 * j + 2 * r + 1] * mul);
}

template <int D>
__global__ void __launch_bounds__(Bwd90<D>::kThreads, 1)
fa_bwd_dq_sm90(const __grid_constant__ CUtensorMap tm_q,
               const __grid_constant__ CUtensorMap tm_k,
               const __grid_constant__ CUtensorMap tm_v,
               const __grid_constant__ CUtensorMap tm_do,
               const __nv_bfloat16* __restrict__ o, const __nv_bfloat16* __restrict__ dout,
               const float* __restrict__ lse, float* __restrict__ delta,
               __nv_bfloat16* __restrict__ dq, int seq, int heads, int n_rep, int causal,
               int window, float scale, float scale_log2) {
  using C = Bwd90<D>;
  using P = hopper::Panels<D>;
  using namespace hopper;
  constexpr int kCons = C::kConsumers;
  constexpr int kStages = C::kStages;
  constexpr int kTileB = C::kTileBytes;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  // the swizzle patterns repeat every 1024 bytes of the shared address
  uint8_t* sq = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  uint8_t* sdo = sq + kCons * kTileB;
  uint8_t* sk = sdo + kCons * kTileB;
  uint8_t* sv = sk + kStages * kTileB;
  uint64_t* full = reinterpret_cast<uint64_t*>(sv + kStages * kTileB);
  uint64_t* empty = full + kStages;
  uint64_t* q_full = empty + kStages;

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int q0 = (int)(gridDim.z - 1 - blockIdx.z) * C::kRowsCta;  // longest first
  const int hk = h / n_rep;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  // key tiles of the CTA's band
  const int q_last = min(q0 + C::kRowsCta, seq) - 1;
  const int t_lo = (window > 0 ? max(0, q0 - window + 1) : 0) / kWalk;
  const int t_hi = (causal ? q_last : seq - 1) / kWalk;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kCons * 4);
    }
    mbar_init(q_full, 1);
    fence_barrier_init();
  }
  __syncthreads();

  if (warp >= kCons * 4) {
    // producer: Q and dO once, then the band's K/V tiles through the ring
    if constexpr (kCons > 1) setmaxnreg_dec<C::kProducerRegs>();
    if (warp == kCons * 4 && lane == 0) {
      const int n_wg = min(kCons, (seq - q0 + kRowsWg - 1) / kRowsWg);
      mbar_arrive_expect_tx(q_full, 2 * n_wg * kTileB);
      for (int g = 0; g < n_wg; ++g)
        for (int p = 0; p < P::kCount; ++p) {
          const int off = g * kTileB + p * kRowsWg * P::kRowBytes;
          tma_load_3d(sq + off, &tm_q, q_full, h * D + p * P::kCols, q0 + g * kRowsWg, b);
          tma_load_3d(sdo + off, &tm_do, q_full, h * D + p * P::kCols, q0 + g * kRowsWg,
                      b);
        }
      for (int t = t_lo, i = 0; t <= t_hi; ++t, ++i) {
        const int s = i % kStages;
        mbar_wait(&empty[s], ((i / kStages) & 1) ^ 1);
        mbar_arrive_expect_tx(&full[s], 2 * kTileB);
        for (int p = 0; p < P::kCount; ++p) {
          const int off = s * kTileB + p * kWalk * P::kRowBytes;
          tma_load_3d(sk + off, &tm_k, &full[s], hk * D + p * P::kCols, t * kWalk, b);
          tma_load_3d(sv + off, &tm_v, &full[s], hk * D + p * P::kCols, t * kWalk, b);
        }
      }
    }
    return;
  }

  // consumer warpgroup wg: query rows r0 .. r0 + 63; this thread holds rows
  // row_a and row_a + 8 of the fragments
  if constexpr (kCons > 1) setmaxnreg_inc<C::kConsumerRegs>();
  const int wg = warp / 4;
  const int r0 = q0 + wg * kRowsWg;
  const int row_a = r0 + (warp % 4) * 16 + lane / 4;
  const int col = 2 * (lane % 4);  // this thread's first column in each 8
  // this warpgroup's tiles [wt_lo, wt_hi]; it waits for and releases the
  // CTA's other tiles without reading them
  int wt_lo = t_hi + 1, wt_hi = t_hi;
  if (r0 < seq) {
    wt_lo = (window > 0 ? max(0, r0 - window + 1) : 0) / kWalk;
    wt_hi = (causal ? min(r0 + kRowsWg, seq) - 1 : seq - 1) / kWalk;
  }
  auto stage = [&](int t) { return (t - t_lo) % kStages; };
  auto wait_tile = [&](int t) {
    mbar_wait(&full[stage(t)], ((t - t_lo) / kStages) & 1);
  };
  auto release = [&](int t) {
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[stage(t)]);  // this warp is done with it
  };
  auto inside = [&](int k0) {  // every (row, key) pair of the tile visible
    return k0 + kWalk <= seq && r0 + kRowsWg <= seq && (!causal || k0 + kWalk - 1 <= r0) &&
           (window <= 0 || k0 > r0 + kRowsWg - 1 - window);
  };

  // lse (log2 domain) and D = rowsum(dO * O) of this thread's two rows: the
  // quad's 4 lanes each sum a quarter of the row (16-byte loads), then 2
  // shuffles. Rows past S take lse = +inf, so their p is 0.
  float lse2[2], dlt[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row_a + 8 * r;
    const int64_t at = ((int64_t)b * heads + h) * seq + row;
    float acc = 0.f;
    lse2[r] = __int_as_float(0x7f800000);
    if (row < seq) {
      lse2[r] = lse[at] * kLog2e;
      const int64_t off =
          ((int64_t)b * seq + row) * heads * D + (int64_t)h * D + (lane % 4) * (D / 4);
#pragma unroll
      for (int e = 0; e < D / 4; e += 8) {
        const uint4 ov = *reinterpret_cast<const uint4*>(o + off + e);
        const uint4 dv = *reinterpret_cast<const uint4*>(dout + off + e);
        const uint32_t ow[4] = {ov.x, ov.y, ov.z, ov.w};
        const uint32_t dw[4] = {dv.x, dv.y, dv.z, dv.w};
#pragma unroll
        for (int w = 0; w < 4; ++w) {
          acc = fmaf(bf16_lo(dw[w]), bf16_lo(ow[w]), acc);
          acc = fmaf(bf16_hi(dw[w]), bf16_hi(ow[w]), acc);
        }
      }
    }
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    acc += __shfl_xor_sync(0xffffffffu, acc, 2);
    dlt[r] = acc;
    if ((lane & 3) == 0 && row < seq) delta[at] = acc;
  }

  for (int t = t_lo; t < wt_lo; ++t) {
    wait_tile(t);
    release(t);
  }

  float acc[D / 2];
#pragma unroll
  for (int j = 0; j < D / 2; ++j) acc[j] = 0.f;
  float sc[32], dp[32];
  uint32_t ds[16];

  if (wt_lo <= wt_hi) {
    mbar_wait(q_full, 0);
    const uint32_t q_addr = smem_addr(sq + wg * kTileB);
    const uint32_t do_addr = smem_addr(sdo + wg * kTileB);
    for (int t = wt_lo; t <= wt_hi; ++t) {
      wait_tile(t);
      const uint32_t k_addr = smem_addr(sk + stage(t) * kTileB);
      wgmma_fence();
      mma_ss<D>(sc, q_addr, k_addr);                                // S
      mma_ss<D>(dp, do_addr, smem_addr(sv + stage(t) * kTileB));  // dP
      wgmma_commit();
      wgmma_wait<0>();  // and dQ += dS K of tile t - 1
      fence_regs(sc);
      fence_regs(dp);
      fence_regs(acc);
      fence_regs(ds);
      if (t > wt_lo) release(t - 1);
      const bool in = inside(t * kWalk);
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        const int r = (j >> 1) & 1;
        float x = sc[j];
        if (!in && !visible(row_a + 8 * r, t * kWalk + (j / 4) * 8 + col + (j & 1), seq,
                            causal, window))
          x = neg_inf();
        sc[j] = ex2(fmaf(x, scale_log2, -lse2[r])) * (dp[j] - dlt[r]);  // dS
      }
#pragma unroll
      for (int j = 0; j < 16; ++j) ds[j] = pack_bf16(sc[2 * j], sc[2 * j + 1]);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kWalk / 16; ++kk) mma_rs_k16<D>(acc, &ds[4 * kk], k_addr, kk);
      wgmma_commit();
    }
    wgmma_wait<0>();
    fence_regs(acc);
    fence_regs(ds);
    release(wt_hi);
  }

  for (int t = max(wt_hi + 1, wt_lo); t <= t_hi; ++t) {
    wait_tile(t);
    release(t);
  }
  if (wt_lo > wt_hi) return;  // no rows below S
  store_rows_bf16<D>(dq + (int64_t)b * seq * heads * D + (int64_t)h * D, (int64_t)heads * D,
                     acc, row_a, col, seq, scale);
}

template <int D, int kMode>
__global__ void __launch_bounds__(Bwd90<D>::kThreads, 1)
fa_bwd_dkdv_sm90(const __grid_constant__ CUtensorMap tm_q,
                 const __grid_constant__ CUtensorMap tm_k,
                 const __grid_constant__ CUtensorMap tm_v,
                 const __grid_constant__ CUtensorMap tm_do,
                 const float* __restrict__ lse, const float* __restrict__ delta,
                 __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv, int seq,
                 int heads, int kv_heads, int causal, int window, float scale,
                 float scale_log2) {
  using C = Bwd90<D>;
  using P = hopper::Panels<D>;
  using namespace hopper;
  constexpr bool kDv = (kMode & kDvOnly) != 0;
  constexpr bool kDk = (kMode & kDkOnly) != 0;
  constexpr int kCons = C::kConsumers;
  constexpr int kStages = C::kStages;
  constexpr int kTileB = C::kTileBytes;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* sk = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  uint8_t* sv = sk + kCons * kTileB;
  uint8_t* sq = sv + kCons * kTileB;
  uint8_t* sdo = sq + kStages * kTileB;
  float* stats = reinterpret_cast<float*>(sdo + kStages * kTileB);
  uint64_t* full = reinterpret_cast<uint64_t*>(stats + kStages * C::kStatFloats);
  uint64_t* empty = full + kStages;
  uint64_t* kv_full = empty + kStages;

  const int hk = blockIdx.x;
  const int b = blockIdx.y;
  const int k0 = (int)blockIdx.z * C::kRowsCta;  // early keys see the most queries
  const int n_rep = heads / kv_heads;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  // query tiles that can see the CTA's keys: i >= k0 (causal) and i <=
  // the last key + window - 1
  const int k_last = min(k0 + C::kRowsCta, seq) - 1;
  const int t_lo = (causal ? k0 : 0) / kWalk;
  const int t_hi = (window > 0 ? min(k_last + window - 1, seq - 1) : seq - 1) / kWalk;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 32);  // the producer warp's lanes (one with the TMA bytes)
      mbar_init(&empty[s], kCons * 4);
    }
    mbar_init(kv_full, 1);
    fence_barrier_init();
  }
  __syncthreads();

  if (warp >= kCons * 4) {
    // producer: K and V once, then for each query head of the group the
    // query tiles through the ring; every lane of its first warp stores 2 of
    // a tile's 64 lse and D values, lane 0 also issues its Q and dO loads
    if constexpr (kCons > 1) setmaxnreg_dec<C::kProducerRegs>();
    if (warp != kCons * 4) return;
    if (lane == 0) {
      const int n_wg = min(kCons, (seq - k0 + kRowsWg - 1) / kRowsWg);
      mbar_arrive_expect_tx(kv_full, 2 * n_wg * kTileB);
      for (int g = 0; g < n_wg; ++g)
        for (int p = 0; p < P::kCount; ++p) {
          const int off = g * kTileB + p * kRowsWg * P::kRowBytes;
          tma_load_3d(sk + off, &tm_k, kv_full, hk * D + p * P::kCols, k0 + g * kRowsWg, b);
          tma_load_3d(sv + off, &tm_v, kv_full, hk * D + p * P::kCols, k0 + g * kRowsWg, b);
        }
    }
    int i = 0;
    for (int rep = 0; rep < n_rep; ++rep) {
      const int h = hk * n_rep + rep;
      const int64_t base = ((int64_t)b * heads + h) * seq;
      for (int t = t_lo; t <= t_hi; ++t, ++i) {
        const int s = i % kStages;
        mbar_wait(&empty[s], ((i / kStages) & 1) ^ 1);
        float* st = stats + s * C::kStatFloats;
        for (int e = lane; e < kWalk; e += 32) {
          const int qi = t * kWalk + e;
          st[e] = qi < seq ? lse[base + qi] * kLog2e : __int_as_float(0x7f800000);
          st[kWalk + e] = qi < seq ? delta[base + qi] : 0.f;
        }
        if (lane == 0) {
          mbar_arrive_expect_tx(&full[s], 2 * kTileB);
          for (int p = 0; p < P::kCount; ++p) {
            const int off = s * kTileB + p * kWalk * P::kRowBytes;
            tma_load_3d(sq + off, &tm_q, &full[s], h * D + p * P::kCols, t * kWalk, b);
            tma_load_3d(sdo + off, &tm_do, &full[s], h * D + p * P::kCols, t * kWalk, b);
          }
        } else {
          mbar_arrive(&full[s]);
        }
      }
    }
    return;
  }

  // consumer warpgroup wg: keys w0 .. w0 + 63; this thread holds keys
  // row_a and row_a + 8 of the fragments
  if constexpr (kCons > 1) setmaxnreg_inc<C::kConsumerRegs>();
  const int wg = warp / 4;
  const int w0 = k0 + wg * kRowsWg;
  const int row_a = w0 + (warp % 4) * 16 + lane / 4;
  const int col = 2 * (lane % 4);
  int wt_lo = t_hi + 1, wt_hi = t_hi;
  if (w0 < seq) {
    wt_lo = (causal ? w0 : 0) / kWalk;
    wt_hi = (window > 0 ? min(min(w0 + kRowsWg, seq) - 1 + window - 1, seq - 1) : seq - 1) /
            kWalk;
  }
  auto wait_tile = [&](int i) { mbar_wait(&full[i % kStages], (i / kStages) & 1); };
  auto release = [&](int i) {
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[i % kStages]);
  };
  auto inside = [&](int q0) {  // every (key, query) pair of the tile visible
    return q0 + kWalk <= seq && w0 + kRowsWg <= seq && (!causal || w0 + kRowsWg - 1 <= q0) &&
           (window <= 0 || w0 > q0 + kWalk - 1 - window);
  };
  const uint32_t k_addr = smem_addr(sk + wg * kTileB);
  const uint32_t v_addr = smem_addr(sv + wg * kTileB);

  float dka[kDk ? D / 2 : 1], dva[kDv ? D / 2 : 1];
#pragma unroll
  for (int j = 0; j < (kDk ? D / 2 : 1); ++j) dka[j] = 0.f;
#pragma unroll
  for (int j = 0; j < (kDv ? D / 2 : 1); ++j) dva[j] = 0.f;
  float sc[32], dp[32];
  uint32_t pt[16], dst[16];
  if (wt_lo <= wt_hi) mbar_wait(kv_full, 0);

  int i = 0;  // the ring's tile count, as the producer's
  for (int rep = 0; rep < n_rep; ++rep) {
    for (int t = t_lo; t < wt_lo; ++t, ++i) {
      wait_tile(i);
      release(i);
    }
    for (int t = wt_lo; t <= wt_hi; ++t, ++i) {
      wait_tile(i);
      const int s = i % kStages;
      const uint32_t q_addr = smem_addr(sq + s * kTileB);
      const uint32_t do_addr = smem_addr(sdo + s * kTileB);
      const float* lse_s = stats + s * C::kStatFloats;
      const float* del_s = lse_s + kWalk;
      wgmma_fence();
      mma_ss<D>(sc, k_addr, q_addr);                                // S^T
      if constexpr (kMode == kDkOnly) mma_ss<D>(dp, v_addr, do_addr);  // dP^T
      wgmma_commit();
      wgmma_wait<0>();  // and tile i - 1's last products
      fence_regs(sc);
      if constexpr (kDk) {
        fence_regs(dp);
        fence_regs(dka);
        fence_regs(dst);
      }
      if constexpr (kDv) {
        fence_regs(dva);
        fence_regs(pt);
      }
      if (t > wt_lo) release(i - 1);
      const bool in = inside(t * kWalk);
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        const int c = (j / 4) * 8 + col + (j & 1);  // the query within the tile
        float x = sc[j];
        if (!in && !visible(t * kWalk + c, row_a + 8 * ((j >> 1) & 1), seq, causal, window))
          x = neg_inf();
        sc[j] = ex2(fmaf(x, scale_log2, -lse_s[c]));  // P^T
      }
#pragma unroll
      for (int j = 0; j < 16; ++j) pt[j] = pack_bf16(sc[2 * j], sc[2 * j + 1]);
      if constexpr (kDv) {
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kWalk / 16; ++kk)
          mma_rs_k16<D>(dva, &pt[4 * kk], do_addr, kk);  // dV += P^T dO
        if constexpr (kMode == kBoth) mma_ss<D>(dp, v_addr, do_addr);  // dP^T
        wgmma_commit();
        if constexpr (kDk) {
          wgmma_wait<0>();
          fence_regs(dp);
          fence_regs(dva);
          fence_regs(pt);
        }
      }
      if constexpr (kDk) {
#pragma unroll
        for (int j = 0; j < 16; ++j) {  // dS^T from the rounded P^T
          const int c = (j / 2) * 8 + col;
          dst[j] = pack_bf16(bf16_lo(pt[j]) * (dp[2 * j] - del_s[c]),
                             bf16_hi(pt[j]) * (dp[2 * j + 1] - del_s[c + 1]));
        }
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kWalk / 16; ++kk)
          mma_rs_k16<D>(dka, &dst[4 * kk], q_addr, kk);  // dK += dS^T Q
        wgmma_commit();
      }
    }
    if (wt_lo <= wt_hi) {
      wgmma_wait<0>();
      if constexpr (kDk) {
        fence_regs(dka);
        fence_regs(dst);
      }
      if constexpr (kDv) {
        fence_regs(dva);
        fence_regs(pt);
      }
      release(i - 1);
    }
    for (int t = max(wt_hi + 1, wt_lo); t <= t_hi; ++t, ++i) {
      wait_tile(i);
      release(i);
    }
  }
  if (wt_lo > wt_hi) return;  // no keys below S
  const int64_t at = (int64_t)b * seq * kv_heads * D + (int64_t)hk * D;
  if constexpr (kDk)
    store_rows_bf16<D>(dk + at, (int64_t)kv_heads * D, dka, row_a, col, seq, scale);
  if constexpr (kDv)
    store_rows_bf16<D>(dv + at, (int64_t)kv_heads * D, dva, row_a, col, seq, 1.f);
}

template <int D, int kMode>
cudaError_t launch_dkdv_sm90(const CUtensorMap& tm_q, const CUtensorMap& tm_k,
                             const CUtensorMap& tm_v, const CUtensorMap& tm_do,
                             const float* lse, const float* delta, void* dk, void* dv,
                             int64_t batch, int64_t seq, int heads, int kv_heads, int causal,
                             int window, float scale, cudaStream_t stream) {
  using C = Bwd90<D>;
  const cudaError_t err = cudaFuncSetAttribute(
      fa_bwd_dkdv_sm90<D, kMode>, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kKvSmem);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)kv_heads, (unsigned)batch,
                  (unsigned)((seq + C::kRowsCta - 1) / C::kRowsCta));
  fa_bwd_dkdv_sm90<D, kMode><<<grid, C::kThreads, C::kKvSmem, stream>>>(
      tm_q, tm_k, tm_v, tm_do, lse, delta, static_cast<__nv_bfloat16*>(dk),
      static_cast<__nv_bfloat16*>(dv), (int)seq, heads, kv_heads, causal, window, scale,
      scale * kLog2e);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_sm90(const void* q, const void* k, const void* v, const void* o,
                        const void* dout, const float* lse, void* dq, void* dk, void* dv,
                        float* delta, int64_t batch, int64_t seq, int heads, int kv_heads,
                        int causal, int64_t window, float scale, cudaStream_t stream) {
  using C = Bwd90<D>;
  using P = hopper::Panels<D>;
  CUtensorMap tm_q, tm_k, tm_v, tm_do;
  if (!hopper::tensor_map(&tm_q, q, batch, seq, (int64_t)heads * D, P::kCols, kRowsWg) ||
      !hopper::tensor_map(&tm_do, dout, batch, seq, (int64_t)heads * D, P::kCols, kRowsWg) ||
      !hopper::tensor_map(&tm_k, k, batch, seq, (int64_t)kv_heads * D, P::kCols, kWalk) ||
      !hopper::tensor_map(&tm_v, v, batch, seq, (int64_t)kv_heads * D, P::kCols, kWalk))
    return cudaErrorInvalidValue;
  // a window of S or more hides nothing: clamped, the band arithmetic stays
  // in int
  const int win = (int)(window < seq ? window : seq);
  cudaError_t err = cudaFuncSetAttribute(
      fa_bwd_dq_sm90<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kDqSmem);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)heads, (unsigned)batch,
                  (unsigned)((seq + C::kRowsCta - 1) / C::kRowsCta));
  fa_bwd_dq_sm90<D><<<grid, C::kThreads, C::kDqSmem, stream>>>(
      tm_q, tm_k, tm_v, tm_do, static_cast<const __nv_bfloat16*>(o),
      static_cast<const __nv_bfloat16*>(dout), lse, delta, static_cast<__nv_bfloat16*>(dq),
      (int)seq, heads, heads / kv_heads, causal, win, scale, scale * kLog2e);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if constexpr (C::kOneWalk) {
    return launch_dkdv_sm90<D, kBoth>(tm_q, tm_k, tm_v, tm_do, lse, delta, dk, dv, batch, seq,
                                      heads, kv_heads, causal, win, scale, stream);
  } else {
    err = launch_dkdv_sm90<D, kDvOnly>(tm_q, tm_k, tm_v, tm_do, lse, delta, dk, dv, batch,
                                       seq, heads, kv_heads, causal, win, scale, stream);
    if (err != cudaSuccess) return err;
    return launch_dkdv_sm90<D, kDkOnly>(tm_q, tm_k, tm_v, tm_do, lse, delta, dk, dv, batch,
                                        seq, heads, kv_heads, causal, win, scale, stream);
  }
}

}  // namespace

extern "C" {

const char* fab_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// dtype: 0 = f32, 1 = bf16. lse is the forward's (B, H, S) f32 output, delta
// a (B, H, S) f32 scratch. Returns cudaErrorInvalidValue for a shape the
// kernels do not take (the Python wrapper checks first).
int fa_backward(const void* q, const void* k, const void* v, const void* o,
                const void* dout, const void* lse, void* dq, void* dk, void* dv,
                void* delta, int64_t batch, int64_t seq, int64_t heads, int64_t kv_heads,
                int64_t head_dim, int dtype, int causal, int64_t window, float scale,
                void* stream) {
  if (batch < 1 || batch > 65535 || seq < 1 || kv_heads < 1 || heads % kv_heads ||
      heads > 65535)
    return (int)cudaErrorInvalidValue;
  if (dtype == 1 &&
      ((seq + kRowsWg - 1) / kRowsWg > 65535 ||
       ((uintptr_t)q | (uintptr_t)k | (uintptr_t)v | (uintptr_t)o | (uintptr_t)dout) % 16))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  float* dl = static_cast<float*>(delta);
  if (dtype == 0)
    return (int)hopper::by_dim(head_dim, [&](auto d) {
      return launch_f32<decltype(d)::value>(q, k, v, o, dout, l, dq, dk, dv, dl, batch, seq,
                                            (int)heads, (int)kv_heads, causal, window,
                                            scale, s);
    });
  if (dtype == 1)
    return (int)hopper::by_dim(head_dim, [&](auto d) {
      return launch_sm90<decltype(d)::value>(q, k, v, o, dout, l, dq, dk, dv, dl, batch,
                                             seq, (int)heads, (int)kv_heads, causal, window,
                                             scale, s);
    });
  return (int)cudaErrorInvalidValue;
}

// The dynamic shared memory a block of kernel 0 (dQ) or 1 (dK/dV) takes
// for dtype 0 (f32) or 1 (bf16) at head dim head_dim; -1 for a head dim or
// dtype the kernels do not take.
int64_t fa_bwd_smem_bytes(int64_t head_dim, int dtype, int kernel) {
  int64_t bytes = -1;
  hopper::by_dim(head_dim, [&](auto d) {
    constexpr int D = decltype(d)::value;
    if (dtype == 0) bytes = kernel == 0 ? Smem<D>::kDqBytes : Smem<D>::kDkdvBytes;
    if (dtype == 1) bytes = kernel == 0 ? Bwd90<D>::kDqSmem : Bwd90<D>::kKvSmem;
    return cudaSuccess;
  });
  return bytes;
}

}  // extern "C"
