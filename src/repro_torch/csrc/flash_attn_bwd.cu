// Hand-written Hopper (sm_90a) kernel: the backward of K5 (causal /
// sliding-window attention with grouped-query K/V heads).
//
// The JAX package has no TPU kernel for this: it trains through the plain
// jnp attention of src/repro/models/attention.py (_full_attention and
// _sliding_window_attention, :86-166) and lets jax.grad differentiate it.
// The port's forward is the CUDA kernel of csrc/flash_attn.cu, so its
// gradient is a kernel too: fa_backward here.
//
// For q (B, S, H, D), k, v (B, S, Hkv, D), the forward's output o and its
// cotangent do (B, S, H, D), with scale = D^-0.5, head h reading kv head
// h / n_rep (n_rep = H / Hkv), key j visible to query i where
// (!causal || i >= j) && (window <= 0 || j > i - window):
//
//   s_ij   = scale * q_i . k_j                     (visible pairs only)
//   lse_i  = log sum_j exp(s_ij)                   (recomputed: K5's forward
//                                                   writes only o)
//   p_ij   = exp(s_ij - lse_i)
//   D_i    = sum_d do_i[d] * o_i[d]
//   ds_ij  = p_ij * (do_i . v_j - D_i)
//   dq_i   = scale * sum_j ds_ij k_j
//   dk_j   = scale * sum_{h in j's group} sum_i ds_ij q_i
//   dv_j   = sum_{h in j's group} sum_i p_ij do_i
//
// Everything is summed in f32; the outputs are written in q's dtype (f32 or
// bf16). Masked scores count as -1e30 in the row maximum and their p is 0;
// the row sum is floored at 1e-20, as in the forward.
//
// Two kernels, one C call:
//   fa_bwd_dq_kernel   a block per (64 query rows, h, b). Pass 1 walks the
//                      visible key tiles for the row max and sum (lse) and
//                      computes D_i; both go to an f32 scratch (B, H, S).
//                      Pass 2 walks the same tiles again: S = Q K^T,
//                      dP = dO V^T, dS, and dQ += dS K in registers.
//   fa_bwd_dkdv_kernel a block per (64 keys, kv head, b). It loops over the
//                      n_rep query heads of its group and, for each, over
//                      only the query tiles that can see its keys, reading
//                      lse and D from the scratch; dK and dV stay in
//                      registers and are written once, so the GQA sum is
//                      inside the block.
// No float atomics anywhere: two launches give the same bits.
//
// Inside a block (256 threads, all f32 in shared memory, bf16 converted on
// load): tiles of 64 rows x D, rows padded to D + 4 floats. Products that
// reduce over d (S = Q K^T, dP = dO V^T) give each thread a 4 x 4 block of
// strided rows (row = ty + 16 r, column = tx + 16 c) and read float4s along
// d: the 8 lanes of a quarter warp read 8 consecutive padded rows, which
// fall in 8 distinct 4-bank groups. Products that reduce over rows (dV +=
// P^T dO, dK += dS^T Q, dQ += dS K) give each thread 4 consecutive output
// rows x D / 16 columns, split in output panels: 4 consecutive columns of
// each 64-column panel where 64 divides D (64, 128, 256), else 2 of each
// 32-column panel (32, 160: five panels, 10 columns a thread), read as
// float4s (float2s) along the output columns. The work is CUDA-core FMAs:
// on these tiles a thread issues two float4 loads from shared memory per
// 16 FMAs, so shared memory, not the FMA pipes, is the limit. wgmma/TMA
// come with the redesign.
//
// D = 256 does not fit whole: four padded 64 x 256 f32 tiles alone are
// 266,240 B, over the 232,448 B a block may opt into. There the tiles a
// block walks (K and V in the dQ kernel, Q and dO in the dK/dV kernel) are
// staged in 64-column chunks, one output panel each, while the block's own
// rows stay whole: S and dP add up the chunks' partial products in d order
// (the same chain of FMAs as a whole tile), and dQ, dK, dV accumulate
// panel by panel as each chunk is loaded again. Shared memory, D = 160
// (whole) and 256 (chunks): 185,600 B (dQ) and 203,264 B (dK/dV) each.
//
// Bound on an H100 SXM at Hymba-1.5B's training shape (B = 2 x 1, S = 2048,
// H = 25, Hkv = 5, D = 64, window 1024): operations. 10 * D FLOP a visible
// pair (the forward's 4 D recomputed, 6 D of gradient products) against 67
// TFLOP/s of f32 CUDA-core work; the kernel does 16 D (the score product
// twice, once in each kernel, and the dq pass's lse pass) on 64 x 64 tiles
// of the band.
//
// Shapes: any B (<= 65535), S, H, Hkv with H % Hkv == 0; D in {32, 64, 128,
// 160, 256} (32: the smoke configs' head dim; 160: stablelm-12b; 256:
// gemma-7b).
//
// Interface: plain C, loaded with ctypes. fa_backward launches both
// kernels on the stream it is given, allocates nothing (the caller passes
// the (B, H, S) f32 lse and D scratch) and returns the first CUDA error;
// fa_bwd_smem_bytes reports each kernel's shared memory a block.
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -I csrc -o libflash_attn_bwd.so flash_attn_bwd.cu

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 64;       // query rows of a q-tile, keys of a k-tile
constexpr int kThreads = 256;   // 16 x 16 threads
constexpr int kLdp = kTile + 4;  // padded row of a 64 x 64 score tile
constexpr float kNegInf = -1e30f;

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

__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}

__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}

__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 v) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
  uint2 raw;
  raw.x = *reinterpret_cast<const unsigned*>(&lo);
  raw.y = *reinterpret_cast<const unsigned*>(&hi);
  *reinterpret_cast<uint2*>(p) = raw;
}

// Columns col0 .. col0 + W - 1 of rows row0 .. row0 + 63 of one head (src
// points at its (b, 0, head, 0); consecutive positions are `stride`
// elements apart) into a 64 x W f32 tile whose rows are LD floats apart;
// rows past S read as zeros.
template <int W, int LD, typename T>
__device__ __forceinline__ void load_cols(float* dst, const T* src, int64_t row0,
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
template <int D, typename T>
__device__ __forceinline__ void load_tile(float* dst, const T* src, int64_t row0,
                                          int64_t seq, int64_t stride) {
  load_cols<D, Smem<D>::kLd>(dst, src, row0, seq, stride, 0);
}

// Chunk cc of a 64 x D tile, into a padded 64 x kChunk buffer
template <int D, typename T>
__device__ __forceinline__ void load_chunk(float* dst, const T* src, int64_t row0,
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

__device__ __forceinline__ void store1(float* p, float v) { *p = v; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// Writes rows row0 + 4 ty + u (those below S) of one head: acc * mul.
template <int D, typename T>
__device__ __forceinline__ void store_rows(T* dst, const float (&acc)[4][D / 16],
                                           int64_t row0, int64_t seq, int64_t stride,
                                           float mul, int ty, int tx) {
  using L = Smem<D>;
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const int64_t s = row0 + 4 * ty + u;
    if (s >= seq) continue;
#pragma unroll
    for (int c = 0; c < L::kPanels; ++c) {
      T* const out = dst + s * stride + L::kPer * tx + L::kPanel * c;
      const float* a = acc[u] + L::kPer * c;
      if constexpr (L::kPer == 4) {
        store4(out, make_float4(a[0] * mul, a[1] * mul, a[2] * mul, a[3] * mul));
      } else {
        store1(out, a[0] * mul);
        store1(out + 1, a[1] * mul);
      }
    }
  }
}

__device__ __forceinline__ bool visible(int64_t i, int64_t j, int64_t seq,
                                        int causal, int64_t window) {
  return i < seq && j < seq && (!causal || i >= j) && (window <= 0 || j > i - window);
}

template <int D, typename T>
__global__ void __launch_bounds__(kThreads)
fa_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const T* __restrict__ o,
                 const T* __restrict__ dout, float* __restrict__ lse_out,
                 float* __restrict__ delta_out, T* __restrict__ dq, int64_t seq,
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
  const T* const qh = q + (b * seq * heads + h) * D;
  const T* const oh = o + (b * seq * heads + h) * D;
  const T* const doh = dout + (b * seq * heads + h) * D;
  const T* const kh = k + (b * seq * kv_heads + hk) * D;
  const T* const vh = v + (b * seq * kv_heads + hk) * D;

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

  // pass 1: row max and sum over the visible keys (online), for lse
  float m[4], l[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) { m[r] = kNegInf; l[r] = 0.f; }
  float s[4][4];
  for (int64_t t = t_lo; t < t_end; ++t) {
    const int64_t k0 = t * kTile;
    zero(s);
#pragma unroll
    for (int cc = 0; cc < kChunks; ++cc) {
      __syncthreads();  // ks free (o, or the previous chunk)
      load_chunk<D>(ks, kh, k0, seq, kstride, cc);
      __syncthreads();
      rows_dot<kChunk, kLd, kLdc>(s, qs + cc * kChunk, ks, ty, tx);
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int64_t i = q0 + ty + 16 * r;
      float sv[4], mx = kNegInf;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int64_t j = k0 + tx + 16 * c;
        sv[c] = visible(i, j, seq, causal, window) ? s[r][c] * scale : kNegInf;
        mx = fmaxf(mx, sv[c]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[r], mx);
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c) sum += sv[c] > kNegInf ? expf(sv[c] - m_new) : 0.f;
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[r] = l[r] * expf(m[r] - m_new) + sum;
      m[r] = m_new;
    }
  }
  float lse[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    lse[r] = m[r] + logf(fmaxf(l[r], 1e-20f));
    const int64_t i = q0 + ty + 16 * r;
    if (tx == 0 && i < seq) {
      const int64_t at = (b * heads + h) * seq + i;
      lse_out[at] = lse[r];
      delta_out[at] = del_s[ty + 16 * r];
    }
  }
  __syncthreads();  // del_s complete for every row
  float delta[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) delta[r] = del_s[ty + 16 * r];

  // pass 2: dQ += dS K over the same tiles
  float acc[4][D / 16];
  zero(acc);
  float dp[4][4];
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

template <int D, typename T>
__global__ void __launch_bounds__(kThreads)
fa_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, const T* __restrict__ dout,
                   const float* __restrict__ lse_in, const float* __restrict__ delta_in,
                   T* __restrict__ dk, T* __restrict__ dv, int64_t seq, int heads,
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
    const T* const qh = q + (b * seq * heads + h) * D;
    const T* const doh = dout + (b * seq * heads + h) * D;
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

template <int D, typename T>
cudaError_t launch(const T* q, const T* k, const T* v, const T* o, const T* dout,
                   T* dq, T* dk, T* dv, float* lse, float* delta, int64_t batch,
                   int64_t seq, int heads, int kv_heads, int causal, int64_t window,
                   float scale, cudaStream_t stream) {
  using L = Smem<D>;
  cudaError_t err = cudaFuncSetAttribute(fa_bwd_dq_kernel<D, T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)L::kDqBytes);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(fa_bwd_dkdv_kernel<D, T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)L::kDkdvBytes);
  if (err != cudaSuccess) return err;
  const unsigned tiles = (unsigned)((seq + kTile - 1) / kTile);
  fa_bwd_dq_kernel<D, T><<<dim3(tiles, heads, (unsigned)batch), kThreads, L::kDqBytes,
                           stream>>>(q, k, v, o, dout, lse, delta, dq, seq, heads,
                                     kv_heads, causal, window, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  fa_bwd_dkdv_kernel<D, T><<<dim3(tiles, kv_heads, (unsigned)batch), kThreads,
                             L::kDkdvBytes, stream>>>(q, k, v, dout, lse, delta, dk, dv,
                                                      seq, heads, kv_heads, causal,
                                                      window, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v, const void* o,
                     const void* dout, void* dq, void* dk, void* dv, float* lse,
                     float* delta, int64_t batch, int64_t seq, int heads, int kv_heads,
                     int64_t head_dim, int causal, int64_t window, float scale,
                     cudaStream_t stream) {
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* ot = static_cast<const T*>(o);
  const T* dot = static_cast<const T*>(dout);
  T* dqt = static_cast<T*>(dq);
  T* dkt = static_cast<T*>(dk);
  T* dvt = static_cast<T*>(dv);
  switch (head_dim) {
    case 32:
      return launch<32, T>(qt, kt, vt, ot, dot, dqt, dkt, dvt, lse, delta, batch, seq,
                           heads, kv_heads, causal, window, scale, stream);
    case 64:
      return launch<64, T>(qt, kt, vt, ot, dot, dqt, dkt, dvt, lse, delta, batch, seq,
                           heads, kv_heads, causal, window, scale, stream);
    case 128:
      return launch<128, T>(qt, kt, vt, ot, dot, dqt, dkt, dvt, lse, delta, batch, seq,
                            heads, kv_heads, causal, window, scale, stream);
    case 160:
      return launch<160, T>(qt, kt, vt, ot, dot, dqt, dkt, dvt, lse, delta, batch, seq,
                            heads, kv_heads, causal, window, scale, stream);
    case 256:
      return launch<256, T>(qt, kt, vt, ot, dot, dqt, dkt, dvt, lse, delta, batch, seq,
                            heads, kv_heads, causal, window, scale, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

template <int D>
int64_t smem_bytes(int kernel) {
  return (int64_t)(kernel == 0 ? Smem<D>::kDqBytes : Smem<D>::kDkdvBytes);
}

}  // namespace

extern "C" {

const char* fab_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// dtype: 0 = f32, 1 = bf16. Returns cudaErrorInvalidValue for a shape the
// kernels do not take (the Python wrapper checks first).
int fa_backward(const void* q, const void* k, const void* v, const void* o,
                const void* dout, void* dq, void* dk, void* dv, void* lse, void* delta,
                int64_t batch, int64_t seq, int64_t heads, int64_t kv_heads,
                int64_t head_dim, int dtype, int causal, int64_t window, float scale,
                void* stream) {
  if (batch < 1 || batch > 65535 || seq < 1 || kv_heads < 1 || heads % kv_heads ||
      heads > 65535)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  float* dl = static_cast<float*>(delta);
  if (dtype == 0)
    return (int)dispatch<float>(q, k, v, o, dout, dq, dk, dv, l, dl, batch, seq, (int)heads,
                                (int)kv_heads, head_dim, causal, window, scale, s);
  if (dtype == 1)
    return (int)dispatch<__nv_bfloat16>(q, k, v, o, dout, dq, dk, dv, l, dl, batch, seq,
                                        (int)heads, (int)kv_heads, head_dim, causal,
                                        window, scale, s);
  return (int)cudaErrorInvalidValue;
}

// The dynamic shared memory a block of kernel 0 (dQ) or 1 (dK/dV) takes
// at head dim head_dim; -1 for a head dim the kernels do not take.
int64_t fa_bwd_smem_bytes(int64_t head_dim, int kernel) {
  switch (head_dim) {
    case 32: return smem_bytes<32>(kernel);
    case 64: return smem_bytes<64>(kernel);
    case 128: return smem_bytes<128>(kernel);
    case 160: return smem_bytes<160>(kernel);
    case 256: return smem_bytes<256>(kernel);
    default: return -1;
  }
}

}  // extern "C"
