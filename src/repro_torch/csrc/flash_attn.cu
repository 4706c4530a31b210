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
// max m, running sum l and the accumulator are f32; masked scores are -1e30
// and their p is 0; l is floored at 1e-20; o is written in q's dtype.
//
// Bound on an H100 SXM at the serving path's shape (Hymba-1.5B prefill, B = 2,
// S = 4096, H = 25, Hkv = 5, D = 64, window 1024, bf16): operations. The
// visible (query, key) pairs number 3,670,528 per (b, h), so 4 * D * pairs *
// B * H = 46.98 GFLOP, 47.5 us at 989 TFLOP/s (bf16 dense), against 62.9 MB
// of q, k, v, o (18.8 us at 3.35 TB/s).
//
// Design (first, simple version: right before fast). One block per (query
// tile of kBlockQ = 64 rows, head, batch); one thread per query row, holding
// its scaled q row and its f32 accumulator in registers. K/V tiles of kBlockK
// rows are staged in shared memory as f32 and read by all threads of the
// block at the same address (a broadcast). Products run on the CUDA cores
// in f32; wgmma, TMA and warp specialisation are later work. Tiles wholly
// outside [q0 - window + 1, q0 + kBlockQ - 1] are never loaded, so a window
// of 1024 at S = 4096 walks 17 of 64 kv tiles per query tile (the TPU kernel
// walks all of them and masks); inside a tile a thread skips each chunk of
// kChunk keys it cannot see. Ragged S is masked in-kernel: rows past S load
// zeros and are never visible, query rows past S are not written.
//
// Online softmax, per row and per chunk of kChunk keys, in the Pallas body's
// order: m_new = max(m, max_j s_j); p_j = visible ? exp(s_j - m_new) : 0;
// alpha = exp(m - m_new); l = alpha * l + sum_j p_j; acc = acc * alpha +
// sum_j p_j v_j; at the end o = acc / max(l, 1e-20).
//
// Shapes: D in {32, 64, 128} (a template parameter: the row lives in
// registers; D = 128 spills part of it to local memory), bf16 or f32 inputs.
//
// Interface: plain C, loaded with ctypes. fa_forward launches on the stream
// it is given, allocates nothing and returns cudaGetLastError().
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -I csrc -o libflash_attn.so flash_attn.cu

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlockQ = 64;     // query rows per block, one per thread
constexpr int kChunk = 16;      // keys per online-softmax update
constexpr float kNegInf = -1e30f;

template <int D>
struct KvTile {
  static constexpr int kRows = D <= 64 ? 64 : 32;  // K and V tiles: 32 KB
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

template <typename T, int D>
__global__ void __launch_bounds__(kBlockQ)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, int64_t seq,
                 int heads, int kv_heads, int causal, int64_t window,
                 float scale) {
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
    const T* qrow = q + ((b * seq + qpos) * heads + h) * D;
#pragma unroll
    for (int d = 0; d < D; ++d) qr[d] = to_f32(qrow[d]) * scale;
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
        kval = to_f32(k[off]);
        vval = to_f32(v[off]);
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
    T* orow = o + ((b * seq + qpos) * heads + h) * D;
#pragma unroll
    for (int d = 0; d < D; ++d) orow[d] = from_f32<T>(acc[d] / denom);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int64_t batch, int64_t seq, int64_t heads, int64_t kv_heads,
                   int causal, int64_t window, float scale, cudaStream_t stream) {
  const dim3 grid((unsigned)((seq + kBlockQ - 1) / kBlockQ), (unsigned)heads,
                  (unsigned)batch);
  flash_fwd_kernel<T, D><<<grid, kBlockQ, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), seq, (int)heads, (int)kv_heads, causal, window, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_dim(const void* q, const void* k, const void* v, void* o,
                       int64_t batch, int64_t seq, int64_t heads, int64_t kv_heads,
                       int64_t dim, int causal, int64_t window, float scale,
                       cudaStream_t stream) {
  switch (dim) {
    case 32:
      return launch<T, 32>(q, k, v, o, batch, seq, heads, kv_heads, causal, window,
                           scale, stream);
    case 64:
      return launch<T, 64>(q, k, v, o, batch, seq, heads, kv_heads, causal, window,
                           scale, stream);
    case 128:
      return launch<T, 128>(q, k, v, o, batch, seq, heads, kv_heads, causal, window,
                            scale, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

const char* fa_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// dtype: 0 = float32, 1 = bfloat16. Returns cudaErrorInvalidValue for a
// shape or type the kernel does not take (the Python wrapper checks first).
int fa_forward(const void* q, const void* k, const void* v, void* o, int64_t batch,
               int64_t seq, int64_t heads, int64_t kv_heads, int64_t dim, int dtype,
               int causal, int64_t window, float scale, void* stream) {
  if (batch < 1 || seq < 1 || kv_heads < 1 || heads % kv_heads || heads > 65535 ||
      batch > 65535)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)launch_dim<float>(q, k, v, o, batch, seq, heads, kv_heads, dim, causal,
                                  window, scale, s);
  if (dtype == 1)
    return (int)launch_dim<__nv_bfloat16>(q, k, v, o, batch, seq, heads, kv_heads, dim,
                                          causal, window, scale, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
