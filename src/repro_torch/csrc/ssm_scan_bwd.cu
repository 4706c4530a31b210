// Hand-written Hopper (sm_90a) kernel: the backward of K6 (the Mamba-1
// selective scan of csrc/ssm_scan.cu).
//
// The JAX package has no TPU kernel for this: it trains through ssm_train's
// chunked associative_scan (src/repro/models/ssm.py:63-102) and lets
// jax.grad differentiate it. The port's forward is the CUDA kernel K6, so
// its gradient is a kernel too: ss_backward here.
//
// Forward, per (b, d, n), with h_0 = 0 (a_t = exp(dt_t A), A = amat[b / a_rows]):
//   h_t = a_t h_{t-1} + (dt_t x_t) B_t[n],      y_t[d] = sum_n h_t C_t[n]
// Backward, for the cotangent dy, from the end of the sequence:
//   g_t   = C_t[n] dy_t + a_{t+1} g_{t+1}                  (dL/dh_t, g_S = 0)
//   dx_t  = dt_t sum_n g_t B_t[n]
//   ddt_t = sum_n (g_t x_t B_t[n] + g_t h_{t-1} a_t A)
//   dB_t  = sum_d g_t dt_t x_t          dC_t = sum_d h_t dy_t
//   dA    = sum over the rows of A's group and t of g_t h_{t-1} a_t dt_t
//
// Layout as in the forward: a block takes 32 consecutive channels d of one
// row b and all N states, lane = channel, warp = state (32 N threads).
//   - Pass 1 walks the sequence forward in chunks of kT = 16 steps, with the
//     forward's op order (the same h bit for bit), and stores h at the start
//     of each chunk to a checkpoint buffer (B, S / 16, N, di) f32: 1/16 of
//     the (B, S, di, N) states. Each thread reads back only what it wrote.
//   - Pass 2 walks the chunks backward. A chunk's x, dt, dy, B_, C_ are
//     staged in shared memory; each thread rebuilds its chunk's 16 states
//     from the checkpoint in registers, then walks them in reverse with g
//     and a_{t+1} carried across chunks. The two terms summed over n go to
//     shared memory [n][t][lane] and are summed over the states in order
//     after the chunk (dx, ddt); the two summed over d are summed over the
//     warp's 32 channels by a shuffle tree (lane 0's result) and written as
//     one partial a block to (B, S, di / 32, N) buffers; dA stays in a
//     register per (b, d, n) over the whole sequence.
//   - A second kernel sums the dB_ / dC_ partials over the channel blocks,
//     and dA over the rows of each A group, in a fixed order.
// No float atomics: two launches give the same bits.
//
// Bound on an H100 SXM at Hymba-1.5B's widths (B = 2, S = 4096, di = 3200,
// N = 16): bytes. It reads x, dt, dy and writes dx, ddt (5 B S di f32) and
// reads B_, C_ and writes dB_, dC_ (4 B S N f32): 526.4 MB, 0.157 ms at 3.35
// TB/s. Its scratch (checkpoints 104.9 MB, dB_ / dC_ partials 2 x 52.4 MB at
// that shape) moves on top. The kernel runs three exps a state-step (the
// forward pass, the rebuild, the reverse walk) and ten shuffles.
//
// Shapes: any B (<= 65535), S and di; N in {4, 8, 16, 32}.
//
// Interface: plain C, loaded with ctypes. ss_backward_workspace gives the
// floats of scratch a call needs; ss_backward launches both kernels on the
// stream it is given, allocates nothing and returns the first CUDA error.
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -I csrc -o libssm_scan_bwd.so ssm_scan_bwd.cu

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kT = 16;         // steps of a chunk: checkpoint spacing, registers
constexpr int kChannels = 32;  // channels per block: one per lane

template <int N>
struct Layout {
  static constexpr int kThreads = kChannels * N;
  static constexpr int kX = 0;                       // x:  [t][lane]
  static constexpr int kDt = kX + kT * kChannels;    // dt: [t][lane]
  static constexpr int kDy = kDt + kT * kChannels;   // dy: [t][lane]
  static constexpr int kB = kDy + kT * kChannels;    // B_: [t][n]
  static constexpr int kC = kB + kT * N;             // C_: [t][n]
  static constexpr int kPx = kC + kT * N;            // g B_:  [n][t][lane]
  static constexpr int kPdt = kPx + N * kT * kChannels;  // ddt terms: [n][t][lane]
  static constexpr int kFloats = kPdt + N * kT * kChannels;
  static constexpr size_t kBytes = sizeof(float) * kFloats;
};

struct Sizes {
  int64_t chunks, blocks, ckpt, partial, da_rows;
};

__host__ __device__ inline Sizes sizes(int64_t batch, int64_t seq, int64_t di, int64_t n) {
  Sizes s;
  s.chunks = (seq + kT - 1) / kT;
  s.blocks = (di + kChannels - 1) / kChannels;
  s.ckpt = batch * s.chunks * n * di;
  s.partial = batch * seq * s.blocks * n;
  s.da_rows = batch * di * n;
  return s;
}

// Copies chunk steps t0 .. t0 + kT - 1 of x, dt (and dy), B_, C_ into shared
// memory; what lies past S or di reads as 0.
template <int N>
__device__ __forceinline__ void stage(float* sm, const float* x, const float* dt,
                                      const float* dy, const float* bmat,
                                      const float* cmat, int64_t b, int64_t t0,
                                      int64_t seq, int64_t d0, int64_t di) {
  using L = Layout<N>;
  for (int e = threadIdx.x; e < kT * kChannels; e += L::kThreads) {
    const int j = e / kChannels, c = e % kChannels;
    const int64_t t = t0 + j, d = d0 + c;
    const bool ok = t < seq && d < di;
    const int64_t at = (b * seq + t) * di + d;
    sm[L::kX + e] = ok ? x[at] : 0.f;
    sm[L::kDt + e] = ok ? dt[at] : 0.f;
    if (dy != nullptr) sm[L::kDy + e] = ok ? dy[at] : 0.f;
  }
  for (int e = threadIdx.x; e < kT * N; e += L::kThreads) {
    const int j = e / N, nn = e % N;
    const int64_t t = t0 + j;
    const bool ok = t < seq;
    sm[L::kB + e] = ok ? bmat[(b * seq + t) * N + nn] : 0.f;
    if (cmat != nullptr) sm[L::kC + e] = ok ? cmat[(b * seq + t) * N + nn] : 0.f;
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  return v;  // lane 0's
}

template <int N>
__global__ void __launch_bounds__(Layout<N>::kThreads)
ss_bwd_kernel(const float* __restrict__ x, const float* __restrict__ dt,
              const float* __restrict__ bmat, const float* __restrict__ cmat,
              const float* __restrict__ amat, const float* __restrict__ dy,
              float* __restrict__ dx, float* __restrict__ ddt, float* __restrict__ ckpt,
              float* __restrict__ pb, float* __restrict__ pc, float* __restrict__ pa,
              int64_t seq, int64_t di, int64_t a_rows) {
  using L = Layout<N>;
  extern __shared__ __align__(16) float sm[];
  const int tid = threadIdx.x;
  const int lane = tid % kChannels;  // channel in the block
  const int n = tid / kChannels;     // state
  const int64_t b = blockIdx.y;
  const int64_t blk = blockIdx.x, nblk = gridDim.x;
  const int64_t d0 = blk * kChannels, d = d0 + lane;
  const bool live = d < di;
  const float a = live ? amat[(b / a_rows) * di * N + d * N + n] : 0.f;
  const int64_t chunks = (seq + kT - 1) / kT;
  float* const ck = ckpt + (b * chunks * N + n) * di + d;  // + c * N * di

  // pass 1: the forward recurrence, h stored at the start of every chunk
  float h = 0.f;
  for (int64_t c = 0; c < chunks; ++c) {
    if (live) ck[c * N * di] = h;
    __syncthreads();  // the previous chunk's reads are done
    stage<N>(sm, x, dt, nullptr, bmat, nullptr, b, c * kT, seq, d0, di);
    __syncthreads();
#pragma unroll
    for (int j = 0; j < kT; ++j) {
      const float dtv = sm[L::kDt + j * kChannels + lane];
      const float da = expf(__fmul_rn(dtv, a));
      h = __fadd_rn(__fmul_rn(da, h),
                    __fmul_rn(__fmul_rn(dtv, sm[L::kX + j * kChannels + lane]),
                              sm[L::kB + j * N + n]));
    }
  }

  // pass 2: chunks in reverse; g and a_{t+1} carried across them
  float g = 0.f, a_next = 0.f, da_acc = 0.f;
  for (int64_t c = chunks - 1; c >= 0; --c) {
    const int64_t t0 = c * kT;
    __syncthreads();  // the previous chunk's sums are done
    stage<N>(sm, x, dt, dy, bmat, cmat, b, t0, seq, d0, di);
    __syncthreads();
    const float h0 = live ? ck[c * N * di] : 0.f;
    float hs[kT];
    float hh = h0;
#pragma unroll
    for (int j = 0; j < kT; ++j) {
      const float dtv = sm[L::kDt + j * kChannels + lane];
      const float da = expf(__fmul_rn(dtv, a));
      hh = __fadd_rn(__fmul_rn(da, hh),
                     __fmul_rn(__fmul_rn(dtv, sm[L::kX + j * kChannels + lane]),
                               sm[L::kB + j * N + n]));
      hs[j] = hh;
    }
#pragma unroll
    for (int j = kT - 1; j >= 0; --j) {
      const float xv = sm[L::kX + j * kChannels + lane];
      const float dtv = sm[L::kDt + j * kChannels + lane];
      const float dyv = sm[L::kDy + j * kChannels + lane];
      const float bv = sm[L::kB + j * N + n];
      const float cv = sm[L::kC + j * N + n];
      const float hp = j > 0 ? hs[j - 1] : h0;
      g = __fadd_rn(__fmul_rn(cv, dyv), __fmul_rn(a_next, g));
      const float da = expf(__fmul_rn(dtv, a));
      const float gh = __fmul_rn(__fmul_rn(g, hp), da);
      const float px = __fmul_rn(g, bv);
      sm[L::kPx + (n * kT + j) * kChannels + lane] = px;
      sm[L::kPdt + (n * kT + j) * kChannels + lane] =
          __fadd_rn(__fmul_rn(px, xv), __fmul_rn(gh, a));
      da_acc = __fadd_rn(da_acc, __fmul_rn(gh, dtv));
      const float db = warp_sum(__fmul_rn(g, __fmul_rn(dtv, xv)));
      const float dc = warp_sum(__fmul_rn(hs[j], dyv));
      const int64_t t = t0 + j;
      if (lane == 0 && t < seq) {
        const int64_t at = ((b * seq + t) * nblk + blk) * N + n;
        pb[at] = db;
        pc[at] = dc;
      }
      a_next = da;
    }
    __syncthreads();  // the chunk's terms are in shared memory
    for (int e = tid; e < kT * kChannels; e += L::kThreads) {
      const int j = e / kChannels, cc = e % kChannels;
      const int64_t t = t0 + j, dd = d0 + cc;
      if (t >= seq || dd >= di) continue;
      float sx = 0.f, sd = 0.f;
#pragma unroll
      for (int s = 0; s < N; ++s) {
        sx = __fadd_rn(sx, sm[L::kPx + (s * kT + j) * kChannels + cc]);
        sd = __fadd_rn(sd, sm[L::kPdt + (s * kT + j) * kChannels + cc]);
      }
      const int64_t at = (b * seq + t) * di + dd;
      dx[at] = __fmul_rn(sm[L::kDt + e], sx);
      ddt[at] = sd;
    }
  }
  if (live) pa[(b * di + d) * N + n] = da_acc;
}

// db, dc (B, S, N): the partials summed over the channel blocks in order;
// da (B / a_rows, di, N): the rows' dA summed over each group in order.
__global__ void ss_bwd_reduce_kernel(const float* __restrict__ pb,
                                     const float* __restrict__ pc,
                                     const float* __restrict__ pa, float* __restrict__ db,
                                     float* __restrict__ dc, float* __restrict__ da,
                                     int64_t rows, int64_t nblk, int64_t n,
                                     int64_t a_items, int64_t mat, int64_t a_rows) {
  const int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t bc_items = rows * n;
  if (idx < bc_items) {
    const int64_t base = (idx / n) * nblk * n + idx % n;
    float sb = 0.f, sc = 0.f;
    for (int64_t k = 0; k < nblk; ++k) {
      sb = __fadd_rn(sb, pb[base + k * n]);
      sc = __fadd_rn(sc, pc[base + k * n]);
    }
    db[idx] = sb;
    dc[idx] = sc;
  } else if (idx - bc_items < a_items) {
    const int64_t e = idx - bc_items;
    const int64_t base = (e / mat) * a_rows * mat + e % mat;
    float sa = 0.f;
    for (int64_t r = 0; r < a_rows; ++r) sa = __fadd_rn(sa, pa[base + r * mat]);
    da[e] = sa;
  }
}

template <int N>
cudaError_t launch(const float* x, const float* dt, const float* bmat, const float* cmat,
                   const float* amat, const float* dy, float* dx, float* ddt, float* db,
                   float* dc, float* da, float* work, int64_t batch, int64_t seq,
                   int64_t di, int64_t a_rows, cudaStream_t stream) {
  using L = Layout<N>;
  const Sizes sz = sizes(batch, seq, di, N);
  float* const ckpt = work;
  float* const pb = ckpt + sz.ckpt;
  float* const pc = pb + sz.partial;
  float* const pa = pc + sz.partial;
  cudaError_t err = cudaFuncSetAttribute(
      ss_bwd_kernel<N>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L::kBytes);
  if (err != cudaSuccess) return err;
  ss_bwd_kernel<N><<<dim3((unsigned)sz.blocks, (unsigned)batch), L::kThreads, L::kBytes,
                     stream>>>(x, dt, bmat, cmat, amat, dy, dx, ddt, ckpt, pb, pc, pa,
                               seq, di, a_rows);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int64_t a_items = (batch / a_rows) * di * N;
  const int64_t items = batch * seq * N + a_items;
  ss_bwd_reduce_kernel<<<(unsigned)((items + 255) / 256), 256, 0, stream>>>(
      pb, pc, pa, db, dc, da, batch * seq, sz.blocks, N, a_items, di * N, a_rows);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* ssb_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Floats of scratch one ss_backward call needs: h checkpoints, the dB_ / dC_
// partials and the per-row dA.
int64_t ss_backward_workspace(int64_t batch, int64_t seq, int64_t di, int64_t n) {
  const Sizes s = sizes(batch, seq, di, n);
  return s.ckpt + 2 * s.partial + s.da_rows;
}

// amat holds batch / a_rows matrices of (di, n); da gets the same shape.
// work holds ss_backward_workspace(...) floats. Returns
// cudaErrorInvalidValue for a shape the kernels do not take (the Python
// wrapper checks first).
int ss_backward(const float* x, const float* dt, const float* bmat, const float* cmat,
                const float* amat, const float* dy, float* dx, float* ddt, float* db,
                float* dc, float* da, float* work, int64_t batch, int64_t seq, int64_t di,
                int64_t n, int64_t a_rows, void* stream) {
  if (batch < 1 || batch > 65535 || seq < 1 || di < 1 || a_rows < 1 || batch % a_rows)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (n) {
    case 4:
      return (int)launch<4>(x, dt, bmat, cmat, amat, dy, dx, ddt, db, dc, da, work, batch,
                            seq, di, a_rows, s);
    case 8:
      return (int)launch<8>(x, dt, bmat, cmat, amat, dy, dx, ddt, db, dc, da, work, batch,
                            seq, di, a_rows, s);
    case 16:
      return (int)launch<16>(x, dt, bmat, cmat, amat, dy, dx, ddt, db, dc, da, work,
                             batch, seq, di, a_rows, s);
    case 32:
      return (int)launch<32>(x, dt, bmat, cmat, amat, dy, dx, ddt, db, dc, da, work,
                             batch, seq, di, a_rows, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
