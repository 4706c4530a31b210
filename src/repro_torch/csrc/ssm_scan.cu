// Hand-written Hopper (sm_90a) kernel K6: the Mamba-1 selective scan.
//
// It replaces the Pallas TPU kernel of the JAX package's
// src/repro/kernels/ssm_scan/kernel.py:
//
//   K6 selective_scan_pallas (:51, body _ssm_kernel :26) -> ss_forward.
//
// It computes, for x, dt (B, S, di), B_, C_ (B, S, N) and A (di, N), all f32,
// with h_0 = 0:
//
//   h_t = exp(dt_t * A) * h_{t-1} + (dt_t * x_t) * B_t     (per (b, d, n))
//
// A is shared by every batch row, or one A per group of a_rows consecutive
// rows (row b reads A[b / a_rows]; a_rows = B is the shared case, and under
// the clients' vmap each client's rows read that client's A), so a vmapped
// call is still one launch.
//   y_t = sum_n h_t[n] * C_t[n]                            (y: (B, S, di) f32)
//
// The D * x and z-gate terms stay outside, as in the JAX package.
//
// Bound on an H100 SXM at the serving path's shape (Hymba-1.5B prefill, B = 2,
// S = 4096, di = 3200, N = 16): bytes. It moves x, dt and y (3 * B*S*di*4 B)
// plus B_, C_ and A, 315.8 MB, 94.3 us at 3.35 TB/s; its 419M exps take
// about as long on the SFUs (16 a clock per SM: ~0.11 ms).
//
// What held the first design back: one thread owned one (b, d) channel and
// walked its N states in registers, so there were B * di = 6,400 threads:
// 100 blocks of 2 warps, 32 SMs idle and two of each busy SM's four
// schedulers with nothing to issue; each thread ran S * N exps and the FMA
// chain alone, with no other warp to hide their latency; and a chunk's
// inputs were loaded by scalar loads before a barrier, so loads never
// overlapped the walk.
//
// This design gives each state its own thread: B * di * N threads, 102,400
// at the serving shape. A block takes kChannels = 32 consecutive channels d
// of one b and all N states: lane = channel, warp = state n (32 * N
// threads, 512 at N = 16; 200 blocks at the serving shape, one or two per
// SM by registers).
//   - Staging: a chunk of kChunkT = 32 steps of x, dt (32 channels), B_ and
//     C_ (N states) goes into shared memory transposed, [row][t], so a
//     thread reads 4 steps of a row as one float4. The copies are 4-byte
//     cp.async (zero-filled past S and di, so any S and di work with no
//     padding copy), a warp taking 8 rows x 4 steps so its 32 writes fall in
//     32 banks; double-buffered: chunk c + 1 is in flight while chunk c is
//     walked and summed.
//   - Walk: each thread carries its h in a register through the chunk, 4
//     steps at a time: it reads the next group's x, dt, B_, C_ before it
//     stores this group's terms (one buffer in shared memory, so the
//     compiler keeps loads and stores in source order), computes the 4 exps
//     and (dt x) B_ products ahead of the h chain, and stores the 4 terms
//     p = h C_[n] as one float4 to P[n][lane][t].
//   - y: after a barrier, each item (channel, 4 steps) sums P over the N
//     states in order, 4 steps at a time, and stores y; the next chunk's
//     first barrier frees P again. No atomics, no scratch in device memory.
// What bounds it as built: the shared-memory path. Every value a lane
// receives from shared memory costs its 4 bytes of the SM's 128 bytes a
// clock, broadcast or not (measured: B_, C_ as one broadcast float4 per 4
// steps or as 4 scalar broadcasts cost alike; by warp shuffle, more). A
// state-step takes dt, x, B_, C_ in and p out and back: 24 bytes, 10 GB at
// the serving shape, 0.30 ms at 128 B/clock on 132 SMs at 1.98 GHz; and
// 200 blocks on 132 SMs leave 64 SMs with one block while 68 have two.
// Halving the dt, x reads would take two states per thread.
//
// Op order, per state, exactly as the first design (bit-identical h and y):
//   da  = expf(__fmul_rn(dt, a[n]))               (accurate expf, no fast-math)
//   h   = __fadd_rn(__fmul_rn(da, h), __fmul_rn(__fmul_rn(dt, x), B_[n]))
//   p_n = __fmul_rn(h, C_[n])
//   y   = __fadd_rn(... __fadd_rn(__fadd_rn(0.f, p_0), p_1) ..., p_{N-1})
// (__fmul_rn / __fadd_rn, because nvcc would otherwise contract them into
// FMAs and drift from the plain version.)
//
// Measured (chip_smoke.py, NVIDIA H100 80GB HBM3, 700.00 W; PERF.md has
// both runs): at the serving shape 0.464 ms a launch (burst and profile),
// against 1.50 ms for the first design and a 0.094 ms bytes bound; S = 1001
// 0.119 ms. Blocks of 8 or 16 channels spread more evenly over the SMs but
// measured no clear gain at N = 16 and losses at N = 4, 8 and 32.
//
// Shapes: any B (<= 65535), S and di; N in {4, 8, 16, 32} (a template
// parameter: it sets the block's warps and the shared-memory layout).
//
// Interface: plain C, loaded with ctypes. ss_forward launches on the stream
// it is given, allocates nothing and returns the first CUDA error.
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -I csrc -o libssm_scan.so ssm_scan.cu

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kChunkT = 32;          // time steps staged and walked per chunk
constexpr int kStep = 4;             // steps read as one float4 of a row
constexpr int kRow = kChunkT + 4;    // floats per staged row: 16-byte rows,
                                     // adjacent rows in other bank groups

constexpr int kChannels = 32;      // channels per block: one per lane

// Shared-memory layout, in floats, for N states. Every part starts 16-byte
// aligned.
template <int N>
struct Layout {
  static constexpr int kThreads = kChannels * N;
  static constexpr int kIn = 2 * kChannels * kRow;  // x or dt: [buf][channel][t]
  static constexpr int kBc = 2 * N * kRow;   // B_ or C_: [buf][state][t]
  static constexpr int kX = 0;
  static constexpr int kDt = kX + kIn;
  static constexpr int kB = kDt + kIn;
  static constexpr int kC = kB + kBc;
  static constexpr int kP = kC + kBc;
  static constexpr int kFloats = kP + N * kChannels * kRow;  // P: [n][channel][t]
  static constexpr size_t kBytes = sizeof(float) * kFloats;
};

__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool valid) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  // src-size 0: nothing is read and the 4 bytes are zero-filled
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(addr),
               "l"(src), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all_but_newest() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// Copies one (kChunkT x R) tile, element (t, r) from src[t * stride + r] to
// dst[r * kRow + t], zero-filling t >= steps or r >= rows. A warp instruction
// covers G = min(R, 8) rows x 32 / G steps: G-float segments of global rows,
// and (for R >= 8) 32 distinct banks of the transposed tile.
template <int R, int kThreads>
__device__ __forceinline__ void stage_tile(float* dst, const float* src, int stride,
                                           int steps, int rows, int tid) {
  constexpr int G = R < 8 ? R : 8;
  static_assert(R % G == 0 && (kChunkT * R) % kThreads == 0, "whole copies");
#pragma unroll
  for (int i = 0; i < kChunkT * R / kThreads; ++i) {
    const int e = tid + i * kThreads;
    const int lane = e % 32, sub = e / 32;
    const int r = sub % (R / G) * G + lane % G;
    const int t = sub / (R / G) * (32 / G) + lane / G;
    const bool ok = t < steps && r < rows;
    cp_async4(dst + r * kRow + t, src + (ok ? t * stride + r : 0), ok);
  }
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// Blocks of 256 or more threads: at most 64 registers a thread, so 1024 of
// their threads fit an SM. Blocks of 128 (N = 4): up to 128 registers (at 64
// the instance spilled).
template <int N>
constexpr int kMinBlocks = Layout<N>::kThreads >= 256 ? 1024 / Layout<N>::kThreads : 4;

template <int N>
__global__ void __launch_bounds__(Layout<N>::kThreads, kMinBlocks<N>)
selective_scan_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                      const float* __restrict__ bmat, const float* __restrict__ cmat,
                      const float* __restrict__ amat, float* __restrict__ y,
                      int64_t seq, int64_t di, int64_t a_rows) {
  using L = Layout<N>;
  extern __shared__ __align__(16) float smem[];
  float* const xs = smem + L::kX;    // [buf][channel][t]
  float* const dts = smem + L::kDt;  // [buf][channel][t]
  float* const bs = smem + L::kB;    // [buf][n][t]
  float* const cs = smem + L::kC;    // [buf][n][t]
  float* const ps = smem + L::kP;    // [n][channel][t]

  const int tid = threadIdx.x;
  const int c = tid % kChannels;  // this thread's channel in the block (lane)
  const int n = tid / kChannels;  // its state (warp)
  const int64_t b = blockIdx.y;
  const int64_t d0 = (int64_t)blockIdx.x * kChannels;
  const int64_t d = d0 + c;
  const float a = d < di ? amat[(b / a_rows) * di * N + d * N + n] : 0.f;
  float h = 0.f;

  // Copies chunk `ch` into buffer `buf`; what lies past S or di reads as 0.
  auto stage = [&](int64_t ch, int buf) {
    const int64_t t0 = ch * kChunkT;
    const int steps = (int)(seq - t0 < kChunkT ? seq - t0 : kChunkT);
    const int64_t row = (b * seq + t0) * di + d0;
    const int rows = (int)(di - d0 < kChannels ? di - d0 : kChannels);
    stage_tile<kChannels, L::kThreads>(xs + buf * kChannels * kRow, x + row,
                                       (int)di, steps, rows, tid);
    stage_tile<kChannels, L::kThreads>(dts + buf * kChannels * kRow, dt + row,
                                       (int)di, steps, rows, tid);
    const int64_t bc = (b * seq + t0) * N;
    stage_tile<N, L::kThreads>(bs + buf * N * kRow, bmat + bc, N, steps, N, tid);
    stage_tile<N, L::kThreads>(cs + buf * N * kRow, cmat + bc, N, steps, N, tid);
  };

  const int64_t chunks = (seq + kChunkT - 1) / kChunkT;
  stage(0, 0);
  cp_async_commit();
  for (int64_t ch = 0; ch < chunks; ++ch) {
    const int buf = (int)(ch & 1);
    // buffer buf ^ 1 was last read by the walk of chunk ch - 1, which every
    // thread finished before that chunk's second barrier
    if (ch + 1 < chunks) stage(ch + 1, buf ^ 1);
    cp_async_commit();  // possibly empty: keeps one group per chunk
    cp_async_wait_all_but_newest();
    __syncthreads();  // chunk ch has landed; the y pass of ch - 1 is done

    // Walk: h through kChunkT steps (zeros past S leave it unchanged), in
    // groups of kStep. A group's inputs are read before the previous
    // group's terms are stored, and its exps and (dt x) B_ products come
    // before the h chain, so the loads and the SFU work of one group
    // overlap the dependent chain of another. The group's kStep terms go to
    // P as one float4.
    const float* xr = xs + (buf * kChannels + c) * kRow;
    const float* dr = dts + (buf * kChannels + c) * kRow;
    const float* br = bs + (buf * N + n) * kRow;
    const float* cr = cs + (buf * N + n) * kRow;
    float* pr = ps + (n * kChannels + c) * kRow;
    float4 xq = ld4(xr), dq = ld4(dr), bq = ld4(br), cq = ld4(cr);
#pragma unroll
    for (int t = 0; t < kChunkT; t += kStep) {
      const float xv[kStep] = {xq.x, xq.y, xq.z, xq.w};
      const float dv[kStep] = {dq.x, dq.y, dq.z, dq.w};
      const float bv[kStep] = {bq.x, bq.y, bq.z, bq.w};
      const float cv[kStep] = {cq.x, cq.y, cq.z, cq.w};
      if (t + kStep < kChunkT) {
        xq = ld4(xr + t + kStep);
        dq = ld4(dr + t + kStep);
        bq = ld4(br + t + kStep);
        cq = ld4(cr + t + kStep);
      }
      float da[kStep], u[kStep], p[kStep];
#pragma unroll
      for (int j = 0; j < kStep; ++j) {
        da[j] = expf(__fmul_rn(dv[j], a));
        u[j] = __fmul_rn(__fmul_rn(dv[j], xv[j]), bv[j]);
      }
#pragma unroll
      for (int j = 0; j < kStep; ++j) {
        h = __fadd_rn(__fmul_rn(da[j], h), u[j]);
        p[j] = __fmul_rn(h, cv[j]);
      }
      *reinterpret_cast<float4*>(pr + t) = make_float4(p[0], p[1], p[2], p[3]);
    }
    __syncthreads();  // P holds the chunk's terms

    // y pass: item (channel k, steps 4g .. 4g + 3), items spread over the
    // block's threads; the states are summed in order, 4 steps at a time
    const int64_t t0 = ch * kChunkT;
    for (int i = tid; i < kChunkT / kStep * kChannels; i += L::kThreads) {
      const int k = i % kChannels, g = i / kChannels;
      if (d0 + k >= di) continue;
      const float* col = ps + k * kRow + g * kStep;
      float acc[kStep] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int s = 0; s < N; ++s) {
        const float4 q = ld4(col + s * kChannels * kRow);
        acc[0] = __fadd_rn(acc[0], q.x);
        acc[1] = __fadd_rn(acc[1], q.y);
        acc[2] = __fadd_rn(acc[2], q.z);
        acc[3] = __fadd_rn(acc[3], q.w);
      }
#pragma unroll
      for (int j = 0; j < kStep; ++j) {
        const int64_t t = t0 + g * kStep + j;
        if (t < seq) y[(b * seq + t) * di + d0 + k] = acc[j];
      }
    }
  }
}

template <int N>
cudaError_t launch(const float* x, const float* dt, const float* bmat,
                   const float* cmat, const float* amat, float* y, int64_t batch,
                   int64_t seq, int64_t di, int64_t a_rows, cudaStream_t stream) {
  using L = Layout<N>;
  const cudaError_t err = cudaFuncSetAttribute(
      selective_scan_kernel<N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)L::kBytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)((di + kChannels - 1) / kChannels), (unsigned)batch);
  selective_scan_kernel<N><<<grid, L::kThreads, L::kBytes, stream>>>(
      x, dt, bmat, cmat, amat, y, seq, di, a_rows);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* ss_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// amat holds batch / a_rows matrices of (di, n). Returns
// cudaErrorInvalidValue for a shape the kernel does not take (the Python
// wrapper checks first).
int ss_forward(const float* x, const float* dt, const float* bmat, const float* cmat,
               const float* amat, float* y, int64_t batch, int64_t seq, int64_t di,
               int64_t n, int64_t a_rows, void* stream) {
  // di < 2^26: a chunk's row offsets (t * di, t < kChunkT) fit an int
  if (batch < 1 || batch > 65535 || seq < 1 || di < 1 || di >= (1 << 26) ||
      a_rows < 1 || batch % a_rows)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (n) {
    case 4:
      return (int)launch<4>(x, dt, bmat, cmat, amat, y, batch, seq, di, a_rows, s);
    case 8:
      return (int)launch<8>(x, dt, bmat, cmat, amat, y, batch, seq, di, a_rows, s);
    case 16:
      return (int)launch<16>(x, dt, bmat, cmat, amat, y, batch, seq, di, a_rows, s);
    case 32:
      return (int)launch<32>(x, dt, bmat, cmat, amat, y, batch, seq, di, a_rows, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
