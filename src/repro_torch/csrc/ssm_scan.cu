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
//   y_t = sum_n h_t[n] * C_t[n]                            (y: (B, S, di) f32)
//
// The D * x and z-gate terms stay outside, as in the JAX package.
//
// Bound on an H100 SXM at the serving path's shape (Hymba-1.5B prefill, B = 2,
// S = 4096, di = 3200, N = 16): bytes. It moves x, dt and y (3 * B*S*di*4 B)
// plus B_, C_ and A, 315.8 MB, 94.3 us at 3.35 TB/s; its 419M exps are about
// the same on the SFUs.
//
// Design (first, simple version). The TPU kernel carries h across a
// sequential grid dimension in VMEM. Here one thread owns one (b, d)
// channel and carries its N state values in registers through a loop over
// t, so h never leaves the register file and exp(dt * A) is never stored.
// A block takes kThreads consecutive d of one b, so each warp loads 32
// consecutive x and dt values (coalesced). A chunk of kChunkT time steps of
// x and dt, and of B_ and C_ (N floats per step, read by every thread as a
// broadcast), is staged in shared memory before the threads walk it, so the
// loads of a chunk are in flight together. Each thread writes y[b, t, d]
// (coalesced across the warp). Any S and any di: the ragged edges are
// masked, with no padding copy.
//
// Known limit: the grid is B * di / kThreads blocks, B * di threads in all:
// 6,400 at the serving shape, a fraction of the card's 132 SMs x 2048
// threads, each walking S steps in order. Splitting S into chunks with a
// second pass (the chunked scan) is the perf PR's starting point.
//
// Numerics: op order of the Pallas body, da * h + (dt * x) * B_, each
// product and sum rounded on its own (__fmul_rn / __fadd_rn), because nvcc
// would otherwise contract them into FMAs and drift from the plain version.
// expf is the accurate exp (no fast-math).
//
// Shapes: N in {4, 8, 16, 32} (a template parameter: the state lives in
// registers).
//
// Interface: plain C, loaded with ctypes. ss_forward launches on the stream
// it is given, allocates nothing and returns cudaGetLastError().
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -I csrc -o libssm_scan.so ssm_scan.cu

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 64;  // channels d per block
constexpr int kChunkT = 32;   // time steps staged in shared memory per pass

template <int N>
__global__ void __launch_bounds__(kThreads)
selective_scan_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                      const float* __restrict__ bmat, const float* __restrict__ cmat,
                      const float* __restrict__ amat, float* __restrict__ y,
                      int64_t seq, int64_t di) {
  __shared__ float xs[kChunkT][kThreads];
  __shared__ float dts[kChunkT][kThreads];
  __shared__ float bs[kChunkT][N];
  __shared__ float cs[kChunkT][N];

  const int tid = threadIdx.x;
  const int64_t b = blockIdx.y;
  const int64_t d = (int64_t)blockIdx.x * kThreads + tid;
  const bool active = d < di;

  float a[N];
  float h[N];
#pragma unroll
  for (int n = 0; n < N; ++n) {
    a[n] = active ? amat[d * N + n] : 0.f;
    h[n] = 0.f;
  }

  for (int64_t t0 = 0; t0 < seq; t0 += kChunkT) {
    const int steps = seq - t0 < kChunkT ? (int)(seq - t0) : kChunkT;
    __syncthreads();  // every thread is done with the previous chunk
    for (int tt = 0; tt < steps; ++tt) {
      const int64_t off = (b * seq + t0 + tt) * di + d;
      xs[tt][tid] = active ? x[off] : 0.f;
      dts[tt][tid] = active ? dt[off] : 0.f;
    }
    const int64_t base = (b * seq + t0) * N;  // steps * N contiguous floats
    for (int idx = tid; idx < steps * N; idx += kThreads) {
      bs[idx / N][idx % N] = bmat[base + idx];
      cs[idx / N][idx % N] = cmat[base + idx];
    }
    __syncthreads();
    if (!active) continue;
    for (int tt = 0; tt < steps; ++tt) {
      const float dtt = dts[tt][tid];
      const float dtx = __fmul_rn(dtt, xs[tt][tid]);
      float acc = 0.f;
#pragma unroll
      for (int n = 0; n < N; ++n) {
        const float da = expf(__fmul_rn(dtt, a[n]));
        h[n] = __fadd_rn(__fmul_rn(da, h[n]), __fmul_rn(dtx, bs[tt][n]));
        acc = __fadd_rn(acc, __fmul_rn(h[n], cs[tt][n]));
      }
      y[(b * seq + t0 + tt) * di + d] = acc;
    }
  }
}

template <int N>
cudaError_t launch(const float* x, const float* dt, const float* bmat,
                   const float* cmat, const float* amat, float* y, int64_t batch,
                   int64_t seq, int64_t di, cudaStream_t stream) {
  const dim3 grid((unsigned)((di + kThreads - 1) / kThreads), (unsigned)batch);
  selective_scan_kernel<N><<<grid, kThreads, 0, stream>>>(x, dt, bmat, cmat, amat, y,
                                                          seq, di);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* ss_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Returns cudaErrorInvalidValue for a shape the kernel does not take (the
// Python wrapper checks first).
int ss_forward(const float* x, const float* dt, const float* bmat, const float* cmat,
               const float* amat, float* y, int64_t batch, int64_t seq, int64_t di,
               int64_t n, void* stream) {
  if (batch < 1 || batch > 65535 || seq < 1 || di < 1) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (n) {
    case 4:
      return (int)launch<4>(x, dt, bmat, cmat, amat, y, batch, seq, di, s);
    case 8:
      return (int)launch<8>(x, dt, bmat, cmat, amat, y, batch, seq, di, s);
    case 16:
      return (int)launch<16>(x, dt, bmat, cmat, amat, y, batch, seq, di, s);
    case 32:
      return (int)launch<32>(x, dt, bmat, cmat, amat, y, batch, seq, di, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
