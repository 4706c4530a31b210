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
// Bound on an H100 SXM at the training round's shape (B = 4 slots x 1
// sequence, S = 2048, di = 3200, N = 16, an A per slot): bytes. It reads x,
// dt, dy and writes dx, ddt (5 B S di f32), reads B_, C_ and writes dB_, dC_
// (4 B S N f32) and reads A and writes dA: 528.0 MB, 0.1576 ms at 3.35 TB/s.
// Its scratch (checkpoints 104.9 MB, dB_ / dC_ partials 2 x 52.4 MB) moves
// on top.
//
// What held the first design back (3.03 ms a launch at that shape, 5% of
// the bound): a thread per (channel, state), 512 threads a block at N = 16;
// three accurate expf a state-step (the forward pass, the rebuild of a
// chunk, the reverse walk again); two 5-round shuffle trees a state-step for
// dB_ and dC_, whose sums lane 0 stored one float at a time; the terms of dx
// and ddt went through shared memory once per state; and each chunk was
// staged by scalar loads between two barriers, with nothing in flight while
// it was walked.
//
// This design. A block takes 32 consecutive channels d of one row b and all
// N states: lane = channel, and each thread walks kP = 2 states (n = 2 w and
// 2 w + 1 for warp w), so a block has 16 N threads (256 at N = 16). x, dt,
// dy and the address arithmetic are read once for both states.
//   - Staging: a chunk of kT = 16 steps of x, dt, dy goes into shared memory
//     transposed ([channel][t], so a lane reads 4 steps of its channel as one
//     float4) and B_, C_ as they lie ([t][state]: a warp reads its two states
//     of a step as one broadcast float2), by 4-byte cp.async, zero-filled
//     past S and di. Pass 1 walks forward with chunk c + 1 in flight, pass 2
//     backward with chunk c - 1 in flight; three tiles, since a chunk's
//     sums read its dt and x after the next chunk's barrier. Offsets inside
//     a chunk are ints; only a chunk's base is 64-bit.
//   - Pass 1 walks the sequence forward with the forward kernel's op order
//     (the same h bit for bit) and stores h at the start of every chunk to a
//     checkpoint buffer (B, S / 16, N, di) f32. Each thread reads back only
//     what it wrote.
//   - Pass 2 walks the chunks backward. Each rebuilds its 16 steps' h_t and
//     a_t = exp(dt_t A) from the checkpoint, with the forward's op order, and
//     keeps them in registers (64 floats a thread); the reverse walk reads
//     a_t there and carries g and a_{t+1} across chunks. Two exps a
//     state-step in all (the first design: three).
//   - dx, ddt: each thread adds its two states' g B_ and g h_{t-1} a_t A
//     in registers and stores them as one float2 to shared memory
//     [warp][t][lane]; after the next chunk's barrier, one thread per (step,
//     channel) sums the warps in order and stores dx = dt * (sum of g B_)
//     and ddt = x * (sum of g B_) + (sum of g h_{t-1} a_t A). Pass 2 has one
//     barrier a chunk (two buffers of sums).
//   - dB_, dC_: a butterfly reduce-scatter over the warp's 32 channels. A
//     lane's 64 values of a chunk (16 steps x {dB_, dC_} x 2 states) are
//     halved each round: the lane keeps one half, adds its partner's copy of
//     it (shfl_xor) and sends the other half. The rounds run as the walk
//     goes: offset 1 splits dB_ from dC_ at every step, offsets 2, 4, 8, 16
//     split the step's bits as pairs of steps complete: 62 shuffles for 32
//     state-steps, against 320 for 64 trees. Lane k ends with complete sums
//     over the 32 channels (kind k & 1, step k >> 1, both states), stored
//     as 16 consecutive floats of dB_ or dC_ partials in (B, di / 32
//     channel blocks, N, S) order. The channels are summed in one fixed tree (pairs
//     of neighbours, then pairs of pairs, ...), whatever lane keeps a sum.
//   - dA: per (row, channel, state) in a register over the whole sequence,
//     stored once.
//   - A second kernel sums the dB_ / dC_ partials over the channel blocks,
//     and dA over the rows of each A group, in a fixed order.
// No float atomics: two launches give the same bits.
//
// Measured against a shorter window: keeping 8 steps of h and a (32
// floats) fits 64 registers, so 4 blocks of 256 threads share an SM and the
// training shape's 400 blocks run as one wave; but the upper half-chunk's
// rebuild then walks the lower half first (2.5 exps a state-step) and the
// walk spilled at 64 registers: 1.82 ms a launch (burst) at the training
// shape against 1.59 for the same code keeping 16 steps at 128 registers
// and 2 blocks an SM (1.52 waves), timed together (PERF.md).
//
// What bounds it as built: issue and latency of the walks, not bytes. At
// N = 16 the walks are ~80% of what a thread executes (cuobjdump -sass of
// the build: the pass-1 walk of a chunk is ~440 instructions for 32
// state-steps, the rebuild and reverse walk ~1,170; the two accurate expf
// ~17 instructions a state-step); staging and the dx / ddt sums the rest.
// The training shape's 400 blocks at 2 an SM run as 1.52 waves, and a wave
// of one block an SM takes about as long as one of two: B 2, S 4096 (200
// blocks, one wave, twice the steps a block) takes what the training shape
// takes for the same state-steps. Pass 1 alone takes ~29% of a launch.
//
// Measured (launch/k6_compare.py, NVIDIA H100 80GB HBM3, 700.00 W; PERF.md
// has the runs): at the training shape 1.4503 ms a launch in a burst and
// 1.6999 ms a single call, against 3.0331 / 3.2690 for the first design
// timed beside it (the bound: 0.1576 ms); B 2, S 4096 1.4683 ms (shared
// A) and 1.4657 (per row); S 1001 0.3914 ms.
//
// Op order (tests/test_torch_ssm_scan_bwd_order.py emulates it on the CPU):
//   h (pass 1 and the rebuilds), as the forward:
//     a_t = expf(__fmul_rn(dt, A)),
//     h   = __fadd_rn(__fmul_rn(a_t, h), __fmul_rn(__fmul_rn(dt, x), B_))
//   per state, from the last step:
//     g   = __fadd_rn(__fmul_rn(C_, dy), __fmul_rn(a_{t+1}, g))
//     gh  = __fmul_rn(__fmul_rn(g, h_{t-1}), a_t);  px = __fmul_rn(g, B_)
//     ga  = __fmul_rn(gh, A)
//     dA += __fmul_rn(gh, dt)  (from 0, t descending)
//     dB_ term __fmul_rn(g, __fmul_rn(dt, x)), dC_ term __fmul_rn(h_t, dy)
//   dx = dt * sx, sx = ((q_0 + q_1) + ... + q_{N/2-1}), q_w = px_{2w} +
//   px_{2w+1}; ddt = x * sx + ((r_0 + r_1) + ...), r_w = ga_{2w} +
//   ga_{2w+1}; dB_, dC_: the channel tree, then the blocks in order
//   ((p_0 + p_1) + p_2 ...); dA: the group's rows in order from 0.
//
// Shapes: any B (<= 65535), S (< 2^31) and di (< 2^26); N in {4, 8, 16, 32}.
//
// Interface: plain C, loaded with ctypes. ss_backward_workspace gives the
// floats of scratch a call needs; ss_backward launches both kernels on the
// stream it is given, allocates nothing and returns the first CUDA error;
// ss_backward_resident_blocks gives the blocks an SM holds at once.
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -I csrc -o libssm_scan_bwd.so ssm_scan_bwd.cu

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kT = 16;         // steps of a chunk: checkpoint spacing, staging,
                               // the h and a a thread keeps in registers
constexpr int kRow = kT + 4;   // floats a staged channel row: 16-byte rows, and
                               // a quarter-warp's float4 reads in 8 bank groups
constexpr int kChannels = 32;  // channels per block: one per lane
constexpr int kP = 2;          // states per thread
constexpr int kBufs = 3;       // tiles: chunk c's sums read its dt and x after
                               // the barrier of chunk c - 1, which stages c - 2
static_assert(kP == 2, "the walk is written out for two states a thread");

// Shared-memory layout, in floats, for N states: kBufs chunk tiles, then
// two chunks' sums (float2 [warp][t][lane]).
template <int N>
struct Layout {
  static constexpr int kWarps = N / kP;
  static constexpr int kThreads = kChannels * kWarps;
  static constexpr int kX = 0;                        // x:  [channel][t]
  static constexpr int kDt = kX + kChannels * kRow;   // dt: [channel][t]
  static constexpr int kDy = kDt + kChannels * kRow;  // dy: [channel][t]
  static constexpr int kB = kDy + kChannels * kRow;   // B_: [t][state]
  static constexpr int kC = kB + kT * N;              // C_: [t][state]
  static constexpr int kTile = kC + kT * N;
  static constexpr int kSums = 2 * kWarps * kT * kChannels;
  static constexpr int kFloats = kBufs * kTile + 2 * kSums;
  static constexpr size_t kBytes = sizeof(float) * kFloats;
  // registers a thread, with 64 floats of h and a: 128 at N >= 16 (2 blocks
  // of 256 threads an SM at N = 16); up to 255 below (at 128 and 168 the
  // N = 4 and 8 instances spilled)
  static constexpr int kRegs = N >= 16 ? 128 : 255;
  static constexpr int kMinBlocks =
      65536 / (kRegs * kThreads) > 0 ? 65536 / (kRegs * kThreads) : 1;
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

__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool valid) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  // src-size 0: nothing is read and the 4 bytes are zero-filled
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(addr),
               "l"(src), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ float2 ld2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// Copies the (kT steps x 32 channels) chunk of one of x, dt, dy transposed:
// element (t, r) from src[t * di + r] to dst[r * kRow + t], zero-filling
// t >= steps or r >= rows. A warp instruction covers 8 channels x 4 steps:
// 32-byte segments of the global rows, and 32 distinct banks.
template <int kThreads>
__device__ __forceinline__ void stage_rows(float* dst, const float* src, int di, int steps,
                                           int rows) {
  static_assert((kT * kChannels) % kThreads == 0, "whole copies");
#pragma unroll
  for (int i = 0; i < kT * kChannels / kThreads; ++i) {
    const int e = threadIdx.x + i * kThreads;
    const int lane = e % 32, sub = e / 32;
    const int r = sub % 4 * 8 + lane % 8, t = sub / 4 * 4 + lane / 8;
    const bool ok = t < steps && r < rows;
    cp_async4(dst + r * kRow + t, src + (ok ? t * di + r : 0), ok);
  }
}

// Starts the copy of the chunk whose first step is row `row` (b S + t0) of
// x, dt, B_ (and dy, C_ where kAll) into a tile; what lies past S (`steps`
// left) or di (`rows` channels left) reads as 0. Offsets inside a chunk are
// ints (di < 2^26); only the chunk's base is 64-bit.
template <int N, bool kAll>
__device__ __forceinline__ void stage(float* tile, const float* x, const float* dt,
                                      const float* dy, const float* bmat,
                                      const float* cmat, int64_t row, int steps,
                                      int64_t d0, int di, int rows) {
  using L = Layout<N>;
  const int64_t at = row * di + d0;
  stage_rows<L::kThreads>(tile + L::kX, x + at, di, steps, rows);
  stage_rows<L::kThreads>(tile + L::kDt, dt + at, di, steps, rows);
  if (kAll) stage_rows<L::kThreads>(tile + L::kDy, dy + at, di, steps, rows);
  const float* const bsrc = bmat + row * N;
  const float* const csrc = cmat + row * N;
  for (int e = threadIdx.x; e < kT * N; e += L::kThreads) {
    const bool ok = e / N < steps;
    cp_async4(tile + L::kB + e, bsrc + (ok ? e : 0), ok);
    if (kAll) cp_async4(tile + L::kC + e, csrc + (ok ? e : 0), ok);
  }
}

// One forward step for the thread's states, in the forward kernel's op
// order; da gets each state's a_t.
__device__ __forceinline__ void fwd_step(float dtv, float xv, float2 bv,
                                         const float (&a)[kP], float (&h)[kP],
                                         float (&da)[kP]) {
  const float u = __fmul_rn(dtv, xv);
  const float bb[kP] = {bv.x, bv.y};
#pragma unroll
  for (int s = 0; s < kP; ++s) {
    da[s] = expf(__fmul_rn(dtv, a[s]));
    h[s] = __fadd_rn(__fmul_rn(da[s], h[s]), __fmul_rn(u, bb[s]));
  }
}

// One butterfly round at lane offset `off`: lanes whose bit `off` is clear
// keep lo, the others hi; each adds its partner's copy of what it keeps.
__device__ __forceinline__ float exchange(float lo, float hi, int off, int lane) {
  const bool up = lane & off;
  const float keep = up ? hi : lo, send = up ? lo : hi;
  return __fadd_rn(keep, __shfl_xor_sync(0xffffffffu, send, off));
}

// What a thread carries from chunk to chunk of pass 2.
struct Carry {
  float a[kP];       // A of its states
  float g[kP];       // dL/dh at the last step walked
  float a_next[kP];  // a_{t+1} of that step
  float da[kP];      // dA of its row, channel and states so far
};

// Chunk walk of pass 2: rebuild its steps' h and a from the checkpoint h0,
// walk them backward, store the dx / ddt terms to `sums` and the chunk's
// dB_ / dC_ partials.
template <int N>
__device__ __forceinline__ void walk_chunk(const float* tile, float2* sums,
                                           const float (&h0)[kP], Carry& st, float* pb,
                                           float* pc, int lane, int w, int64_t part,
                                           int64_t t0, int64_t seq) {
  using L = Layout<N>;
  const int n0 = w * kP;
  const float* const xr = tile + L::kX + lane * kRow;  // this lane's rows
  const float* const dr = tile + L::kDt + lane * kRow;
  const float* const yr = tile + L::kDy + lane * kRow;
  float hh[kP] = {h0[0], h0[1]}, da[kP];
  float hs[kP][kT], as[kP][kT];
#pragma unroll
  for (int q = 0; q < kT; q += 4) {
    const float4 x4 = ld4(xr + q), d4 = ld4(dr + q);
    const float xv[4] = {x4.x, x4.y, x4.z, x4.w}, dv[4] = {d4.x, d4.y, d4.z, d4.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      fwd_step(dv[k], xv[k], ld2(tile + L::kB + (q + k) * N + n0), st.a, hh, da);
#pragma unroll
      for (int s = 0; s < kP; ++s) {
        hs[s][q + k] = hh[s];
        as[s][q + k] = da[s];
      }
    }
  }

  float pend[kP][4];
  float4 x4, d4, y4;
#pragma unroll
  for (int j = kT - 1; j >= 0; --j) {
    if (j % 4 == 3) {
      x4 = ld4(xr + j - 3);
      d4 = ld4(dr + j - 3);
      y4 = ld4(yr + j - 3);
    }
    const float xv = j % 4 == 0 ? x4.x : j % 4 == 1 ? x4.y : j % 4 == 2 ? x4.z : x4.w;
    const float dtv = j % 4 == 0 ? d4.x : j % 4 == 1 ? d4.y : j % 4 == 2 ? d4.z : d4.w;
    const float dyv = j % 4 == 0 ? y4.x : j % 4 == 1 ? y4.y : j % 4 == 2 ? y4.z : y4.w;
    const float2 bv = ld2(tile + L::kB + j * N + n0);
    const float2 cv = ld2(tile + L::kC + j * N + n0);
    const float bb[kP] = {bv.x, bv.y}, cc[kP] = {cv.x, cv.y};
    const float dtx = __fmul_rn(dtv, xv);
    float qx = 0.f, qd = 0.f;
#pragma unroll
    for (int s = 0; s < kP; ++s) {
      const float g = __fadd_rn(__fmul_rn(cc[s], dyv), __fmul_rn(st.a_next[s], st.g[s]));
      const float hp = j > 0 ? hs[s][j - 1] : h0[s];
      const float gh = __fmul_rn(__fmul_rn(g, hp), as[s][j]);
      const float px = __fmul_rn(g, bb[s]);
      const float ga = __fmul_rn(gh, st.a[s]);
      st.da[s] = __fadd_rn(st.da[s], __fmul_rn(gh, dtv));
      qx = s == 0 ? px : __fadd_rn(qx, px);
      qd = s == 0 ? ga : __fadd_rn(qd, ga);
      st.g[s] = g;
      st.a_next[s] = as[s][j];
      // dB_ / dC_: offset 1 splits the kinds, then each completed pair of
      // steps (bit l of j) is split at offset 2 << l
      float cur = exchange(__fmul_rn(g, dtx), __fmul_rn(hs[s][j], dyv), 1, lane);
      bool open = true;
#pragma unroll
      for (int l = 0; l < 4; ++l) {
        if (open) {
          if ((j >> l) & 1) {
            pend[s][l] = cur;
            open = false;
          } else {
            cur = exchange(cur, pend[s][l], 2 << l, lane);
          }
        }
      }
      if (open) pend[s][0] = cur;  // j == 0: the chunk's sums of this state
    }
    sums[(w * kT + j) * kChannels + lane] = make_float2(qx, qd);
  }

  // lane k: kind k & 1, step k >> 1, both states
  float* const dst = (lane & 1) ? pc : pb;
  const int64_t t = t0 + (lane >> 1);
  if (t < seq) {
#pragma unroll
    for (int s = 0; s < kP; ++s) dst[(part + n0 + s) * seq + t] = pend[s][0];
  }
}

// The dx / ddt of the chunk at row `row` (b S + t0), `steps` of it before
// S (its tile and sums): one thread per (step, channel) sums the warps'
// float2 in order, then dx = dt * (sum of g B_) and ddt = x * (sum of g B_)
// + (sum of g h_{t-1} a_t A).
template <int N>
__device__ __forceinline__ void sum_chunk(const float* tile, const float2* sums,
                                          int64_t row, int steps, float* __restrict__ dx,
                                          float* __restrict__ ddt, int64_t d0, int di,
                                          int rows) {
  using L = Layout<N>;
  float* const dxc = dx + row * di + d0;
  float* const ddtc = ddt + row * di + d0;
  for (int e = threadIdx.x; e < kT * kChannels; e += L::kThreads) {
    const int j = e / kChannels, k = e % kChannels;
    if (j >= steps || k >= rows) continue;
    float2 q = sums[j * kChannels + k];
    float sx = q.x, sd = q.y;
    // at N = 32 the whole loop's loads pushed the walk past 128 registers
#pragma unroll(N == 32 ? 4 : L::kWarps)
    for (int w = 1; w < L::kWarps; ++w) {
      q = sums[(w * kT + j) * kChannels + k];
      sx = __fadd_rn(sx, q.x);
      sd = __fadd_rn(sd, q.y);
    }
    const int at = j * di + k;
    dxc[at] = __fmul_rn(tile[L::kDt + k * kRow + j], sx);
    ddtc[at] = __fadd_rn(__fmul_rn(tile[L::kX + k * kRow + j], sx), sd);
  }
}

template <int N>
__global__ void __launch_bounds__(Layout<N>::kThreads, Layout<N>::kMinBlocks)
ss_bwd_kernel(const float* __restrict__ x, const float* __restrict__ dt,
              const float* __restrict__ bmat, const float* __restrict__ cmat,
              const float* __restrict__ amat, const float* __restrict__ dy,
              float* __restrict__ dx, float* __restrict__ ddt, float* __restrict__ ckpt,
              float* __restrict__ pb, float* __restrict__ pc, float* __restrict__ pa,
              int64_t seq, int64_t di, int64_t a_rows) {
  using L = Layout<N>;
  extern __shared__ __align__(16) float sm[];
  float2* const sums = reinterpret_cast<float2*>(sm + kBufs * L::kTile);  // [2][warp][t][lane]
  const int lane = threadIdx.x % kChannels;  // channel in the block
  const int w = threadIdx.x / kChannels;     // states 2 w, 2 w + 1
  const int n0 = w * kP;
  const int64_t b = blockIdx.y;
  const int64_t blk = blockIdx.x, nblk = gridDim.x;
  const int64_t d0 = blk * kChannels, d = d0 + lane;
  const bool live = d < di;
  Carry st;
#pragma unroll
  for (int s = 0; s < kP; ++s) {
    st.a[s] = live ? amat[(b / a_rows) * di * N + d * N + n0 + s] : 0.f;
    st.g[s] = st.a_next[s] = st.da[s] = 0.f;
  }
  const int seq_i = (int)seq, di_i = (int)di;  // < 2^31 and < 2^26 (ss_backward)
  const int rows = (int)(di - d0 < kChannels ? di - d0 : kChannels);
  const int chunks = (seq_i + kT - 1) / kT;
  const int64_t row0 = b * seq;                               // + t: a row of x, dt, dy
  float* const ck = ckpt + (b * chunks * N + n0) * di + d;  // + (c N + s) di

  // pass 1: the forward recurrence, h stored at the start of every chunk
  float h[kP] = {0.f, 0.f}, da[kP];
  stage<N, false>(sm, x, dt, dy, bmat, cmat, row0, seq_i, d0, di_i, rows);
  cp_async_commit();
  for (int c = 0; c < chunks; ++c) {
    if (live) {
#pragma unroll
      for (int s = 0; s < kP; ++s) ck[(int64_t)(c * N + s) * di] = h[s];
    }
    cp_async_wait_all();
    __syncthreads();  // chunk c has landed; every walk of chunk c - 1 is done
    if (c + 1 < chunks)
      stage<N, false>(sm + (c + 1) % kBufs * L::kTile, x, dt, dy, bmat, cmat,
                      row0 + (c + 1) * kT, seq_i - (c + 1) * kT, d0, di_i, rows);
    cp_async_commit();
    const float* tile = sm + c % kBufs * L::kTile;
#pragma unroll
    for (int q = 0; q < kT; q += 4) {
      const float4 x4 = ld4(tile + L::kX + lane * kRow + q);
      const float4 d4 = ld4(tile + L::kDt + lane * kRow + q);
      const float xv[4] = {x4.x, x4.y, x4.z, x4.w}, dv[4] = {d4.x, d4.y, d4.z, d4.w};
#pragma unroll
      for (int k = 0; k < 4; ++k)
        fwd_step(dv[k], xv[k], ld2(tile + L::kB + (q + k) * N + n0), st.a, h, da);
    }
  }

  // pass 2: chunks in reverse; the sums of chunk c are taken after the
  // barrier of chunk c - 1
  const int64_t part = (b * nblk + blk) * N;  // + n: a row of S partials
  cp_async_wait_all();
  __syncthreads();  // pass 1's walks are done with every tile
  stage<N, true>(sm + (chunks - 1) % kBufs * L::kTile, x, dt, dy, bmat, cmat,
                 row0 + (chunks - 1) * kT, seq_i - (chunks - 1) * kT, d0, di_i, rows);
  cp_async_commit();
  for (int c = chunks - 1; c >= 0; --c) {
    float h0[kP];
#pragma unroll
    for (int s = 0; s < kP; ++s) h0[s] = live ? ck[(int64_t)(c * N + s) * di] : 0.f;
    cp_async_wait_all();
    __syncthreads();  // chunk c has landed; chunk c + 1's sums are in
    if (c > 0) {
      stage<N, true>(sm + (c - 1) % kBufs * L::kTile, x, dt, dy, bmat, cmat,
                     row0 + (c - 1) * kT, seq_i - (c - 1) * kT, d0, di_i, rows);
      cp_async_commit();
    }
    if (c + 1 < chunks)
      sum_chunk<N>(sm + (c + 1) % kBufs * L::kTile, sums + ((c + 1) & 1) * (L::kSums / 2),
                   row0 + (c + 1) * kT, seq_i - (c + 1) * kT, dx, ddt, d0, di_i, rows);
    walk_chunk<N>(sm + c % kBufs * L::kTile, sums + (c & 1) * (L::kSums / 2), h0, st, pb,
                  pc, lane, w, part, c * kT, seq);
  }
  __syncthreads();
  sum_chunk<N>(sm, sums, row0, seq_i, dx, ddt, d0, di_i, rows);
  if (live) {
#pragma unroll
    for (int s = 0; s < kP; ++s) pa[(b * di + d) * N + n0 + s] = st.da[s];
  }
}

// db, dc (B, S, N): the partials (B, blocks, N, S) summed over the channel
// blocks in order; da (B / a_rows, di, N): the rows' dA summed over each
// group in order.
__global__ void ss_bwd_reduce_kernel(const float* __restrict__ pb,
                                     const float* __restrict__ pc,
                                     const float* __restrict__ pa, float* __restrict__ db,
                                     float* __restrict__ dc, float* __restrict__ da,
                                     int64_t batch, int64_t seq, int64_t nblk, int64_t n,
                                     int64_t a_items, int64_t mat, int64_t a_rows) {
  const int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t bc_items = batch * n * seq;
  if (idx < bc_items) {  // idx = (b n + state) S + t: the reads are coalesced
    const int64_t t = idx % seq, bn = idx / seq, bb = bn / n, nn = bn % n;
    const int64_t base = (bb * nblk * n + nn) * seq + t, stride = n * seq;
    float sb = 0.f, sc = 0.f;
    for (int64_t k = 0; k < nblk; ++k) {
      sb = __fadd_rn(sb, pb[base + k * stride]);
      sc = __fadd_rn(sc, pc[base + k * stride]);
    }
    db[(bb * seq + t) * n + nn] = sb;
    dc[(bb * seq + t) * n + nn] = sc;
  } else if (idx - bc_items < a_items) {
    const int64_t e = idx - bc_items;
    const int64_t base = (e / mat) * a_rows * mat + e % mat;
    float sa = 0.f;
    for (int64_t r = 0; r < a_rows; ++r) sa = __fadd_rn(sa, pa[base + r * mat]);
    da[e] = sa;
  }
}

template <int N>
cudaError_t allow_smem() {
  return cudaFuncSetAttribute(ss_bwd_kernel<N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)Layout<N>::kBytes);
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
  cudaError_t err = allow_smem<N>();
  if (err != cudaSuccess) return err;
  ss_bwd_kernel<N><<<dim3((unsigned)sz.blocks, (unsigned)batch), L::kThreads, L::kBytes,
                     stream>>>(x, dt, bmat, cmat, amat, dy, dx, ddt, ckpt, pb, pc, pa,
                               seq, di, a_rows);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int64_t a_items = (batch / a_rows) * di * N;
  const int64_t items = batch * seq * N + a_items;
  ss_bwd_reduce_kernel<<<(unsigned)((items + 255) / 256), 256, 0, stream>>>(
      pb, pc, pa, db, dc, da, batch, seq, sz.blocks, N, a_items, di * N, a_rows);
  return cudaGetLastError();
}

template <int N>
int resident() {
  int blocks = 0;
  cudaError_t err = allow_smem<N>();
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, ss_bwd_kernel<N>,
                                                        Layout<N>::kThreads,
                                                        Layout<N>::kBytes);
  if (err != cudaSuccess) {
    cudaGetLastError();  // reported to the caller, not left for the next launch
    return -(int)err;
  }
  return blocks;
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

// Blocks of ss_bwd_kernel<n> an SM holds at once on the current device.
// Negative: -(cudaError_t).
int ss_backward_resident_blocks(int64_t n) {
  switch (n) {
    case 4:
      return resident<4>();
    case 8:
      return resident<8>();
    case 16:
      return resident<16>();
    case 32:
      return resident<32>();
    default:
      return -(int)cudaErrorInvalidValue;
  }
}

// amat holds batch / a_rows matrices of (di, n); da gets the same shape.
// work holds ss_backward_workspace(...) floats. Returns
// cudaErrorInvalidValue for a shape the kernels do not take (the Python
// wrapper checks first).
int ss_backward(const float* x, const float* dt, const float* bmat, const float* cmat,
                const float* amat, const float* dy, float* dx, float* ddt, float* db,
                float* dc, float* da, float* work, int64_t batch, int64_t seq, int64_t di,
                int64_t n, int64_t a_rows, void* stream) {
  // seq < 2^31 and di < 2^26: offsets inside a chunk (t * di, t < 16) are ints
  if (batch < 1 || batch > 65535 || seq < 1 || seq >= (int64_t(1) << 31) || di < 1 ||
      di >= (1 << 26) || a_rows < 1 || batch % a_rows)
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
