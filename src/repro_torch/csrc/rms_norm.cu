// Hand-written Hopper (sm_90a) kernels: the models' RMSNorm, forward and
// backward.
//
// They replace no TPU kernel. The JAX package's rms_norm
// (src/repro/models/layers.py:26) is a jnp chain that XLA fuses on the TPU;
// run eagerly, the same chain is ~10 PyTorch ops forward and ~15 backward,
// each one more pass over the rows (about 40 bytes an element forward).
//
// Forward, for x (rows, d) in bf16 or f32 with a row stride, and w (G, d) f32
// with a row stride (row i reads w[i / w_rows]; G = 1 is a shared weight, as
// is a row stride of 0), all in f32:
//   r_i  = rsqrt(sum_j x_ij^2 (1 / d) + eps)      rstd, one f32 a row
//   y_ij = (x_ij * r_i) * (1 + w_j)               rounded once to x's dtype
// which is the eager chain's arithmetic in its order; only the row sum is
// taken in another order (a lane's terms, then a shuffle tree).
// Backward, for dy (rows, d) in x's dtype and the forward's r:
//   s_i   = sum_j (dy_ij (1 + w_j)) x_ij
//   dx_ij = r_i (dy_ij (1 + w_j)) - x_ij (r_i^3 s_i (1 / d))   in x's dtype
//   dw_gj = sum of dy_ij (x_ij r_i) over the rows i of dw group g   (f32)
// The dw groups are the vmapped calls folded into the rows (dw_rows rows a
// group): each call gets its own dw even where the calls share w.
//
// Bound on an H100 (3.35 TB/s): bytes. The forward moves 2 rows d sizeof(x)
// + G d 4 (+ 4 rows for r): 419.4 MB at the prefill shape (65,536 x 1,600
// bf16), 0.125 ms. The backward moves 3 rows d sizeof(x) + 4 rows + 8 G d
// and its dw partials. So each reads x (and dy) once from device memory and
// writes once:
//   - d <= 2,048 (bf16) or 1,024 (f32), 16-byte aligned rows: "rows" kernels.
//     A row belongs to `lanes` threads (a warp, or a power-of-two part of one
//     for short rows), each holding up to kMaxVectors 16-byte vectors of it in
//     registers as loaded (bf16 packed, so ~70 registers and many warps an
//     SM keep enough loads in flight); the f32 sum of squares is a shuffle
//     tree inside the row's lanes. (1 + w) of the block's weight group sits in
//     shared memory. The forward's groups of lanes walk a few rows each, as
//     many as keep about kFwdBlocksPerSm blocks an SM.
//   - any other d or alignment: "block" kernels, a block of 256 threads a row
//     (block_reduce.cuh's fixed-order block_sum); the second pass over the row
//     reads it again from L1/L2, not device memory.
// dw is deterministic, with no atomics: the backward's blocks each own a tile
// of rows inside one dw group and write one partial row of d sums (lanes keep
// their columns' sums in shared memory, summed over the block's row groups in
// a fixed order); a second kernel sums each group's partials in tile order.
// The tiling depends only on the shape and the SM count, so two launches give
// identical bits.
//
// Interface: plain C, loaded with ctypes. The entry points launch on the
// stream they are given, allocate nothing (the backward's partials come from
// the caller, rn_backward_workspace floats) and return the first CUDA error.
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -I csrc -o librms_norm.so rms_norm.cu

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

#include "block_reduce.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kRowThreads = 128;  // "rows" kernels: 4 warps a block
constexpr int kMaxVectors = 8;    // 16-byte vectors of a row a lane holds
constexpr int kMaxRowD = 32 * kMaxVectors * 8;  // widest "rows" row: 2,048
constexpr int kMaxRowsPerSub = 8;  // forward: rows a group of lanes walks
constexpr int kFwdBlocksPerSm = 8;  // forward: blocks aimed at per SM
constexpr int kBlockThreads = block_reduce::kThreads;  // "block" kernels: 256
constexpr int kSumThreads = 256;  // dw's second stage
constexpr int kTilesPerSm = 4;    // backward: blocks aimed at per SM

template <typename T>
constexpr int kVec16 = 16 / (int)sizeof(T);  // elements of a 16-byte access

// ---------------------------------------------------------------------------
// loads and stores of VEC elements: one 16-byte access (VEC = kVec16<T>) or
// one element (VEC = 1); values in f32
// ---------------------------------------------------------------------------

template <typename T, int VEC>
__device__ __forceinline__ void load(const T* p, float (&v)[VEC]) {
  if constexpr (VEC == 1) {
    if constexpr (sizeof(T) == 2) v[0] = __bfloat162float(*p);
    else v[0] = *p;
  } else if constexpr (sizeof(T) == 2) {
    const uint4 q = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&q);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      v[2 * i] = f.x;
      v[2 * i + 1] = f.y;
    }
  } else {
    const float4 q = *reinterpret_cast<const float4*>(p);
    v[0] = q.x, v[1] = q.y, v[2] = q.z, v[3] = q.w;
  }
}

template <typename T, int VEC>
__device__ __forceinline__ void store(T* p, const float (&v)[VEC]) {
  if constexpr (VEC == 1) {
    if constexpr (sizeof(T) == 2) *p = __float2bfloat16_rn(v[0]);
    else *p = v[0];
  } else if constexpr (sizeof(T) == 2) {
    uint4 q;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&q);
#pragma unroll
    for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
    *reinterpret_cast<uint4*>(p) = q;
  } else {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  }
}

// 1 + w for VEC columns (w is read-only for the launch: the L1 path)
template <int VEC>
__device__ __forceinline__ void load_gain(const float* w, float (&g)[VEC]) {
  if constexpr (VEC == 1) {
    g[0] = __fadd_rn(1.f, __ldg(w));
  } else {
#pragma unroll
    for (int i = 0; i < VEC; i += 4) {
      const float4 q = __ldg(reinterpret_cast<const float4*>(w + i));
      g[i] = __fadd_rn(1.f, q.x), g[i + 1] = __fadd_rn(1.f, q.y);
      g[i + 2] = __fadd_rn(1.f, q.z), g[i + 3] = __fadd_rn(1.f, q.w);
    }
  }
}

// A row's 16-byte vectors are held as they were loaded (bf16 stays packed:
// half the registers of its floats) and unpacked where they are used.
template <typename T>
__device__ __forceinline__ uint4 load_raw(const T* p) {
  return *reinterpret_cast<const uint4*>(p);
}

template <typename T>
__device__ __forceinline__ void unpack(const uint4& q, float (&v)[kVec16<T>]) {
  if constexpr (sizeof(T) == 2) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&q);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      v[2 * i] = f.x;
      v[2 * i + 1] = f.y;
    }
  } else {
    v[0] = __uint_as_float(q.x), v[1] = __uint_as_float(q.y);
    v[2] = __uint_as_float(q.z), v[3] = __uint_as_float(q.w);
  }
}

// (1 + w) of one weight row into shared memory, by the whole block (d % 4
// == 0); read back by read_gain
__device__ __forceinline__ void stage_gain(const float* w, float* gain, int d) {
  for (int c = threadIdx.x * 4; c < d; c += blockDim.x * 4) {
    const float4 q = __ldg(reinterpret_cast<const float4*>(w + c));
    *reinterpret_cast<float4*>(gain + c) =
        make_float4(__fadd_rn(1.f, q.x), __fadd_rn(1.f, q.y), __fadd_rn(1.f, q.z),
                    __fadd_rn(1.f, q.w));
  }
}

template <int VEC>
__device__ __forceinline__ void read_gain(const float* gain, float (&g)[VEC]) {
#pragma unroll
  for (int i = 0; i < VEC; i += 4) {
    const float4 q = *reinterpret_cast<const float4*>(gain + i);
    g[i] = q.x, g[i + 1] = q.y, g[i + 2] = q.z, g[i + 3] = q.w;
  }
}

// Sum over a row's `lanes` threads (a power of two, aligned inside the warp):
// a butterfly, so every lane ends with the same bits (a + b == b + a). Every
// lane of the warp must call it.
__device__ __forceinline__ float lanes_sum(float v, int lanes) {
  for (int off = lanes >> 1; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// block_sum, with the total handed to every thread
__device__ __forceinline__ float block_total(float v, float* smem) {
  __shared__ float total;
  v = block_reduce::block_sum(v, smem);
  if (threadIdx.x == 0) total = v;
  __syncthreads();
  v = total;
  __syncthreads();  // total may be written again by the next call
  return v;
}

// inv_d = 1 / d, rounded once on the host: a division would call the
// IEEE divide's slow-path subroutine, whose frame ptxas reports as spills
__device__ __forceinline__ float row_rstd(float sum_sq, float inv_d, float eps) {
  return rsqrtf(__fadd_rn(__fmul_rn(sum_sq, inv_d), eps));
}

// ---------------------------------------------------------------------------
// forward
// ---------------------------------------------------------------------------

// Each group of `lanes` threads walks `rps` consecutive rows; lane l holds
// vectors k = 0 .. NV-1 of a row at columns (k lanes + l) VEC. The block
// stages (1 + w) of its first row's weight group in shared memory; a row of
// another group (a block across a group boundary) reads w itself.
template <typename T, int NV>
__global__ void __launch_bounds__(kRowThreads)
rms_fwd_rows(const T* __restrict__ x, int64_t ldx, const float* __restrict__ w,
             int64_t ldw, int64_t w_rows, T* __restrict__ y, float* __restrict__ rstd, int64_t rows,
             int d, float inv_d, int lanes, int rps, float eps) {
  constexpr int VEC = kVec16<T>;
  __shared__ float4 gain4[kMaxRowD / 4];
  float* gain = reinterpret_cast<float*>(gain4);
  const int lane = threadIdx.x & (lanes - 1);
  const int sub = threadIdx.x / lanes;
  const int64_t block_first = (int64_t)blockIdx.x * (kRowThreads / lanes) * rps;
  const int64_t staged = block_reduce::div_index(block_first, w_rows);
  stage_gain(w + staged * ldw, gain, d);
  __syncthreads();
  const int64_t first = block_first + (int64_t)sub * rps;
#pragma unroll 1
  for (int i = 0; i < rps; ++i) {
    const int64_t row = first + i;
    const bool valid = row < rows;  // the shuffles below still run
    uint4 q[NV];
    float ss = 0.f;
#pragma unroll
    for (int k = 0; k < NV; ++k) {
      const int col = (k * lanes + lane) * VEC;
      q[k] = valid && col < d ? load_raw(x + row * ldx + col) : make_uint4(0, 0, 0, 0);
      float v[VEC];
      unpack<T>(q[k], v);
#pragma unroll
      for (int j = 0; j < VEC; ++j) ss = fmaf(v[j], v[j], ss);
    }
    ss = lanes_sum(ss, lanes);
    if (!valid) continue;  // every later row of this group is past the end too
    const float r = row_rstd(ss, inv_d, eps);
    const int64_t group = block_reduce::div_index(row, w_rows);
#pragma unroll
    for (int k = 0; k < NV; ++k) {
      const int col = (k * lanes + lane) * VEC;
      if (col < d) {
        float v[VEC], g[VEC], o[VEC];
        unpack<T>(q[k], v);
        if (group == staged) read_gain<VEC>(gain + col, g);
        else load_gain<VEC>(w + group * ldw + col, g);
#pragma unroll
        for (int j = 0; j < VEC; ++j) o[j] = __fmul_rn(__fmul_rn(v[j], r), g[j]);
        store<T, VEC>(y + row * d + col, o);
      }
    }
    if (lane == 0) rstd[row] = r;
  }
}

// One block a row, any d: the sum of squares, then the row again.
template <typename T, int VEC>
__global__ void __launch_bounds__(kBlockThreads)
rms_fwd_block(const T* __restrict__ x, int64_t ldx, const float* __restrict__ w,
              int64_t ldw, int64_t w_rows, T* __restrict__ y, float* __restrict__ rstd, int d,
              float inv_d, float eps) {
  __shared__ float red[block_reduce::kWarps];
  const int64_t row = blockIdx.x;
  const T* xr = x + row * ldx;
  float ss = 0.f;
  for (int c = threadIdx.x * VEC; c < d; c += kBlockThreads * VEC) {
    float v[VEC];
    load<T, VEC>(xr + c, v);
#pragma unroll
    for (int j = 0; j < VEC; ++j) ss = fmaf(v[j], v[j], ss);
  }
  const float r = row_rstd(block_total(ss, red), inv_d, eps);
  const float* wr = w + block_reduce::div_index(row, w_rows) * ldw;
  for (int c = threadIdx.x * VEC; c < d; c += kBlockThreads * VEC) {
    float v[VEC], g[VEC], o[VEC];
    load<T, VEC>(xr + c, v);
    load_gain<VEC>(wr + c, g);
#pragma unroll
    for (int j = 0; j < VEC; ++j) o[j] = __fmul_rn(__fmul_rn(v[j], r), g[j]);
    store<T, VEC>(y + row * d + c, o);
  }
  if (threadIdx.x == 0) rstd[row] = r;
}

// ---------------------------------------------------------------------------
// backward
// ---------------------------------------------------------------------------

// Block b owns tile b % tiles of dw group b / tiles: rows [lo, hi).
struct Tile {
  int64_t lo, hi;
};

__device__ __forceinline__ Tile tile_of(int64_t dw_rows, int64_t tiles, int64_t tile_rows) {
  const int64_t group = blockIdx.x / tiles, t = blockIdx.x % tiles;
  const int64_t lo = group * dw_rows + t * tile_rows;
  const int64_t end = (group + 1) * dw_rows;
  return {lo, lo + tile_rows < end ? lo + tile_rows : end};
}

// The block's groups of lanes take the tile's rows in turn, with (1 + w) of
// the tile's weight group staged in shared memory. A lane keeps its columns'
// dw sums in shared memory, laid out [sub][k][j][lane] (conflict free), and
// the block sums them over its groups in order at the end.
template <typename T, int NV>
__global__ void __launch_bounds__(kRowThreads)
rms_bwd_rows(const T* __restrict__ x, int64_t ldx, const float* __restrict__ w,
             int64_t ldw, int64_t w_rows, const float* __restrict__ rstd, const T* __restrict__ dy,
             int64_t lddy, T* __restrict__ dx, float* __restrict__ partials, int d,
             float inv_d, int lanes, int64_t dw_rows, int64_t tiles, int64_t tile_rows) {
  constexpr int VEC = kVec16<T>;
  constexpr int kPerLane = NV * VEC;
  __shared__ float4 acc4[kRowThreads * kPerLane / 4];
  __shared__ float4 gain4[kMaxRowD / 4];
  float* acc = reinterpret_cast<float*>(acc4);
  float* gain = reinterpret_cast<float*>(gain4);
  const int lane = threadIdx.x & (lanes - 1);
  const int sub = threadIdx.x / lanes;
  const int subs = kRowThreads / lanes;
  const Tile tile = tile_of(dw_rows, tiles, tile_rows);
  for (int i = threadIdx.x; i < kRowThreads * kPerLane; i += kRowThreads) acc[i] = 0.f;
  // a dw group lies inside one weight group
  stage_gain(w + block_reduce::div_index(tile.lo, w_rows) * ldw, gain, d);
  __syncthreads();
  float* mine = acc + sub * kPerLane * lanes + lane;  // [k][j] at (k VEC + j) lanes
#pragma unroll 1
  for (int64_t base = tile.lo; base < tile.hi; base += subs) {
    const int64_t row = base + sub;
    const bool valid = row < tile.hi;  // the shuffles below still run
    const float r = valid ? rstd[row] : 0.f;
    uint4 xq[NV], dq[NV];
    float s = 0.f;
#pragma unroll
    for (int k = 0; k < NV; ++k) {
      const int col = (k * lanes + lane) * VEC;
      const bool in = valid && col < d;
      xq[k] = in ? load_raw(x + row * ldx + col) : make_uint4(0, 0, 0, 0);
      dq[k] = in ? load_raw(dy + row * lddy + col) : make_uint4(0, 0, 0, 0);
      if (in) {
        float xv[VEC], dv[VEC], g[VEC];
        unpack<T>(xq[k], xv);
        unpack<T>(dq[k], dv);
        read_gain<VEC>(gain + col, g);
#pragma unroll
        for (int j = 0; j < VEC; ++j) {
          float* a = mine + (k * VEC + j) * lanes;
          *a = fmaf(dv[j], __fmul_rn(xv[j], r), *a);
          s = fmaf(__fmul_rn(dv[j], g[j]), xv[j], s);
        }
      }
    }
    s = lanes_sum(s, lanes);
    if (!valid) continue;  // the group's later rows are past the tile too
    const float c = __fmul_rn(__fmul_rn(__fmul_rn(__fmul_rn(r, r), r), s), inv_d);
#pragma unroll
    for (int k = 0; k < NV; ++k) {
      const int col = (k * lanes + lane) * VEC;
      if (col < d) {
        float xv[VEC], dv[VEC], g[VEC], o[VEC];
        unpack<T>(xq[k], xv);
        unpack<T>(dq[k], dv);
        read_gain<VEC>(gain + col, g);
#pragma unroll
        for (int j = 0; j < VEC; ++j)
          o[j] = fmaf(-xv[j], c, __fmul_rn(r, __fmul_rn(dv[j], g[j])));
        store<T, VEC>(dx + row * d + col, o);
      }
    }
  }
  __syncthreads();
  // partial sums of the tile: entry e = (k VEC + j) lanes + l is column
  // (k lanes + l) VEC + j, summed over the groups in order
  for (int e = threadIdx.x; e < kPerLane * lanes; e += kRowThreads) {
    const int kj = e / lanes, l = e % lanes;
    const int col = ((kj / VEC) * lanes + l) * VEC + kj % VEC;
    if (col >= d) continue;
    float sum = 0.f;
    for (int q = 0; q < subs; ++q) sum += acc[q * kPerLane * lanes + e];
    partials[(int64_t)blockIdx.x * d + col] = sum;
  }
}

// The tile's rows one at a time over the whole block, any d; each thread
// keeps its own columns' dw sums in shared memory (d floats, dynamic).
template <typename T, int VEC>
__global__ void __launch_bounds__(kBlockThreads)
rms_bwd_block(const T* __restrict__ x, int64_t ldx, const float* __restrict__ w,
              int64_t ldw, int64_t w_rows, const float* __restrict__ rstd, const T* __restrict__ dy,
              int64_t lddy, T* __restrict__ dx, float* __restrict__ partials, int d,
              float inv_d, int64_t dw_rows, int64_t tiles, int64_t tile_rows) {
  extern __shared__ float4 dyn4[];
  float* acc = reinterpret_cast<float*>(dyn4);
  __shared__ float red[block_reduce::kWarps];
  for (int c = threadIdx.x * VEC; c < d; c += kBlockThreads * VEC)
#pragma unroll
    for (int j = 0; j < VEC; ++j) acc[c + j] = 0.f;
  const Tile tile = tile_of(dw_rows, tiles, tile_rows);
#pragma unroll 1
  for (int64_t row = tile.lo; row < tile.hi; ++row) {
    const float r = rstd[row];
    const T* xr = x + row * ldx;
    const T* dyr = dy + row * lddy;
    const float* wr = w + block_reduce::div_index(row, w_rows) * ldw;
    float s = 0.f;
    for (int c = threadIdx.x * VEC; c < d; c += kBlockThreads * VEC) {
      float xv[VEC], dv[VEC], g[VEC];
      load<T, VEC>(xr + c, xv);
      load<T, VEC>(dyr + c, dv);
      load_gain<VEC>(wr + c, g);
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        acc[c + j] = fmaf(dv[j], __fmul_rn(xv[j], r), acc[c + j]);
        s = fmaf(__fmul_rn(dv[j], g[j]), xv[j], s);
      }
    }
    s = block_total(s, red);
    const float cf = __fmul_rn(__fmul_rn(__fmul_rn(__fmul_rn(r, r), r), s), inv_d);
    for (int c = threadIdx.x * VEC; c < d; c += kBlockThreads * VEC) {
      float xv[VEC], dv[VEC], g[VEC], o[VEC];
      load<T, VEC>(xr + c, xv);
      load<T, VEC>(dyr + c, dv);
      load_gain<VEC>(wr + c, g);
#pragma unroll
      for (int j = 0; j < VEC; ++j)
        o[j] = fmaf(-xv[j], cf, __fmul_rn(r, __fmul_rn(dv[j], g[j])));
      store<T, VEC>(dx + row * d + c, o);
    }
  }
  for (int c = threadIdx.x * VEC; c < d; c += kBlockThreads * VEC)
#pragma unroll
    for (int j = 0; j < VEC; ++j) partials[(int64_t)blockIdx.x * d + c + j] = acc[c + j];
}

// dw[g][j] = sum over t < tiles, in order, of partials[g tiles + t][j]
__global__ void __launch_bounds__(kSumThreads)
rms_dw_sum(const float* __restrict__ partials, float* __restrict__ dw, int d,
           int64_t tiles) {
  const int col = blockIdx.x * kSumThreads + threadIdx.x;
  if (col >= d) return;
  const float* p = partials + (int64_t)blockIdx.y * tiles * d + col;
  float sum = 0.f;
  for (int64_t t = 0; t < tiles; ++t) sum += p[t * d];
  dw[(int64_t)blockIdx.y * d + col] = sum;
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

// The "rows" kernels take the row when every access is a whole aligned
// 16-byte vector and a lane needs at most kMaxVectors of them.
template <typename T>
bool fits_rows(int64_t d, int64_t ld, int64_t ldw, const void* a, const void* b,
               const void* w) {
  constexpr int VEC = kVec16<T>;
  return d % VEC == 0 && ld % VEC == 0 && ldw % 4 == 0 && d / VEC <= 32 * kMaxVectors &&
         aligned16(a) &&
         aligned16(b) && aligned16(w);
}

// threads a row: the vectors' count rounded up to a power of two, at most 32
int lanes_for(int64_t vectors) {
  int lanes = 1;
  while (lanes < 32 && lanes < vectors) lanes <<= 1;
  return lanes;
}

// SMs of the current device, cached per device
int sm_count() {
  static std::atomic<int> cache[64];
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev >= 64) return -1;
  int sms = cache[dev].load(std::memory_order_relaxed);
  if (sms > 0) return sms;
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    return -1;
  cache[dev].store(sms, std::memory_order_relaxed);
  return sms;
}

#define RN_CASES(X) X(1) X(2) X(3) X(4) X(5) X(6) X(7) X(8)

template <typename T>
cudaError_t forward(const T* x, int64_t ldx, const float* w, int64_t ldw, int64_t w_rows, T* y,
                    float* rstd, int64_t rows, int d, float eps, cudaStream_t s) {
  const float inv_d = 1.f / (float)d;
  if (fits_rows<T>(d, ldx, ldw, x, y, w)) {
    const int sms = sm_count();
    if (sms < 1) return cudaErrorInvalidDevice;
    const int64_t vectors = d / kVec16<T>;
    const int lanes = lanes_for(vectors);
    const int nv = (int)((vectors + lanes - 1) / lanes);
    // rows a group of lanes walks: the fewest that keep the grid near
    // kFwdBlocksPerSm blocks an SM, at most kMaxRowsPerSub
    const int64_t subs = kRowThreads / lanes;
    int64_t rps = rows / (subs * kFwdBlocksPerSm * sms);
    rps = rps < 1 ? 1 : rps > kMaxRowsPerSub ? kMaxRowsPerSub : rps;
    const int64_t per_block = subs * rps;
    const dim3 grid((unsigned)((rows + per_block - 1) / per_block));
    switch (nv) {
#define RN_FWD(N)                                                                     \
  case N:                                                                             \
    rms_fwd_rows<T, N><<<grid, kRowThreads, 0, s>>>(x, ldx, w, ldw, w_rows, y, rstd, rows, \
                                                    d, inv_d, lanes, (int)rps, eps);  \
    break;
      RN_CASES(RN_FWD)
#undef RN_FWD
      default:
        return cudaErrorInvalidValue;
    }
  } else if (d % kVec16<T> == 0 && ldx % kVec16<T> == 0 && ldw % 4 == 0 &&
             aligned16(x) && aligned16(y) && aligned16(w)) {
    rms_fwd_block<T, kVec16<T>><<<(unsigned)rows, kBlockThreads, 0, s>>>(
        x, ldx, w, ldw, w_rows, y, rstd, d, inv_d, eps);
  } else {
    rms_fwd_block<T, 1><<<(unsigned)rows, kBlockThreads, 0, s>>>(x, ldx, w, ldw, w_rows, y,
                                                                 rstd, d, inv_d, eps);
  }
  return cudaGetLastError();
}

// Tiles a dw group is cut into: about kTilesPerSm blocks an SM over all
// groups, each tile holding a whole number of rows.
void plan_tiles(int64_t rows, int64_t dw_rows, int sms, int64_t* tiles,
                int64_t* tile_rows) {
  const int64_t groups = rows / dw_rows;
  int64_t want = ((int64_t)kTilesPerSm * sms + groups - 1) / groups;
  if (want > dw_rows) want = dw_rows;
  if (want < 1) want = 1;
  *tile_rows = (dw_rows + want - 1) / want;
  *tiles = (dw_rows + *tile_rows - 1) / *tile_rows;
}

template <typename T>
cudaError_t backward(const T* x, int64_t ldx, const float* w, int64_t ldw, int64_t w_rows,
                     const float* rstd, const T* dy, int64_t lddy, T* dx, float* dw,
                     float* work, int64_t rows, int d, int64_t dw_rows, cudaStream_t s) {
  const float inv_d = 1.f / (float)d;
  const int sms = sm_count();
  if (sms < 1) return cudaErrorInvalidDevice;
  int64_t tiles = 0, tile_rows = 0;
  plan_tiles(rows, dw_rows, sms, &tiles, &tile_rows);
  const int64_t groups = rows / dw_rows;
  const dim3 grid((unsigned)(groups * tiles));
  constexpr int VEC = kVec16<T>;
  if (fits_rows<T>(d, ldx, ldw, x, dx, w) && lddy % VEC == 0 && aligned16(dy)) {
    const int64_t vectors = d / VEC;
    const int lanes = lanes_for(vectors);
    const int nv = (int)((vectors + lanes - 1) / lanes);
    switch (nv) {
#define RN_BWD(N)                                                                    \
  case N:                                                                            \
    rms_bwd_rows<T, N><<<grid, kRowThreads, 0, s>>>(x, ldx, w, ldw, w_rows, rstd, dy,     \
                                                    lddy, dx, work, d, inv_d, lanes, \
                                                    dw_rows, tiles, tile_rows);      \
    break;
      RN_CASES(RN_BWD)
#undef RN_BWD
      default:
        return cudaErrorInvalidValue;
    }
  } else {
    const size_t smem = sizeof(float) * (size_t)d;
    const bool vec = d % VEC == 0 && ldx % VEC == 0 && lddy % VEC == 0 && ldw % 4 == 0 &&
                     aligned16(x) && aligned16(dy) && aligned16(dx) && aligned16(w);
    auto kernel = vec ? rms_bwd_block<T, VEC> : rms_bwd_block<T, 1>;
    cudaError_t err = cudaSuccess;
    if (smem > 48 * 1024)
      err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 (int)smem);
    if (err != cudaSuccess) return err;
    kernel<<<grid, kBlockThreads, smem, s>>>(x, ldx, w, ldw, w_rows, rstd, dy, lddy, dx, work,
                                             d, inv_d, dw_rows, tiles, tile_rows);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  rms_dw_sum<<<dim3((unsigned)((d + kSumThreads - 1) / kSumThreads), (unsigned)groups),
               kSumThreads, 0, s>>>(work, dw, d, tiles);
  return cudaGetLastError();
}

// shapes the kernels take (the Python wrapper checks first): rows and d
// positive, d at most kMaxD (the backward's block kernels keep d floats in
// shared memory), whole groups of rows, at most kMaxGroups dw groups
constexpr int64_t kMaxD = 32768;
constexpr int64_t kMaxGroups = 65535;  // dw groups: the second stage's grid.y

bool shape_ok(int64_t rows, int64_t d, int64_t ld, int64_t group_rows) {
  return rows >= 1 && rows <= 0x7fffffff && d >= 1 && d <= kMaxD && ld >= d &&
         group_rows >= 1 && rows % group_rows == 0;
}

}  // namespace

extern "C" {

const char* rn_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// x (rows, d) with row stride ldx (elements), bf16 when x_bf16 else f32; w
// (rows / w_rows, d) f32 with row stride ldw (0: one row for every group);
// y (rows, d) contiguous in x's dtype; rstd (rows) f32.
int rn_forward(const void* x, int64_t ldx, const float* w, int64_t ldw, int64_t w_rows,
               void* y, float* rstd, int64_t rows, int64_t d, int x_bf16, float eps,
               void* stream) {
  if (!shape_ok(rows, d, ldx, w_rows) || ldw < 0) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_bf16)
    return (int)forward(static_cast<const bf16*>(x), ldx, w, ldw, w_rows,
                        static_cast<bf16*>(y), rstd, rows, (int)d, eps, s);
  return (int)forward(static_cast<const float*>(x), ldx, w, ldw, w_rows,
                      static_cast<float*>(y), rstd, rows, (int)d, eps, s);
}

// Floats of the backward's partials for these shapes on the current device
// (negative: a CUDA error).
int64_t rn_backward_workspace(int64_t rows, int64_t d, int64_t dw_rows) {
  if (!shape_ok(rows, d, d, dw_rows)) return -(int64_t)cudaErrorInvalidValue;
  const int sms = sm_count();
  if (sms < 1) return -(int64_t)cudaErrorInvalidDevice;
  int64_t tiles = 0, tile_rows = 0;
  plan_tiles(rows, dw_rows, sms, &tiles, &tile_rows);
  return rows / dw_rows * tiles * d;
}

// The forward's x, w, ldw, w_rows and rstd; dy (rows, d) with row stride lddy in
// x's dtype; dx (rows, d) contiguous in x's dtype; dw (rows / dw_rows, d) f32,
// where each dw group lies inside one w group; work: rn_backward_workspace
// floats.
int rn_backward(const void* x, int64_t ldx, const float* w, int64_t ldw, int64_t w_rows,
                const float* rstd, const void* dy, int64_t lddy, void* dx, float* dw,
                float* work, int64_t rows, int64_t d, int64_t dw_rows, int x_bf16,
                void* stream) {
  if (!shape_ok(rows, d, ldx, w_rows) || !shape_ok(rows, d, lddy, dw_rows) || ldw < 0 ||
      w_rows % dw_rows || rows / dw_rows > kMaxGroups)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_bf16)
    return (int)backward(static_cast<const bf16*>(x), ldx, w, ldw, w_rows, rstd,
                         static_cast<const bf16*>(dy), lddy, static_cast<bf16*>(dx), dw,
                         work, rows, (int)d, dw_rows, s);
  return (int)backward(static_cast<const float*>(x), ldx, w, ldw, w_rows, rstd,
                       static_cast<const float*>(dy), lddy, static_cast<float*>(dx), dw,
                       work, rows, (int)d, dw_rows, s);
}

}  // extern "C"
