// Hopper (sm_90a) building blocks in inline PTX: shared-memory addresses,
// mbarriers, TMA tile loads and warpgroup matrix multiplies (wgmma) on bf16
// operands with f32 accumulators; the tensor maps TMA reads (host side),
// and the 64-row tile products both K5 kernels are built from. Used by
// csrc/flash_attn.cu (K5's forward) and csrc/flash_attn_bwd.cu (its
// backward).
//
// wgmma operands in shared memory are described by a 64-bit matrix
// descriptor: start address >> 4 (bits 0-13), leading byte offset >> 4
// (16-29), stride byte offset >> 4 (32-45), swizzle mode (62-63: 1 = 128-byte,
// 2 = 64-byte). For a K-major operand in a swizzled layout the stride byte
// offset is the distance between groups of 8 rows (8 x the row's bytes) and
// the leading byte offset is unused; for an MN-major operand the stride byte
// offset is the distance between groups of 8 rows along K and the leading
// byte offset the distance between successive swizzle-wide column panels
// along MN. Tiles are laid out as TMA writes them with the matching swizzle,
// each panel aligned to 1024 bytes, so no base offset is needed.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace hopper {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---- mbarriers -------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(count)
               : "memory");
}

// Makes the barriers' initialisation visible to the async proxy (TMA).
__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar))
               : "memory");
}

// One arrival that also announces `bytes` of TMA traffic to wait for.
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// Wait until the barrier's phase with the given parity has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_addr(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

// ---- registers ---------------------------------------------------------------

// Moves a warpgroup's per-thread register budget down or up (every warp of
// the warpgroup executes it): a producer warpgroup gives registers up to
// its consumers.
template <uint32_t N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <uint32_t N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

// ---- TMA -------------------------------------------------------------------

// Copy one box of a 3-d tensor map at coordinates (c0, c1, c2), innermost
// first, into shared memory; completion is counted on `bar` in bytes.
// Elements outside the tensor arrive as zeros.
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0), "r"(c1),
      "r"(c2)
      : "memory");
}

// ---- wgmma -----------------------------------------------------------------

__device__ __forceinline__ uint64_t gmma_desc(uint32_t addr, uint32_t lbo_bytes,
                                              uint32_t sbo_bytes, uint32_t swizzle) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo_bytes >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo_bytes >> 4) & 0x3FFF) << 32) | ((uint64_t)swizzle << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving reads or writes of registers that an
// asynchronous wgmma owns across the wait that ends it.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// D (64 x 64, f32) (+)= A (64 x 16, shared, K-major) * B (16 x 64, shared,
// K-major); scale_d = 0 overwrites D.
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t desc_a,
                                         uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// D (64 x 32, f32) += A (64 x 16, bf16 registers) * B (16 x 32, shared,
// MN-major: the transpose bit set); scale_d = 0 overwrites D.
__device__ __forceinline__ void wgmma_rs(float (&d)[16], uint32_t a0, uint32_t a1,
                                         uint32_t a2, uint32_t a3, uint64_t desc_b,
                                         int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(desc_b), "r"(scale_d));
}

// D (64 x 64, f32) += A (64 x 16, bf16 registers) * B (16 x 64, shared,
// MN-major: the transpose bit set); scale_d = 0 overwrites D.
__device__ __forceinline__ void wgmma_rs(float (&d)[32], uint32_t a0, uint32_t a1,
                                         uint32_t a2, uint32_t a3, uint64_t desc_b,
                                         int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(desc_b), "r"(scale_d));
}

// D (64 x 128, f32) += A (64 x 16, bf16 registers) * B (16 x 128, shared,
// MN-major: the transpose bit set); scale_d = 0 overwrites D.
__device__ __forceinline__ void wgmma_rs(float (&d)[64], uint32_t a0, uint32_t a1,
                                         uint32_t a2, uint32_t a3, uint64_t desc_b,
                                         int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(desc_b), "r"(scale_d));
}

// ---- 64-row bf16 tiles of a head dim D ----------------------------------

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// A 64 x D bf16 tile in shared memory as TMA writes it: D split in panels
// of kCols columns, each panel 64 rows of kRowBytes, swizzled: 128-byte
// rows of 64 bf16 (D = 64; D = 128 and 256 as two and four panels),
// 64-byte rows of 32 (D = 32; D = 160 as five panels).
template <int D>
struct Panels {
  static constexpr int kCols = D % 64 == 0 ? 64 : 32;
  static constexpr int kCount = D / kCols;
  static constexpr int kRowBytes = kCols * 2;
  static constexpr uint32_t kSwizzle = kRowBytes == 128 ? 1 : 2;  // descriptor
  static constexpr int kBytes = 64 * D * 2;  // the whole tile
  static_assert(D % kCols == 0, "D must be whole panels");
};

// acc (64 x 64, f32) = A B^T for two 64 x D tiles, both read K-major (rows
// along D), over D in steps of 16: Q K^T, dO V^T and their transposes.
template <int D>
__device__ __forceinline__ void mma_ss(float (&acc)[32], uint32_t a_addr,
                                       uint32_t b_addr) {
  using P = Panels<D>;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t col = (kk * 16 % P::kCols) * 2;
    const uint32_t panel = kk * 16 / P::kCols;
    wgmma_ss(acc,
             gmma_desc(a_addr + panel * 64 * P::kRowBytes + col, 16, 8 * P::kRowBytes,
                       P::kSwizzle),
             gmma_desc(b_addr + panel * 64 * P::kRowBytes + col, 16, 8 * P::kRowBytes,
                       P::kSwizzle),
             kk > 0);
  }
}

// acc (64 x D, f32) += A_kk B_kk: the kk-th 16-row step of A (64 x 64, bf16
// in wgmma's A registers, a[0..3]) times a 64 x D tile read MN-major (the
// transpose bit): P V, dS K, P^T dO, dS^T Q. Up to D = 128 one wgmma spans
// D (its leading byte offset steps between panels); above, one wgmma per
// panel, each on its slice of the accumulator: the fragment of an n-wide
// product is the fragments of its panels side by side.
template <int D>
__device__ __forceinline__ void mma_rs_k16(float (&acc)[D / 2], const uint32_t* a,
                                           uint32_t b_addr, int kk) {
  using P = Panels<D>;
  if constexpr (D <= 128) {
    wgmma_rs(acc, a[0], a[1], a[2], a[3],
             gmma_desc(b_addr + kk * 16 * P::kRowBytes, 64 * P::kRowBytes,
                       8 * P::kRowBytes, P::kSwizzle),
             1);
  } else {
#pragma unroll
    for (int p = 0; p < P::kCount; ++p) {
      float(&part)[P::kCols / 2] =
          *reinterpret_cast<float(*)[P::kCols / 2]>(&acc[p * P::kCols / 2]);
      wgmma_rs(part, a[0], a[1], a[2], a[3],
               gmma_desc(b_addr + (p * 64 + kk * 16) * P::kRowBytes,
                         64 * P::kRowBytes, 8 * P::kRowBytes, P::kSwizzle),
               1);
    }
  }
}

// ---- elementwise -----------------------------------------------------------

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// -inf: a masked score, whose exp2 is p = 0
__device__ __forceinline__ float neg_inf() { return __int_as_float(0xff800000); }

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// the two bf16 of a packed pair, as f32
__device__ __forceinline__ float bf16_lo(uint32_t v) { return __uint_as_float(v << 16); }
__device__ __forceinline__ float bf16_hi(uint32_t v) {
  return __uint_as_float(v & 0xffff0000u);
}

// Calls f(std::integral_constant<int, D>) for D = dim in {32, 64, 128, 160,
// 256}, K5's head dims; cudaErrorInvalidValue for another.
template <typename F>
cudaError_t by_dim(int64_t dim, F f) {
  switch (dim) {
    case 32:
      return f(std::integral_constant<int, 32>{});
    case 64:
      return f(std::integral_constant<int, 64>{});
    case 128:
      return f(std::integral_constant<int, 128>{});
    case 160:
      return f(std::integral_constant<int, 160>{});
    case 256:
      return f(std::integral_constant<int, 256>{});
    default:
      return cudaErrorInvalidValue;
  }
}

// ---- tensor maps (host) ----------------------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up through the CUDA runtime, so a library
// needs no -lcuda.
inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                                    cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// Tensor map over a contiguous (batch, seq, cols) bf16 array; boxes of
// (panel_cols, rows, 1) with the swizzle the wgmma descriptors expect.
// Rows past seq arrive as zeros.
inline bool tensor_map(CUtensorMap* map, const void* ptr, int64_t batch, int64_t seq,
                       int64_t cols, int panel_cols, int rows) {
  const EncodeTiled encode = encode_tiled();
  if (!encode) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)cols, (cuuint64_t)seq, (cuuint64_t)batch};
  const cuuint64_t strides[2] = {(cuuint64_t)cols * 2, (cuuint64_t)(cols * seq) * 2};
  const cuuint32_t box[3] = {(cuuint32_t)panel_cols, (cuuint32_t)rows, 1};
  const cuuint32_t step[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr), dims,
                strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
                panel_cols * 2 == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                                      : CU_TENSOR_MAP_SWIZZLE_64B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace hopper
