// Warp-level tensor-core building blocks for sm_90a, shared by the
// tensor-core kernels (conv3d_fused.cu, vit_attention.cu, conv3d.cu).
//
// - cp.async 16-byte copies global -> shared, zero-filled when the source is
//   off the tensor (src-size 0), with commit and wait;
// - ldmatrix .x4 and .x4.trans (four 8x8 b16 matrices; lanes 8i .. 8i + 7
//   give the row addresses of matrix i);
// - mma.sync m16n8k16, bf16 inputs, float32 accumulators;
// - mma.sync m16n8k8, tf32 inputs, float32 accumulators, and the float32 ->
//   tf32 rounding and split (a float32 is its tf32 "high" part plus a tf32
//   remainder: three tf32 products, lo*hi + hi*lo + hi*hi, keep about
//   float32 accuracy: 3xTF32);
// - packing two floats into a bf16x2 register.
//
// Fragment layouts of m16n8k16 (g = lane / 4, t = lane % 4):
//   A 16x16 row-major, a[0]: (g, 2t..2t+1), a[1]: (g+8, 2t..), a[2]: (g, 8+2t..),
//     a[3]: (g+8, 8+2t..);
//   B 16x8 (k x n), b[0]: (k 2t..2t+1, n g), b[1]: (k 8+2t.., n g);
//   C 16x8, c[0..1]: (g, 2t..2t+1), c[2..3]: (g+8, 2t..2t+1).
// m16n8k8 tf32: A 16x8, a[0]: (g, t), a[1]: (g+8, t), a[2]: (g, t+4),
//   a[3]: (g+8, t+4); B 8x8 (k x n), b[0]: (k t, n g), b[1]: (k t+4, n g);
//   C as above.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace mma {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from `src` into shared memory at `dst`; zeros when !pred (src is
// then not read, but must still be a valid address).
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool pred) {
  const int n = pred ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(n));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Wait until at most N committed groups of this thread are still in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// d += a * b, m16n8k16, bf16 x bf16 -> float32
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// x rounded to tf32 (nearest, ties away), as the 32-bit pattern mma takes
__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// x (as bits) rounded to tf32 like to_tf32, in two integer instructions:
// half a tf32 unit added to the magnitude's bits, the 13 low bits cleared.
// The same value as cvt.rna for every x but NaN (cvt, which keeps NaN a
// NaN, takes about four instructions).
__device__ __forceinline__ uint32_t tf32_bits(uint32_t x) { return (x + 0x1000u) & 0xffffe000u; }

// x split into its tf32 high part and tf32 remainder: x = hi + lo to about
// 2^-22 of |x|.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_bits(__float_as_uint(x));
  lo = tf32_bits(__float_as_uint(x - __uint_as_float(hi)));
}

// Four float32 fragment elements (as bits) split likewise.
__device__ __forceinline__ void split_tf32(const uint32_t (&x)[4], uint32_t (&hi)[4],
                                           uint32_t (&lo)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) split_tf32(__uint_as_float(x[i]), hi[i], lo[i]);
}

// d += a * b, m16n8k8, tf32 x tf32 -> float32
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two floats rounded to bf16, `lo` in the low half (the lower address).
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

}  // namespace mma
