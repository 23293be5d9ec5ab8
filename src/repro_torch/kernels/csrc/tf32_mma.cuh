// Tensor-core helpers shared by ps_matmul.cu and lamp_attention.cu: cp.async
// staging, the tf32 split of an FP32 value into hi + lo, and the mma.sync
// m16n8k8 tf32 product with its ldmatrix A-fragment load.
//
// 3xTF32: a product a b of FP32 values is taken as a_lo b_hi + a_hi b_lo +
// a_hi b_hi on the tensor cores, where hi = tf32(x) and lo = tf32(x - hi);
// the dropped a_lo b_lo term is about 2^-22 relative, so the sum is an FP32
// sum taken in the MMA's order. A single tf32 pass keeps about 10 mantissa
// bits.

#pragma once

#include <cuda_runtime.h>
#include <float.h>
#include <math.h>
#include <stdint.h>

namespace tf32_mma {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// Copy 16 bytes (4 bytes), or with ok false zero-fill them in shared memory.
__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(ok ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(ok ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// tf32(x): x rounded to 10 mantissa bits, to nearest, ties away from zero:
// the bits of cvt.rna.tf32.f32 for every finite x (lamp_tf32_split checks
// it), in two integer operations, which issue faster than the conversion.
// Half of the 13 dropped bits' unit is added to the magnitude and the
// dropped bits are cleared, a carry running into the exponent.
__device__ __forceinline__ uint32_t tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

__device__ __forceinline__ uint32_t tf32_cvt(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// x = hi + lo, both tf32; x - hi is exact in FP32 for a finite x. Where
// x - hi is not finite, x is a NaN or an Inf (or hi rounded up past
// FLT_MAX) and bad is set: tf32 wraps a NaN of a high payload, such as the
// GPU's 0x7fffffff, into a zero, and the cross products can make an Inf a
// NaN (lo(1) . Inf = 0 . Inf).
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo, bool& bad) {
  hi = tf32(x);
  const float d = __fsub_rn(x, __uint_as_float(hi));
  bad |= !(fabsf(d) <= FLT_MAX);
  lo = tf32(d);
}

// The split of a value whose partners in the product are finite (the
// attention's probabilities and V): where x - hi is not finite, hi keeps
// x's bits (a NaN or an Inf stays one in tf32), lo is 0, and hx -- the hi
// that multiplies a partner's lo -- is 0. The three products with a finite
// partner a then sum to a_hi x, a NaN or an Inf of the class FP32's a x
// gives wherever a_hi is 0 only if a is. That fails for a subnormal a: tf32
// rounds |a| below 2^-136 to 0, so 0 x is a NaN where FP32 gives an Inf.
// The caller keeps a subnormal partner away from a zero a_hi (the
// attention writes a subnormal p as FLT_MIN).
__device__ __forceinline__ void split_keep(float x, uint32_t& hi, uint32_t& lo,
                                           uint32_t& hx) {
  const uint32_t h = tf32(x);
  const float d = __fsub_rn(x, __uint_as_float(h));
  const bool fin = fabsf(d) <= FLT_MAX;
  hi = fin ? h : __float_as_uint(x);
  lo = fin ? tf32(d) : 0u;
  hx = fin ? h : 0u;
}

// d += a (16 x 8, row) @ b (8 x 8, col), tf32 in, f32 accumulate.
__device__ __forceinline__ void mma_tf32(float* d, const uint32_t* a, const uint32_t* b) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// The four 8 x 8 b16 matrices of ldmatrix.x4 over FP32 data are four 8 x 4
// FP32 blocks, and lane l receives word l % 4 of row l / 4 of each: with
// lane l pointing at row l % 8 (+ 8 for blocks 1 and 3) and column 4 (l / 16)
// (blocks 2 and 3), that is the m16n8k8 tf32 A fragment, one instruction
// for four loads.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const float* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

}  // namespace tf32_mma
