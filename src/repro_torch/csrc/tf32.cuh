// The 3xTF32 building blocks shared by the FastEGNN kernels (through
// common.cuh) and the f32 attention kernel (swa_attention.cu): the operand
// split and one tensor-core MMA; and the bf16 operand rounding of the
// FastEGNN kernels' bf16 mode.  Header only, inside an anonymous
// namespace, so each including file gets its own copy.
#pragma once
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// a = hi + lo, both TF32 values: hi is a rounded to the nearest TF32 value
// (half an ulp added to the bits, ties away from zero, the 13 low bits
// cleared) and lo the rest a - hi (exact) cut to TF32 by the mask.  The rest
// has either sign, so cutting it biases no product.  Where a is NaN, a - hi
// is NaN and the mask keeps it, so the products stay NaN (hi alone may not
// be: the add carries the card's NaN, 0x7fffffff, into -0); where a is
// infinite, a - hi is NaN.
__device__ __forceinline__ void split_tf32(float a, uint32_t& hi,
                                           uint32_t& lo) {
  hi = (__float_as_uint(a) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(a - __uint_as_float(hi)) & 0xffffe000u;
}

// a rounded to the nearest bfloat16 value, ties to even, held in f32 (its
// 16 low bits zero): the cast of the reference's bf16 mode.  cvt.rn.bf16
// keeps NaN a NaN and infinities infinite; a bf16 value is a TF32 value,
// and the product of two is exact in f32.
__device__ __forceinline__ float bf16_round(float a) {
  return __bfloat162float(__float2bfloat16_rn(a));
}

// bf16_round in the bf16 mode (BF), the identity in f32
template <bool BF>
__device__ __forceinline__ float rnd(float a) {
  return BF ? bf16_round(a) : a;
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

}  // namespace
