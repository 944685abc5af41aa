// What the bodies of the fused dequant-matmul (qmm.cu, qmm_int8.cu: the
// wgmma body per layout; qmm_smallm.cu: the split-K body; qmm_simt.cu: the
// f32 body) share: how a code becomes a weight in the operand type.
#pragma once

#include "common.cuh"

namespace gguf_cuda {

constexpr float MAGIC = 8388608.0f;  // 2^23: 0x4B000000 | n is 2^23 + n

// One dequantized weight from its magic-number float f = 2^23 + code.
// FOLD (nibble codes with offsets, zero point 0): fma(s, f, -s * 2^23) is
// the exactly rounded s * code, because s * 2^23 is exact. Otherwise the
// code is recovered exactly by the subtraction first.
template <bool FOLD, bool HAS_OFF>
__device__ __forceinline__ float dequant1(float f, float s, float o,
                                          float cs, float neg_base) {
  float v;
  if constexpr (FOLD) {
    v = __fmaf_rn(s, f, cs);
  } else {
    v = __fmul_rn(s, __fadd_rn(f, neg_base));
  }
  if constexpr (HAS_OFF) v = __fadd_rn(v, o);
  return v;
}

__device__ __forceinline__ float magic_of_byte(uint32_t word, int b) {
  // byte b of word -> the low byte of 0x4B0000xx
  return __uint_as_float(__byte_perm(word, 0x4B000000u, 0x7650u | b));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&p);
}

// Two weights as one operand register of the body's operand type: bf16,
// or f16 for the f16 instances (dequant_dtype float16).
template <bool F16>
__device__ __forceinline__ uint32_t pack_op(float lo, float hi) {
  if constexpr (F16) {
    return pack_f16x2(lo, hi);
  } else {
    return pack_bf16(lo, hi);
  }
}

}  // namespace gguf_cuda
