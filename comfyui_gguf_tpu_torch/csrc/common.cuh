// Shared device helpers for the port's hand-written Hopper kernels.
//
// The kernels use the warp-level tensor-core path (ldmatrix + mma.sync):
// m16n8k16 for bf16 with an f32 accumulator, m16n8k32 for s8 with an
// exact s32 accumulator. The asynchronous warpgroup path (wgmma + TMA) is
// left for the performance work that follows the bring-up.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace gguf_cuda {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Four 8x8 b16 matrices; lane l supplies the row address of matrix l/8.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// d += a(16x16 bf16, row) * b(16x8 bf16, col), f32 accumulate.
__device__ __forceinline__ void mma_bf16_16816(float (&d)[4],
                                               const uint32_t (&a)[4],
                                               uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a(16x32 s8, row) * b(32x8 s8, col), exact s32 accumulate.
__device__ __forceinline__ void mma_s8_16832(int (&d)[4],
                                             const uint32_t (&a)[4],
                                             uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 16-byte global->shared copy; src_bytes = 0 fills the destination with 0.
__device__ __forceinline__ void cp_async_16(void* smem, const void* gmem,
                                            int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_u32(smem)), "l"(gmem), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

// tanh-approximate GELU, the formula of the reference kernel epilogue
// (comfyui_gguf_tpu/ops/qmatmul.py _gelu_tanh). Written with
// non-contracting intrinsics in the plain version's order of operations:
// for negative x, 1 + tanh(.) cancels, and an FMA-fused argument would
// move small results by many ulps.
__device__ __forceinline__ float gelu_tanh(float x) {
  const float c = 0.7978845608028654f;  // sqrt(2/pi)
  const float x3 = __fmul_rn(__fmul_rn(__fmul_rn(0.044715f, x), x), x);
  const float t = tanhf(__fmul_rn(c, __fadd_rn(x, x3)));
  return __fmul_rn(__fmul_rn(0.5f, x), __fadd_rn(1.0f, t));
}

// The shared epilogue on two adjacent f32 accumulator columns (n, n+1) of
// row m: + bias, then GELU-tanh on columns >= act_from (act_from < 0: none),
// then a bf16 store into the (M, R) row-major output.
__device__ __forceinline__ void epilogue_store2(
    __nv_bfloat16* __restrict__ out, const float* __restrict__ bias,
    int act_from, int M, int R, int m, int n, float v0, float v1) {
  if (m >= M || n >= R) return;
  const bool has1 = n + 1 < R;
  if (bias != nullptr) {
    v0 = __fadd_rn(v0, bias[n]);
    if (has1) v1 = __fadd_rn(v1, bias[n + 1]);
  }
  if (act_from >= 0) {
    if (n >= act_from) v0 = gelu_tanh(v0);
    if (n + 1 >= act_from) v1 = gelu_tanh(v1);
  }
  __nv_bfloat16* p = out + static_cast<size_t>(m) * R + n;
  if (has1 && (R % 2 == 0)) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v0, v1);
  } else {
    p[0] = __float2bfloat16(v0);
    if (has1) p[1] = __float2bfloat16(v1);
  }
}

}  // namespace gguf_cuda
