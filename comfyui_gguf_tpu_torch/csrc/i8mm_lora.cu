// K4 with the LoRA rank term: the w8a8 matmul of i8mm.cu whose epilogue adds
// h @ upᵀ on the f32 accumulator after the rescale and before the bias and
// GELU, as the reference's Pallas kernel does (_make_i8_kernel's lh/lu
// operands, comfyui_gguf_tpu/ops/i8mm.py:81, through the shared _epilogue
// of ops/qmatmul.py:78).
//
//   out[m, r] = epi( float(acc) * xs[m] * ws[r] + sum_j h[m, j] * up[r, j] )
//
// h (M, rk) is the rank intermediate x @ downᵀ (computed outside, as the
// reference computes it outside Pallas), up (Rp, rk) the scale-folded up
// factor, both bf16, rank contiguous, rk a multiple of 16 (the wrapper
// zero-pads Σr; padded columns add exact zeros). The design is the LORA
// instance of gemm_wgmma.cuh: the rank chunks stream through the TMA ring as
// ceil(rk / 64) more stages of each tile and run as bf16 wgmma onto the
// rescaled f32 fragment. What bounds it is the base product's int8
// tensor-core work; the rank term adds 2·M·R·rk bf16 operations (under 1%
// at r = 16 and the flux shapes) and reads h and up once a tile. A separate
// source so that it compiles beside i8mm.cu.
#include "gemm_wgmma.cuh"

using namespace gguf_cuda;

template <int BN>
static cudaError_t i8mm_lora_bn(const void* xq, const void* xs,
                                const void* wq, const void* ws,
                                const void* bias, void* out, const void* h,
                                const void* up, int M, int K, int Kp, int R,
                                int Rp, int ldo, int rk, int act_from,
                                cudaStream_t stream) {
  CUtensorMap tm_x, tm_w, tm_o, tm_h, tm_up;
  bool ok = make_map(&tm_x, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, xq, M, K,
                     GM_BM, GM_BK, CU_TENSOR_MAP_SWIZZLE_128B);
  ok = ok && make_map(&tm_w, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, wq, Rp, Kp,
                      BN, GM_BK, CU_TENSOR_MAP_SWIZZLE_128B);
  ok = ok && make_out_map(&tm_o, out, M, ldo);
  ok = ok && make_lora_maps(&tm_h, &tm_up, h, up, M, Rp, rk, BN);
  if (!ok) return cudaErrorInvalidValue;
  return launch_gemm<false, BN, true>(tm_x, tm_w, tm_o, xs, 1, ws, bias, M,
                                      R, (K + GM_BK - 1) / GM_BK, act_from,
                                      stream, tm_h, tm_up, rk);
}

// Plain C entry (bound with ctypes); as i8mm_launch (i8mm.cu) plus h (M, rk)
// and up (Rp, rk) bf16, 16-byte aligned and contiguous, rk > 0 a multiple
// of 16 (checked by the Python wrapper). Returns cudaGetLastError().
extern "C" int i8mm_lora_launch(const void* xq, const void* xs,
                                const void* wq, const void* ws,
                                const void* bias, void* out, const void* h,
                                const void* up, int M, int K, int Kp, int R,
                                int Rp, int ldo, int rk, int act_from,
                                int bn, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bn == 256)
    return static_cast<int>(i8mm_lora_bn<256>(xq, xs, wq, ws, bias, out, h,
                                              up, M, K, Kp, R, Rp, ldo, rk,
                                              act_from, s));
  if (bn == 128)
    return static_cast<int>(i8mm_lora_bn<128>(xq, xs, wq, ws, bias, out, h,
                                              up, M, K, Kp, R, Rp, ldo, rk,
                                              act_from, s));
  return static_cast<int>(cudaErrorInvalidValue);
}
