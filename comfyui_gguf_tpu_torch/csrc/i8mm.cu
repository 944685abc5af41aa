// K4: w8a8 matmul — s8 activations x s8 weights, exact s32 accumulation.
//
// Replaces the Pallas kernel of comfyui_gguf_tpu/ops/i8mm.py
// (_make_i8_kernel, launched by pallas_i8mm and, on a depth-stacked weight,
// by pallas_i8mm_indexed; the stacked case is this kernel launched on block
// i's view).
//
//   acc[m, r] = sum_k xq[m, k] * wq[r, k]              (exact, s32)
//   out[m, r] = epi( float(acc) * xs[m] * ws[r] )
//
// What bounds it: int8 tensor-core operations at the flux token shapes
// (M = 512..4608, K = 3072..15360). Design: the persistent TMA + wgmma GEMM
// of gemm_wgmma.cuh (shared with the GEMM probes) at its s8 instances,
// output tiles of 128 tokens x BN out-features (BN = 256, or 128 where that
// leaves a shorter last wave; ops/qmatmul.py i8mm_plan). The weight is
// stored out-feature-major (quant/i8.py), the K-major form that s8 wgmma
// takes. Ragged M and K < Kp are zero-filled by TMA (x's tensor map has the
// extents (M, K)); the f32 rescale in the plain version's order and the
// shared epilogue (bias, GELU-tanh from a column) run on the accumulator
// and leave by TMA store.
#include "gemm_wgmma.cuh"

using namespace gguf_cuda;

template <int BN>
static cudaError_t i8mm_launch_bn(const void* xq, const void* xs,
                                  const void* wq, const void* ws,
                                  const void* bias, void* out, int M, int K,
                                  int Kp, int R, int Rp, int ldo,
                                  int act_from, cudaStream_t stream) {
  CUtensorMap tm_x, tm_w, tm_o;
  bool ok = make_map(&tm_x, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, xq, M, K,
                     GM_BM, GM_BK, CU_TENSOR_MAP_SWIZZLE_128B);
  ok = ok && make_map(&tm_w, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, wq, Rp, Kp,
                      BN, GM_BK, CU_TENSOR_MAP_SWIZZLE_128B);
  ok = ok && make_out_map(&tm_o, out, M, ldo);
  if (!ok) return cudaErrorInvalidValue;
  return launch_gemm<false, BN>(tm_x, tm_w, tm_o, xs, 1, ws, bias, M, R,
                                (K + GM_BK - 1) / GM_BK, act_from, stream);
}

// Dynamic shared memory of a launch at tile width bn (0 for another bn).
extern "C" int i8mm_smem_bytes(int bn) {
  return bn == 256   ? GemmShape<256>::SMEM
         : bn == 128 ? GemmShape<128>::SMEM
                     : 0;
}

// Plain C entry (bound with ctypes). Shapes are checked by the Python
// wrapper: wq (Rp, Kp) with Kp % 128 == 0, Rp % 128 == 0, R <= Rp, K <= Kp,
// K % 16 == 0 and the output's row stride ldo >= R a multiple of 8 (TMA's
// 16-byte row strides), bn 128 or 256, every pointer 16-byte aligned.
// Returns cudaGetLastError().
extern "C" int i8mm_launch(const void* xq, const void* xs, const void* wq,
                           const void* ws, const void* bias, void* out, int M,
                           int K, int Kp, int R, int Rp, int ldo,
                           int act_from, int bn, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bn == 256)
    return static_cast<int>(i8mm_launch_bn<256>(
        xq, xs, wq, ws, bias, out, M, K, Kp, R, Rp, ldo, act_from, s));
  if (bn == 128)
    return static_cast<int>(i8mm_launch_bn<128>(
        xq, xs, wq, ws, bias, out, M, K, Kp, R, Rp, ldo, act_from, s));
  return static_cast<int>(cudaErrorInvalidValue);
}
