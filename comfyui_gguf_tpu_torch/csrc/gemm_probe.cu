// K8: GEMM rate probes — plain matmuls that measure what the tensor cores
// reach on this card through the path the model's kernels take, without
// quantization epilogues.
//
// Replaces the Pallas probe kernels of tools_i8_microbench.py:
//   make_plain (K8a):  out = bf16( x @ w ),  bf16 x bf16 -> f32  or
//                                            s8 x s8 -> s32, no scales
//   make_w8a8  (K8b):  out = bf16( float(x @ w) * xs[m] * ws[r] ),  s8 x s8
// with x (M, K) row-major; w is (K, R) row-major at bf16, as the reference
// feeds it, and (R, K) K-contiguous at s8, the out-feature-major layout of
// the model's int8 weights (quant/i8.py) and the only B form s8 wgmma reads.
//
// What bounds them: tensor-core operations (2·M·K·R). Design: the
// persistent TMA + wgmma GEMM of gemm_wgmma.cuh, the body of the w8a8
// matmul (i8mm.cu), at a block tile of 128 x BN (BN in {128, 256}). The s8
// probes are that GEMM with the rescale of w8a8 (a null xs and ws multiply
// by 1, exactly); the bf16 probe reads w MN-major with wgmma's transpose
// bit. The wrapper checks M % 128 == 0, K % 64 == 0, R % 256 == 0.
#include "gemm_wgmma.cuh"

using namespace gguf_cuda;

template <int BN>
static cudaError_t probe_bf16_bn(const void* x, const void* w, void* out,
                                 int M, int K, int R, cudaStream_t stream) {
  CUtensorMap tm_x, tm_w, tm_o;
  bool ok = make_map(&tm_x, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, x, M, K,
                     GM_BM, GM_BK / 2, CU_TENSOR_MAP_SWIZZLE_128B);
  // boxes of 64 k rows x 64 columns (128 bytes), BN / 64 of them a stage
  ok = ok && make_map(&tm_w, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, w, K, R,
                      64, 64, CU_TENSOR_MAP_SWIZZLE_128B);
  ok = ok && make_out_map(&tm_o, out, M, R);
  if (!ok) return cudaErrorInvalidValue;
  return launch_gemm<true, BN>(tm_x, tm_w, tm_o, nullptr, 0, nullptr,
                               nullptr, M, R, (2 * K + GM_BK - 1) / GM_BK,
                               -1, stream);
}

template <int BN>
static cudaError_t probe_s8_bn(const void* x, const void* w, const void* xs,
                               const void* ws, void* out, int M, int K, int R,
                               int xs_stride, cudaStream_t stream) {
  CUtensorMap tm_x, tm_w, tm_o;
  bool ok = make_map(&tm_x, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, x, M, K, GM_BM,
                     GM_BK, CU_TENSOR_MAP_SWIZZLE_128B);
  ok = ok && make_map(&tm_w, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, w, R, K, BN,
                      GM_BK, CU_TENSOR_MAP_SWIZZLE_128B);
  ok = ok && make_out_map(&tm_o, out, M, R);
  if (!ok) return cudaErrorInvalidValue;
  return launch_gemm<false, BN>(tm_x, tm_w, tm_o, xs, xs_stride, ws, nullptr,
                                M, R, (K + GM_BK - 1) / GM_BK, -1, stream);
}

// Plain C entries (bound with ctypes). bn selects the block tile: 128
// (128x128, 4 stages) or 256 (128x256, 3 stages). x (M, K) bf16, w (K, R)
// bf16. Shapes are checked by the Python wrapper. Each returns
// cudaGetLastError().
extern "C" int gemm_probe_bf16_launch(const void* x, const void* w, void* out,
                                      int M, int K, int R, int bn,
                                      void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bn == 128) return probe_bf16_bn<128>(x, w, out, M, K, R, s);
  if (bn == 256) return probe_bf16_bn<256>(x, w, out, M, K, R, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// x (M, K) s8, w (R, K) s8. xs == null: the raw s8 product cast to bf16
// (K8a); else the w8a8 rescale (K8b) with xs read at element stride
// xs_stride.
extern "C" int gemm_probe_s8_launch(const void* x, const void* w,
                                    const void* xs, const void* ws, void* out,
                                    int M, int K, int R, int xs_stride, int bn,
                                    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bn == 128)
    return probe_s8_bn<128>(x, w, xs, ws, out, M, K, R, xs_stride, s);
  if (bn == 256)
    return probe_s8_bn<256>(x, w, xs, ws, out, M, K, R, xs_stride, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
