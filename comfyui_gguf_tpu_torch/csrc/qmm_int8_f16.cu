// K2 at dequant_dtype float16: the f16 instances of the wgmma body over one
// int8 code per element (design: qmm_f16.cu). Replaces _make_int8_kernel of
// comfyui_gguf_tpu/ops/qmatmul.py run with compute_dtype float16. A
// separate source so that it compiles beside qmm_int8.cu.
#include "qmm_wgmma.cuh"

using namespace gguf_cuda;

// As qmm_wgmma_nib4_f16_launch (qmm_f16.cu), over int8 codes.
extern "C" int qmm_wgmma_int8_f16_launch(
    const void* x, const void* qs, const void* scales, const void* offsets,
    const void* bias, void* out, int M, int K, int Kp, int R, int Rp, int gs,
    int zp, int act_from, int nt, int split, int sbf16, void* stream) {
  return launch_wgmma<false, false, true>(
      x, qs, scales, offsets, bias, out, nullptr, nullptr, M, K, Kp, R, Rp,
      gs, zp, 0, act_from, nt, split, sbf16,
      static_cast<cudaStream_t>(stream));
}
