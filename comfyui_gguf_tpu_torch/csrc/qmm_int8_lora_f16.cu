// K2 with the LoRA rank term at dequant_dtype float16: the f16 LORA
// instances of the wgmma body over int8 codes (design: qmm_lora_f16.cu). A
// separate source so that it compiles beside qmm_int8_lora.cu.
#include "qmm_wgmma.cuh"

using namespace gguf_cuda;

// As qmm_wgmma_nib4_f16_lora_launch (qmm_lora_f16.cu), over int8 codes.
extern "C" int qmm_wgmma_int8_f16_lora_launch(
    const void* x, const void* qs, const void* scales, const void* offsets,
    const void* bias, void* out, const void* h, const void* up, int M, int K,
    int Kp, int R, int Rp, int gs, int zp, int rk, int act_from, int nt,
    int split, int sbf16, void* stream) {
  return launch_wgmma<false, true, true>(x, qs, scales, offsets, bias, out, h,
                                         up, M, K, Kp, R, Rp, gs, zp, rk,
                                         act_from, nt, split, sbf16,
                                         static_cast<cudaStream_t>(stream));
}
