// K1 with the LoRA rank term at dequant_dtype float16: the f16 LORA
// instances of the wgmma body (design: qmm_lora.cu, qmm_f16.cu). The rank
// operands h and up are f16, as the reference's _prep_lora casts them to
// dequant_dtype (comfyui_gguf_tpu/ops/qmatmul.py:430). A separate source so
// that it compiles beside qmm_lora.cu.
#include "qmm_wgmma.cuh"

using namespace gguf_cuda;

// As qmm_wgmma_nib4_lora_launch (qmm_lora.cu) over f16 x, h and up and an
// f32 output.
extern "C" int qmm_wgmma_nib4_f16_lora_launch(
    const void* x, const void* qs, const void* scales, const void* offsets,
    const void* bias, void* out, const void* h, const void* up, int M, int K,
    int Kp, int R, int Rp, int gs, int zp, int rk, int act_from, int nt,
    int split, int sbf16, void* stream) {
  return launch_wgmma<true, true, true>(x, qs, scales, offsets, bias, out, h,
                                        up, M, K, Kp, R, Rp, gs, zp, rk,
                                        act_from, nt, split, sbf16,
                                        static_cast<cudaStream_t>(stream));
}
