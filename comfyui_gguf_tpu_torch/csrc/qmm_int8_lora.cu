// K2 with the LoRA rank term: the LORA instances of the wgmma body over one
// int8 code per element (design: qmm_lora.cu). Replaces the has_lora
// operands of _make_int8_kernel (comfyui_gguf_tpu/ops/qmatmul.py:169, :181).
// A separate source so that it compiles beside qmm_int8.cu.
#include "qmm_wgmma.cuh"

using namespace gguf_cuda;

// As qmm_wgmma_nib4_lora_launch (qmm_lora.cu), over int8 codes.
extern "C" int qmm_wgmma_int8_lora_launch(
    const void* x, const void* qs, const void* scales, const void* offsets,
    const void* bias, void* out, const void* h, const void* up, int M, int K,
    int Kp, int R, int Rp, int gs, int zp, int rk, int act_from, int nt,
    void* stream) {
  return launch_wgmma<false, true>(x, qs, scales, offsets, bias, out, h, up,
                                   M, K, Kp, R, Rp, gs, zp, rk, act_from, nt,
                                   static_cast<cudaStream_t>(stream));
}
