// K1/K2 for M <= 8 with f16 operands (dequant_dtype float16): the weight and x rounded to f16,
// mma.sync m16n8k16 f32.f16.f16; an f32 output. The entries of the
// split-K body (qmm_smallm.cuh) at that type, both layouts; a separate
// source so that it compiles beside qmm_smallm.cu.
#include "qmm_smallm.cuh"

using namespace gguf_cuda;

// As qmm_smallm_ex_launch (qmm_smallm.cu) over f16 x (M, K) and an f32
// output (M, R).
extern "C" int qmm_smallm_f16_launch(const void* x, const void* qs,
                                     const void* scales, const void* offsets,
                                     const void* bias, void* out, int M,
                                     int K, int Kp, int R, int Rp, int gs,
                                     int zp, int nib4, int act_from,
                                     int split, int sbf16, void* stream) {
  return launch_smallm_any<false, DT_F16>(
      x, qs, scales, offsets, bias, out, nullptr, nullptr, M, K, Kp, R, Rp,
      gs, zp, 0, nib4, act_from, split, sbf16,
      static_cast<cudaStream_t>(stream));
}

// As qmm_smallm_lora_launch (qmm_smallm.cu) with f16 x, h and up and an
// f32 output.
extern "C" int qmm_smallm_f16_lora_launch(
    const void* x, const void* qs, const void* scales, const void* offsets,
    const void* bias, void* out, const void* h, const void* up, int M, int K,
    int Kp, int R, int Rp, int gs, int zp, int rk, int nib4, int act_from,
    int split, int sbf16, void* stream) {
  return launch_smallm_any<true, DT_F16>(
      x, qs, scales, offsets, bias, out, h, up, M, K, Kp, R, Rp, gs, zp, rk,
      nib4, act_from, split, sbf16, static_cast<cudaStream_t>(stream));
}
