// K2 for M above the small-M limit: the int8-layout instances of the wgmma
// body of the fused dequant-matmul (design note: qmm.cu). Replaces
// _make_int8_kernel of comfyui_gguf_tpu/ops/qmatmul.py.
#include "qmm_wgmma.cuh"

using namespace gguf_cuda;

// As qmm_wgmma_nib4_launch (qmm.cu), over one int8 code per element.
extern "C" int qmm_wgmma_int8_launch(const void* x, const void* qs,
                                     const void* scales, const void* offsets,
                                     const void* bias, void* out, int M,
                                     int K, int Kp, int R, int Rp, int gs,
                                     int zp, int act_from, int nt,
                                     void* stream) {
  return launch_wgmma<false, false>(
      x, qs, scales, offsets, bias, out, nullptr, nullptr, M, K, Kp, R, Rp,
      gs, zp, 0, act_from, nt, 1, 0, static_cast<cudaStream_t>(stream));
}

// As qmm_wgmma_nib4_split_launch (qmm.cu), over int8 codes.
extern "C" int qmm_wgmma_int8_split_launch(
    const void* x, const void* qs, const void* scales, const void* offsets,
    const void* bias, void* out, int M, int K, int Kp, int R, int Rp, int gs,
    int zp, int act_from, int nt, int split, int sbf16, void* stream) {
  return launch_wgmma<false, false>(
      x, qs, scales, offsets, bias, out, nullptr, nullptr, M, K, Kp, R, Rp,
      gs, zp, 0, act_from, nt, split, sbf16,
      static_cast<cudaStream_t>(stream));
}
