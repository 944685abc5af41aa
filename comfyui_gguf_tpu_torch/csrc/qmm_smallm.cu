// K1/K2 for M <= 8, bf16 operands: the entries of the split-K body
// (qmm_smallm.cuh; design note: qmm.cu), both layouts.
#include "qmm_smallm.cuh"

using namespace gguf_cuda;

// Plain C entry (bound with ctypes); shapes as for qmm_wgmma_nib4_launch
// (qmm.cu). `split` (1..8, dividing the code rows into slices that are
// multiples of 16 rows) is the cluster size along K. Returns the launch's
// CUDA error code.
extern "C" int qmm_smallm_launch(const void* x, const void* qs,
                                 const void* scales, const void* offsets,
                                 const void* bias, void* out, int M, int K,
                                 int Kp, int R, int Rp, int gs, int zp,
                                 int nib4, int act_from, int split,
                                 void* stream) {
  return launch_smallm_any<false, DT_BF16>(
      x, qs, scales, offsets, bias, out, nullptr, nullptr, M, K, Kp, R, Rp,
      gs, zp, 0, nib4, act_from, split, 0, static_cast<cudaStream_t>(stream));
}

// qmm_smallm_launch with the scale planes' type (sbf16 = 1: bfloat16
// scales and offsets, else float32).
extern "C" int qmm_smallm_ex_launch(const void* x, const void* qs,
                                    const void* scales, const void* offsets,
                                    const void* bias, void* out, int M,
                                    int K, int Kp, int R, int Rp, int gs,
                                    int zp, int nib4, int act_from,
                                    int split, int sbf16, void* stream) {
  return launch_smallm_any<false, DT_BF16>(
      x, qs, scales, offsets, bias, out, nullptr, nullptr, M, K, Kp, R, Rp,
      gs, zp, 0, nib4, act_from, split, sbf16,
      static_cast<cudaStream_t>(stream));
}

// The LORA instance: qmm_smallm_ex_launch plus h (M, rk) and up (Rp, rk)
// bf16, rk > 0 a multiple of 16 (checked by the Python wrapper).
extern "C" int qmm_smallm_lora_launch(
    const void* x, const void* qs, const void* scales, const void* offsets,
    const void* bias, void* out, const void* h, const void* up, int M, int K,
    int Kp, int R, int Rp, int gs, int zp, int rk, int nib4, int act_from,
    int split, int sbf16, void* stream) {
  return launch_smallm_any<true, DT_BF16>(
      x, qs, scales, offsets, bias, out, h, up, M, K, Kp, R, Rp, gs, zp, rk,
      nib4, act_from, split, sbf16, static_cast<cudaStream_t>(stream));
}
