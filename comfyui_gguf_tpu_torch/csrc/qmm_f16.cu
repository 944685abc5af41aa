// K1 at dequant_dtype float16: the f16 instances of the wgmma body of the
// fused dequant-matmul, nib4 layout (qmm_wgmma.cuh; design note: qmm.cu).
// Replaces _make_nib4_kernel of comfyui_gguf_tpu/ops/qmatmul.py run with
// compute_dtype float16 (pallas_qmm casts x and the dequantized weight to
// dequant_dtype, :398 and the kernel's compute_dtype). The codes are
// dequantized in f32 as in the bf16 instances and rounded to f16, x is f16,
// the wgmma is f32.f16.f16 at the bf16 rate, so the bound is the same
// tensor-core work; bias and GELU run on the f32 accumulator and the output
// is stored in f32 (the wrapper rounds it once to the caller's dtype). A
// separate source so that it compiles beside qmm.cu.
#include "qmm_wgmma.cuh"

using namespace gguf_cuda;

// As qmm_wgmma_nib4_split_launch (qmm.cu) over f16 x (M, K) and an f32
// output (M, R).
extern "C" int qmm_wgmma_nib4_f16_launch(
    const void* x, const void* qs, const void* scales, const void* offsets,
    const void* bias, void* out, int M, int K, int Kp, int R, int Rp, int gs,
    int zp, int act_from, int nt, int split, int sbf16, void* stream) {
  return launch_wgmma<true, false, true>(
      x, qs, scales, offsets, bias, out, nullptr, nullptr, M, K, Kp, R, Rp,
      gs, zp, 0, act_from, nt, split, sbf16,
      static_cast<cudaStream_t>(stream));
}
