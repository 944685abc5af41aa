// K1 with the LoRA rank term: the LORA instances of the wgmma body of the
// fused dequant-matmul (qmm_wgmma.cuh; design note: qmm.cu), nib4 layout.
// Replaces the has_lora operands of _make_nib4_kernel
// (comfyui_gguf_tpu/ops/qmatmul.py:97, :117), whose epilogue adds h @ upᵀ
// on the f32 accumulator before the bias and GELU (_epilogue, :78).
//
//   out[m, r] = epi( sum_k x[m, k] * W[k, r] + sum_j h[m, j] * up[r, j] )
//
// h (M, rk) = x @ downᵀ is computed outside, as the reference computes it
// outside Pallas; up (Rp, rk) is the scale-folded up factor; both bf16, rank
// contiguous, rk a multiple of 16 (zero-padded; padded columns add exact
// zeros). The body's accumulator is transposed (out-features are its rows),
// so the rank term is ceil(rk / 16) more m64n128k16 products after the K
// loop with up as the register-fed A operand and h as the B operand, which
// streams through the TMA ring like x. Bound, as for the unpatched body, by
// the bf16 tensor-core work of the base product; the term adds 2·M·R·rk
// operations. A separate source so that it compiles beside qmm.cu.
#include "qmm_wgmma.cuh"

using namespace gguf_cuda;

// Plain C entry (bound with ctypes): qmm_wgmma_nib4_launch (qmm.cu) plus h
// (M, rk) and up (Rp, rk) bf16, contiguous and 16-byte aligned, rk > 0 a
// multiple of 16 (checked by the Python wrapper).
extern "C" int qmm_wgmma_nib4_lora_launch(
    const void* x, const void* qs, const void* scales, const void* offsets,
    const void* bias, void* out, const void* h, const void* up, int M, int K,
    int Kp, int R, int Rp, int gs, int zp, int rk, int act_from, int nt,
    void* stream) {
  return launch_wgmma<true, true>(x, qs, scales, offsets, bias, out, h, up, M,
                                  K, Kp, R, Rp, gs, zp, rk, act_from, nt,
                                  static_cast<cudaStream_t>(stream));
}
