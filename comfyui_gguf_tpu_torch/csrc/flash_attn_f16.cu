// K7's f16 instances: the bodies of flash_attn.cuh and flash_attn_wide.cuh
// with f16 operands, P and output, at every head dim of the bf16 instances
// (flash_attn.cu).
#include "flash_attn_wide.cuh"

using namespace gguf_flash;

// Plain C entry (bound with ctypes), as flash_attn_launch but for f16
// (B, H, L, D) views q, k, v and out.
extern "C" int flash_attn_f16_launch(const void* q, const void* k,
                                     const void* v, void* out, int B, int H,
                                     int Lq, int Lk, int D,
                                     const long long* strides, float scale,
                                     void* stream) {
  return flash_dispatch<true>(q, k, v, out, B, H, Lq, Lk, D, strides, scale,
                              stream);
}
