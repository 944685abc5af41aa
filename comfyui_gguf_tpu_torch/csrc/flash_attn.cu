// K7's bf16 instances: the body of flash_attn.cuh (its header says what it
// replaces, what bounds it and how it is laid out) at head dims up to 256
// and the wide-head body of flash_attn_wide.cuh at 384 and 512: every head
// dim of nn/attention.py's FLASH_HEAD_DIMS.
#include "flash_attn_wide.cuh"

using namespace gguf_flash;

// Dynamic shared memory of a launch at head dim D (0 for another D); the
// f16 instances use the same.
extern "C" int flash_attn_smem_bytes(int D) {
  switch (D) {
    case 40: return FShape<40>::SMEM;
    case 64: return FShape<64>::SMEM;
    case 80: return FShape<80>::SMEM;
    case 96: return FShape<96>::SMEM;
    case 128: return FShape<128>::SMEM;
    case 160: return FShape<160>::SMEM;
    case 256: return FShape<256>::SMEM;
    case 384: return WShape<384>::SMEM;
    case 512: return WShape<512>::SMEM;
    default: return 0;
  }
}

// Plain C entry (bound with ctypes). q/k/v/out are bf16 (B, H, L, D) views
// with unit stride along D; strides[12] = (b, h, l) element strides of q,
// k, v and out. The wrapper checks D in {40, 64, 80, 96, 128, 160, 256,
// 384, 512}, Lk >= 1, and TMA's rule for the base and the strides
// (multiples of 16 bytes). Returns cudaGetLastError().
extern "C" int flash_attn_launch(const void* q, const void* k, const void* v,
                                 void* out, int B, int H, int Lq, int Lk,
                                 int D, const long long* strides, float scale,
                                 void* stream) {
  return flash_dispatch<false>(q, k, v, out, B, H, Lq, Lk, D, strides, scale,
                               stream);
}
