// K1/K2 at dequant_dtype float32 for M above the small-M limit: the f32
// body of the fused dequant-matmul, both layouts.
//
// Replaces _make_nib4_kernel and _make_int8_kernel of
// comfyui_gguf_tpu/ops/qmatmul.py run with compute_dtype float32, where the
// reference multiplies the f32 weight by f32 x in a true f32 product. No
// tensor-core type holds that: a single TF32 pass keeps 10 bits of
// mantissa. So this body multiplies on f32 FMAs, and what bounds it is the
// card's f32 rate outside the tensor cores (67 TFLOP/s), 15x below bf16.
//
//   out[m, r] = epi( sum_k x[m, k] * W[k, r] (+ sum_j h[m, j] * up[r, j]) )
//
// A simple SIMT tile kernel: a 256-thread block owns 64 tokens x 128
// out-features and walks K in steps of 32. Per step it copies the x tile
// into shared memory (k-major) and dequantizes the 32 x 128 weight tile
// there in f32 (the codes read once, 4 adjacent out-features a thread, the
// same magic-number arithmetic as the other bodies, qmm_common.cuh, so the
// weight equals the plain version's f32 weight bit for bit), and each
// thread accumulates a 4-token x 8-feature sub-tile with FMAs from
// float4 shared loads. The LoRA instances walk the rank the same way after
// K, h as x and up as the weight. Bias and GELU run on the accumulator; the
// output is f32 (the wrapper rounds it once to the caller's dtype). Two
// launches give the same bits: each output is one thread's sum in k order.
#include "qmm_common.cuh"

using namespace gguf_cuda;

namespace {

constexpr int SI_BM = 64;        // tokens a tile
constexpr int SI_BN = 128;       // out-features a tile
constexpr int SI_BK = 32;        // k a step
constexpr int SI_THREADS = 256;  // 16 x 16 threads, 4 x 8 outputs each

template <bool SBF16>
__device__ __forceinline__ float4 ld_scale4(const void* plane, size_t at) {
  if constexpr (SBF16) {  // 4 bf16, each the high half of its f32
    const uint2 u = __ldg(reinterpret_cast<const uint2*>(
        static_cast<const __nv_bfloat16*>(plane) + at));
    return make_float4(__uint_as_float(u.x << 16),
                       __uint_as_float(u.x & 0xFFFF0000u),
                       __uint_as_float(u.y << 16),
                       __uint_as_float(u.y & 0xFFFF0000u));
  } else {
    return __ldg(reinterpret_cast<const float4*>(
        static_cast<const float*>(plane) + at));
  }
}

template <bool NIB4, bool HAS_OFF, bool LORA, bool SBF16>
__global__ void __launch_bounds__(SI_THREADS)
qmm_simt_kernel(const float* __restrict__ x,       // (M, K)
                const uint8_t* __restrict__ qs,    // (Kp/2 or Kp, Rp)
                const void* __restrict__ scales,   // (Kp/gs, Rp)
                const void* __restrict__ offsets,  // (Kp/gs, Rp) | null
                const float* __restrict__ bias,    // (R) | null
                float* __restrict__ out,           // (M, R)
                int M, int K, int Kp, int R, int Rp, int gs, float zp,
                int act_from,
                const float* __restrict__ lora_h,   // LORA: (M, rk)
                const float* __restrict__ lora_up,  // LORA: (Rp, rk)
                int rk) {
  constexpr bool FOLD = NIB4 && HAS_OFF;
  __shared__ __align__(16) float xs[SI_BK][SI_BM];
  __shared__ __align__(16) float ws[SI_BK][SI_BN];
  const int tid = threadIdx.x;
  const int m0 = blockIdx.x * SI_BM;
  const int r0 = blockIdx.y * SI_BN;
  const int tm = tid >> 4;  // tokens 4tm .. 4tm+3
  const int tn = tid & 15;  // out-features 8tn .. 8tn+7
  const float neg_base = NIB4 ? -(MAGIC + zp) : -(MAGIC + 128.0f);
  const int half = Kp / 2;

  float acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;

  // rows (M, kw) of src from column k0 into xs, zeros past M and past kw
  // (kw is a multiple of 4, so a float4 is all in or all out)
  auto load_x = [&](const float* src, int kw, int k0) {
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      const int i = tid + p * SI_THREADS;
      const int tok = i >> 3;
      const int kq = (i & 7) * 4;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (m0 + tok < M && k0 + kq < kw)
        v = __ldg(reinterpret_cast<const float4*>(
            src + static_cast<size_t>(m0 + tok) * kw + k0 + kq));
      xs[kq][tok] = v.x;
      xs[kq + 1][tok] = v.y;
      xs[kq + 2][tok] = v.z;
      xs[kq + 3][tok] = v.w;
    }
  };
  auto fma_tile = [&]() {
#pragma unroll 8
    for (int kk = 0; kk < SI_BK; ++kk) {
      const float4 a = *reinterpret_cast<const float4*>(&xs[kk][4 * tm]);
      const float4 b0 = *reinterpret_cast<const float4*>(&ws[kk][8 * tn]);
      const float4 b1 =
          *reinterpret_cast<const float4*>(&ws[kk][8 * tn + 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j)
          acc[i][j] = __fmaf_rn(av[i], bv[j], acc[i][j]);
    }
  };

  // the weight tile: thread (kr, cg) dequantizes k rows 4kr .. 4kr+3 of
  // out-features 4cg .. 4cg+3
  const int cg = tid & 31;
  const int kr = tid >> 5;
  const int col = r0 + 4 * cg;
  for (int k0 = 0; k0 < Kp; k0 += SI_BK) {
    load_x(x, K, k0);
    // a step lies in one half of the nib4 rows (Kp / 2 is a multiple of 32)
    const int shift = (NIB4 && k0 >= half) ? 4 : 0;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int k = k0 + 4 * kr + j;
      const int row = NIB4 ? (k >= half ? k - half : k) : k;
      const uint32_t word = __ldg(reinterpret_cast<const uint32_t*>(
          qs + static_cast<size_t>(row) * Rp + col));
      const uint32_t codes = ((word >> shift) &
                              (NIB4 ? 0x0F0F0F0Fu : 0xFFFFFFFFu)) ^
                             (NIB4 ? 0u : 0x80808080u);
      const size_t at = static_cast<size_t>(k / gs) * Rp + col;
      const float4 s4 = ld_scale4<SBF16>(scales, at);
      float4 o4 = make_float4(0.f, 0.f, 0.f, 0.f);
      if constexpr (HAS_OFF) o4 = ld_scale4<SBF16>(offsets, at);
      const float s[4] = {s4.x, s4.y, s4.z, s4.w};
      const float o[4] = {o4.x, o4.y, o4.z, o4.w};
      float w[4];
#pragma unroll
      for (int b = 0; b < 4; ++b)
        w[b] = dequant1<FOLD, HAS_OFF>(magic_of_byte(codes, b), s[b], o[b],
                                       -s[b] * MAGIC, neg_base);
      *reinterpret_cast<float4*>(&ws[4 * kr + j][4 * cg]) =
          make_float4(w[0], w[1], w[2], w[3]);
    }
    __syncthreads();
    fma_tile();
    __syncthreads();
  }

  if constexpr (LORA) {
    // + h · upᵀ, 32 rank columns a step (rk is a multiple of 16)
    for (int c0 = 0; c0 < rk; c0 += SI_BK) {
      load_x(lora_h, rk, c0);
      const int c = tid & (SI_BN - 1);
#pragma unroll 4
      for (int j = 0; j < SI_BK / 2; ++j) {
        const int kk = (tid >> 7) * (SI_BK / 2) + j;
        ws[kk][c] = c0 + kk < rk
                        ? __ldg(lora_up + static_cast<size_t>(r0 + c) * rk +
                                c0 + kk)
                        : 0.0f;
      }
      __syncthreads();
      fma_tile();
      __syncthreads();
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      epilogue_store2(out, bias, act_from, M, R, m0 + 4 * tm + i,
                      r0 + 8 * tn + 2 * j, acc[i][2 * j], acc[i][2 * j + 1]);
}

template <bool NIB4, bool HAS_OFF, bool LORA, bool SBF16>
cudaError_t launch_simt(const void* x, const void* qs, const void* scales,
                        const void* offsets, const void* bias, void* out,
                        const void* h, const void* up, int M, int K, int Kp,
                        int R, int Rp, int gs, int zp, int rk, int act_from,
                        cudaStream_t stream) {
  const dim3 grid((M + SI_BM - 1) / SI_BM, (R + SI_BN - 1) / SI_BN, 1);
  qmm_simt_kernel<NIB4, HAS_OFF, LORA, SBF16><<<grid, SI_THREADS, 0, stream>>>(
      static_cast<const float*>(x), static_cast<const uint8_t*>(qs), scales,
      offsets, static_cast<const float*>(bias), static_cast<float*>(out), M,
      K, Kp, R, Rp, gs, static_cast<float>(zp), act_from,
      static_cast<const float*>(h), static_cast<const float*>(up), rk);
  return cudaGetLastError();
}

template <bool LORA>
int launch_simt_any(const void* x, const void* qs, const void* scales,
                    const void* offsets, const void* bias, void* out,
                    const void* h, const void* up, int M, int K, int Kp,
                    int R, int Rp, int gs, int zp, int rk, int nib4,
                    int act_from, int sbf16, cudaStream_t s) {
#define GGUF_SIMT(NIB, OFF, SB)                                            \
  launch_simt<NIB, OFF, LORA, SB>(x, qs, scales, offsets, bias, out, h, up, \
                                  M, K, Kp, R, Rp, gs, zp, rk, act_from, s)
#define GGUF_SIMT_SB(NIB, OFF) \
  (sbf16 ? GGUF_SIMT(NIB, OFF, true) : GGUF_SIMT(NIB, OFF, false))
  if (nib4)
    return offsets ? GGUF_SIMT_SB(true, true) : GGUF_SIMT_SB(true, false);
  return offsets ? GGUF_SIMT_SB(false, true) : GGUF_SIMT_SB(false, false);
#undef GGUF_SIMT_SB
#undef GGUF_SIMT
}

}  // namespace

// Plain C entry (bound with ctypes): x (M, K) f32, out (M, R) f32; the
// planar operands, shapes and alignment as for qmm_wgmma_nib4_launch
// (qmm.cu); sbf16 = 1: bfloat16 scale planes. Returns the launch's CUDA
// error code.
extern "C" int qmm_simt_launch(const void* x, const void* qs,
                               const void* scales, const void* offsets,
                               const void* bias, void* out, int M, int K,
                               int Kp, int R, int Rp, int gs, int zp,
                               int nib4, int act_from, int sbf16,
                               void* stream) {
  return launch_simt_any<false>(x, qs, scales, offsets, bias, out, nullptr,
                                nullptr, M, K, Kp, R, Rp, gs, zp, 0, nib4,
                                act_from, sbf16,
                                static_cast<cudaStream_t>(stream));
}

// The LORA instance: plus h (M, rk) and up (Rp, rk) f32, rk > 0 a multiple
// of 16.
extern "C" int qmm_simt_lora_launch(const void* x, const void* qs,
                                    const void* scales, const void* offsets,
                                    const void* bias, void* out,
                                    const void* h, const void* up, int M,
                                    int K, int Kp, int R, int Rp, int gs,
                                    int zp, int rk, int nib4, int act_from,
                                    int sbf16, void* stream) {
  return launch_simt_any<true>(x, qs, scales, offsets, bias, out, h, up, M,
                               K, Kp, R, Rp, gs, zp, rk, nib4, act_from,
                               sbf16, static_cast<cudaStream_t>(stream));
}
