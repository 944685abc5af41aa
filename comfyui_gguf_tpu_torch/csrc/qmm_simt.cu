// K1/K2 at dequant_dtype float32 for M above the small-M limit: the f32
// body of the fused dequant-matmul, both layouts.
//
// Replaces _make_nib4_kernel and _make_int8_kernel of
// comfyui_gguf_tpu/ops/qmatmul.py run with compute_dtype float32, where the
// reference multiplies the f32 weight by f32 x in a true f32 product. No
// tensor-core type holds that exactly: a TF32 pass keeps 10 bits of
// mantissa, and a 3xTF32 split keeps 22 of a weight's 24, where the tests
// hold each dequantized weight bit for bit. So this body multiplies on f32
// FMAs, and what bounds it is the card's f32 rate outside the tensor cores
// (67 TFLOP/s on the H100 SXM), 15x below bf16.
//
//   out[m, r] = epi( sum_k x[m, k] * W[k, r] (+ sum_j h[m, j] * up[r, j]) )
//
// A pipelined SIMT GEMM (it replaces a 64 x 128 single-buffer tile, 4 x 8
// outputs a thread, which reached 36% of the FMA peak). A 256-thread
// block owns 128 tokens x 128 out-features, 8 x 8 outputs a thread, or 64
// x 128 (4 x 8) where 128-token tiles would leave more than half the SMs
// idle (simt_bm below: T5-xxl's q at M = 512, R = 4096, 128 tiles for
// 132 SMs, keeps 128; M <= 128 at R up to 8192 takes 64). It walks K
// in steps of 32 through three shared stages of each operand:
//   x  token rows of 32 k (padded to 36), by 16-byte cp.async issued two
//      steps ahead (zeros past M and K);
//   W  k rows of the 128 out-features (padded to 132), dequantized by the
//      threads themselves: the codes and scales of step t + 1 are loaded
//      into registers when step t starts, the FMAs of step t run, and then
//      those registers are dequantized in f32 (qmm_common.cuh dequant1, the
//      plain version's arithmetic, so the weight equals its f32 weight bit
//      for bit) into the next stage.
// One __syncthreads a step (stage t landed and written, stage t - 1 read by
// all), none between load, dequantization and product. A thread owns
// tokens ty + 16i and two quads of out-features 64 apart; for each quad of
// k it loads W's 4 k rows of its out-features (two 16-byte loads each) and
// then each token's 4 k values (one 16-byte load), 16 loads for 256 FMAs.
// Within a warp those fall on 8 (W) and 4 (x) distinct 16-byte bank groups
// and are broadcast to the other lanes, so no bank conflicts; the
// dequantizing lanes are laid out so their 16-byte stores do not conflict
// either. The LoRA instances walk the rank the same way after K, h as x
// and up as the weight (up (Rp, rk) transposed into W's k rows by 4-byte
// cp.async). Bias and GELU run on the accumulator; the output is f32 (the
// wrapper rounds it once to the caller's dtype). Two launches give the
// same bits: each output is one thread's sum in k order, no split of K.
//
// Measured on the H100 (PERF.md): the FMA loop alone, without the loads
// of x and the dequantization, runs at torch.matmul's f32 rate; the x
// loads, first as 4-byte copies transposing x into k rows, cost a fifth of
// the time, hence the token rows; the dequantization about a tenth. A 128
// x 256 tile at 8 x 16 a thread, one block an SM, measured within 6% of
// the 128 x 128 one either way and is not kept.
#include "qmm_common.cuh"
#include "tma.cuh"

using namespace gguf_cuda;

namespace {

constexpr int SI_BK = 32;        // k a step
constexpr int SI_STAGES = 3;
constexpr int SI_THREADS = 256;  // 16 x 16 threads

constexpr int SI_BN = 128;       // out-features a tile

template <int BM>
struct SimtShape {
  static constexpr int LDX = SI_BK + 4;  // floats of an x stage's token row
  static constexpr int LDW = SI_BN + 4;  // floats of a W stage's k row
  static constexpr int XS = BM * LDX;     // floats of an x stage
  static constexpr int WS = SI_BK * LDW;  // floats of a W stage
  static constexpr int SMEM = SI_STAGES * (XS + WS) * 4;
  static constexpr int TM = BM / 16;  // tokens a thread, 16 apart
  static constexpr int TN = 2;        // out-feature quads a thread, 64 apart
};

// Token tile of a launch: 128, or 64 where 128-token tiles would leave
// more than half the SMs idle.
int simt_bm(int M, int R) {
  const long long tiles128 =
      static_cast<long long>((M + 127) / 128) * ((R + SI_BN - 1) / SI_BN);
  return 2 * tiles128 > sm_count() ? 128 : 64;
}

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

// 16 bytes global -> shared, zeros where !ok (nothing is read then)
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}

// 4 bytes global -> shared, a zero where !ok (nothing is read then)
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(ok ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// two blocks an SM (at most 128 registers a thread); the LoRA instances,
// whose rank steps hold more, one
template <bool NIB4, bool HAS_OFF, bool LORA, bool SBF16, int BM>
__global__ void __launch_bounds__(SI_THREADS, LORA ? 1 : 2)
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
  using S = SimtShape<BM>;
  constexpr bool FOLD = NIB4 && HAS_OFF;
  constexpr int TM = S::TM;
  constexpr int TN = S::TN;
  extern __shared__ float4 smem4[];
  float* xs = reinterpret_cast<float*>(smem4);  // stages x (BM, LDX)
  float* ws = xs + SI_STAGES * S::XS;           // stages x (BK, LDW)

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int m0 = blockIdx.x * BM;
  const int r0 = blockIdx.y * SI_BN;
  // product layout: warp (warp / 2, warp % 2) holds rows 4(warp / 2) + ly
  // and columns 8(warp % 2) + lx of the 16 x 16 thread grid; a thread owns
  // tokens ty + 16i x out-features 4tx .. 4tx+3 and 64 + those
  const int ty = 4 * (warp >> 1) + (lane >> 3);
  const int tx = 8 * (warp & 1) + (lane & 7);
  // dequantization layout: k rows 4kr .. 4kr+3 of out-features 4cg ..
  // 4cg+3; a quarter warp is 8 consecutive cg, so its 16-byte stores hit 8
  // distinct bank groups
  const int cg = 8 * (warp & 3) + (lane & 7);
  const int kr = 4 * (warp >> 2) + (lane >> 3);
  const int col = r0 + 4 * cg;
  const float neg_base = NIB4 ? -(MAGIC + zp) : -(MAGIC + 128.0f);
  const int half = Kp / 2;
  const int nk = Kp / SI_BK;
  const int nsteps = nk + (LORA ? (rk + SI_BK - 1) / SI_BK : 0);

  // step t's x (or h) into x stage t % 3, token rows of 32 k (16-byte
  // copies, zeros past M and the width), and on a rank step up into W stage
  // t % 3, transposed to k rows by 4-byte copies (element e of a round is
  // rank (e & 7) + 8((e >> 5) & 3) of out-feature 4(e >> 7) + ((e >> 3) &
  // 3): a warp reads 4 rows x 32 bytes and writes 32 distinct banks)
  auto issue = [&](int t) {
    if (t >= nsteps) return;
    const bool rank = t >= nk;
    const float* src = rank ? lora_h : x;
    const int kw = rank ? rk : K;
    const int k0 = (rank ? t - nk : t) * SI_BK;
    float* xd = xs + (t % SI_STAGES) * S::XS;
#pragma unroll
    for (int p = 0; p < BM * 8 / SI_THREADS; ++p) {
      const int i = tid + p * SI_THREADS;
      const int row = i >> 3;
      const int kq = (i & 7) * 4;
      const bool ok = m0 + row < M && k0 + kq < kw;
      cp_async16(xd + row * S::LDX + kq,
                 ok ? src + static_cast<size_t>(m0 + row) * kw + k0 + kq
                    : src,
                 ok);
    }
    if constexpr (LORA) {
      if (rank) {
        float* wd = ws + (t % SI_STAGES) * S::WS;
#pragma unroll 4
        for (int e = tid; e < SI_BN * SI_BK; e += SI_THREADS) {
          const int k = (e & 7) + 8 * ((e >> 5) & 3);
          const int f = 4 * (e >> 7) + ((e >> 3) & 3);
          const bool ok = k0 + k < rk;
          cp_async4(wd + k * S::LDW + f,
                    ok ? lora_up + static_cast<size_t>(r0 + f) * rk + k0 + k
                       : lora_up,
                    ok);
        }
      }
    }
  };

  // the codes and scale (offset) quads of step t's weight rows, in
  // registers; then their f32 weights into W stage t % 3
  uint32_t code[4];
  float4 s4, o4 = make_float4(0.f, 0.f, 0.f, 0.f);
  auto fetch = [&](int t) {
    const int k = t * SI_BK + 4 * kr;
    const int shift = (NIB4 && k >= half) ? 4 : 0;
    const int row = NIB4 ? (k >= half ? k - half : k) : k;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const uint32_t word = __ldg(reinterpret_cast<const uint32_t*>(
          qs + static_cast<size_t>(row + j) * Rp + col));
      code[j] = ((word >> shift) & (NIB4 ? 0x0F0F0F0Fu : 0xFFFFFFFFu)) ^
                (NIB4 ? 0u : 0x80808080u);
    }
    const size_t at = static_cast<size_t>(k / gs) * Rp + col;
    s4 = ld_scale4<SBF16>(scales, at);
    if constexpr (HAS_OFF) o4 = ld_scale4<SBF16>(offsets, at);
  };
  auto dequant_store = [&](int t) {
    const float s[4] = {s4.x, s4.y, s4.z, s4.w};
    const float o[4] = {o4.x, o4.y, o4.z, o4.w};
    float* wd = ws + (t % SI_STAGES) * S::WS + 4 * kr * S::LDW + 4 * cg;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float w[4];
#pragma unroll
      for (int b = 0; b < 4; ++b)
        w[b] = dequant1<FOLD, HAS_OFF>(magic_of_byte(code[j], b), s[b], o[b],
                                       -s[b] * MAGIC, neg_base);
      *reinterpret_cast<float4*>(wd + j * S::LDW) =
          make_float4(w[0], w[1], w[2], w[3]);
    }
  };

  // acc[i][j]: token ty + 16i, out-feature 4tx + (j & 3) + 64(j >> 2)
  float acc[TM][4 * TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < 4 * TN; ++j) acc[i][j] = 0.0f;

  issue(0);
  cp_async_commit();
  issue(1);
  cp_async_commit();
  fetch(0);
  dequant_store(0);

  for (int t = 0; t < nsteps; ++t) {
    cp_async_wait<1>();
    __syncthreads();  // stage t landed and written; stage t - 1 read by all
    issue(t + 2);
    cp_async_commit();
    const bool next_w = t + 1 < nk;
    if (next_w) fetch(t + 1);
    const float* xt = xs + (t % SI_STAGES) * S::XS + ty * S::LDX;
    const float* wt = ws + (t % SI_STAGES) * S::WS + 4 * tx;
    // a quad of k at a time: W's 4 k rows of this thread's 8 out-features,
    // then each token's 4 k values, k in order for every output
#pragma unroll 1
    for (int kq = 0; kq < SI_BK; kq += 4) {
      float b[4][4 * TN];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int h = 0; h < TN; ++h)
          *reinterpret_cast<float4*>(b[kk] + 4 * h) =
              *reinterpret_cast<const float4*>(wt + (kq + kk) * S::LDW +
                                               64 * h);
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        const float4 a =
            *reinterpret_cast<const float4*>(xt + 16 * i * S::LDX + kq);
#pragma unroll
        for (int j = 0; j < 4 * TN; ++j) {
          acc[i][j] = __fmaf_rn(a.x, b[0][j], acc[i][j]);
          acc[i][j] = __fmaf_rn(a.y, b[1][j], acc[i][j]);
          acc[i][j] = __fmaf_rn(a.z, b[2][j], acc[i][j]);
          acc[i][j] = __fmaf_rn(a.w, b[3][j], acc[i][j]);
        }
      }
    }
    if (next_w) dequant_store(t + 1);
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < 4 * TN; j += 2)
      epilogue_store2(out, bias, act_from, M, R, m0 + ty + 16 * i,
                      r0 + 4 * tx + (j & 3) + 64 * (j >> 2), acc[i][j],
                      acc[i][j + 1]);
}

template <bool NIB4, bool HAS_OFF, bool LORA, bool SBF16, int BM>
cudaError_t launch_simt(const void* x, const void* qs, const void* scales,
                        const void* offsets, const void* bias, void* out,
                        const void* h, const void* up, int M, int K, int Kp,
                        int R, int Rp, int gs, int zp, int rk, int act_from,
                        cudaStream_t stream) {
  constexpr int SMEM = SimtShape<BM>::SMEM;
  static const cudaError_t attr = cudaFuncSetAttribute(
      qmm_simt_kernel<NIB4, HAS_OFF, LORA, SBF16, BM>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (attr != cudaSuccess) return attr;
  const dim3 grid((M + BM - 1) / BM, (R + SI_BN - 1) / SI_BN, 1);
  qmm_simt_kernel<NIB4, HAS_OFF, LORA, SBF16, BM>
      <<<grid, SI_THREADS, SMEM, stream>>>(
          static_cast<const float*>(x), static_cast<const uint8_t*>(qs),
          scales, offsets, static_cast<const float*>(bias),
          static_cast<float*>(out), M, K, Kp, R, Rp, gs,
          static_cast<float>(zp), act_from, static_cast<const float*>(h),
          static_cast<const float*>(up), rk);
  return cudaGetLastError();
}

template <bool LORA>
int launch_simt_any(const void* x, const void* qs, const void* scales,
                    const void* offsets, const void* bias, void* out,
                    const void* h, const void* up, int M, int K, int Kp,
                    int R, int Rp, int gs, int zp, int rk, int nib4,
                    int act_from, int sbf16, cudaStream_t s) {
#define GGUF_SIMT(NIB, OFF, SB)                                              \
  (simt_bm(M, R) == 128                                                      \
       ? launch_simt<NIB, OFF, LORA, SB, 128>(x, qs, scales, offsets, bias,  \
                                              out, h, up, M, K, Kp, R, Rp,   \
                                              gs, zp, rk, act_from, s)       \
       : launch_simt<NIB, OFF, LORA, SB, 64>(x, qs, scales, offsets, bias,   \
                                             out, h, up, M, K, Kp, R, Rp,    \
                                             gs, zp, rk, act_from, s))
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
