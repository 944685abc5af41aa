// K1/K2 for M <= 8 at dequant_dtype float32: the split-K body of the fused
// dequant-matmul on f32 FMAs, both layouts, with its own layout of the
// work (the bf16 and f16 instances are qmm_smallm.cuh's mma.sync body).
//
// Replaces _make_nib4_kernel and _make_int8_kernel of
// comfyui_gguf_tpu/ops/qmatmul.py run with compute_dtype float32 at the
// modulation projections' M = batch, where the reference multiplies the f32
// weight by f32 x in a true f32 product: no TF32, no tensor cores.
//
//   out[m, r] = epi( sum_k x[m, k] * W[k, r] (+ sum_j h[m, j] * up[r, j]) )
//
// What bounds it: the bytes of the packed weight (codes and scale planes:
// 42 MB at flux's 3072 -> 18432 Q4_K, 12.7 us at 3.35 TB/s). At M = 1 a
// weight costs one FMA, about 4.6 instructions with its unpacking and
// dequantization, 7.8 us of issue at that shape; at M = 8 the 8 FMAs a
// weight make the f32 FMA rate the bound instead.
//
// Design. The block is instantiated on MT, the token count M rounded up to
// 1, 2, 4 or 8 (ops/qmatmul.py smallm_f32_plan picks it, with the split
// and the shared memory, and passes all three), so each weight takes MT
// FMAs and never 8 regardless of M. A 256-thread block owns a
// 128-column strip and 1/split of the code rows (Kp/2 for nib4, one nibble
// plane each; Kp for int8); the split blocks of a strip form one cluster
// along K. Lane l of every warp owns columns 4l .. 4l + 3, so a warp reads
// one 128-byte line of codes a row and one 16-byte scale (8-byte bf16)
// load a plane row; the 8 warps take chunks of ROWS code rows in turn
// (16 at MT <= 2, 8 at 4 and 4 at 8, where the accumulators and the x
// values take the registers). A chunk lies inside one scale group (gs 16
// or 32), so a thread loads its four columns' scale and offset once a
// chunk, and the next chunk's codes and scale rows are in flight
// (registers) while this one is dequantized and multiplied. Two blocks
// fit an SM; the plan's split weighs the rounds of blocks against a
// block's fixed cost. x lives in
// shared memory as MT token rows of the block's K slice (zeros past M and
// K), read as float4 over four k rows: all 32 lanes read the same 16
// bytes, a broadcast. Each weight is dequantized in f32 exactly as the
// plain version does (qmm_common.cuh dequant1) and multiplied into
// acc[m][col] by __fmaf_rn.
//
// Reduction, in a fixed order, no atomics, so two launches give the same
// bits: the 8 warps' partial sums through shared memory, summed in warp
// order; then cluster rank 0 adds the ranks' sums in rank order through
// distributed shared memory, adds the LoRA instance's rank term h[m] .
// up[col] (f32 FMAs in rank-column order, once), then the bias and
// GELU-tanh, and stores f32 (the wrapper rounds once to the caller's
// dtype). Scale and offset planes come in float32 or bfloat16 (SBF16),
// widened exactly.
#include <cooperative_groups.h>

#include "qmm_common.cuh"

using namespace gguf_cuda;

namespace {

namespace cg = cooperative_groups;

constexpr int SF_THREADS = 256;
constexpr int SF_WARPS = SF_THREADS / 32;
constexpr int SF_BN = 128;  // columns per strip: 32 lanes x 4
constexpr int SF_XPAD = 4;  // floats of padding per x row

// code rows a warp takes at a time: a whole 16-row unit where the
// accumulators are few, fewer where they and the x values take the
// registers (8 at MT = 4, 4 at MT = 8: 8 spilled there)
template <int MT>
__host__ __device__ constexpr int sf_rows() {
  return MT <= 2 ? 16 : MT == 4 ? 8 : 4;
}

// the four columns' values of one scale / offset plane row, widened to f32
template <bool SBF16>
__device__ __forceinline__ float4 ld_cols4(const void* plane, size_t at) {
  if constexpr (SBF16) {
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

__device__ __forceinline__ float f4_at(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// one chunk of a thread's operands: ROWS code words (4 columns of one row
// each) and the chunk's scale / offset rows per plane
template <int ROWS, int PLANES, bool HAS_OFF>
struct SfChunk {
  uint32_t code[ROWS];
  float4 sc[PLANES];
  float4 of[HAS_OFF ? PLANES : 1];
};

template <bool NIB4, bool HAS_OFF, bool LORA, bool SBF16, int MT>
__global__ void __launch_bounds__(SF_THREADS, 2)
qmm_smallm_fma_kernel(const float* __restrict__ x,       // (M, K)
                      const uint8_t* __restrict__ qs,    // (Kp/2 or Kp, Rp)
                      const void* __restrict__ scales,   // (Kp/gs, Rp)
                      const void* __restrict__ offsets,  // (Kp/gs, Rp) | null
                      const float* __restrict__ bias,    // (R) | null
                      float* __restrict__ out,           // (M, R)
                      int M, int K, int Kp, int R, int Rp, int gs, float zp,
                      int act_from,
                      const float* __restrict__ lora_h,   // LORA: (M, rk)
                      const float* __restrict__ lora_up,  // LORA: (Rp, rk)
                      int lora_k, int smem_bytes) {
  constexpr bool FOLD = NIB4 && HAS_OFF;
  constexpr int PLANES = NIB4 ? 2 : 1;
  constexpr int ROWS = sf_rows<MT>();
  using Chunk = SfChunk<ROWS, PLANES, HAS_OFF>;
  extern __shared__ __align__(16) uint8_t smem_b[];
  cg::cluster_group cluster = cg::this_cluster();
  const int split = gridDim.y;
  const int rank = cluster.block_rank();  // cluster = the strip's K slices
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int half = Kp / 2;
  const int rows_blk = (NIB4 ? half : Kp) / split;  // code rows of the block
  const int jb = rank * rows_blk;
  const int pitch = rows_blk + SF_XPAD;  // floats per x token row
  const int n0 = blockIdx.x * SF_BN;
  const int col = n0 + 4 * lane;
  const float neg_base = NIB4 ? -(MAGIC + zp) : -(MAGIC + 128.0f);
  const uint32_t mask = NIB4 ? 0x0F0F0F0Fu : 0xFFFFFFFFu;
  const uint32_t flip = NIB4 ? 0u : 0x80808080u;

  // shared memory (smem_bytes, the host plan's): the x slice
  // xs[plane][MT][pitch] (rows past M and k past K are zeros), later reused
  // as the warps' partial sums red[8][MT][128]; at its end part[MT][128],
  // read by rank 0
  float* xs = reinterpret_cast<float*>(smem_b);
  float* part = reinterpret_cast<float*>(smem_b + smem_bytes) - MT * SF_BN;

  auto load_chunk = [&](int ci, Chunk& c) {
    const int r0 = jb + ci * ROWS;
#pragma unroll
    for (int i = 0; i < ROWS; ++i)
      c.code[i] = __ldg(reinterpret_cast<const uint32_t*>(
          qs + static_cast<size_t>(r0 + i) * Rp + col));
    const int grow = r0 / gs;  // the low nibbles' (or int8) scale row
#pragma unroll
    for (int p = 0; p < PLANES; ++p) {
      const size_t at =
          static_cast<size_t>(p * (half / gs) + grow) * Rp + col;
      c.sc[p] = ld_cols4<SBF16>(scales, at);
      if constexpr (HAS_OFF) c.of[p] = ld_cols4<SBF16>(offsets, at);
    }
  };

  // acc[m][b]: this thread's k rows' part of token m, column col + b
  float acc[MT][4];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int b = 0; b < 4; ++b) acc[m][b] = 0.0f;

  const int n_chunks = rows_blk / ROWS;
  Chunk cur, nxt;
  if (warp < n_chunks) load_chunk(warp, cur);

  // the x slice is copied while the first chunk's loads are in flight, in
  // 16-byte pieces (4 k of one token row); rows_blk and K are multiples
  // of 8
  const int vec_row = rows_blk / 4;
  for (int i = tid; i < PLANES * MT * vec_row; i += SF_THREADS) {
    const int jj = (i % vec_row) * 4;
    const int m = (i / vec_row) % MT;
    const int p = i / (vec_row * MT);
    const int k = p * half + jb + jj;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (m < M && k < K)
      v = __ldg(reinterpret_cast<const float4*>(
          x + static_cast<size_t>(m) * K + k));
    *reinterpret_cast<float4*>(xs + (p * MT + m) * pitch + jj) = v;
  }
  __syncthreads();

  for (int ci = warp; ci < n_chunks; ci += SF_WARPS) {
    if (ci + SF_WARPS < n_chunks) load_chunk(ci + SF_WARPS, nxt);
#pragma unroll
    for (int p = 0; p < PLANES; ++p) {
      float s[4], o[4], cs[4];
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        s[b] = f4_at(cur.sc[p], b);
        o[b] = HAS_OFF ? f4_at(cur.of[HAS_OFF ? p : 0], b) : 0.f;
        cs[b] = -s[b] * MAGIC;
      }
#pragma unroll
      for (int rq = 0; rq < ROWS / 4; ++rq) {
        // x of the quad's four k rows for each token: one broadcast load
        float4 xv[MT];
#pragma unroll
        for (int m = 0; m < MT; ++m)
          xv[m] = *reinterpret_cast<const float4*>(
              xs + (p * MT + m) * pitch + ci * ROWS + 4 * rq);
#pragma unroll
        for (int ii = 0; ii < 4; ++ii) {
          const uint32_t word =
              ((cur.code[4 * rq + ii] >> (4 * p)) & mask) ^ flip;
#pragma unroll
          for (int b = 0; b < 4; ++b) {
            const float w = dequant1<FOLD, HAS_OFF>(
                magic_of_byte(word, b), s[b], o[b], cs[b], neg_base);
#pragma unroll
            for (int m = 0; m < MT; ++m)
              acc[m][b] = __fmaf_rn(w, f4_at(xv[m], ii), acc[m][b]);
          }
        }
      }
    }
    cur = nxt;
  }

  // the warps' sums in warp order through shared memory
  __syncthreads();  // every warp is done with the x slice
  float* red = reinterpret_cast<float*>(smem_b);
#pragma unroll
  for (int m = 0; m < MT; ++m)
    *reinterpret_cast<float4*>(red + (warp * MT + m) * SF_BN + 4 * lane) =
        make_float4(acc[m][0], acc[m][1], acc[m][2], acc[m][3]);
  __syncthreads();
  for (int i = tid; i < MT * SF_BN; i += SF_THREADS) {
    float v = 0.0f;
#pragma unroll
    for (int w = 0; w < SF_WARPS; ++w) v += red[w * MT * SF_BN + i];
    part[i] = v;
  }
  cluster.sync();  // every rank's partial sums are in its shared memory
  if (rank == 0) {
    for (int i = tid; i < MT * (SF_BN / 2); i += SF_THREADS) {
      const int m = i / (SF_BN / 2);
      const int c = (i % (SF_BN / 2)) * 2;
      if (m >= M) continue;
      // all ranks' loads first (a cluster has at most 8), then the sum in
      // rank order
      float2 pr[8];
#pragma unroll
      for (int rk = 0; rk < 8; ++rk)
        pr[rk] = rk < split
                     ? *reinterpret_cast<const float2*>(
                           cluster.map_shared_rank(part, rk) + m * SF_BN + c)
                     : make_float2(0.f, 0.f);
      float v0 = 0.0f, v1 = 0.0f;
#pragma unroll
      for (int rk = 0; rk < 8; ++rk) {
        v0 += pr[rk].x;
        v1 += pr[rk].y;
      }
      if constexpr (LORA) {  // + h[m] . up[n0 + c], h[m] . up[n0 + c + 1]
        const float2* hp = reinterpret_cast<const float2*>(
            lora_h + static_cast<size_t>(m) * lora_k);
        const float2* u0 = reinterpret_cast<const float2*>(
            lora_up + static_cast<size_t>(n0 + c) * lora_k);
        const float2* u1 = u0 + lora_k / 2;
        float d0 = 0.0f, d1 = 0.0f;
        for (int j = 0; j < lora_k / 2; ++j) {
          const float2 hv = hp[j], a = u0[j], b = u1[j];
          d0 = __fmaf_rn(hv.y, a.y, __fmaf_rn(hv.x, a.x, d0));
          d1 = __fmaf_rn(hv.y, b.y, __fmaf_rn(hv.x, b.x, d1));
        }
        v0 = __fadd_rn(v0, d0);
        v1 = __fadd_rn(v1, d1);
      }
      epilogue_store2(out, bias, act_from, M, R, m, n0 + c, v0, v1);
    }
  }
  cluster.sync();  // no rank leaves while rank 0 reads its shared memory
}

template <bool NIB4, bool HAS_OFF, bool LORA, bool SBF16, int MT>
cudaError_t launch_f32(const void* x, const void* qs, const void* scales,
                       const void* offsets, const void* bias, void* out,
                       const void* h, const void* up, int M, int K, int Kp,
                       int R, int Rp, int gs, int zp, int rk, int act_from,
                       int split, int smem, cudaStream_t stream) {
  static const cudaError_t attr = cudaFuncSetAttribute(
      qmm_smallm_fma_kernel<NIB4, HAS_OFF, LORA, SBF16, MT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, 200 * 1024);
  if (attr != cudaSuccess) return attr;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((R + SF_BN - 1) / SF_BN, split, 1);
  cfg.blockDim = dim3(SF_THREADS, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute at[1];
  at[0].id = cudaLaunchAttributeClusterDimension;
  at[0].val.clusterDim.x = 1;
  at[0].val.clusterDim.y = split;
  at[0].val.clusterDim.z = 1;
  cfg.attrs = at;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(
      &cfg, qmm_smallm_fma_kernel<NIB4, HAS_OFF, LORA, SBF16, MT>,
      static_cast<const float*>(x), static_cast<const uint8_t*>(qs), scales,
      offsets, static_cast<const float*>(bias), static_cast<float*>(out), M,
      K, Kp, R, Rp, gs, static_cast<float>(zp), act_from,
      static_cast<const float*>(h), static_cast<const float*>(up), rk, smem);
}

// The instance for the layout, the offsets, the scale planes' type and the
// token count mt (1, 2, 4 or 8, at least M).
template <bool LORA>
int launch_f32_any(const void* x, const void* qs, const void* scales,
                   const void* offsets, const void* bias, void* out,
                   const void* h, const void* up, int M, int K, int Kp, int R,
                   int Rp, int gs, int zp, int rk, int nib4, int act_from,
                   int mt, int split, int smem, int sbf16, cudaStream_t s) {
  if ((mt != 1 && mt != 2 && mt != 4 && mt != 8) || M > mt)
    return cudaErrorInvalidValue;
#define GGUF_SF(NIB, OFF, SB, MT)                                          \
  launch_f32<NIB, OFF, LORA, SB, MT>(x, qs, scales, offsets, bias, out, h, \
                                     up, M, K, Kp, R, Rp, gs, zp, rk,      \
                                     act_from, split, smem, s)
#define GGUF_SF_MT(NIB, OFF, SB)                                \
  (mt == 1   ? GGUF_SF(NIB, OFF, SB, 1)                         \
   : mt == 2 ? GGUF_SF(NIB, OFF, SB, 2)                         \
   : mt == 4 ? GGUF_SF(NIB, OFF, SB, 4)                         \
             : GGUF_SF(NIB, OFF, SB, 8))
#define GGUF_SF_SB(NIB, OFF) \
  (sbf16 ? GGUF_SF_MT(NIB, OFF, true) : GGUF_SF_MT(NIB, OFF, false))
  if (nib4)
    return offsets ? GGUF_SF_SB(true, true) : GGUF_SF_SB(true, false);
  return offsets ? GGUF_SF_SB(false, true) : GGUF_SF_SB(false, false);
#undef GGUF_SF_SB
#undef GGUF_SF_MT
#undef GGUF_SF
}

}  // namespace

// Plain C entry (bound with ctypes): as qmm_smallm_ex_launch (qmm_smallm.cu)
// over f32 x (M, K), M <= 8, and an f32 output (M, R), with the plan of
// ops/qmatmul.py smallm_f32_plan: `mt` the instance's token count, `split`
// (1..8, dividing the code rows into slices that are multiples of 16 rows)
// the cluster size along K, `smem` the dynamic shared memory. Returns the
// launch's CUDA error code.
extern "C" int qmm_smallm_f32_launch(const void* x, const void* qs,
                                     const void* scales, const void* offsets,
                                     const void* bias, void* out, int M,
                                     int K, int Kp, int R, int Rp, int gs,
                                     int zp, int nib4, int act_from, int mt,
                                     int split, int smem, int sbf16,
                                     void* stream) {
  return launch_f32_any<false>(x, qs, scales, offsets, bias, out, nullptr,
                               nullptr, M, K, Kp, R, Rp, gs, zp, 0, nib4,
                               act_from, mt, split, smem, sbf16,
                               static_cast<cudaStream_t>(stream));
}

// As qmm_smallm_lora_launch (qmm_smallm.cu) with f32 x, h (M, rk) and up
// (Rp, rk), rk > 0 a multiple of 16, and an f32 output.
extern "C" int qmm_smallm_f32_lora_launch(
    const void* x, const void* qs, const void* scales, const void* offsets,
    const void* bias, void* out, const void* h, const void* up, int M, int K,
    int Kp, int R, int Rp, int gs, int zp, int rk, int nib4, int act_from,
    int mt, int split, int smem, int sbf16, void* stream) {
  return launch_f32_any<true>(x, qs, scales, offsets, bias, out, h, up, M, K,
                              Kp, R, Rp, gs, zp, rk, nib4, act_from, mt,
                              split, smem, sbf16,
                              static_cast<cudaStream_t>(stream));
}
