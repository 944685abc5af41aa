// K1/K2 for M <= 8: the weight-streaming split-K body of the fused
// dequant-matmul, both layouts (design note: qmm.cu). Replaces
// _make_nib4_kernel and _make_int8_kernel of
// comfyui_gguf_tpu/ops/qmatmul.py at the modulation projections' M = batch.
// A header: the bf16 instances are in qmm_smallm.cu and the f16 ones in
// qmm_smallm_f16.cu, so that the two compile side by side. The f32
// instances (dequant_dtype float32) are a body of their own,
// qmm_smallm_f32.cu, on f32 FMAs at the real token count.
//
// The operand type DT follows the reference's dequant_dtype: bf16 (DT_BF16)
// and f16 (DT_F16) round the dequantized weight and x to that type and
// multiply on mma.sync m16n8k16, whose N of 8 holds the 8 token rows
// whatever M is (rows past M are zeros). The f16 instances store an f32
// output; the wrapper rounds it once to the caller's dtype.
//
// Its LORA instances add the reference epilogue's rank term (the has_lora
// operands, qmatmul.py:117 and :181) once, in cluster rank 0 after the
// partial sums are reduced and before the bias and GELU: h (M, rk) · up[r]
// (up (Rp, rk), rank contiguous, bf16) as CUDA-core FMAs in a fixed order,
// so two launches still give the same bits. At M <= 8 the term reads
// R·rk·2 bytes of up (0.6 MB at R = 18432, r = 16) beside the packed weight
// (28 MB at Q4_K).
//
// Scale and offset planes come in float32 or bfloat16 (SBF16): a bf16
// plane halves their bytes (Q4_K reads 0.625 instead of 0.75 bytes a
// weight, and this body is bound by those bytes); each value is widened to
// f32 exactly, so the dequantized weight keeps its bits.
#pragma once

#include <cooperative_groups.h>
#include <type_traits>

#include "qmm_common.cuh"

namespace gguf_cuda {
namespace cg = cooperative_groups;

namespace {

enum : int { DT_BF16 = 0, DT_F16 = 1 };

// x's (and the LoRA operands') element type and the output type per DT
template <int DT>
using SmX = std::conditional_t<DT == DT_BF16, __nv_bfloat16, __half>;
template <int DT>
using SmOut = std::conditional_t<DT == DT_BF16, __nv_bfloat16, float>;

// elements 2j and 2j+1 of a row of SmX<DT>, widened to f32
template <int DT>
__device__ __forceinline__ float2 ld_pair(const SmX<DT>* p, int j) {
  if constexpr (DT == DT_BF16) {
    return __bfloat1622float2(reinterpret_cast<const __nv_bfloat162*>(p)[j]);
  } else {
    return __half22float2(reinterpret_cast<const __half2*>(p)[j]);
  }
}

constexpr int SM_THREADS = 256;
constexpr int SM_BN = 128;    // columns per strip: 2 warp columns x 64
constexpr int SM_MT = 8;      // rows of x (the mma N)
constexpr int SM_UNIT = 16;   // code rows a warp takes at a time
constexpr int SM_XPAD = 8;    // bf16 of padding per x row in shared memory

// The four A fragments' worth of one 16-row block: fills a[tile][0..3] for
// the warp's four 16-out-feature mma tiles from the thread's four 8-byte
// code loads (rows 2t, 2t+1, 2t+8, 2t+9; 8 adjacent out-features each).
template <bool FOLD, bool HAS_OFF, bool F16>
__device__ __forceinline__ void smallm_frags(
    uint32_t (&a)[4][4], const uint2 (&rows)[4], int nib_shift, uint32_t mask,
    uint32_t flip, const float (&s)[8], const float (&o)[8],
    float neg_base) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    // bytes [r k, r+1 k, r k+1, r+1 k+1] of tile i: out-features 2i, 2i+1
    const uint32_t sel = (i & 1) ? 0x7632u : 0x5410u;
    auto word = [&](const uint2& v) { return i < 2 ? v.x : v.y; };
    const uint32_t ab =
        ((__byte_perm(word(rows[0]), word(rows[1]), sel) >> nib_shift) &
         mask) ^ flip;
    const uint32_t cd =
        ((__byte_perm(word(rows[2]), word(rows[3]), sel) >> nib_shift) &
         mask) ^ flip;
    auto dq = [&](uint32_t w, int b) {
      const int c = 2 * i + (b & 1);
      return dequant1<FOLD, HAS_OFF>(magic_of_byte(w, b), s[c],
                                     HAS_OFF ? o[c] : 0.f, -s[c] * MAGIC,
                                     neg_base);
    };
    a[i][0] = pack_op<F16>(dq(ab, 0), dq(ab, 2));
    a[i][1] = pack_op<F16>(dq(ab, 1), dq(ab, 3));
    a[i][2] = pack_op<F16>(dq(cd, 0), dq(cd, 2));
    a[i][3] = pack_op<F16>(dq(cd, 1), dq(cd, 3));
  }
}

template <bool NIB4, bool HAS_OFF, bool LORA, bool SBF16, int DT>
__global__ void __launch_bounds__(SM_THREADS)
qmm_smallm_kernel(const SmX<DT>* __restrict__ x,        // (M, K)
                  const uint8_t* __restrict__ qs,       // (Kp/2 or Kp, Rp)
                  const void* __restrict__ scales,      // (Kp/gs, Rp)
                  const void* __restrict__ offsets,     // (Kp/gs, Rp) | null
                  const float* __restrict__ bias,       // (R) | null
                  SmOut<DT>* __restrict__ out,          // (M, R)
                  int M, int K, int Kp, int R, int Rp, int gs, float zp,
                  int act_from,
                  const SmX<DT>* __restrict__ lora_h,   // LORA: (M, rk)
                  const SmX<DT>* __restrict__ lora_up,  // LORA: (Rp, rk)
                  int lora_k) {  // rk, the rank columns
  using X = SmX<DT>;
  constexpr bool FOLD = NIB4 && HAS_OFF;
  constexpr int PLANES = NIB4 ? 2 : 1;
  constexpr int EPV = 16 / sizeof(X);  // elements of x a 16-byte piece
  extern __shared__ __align__(16) uint8_t smem_b[];
  cg::cluster_group cluster = cg::this_cluster();
  const int split = gridDim.y;
  const int rank = cluster.block_rank();  // cluster = the strip's K slices
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int half = Kp / 2;
  const int rows_blk = (NIB4 ? half : Kp) / split;  // code rows of the block
  const int jb = rank * rows_blk;
  const int pitch = rows_blk + SM_XPAD;  // elements per x row

  // shared memory: the x slice xs[plane][8][pitch] of X (rows past M and
  // columns past K are zeros), later reused as the four row lanes' partial
  // sums red[4][8][128] f32; then part[8][128], read by rank 0
  X* xs = reinterpret_cast<X*>(smem_b);
  const int x_bytes = PLANES * SM_MT * pitch * static_cast<int>(sizeof(X));
  const int red_bytes = 4 * SM_MT * SM_BN * 4;
  float* part = reinterpret_cast<float*>(
      smem_b + (x_bytes > red_bytes ? x_bytes : red_bytes));

  // warp (cw, rw): 64 columns n0 + 64 cw .., row lane rw of 4; the thread
  // loads the 8 columns col .. col+7, which are out-features 2i, 2i+1 of
  // row g (and g+8) of mma tile i
  const int cw = warp & 1;
  const int rw = warp >> 1;
  const int col = blockIdx.x * SM_BN + cw * 64 + g * 8;
  const float neg_base = NIB4 ? -(MAGIC + zp) : -(MAGIC + 128.0f);
  // acc[i][2h + c] = token 2t + c, column 8g + 2i + h
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[i][c] = 0.0f;

  auto load8 = [&](const void* plane, int grow, float (&v)[8]) {
    const size_t at = static_cast<size_t>(grow) * Rp + col;
    if constexpr (SBF16) {  // 8 bf16 in one 16-byte load, widened exactly
      const uint4 u = __ldg(reinterpret_cast<const uint4*>(
          static_cast<const __nv_bfloat16*>(plane) + at));
      const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        v[2 * i] = __uint_as_float(w[i] << 16);
        v[2 * i + 1] = __uint_as_float(w[i] & 0xFFFF0000u);
      }
    } else {
      const float4* p =
          reinterpret_cast<const float4*>(static_cast<const float*>(plane) +
                                          at);
      const float4 a = __ldg(p), b = __ldg(p + 1);
      v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
      v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
    }
  };
  // the B fragment of token g: x[g][k0 + 2t .. +1] and x[g][k0 + 2t + 8 ..]
  auto x_frag = [&](int plane, int k0, uint32_t& b0, uint32_t& b1) {
    const uint32_t* p = reinterpret_cast<const uint32_t*>(
        xs + (plane * SM_MT + g) * pitch + k0 + 2 * t);
    b0 = p[0];
    b1 = p[4];
  };

  auto load_codes = [&](int u, uint2 (&c)[4]) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {  // rows 2t, 2t+1, 2t+8, 2t+9 of the unit
      const int row = jb + u * SM_UNIT + 2 * t + (q & 1) + (q >> 1) * 8;
      c[q] = __ldg(reinterpret_cast<const uint2*>(
          qs + static_cast<size_t>(row) * Rp + col));
    }
  };

  const int n_units = rows_blk / SM_UNIT;
  uint2 codes[4], next[4];
  if (rw < n_units) load_codes(rw, codes);

  // the x slice is copied while the first unit's loads are in flight, in
  // 16-byte pieces (EPV k of one row); rows_blk and K are multiples of 8
  const int vec_row = rows_blk / EPV;
  for (int i = tid; i < PLANES * SM_MT * vec_row; i += SM_THREADS) {
    const int jj = (i % vec_row) * EPV;
    const int m = (i / vec_row) % SM_MT;
    const int p = i / (vec_row * SM_MT);
    const int k = p * half + jb + jj;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (m < M && k < K) {
      v = __ldg(reinterpret_cast<const uint4*>(
          x + static_cast<size_t>(m) * K + k));
    }
    *reinterpret_cast<uint4*>(xs + (p * SM_MT + m) * pitch + jj) = v;
  }
  __syncthreads();

  // units of 16 code rows, dealt to the four row lanes in turn; the next
  // unit's codes are in flight while this one is unpacked (prefetching the
  // scales too costs registers, and it is the resident warps that hide the
  // latency)
  for (int u = rw; u < n_units; u += 4) {
    if (u + 4 < n_units) load_codes(u + 4, next);
    // the unit's scale / offset rows: the low nibbles' (or int8) group,
    // then the high nibbles' group Kp/2 further on
    const int grow = (jb + u * SM_UNIT) / gs;
    float sc[PLANES][8], of[PLANES][8];
#pragma unroll
    for (int p = 0; p < PLANES; ++p) {
      load8(scales, p * (half / gs) + grow, sc[p]);
      if constexpr (HAS_OFF) load8(offsets, p * (half / gs) + grow, of[p]);
    }
    uint32_t a[4][4], b0, b1;
#pragma unroll
    for (int p = 0; p < PLANES; ++p) {
      smallm_frags<FOLD, HAS_OFF, DT == DT_F16>(
          a, codes, 4 * p, NIB4 ? 0x0F0F0F0Fu : 0xFFFFFFFFu,
          NIB4 ? 0u : 0x80808080u, sc[p], of[p], neg_base);
      x_frag(p, u * SM_UNIT, b0, b1);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if constexpr (DT == DT_F16) {
          mma_f16_16816(acc[i], a[i], b0, b1);
        } else {
          mma_bf16_16816(acc[i], a[i], b0, b1);
        }
      }
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) codes[q] = next[q];
  }

  // block reduction in a fixed order: the four row lanes through shared
  // memory. acc[i][2h + c] = sum for token 2t + c, column 8g + 2i + h.
  __syncthreads();  // every warp is done with the x slice
  float* red = reinterpret_cast<float*>(smem_b);
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int m = 2 * t + (e & 1);
      const int c = cw * 64 + 8 * g + 2 * i + (e >> 1);
      red[(rw * SM_MT + m) * SM_BN + c] = acc[i][e];
    }
  __syncthreads();
  for (int i = tid; i < SM_MT * SM_BN; i += SM_THREADS) {
    float v = 0.0f;
#pragma unroll
    for (int r = 0; r < 4; ++r) v += red[r * SM_MT * SM_BN + i];
    part[i] = v;
  }
  cluster.sync();  // every rank's partial sums are in its shared memory
  if (rank == 0) {
    const int n0 = blockIdx.x * SM_BN;
    for (int i = tid; i < SM_MT * (SM_BN / 2); i += SM_THREADS) {
      const int m = i / (SM_BN / 2);
      const int c = (i % (SM_BN / 2)) * 2;
      // all ranks' loads first (a cluster has at most 8), then the sum in
      // rank order
      float2 p[8];
#pragma unroll
      for (int rk = 0; rk < 8; ++rk) {
        p[rk] = rk < split
                    ? *reinterpret_cast<const float2*>(
                          cluster.map_shared_rank(part, rk) + m * SM_BN + c)
                    : make_float2(0.f, 0.f);
      }
      float v0 = 0.0f, v1 = 0.0f;
#pragma unroll
      for (int rk = 0; rk < 8; ++rk) {
        v0 += p[rk].x;
        v1 += p[rk].y;
      }
      if constexpr (LORA) {
        if (m < M) {  // + h[m] . up[n0 + c], h[m] . up[n0 + c + 1]
          const X* hp = lora_h + static_cast<size_t>(m) * lora_k;
          const X* u0 = lora_up + static_cast<size_t>(n0 + c) * lora_k;
          const X* u1 = u0 + lora_k;
          float d0 = 0.0f, d1 = 0.0f;
          for (int j = 0; j < lora_k / 2; ++j) {
            const float2 hv = ld_pair<DT>(hp, j);
            const float2 a = ld_pair<DT>(u0, j);
            const float2 b = ld_pair<DT>(u1, j);
            d0 = __fmaf_rn(hv.y, a.y, __fmaf_rn(hv.x, a.x, d0));
            d1 = __fmaf_rn(hv.y, b.y, __fmaf_rn(hv.x, b.x, d1));
          }
          v0 = __fadd_rn(v0, d0);
          v1 = __fadd_rn(v1, d1);
        }
      }
      epilogue_store2(out, bias, act_from, M, R, m, n0 + c, v0, v1);
    }
  }
  cluster.sync();  // no rank leaves while rank 0 reads its shared memory
}

// dynamic shared memory of the small-M body with x elements of `esize`
// bytes (the wrapper's smallm_plan states the same arithmetic)
int smallm_smem(bool nib4, int Kp, int split, int esize) {
  const int rows_blk = (nib4 ? Kp / 2 : Kp) / split;
  const int x_bytes = (nib4 ? 2 : 1) * SM_MT * (rows_blk + SM_XPAD) * esize;
  const int red_bytes = 4 * SM_MT * SM_BN * 4;
  return (x_bytes > red_bytes ? x_bytes : red_bytes) + SM_MT * SM_BN * 4;
}

template <bool NIB4, bool HAS_OFF, bool LORA, bool SBF16, int DT>
cudaError_t launch_smallm(const void* x, const void* qs, const void* scales,
                          const void* offsets, const void* bias, void* out,
                          const void* h, const void* up, int M, int K, int Kp,
                          int R, int Rp, int gs, int zp, int rk, int act_from,
                          int split, cudaStream_t stream) {
  using X = SmX<DT>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      qmm_smallm_kernel<NIB4, HAS_OFF, LORA, SBF16, DT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, 200 * 1024);
  if (attr != cudaSuccess) return attr;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((R + SM_BN - 1) / SM_BN, split, 1);
  cfg.blockDim = dim3(SM_THREADS, 1, 1);
  cfg.dynamicSmemBytes =
      smallm_smem(NIB4, Kp, split, static_cast<int>(sizeof(X)));
  cfg.stream = stream;
  cudaLaunchAttribute at[1];
  at[0].id = cudaLaunchAttributeClusterDimension;
  at[0].val.clusterDim.x = 1;
  at[0].val.clusterDim.y = split;
  at[0].val.clusterDim.z = 1;
  cfg.attrs = at;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(
      &cfg, qmm_smallm_kernel<NIB4, HAS_OFF, LORA, SBF16, DT>,
      static_cast<const X*>(x), static_cast<const uint8_t*>(qs), scales,
      offsets, static_cast<const float*>(bias),
      static_cast<SmOut<DT>*>(out), M, K, Kp, R, Rp, gs,
      static_cast<float>(zp), act_from, static_cast<const X*>(h),
      static_cast<const X*>(up), rk);
}

// The instance for the layout, the offsets and the scale planes' type.
template <bool LORA, int DT>
int launch_smallm_any(const void* x, const void* qs, const void* scales,
                      const void* offsets, const void* bias, void* out,
                      const void* h, const void* up, int M, int K, int Kp,
                      int R, int Rp, int gs, int zp, int rk, int nib4,
                      int act_from, int split, int sbf16, cudaStream_t s) {
#define GGUF_SMALLM(NIB, OFF, SB)                                          \
  launch_smallm<NIB, OFF, LORA, SB, DT>(x, qs, scales, offsets, bias, out, \
                                        h, up, M, K, Kp, R, Rp, gs, zp, rk, \
                                        act_from, split, s)
#define GGUF_SMALLM_SB(NIB, OFF) \
  (sbf16 ? GGUF_SMALLM(NIB, OFF, true) : GGUF_SMALLM(NIB, OFF, false))
  if (nib4)
    return offsets ? GGUF_SMALLM_SB(true, true) : GGUF_SMALLM_SB(true, false);
  return offsets ? GGUF_SMALLM_SB(false, true)
                 : GGUF_SMALLM_SB(false, false);
#undef GGUF_SMALLM_SB
#undef GGUF_SMALLM
}


}  // namespace
}  // namespace gguf_cuda
