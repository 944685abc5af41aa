// The persistent warp-specialised TMA + wgmma GEMM shared by the w8a8
// matmul (K4, i8mm.cu) and the GEMM rate probes (K8, gemm_probe.cu). A
// header, so that both sources instantiate one body.
//
//   acc[m, r] = sum_k x[m, k] * w[k, r]     (s8: exact s32; bf16: f32)
//   out[m, r] = bf16( epi( (float(acc) * xs[m]) * ws[r] ) )
//
// One block a SM walks output tiles of 128 rows x BN columns (BN = 256 or
// 128), m fastest. A producer warp keeps a ring of shared tiles (3 stages
// at BN = 256, 4 at 128) full with TMA loads of 128 bytes of k a stage:
// x (128, 128 B) K-major, and w either (BN, 128 B) K-major (s8: the
// out-feature-major codes, the only B form s8 wgmma reads) or BN / 64
// blocks of (64 k, 128 B) MN-major (bf16: w (K, R) as stored, read with the
// transpose bit), all with the 128-byte swizzle, completing on mbarriers.
// Two consumer warpgroups of 64 rows each run wgmma m64nBNk32 s8 (or
// m64nBNk16 bf16) on them with both operands read from shared memory, so
// no byte passes through registers before the tensor cores. Ragged M, R and
// K are zero-filled by TMA. The f32 rescale in the plain version's order
// (a null xs or ws is 1, exactly) and the shared epilogue (bias, GELU-tanh
// from a column) run on the accumulator; each warpgroup writes its bf16
// rows into a swizzled shared tile, and one TMA store (clipped at M and R)
// takes them to global memory while the warpgroup goes on to the next
// tile's products. The tile's column scales, bias and row scales reach
// shared memory while its first products run. Left to global stores of the
// registers and to loads of the scales at the end of the tile, the
// epilogue took as long as the matrix work.
//
// The LoRA instance (s8 only, LORA = true) adds the rank term of the
// reference's shared epilogue between the rescale and the bias:
//   out[m, r] = bf16( epi( (float(acc) * xs[m]) * ws[r] + h[m] . up[r] ) )
// with h (M, rk) and up (Rp, rk) bf16, rk a multiple of 16. The s32 and f32
// accumulators of wgmma share one register layout, so after the K loop each
// warpgroup rescales its fragment to f32 in place and issues bf16 m64nBNk16
// products onto it. The rank chunks stream through the same ring, ceil(rk /
// 64) more stages a tile: 64 bf16 of rank are the 128 bytes of a stage row,
// so an h tile is an x tile and an up tile a w tile, K-major with the
// 128-byte swizzle. The unpatched instances compile as before.
#pragma once

#include "common.cuh"
#include "tma.cuh"

namespace gguf_cuda {
namespace {

constexpr int GM_BM = 128;       // rows per tile (2 consumer warpgroups x 64)
constexpr int GM_BK = 128;       // bytes of k per stage (one swizzle row)
constexpr int GM_THREADS = 384;  // 2 consumer warpgroups + the producer's
constexpr int GM_X_TILE = GM_BM * GM_BK;

template <int BN>
struct GemmShape {
  static constexpr int STAGES = BN == 256 ? 3 : 4;
  static constexpr int STAGE = GM_X_TILE + BN * GM_BK;
  // one warpgroup's 64 output rows, bf16, as BN / 64 column blocks of
  // (64 rows, 128 bytes) with the 128-byte swizzle
  static constexpr int OUT_WG = 64 * BN * 2;
  // one warpgroup's epilogue operands: ws and bias of the tile's BN
  // columns, xs of its 64 rows (f32)
  static constexpr int EPI_WG = (2 * BN + 64) * 4;
  static constexpr int SMEM =
      1024 + STAGES * STAGE + 2 * (OUT_WG + EPI_WG) + 128;
};

// The operand types: how a stage's w tile is loaded and how its products
// are issued. A and B are shared-state-space addresses of the stage's x
// and w tiles.
template <bool BF16, int BN>
struct GemmOps;

template <int BN>
struct GemmOps<false, BN> {  // s8 x s8 -> s32; w (Rp, Kp), K contiguous
  using Acc = int;
  static __device__ __forceinline__ void load_w(uint8_t* dst, const void* tm,
                                                uint64_t* bar, int ks,
                                                int r0) {
    tma_load_2d(dst, tm, bar, ks * GM_BK, r0);
  }
  static __device__ __forceinline__ void mma(int (&acc)[BN / 2], uint32_t a,
                                             uint32_t b) {
    const uint64_t da = wgmma_desc_k128(a);
    const uint64_t db = wgmma_desc_k128(b);
#pragma unroll
    for (int kk = 0; kk < GM_BK / 32; ++kk) {
      if constexpr (BN == 256) {
        wgmma_m64n256k32_s8(acc, da + 2 * kk, db + 2 * kk);
      } else {
        wgmma_m64n128k32_s8(acc, da + 2 * kk, db + 2 * kk);
      }
    }
  }
  static __device__ __forceinline__ float to_float(int v) {
    return __int2float_rn(v);
  }
};

template <int BN>
struct GemmOps<true, BN> {  // bf16 x bf16 -> f32; w (K, R), R contiguous
  using Acc = float;
  static __device__ __forceinline__ void load_w(uint8_t* dst, const void* tm,
                                                uint64_t* bar, int ks,
                                                int r0) {
#pragma unroll
    for (int c = 0; c < BN / 64; ++c)
      tma_load_2d(dst + c * (64 * 128), tm, bar, r0 + 64 * c, ks * 64);
  }
  static __device__ __forceinline__ void mma(float (&acc)[BN / 2], uint32_t a,
                                             uint32_t b) {
    const uint64_t da = wgmma_desc_k128(a);
#pragma unroll
    for (int kk = 0; kk < GM_BK / 32; ++kk) {
      // 16 k are 16 rows of each 64-column block; blocks lie 8 KB apart
      const uint64_t db = wgmma_desc_mn128(b + kk * 16 * 128, 64 * 128);
      if constexpr (BN == 256) {
        wgmma_m64n256k16_ss_tb(acc, da + 2 * kk, db);
      } else {
        wgmma_m64n128k16_ss_tb(acc, da + 2 * kk, db);
      }
    }
  }
  static __device__ __forceinline__ float to_float(float v) { return v; }
};

template <bool BF16, int BN, bool LORA>
__global__ void __launch_bounds__(GM_THREADS, 1)
gemm_wgmma_kernel(const __grid_constant__ CUtensorMap tm_x,  // (M, K)
                  const __grid_constant__ CUtensorMap tm_w,  // see GemmOps
                  const __grid_constant__ CUtensorMap tm_o,  // (M, R) bf16
                  const float* __restrict__ xs,  // (M) at xs_stride | null
                  const float* __restrict__ ws,  // (R) | null
                  const float* __restrict__ bias,  // (R) | null
                  int xs_stride, int M, int R, int n_steps, int act_from,
                  int m_tiles, int n_tiles,
                  const __grid_constant__ CUtensorMap tm_h,   // LORA: (M, rk)
                  const __grid_constant__ CUtensorMap tm_up,  // LORA: (Rp, rk)
                  int rk) {
  static_assert(!(LORA && BF16), "the rank term is an s8 instance");
  using S = GemmShape<BN>;
  using Op = GemmOps<BF16, BN>;
  constexpr int STAGES = S::STAGES;
  // stages a tile: the K steps, then (LORA) the rank chunks of 64
  const int t_steps = n_steps + (LORA ? (rk + 63) / 64 : 0);
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t{1023});
  uint8_t* out_s = smem + STAGES * S::STAGE;
  float* epi_s = reinterpret_cast<float*>(out_s + 2 * S::OUT_WG);
  uint64_t* full = reinterpret_cast<uint64_t*>(
      reinterpret_cast<uint8_t*>(epi_s) + 2 * S::EPI_WG);
  uint64_t* empty = full + STAGES;

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 256);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (warp >= 8) {
    // ---- producer warpgroup: one lane keeps the ring full ----------------
    // The block starts at 168 registers a thread (65536 / 384); the three
    // idle warps are part of that pool, so the consumers' request below
    // can complete (40 * 128 + 232 * 256 = 168 * 384).
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (warp == 8 && lane == 0) {
      int stage = 0;
      uint32_t phase = 0;
      for (int tile = blockIdx.x; tile < m_tiles * n_tiles;
           tile += gridDim.x) {
        const int m0 = (tile % m_tiles) * GM_BM;
        const int r0 = (tile / m_tiles) * BN;
        for (int ks = 0; ks < t_steps; ++ks) {
          mbar_wait(&empty[stage], phase ^ 1);
          uint8_t* st = smem + stage * S::STAGE;
          mbar_arrive_expect_tx(&full[stage], S::STAGE);
          if (LORA && ks >= n_steps) {
            // rank chunk: h rows as the x tile, up rows as the w tile
            const int c = (ks - n_steps) * 64;
            tma_load_2d(st, &tm_h, &full[stage], c, m0);
            tma_load_2d(st + GM_X_TILE, &tm_up, &full[stage], c, r0);
          } else {
            tma_load_2d(st, &tm_x, &full[stage],
                        ks * GM_BK / (BF16 ? 2 : 1), m0);
            Op::load_w(st + GM_X_TILE, &tm_w, &full[stage], ks, r0);
          }
          if (++stage == STAGES) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
  } else {
    // ---- consumers: warpgroup wg owns rows 64*wg .. 64*wg+63 -------------
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int wg = warp >> 2;
    const int w = warp & 3;
    const int g = lane >> 2;
    const int t = lane & 3;
    const uint32_t smem_base = smem_u32(smem);
    uint8_t* ot = out_s + wg * S::OUT_WG;
    float* ep = epi_s + wg * (S::EPI_WG / 4);  // ws [BN], bias [BN], xs [64]
    const int wtid = tid & 127;
    const bool leader = wtid == 0;  // issues the warpgroup's stores

    int stage = 0;
    uint32_t phase = 0;
    for (int tile = blockIdx.x; tile < m_tiles * n_tiles;
         tile += gridDim.x) {
      const int m0 = (tile % m_tiles) * GM_BM;
      const int r0 = (tile / m_tiles) * BN;
      typename Op::Acc acc[BN / 2];
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) acc[i] = 0;
      int release = -1;  // stage whose wgmma may still be in flight

      for (int ks = 0; ks < n_steps; ++ks) {
        mbar_wait(&full[stage], phase);
        // uniform across the warp, so the descriptors stay uniform
        const uint32_t st = __shfl_sync(
            0xFFFFFFFFu, smem_base + stage * S::STAGE, 0);
        wgmma_fence();
        Op::mma(acc, st + wg * 64 * GM_BK, st + GM_X_TILE);
        wgmma_commit();
        if (ks == 0) {
          // the epilogue's operands, while the first products run (the
          // last tile's epilogue has read them: it ended at a barrier)
          for (int i = wtid; i < BN; i += 128) {
            const int n = r0 + i;
            ep[i] = ws == nullptr ? 1.0f : n < R ? ws[n] : 0.0f;
            ep[BN + i] = bias != nullptr && n < R ? bias[n] : 0.0f;
          }
          if (wtid < 64) {
            const int m = m0 + wg * 64 + wtid;
            ep[2 * BN + wtid] = xs == nullptr ? 1.0f
                                : m < M ? xs[static_cast<size_t>(m) *
                                             xs_stride]
                                        : 0.0f;
          }
        }
        // the group of the step before has retired: its stage is free
        wgmma_wait<1>();
        if (release >= 0) mbar_arrive(&empty[release]);
        release = stage;
        if (++stage == STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
      wgmma_wait<0>();
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) reg_fence(acc[i]);
      mbar_arrive(&empty[release]);

      // acc[4i + 2h + c] = out[m + 8h][r0 + 8i + 2t + c]; rows m, m + 8
      // are rows r, r + 8 of the warpgroup's output tile
      const int r = w * 16 + g;
      if constexpr (LORA) {
        if (leader) bulk_wait_read<0>();  // the last tile's rows left ot
        named_bar_sync(1 + wg, 128);      // ... and ep is written
        const float xs0 = ep[2 * BN + r];
        const float xs1 = ep[2 * BN + r + 8];
        // (acc * xs) * ws in place, rounded as the plain version does
        float f[BN / 2];
#pragma unroll
        for (int i = 0; i < BN / 2; ++i) {
          const int n = 8 * (i >> 2) + 2 * t + (i & 1);
          f[i] = __fmul_rn(__fmul_rn(Op::to_float(acc[i]),
                                     (i & 2) ? xs1 : xs0),
                           ep[n]);
        }
        // + h . up over the rank chunks, on the f32 fragment
        int rel = -1;
        for (int c = 0; c < rk; c += 64) {
          const int nk = (rk - c) / 16 < 4 ? (rk - c) / 16 : 4;
          mbar_wait(&full[stage], phase);
          const uint32_t st = __shfl_sync(
              0xFFFFFFFFu, smem_base + stage * S::STAGE, 0);
          const uint64_t da = wgmma_desc_k128(st + wg * 64 * GM_BK);
          const uint64_t db = wgmma_desc_k128(st + GM_X_TILE);
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
            if (kk < nk) {
              if constexpr (BN == 256) {
                wgmma_m64n256k16_ss(f, da + 2 * kk, db + 2 * kk);
              } else {
                wgmma_m64n128k16_ss(f, da + 2 * kk, db + 2 * kk, 1);
              }
            }
          }
          wgmma_commit();
          wgmma_wait<1>();
          if (rel >= 0) mbar_arrive(&empty[rel]);
          rel = stage;
          if (++stage == STAGES) {
            stage = 0;
            phase ^= 1;
          }
        }
        wgmma_wait<0>();
#pragma unroll
        for (int i = 0; i < BN / 2; ++i) reg_fence(f[i]);
        if (rel >= 0) mbar_arrive(&empty[rel]);
        // + bias, then GELU from column act_from
        auto post = [&](float y, int c) {
          if (bias != nullptr) y = __fadd_rn(y, ep[BN + c]);
          return act_from >= 0 && r0 + c >= act_from ? gelu_tanh(y) : y;
        };
#pragma unroll
        for (int i = 0; i < BN / 8; ++i) {
          const int n = 8 * i + 2 * t;
          uint8_t* p = ot + (i >> 3) * (64 * 128) + r * 128 +
                       (((i & 7) ^ (r & 7)) << 4) + 4 * t;
          *reinterpret_cast<uint32_t*>(p) =
              pack_bf16x2(post(f[4 * i], n), post(f[4 * i + 1], n + 1));
          *reinterpret_cast<uint32_t*>(p + 8 * 128) =
              pack_bf16x2(post(f[4 * i + 2], n), post(f[4 * i + 3], n + 1));
        }
      } else {
        // (acc * xs) * ws, rounded at each step as the plain version does,
        // then + bias and GELU from column act_from; columns past R are
        // clipped by the store
        auto value = [&](typename Op::Acc v, float s, int c) {
          float y = __fmul_rn(__fmul_rn(Op::to_float(v), s), ep[c]);
          if (bias != nullptr) y = __fadd_rn(y, ep[BN + c]);
          return act_from >= 0 && r0 + c >= act_from ? gelu_tanh(y) : y;
        };
        if (leader) bulk_wait_read<0>();  // the last tile's rows have left ot
        named_bar_sync(1 + wg, 128);      // ... and ep is written
        const float xs0 = ep[2 * BN + r];
        const float xs1 = ep[2 * BN + r + 8];
#pragma unroll
        for (int i = 0; i < BN / 8; ++i) {
          const int n = 8 * i + 2 * t;  // the tile's column
          // 16-byte unit i % 8 of row r in column block i / 8, swizzled by
          // r % 8 (the same for row r + 8)
          uint8_t* p = ot + (i >> 3) * (64 * 128) + r * 128 +
                       (((i & 7) ^ (r & 7)) << 4) + 4 * t;
          *reinterpret_cast<uint32_t*>(p) =
              pack_bf16x2(value(acc[4 * i], xs0, n),
                          value(acc[4 * i + 1], xs0, n + 1));
          *reinterpret_cast<uint32_t*>(p + 8 * 128) =
              pack_bf16x2(value(acc[4 * i + 2], xs1, n),
                          value(acc[4 * i + 3], xs1, n + 1));
        }
      }
      fence_proxy_async();
      named_bar_sync(1 + wg, 128);
      if (leader) {
#pragma unroll
        for (int c = 0; c < BN / 64; ++c)
          tma_store_2d(&tm_o, ot + c * (64 * 128), r0 + 64 * c,
                       m0 + 64 * wg);
        bulk_commit();
      }
    }
    if (leader) bulk_wait<0>();  // the stores have read shared memory
  }
}

// Tensor map of the (M, R) bf16 output whose rows lie ldo apart: the
// extents are (M, ldo), where the columns past R are the rows' own padding
// (the store clips at them).
inline bool make_out_map(CUtensorMap* tm, void* out, int M, int ldo) {
  return make_map(tm, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, out, M, ldo, 64,
                  64, CU_TENSOR_MAP_SWIZZLE_128B);
}

// Launches one persistent grid (at most one block a SM) over the maps:
// x (M, K) with a box of 128 rows x 128 bytes, w as GemmOps reads it, the
// output from make_out_map. n_steps = ceil(K bytes / 128). LORA: tm_h and
// tm_up from make_lora_maps, rk their rank (a multiple of 16).
template <bool BF16, int BN, bool LORA = false>
cudaError_t launch_gemm(const CUtensorMap& tm_x, const CUtensorMap& tm_w,
                        const CUtensorMap& tm_o, const void* xs,
                        int xs_stride, const void* ws, const void* bias,
                        int M, int R, int n_steps, int act_from,
                        cudaStream_t stream,
                        const CUtensorMap& tm_h = CUtensorMap{},
                        const CUtensorMap& tm_up = CUtensorMap{},
                        int rk = 0) {
  using S = GemmShape<BN>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      gemm_wgmma_kernel<BF16, BN, LORA>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, S::SMEM);
  if (attr != cudaSuccess) return attr;
  const int m_tiles = (M + GM_BM - 1) / GM_BM;
  const int n_tiles = (R + BN - 1) / BN;
  const int tiles = m_tiles * n_tiles;
  const int grid = tiles < sm_count() ? tiles : sm_count();
  gemm_wgmma_kernel<BF16, BN, LORA><<<grid, GM_THREADS, S::SMEM, stream>>>(
      tm_x, tm_w, tm_o, static_cast<const float*>(xs),
      static_cast<const float*>(ws), static_cast<const float*>(bias),
      xs_stride, M, R, n_steps, act_from, m_tiles, n_tiles, tm_h, tm_up, rk);
  return cudaGetLastError();
}

// Tensor maps of the LoRA instance's rank operands: h (M, rk) in boxes of
// 128 rows x 64 bf16 (an x tile), up (Rp, rk) in boxes of BN rows x 64 bf16
// (a w tile), both with the 128-byte swizzle; columns past rk are zeros.
inline bool make_lora_maps(CUtensorMap* tm_h, CUtensorMap* tm_up,
                           const void* h, const void* up, int M, int Rp,
                           int rk, int bn) {
  return make_map(tm_h, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, h, M, rk, GM_BM,
                  64, CU_TENSOR_MAP_SWIZZLE_128B) &&
         make_map(tm_up, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, up, Rp, rk, bn,
                  64, CU_TENSOR_MAP_SWIZZLE_128B);
}

}  // namespace
}  // namespace gguf_cuda
