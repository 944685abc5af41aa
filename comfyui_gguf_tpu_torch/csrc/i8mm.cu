// K4: w8a8 matmul — s8 activations x s8 weights, exact s32 accumulation.
//
// Replaces the Pallas kernel of comfyui_gguf_tpu/ops/i8mm.py
// (_make_i8_kernel, launched by pallas_i8mm and, on a depth-stacked weight,
// by pallas_i8mm_indexed; the stacked case is this kernel launched on block
// i's view).
//
//   acc[m, r] = sum_k xq[m, k] * wq[r, k]              (exact, s32)
//   out[m, r] = epi( float(acc) * xs[m] * ws[r] )
//
// What bounds it: int8 tensor-core operations at the flux token shapes
// (M = 512..4608, K = 3072..15360). Design: a persistent warp-specialised
// wgmma GEMM. One block a SM walks output tiles of 128 tokens x BN
// out-features (BN = 256, or 128 where that leaves a shorter last wave;
// ops/qmatmul.py i8mm_plan). A producer warp keeps a ring of shared tiles
// (3 stages at BN = 256, 4 at 128) full with TMA loads (128 bytes of k a
// stage: x (128, 128) and w (BN, 128), both K-major with the 128-byte
// swizzle, completing on mbarriers); two consumer warpgroups of 64 tokens each run
// wgmma m64nBNk32 s8 on them with both operands read from shared memory,
// so no byte passes through registers before the tensor cores. The weight
// is stored out-feature-major (quant/i8.py), the K-major form that s8
// wgmma takes. Ragged M and K < Kp are zero-filled by TMA (x's tensor map
// has the extents (M, K)). The f32 rescale in the plain version's order and
// the shared epilogue (bias, GELU-tanh from a column) run on the
// accumulator; each warpgroup writes its bf16 rows into a swizzled tile of
// shared memory, and one TMA store (clipped at M and R) takes them to
// global memory while the warpgroup goes on to the next tile's products.
// The tile's column scales, bias and row scales reach shared memory while
// its first products run. Left to global stores of the registers and to
// loads of the scales at the end of the tile, the epilogue took as long as
// the matrix work.
#include "common.cuh"
#include "tma.cuh"

using namespace gguf_cuda;

namespace {

constexpr int BM = 128;      // tokens per tile (2 consumer warpgroups x 64)
constexpr int BK = 128;      // bytes of k per stage (one swizzle row)
constexpr int THREADS = 384; // 2 consumer warpgroups + the producer's
constexpr int X_TILE = BM * BK;

template <int BN>
struct Shape {
  static constexpr int STAGES = BN == 256 ? 3 : 4;
  static constexpr int STAGE = X_TILE + BN * BK;
  // one warpgroup's 64 output rows, bf16, as BN / 64 column blocks of
  // (64 rows, 128 bytes) with the 128-byte swizzle
  static constexpr int OUT_WG = 64 * BN * 2;
  // one warpgroup's epilogue operands: ws and bias of the tile's BN
  // columns, xs of its 64 rows (f32)
  static constexpr int EPI_WG = (2 * BN + 64) * 4;
  static constexpr int SMEM =
      1024 + STAGES * STAGE + 2 * (OUT_WG + EPI_WG) + 128;
};

template <int BN>
__device__ __forceinline__ void wgmma_s8(int (&d)[BN / 2], uint64_t da,
                                         uint64_t db) {
  if constexpr (BN == 256) {
    wgmma_m64n256k32_s8(d, da, db);
  } else {
    wgmma_m64n128k32_s8(d, da, db);
  }
}

template <int BN>
__global__ void __launch_bounds__(THREADS, 1)
i8mm_kernel(const __grid_constant__ CUtensorMap tm_x,  // (M, K) s8
            const __grid_constant__ CUtensorMap tm_w,  // (Rp, Kp) s8
            const __grid_constant__ CUtensorMap tm_o,  // (M, R) bf16
            const float* __restrict__ xs,              // (M)
            const float* __restrict__ ws,              // (Rp)
            const float* __restrict__ bias,            // (R) | null
            int M, int R, int n_steps, int act_from, int m_tiles,
            int n_tiles) {
  using S = Shape<BN>;
  constexpr int STAGES = S::STAGES;
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
        const int m0 = (tile % m_tiles) * BM;
        const int r0 = (tile / m_tiles) * BN;
        for (int ks = 0; ks < n_steps; ++ks) {
          mbar_wait(&empty[stage], phase ^ 1);
          uint8_t* st = smem + stage * S::STAGE;
          mbar_arrive_expect_tx(&full[stage], S::STAGE);
          tma_load_2d(st, &tm_x, &full[stage], ks * BK, m0);
          tma_load_2d(st + X_TILE, &tm_w, &full[stage], ks * BK, r0);
          if (++stage == STAGES) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
  } else {
    // ---- consumers: warpgroup wg owns tokens 64*wg .. 64*wg+63 -----------
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
      const int m0 = (tile % m_tiles) * BM;
      const int r0 = (tile / m_tiles) * BN;
      int acc[BN / 2];
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) acc[i] = 0;
      int release = -1;  // stage whose wgmma may still be in flight

      for (int ks = 0; ks < n_steps; ++ks) {
        mbar_wait(&full[stage], phase);
        // uniform across the warp, so the descriptors stay uniform
        const uint32_t st = __shfl_sync(
            0xFFFFFFFFu, smem_base + stage * S::STAGE, 0);
        const uint64_t da = wgmma_desc_k128(st + wg * 64 * BK);
        const uint64_t db = wgmma_desc_k128(st + X_TILE);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BK / 32; ++kk)
          wgmma_s8<BN>(acc, da + 2 * kk, db + 2 * kk);
        wgmma_commit();
        if (ks == 0) {
          // the epilogue's operands, while the first products run (the
          // last tile's epilogue has read them: it ended at a barrier)
          for (int i = wtid; i < BN; i += 128) {
            const int n = r0 + i;
            ep[i] = n < R ? ws[n] : 0.0f;
            ep[BN + i] = bias != nullptr && n < R ? bias[n] : 0.0f;
          }
          if (wtid < 64) {
            const int m = m0 + wg * 64 + wtid;
            ep[2 * BN + wtid] = m < M ? xs[m] : 0.0f;
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
      // (acc * xs) * ws, rounded at each step as the plain version does,
      // then + bias and GELU from column act_from; columns past R are
      // clipped by the store
      auto value = [&](int v, float s, int c) {
        float y = __fmul_rn(__fmul_rn(__int2float_rn(v), s), ep[c]);
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

template <int BN>
cudaError_t launch(const void* xq, const void* xs, const void* wq,
                   const void* ws, const void* bias, void* out, int M, int K,
                   int Kp, int R, int Rp, int ldo, int act_from,
                   cudaStream_t stream) {
  using S = Shape<BN>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      i8mm_kernel<BN>, cudaFuncAttributeMaxDynamicSharedMemorySize, S::SMEM);
  if (attr != cudaSuccess) return attr;
  CUtensorMap tm_x, tm_w, tm_o;
  bool ok = make_map(&tm_x, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, xq, M, K, BM,
                     BK, CU_TENSOR_MAP_SWIZZLE_128B);
  ok = ok && make_map(&tm_w, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, wq, Rp, Kp,
                      BN, BK, CU_TENSOR_MAP_SWIZZLE_128B);
  // (M, R) rows ldo apart: the extents are (M, ldo), where the columns
  // past R are the rows' own padding
  ok = ok && make_map(&tm_o, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, out, M,
                      ldo, 64, 64, CU_TENSOR_MAP_SWIZZLE_128B);
  if (!ok) return cudaErrorInvalidValue;
  const int m_tiles = (M + BM - 1) / BM;
  const int n_tiles = (R + BN - 1) / BN;
  const int tiles = m_tiles * n_tiles;
  const int grid = tiles < sm_count() ? tiles : sm_count();
  i8mm_kernel<BN><<<grid, THREADS, S::SMEM, stream>>>(
      tm_x, tm_w, tm_o, static_cast<const float*>(xs),
      static_cast<const float*>(ws), static_cast<const float*>(bias), M, R,
      (K + BK - 1) / BK, act_from, m_tiles, n_tiles);
  return cudaGetLastError();
}

}  // namespace

// Dynamic shared memory of a launch at tile width bn (0 for another bn).
extern "C" int i8mm_smem_bytes(int bn) {
  return bn == 256 ? Shape<256>::SMEM : bn == 128 ? Shape<128>::SMEM : 0;
}

// Plain C entry (bound with ctypes). Shapes are checked by the Python
// wrapper: wq (Rp, Kp) with Kp % 128 == 0, Rp % 128 == 0, R <= Rp, K <= Kp,
// K % 16 == 0 and the output's row stride ldo >= R a multiple of 8 (TMA's
// 16-byte row strides), bn 128 or 256, every pointer 16-byte aligned.
// Returns cudaGetLastError().
extern "C" int i8mm_launch(const void* xq, const void* xs, const void* wq,
                           const void* ws, const void* bias, void* out, int M,
                           int K, int Kp, int R, int Rp, int ldo,
                           int act_from, int bn, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bn == 256)
    return static_cast<int>(launch<256>(xq, xs, wq, ws, bias, out, M, K, Kp,
                                        R, Rp, ldo, act_from, s));
  if (bn == 128)
    return static_cast<int>(launch<128>(xq, xs, wq, ws, bias, out, M, K, Kp,
                                        R, Rp, ldo, act_from, s));
  return static_cast<int>(cudaErrorInvalidValue);
}
