// The wgmma body of the fused dequant-matmul (design note: qmm.cu). A
// header so that the nib4 instances (qmm.cu), the int8 instances
// (qmm_int8.cu) and their LoRA instances (qmm_lora.cu, qmm_int8_lora.cu)
// compile side by side. Each comes with float32 or bfloat16 scale planes
// (SBF16), persistent (KSPLIT false) or with its K split over a
// thread-block cluster of `split` blocks (KSPLIT true; the persistent
// instances carry none of the cluster's code), and with bf16 operands or,
// F16 (dequant_dtype float16), f16 operands: the weight is rounded to f16,
// x arrives as f16, the wgmma is f32.f16.f16, and the output is written in
// f32 so that the wrapper rounds once to the caller's dtype (the f16
// instances live in qmm_f16.cu, qmm_int8_f16.cu and their LoRA sources).
#pragma once

#include <type_traits>

#include "qmm_common.cuh"
#include "tma.cuh"

namespace gguf_cuda {
namespace {

constexpr int WG_BR = 128;      // out-features per tile (2 warpgroups x 64)
constexpr int WG_BM = 128;      // tokens per wgmma (its N); a tile has NT
constexpr int WG_STAGES = 5;
constexpr int WG_THREADS = 384; // 2 consumer warpgroups + the producer's
constexpr int WG_XSUB = WG_BM * 64;      // 128 tokens x 32 bf16, 64-B swizzle
constexpr int WG_S_BOX = 2 * WG_BR * 4;  // up to 2 f32 scale rows a range
constexpr int WG_S_TILE = 2 * WG_S_BOX;  // two k ranges
constexpr int WG_SPLIT_MAX = 8;          // a portable cluster

// the output type: bf16 for the bf16 instances, f32 for the f16 ones
template <bool F16>
using WgOut = std::conditional_t<F16, float, __nv_bfloat16>;

template <bool NIB4, int NT>
struct WgShape {
  static constexpr int QROWS = NIB4 ? 32 : 64;  // code rows per K step
  static constexpr int Q_TILE = QROWS * WG_BR;
  static constexpr int X_RANGE = NT * WG_XSUB;  // x of one k range
  static constexpr int STAGE = 2 * X_RANGE + Q_TILE + 2 * WG_S_TILE;
  static constexpr int SMEM = 1024 + WG_STAGES * STAGE + 128;
};

__device__ __forceinline__ uint32_t lds_u16(uint32_t addr) {
  uint16_t v;
  asm volatile("ld.shared.u16 %0, [%1];\n" : "=h"(v) : "r"(addr));
  return v;
}

__device__ __forceinline__ float2 lds_f32x2(uint32_t addr) {
  float2 v;
  asm volatile("ld.shared.v2.f32 {%0, %1}, [%2];\n"
               : "=f"(v.x), "=f"(v.y) : "r"(addr));
  return v;
}

__device__ __forceinline__ uint32_t ldg_u32(const __nv_bfloat16* p) {
  return __ldg(reinterpret_cast<const unsigned int*>(p));
}

// The scales (or offsets) of two adjacent out-features, widened to f32:
// a bf16 value is the high half of its f32, so the widening is exact.
template <bool SBF16>
__device__ __forceinline__ float2 lds_scale2(uint32_t addr) {
  if constexpr (SBF16) {
    uint32_t v;
    asm volatile("ld.shared.u32 %0, [%1];\n" : "=r"(v) : "r"(addr));
    return make_float2(__uint_as_float(v << 16),
                       __uint_as_float(v & 0xFFFF0000u));
  } else {
    return lds_f32x2(addr);
  }
}

// LORA: after the K loop, acc += up_tile · h_tileᵀ, the reference epilogue's
// rank term. up (Rp, rk) is the A operand, fed from registers like the
// weight (each thread loads its two out-features' rank values from global
// memory, in the out-feature order of its accumulator rows); h (M, rk) is
// the B operand, streamed through the ring exactly as x is (two 32-column
// boxes of 64 rank columns a stage, ceil(rk / 64) more stages a tile).
//
// split > 1: the grid holds `split` blocks per output tile, one cluster
// along K, and each walks Kp / 64 / split steps of K (rank r the r-th
// slice); rank 0 alone adds the LoRA term. After the K loop every rank
// stores its f32 accumulator in its own shared memory (the ring is idle
// by then: a block has one tile), the cluster synchronises, and rank r
// sums slice r of the tile's accumulator groups over the ranks in rank
// order, reading the others through distributed shared memory, and runs
// the epilogue on that slice. No atomics and no workspace: two launches
// give the same bits. Without KSPLIT: persistent blocks, no cluster.
template <bool NIB4, bool HAS_OFF, int NT, bool LORA, bool SBF16,
          bool KSPLIT, bool F16>
__global__ void __launch_bounds__(WG_THREADS, 1)
qmm_wgmma_kernel(const __grid_constant__ CUtensorMap tm_x,  // (M, K)
                 const __grid_constant__ CUtensorMap tm_q,  // codes, u8
                 const __grid_constant__ CUtensorMap tm_s,  // scales
                 const __grid_constant__ CUtensorMap tm_o,  // offsets
                 const float* __restrict__ bias,            // (R) | null
                 WgOut<F16>* __restrict__ out,              // (M, R)
                 int M, int Kp, int R, int gs, float zp, int act_from,
                 int m_tiles, int n_tiles,
                 const __grid_constant__ CUtensorMap tm_h,  // LORA: (M, rk)
                 // LORA: (Rp, rk), bf16 or (F16) f16 bits
                 const __nv_bfloat16* __restrict__ lora_up,
                 int rk, int split_arg) {
  using S = WgShape<NIB4, NT>;
  constexpr bool FOLD = NIB4 && HAS_OFF;
  constexpr int ES = SBF16 ? 2 : 4;  // bytes of a scale / offset
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t{1023});
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + WG_STAGES * S::STAGE);
  uint64_t* empty = full + WG_STAGES;

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int n_steps = Kp / 64;  // 64 logical k per step in both layouts
  const int half = Kp / 2;
  const int g_per = 32 / gs;    // scale rows per k range and step
  // the cluster's K slice (persistent: all of K) and the tile walk
  const int split = KSPLIT ? split_arg : 1;
  const int rank = KSPLIT ? static_cast<int>(cluster_ctarank()) : 0;
  const int ks0 = rank * (n_steps / split);
  const int ks1 = ks0 + n_steps / split;
  const int tile0 = static_cast<int>(blockIdx.x) / split;
  const int tile_step = static_cast<int>(gridDim.x) / split;

  if (tid == 0) {
    for (int s = 0; s < WG_STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 256);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (warp >= 8) {
    // ---- producer warpgroup: one lane keeps the ring full ----------------
    // The block starts at 168 registers a thread (65536 / 384). The three
    // idle warps exist to be part of that pool: the producer warpgroup
    // keeps 40 a thread and the consumers take 232 (40 * 128 + 232 * 256 =
    // 168 * 384).
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (warp == 8 && lane == 0) {
      const uint32_t tx = 2 * S::X_RANGE + S::Q_TILE +
                          (HAS_OFF ? 2 : 1) * 2 * g_per * WG_BR * ES;
      int stage = 0;
      uint32_t phase = 0;
      for (int tile = tile0; tile < n_tiles; tile += tile_step) {
        const int m0 = (tile % m_tiles) * (NT * WG_BM);
        const int r0 = (tile / m_tiles) * WG_BR;
        for (int ks = ks0; ks < ks1; ++ks) {
          // k range A and B of the step, and its first code row
          const int ka = NIB4 ? ks * 32 : ks * 64;
          const int kb = NIB4 ? half + ks * 32 : ks * 64 + 32;
          const int qrow = NIB4 ? ks * 32 : ks * 64;
          mbar_wait(&empty[stage], phase ^ 1);
          uint8_t* st = smem + stage * S::STAGE;
          mbar_arrive_expect_tx(&full[stage], tx);
          tma_load_2d(st, &tm_x, &full[stage], ka, m0);
          tma_load_2d(st + S::X_RANGE, &tm_x, &full[stage], kb, m0);
          uint8_t* qd = st + 2 * S::X_RANGE;
          tma_load_2d(qd, &tm_q, &full[stage], r0, qrow);
          uint8_t* sd = qd + S::Q_TILE;
          tma_load_2d(sd, &tm_s, &full[stage], r0, ka / gs);
          tma_load_2d(sd + WG_S_BOX, &tm_s, &full[stage], r0, kb / gs);
          if constexpr (HAS_OFF) {
            uint8_t* od = sd + WG_S_TILE;
            tma_load_2d(od, &tm_o, &full[stage], r0, ka / gs);
            tma_load_2d(od + WG_S_BOX, &tm_o, &full[stage], r0, kb / gs);
          }
          if (++stage == WG_STAGES) {
            stage = 0;
            phase ^= 1;
          }
        }
        if constexpr (LORA) {
          for (int c = 0; rank == 0 && c < rk; c += 64) {
            const bool two = c + 32 < rk;  // the second 32 rank columns
            mbar_wait(&empty[stage], phase ^ 1);
            uint8_t* st = smem + stage * S::STAGE;
            mbar_arrive_expect_tx(&full[stage], (two ? 2 : 1) * S::X_RANGE);
            tma_load_2d(st, &tm_h, &full[stage], c, m0);
            if (two)
              tma_load_2d(st + S::X_RANGE, &tm_h, &full[stage], c + 32, m0);
            if (++stage == WG_STAGES) {
              stage = 0;
              phase ^= 1;
            }
          }
        }
      }
    }
    if constexpr (KSPLIT) {  // the consumers' two cluster barriers
      cluster_sync_all();
      cluster_sync_all();
    }
  } else {
    // ---- consumers: warpgroup wg owns out-features 64*wg .. 64*wg+63 -----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int wg = warp >> 2;
    const int w = warp & 3;
    const int g = lane >> 2;
    const int t = lane & 3;
    // this thread's two adjacent out-features inside the tile: wgmma rows
    // g and g+8 of warp w are mapped to columns r_loc and r_loc+1
    const int r_loc = wg * 64 + w * 16 + 2 * g;
    // byte offsets of its code pairs in rows 2t and 2t+1 of a 128-byte-
    // swizzled code tile: 16-byte chunk (4 wg + w) ^ (row % 8), byte 2g
    const uint32_t q_off0 = (2 * t) * WG_BR +
                            ((((wg * 4 + w) ^ (2 * t)) << 4) | (2 * g));
    const uint32_t q_off1 = (2 * t + 1) * WG_BR +
                            ((((wg * 4 + w) ^ (2 * t + 1)) << 4) | (2 * g));
    const float neg_base = NIB4 ? -(MAGIC + zp) : -(MAGIC + 128.0f);
    const uint32_t smem_base = smem_u32(smem);

    int stage = 0;
    uint32_t phase = 0;
    for (int tile = tile0; tile < n_tiles; tile += tile_step) {
      const int m0 = (tile % m_tiles) * (NT * WG_BM);
      const int r0 = (tile / m_tiles) * WG_BR;
      float acc[NT][64];
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int i = 0; i < 64; ++i) acc[j][i] = 0.0f;
      // the four A fragments of a K step (block 0 and 1, k range A and
      // B), double-buffered over steps
      uint32_t frag[2][4][4];
      int release = -1;  // stage whose wgmma may still be in flight

      for (int ks = ks0; ks < ks1; ks += 2) {
#pragma unroll
        for (int par = 0; par < 2; ++par) {  // a slice has even steps
          mbar_wait(&full[stage], phase);
          // the stage's addresses, broadcast so that they (and the wgmma
          // descriptors made from them) stay in uniform registers
          const uint32_t xa = __shfl_sync(
              0xFFFFFFFFu, smem_base + stage * S::STAGE, 0);
          const uint32_t xb = xa + S::X_RANGE;
          const uint32_t qt = xa + 2 * S::X_RANGE;
          const uint32_t sc = qt + S::Q_TILE + r_loc * ES;
          const uint32_t oc = sc + WG_S_TILE;
          float2 s_a, s_b, o_a, o_b, c_a, c_b;
          o_a = o_b = c_a = c_b = make_float2(0.f, 0.f);

          // the four code pairs of rows rb+2t, +1, +8, +9 as two words
          // with bytes [r k, r+1 k, r k+1, r+1 k+1] (rb is a multiple of
          // 16, so the swizzle term of a row does not depend on it)
          auto load_words = [&](int rb, uint32_t& ab, uint32_t& cd) {
            const uint32_t p0 = qt + q_off0 + rb * WG_BR;
            const uint32_t p1 = qt + q_off1 + rb * WG_BR;
            ab = lds_u16(p0) | (lds_u16(p1) << 16);
            cd = lds_u16(p0 + 8 * WG_BR) | (lds_u16(p1 + 8 * WG_BR) << 16);
          };
          auto make_frag = [&](uint32_t (&a)[4], uint32_t ab, uint32_t cd,
                               float2 s, float2 o, float2 c) {
            auto dq = [&](uint32_t word, int b) {
              return dequant1<FOLD, HAS_OFF>(
                  magic_of_byte(word, b), (b & 1) ? s.y : s.x,
                  (b & 1) ? o.y : o.x, (b & 1) ? c.y : c.x, neg_base);
            };
            a[0] = pack_op<F16>(dq(ab, 0), dq(ab, 2));
            a[1] = pack_op<F16>(dq(ab, 1), dq(ab, 3));
            a[2] = pack_op<F16>(dq(cd, 0), dq(cd, 2));
            a[3] = pack_op<F16>(dq(cd, 1), dq(cd, 3));
          };

          // unpack the step's 32 (nib4) or 64 (int8) code rows
#pragma unroll
          for (int blk = 0; blk < 2; ++blk) {
            if (gs == 16 || blk == 0) {
              const uint32_t gl = gs == 16 ? blk * WG_BR * ES : 0;
              s_a = lds_scale2<SBF16>(sc + gl);
              s_b = lds_scale2<SBF16>(sc + WG_S_BOX + gl);
              if constexpr (HAS_OFF) {
                o_a = lds_scale2<SBF16>(oc + gl);
                o_b = lds_scale2<SBF16>(oc + WG_S_BOX + gl);
              }
              if constexpr (FOLD) {
                c_a = make_float2(-s_a.x * MAGIC, -s_a.y * MAGIC);
                c_b = make_float2(-s_b.x * MAGIC, -s_b.y * MAGIC);
              }
            }
            uint32_t ab, cd;
            load_words(blk * 16, ab, cd);
            if constexpr (NIB4) {
              make_frag(frag[par][2 * blk], ab & 0x0F0F0F0Fu,
                        cd & 0x0F0F0F0Fu, s_a, o_a, c_a);
              make_frag(frag[par][2 * blk + 1], (ab >> 4) & 0x0F0F0F0Fu,
                        (cd >> 4) & 0x0F0F0F0Fu, s_b, o_b, c_b);
            } else {
              make_frag(frag[par][2 * blk], ab ^ 0x80808080u,
                        cd ^ 0x80808080u, s_a, o_a, c_a);
              load_words(32 + blk * 16, ab, cd);
              make_frag(frag[par][2 * blk + 1], ab ^ 0x80808080u,
                        cd ^ 0x80808080u, s_b, o_b, c_b);
            }
          }
          // one wgmma group per step; while it runs, the next step is
          // unpacked into the other fragment buffer
          wgmma_fence();
#pragma unroll
          for (int f = 0; f < 4; ++f)
#pragma unroll
            for (int j = 0; j < NT; ++j)
              wgmma_m64n128k16_rs<F16>(
                  acc[j], frag[par][f],
                  wgmma_desc_k64(((f & 1) ? xb : xa) + j * WG_XSUB) +
                      2 * (f >> 1));
          wgmma_commit();
          // the group of the step before has retired: its fragments (the
          // other buffer) and its stage are free
          wgmma_wait<1>();
#pragma unroll
          for (int f = 0; f < 4; ++f)
#pragma unroll
            for (int i = 0; i < 4; ++i) reg_fence(frag[par ^ 1][f][i]);
          if (release >= 0) mbar_arrive(&empty[release]);
          release = stage;
          if (++stage == WG_STAGES) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
      wgmma_wait<0>();
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int i = 0; i < 64; ++i) reg_fence(acc[j][i]);
      mbar_arrive(&empty[release]);

      if constexpr (LORA) {
        // rows g and g + 8 of the A fragment are out-features r_loc and
        // r_loc + 1; k = the rank column
        const __nv_bfloat16* u0 =
            lora_up + static_cast<size_t>(r0 + r_loc) * rk + 2 * t;
        const __nv_bfloat16* u1 = u0 + rk;
        for (int c = 0; rank == 0 && c < rk; c += 64) {
          const int nk = (rk - c) / 16 < 4 ? (rk - c) / 16 : 4;
          uint32_t a[4][4] = {};
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
            const int k = c + 16 * kk;
            if (kk < nk) {
              a[kk][0] = ldg_u32(u0 + k);
              a[kk][1] = ldg_u32(u1 + k);
              a[kk][2] = ldg_u32(u0 + k + 8);
              a[kk][3] = ldg_u32(u1 + k + 8);
            }
          }
          mbar_wait(&full[stage], phase);
          const uint32_t xa = __shfl_sync(
              0xFFFFFFFFu, smem_base + stage * S::STAGE, 0);
          const uint32_t xb = xa + S::X_RANGE;
          // the chunk's nk k16 slices as one straight run of wgmma: a
          // branch between two of them makes ptxas inject a
          // warpgroup.arrive before each (C7519)
          auto issue = [&](auto n_slices) {
            wgmma_fence();
#pragma unroll
            for (int kk = 0; kk < decltype(n_slices)::value; ++kk)
#pragma unroll
              for (int j = 0; j < NT; ++j)
                wgmma_m64n128k16_rs<F16>(
                    acc[j], a[kk],
                    wgmma_desc_k64(((kk >> 1) ? xb : xa) + j * WG_XSUB) +
                        2 * (kk & 1));
            wgmma_commit();
          };
          if (nk == 4)
            issue(std::integral_constant<int, 4>{});
          else if (nk == 3)
            issue(std::integral_constant<int, 3>{});
          else if (nk == 2)
            issue(std::integral_constant<int, 2>{});
          else
            issue(std::integral_constant<int, 1>{});
          // one chunk at a time: its A registers are read until it retires
          wgmma_wait<0>();
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
#pragma unroll
            for (int i = 0; i < 4; ++i) reg_fence(a[kk][i]);
#pragma unroll
          for (int j = 0; j < NT; ++j)
#pragma unroll
            for (int i = 0; i < 64; ++i) reg_fence(acc[j][i]);
          mbar_arrive(&empty[stage]);
          if (++stage == WG_STAGES) {
            stage = 0;
            phase ^= 1;
          }
        }
      }

      // acc[j][4i + 2h + c] = out[m0 + 128j + 8i + 2t + c][r0 + r_loc + h]
      const int r = r0 + r_loc;
      if constexpr (KSPLIT) {
        // the partials overwrite the ring: wait until both consumer
        // warpgroups are done with every stage (they read the same x and h
        // tiles, and one may still be in its last wgmma)
        named_bar_sync(1, 256);
        // group a = 16j + i is acc[j][4i .. 4i + 3]; this thread's groups
        // at part + (a * 256 + tid) * 16, conflict-free 16-byte stores
        const uint32_t part = smem_base + tid * 16;
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int i = 0; i < 16; ++i)
            st_shared_f32x4(part + (j * 16 + i) * (256 * 16),
                            make_float4(acc[j][4 * i], acc[j][4 * i + 1],
                                        acc[j][4 * i + 2],
                                        acc[j][4 * i + 3]));
        cluster_sync_all();
        const int per = NT * 16 / split;  // groups this rank sums
        for (int a = rank * per; a < (rank + 1) * per; ++a) {
          const uint32_t src = part + a * (256 * 16);
          float4 p[WG_SPLIT_MAX];
#pragma unroll
          for (int q = 0; q < WG_SPLIT_MAX; ++q)
            if (q < split) p[q] = ld_cluster_f32x4(cluster_map(src, q));
          float4 v = p[0];
#pragma unroll
          for (int q = 1; q < WG_SPLIT_MAX; ++q) {
            if (q < split) {
              v.x = __fadd_rn(v.x, p[q].x);
              v.y = __fadd_rn(v.y, p[q].y);
              v.z = __fadd_rn(v.z, p[q].z);
              v.w = __fadd_rn(v.w, p[q].w);
            }
          }
          const int m = m0 + (a / 16) * WG_BM + 8 * (a % 16) + 2 * t;
          epilogue_store2(out, bias, act_from, M, R, m, r, v.x, v.z);
          epilogue_store2(out, bias, act_from, M, R, m + 1, r, v.y, v.w);
        }
        cluster_sync_all();  // no rank leaves while another reads it
        continue;
      }
#pragma unroll
      for (int j = 0; j < NT; ++j) {
#pragma unroll
        for (int i = 0; i < 16; ++i) {
          const int m = m0 + j * WG_BM + 8 * i + 2 * t;
          epilogue_store2(out, bias, act_from, M, R, m, r, acc[j][4 * i],
                          acc[j][4 * i + 2]);
          epilogue_store2(out, bias, act_from, M, R, m + 1, r,
                          acc[j][4 * i + 1], acc[j][4 * i + 3]);
        }
      }
    }
  }
}

template <bool NIB4, bool HAS_OFF, int NT, bool LORA, bool SBF16,
          bool KSPLIT, bool F16>
cudaError_t launch_wgmma_nt(const void* x, const void* qs, const void* scales,
                            const void* offsets, const void* bias, void* out,
                            const void* h, const void* up, int M, int K,
                            int Kp, int R, int Rp, int gs, int zp, int rk,
                            int act_from, int split, cudaStream_t stream) {
  using S = WgShape<NIB4, NT>;
  auto kernel =
      qmm_wgmma_kernel<NIB4, HAS_OFF, NT, LORA, SBF16, KSPLIT, F16>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, S::SMEM);
  if (attr != cudaSuccess) return attr;
  const int n_steps = Kp / 64;
  if (split < 1 || split > WG_SPLIT_MAX || n_steps % (2 * split) ||
      (NT * 16) % split || KSPLIT != (split > 1))
    return cudaErrorInvalidValue;
  CUtensorMap tm_x, tm_q, tm_s, tm_o, tm_h{};
  const uint32_t g_per = 32 / gs;
  const auto s_dt = SBF16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                          : CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  const int es = SBF16 ? 2 : 4;
  const auto x_dt =
      F16 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  bool ok = make_map(&tm_x, x_dt, 2, x, M, K,
                     NT * WG_BM, 32, CU_TENSOR_MAP_SWIZZLE_64B);
  ok = ok && make_map(&tm_q, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, qs,
                      NIB4 ? Kp / 2 : Kp, Rp, S::QROWS, WG_BR,
                      CU_TENSOR_MAP_SWIZZLE_128B);
  ok = ok && make_map(&tm_s, s_dt, es, scales, Kp / gs, Rp, g_per, WG_BR,
                      CU_TENSOR_MAP_SWIZZLE_NONE);
  ok = ok && make_map(&tm_o, s_dt, es, HAS_OFF ? offsets : scales, Kp / gs,
                      Rp, g_per, WG_BR, CU_TENSOR_MAP_SWIZZLE_NONE);
  // h (M, rk) in the boxes of x: NT x 128 rows x 32 bf16, 64-byte swizzle
  if (LORA)
    ok = ok && make_map(&tm_h, x_dt, 2, h, M, rk,
                        NT * WG_BM, 32, CU_TENSOR_MAP_SWIZZLE_64B);
  if (!ok) return cudaErrorInvalidValue;
  const int m_tiles = (M + NT * WG_BM - 1) / (NT * WG_BM);
  const int n_tiles = m_tiles * ((R + WG_BR - 1) / WG_BR);
  // split == 1: one persistent block a SM; else a cluster per tile
  const int grid = split > 1 ? n_tiles * split
                             : (n_tiles < sm_count() ? n_tiles : sm_count());
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid, 1, 1);
  cfg.blockDim = dim3(WG_THREADS, 1, 1);
  cfg.dynamicSmemBytes = S::SMEM;
  cfg.stream = stream;
  cudaLaunchAttribute at[1];
  at[0].id = cudaLaunchAttributeClusterDimension;
  at[0].val.clusterDim.x = split;
  at[0].val.clusterDim.y = 1;
  at[0].val.clusterDim.z = 1;
  cfg.attrs = at;
  cfg.numAttrs = split > 1 ? 1 : 0;
  const cudaError_t e = cudaLaunchKernelEx(
      &cfg, kernel, tm_x, tm_q, tm_s, tm_o, static_cast<const float*>(bias),
      static_cast<WgOut<F16>*>(out), M, Kp, R, gs,
      static_cast<float>(zp), act_from, m_tiles, n_tiles, tm_h,
      static_cast<const __nv_bfloat16*>(up), rk, split);
  return e != cudaSuccess ? e : cudaGetLastError();
}

// The instance for the layout, the offsets, the token sub-tiles `nt` and
// the scale planes' type (sbf16: bfloat16, else float32), with a K split
// over a cluster of `split` blocks; LORA instances take the rank operands
// h, up (and rk), the others ignore them.
template <bool NIB4, bool LORA, bool F16 = false>
cudaError_t launch_wgmma(const void* x, const void* qs, const void* scales,
                         const void* offsets, const void* bias, void* out,
                         const void* h, const void* up, int M, int K, int Kp,
                         int R, int Rp, int gs, int zp, int rk, int act_from,
                         int nt, int split, int sbf16, cudaStream_t stream) {
#define GGUF_QMM_NT(OFF, NTV, SB, KS)                                       \
  launch_wgmma_nt<NIB4, OFF, NTV, LORA, SB, KS, F16>(                       \
      x, qs, scales, offsets, bias, out, h, up, M, K, Kp, R, Rp, gs, zp, rk, \
      act_from, split, stream)
#define GGUF_QMM_KS(OFF, NTV, SB)                  \
  (split > 1 ? GGUF_QMM_NT(OFF, NTV, SB, true) \
             : GGUF_QMM_NT(OFF, NTV, SB, false))
#define GGUF_QMM_SB(OFF, NTV) \
  (sbf16 ? GGUF_QMM_KS(OFF, NTV, true) : GGUF_QMM_KS(OFF, NTV, false))
  if (offsets != nullptr)
    return nt == 2 ? GGUF_QMM_SB(true, 2) : GGUF_QMM_SB(true, 1);
  return nt == 2 ? GGUF_QMM_SB(false, 2) : GGUF_QMM_SB(false, 1);
#undef GGUF_QMM_SB
#undef GGUF_QMM_KS
#undef GGUF_QMM_NT
}

// Blocks of one instance that fit on the card at once with clusters of
// `split` (split == 1: one a SM), for the wrapper's plan and phase 2.
template <bool NIB4>
int wgmma_resident_blocks(int nt, int split) {
  auto kernel =
      nt == 2 ? qmm_wgmma_kernel<NIB4, true, 2, false, false, true, false>
              : qmm_wgmma_kernel<NIB4, true, 1, false, false, true, false>;
  const int smem = nt == 2 ? WgShape<NIB4, 2>::SMEM : WgShape<NIB4, 1>::SMEM;
  if (cudaFuncSetAttribute(kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           smem) != cudaSuccess)
    return -1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(split * 132, 1, 1);
  cfg.blockDim = dim3(WG_THREADS, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cudaLaunchAttribute at[1];
  at[0].id = cudaLaunchAttributeClusterDimension;
  at[0].val.clusterDim.x = split;
  at[0].val.clusterDim.y = 1;
  at[0].val.clusterDim.z = 1;
  cfg.attrs = at;
  cfg.numAttrs = 1;
  int n = 0;
  if (cudaOccupancyMaxActiveClusters(&n, kernel, &cfg) != cudaSuccess)
    return -1;
  return n * split;
}

}  // namespace
}  // namespace gguf_cuda
