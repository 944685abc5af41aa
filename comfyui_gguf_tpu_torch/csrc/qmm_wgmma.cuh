// The wgmma body of the fused dequant-matmul (design note: qmm.cu). A
// header so that the nib4 instances (qmm.cu) and the int8 instances
// (qmm_int8.cu) compile side by side.
#pragma once

#include "qmm_common.cuh"
#include "tma.cuh"

namespace gguf_cuda {
namespace {

constexpr int WG_BR = 128;      // out-features per tile (2 warpgroups x 64)
constexpr int WG_BM = 128;      // tokens per wgmma (its N); a tile has NT
constexpr int WG_STAGES = 5;
constexpr int WG_THREADS = 384; // 2 consumer warpgroups + the producer's
constexpr int WG_XSUB = WG_BM * 64;      // 128 tokens x 32 bf16, 64-B swizzle
constexpr int WG_S_BOX = 2 * WG_BR * 4;  // up to 2 scale rows per k range
constexpr int WG_S_TILE = 2 * WG_S_BOX;  // two k ranges

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

template <bool NIB4, bool HAS_OFF, int NT>
__global__ void __launch_bounds__(WG_THREADS, 1)
qmm_wgmma_kernel(const __grid_constant__ CUtensorMap tm_x,  // (M, K) bf16
                 const __grid_constant__ CUtensorMap tm_q,  // codes, u8
                 const __grid_constant__ CUtensorMap tm_s,  // scales, f32
                 const __grid_constant__ CUtensorMap tm_o,  // offsets, f32
                 const float* __restrict__ bias,            // (R) | null
                 __nv_bfloat16* __restrict__ out,           // (M, R)
                 int M, int Kp, int R, int gs, float zp, int act_from,
                 int m_tiles, int n_tiles) {
  using S = WgShape<NIB4, NT>;
  constexpr bool FOLD = NIB4 && HAS_OFF;
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
                          (HAS_OFF ? 2 : 1) * 2 * g_per * WG_BR * 4;
      int stage = 0;
      uint32_t phase = 0;
      for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
        const int m0 = (tile % m_tiles) * (NT * WG_BM);
        const int r0 = (tile / m_tiles) * WG_BR;
        for (int ks = 0; ks < n_steps; ++ks) {
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
      }
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
    for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
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

      for (int ks = 0; ks < n_steps; ks += 2) {
#pragma unroll
        for (int par = 0; par < 2; ++par) {  // n_steps is even
          mbar_wait(&full[stage], phase);
          // the stage's addresses, broadcast so that they (and the wgmma
          // descriptors made from them) stay in uniform registers
          const uint32_t xa = __shfl_sync(
              0xFFFFFFFFu, smem_base + stage * S::STAGE, 0);
          const uint32_t xb = xa + S::X_RANGE;
          const uint32_t qt = xa + 2 * S::X_RANGE;
          const uint32_t sc = qt + S::Q_TILE + r_loc * 4;
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
            a[0] = pack_bf16(dq(ab, 0), dq(ab, 2));
            a[1] = pack_bf16(dq(ab, 1), dq(ab, 3));
            a[2] = pack_bf16(dq(cd, 0), dq(cd, 2));
            a[3] = pack_bf16(dq(cd, 1), dq(cd, 3));
          };

          // unpack the step's 32 (nib4) or 64 (int8) code rows
#pragma unroll
          for (int blk = 0; blk < 2; ++blk) {
            if (gs == 16 || blk == 0) {
              const uint32_t gl = gs == 16 ? blk * WG_BR * 4 : 0;
              s_a = lds_f32x2(sc + gl);
              s_b = lds_f32x2(sc + WG_S_BOX + gl);
              if constexpr (HAS_OFF) {
                o_a = lds_f32x2(oc + gl);
                o_b = lds_f32x2(oc + WG_S_BOX + gl);
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
              wgmma_m64n128k16_rs(
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

      // acc[j][4i + 2h + c] = out[m0 + 128j + 8i + 2t + c][r0 + r_loc + h]
      const int r = r0 + r_loc;
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

template <bool NIB4, bool HAS_OFF, int NT>
cudaError_t launch_wgmma_nt(const void* x, const void* qs, const void* scales,
                            const void* offsets, const void* bias, void* out,
                            int M, int K, int Kp, int R, int Rp, int gs,
                            int zp, int act_from, cudaStream_t stream) {
  using S = WgShape<NIB4, NT>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      qmm_wgmma_kernel<NIB4, HAS_OFF, NT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, S::SMEM);
  if (attr != cudaSuccess) return attr;
  CUtensorMap tm_x, tm_q, tm_s, tm_o;
  const uint32_t g_per = 32 / gs;
  bool ok = make_map(&tm_x, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, x, M, K,
                     NT * WG_BM, 32, CU_TENSOR_MAP_SWIZZLE_64B);
  ok = ok && make_map(&tm_q, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, qs,
                      NIB4 ? Kp / 2 : Kp, Rp, S::QROWS, WG_BR,
                      CU_TENSOR_MAP_SWIZZLE_128B);
  ok = ok && make_map(&tm_s, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, scales,
                      Kp / gs, Rp, g_per, WG_BR, CU_TENSOR_MAP_SWIZZLE_NONE);
  ok = ok && make_map(&tm_o, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4,
                      HAS_OFF ? offsets : scales, Kp / gs, Rp, g_per, WG_BR,
                      CU_TENSOR_MAP_SWIZZLE_NONE);
  if (!ok) return cudaErrorInvalidValue;
  const int m_tiles = (M + NT * WG_BM - 1) / (NT * WG_BM);
  const int n_tiles = m_tiles * ((R + WG_BR - 1) / WG_BR);
  const int grid = n_tiles < sm_count() ? n_tiles : sm_count();
  qmm_wgmma_kernel<NIB4, HAS_OFF, NT><<<grid, WG_THREADS, S::SMEM, stream>>>(
      tm_x, tm_q, tm_s, tm_o, static_cast<const float*>(bias),
      static_cast<__nv_bfloat16*>(out), M, Kp, R, gs, static_cast<float>(zp),
      act_from, m_tiles, n_tiles);
  return cudaGetLastError();
}

template <bool NIB4, bool HAS_OFF>
cudaError_t launch_wgmma(const void* x, const void* qs, const void* scales,
                         const void* offsets, const void* bias, void* out,
                         int M, int K, int Kp, int R, int Rp, int gs, int zp,
                         int act_from, int nt, cudaStream_t stream) {
  return nt == 2
             ? launch_wgmma_nt<NIB4, HAS_OFF, 2>(x, qs, scales, offsets, bias,
                                                 out, M, K, Kp, R, Rp, gs, zp,
                                                 act_from, stream)
             : launch_wgmma_nt<NIB4, HAS_OFF, 1>(x, qs, scales, offsets, bias,
                                                 out, M, K, Kp, R, Rp, gs, zp,
                                                 act_from, stream);
}

}  // namespace
}  // namespace gguf_cuda
