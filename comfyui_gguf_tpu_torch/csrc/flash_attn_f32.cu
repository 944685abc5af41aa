// K7's f32 instances: flash attention forward, non-causal, f32 in and out,
// its products as 3xTF32 on the tensor cores (wgmma m64n64k8 tf32).
//
// Replaces the library Pallas kernels of comfyui_gguf_tpu/nn/attention.py
// (_splash_attention and the flash branch of dot_product_attention) for
// f32 q/k/v, which the reference computes in f32 through
// jax.nn.dot_product_attention:
//
//   out[b, h, i, :] = softmax_j(scale * q[b, h, i, :] . k[b, h, j, :])
//                     v[b, h, j, :]
//
// with f32 logits, an f32 softmax and f32 accumulation of P·V, as
// plain_attention does in f32. Each f32 operand is split into two TF32
// halves (common.cuh split_tf32: big rounded to nearest, small the exact
// rest rounded again) and each product is a_small·b_big + a_big·b_small +
// a_big·b_big, so the result stays within about 2^-20 of an f32 product
// (one TF32 pass is off by 2^-11).
//
// What bounds it: the TF32 tensor cores (495 TFLOP/s on the H100 SXM) at
// three products per f32 product, 3·4·L²·D operations per head, and beside
// them shared-memory bandwidth: at M = 64 rows a wgmma reads 4 bytes of B
// for every 128 operations, half the SM's shared-memory rate at the full
// TF32 rate, before the operand splits and the A fragments.
//
// Design. A block owns BQ = 64 query rows of one (b, h) and runs the
// products transposed, so that the operands it splits in registers are the
// streamed ones and the resident-per-tile ones need the split once:
//   Sᵀ = K·Qᵀ: consumer warpgroup w takes 64 keys of the tile as the M rows
//     (A = K fragments read from the TMA-landed chunk and split in
//     registers), N = the 64 query rows (B = Q's big and small halves);
//   Oᵀ += Vᵀ·Pᵀ: warpgroup w owns 64-column groups w, w + NW, ... of the
//     output as M rows (A = V fragments read from the TMA-landed tile and
//     split in registers), N = the 64 query rows (B = P's big and small
//     halves, written by the softmax).
// TF32 wgmma reads shared operands K-major only, and both B operands are:
// Q and P are stored query-major, d or keys contiguous. V is never
// transposed: its fragments are loaded element by element as A.
// A producer warpgroup keeps the loads in two rings under mbarriers: lane 0
// of its first warp issues the TMA loads (Q and K in 32-wide d chunks, V in
// chunks of 64 keys x 64 columns, each with its one owner warpgroup;
// 128-byte swizzle, zero past D and past Lq / Lk), and its other three
// warps split each Q chunk into its TF32 halves, big in place and small
// beside it (fence.proxy.async, then an mbarrier arrival). So Q is read
// from L2 again for every key tile rather than held whole: at D = 512, 64
// rows of Q and its two halves would need 384 KB. The keys a tile are
// BKV = 64·NW.
//
// Scores once at every head dim. Each (query tile, key tile) pair's scores
// are computed once, over all of D, by the warpgroup that owns those 64
// keys; the softmax max is exchanged through shared memory (each warp's
// per-query maxima, then 64 reducer threads, two named barriers), P is
// written once and every warpgroup reads all of it for its own output
// columns (a third barrier). So an instance does 2·Lq·Lk·DK operations for
// Sᵀ and 2·Lq·Lk·DV for Oᵀ, DK = D padded to 32 and DV = D padded to 64,
// three times over for 3xTF32: 4·Lq·Lk·D at D = 64, 128, 256, 384 and 512
// (no padding), 4.5·Lq·Lk·D at D = 40, 80 and 96, 4.4·Lq·Lk·D at D = 160.
// The SIMT body this replaces recomputed the scores in every 128-column
// slice (2x and 2.5x the operations at D = 384 and 512).
//
// Accumulation. A wgmma adds into its f32 accumulator with less than an
// f32 add's rounding, and the error is biased: O accumulated by the tensor
// cores over 6,240 keys (2,340 wgmmas) came out 4.6e-5 from plain_attention
// (relative L2, H100), SDPA 1.7e-6. So every product runs into a fresh
// accumulator over one 32-wide d chunk (12 wgmmas) or one 64-key V chunk
// (24) and is added into S or O by f32 adds in registers.
//
// The keys inside each group of 8 are fed to the Oᵀ product in the order
// 0, 2, 4, 6, 1, 3, 5, 7 (V's rows and P's columns alike), which makes the
// V fragment loads and the P stores free of bank conflicts; a sum over the
// keys does not see the order. The softmax runs in base 2 with the scale
// folded in; the per-query row sums go through the same exchange as the
// maxima (each warp's, a tile late, into a running sum the reducers keep).
// Keys past Lk are masked to -inf (their V rows are TMA's zeros), V
// columns past D read as zeros, query rows past Lq are not stored, and
// q/k/v may be strided views: the tensor maps are 4-D (D, L, H, B).
//
// Shared memory: 2 stages of Q chunks (8 KB, big in place, and 8 KB
// small), 2 stages of K chunks (BKV x 128 B), 4 stages of 16 KB V chunks,
// P's two halves (64 x BKV x 4 B each) and the exchange: 202,864 bytes with
// two consumer warpgroups (D > 64), 151,664 with one
// (flash_attn_f32_smem_bytes, within a block's 232,448). Registers: the owned O columns (32 a 64-column
// group: 128 at D = 512), S and the fresh accumulator (32 each) and the
// fragments, double-buffered below D = 512; the producer warpgroup gives
// its registers up (setmaxnreg 40, the consumers 232) where there are two
// consumer warpgroups. The K and V fragments and the softmax's (max,
// correction) pairs are read by volatile ld.shared with 32-bit addresses:
// plain loads let the compiler hoist a loop's worth of them into
// registers, and D = 512 spilled.
#include "common.cuh"
#include "tma.cuh"

namespace {

using namespace gguf_cuda;

constexpr int BQ = 64;        // query rows a block: the N of every wgmma
constexpr int QKS = 2;        // stages of the Q / K chunk ring
constexpr int VS = 4;         // stages of the V ring
constexpr int Q_CH = BQ * 128;  // bytes of one 32-wide d chunk of Q
constexpr int V_BOX = 64 * 128;  // bytes of a V box: 64 keys x 32 columns
constexpr int V_CH = 2 * V_BOX;  // a V chunk: 64 keys x 64 columns

template <int D>
struct F32Shape {
  static constexpr int NC = (D + 31) / 32;    // 32-wide d chunks (TMA boxes)
  static constexpr int NCG = (D + 63) / 64;   // 64-column groups of O
  static constexpr int NW = NCG > 1 ? 2 : 1;  // consumer warpgroups
  static constexpr int BKV = 64 * NW;         // keys a tile
  static constexpr int NCGW = (NCG + NW - 1) / NW;  // groups a warpgroup
  static constexpr int NVC = NW * NCG;        // V chunks a tile
  static constexpr int THREADS = 128 * (NW + 1);
  static constexpr int K_CH = BKV * 128;      // bytes of a K chunk
  static constexpr int P_BYTES = BKV * BQ * 4;  // one half of P
  static constexpr int RED = 4 * NW * BQ * 4;   // a (warps, 64) f32 table
  // offsets from the 1024-aligned base: Q chunks (raw, then big in place),
  // their small halves, K chunks, V chunks, P's halves, the softmax tables
  static constexpr int OFF_QS = QKS * Q_CH;
  static constexpr int OFF_K = 2 * QKS * Q_CH;
  static constexpr int OFF_V = OFF_K + QKS * K_CH;
  static constexpr int OFF_PB = OFF_V + VS * V_CH;
  static constexpr int OFF_PS = OFF_PB + P_BYTES;
  static constexpr int OFF_RMAX = OFF_PS + P_BYTES;  // per-warp maxima
  static constexpr int OFF_RSUM = OFF_RMAX + RED;    // per-warp sums
  static constexpr int OFF_MC = OFF_RSUM + RED;      // (64) (m, corr)
  static constexpr int OFF_MRUN = OFF_MC + BQ * 8;   // (64) running max
  static constexpr int OFF_LRUN = OFF_MRUN + BQ * 4;  // (64) running sum
  static constexpr int OFF_BAR = OFF_LRUN + BQ * 4;
  static constexpr int N_BAR = 3 * QKS + 2 * VS;
  static constexpr int SMEM = 1024 + OFF_BAR + N_BAR * 8;
  static_assert(SMEM <= 232448, "past the shared memory of a block");
};

// one f32 (two) from a shared-state-space address: 32 bits where a generic
// pointer takes 64, and volatile, so the compiler neither moves them above
// the mbarrier waits nor hoists a loop's worth of them into registers (at
// D = 512 that spilled)
__device__ __forceinline__ float lds_f32(uint32_t addr) {
  float v;
  asm volatile("ld.shared.f32 %0, [%1];\n" : "=f"(v) : "r"(addr));
  return v;
}

__device__ __forceinline__ float2 lds_f32x2(uint32_t addr) {
  float2 v;
  asm volatile("ld.shared.v2.f32 {%0, %1}, [%2];\n"
               : "=f"(v.x), "=f"(v.y) : "r"(addr));
  return v;
}

// 3xTF32 wgmmas over one 8-wide k step of a product whose A fragments are
// split in registers: f[0..3] big, f[4..7] small
__device__ __forceinline__ void step3(float (&d)[32], const uint32_t (&f)[8],
                                      uint64_t desc_big, uint64_t desc_small,
                                      int scale_d) {
  const uint32_t big[4] = {f[0], f[1], f[2], f[3]};
  const uint32_t small[4] = {f[4], f[5], f[6], f[7]};
  wgmma_m64n64k8_3xtf32(d, big, small, desc_big, desc_small, scale_d);
}

template <int D>
__global__ void __launch_bounds__(F32Shape<D>::THREADS, 1)
flash_tf32_kernel(const __grid_constant__ CUtensorMap tm_q,  // (D, Lq, H, B)
                  const __grid_constant__ CUtensorMap tm_k,  // (D, Lk, H, B)
                  const __grid_constant__ CUtensorMap tm_v,  // (D, Lk, H, B)
                  float* __restrict__ out, int Lq, int Lk, long long ob,
                  long long oh, long long ol, float scale_log2) {
  using S = F32Shape<D>;
  constexpr int NW = S::NW;
  constexpr int NC = S::NC;
  constexpr int NCG = S::NCG;
  constexpr int BKV = S::BKV;
  constexpr int NCONS = 128 * NW;  // consumer threads
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t{1023});
  uint8_t* q_s = smem;
  uint8_t* k_s = smem + S::OFF_K;
  uint8_t* v_s = smem + S::OFF_V;
  float* rmax = reinterpret_cast<float*>(smem + S::OFF_RMAX);
  float* rsum = reinterpret_cast<float*>(smem + S::OFF_RSUM);
  float2* mc = reinterpret_cast<float2*>(smem + S::OFF_MC);
  float* mrun = reinterpret_cast<float*>(smem + S::OFF_MRUN);
  float* lrun = reinterpret_cast<float*>(smem + S::OFF_LRUN);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + S::OFF_BAR);
  uint64_t* split_full = full + QKS;
  uint64_t* empty = split_full + QKS;
  uint64_t* vfull = empty + QKS;
  uint64_t* vempty = vfull + VS;

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int q0 = blockIdx.x * BQ;
  const int n_kv = (Lk + BKV - 1) / BKV;
  const float neg_inf = -__int_as_float(0x7f800000);

  if (tid == 0) {
    for (int s = 0; s < QKS; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&split_full[s], 96);
      mbar_init(&empty[s], NCONS);
    }
    for (int s = 0; s < VS; ++s) {
      mbar_init(&vfull[s], 1);
      mbar_init(&vempty[s], 128);  // a V chunk has one owner warpgroup
    }
    mbar_init_fence();
  }
  if (tid < BQ) {
    mrun[tid] = neg_inf;
    lrun[tid] = 0.0f;
  }
  __syncthreads();

  if (warp >= 4 * NW) {
    // ---- producer warpgroup ------------------------------------------------
    // (register pool: 40 * 128 + 232 * 256 = 168 * 384, as in flash_attn.cuh)
    if constexpr (NW > 1) asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (warp == 4 * NW) {
      if (lane == 0) {
        for (int j = 0; j < n_kv; ++j) {
          for (int c = 0; c < NC; ++c) {
            const int n = j * NC + c;
            const int st = n % QKS;
            mbar_wait(&empty[st], ((n / QKS) & 1) ^ 1);
            mbar_arrive_expect_tx(&full[st], Q_CH + S::K_CH);
            tma_load_4d(q_s + st * Q_CH, &tm_q, &full[st], 32 * c, q0, h, b);
            tma_load_4d(k_s + st * S::K_CH, &tm_k, &full[st], 32 * c,
                        j * BKV, h, b);
          }
          // V chunk (half, column group): 64 keys x 64 columns, in the
          // order the owners consume them; a box wholly past D is not
          // loaded (its fragments read as zeros)
          for (int hf = 0; hf < NW; ++hf)
            for (int cg = 0; cg < NCG; ++cg) {
              const int m = j * S::NVC + hf * NCG + cg;
              const int st = m % VS;
              const int nbox = 64 * cg + 32 < D ? 2 : 1;
              mbar_wait(&vempty[st], ((m / VS) & 1) ^ 1);
              mbar_arrive_expect_tx(&vfull[st], nbox * V_BOX);
              for (int bx = 0; bx < nbox; ++bx)
                tma_load_4d(v_s + st * V_CH + bx * V_BOX, &tm_v, &vfull[st],
                            64 * cg + 32 * bx, j * BKV + 64 * hf, h, b);
            }
        }
      }
    } else {
      // warps 1..3: each Q chunk into its TF32 halves, big in place and
      // small beside it (elementwise, so the swizzled layout carries over)
      const int sid = tid - (4 * NW + 1) * 32;
      for (int n = 0; n < n_kv * NC; ++n) {
        const int st = n % QKS;
        mbar_wait(&full[st], (n / QKS) & 1);
        uint2* big = reinterpret_cast<uint2*>(q_s + st * Q_CH);
        uint2* small = reinterpret_cast<uint2*>(smem + S::OFF_QS + st * Q_CH);
        for (int e = sid; e < Q_CH / 8; e += 96) {
          const uint2 x = big[e];
          uint2 bg, sm;
          split_tf32(__uint_as_float(x.x), bg.x, sm.x);
          split_tf32(__uint_as_float(x.y), bg.y, sm.y);
          big[e] = bg;
          small[e] = sm;
        }
        fence_proxy_async();
        mbar_arrive(&split_full[st]);
      }
    }
    return;
  }

  // ---- consumers: warpgroup wg owns keys 64wg.. of a tile and the output
  // column groups wg, wg + NW, ...
  if constexpr (NW > 1) asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const int wg = warp >> 2;
  const int wp = warp & 3;
  const int g = lane >> 2;
  const int t = lane & 3;
  const uint32_t pb_base = smem_u32(smem + S::OFF_PB);
  const uint32_t ps_base = smem_u32(smem + S::OFF_PS);
  // this thread's key rows of a K chunk: 64wg + 16wp + g (+8)
  const int krow = 64 * wg + 16 * wp + g;

  // o[ci][4i + 2r + c] = output column 64(wg + NW ci) + 16wp + g + 8r,
  // query 8i + 2t + c
  float o[S::NCGW][32];
#pragma unroll
  for (int ci = 0; ci < S::NCGW; ++ci)
#pragma unroll
    for (int e = 0; e < 32; ++e) o[ci][e] = 0.0f;

  // A wgmma adds into its accumulator with less than f32's rounding (the
  // error grows with the number of wgmmas an accumulator takes, biased), so
  // every product runs into a fresh accumulator over at most 64 keys or 32
  // d values and is added to S or O by f32 adds
  float acc[32];
  uint32_t f[2][8];  // A fragments, big then small, double-buffered
  // fragment buffers: one at D = 512, where the 128 O registers, S and the
  // fresh accumulator leave no room for a second (two spilled)
  constexpr int NFB = S::NCGW > 3 ? 1 : 2;

  for (int j = 0; j < n_kv; ++j) {
    // ---- Sᵀ = K Qᵀ: 64 keys x 64 queries over all of D --------------------
    float s[32];
#pragma unroll 1
    for (int c = 0; c < NC; ++c) {
      const int n = j * NC + c;
      const int st = n % QKS;
      const uint32_t ph = (n / QKS) & 1;
      mbar_wait(&full[st], ph);
      mbar_wait(&split_full[st], ph);
      const uint32_t r0 = smem_u32(k_s + st * S::K_CH + krow * 128);
      const uint32_t r1 = r0 + 8 * 128;
      const uint32_t qb = smem_u32(q_s + st * Q_CH);
      const uint32_t qs = smem_u32(smem + S::OFF_QS + st * Q_CH);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        // (key row, d = 8kk + t (+4)) of the swizzled chunk: 16-byte unit
        // 2kk (+1) of the row, XOR the row's low 3 bits (g)
        const uint32_t u0 = (((2 * kk) ^ g) * 4 + t) * 4;
        const uint32_t u1 = (((2 * kk + 1) ^ g) * 4 + t) * 4;
        uint32_t(&fr)[8] = f[NFB == 1 ? 0 : kk & 1];
        split_tf32(lds_f32(r0 + u0), fr[0], fr[4]);
        split_tf32(lds_f32(r1 + u0), fr[1], fr[5]);
        split_tf32(lds_f32(r0 + u1), fr[2], fr[6]);
        split_tf32(lds_f32(r1 + u1), fr[3], fr[7]);
        wgmma_fence();
        step3(acc, fr, wgmma_desc_k128(qb) + 2 * kk,
              wgmma_desc_k128(qs) + 2 * kk, kk > 0);
        wgmma_commit();
        if constexpr (NFB == 1) {
          wgmma_wait<0>();
#pragma unroll
          for (int e = 0; e < 8; ++e) reg_fence(f[0][e]);
        } else if (kk > 0) {
          wgmma_wait<1>();
#pragma unroll
          for (int e = 0; e < 8; ++e) reg_fence(f[(kk - 1) & 1][e]);
        }
      }
      wgmma_wait<0>();
#pragma unroll
      for (int e = 0; e < 8; ++e) reg_fence(f[NFB - 1][e]);
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        reg_fence(acc[e]);
        s[e] = c ? s[e] + acc[e] : acc[e];
      }
      mbar_arrive(&empty[st]);
    }

    // ---- online softmax over the tile's keys (base 2, scale folded in) ----
    // s[4i + 2r + c] = key krow + 8r, query 8i + 2t + c
    const int key0 = j * BKV + krow;
    const bool ok0 = key0 < Lk;
    const bool ok1 = key0 + 8 < Lk;
    float pm[16];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const float a0 = ok0 ? s[4 * i + c] * scale_log2 : neg_inf;
        const float a1 = ok1 ? s[4 * i + 2 + c] * scale_log2 : neg_inf;
        s[4 * i + c] = a0;
        s[4 * i + 2 + c] = a1;
        pm[2 * i + c] = fmaxf(a0, a1);
      }
#pragma unroll
    for (int e = 0; e < 16; ++e) {
      pm[e] = fmaxf(pm[e], __shfl_xor_sync(0xffffffffu, pm[e], 4));
      pm[e] = fmaxf(pm[e], __shfl_xor_sync(0xffffffffu, pm[e], 8));
      pm[e] = fmaxf(pm[e], __shfl_xor_sync(0xffffffffu, pm[e], 16));
    }
    if (g == 0) {
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int c = 0; c < 2; ++c)
          rmax[warp * BQ + 8 * i + 2 * t + c] = pm[2 * i + c];
    }
    named_bar_sync(1, NCONS);
    // 64 reducers: the previous tile's sums into the running sum (at the
    // previous tile's max), then this tile's max and correction
    if (tid < BQ) {
      float l = lrun[tid];
      if (j > 0) {
        l *= mc[tid].y;
#pragma unroll
        for (int w = 0; w < 4 * NW; ++w) l += rsum[w * BQ + tid];
        lrun[tid] = l;
      }
      const float m_old = mrun[tid];
      float mx = m_old;
#pragma unroll
      for (int w = 0; w < 4 * NW; ++w) mx = fmaxf(mx, rmax[w * BQ + tid]);
      mrun[tid] = mx;
      mc[tid] = make_float2(mx, exp2f(m_old - mx));
    }
    named_bar_sync(2, NCONS);

    // P = exp2(s - m), its TF32 halves into P's K-major tiles (query rows of
    // 32 keys, 128-byte swizzle), keys of each 8 in the order 0 2 4 6 1 3 5
    // 7; this warp's per-query sums into rsum; the owned O columns rescaled
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int q = 8 * i + 2 * t + c;
        const float2 m = lds_f32x2(smem_u32(mc + q));
        const float p0 = exp2f(s[4 * i + c] - m.x);
        const float p1 = exp2f(s[4 * i + 2 + c] - m.x);
        pm[2 * i + c] = p0 + p1;
#pragma unroll
        for (int ci = 0; ci < S::NCGW; ++ci) {
          o[ci][4 * i + c] *= m.y;
          o[ci][4 * i + 2 + c] *= m.y;
        }
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          // key krow + 8r of the tile: its 32-key chunk, and its position
          // in the 128-byte row after the in-group reorder
          const int key = krow + 8 * r;
          const int pos = (key & 24) + (g & 1) * 4 + (g >> 1);
          const uint32_t off = (key >> 5) * (BQ * 128) + q * 128 +
                               (((pos >> 2) ^ (q & 7)) << 4) + (pos & 3) * 4;
          uint32_t pbig, psmall;
          split_tf32(r ? p1 : p0, pbig, psmall);
          asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(pb_base + off),
                       "r"(pbig) : "memory");
          asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(ps_base + off),
                       "r"(psmall) : "memory");
        }
      }
#pragma unroll
    for (int e = 0; e < 16; ++e) {
      pm[e] += __shfl_xor_sync(0xffffffffu, pm[e], 4);
      pm[e] += __shfl_xor_sync(0xffffffffu, pm[e], 8);
      pm[e] += __shfl_xor_sync(0xffffffffu, pm[e], 16);
    }
    if (g == 0) {
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int c = 0; c < 2; ++c)
          rsum[warp * BQ + 8 * i + 2 * t + c] = pm[2 * i + c];
    }
    fence_proxy_async();
    named_bar_sync(3, NCONS);

    // ---- Oᵀ += Vᵀ Pᵀ: this warpgroup's column groups, chunk by chunk -----
#pragma unroll 1
    for (int hf = 0; hf < NW; ++hf) {
#pragma unroll
      for (int ci = 0; ci < S::NCGW; ++ci) {
        const int cg = wg + NW * ci;
        if (NCG % NW != 0 && cg >= NCG) break;
        const int m = j * S::NVC + hf * NCG + cg;
        const int st = m % VS;
        mbar_wait(&vfull[st], (m / VS) & 1);
        // A rows: columns 64cg + 16wp + g (+8) = column cb (+8) of the
        // chunk's box wp / 2; zeros past D
        const uint32_t box = smem_u32(v_s + st * V_CH + (wp >> 1) * V_BOX);
        const int cb = 16 * (wp & 1) + g;
        const bool in0 = 64 * cg + 16 * wp + g < D;
        const bool in1 = 64 * cg + 16 * wp + g + 8 < D;
#pragma unroll
        for (int kk = 0; kk < 8; ++kk) {
          // A's k index t is key row 8kk + 2t, t + 4 is 8kk + 2t + 1
          const int ra = 8 * kk + 2 * t;
          const int rb = ra + 1;
          const uint32_t pa = box + ra * 128 + (cb & 3) * 4;
          const uint32_t pb = box + rb * 128 + (cb & 3) * 4;
          const float va0 =
              in0 ? lds_f32(pa + (((cb >> 2) ^ (ra & 7)) << 4)) : 0.f;
          const float va1 =
              in1 ? lds_f32(pa + ((((cb + 8) >> 2) ^ (ra & 7)) << 4)) : 0.f;
          const float vb0 =
              in0 ? lds_f32(pb + (((cb >> 2) ^ (rb & 7)) << 4)) : 0.f;
          const float vb1 =
              in1 ? lds_f32(pb + ((((cb + 8) >> 2) ^ (rb & 7)) << 4)) : 0.f;
          uint32_t(&fr)[8] = f[NFB == 1 ? 0 : kk & 1];
          split_tf32(va0, fr[0], fr[4]);
          split_tf32(va1, fr[1], fr[5]);
          split_tf32(vb0, fr[2], fr[6]);
          split_tf32(vb1, fr[3], fr[7]);
          // the keys' P chunk (32 keys) and k8 step in it
          const int key = 64 * hf + 8 * kk;
          const uint32_t poff = (key >> 5) * (BQ * 128);
          const int ks = (key & 31) >> 3;
          wgmma_fence();
          step3(acc, fr, wgmma_desc_k128(pb_base + poff) + 2 * ks,
                wgmma_desc_k128(ps_base + poff) + 2 * ks, kk > 0);
          wgmma_commit();
          if constexpr (NFB == 1) {
            wgmma_wait<0>();
#pragma unroll
            for (int e = 0; e < 8; ++e) reg_fence(f[0][e]);
          } else if (kk > 0) {
            wgmma_wait<1>();
#pragma unroll
            for (int e = 0; e < 8; ++e) reg_fence(f[(kk - 1) & 1][e]);
          }
        }
        wgmma_wait<0>();
#pragma unroll
        for (int e = 0; e < 8; ++e) reg_fence(f[NFB - 1][e]);
        mbar_arrive(&vempty[st]);
#pragma unroll
        for (int e = 0; e < 32; ++e) {
          reg_fence(acc[e]);
          o[ci][e] += acc[e];
        }
      }
    }
  }

  // ---- the last tile's sums, then the store of rows < Lq, columns < D -----
  named_bar_sync(1, NCONS);
  if (tid < BQ) {
    float l = lrun[tid] * mc[tid].y;
#pragma unroll
    for (int w = 0; w < 4 * NW; ++w) l += rsum[w * BQ + tid];
    lrun[tid] = 1.0f / l;
  }
  named_bar_sync(2, NCONS);
  float* ob_ = out + b * ob + h * oh;
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int q = 8 * i + 2 * t + c;
      if (q0 + q >= Lq) continue;
      const float inv = lrun[q];
      float* orow = ob_ + (q0 + q) * ol;
#pragma unroll
      for (int ci = 0; ci < S::NCGW; ++ci) {
        const int cg = wg + NW * ci;
        if (NCG % NW != 0 && cg >= NCG) break;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int col = 64 * cg + 16 * wp + 8 * r + g;
          if (col < D) orow[col] = o[ci][4 * i + 2 * r + c] * inv;
        }
      }
    }
}

// 4-D tensor map of an f32 (B, H, L, D) view with element strides (sb,
// sh, sl) and unit stride along D; box: one 32-value d chunk of `rows`
// rows, 128-byte swizzle (past D and L, TMA fills zeros). A dimension of
// extent 1 is never stepped, so it takes the stride D.
bool make_f32_map(CUtensorMap* map, const void* base, int D, int B, int H,
                  int L, const long long* st, int rows) {
  const long long sb = B > 1 ? st[0] : D;
  const long long sh = H > 1 ? st[1] : D;
  const long long sl = L > 1 ? st[2] : D;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D),
                              static_cast<cuuint64_t>(L),
                              static_cast<cuuint64_t>(H),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(sl) * 4,
                                 static_cast<cuuint64_t>(sh) * 4,
                                 static_cast<cuuint64_t>(sb) * 4};
  const cuuint32_t box[4] = {32, static_cast<cuuint32_t>(rows), 1, 1};
  return make_map_nd(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, base, 4, dims,
                     strides, box, CU_TENSOR_MAP_SWIZZLE_128B);
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   int B, int H, int Lq, int Lk, const long long* st,
                   float scale, cudaStream_t stream) {
  using S = F32Shape<D>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_tf32_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      S::SMEM);
  if (attr != cudaSuccess) return attr;
  CUtensorMap tm_q, tm_k, tm_v;
  bool ok = make_f32_map(&tm_q, q, D, B, H, Lq, st, BQ);
  ok = ok && make_f32_map(&tm_k, k, D, B, H, Lk, st + 3, S::BKV);
  ok = ok && make_f32_map(&tm_v, v, D, B, H, Lk, st + 6, 64);
  if (!ok) return cudaErrorInvalidValue;
  dim3 grid((Lq + BQ - 1) / BQ, H, B);
  flash_tf32_kernel<D><<<grid, S::THREADS, S::SMEM, stream>>>(
      tm_q, tm_k, tm_v, static_cast<float*>(out), Lq, Lk, st[9], st[10],
      st[11], scale * 1.4426950408889634f);
  return cudaGetLastError();
}

}  // namespace

// Dynamic shared memory of a launch at head dim D (0 for another D).
extern "C" int flash_attn_f32_smem_bytes(int D) {
  switch (D) {
    case 40: return F32Shape<40>::SMEM;
    case 64: return F32Shape<64>::SMEM;
    case 80: return F32Shape<80>::SMEM;
    case 96: return F32Shape<96>::SMEM;
    case 128: return F32Shape<128>::SMEM;
    case 160: return F32Shape<160>::SMEM;
    case 256: return F32Shape<256>::SMEM;
    case 384: return F32Shape<384>::SMEM;
    case 512: return F32Shape<512>::SMEM;
    default: return 0;
  }
}

// Plain C entry (bound with ctypes). q/k/v/out are f32 (B, H, L, D) views
// with unit stride along D, a 16-byte aligned base and strides that are
// multiples of 4 elements (the wrapper checks: TMA's rule); strides[12] =
// (b, h, l) element strides of q, k, v and out. D in {40, 64, 80, 96, 128,
// 160, 256, 384, 512}, Lk >= 1. Returns cudaGetLastError().
extern "C" int flash_attn_f32_launch(const void* q, const void* k,
                                     const void* v, void* out, int B, int H,
                                     int Lq, int Lk, int D,
                                     const long long* strides, float scale,
                                     void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 40: return launch<40>(q, k, v, out, B, H, Lq, Lk, strides, scale, s);
    case 64: return launch<64>(q, k, v, out, B, H, Lq, Lk, strides, scale, s);
    case 80: return launch<80>(q, k, v, out, B, H, Lq, Lk, strides, scale, s);
    case 96: return launch<96>(q, k, v, out, B, H, Lq, Lk, strides, scale, s);
    case 128:
      return launch<128>(q, k, v, out, B, H, Lq, Lk, strides, scale, s);
    case 160:
      return launch<160>(q, k, v, out, B, H, Lq, Lk, strides, scale, s);
    case 256:
      return launch<256>(q, k, v, out, B, H, Lq, Lk, strides, scale, s);
    case 384:
      return launch<384>(q, k, v, out, B, H, Lq, Lk, strides, scale, s);
    case 512:
      return launch<512>(q, k, v, out, B, H, Lq, Lk, strides, scale, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
