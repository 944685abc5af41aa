// K6: int8 flash attention forward (SageAttention-style), at any head dim
// that is a multiple of 128.
//
// Replaces the Pallas kernel of comfyui_gguf_tpu/ops/i8attn.py
// (_make_attn_kernel, launched by pallas_i8_attention). Operands come from
// the prep (csrc/i8attn_prep.cu on the card; ops/i8attn.py
// kernel_operands(quantize_attn_inputs(...)) as its plain version): per-row
// s8 q with the softmax scale folded into qs, per-row s8 mean-smoothed k,
// and either per-channel s8 v (mode "pv") or bf16 v (mode "qk"):
//
//   s[i, j]  = float(sum_d qq[i, d] * kq[j, d]) * qs[i] * ks[j]   (s32 exact)
//   online softmax over key tiles in f32 (running m, l, acc per row)
//   "pv":  pq = round_half_even(127 * p) as s8;
//          acc = acc*alpha + float(pq . vq)
//          out = acc * ((1/127) / l) * vs[d]
//   "qk":  acc = acc*alpha + bf16(p) . v (f32 accumulate);  out = acc / l
//
// p is quantized against the running row maximum, so the result depends on
// the key-tile size (BKV: 128 keys at D = 128, 64 at every other head dim);
// the plain version takes the same tile size (ops/i8attn.py
// kernel_block_kv).
//
// What bounds it: int8 tensor-core operations (4·L²·D per head, the P·V
// half at the bf16 rate in mode "qk"), and as much again the softmax's
// per-score work (L² exponentials on the special-function units, and about
// nine full-rate ALU operations a score). Design: a block owns 128 query
// rows of one (b, h); a producer warp loads them once by TMA and then
// streams K (with its ks) and V in tiles of BKV keys through a ring of
// shared tiles (TMA, swizzled, K and V completing on their own mbarriers;
// 3 stages at D = 128, 2 at 256). Two consumer warpgroups own 64 query rows
// each. S = Q·Kᵀ is wgmma m64nBKVk32 s8 with both operands in shared memory
// (q and k are K-major as stored: D contiguous). The f32 online softmax
// runs on the s32 accumulator in registers, in base 2, with few operations
// a score: the row maximum is taken over float(s)·ks and qs·log2 e applied
// in the exponent's FFMA, the 127 of mode "pv" is folded into the
// exponent, the code of 127·p is the low byte of 127·p + 1.5·2^23 and four
// codes pack by three byte permutes. At D = 128 each warpgroup issues the
// scores of tile j together with the P·V of tile j - 1 and runs the
// softmax of tile j while they run, and the two warpgroups take turns at
// issuing (named barriers), so one's products run under the other's
// softmax (FlashAttention-3's schedule); at D = 256 the 128-register
// accumulator leaves no room for that, and a warpgroup waits for each
// product. ptxas serializes the products of the D = 128 instances (its
// advisory C7520: a fence it inserts in a divergent path); a version it
// did not serialize (unconditional turn arrivals, V waited for before the
// turn, pad keys masked by an additive bias instead of a branch) measured
// slower on the H100 (PERF.md, Findings).
//
// "pv": s8 wgmma reads only K-major B operands, and for P·V the contracted
// dimension is the keys, so the prep stores v transposed, (BH, D, Lkp), keys
// contiguous. The accumulator of S is not the A fragment of P·V: thread
// (g, t) of a warp holds scores of keys {2t, 2t+1, 8+2t, 9+2t} of every
// 16-key group (rows g and g+8), while the register A operand of wgmma
// m64nNk32 s8 (the mma.sync m16n8k32 layout) wants keys 4t..4t+3 in one
// register. So the prep permutes the keys inside every 16-key group: key
// position 4t + e of Vᵀ holds key {2t, 2t+1, 8+2t, 9+2t}[e], and a thread
// packs the four codes it already holds into one A register, with no
// shuffle and no transpose in the kernel. The s32 product of each tile goes
// to f32 and onto acc·alpha (at D = 256 in four 64-column parts, which
// keeps the s32 temporary at 32 registers beside the 128 of the f32
// accumulator).
//
// "qk": P goes to bf16 A fragments in place, and V (bf16, (B, H, Lk, D) as
// given) is read MN-major with the transpose bit, as in flash_attn.cu.
//
// Head dims past 256 (the split instance): a block owns 128 of the output
// columns (grid z: Dh / 128 blocks for one query tile) and computes the
// scores over all Dh itself; Q and K reach it in 128-byte column chunks, a
// (Q chunk, K chunk) pair a slot of their own ring, so shared memory does
// not grow with Dh. Each block recomputes the scores, so the instance does
// Dh / 128 times the Q·Kᵀ work of one pass; it exists so that every head
// dim the gate admits has a kernel (no ported model has such a head dim).
//
// Keys past Lk are zero-filled by TMA and masked to -1e30; the output
// leaves through a swizzled shared tile and a TMA store into the (B, Lq, H,
// D) storage of the result, clipped at Lq. The result takes q's dtype, as
// pallas_i8_attention's out_shape does: bf16 or f16 through that tile
// (round to nearest even, the plain version's .to(q.dtype)), f32 stored
// from the registers with no rounding (a 64-row f32 tile would double
// the shared tile of the output). The operands are the same integers and
// f32 scales for every dtype (the prep reads bf16, f16 and f32 q/k/v).
// In mode "qk" V is bf16 whatever q's dtype: the reference rounds it to
// bf16 there (ops/i8attn.py quantize_attn_inputs).
#include <string.h>

#include "common.cuh"
#include "tma.cuh"

using namespace gguf_cuda;

namespace {

constexpr int BQ = 128;       // query rows a block (2 consumer warpgroups)
constexpr int THREADS = 384;  // 2 consumer warpgroups + the producer's
constexpr float NEG = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LOG2_127 = 6.9886846867721655f;  // 127 = 2^LOG2_127
constexpr float MAGIC = 12582912.0f;  // 1.5 * 2^23

// D: the output columns a block owns, the head dim itself but in the split
// instance (SPLIT: D = 128 of a head dim past 256)
template <int D, bool PV8, bool SPLIT = false>
struct AShape {
  // D = 128 overlaps each warpgroup's softmax with its own products and
  // needs a third stage; the others keep two (at D = 256 the accumulator
  // leaves no registers for the overlap, and "qk" no shared memory for a
  // third)
  static constexpr bool PIPE = D == 128 && !SPLIT;
  static constexpr int BKV = PIPE ? 128 : 64;  // keys a tile
  static constexpr int STAGES = PIPE ? 3 : 2;
  static constexpr int NC = D / 128;           // 128-byte chunks of a row
  static constexpr int Q_CHUNK = BQ * 128;
  static constexpr int K_CHUNK = BKV * 128;
  // SPLIT: Q and K stream through a ring of SST (Q chunk, K chunk) slots,
  // which takes the place of the resident Q tile and the K stages
  static constexpr int SST = SPLIT ? 4 : 0;
  static constexpr int SLOT = Q_CHUNK + K_CHUNK;
  static constexpr int Q_BYTES = SPLIT ? SST * SLOT : NC * Q_CHUNK;
  static constexpr int K_BYTES = SPLIT ? 0 : NC * K_CHUNK;
  // "pv": Vᵀ, D rows of BKV key bytes; "qk": D / 64 blocks of (BKV keys,
  // 64 bf16 columns)
  static constexpr int V_BLOCK = BKV * 128;
  static constexpr int V_BYTES = PV8 ? D * BKV : (D / 64) * V_BLOCK;
  static constexpr int O_WG = 64 * D * 2;  // a warpgroup's bf16 rows
  static constexpr int KS_BYTES = BKV * 4;
  // P of a tile as A fragments of 4 registers: one a k32 step (s8) or a
  // k16 step (bf16)
  static constexpr int P_STEPS = PV8 ? BKV / 32 : BKV / 16;
  static constexpr int SMEM = 1024 + Q_BYTES + STAGES * (K_BYTES + V_BYTES) +
                              2 * O_WG + STAGES * KS_BYTES + 256;
};

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Four codes 0..127 held as the low bytes of (x + 1.5·2^23)'s bits, packed
// lowest first into one s8 A register.
__device__ __forceinline__ uint32_t pack_codes(float a, float b, float c,
                                               float d) {
  uint32_t lo, hi, r;
  asm("prmt.b32 %0, %1, %2, 0x0040;\n"
      : "=r"(lo) : "r"(__float_as_uint(a)), "r"(__float_as_uint(b)));
  asm("prmt.b32 %0, %1, %2, 0x0040;\n"
      : "=r"(hi) : "r"(__float_as_uint(c)), "r"(__float_as_uint(d)));
  asm("prmt.b32 %0, %1, %2, 0x5410;\n" : "=r"(r) : "r"(lo), "r"(hi));
  return r;
}

// s (+)= the k32 step of Q·Kᵀ; the first step overwrites s (see the _z
// products in common.cuh)
template <int BKV, bool FIRST>
__device__ __forceinline__ void wgmma_scores(int (&s)[BKV / 2], uint64_t da,
                                             uint64_t db) {
  if constexpr (BKV == 128) {
    if constexpr (FIRST) {
      wgmma_m64n128k32_s8_z(s, da, db);
    } else {
      wgmma_m64n128k32_s8(s, da, db);
    }
  } else {
    if constexpr (FIRST) {
      wgmma_m64n64k32_s8_z(s, da, db);
    } else {
      wgmma_m64n64k32_s8(s, da, db);
    }
  }
}

template <int D, bool PV8, bool SPLIT>
__global__ void __launch_bounds__(THREADS, 1)
i8attn_kernel(const __grid_constant__ CUtensorMap tm_q,   // (Dh, Lq, BH) s8
              const __grid_constant__ CUtensorMap tm_k,   // (Dh, Lk, BH) s8
              const __grid_constant__ CUtensorMap tm_ks,  // (Lkp, BH) f32
              const __grid_constant__ CUtensorMap tm_v,   // see launch()
              const __grid_constant__ CUtensorMap tm_o,   // (Dh, Lq, H, B)
              const float* __restrict__ qs,               // (BH, Lq)
              const float* __restrict__ vs,               // (BH, Dh)
              int H, int Lq, int Lk, int Dh,
              float* __restrict__ out32,  // out_kind 2: (B, H, Lq, Dh)
              long long ob, long long oh, long long ol, int out_kind) {
  using S = AShape<D, PV8, SPLIT>;
  constexpr int BKV = S::BKV;
  constexpr int ST = S::STAGES;
  constexpr int NO = D / 128;  // 128-column parts of the accumulator
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t{1023});
  uint8_t* q_s = smem;                       // NC x (BQ, 128 B); SPLIT: SST
                                             // slots (Q chunk, K chunk)
  uint8_t* k_s = q_s + S::Q_BYTES;           // ST stages x NC x (BKV, 128 B)
  uint8_t* v_s = k_s + ST * S::K_BYTES;      // ST stages x V_BYTES
  uint8_t* o_s = v_s + ST * S::V_BYTES;      // 2 warpgroups x O_WG
  float* ks_s = reinterpret_cast<float*>(o_s + 2 * S::O_WG);  // ST x BKV
  uint64_t* q_full = reinterpret_cast<uint64_t*>(ks_s + ST * BKV);
  uint64_t* k_full = q_full + 1;
  uint64_t* v_full = k_full + ST;
  uint64_t* empty = v_full + ST;
  uint64_t* s_full = empty + ST;  // SPLIT: the slots of Q and K chunks
  uint64_t* s_empty = s_full + S::SST;

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh - b * H;
  const int q0 = blockIdx.x * BQ;
  const int c0 = blockIdx.z * D;  // the block's first output column
  const int n_kv = (Lk + BKV - 1) / BKV;
  const int nd = Dh / 128;  // SPLIT: 128-byte chunks of a q or k row

  if (tid == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < ST; ++s) {
      mbar_init(&k_full[s], 1);
      mbar_init(&v_full[s], 1);
      mbar_init(&empty[s], 256);
    }
    for (int s = 0; s < S::SST; ++s) {
      mbar_init(&s_full[s], 1);
      mbar_init(&s_empty[s], 256);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (warp >= 8) {
    // ---- producer warpgroup: one lane issues every load ------------------
    // (register pool: 40 * 128 + 232 * 256 = 168 * 384, as in gemm_wgmma.cuh)
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    // V of tile j (the block's D columns) into stage st
    auto load_v = [&](int j, int st) {
      uint8_t* vd = v_s + st * S::V_BYTES;
      if constexpr (PV8) {
        tma_load_3d(vd, &tm_v, &v_full[st], j * BKV, c0, bh);
      } else {
        for (int c = 0; c < D / 64; ++c)
          tma_load_4d(vd + c * S::V_BLOCK, &tm_v, &v_full[st], c0 + c * 64,
                      j * BKV, h, b);
      }
    };
    if constexpr (!SPLIT) {
      if (warp == 8 && lane == 0) {
        mbar_arrive_expect_tx(q_full, S::Q_BYTES);
        for (int c = 0; c < S::NC; ++c)
          tma_load_3d(q_s + c * S::Q_CHUNK, &tm_q, q_full, c * 128, q0, bh);
        for (int j = 0; j < n_kv; ++j) {
          const int st = j % ST;
          mbar_wait(&empty[st], ((j / ST) & 1) ^ 1);
          mbar_arrive_expect_tx(&k_full[st], S::K_BYTES + S::KS_BYTES);
          for (int c = 0; c < S::NC; ++c)
            tma_load_3d(k_s + st * S::K_BYTES + c * S::K_CHUNK, &tm_k,
                        &k_full[st], c * 128, j * BKV, bh);
          tma_load_2d(ks_s + st * BKV, &tm_ks, &k_full[st], j * BKV, bh);
          mbar_arrive_expect_tx(&v_full[st], S::V_BYTES);
          load_v(j, st);
        }
      }
    } else if (warp == 8 && lane == 0) {
      // tile j's nd (Q chunk, K chunk) pairs through the slot ring, then its
      // V columns with its ks
      int n = 0;
      for (int j = 0; j < n_kv; ++j) {
        for (int c = 0; c < nd; ++c, ++n) {
          const int sl = n % S::SST;
          uint8_t* sd = q_s + sl * S::SLOT;
          mbar_wait(&s_empty[sl], ((n / S::SST) & 1) ^ 1);
          mbar_arrive_expect_tx(&s_full[sl], S::SLOT);
          tma_load_3d(sd, &tm_q, &s_full[sl], c * 128, q0, bh);
          tma_load_3d(sd + S::Q_CHUNK, &tm_k, &s_full[sl], c * 128, j * BKV,
                      bh);
        }
        const int st = j % ST;
        mbar_wait(&empty[st], ((j / ST) & 1) ^ 1);
        mbar_arrive_expect_tx(&v_full[st], S::V_BYTES + S::KS_BYTES);
        tma_load_2d(ks_s + st * BKV, &tm_ks, &v_full[st], j * BKV, bh);
        load_v(j, st);
      }
    }
  } else {
    // ---- consumers: warpgroup wg owns query rows 64*wg .. 64*wg+63 -------
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int wg = warp >> 2;
    const int w = warp & 3;
    const int g = lane >> 2;
    const int t = lane & 3;
    const uint32_t qa = smem_u32(q_s) + wg * 64 * 128;
    const uint32_t kb = smem_u32(k_s);
    const uint32_t vb = smem_u32(v_s);
    const int r = w * 16 + g;  // rows r, r + 8 of the warpgroup's 64
    const int row0 = q0 + wg * 64 + r;
    // the row scales of the base-2 logits: qs · log2(e)
    float qsl[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int row = row0 + 8 * hh;
      qsl[hh] = row < Lq
                    ? qs[static_cast<size_t>(bh) * Lq + row] * LOG2E
                    : 0.0f;
    }

    // o[n][4i + 2h + c] = row g + 8h, column 128n + 8i + 2t + c; in mode
    // "pv" the sum of 127·p·vq (the 1/127 is folded into 1/l at the end)
    float o[NO][64];
#pragma unroll
    for (int n = 0; n < NO; ++n)
#pragma unroll
      for (int i = 0; i < 64; ++i) o[n][i] = 0.0f;
    float m_run[2] = {NEG, NEG};  // running row maxima of float(s) · ks
    float l_run[2] = {0.0f, 0.0f};

    // S = Q Kᵀ of the tile in stage st: 64 rows x BKV keys, exact in s32
    int s[BKV / 2];
    auto issue_scores = [&](int st) {
      const uint32_t kt = kb + st * S::K_BYTES;
      wgmma_scores<BKV, true>(s, wgmma_desc_k128(qa), wgmma_desc_k128(kt));
#pragma unroll
      for (int c = 0; c < S::NC; ++c)
#pragma unroll
        for (int kk = c == 0 ? 1 : 0; kk < 4; ++kk)
          wgmma_scores<BKV, false>(
              s, wgmma_desc_k128(qa + c * S::Q_CHUNK) + 2 * kk,
              wgmma_desc_k128(kt + c * S::K_CHUNK) + 2 * kk);
    };
    // SPLIT: the scores of tile j, a chunk of the slot ring at a time, each
    // slot released once its product has run
    auto split_scores = [&](int j) {
      if constexpr (SPLIT) {
#pragma unroll
        for (int i = 0; i < BKV / 2; ++i) s[i] = 0;
        for (int c = 0, n = j * nd; c < nd; ++c, ++n) {
          const int sl = n % S::SST;
          const uint32_t sq = smem_u32(q_s) + sl * S::SLOT;
          mbar_wait(&s_full[sl], (n / S::SST) & 1);
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
            wgmma_scores<BKV, false>(
                s, wgmma_desc_k128(sq + wg * 64 * 128) + 2 * kk,
                wgmma_desc_k128(sq + S::Q_CHUNK) + 2 * kk);
          wgmma_commit();
          wgmma_wait<0>();
#pragma unroll
          for (int i = 0; i < BKV / 2; ++i) reg_fence(s[i]);
          mbar_arrive(&s_empty[sl]);
        }
      }
    };

    // The online softmax of tile j (stage st) on s: y = float(s32) · ks
    // (pad keys at -1e30) and its running row maximum m, the base-2 logits
    // qs·log2e·(y - m) in one FFMA (qs > 0 keeps the maximum), the running
    // sums, and P as A fragments. "pv" quantizes p at the static scale
    // 127 with the 127 folded into the exponent: pq = round(2^(x - m +
    // log2 127)), and l sums 127·p. s[4i + 2h + c] is row g + 8h, key
    // 8i + 2t + c of the tile; keys 32kk .. 32kk+31 are column blocks
    // 4kk .. 4kk+3, so registers 0/1 (rows g, g+8) of k32 step kk take
    // blocks 4kk, 4kk+1 and registers 2/3 take 4kk+2, 4kk+3 (the permuted
    // key order of Vᵀ matches).
    auto softmax = [&](int j, int st, uint32_t (&P)[S::P_STEPS][4],
                       float (&alpha)[2]) {
      const float* ksv = ks_s + st * BKV;
      const int kv0 = j * BKV;
      float x[BKV / 2];
#pragma unroll
      for (int i = 0; i < BKV / 8; ++i) {
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const float kscale = ksv[8 * i + 2 * t + c];
          x[4 * i + c] = __fmul_rn(__int2float_rn(s[4 * i + c]), kscale);
          x[4 * i + 2 + c] =
              __fmul_rn(__int2float_rn(s[4 * i + 2 + c]), kscale);
        }
      }
      if (kv0 + BKV > Lk) {
#pragma unroll
        for (int i = 0; i < BKV / 2; ++i)
          if (kv0 + 8 * (i >> 2) + 2 * t + (i & 1) >= Lk) x[i] = NEG;
      }
      // row maxima and sums over four partial chains a row, so that the
      // dependent operations overlap
      float mq[2][4];
#pragma unroll
      for (int i = 0; i < 8; ++i) mq[(i >> 1) & 1][(i & 1) | ((i >> 1) & 2)] =
          fmaxf(x[i], x[i + 8]);
#pragma unroll
      for (int i = 16; i < BKV / 2; ++i) {
        float& q = mq[(i >> 1) & 1][(i & 1) | ((i >> 1) & 2)];
        q = fmaxf(q, x[i]);
      }
      float mx[2], mb[2];
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
        mx[hh] = fmaxf(fmaxf(fmaxf(mq[hh][0], mq[hh][1]),
                             fmaxf(mq[hh][2], mq[hh][3])),
                       m_run[hh]);
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 1));
        mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 2));
        alpha[hh] = ex2((m_run[hh] - mx[hh]) * qsl[hh]);
        m_run[hh] = mx[hh];
        l_run[hh] *= alpha[hh];
        mb[hh] = PV8 ? mx[hh] * qsl[hh] - LOG2_127 : mx[hh] * qsl[hh];
      }
      float lq[2][4] = {};
#pragma unroll
      for (int i = 0; i < BKV / 2; ++i) {
        x[i] = ex2(__fmaf_rn(x[i], qsl[(i >> 1) & 1], -mb[(i >> 1) & 1]));
        lq[(i >> 1) & 1][(i & 1) | ((i >> 1) & 2)] += x[i];
      }
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
        l_run[hh] += (lq[hh][0] + lq[hh][1]) + (lq[hh][2] + lq[hh][3]);
      if constexpr (PV8) {
        // round(127 p) as the low byte of 127 p + 1.5·2^23
#pragma unroll
        for (int i = 0; i < BKV / 2; ++i) x[i] = __fadd_rn(x[i], MAGIC);
#pragma unroll
        for (int kk = 0; kk < BKV / 32; ++kk) {
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const float* a = x + 4 * (4 * kk + 2 * half);
            P[kk][2 * half] = pack_codes(a[0], a[1], a[4], a[5]);
            P[kk][2 * half + 1] = pack_codes(a[2], a[3], a[6], a[7]);
          }
        }
      } else {
        // keys 16kk .. 16kk+15 are column blocks 2kk, 2kk+1: x[8kk ..]
#pragma unroll
        for (int kk = 0; kk < BKV / 16; ++kk) {
          P[kk][0] = pack_bf16x2(x[8 * kk], x[8 * kk + 1]);
          P[kk][1] = pack_bf16x2(x[8 * kk + 2], x[8 * kk + 3]);
          P[kk][2] = pack_bf16x2(x[8 * kk + 4], x[8 * kk + 5]);
          P[kk][3] = pack_bf16x2(x[8 * kk + 6], x[8 * kk + 7]);
        }
      }
    };

    // O (+)= P V of the tile in stage st, issued (not waited for): "pv"
    // into the s32 temporary pv (D = 128: all 128 columns), "qk" onto o
    int pv[64];
    auto issue_pv = [&](int st, const uint32_t (&P)[S::P_STEPS][4]) {
      const uint32_t vt = vb + st * S::V_BYTES;
      if constexpr (PV8) {
        if constexpr (D == 128) {
          // Vᵀ: 128 d rows of 128 key bytes, 128-byte swizzle
          wgmma_m64n128k32_s8_rs_z(pv, P[0], wgmma_desc_k128(vt));
#pragma unroll
          for (int kk = 1; kk < BKV / 32; ++kk)
            wgmma_m64n128k32_s8_rs(pv, P[kk], wgmma_desc_k128(vt) + 2 * kk);
        }
      } else {
        // V's 64-column blocks lie V_BLOCK apart
#pragma unroll
        for (int kk = 0; kk < BKV / 16; ++kk)
#pragma unroll
          for (int n = 0; n < NO; ++n)
            wgmma_m64n128k16_rs_tb(
                o[n], P[kk],
                wgmma_desc_mn128(vt + 2 * n * S::V_BLOCK + kk * 16 * 128,
                                 S::V_BLOCK));
      }
    };
    auto rescale_o = [&](const float (&alpha)[2]) {
#pragma unroll
      for (int n = 0; n < NO; ++n)
#pragma unroll
        for (int i = 0; i < 64; ++i) o[n][i] *= alpha[(i >> 1) & 1];
    };

    if constexpr (!SPLIT) mbar_wait(q_full, 0);
    if constexpr (S::PIPE) {
      // Each warpgroup issues the scores of tile j with the P·V of tile
      // j - 1 and runs the softmax of tile j while they run; the two
      // warpgroups take turns at issuing (named barriers 3 and 4), so one's
      // products run under the other's softmax.
      uint32_t P[S::P_STEPS][4];
      float alpha[2];
      mbar_wait(&k_full[0], 0);
      wgmma_fence();
      issue_scores(0);
      wgmma_commit();
      wgmma_wait<0>();
#pragma unroll
      for (int i = 0; i < BKV / 2; ++i) reg_fence(s[i]);
      softmax(0, 0, P, alpha);
      if (wg == 1 && n_kv > 1) named_bar_arrive(3, 256);
      for (int j = 1; j < n_kv; ++j) {
        const int st = j % ST;
        const int sp = (j - 1) % ST;
        mbar_wait(&k_full[st], (j / ST) & 1);
        named_bar_sync(3 + wg, 256);  // the other warpgroup has issued
        if constexpr (!PV8) rescale_o(alpha);
        wgmma_fence();
        issue_scores(st);
        wgmma_commit();
        mbar_wait(&v_full[sp], ((j - 1) / ST) & 1);
        issue_pv(sp, P);
        wgmma_commit();
        if (wg == 0 || j + 1 < n_kv) named_bar_arrive(4 - wg, 256);
        wgmma_wait<1>();
#pragma unroll
        for (int i = 0; i < BKV / 2; ++i) reg_fence(s[i]);
        uint32_t Pn[S::P_STEPS][4];
        float an[2];
        softmax(j, st, Pn, an);
        wgmma_wait<0>();
#pragma unroll
        for (int kk = 0; kk < S::P_STEPS; ++kk)
#pragma unroll
          for (int e = 0; e < 4; ++e) reg_fence(P[kk][e]);
        if constexpr (PV8) {
#pragma unroll
          for (int i = 0; i < 64; ++i) {
            reg_fence(pv[i]);
            o[0][i] = o[0][i] * alpha[(i >> 1) & 1] + __int2float_rn(pv[i]);
          }
        } else {
#pragma unroll
          for (int n = 0; n < NO; ++n)
#pragma unroll
            for (int i = 0; i < 64; ++i) reg_fence(o[n][i]);
        }
        mbar_arrive(&empty[sp]);
#pragma unroll
        for (int kk = 0; kk < S::P_STEPS; ++kk)
#pragma unroll
          for (int e = 0; e < 4; ++e) P[kk][e] = Pn[kk][e];
        alpha[0] = an[0];
        alpha[1] = an[1];
      }
      const int sl = (n_kv - 1) % ST;
      if constexpr (!PV8) rescale_o(alpha);
      mbar_wait(&v_full[sl], ((n_kv - 1) / ST) & 1);
      wgmma_fence();
      issue_pv(sl, P);
      wgmma_commit();
      wgmma_wait<0>();
#pragma unroll
      for (int kk = 0; kk < S::P_STEPS; ++kk)
#pragma unroll
        for (int e = 0; e < 4; ++e) reg_fence(P[kk][e]);
      if constexpr (PV8) {
#pragma unroll
        for (int i = 0; i < 64; ++i) {
          reg_fence(pv[i]);
          o[0][i] = o[0][i] * alpha[(i >> 1) & 1] + __int2float_rn(pv[i]);
        }
      } else {
#pragma unroll
        for (int n = 0; n < NO; ++n)
#pragma unroll
          for (int i = 0; i < 64; ++i) reg_fence(o[n][i]);
      }
      mbar_arrive(&empty[sl]);
    } else {
      for (int j = 0; j < n_kv; ++j) {
        const int st = j % ST;
        const uint32_t ph = (j / ST) & 1;
        if constexpr (SPLIT) {
          split_scores(j);
          mbar_wait(&v_full[st], ph);  // tile j's ks comes with its V
        } else {
          mbar_wait(&k_full[st], ph);
          wgmma_fence();
          issue_scores(st);
          wgmma_commit();
          wgmma_wait<0>();
        }
#pragma unroll
        for (int i = 0; i < BKV / 2; ++i) reg_fence(s[i]);
        uint32_t P[S::P_STEPS][4];
        float alpha[2];
        softmax(j, st, P, alpha);
        mbar_wait(&v_full[st], ph);
        if constexpr (PV8) {
          // Vᵀ: D d rows of 64 key bytes, 64-byte swizzle; parts of 64
          // output columns keep the s32 temporary at 32 registers
          const uint32_t vt = vb + st * S::V_BYTES;
#pragma unroll
          for (int dc = 0; dc < D / 64; ++dc) {
            int part[32];
            const uint64_t dv = wgmma_desc_k64(vt + dc * 64 * BKV);
            wgmma_fence();
            wgmma_m64n64k32_s8_rs_z(part, P[0], dv);
#pragma unroll
            for (int kk = 1; kk < BKV / 32; ++kk)
              wgmma_m64n64k32_s8_rs(part, P[kk], dv + 2 * kk);
            wgmma_commit();
            wgmma_wait<0>();
#pragma unroll
            for (int i = 0; i < 32; ++i) {
              reg_fence(part[i]);
              float& oi = o[dc >> 1][32 * (dc & 1) + i];
              oi = oi * alpha[(i >> 1) & 1] + __int2float_rn(part[i]);
            }
          }
        } else {
          rescale_o(alpha);
          wgmma_fence();
          issue_pv(st, P);
          wgmma_commit();
          wgmma_wait<0>();
#pragma unroll
          for (int n = 0; n < NO; ++n)
#pragma unroll
            for (int i = 0; i < 64; ++i) reg_fence(o[n][i]);
        }
#pragma unroll
        for (int kk = 0; kk < S::P_STEPS; ++kk)
#pragma unroll
          for (int e = 0; e < 4; ++e) reg_fence(P[kk][e]);
        mbar_arrive(&empty[st]);
      }
    }

#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      l_run[hh] += __shfl_xor_sync(0xffffffffu, l_run[hh], 1);
      l_run[hh] += __shfl_xor_sync(0xffffffffu, l_run[hh], 2);
    }
    // "pv": l sums 127·p, so 1/l is the plain version's (1/127)/l
    const float inv0 = __fdiv_rn(1.0f, l_run[0]);
    const float inv1 = __fdiv_rn(1.0f, l_run[1]);
    const float* vsp = vs + static_cast<size_t>(bh) * Dh + c0;
    // (acc * inv) * vs[d], rounded at each step as the plain version does
    if (out_kind == 2) {
      // f32 out: rows r and r + 8 straight from the registers, rows < Lq
      float* op = out32 + b * ob + h * oh + c0;
#pragma unroll
      for (int i = 0; i < D / 8; ++i) {
        const int col = 8 * i + 2 * t;
        const float* a = &o[i >> 4][4 * (i & 15)];
        float v0 = 1.0f, v1 = 1.0f;
        if constexpr (PV8) {
          v0 = vsp[col];
          v1 = vsp[col + 1];
        }
        if (row0 < Lq)
          *reinterpret_cast<float2*>(op + row0 * ol + col) =
              make_float2(__fmul_rn(__fmul_rn(a[0], inv0), v0),
                          __fmul_rn(__fmul_rn(a[1], inv0), v1));
        if (row0 + 8 < Lq)
          *reinterpret_cast<float2*>(op + (row0 + 8) * ol + col) =
              make_float2(__fmul_rn(__fmul_rn(a[2], inv1), v0),
                          __fmul_rn(__fmul_rn(a[3], inv1), v1));
      }
      return;
    }
    // bf16 or f16 out (out_kind 0 or 1, rounded to nearest even): rows r
    // and r + 8 of the warpgroup's tile, as D / 64 column blocks of (64
    // rows, 128 bytes) with the 128-byte swizzle, then a TMA store
    uint8_t* ot = o_s + wg * S::O_WG;
    const bool f16 = out_kind == 1;
#pragma unroll
    for (int i = 0; i < D / 8; ++i) {
      const int col = 8 * i + 2 * t;
      const float* a = &o[i >> 4][4 * (i & 15)];
      float c0 = 1.0f, c1 = 1.0f;
      if constexpr (PV8) {
        c0 = vsp[col];
        c1 = vsp[col + 1];
      }
      uint8_t* dst = ot + (i >> 3) * (64 * 128) + r * 128 +
                     (((i & 7) ^ (r & 7)) << 4) + 4 * t;
      const float x0 = __fmul_rn(__fmul_rn(a[0], inv0), c0);
      const float x1 = __fmul_rn(__fmul_rn(a[1], inv0), c1);
      const float x2 = __fmul_rn(__fmul_rn(a[2], inv1), c0);
      const float x3 = __fmul_rn(__fmul_rn(a[3], inv1), c1);
      *reinterpret_cast<uint32_t*>(dst) =
          f16 ? pack_f16x2(x0, x1) : pack_bf16x2(x0, x1);
      *reinterpret_cast<uint32_t*>(dst + 8 * 128) =
          f16 ? pack_f16x2(x2, x3) : pack_bf16x2(x2, x3);
    }
    fence_proxy_async();
    named_bar_sync(1 + wg, 128);
    if ((tid & 127) == 0 && q0 + 64 * wg < Lq) {
#pragma unroll
      for (int c = 0; c < D / 64; ++c)
        tma_store_4d(&tm_o, ot + c * (64 * 128), c0 + 64 * c, q0 + 64 * wg,
                     h, b);
      bulk_commit();
      bulk_wait<0>();  // the store has read shared memory
    }
  }
}

// 4-D tensor map of a (B, H, L, D) view of 2-byte elements (bf16, or f16
// with f16 set) with element strides st = (b, h, l) and unit stride along
// D; box: 64 columns of `rows` rows, 128-byte swizzle. A dimension of
// extent 1 is never stepped, so it takes the stride D.
bool make_bhld_map(CUtensorMap* map, const void* base, int B, int H, int L,
                   int D, const long long* st, int rows, bool f16 = false) {
  const long long sb = B > 1 ? st[0] : D;
  const long long sh = H > 1 ? st[1] : D;
  const long long sl = L > 1 ? st[2] : D;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D),
                              static_cast<cuuint64_t>(L),
                              static_cast<cuuint64_t>(H),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(sl) * 2,
                                 static_cast<cuuint64_t>(sh) * 2,
                                 static_cast<cuuint64_t>(sb) * 2};
  const cuuint32_t box[4] = {64, static_cast<cuuint32_t>(rows), 1, 1};
  return make_map_nd(map,
                     f16 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16
                         : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                     base, 4, dims, strides, box, CU_TENSOR_MAP_SWIZZLE_128B);
}

// 3-D tensor map of a contiguous s8 (n3, n2, n1) array, box (b1 bytes, b2
// rows, 1).
bool make_s8_map(CUtensorMap* map, const void* base, int n1, int n2, int n3,
                 int b1, int b2, CUtensorMapSwizzle sw) {
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(n1),
                              static_cast<cuuint64_t>(n2),
                              static_cast<cuuint64_t>(n3)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(n1),
                                 static_cast<cuuint64_t>(n1) * n2};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(b1),
                             static_cast<cuuint32_t>(b2), 1};
  return make_map_nd(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, base, 3, dims,
                     strides, box, sw);
}

// D: the head dim Dh, or (SPLIT) the 128 output columns a block owns of a
// head dim past 256
template <int D, bool PV8, bool SPLIT>
cudaError_t launch(const void* qq, const void* qs, const void* kq,
                   const void* ks, const void* v, const void* vs, void* out,
                   int B, int H, int Lq, int Lk, int Lkp, int Dh,
                   const long long* st, int out_kind, cudaStream_t stream) {
  using S = AShape<D, PV8, SPLIT>;
  constexpr int BKV = S::BKV;
  static const cudaError_t attr = cudaFuncSetAttribute(
      i8attn_kernel<D, PV8, SPLIT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, S::SMEM);
  if (attr != cudaSuccess) return attr;
  if (Lkp % BKV != 0 || Lkp < Lk || Dh % D != 0) return cudaErrorInvalidValue;
  const int BH = B * H;
  CUtensorMap tm_q, tm_k, tm_ks, tm_v, tm_o;
  bool ok = make_s8_map(&tm_q, qq, Dh, Lq, BH, 128, BQ,
                        CU_TENSOR_MAP_SWIZZLE_128B);
  ok = ok && make_s8_map(&tm_k, kq, Dh, Lk, BH, 128, BKV,
                         CU_TENSOR_MAP_SWIZZLE_128B);
  ok = ok && make_map(&tm_ks, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, ks, BH,
                      Lkp, 1, BKV, CU_TENSOR_MAP_SWIZZLE_NONE);
  if constexpr (PV8) {
    // Vᵀ (BH, Dh, Lkp): boxes of BKV keys x the block's D rows, swizzled by
    // the row width (128 bytes at BKV = 128, 64 at BKV = 64)
    ok = ok && make_s8_map(&tm_v, v, Lkp, Dh, BH, BKV, D,
                           BKV == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                                      : CU_TENSOR_MAP_SWIZZLE_64B);
  } else {
    ok = ok && make_bhld_map(&tm_v, v, B, H, Lk, Dh, st, BKV);
  }
  if (out_kind == 2) {
    memset(&tm_o, 0, sizeof(tm_o));  // f32 out: stored from the registers
  } else {
    ok = ok && make_bhld_map(&tm_o, out, B, H, Lq, Dh, st + 3, 64,
                             out_kind == 1);
  }
  if (!ok) return cudaErrorInvalidValue;
  dim3 grid((Lq + BQ - 1) / BQ, BH, Dh / D);
  i8attn_kernel<D, PV8, SPLIT><<<grid, THREADS, S::SMEM, stream>>>(
      tm_q, tm_k, tm_ks, tm_v, tm_o, static_cast<const float*>(qs),
      static_cast<const float*>(vs), H, Lq, Lk, Dh, static_cast<float*>(out),
      st[3], st[4], st[5], out_kind);
  return cudaGetLastError();
}

}  // namespace

// Dynamic shared memory of a launch at head dim D and mode (0 for a D that
// is no positive multiple of 128).
extern "C" int i8attn_smem_bytes(int D, int pv_int8) {
  if (D == 128) return pv_int8 ? AShape<128, true>::SMEM
                               : AShape<128, false>::SMEM;
  if (D == 256) return pv_int8 ? AShape<256, true>::SMEM
                               : AShape<256, false>::SMEM;
  if (D > 0 && D % 128 == 0)
    return pv_int8 ? AShape<128, true, true>::SMEM
                   : AShape<128, false, true>::SMEM;
  return 0;
}

// Plain C entry (bound with ctypes), on the operands of the prep
// (ops/i8attn.py kernel_operands): qq (BH, Lq, D) and kq (BH, Lk, D)
// contiguous s8, qs (BH, Lq) and ks (BH, Lkp) contiguous f32, Lkp a
// multiple of the key tile. pv_int8 != 0: v is Vᵀ (BH, D, Lkp) s8 in the
// permuted key order and vs (BH, D) f32; else v is a bf16 (B, H, Lk, D)
// view with unit stride along D and vs is unused. out is a (B, H, Lq, D)
// view with unit stride along D, bf16 (out_kind 0), f16 (1) or f32 (2);
// strides[6] = (b, h, l) element strides of v (mode "qk") and of out. The
// wrapper checks that D is a multiple of 128, Lk >= 1 and 16-byte aligned
// rows. Returns cudaGetLastError().
extern "C" int i8attn_launch(const void* qq, const void* qs, const void* kq,
                             const void* ks, const void* v, const void* vs,
                             void* out, int B, int H, int Lq, int Lk, int Lkp,
                             int D, int pv_int8, const long long* strides,
                             int out_kind, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (out_kind < 0 || out_kind > 2)
    return static_cast<int>(cudaErrorInvalidValue);
  if (D == 128) {
    return pv_int8 ? launch<128, true, false>(qq, qs, kq, ks, v, vs, out, B,
                                              H, Lq, Lk, Lkp, D, strides,
                                              out_kind, s)
                   : launch<128, false, false>(qq, qs, kq, ks, v, vs, out, B,
                                               H, Lq, Lk, Lkp, D, strides,
                                               out_kind, s);
  }
  if (D == 256) {
    return pv_int8 ? launch<256, true, false>(qq, qs, kq, ks, v, vs, out, B,
                                              H, Lq, Lk, Lkp, D, strides,
                                              out_kind, s)
                   : launch<256, false, false>(qq, qs, kq, ks, v, vs, out, B,
                                               H, Lq, Lk, Lkp, D, strides,
                                               out_kind, s);
  }
  if (D > 0 && D % 128 == 0) {
    return pv_int8 ? launch<128, true, true>(qq, qs, kq, ks, v, vs, out, B, H,
                                             Lq, Lk, Lkp, D, strides,
                                             out_kind, s)
                   : launch<128, false, true>(qq, qs, kq, ks, v, vs, out, B,
                                              H, Lq, Lk, Lkp, D, strides,
                                              out_kind, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

