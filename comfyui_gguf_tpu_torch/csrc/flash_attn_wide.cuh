// K7's wide-head body: flash attention forward at D = 384 and 512, bf16 or
// f16 in and out, the scores computed once. Instantiated from flash_attn.cu
// (bf16) and flash_attn_f16.cu (f16) through flash_dispatch below, beside
// flash_attn.cuh's body for D <= 256 (whose header says what K7 replaces).
//
// These head dims are the single-head mid-block attentions of the Wan 2.1
// VAE (384 channels) and the HunyuanVideo VAE (512) over a frame's
// positions. What bounds them is the tensor cores (4·Lq·Lk·D operations a
// head). The f32 O accumulator caps the query rows a block holds at 64
// (64 x 512 f32 is 128 registers a consumer thread over 256 threads).
//
// Design (the f32 body's, flash_attn_f32.cu, on bf16/f16 wgmma). A block
// owns WQ = 64 query rows of one (b, h) and walks the keys in tiles of
// WKV = 128; two consumer warpgroups and a producer warpgroup.
//   S = Q·Kᵀ once per (query tile, key tile): warpgroup w takes keys 64w ..
//     64w + 63 of the tile, m64n64k16 wgmmas with both operands in shared
//     memory, accumulated over all of D in 64-wide d chunks;
//   the softmax (base 2, scale folded in, f32) exchanges each row's max over
//     the two warpgroups' keys through shared memory (a named barrier), so
//     both hold the same running max; each keeps the row sum of its own
//     keys, added at the end;
//   P, rounded to q's dtype, is written once to shared memory query-major
//     with keys contiguous (warpgroup w writes keys 64w .. of each row,
//     the 128-byte swizzle a TMA box would give), so it is the K-major A
//     operand of the second product (a second named barrier);
//   O[:, w·D/2 ..] += P·V[:, w·D/2 ..]: warpgroup w owns half the output
//     columns, m64n256k16 (D = 512) or m64n192k16 (384) wgmmas, A = P and
//     B = V from shared memory, V through the transpose bit (MN-major).
//
// Per key tile a consumer warpgroup runs S, the softmax, then P·V, each
// d chunk or 16-key step one wgmma group: after issuing a group it waits
// for the one before (wgmma_wait<1>) and releases that group's ring slot,
// and it goes from tile j's P·V straight into tile j + 1's scores without
// draining, since those only read Q and K. The O rescale by the softmax
// correction is skipped where every lane's correction is exactly 1 (the
// running max did not move: the same bits). Letting the softmax of tile j
// overlap tile j + 1's scores (two score tiles in registers, waits that
// depend on how many groups are in flight) made ptxas serialize the
// wgmmas (C7514) and spill at D = 512, and ran slower (PERF.md, Findings).
//
// Shared memory: Q resident (64 rows x D: 48 / 64 KB), P (16 KB), the
// exchange, and one ring of 16 KB slots in what is left (10 at D = 384, 9
// at 512: 231,592 / 231,576 bytes, flash_attn_smem_bytes) that holds K and
// V chunks in the order the consumers take them: a tile's NC K chunks (128
// keys x 64 d), then its 8 V chunks (16 keys x D: one k16 step of both
// warpgroups' products). One producer lane issues Q and then the ring by
// TMA, a chunk one box (V through a 5-D view that puts its D/64 column
// blocks one after another): that lane's issue rate is on the critical
// path, and a box a column block was slower. One arrival a consumer warp
// releases a slot. A ring for K and one for V (4 slots each), and a
// cluster of two blocks sharing each K and V load by TMA multicast, both
// ran slower (PERF.md, Findings).
//
// Semantics kept from the D <= 256 body: f32 logits and softmax in base 2
// with the scale folded in, probabilities rounded to the value dtype, f32
// accumulation of P·V, keys past Lk zero-filled by TMA and masked to -inf,
// query rows past Lq not stored, q/k/v read in place as strided views (4-D
// and 5-D tensor maps). Every sum is in a fixed order, so two launches give the
// same bits. At D = 384 and 512 this does 4·Lq·Lk·D operations, where the
// column-sliced instances it replaces recomputed the scores in each 128-
// column slice (2x and 2.5x).
#pragma once

#include "flash_attn.cuh"

namespace gguf_flash {

constexpr int WQ = 64;         // query rows a block
constexpr int WKV = 128;       // keys a tile: 64 a consumer warpgroup
constexpr int WTHREADS = 384;  // 2 consumer warpgroups + the producer's

template <int D>
struct WShape {
  static_assert(D % 128 == 0 && D > 256 && D <= 512, "a wide head dim");
  static constexpr int NC = D / CHUNK;       // 64-wide d chunks
  static constexpr int DH = D / 2;           // output columns a warpgroup
  static constexpr int NB = DH / CHUNK;      // 64-column V boxes a warpgroup
  static constexpr int Q_CH = WQ * 128;      // one d chunk of Q
  static constexpr int K_CH = WKV * 128;     // one d chunk of a K tile
  static constexpr int V_KEYS = 16;          // keys a V chunk
  static constexpr int V_BOX = V_KEYS * 128;  // 16 keys x 64 columns
  static constexpr int V_CH = NC * V_BOX;    // 16 keys x D
  static constexpr int V_STEPS = WKV / V_KEYS;  // V chunks a key tile
  static constexpr int SLOT = K_CH;          // a ring slot: a K or V chunk
  static constexpr int P_CH = WQ * 128;      // 64 queries x 64 keys of P
  // the ring takes what Q, P and the exchange leave of a block's 227 KB
  static constexpr int RS =
      (232448 - 1024 - NC * Q_CH - 2 * P_CH - 2048) / SLOT;
  static constexpr int OFF_R = NC * Q_CH;
  static constexpr int OFF_P = OFF_R + RS * SLOT;
  static constexpr int OFF_X = OFF_P + 2 * P_CH;  // rmax[2][64], lsum[2][64]
  static constexpr int OFF_BAR = OFF_X + 4 * WQ * 4;
  static constexpr int N_BAR = 1 + 2 * RS;
  static constexpr int SMEM = 1024 + OFF_BAR + 8 * N_BAR;
  static_assert(V_CH <= SLOT, "a V chunk fits a slot");
  static_assert(SMEM <= 232448, "past the shared memory of a block");
};

// O += P·V over one 16-key step: 64 rows x DH output columns, both
// operands in shared memory
template <bool F16, int DH>
__device__ __forceinline__ void wgmma_pv_wide(float (&o)[DH / 2],
                                              uint64_t desc_p,
                                              uint64_t desc_v) {
  if constexpr (DH == 256) {
    wgmma_m64n256k16_ss_tb<F16>(o, desc_p, desc_v);
  } else {
    wgmma_m64n192k16_ss_tb<F16>(o, desc_p, desc_v);
  }
}

template <int D, bool F16>
__global__ void __launch_bounds__(WTHREADS, 1)
flash_wide_kernel(const __grid_constant__ CUtensorMap tm_q,  // (D, Lq, H, B)
                  const __grid_constant__ CUtensorMap tm_k,  // (D, Lk, H, B)
                  const __grid_constant__ CUtensorMap tm_v,  // (D, Lk, H, B)
                  typename Elem<F16>::T* __restrict__ out, int Lq, int Lk,
                  long long ob, long long oh, long long ol,
                  float scale_log2) {
  using S = WShape<D>;
  using T = typename Elem<F16>::T;
  constexpr int NC = S::NC;
  constexpr int DH = S::DH;
  constexpr int RS = S::RS;
  constexpr int V_STEPS = S::V_STEPS;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t{1023});
  uint8_t* q_s = smem;
  uint8_t* r_s = smem + S::OFF_R;
  float* rmax = reinterpret_cast<float*>(smem + S::OFF_X);  // [2][WQ]
  float* lsum = rmax + 2 * WQ;                               // [2][WQ]
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + S::OFF_BAR);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + RS;

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int q0 = blockIdx.x * WQ;
  const int n_kv = (Lk + WKV - 1) / WKV;

  if (tid == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < RS; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);  // every consumer warp
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (warp >= 8) {
    // ---- producer warpgroup: lane 0 of warp 8 issues Q, then every K and
    // V chunk in the order the consumers take them, K(j) then V(j) for each
    // tile j (register pool: 40 * 128 + 232 * 256 = 168 * 384, as in
    // flash_attn.cuh)
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (warp == 8 && lane == 0) {
      mbar_arrive_expect_tx(q_full, NC * S::Q_CH);
      for (int c = 0; c < NC; ++c)
        tma_load_4d(q_s + c * S::Q_CH, &tm_q, q_full, c * CHUNK, q0, h, b);
      int pos = 0;
      // the next ring slot, once free, expecting `bytes`
      auto slot = [&](int bytes) {
        const int st = pos % RS;
        mbar_wait(&empty[st], ((pos / RS) & 1) ^ 1);
        mbar_arrive_expect_tx(&full[st], bytes);
        ++pos;
        return st;
      };
      auto load_k = [&](int j) {
        for (int c = 0; c < NC; ++c) {
          const int st = slot(S::K_CH);
          tma_load_4d(r_s + st * S::SLOT, &tm_k, &full[st], c * CHUNK,
                      j * WKV, h, b);
        }
      };
      for (int j = 0; j < n_kv; ++j) {
        load_k(j);
        for (int kk = 0; kk < V_STEPS; ++kk) {
          const int st = slot(S::V_CH);
          // one box: the chunk's NC column blocks of 16 keys x 64
          tma_load_5d(r_s + st * S::SLOT, &tm_v, &full[st], 0,
                      j * WKV + kk * S::V_KEYS, 0, h, b);
        }
      }
    }
  } else {
    // ---- consumers: warpgroup wg owns keys 64wg.. of each tile and output
    // columns wg·DH ..; warp wp of it query rows 16wp + g and 16wp + g + 8
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int wg = warp >> 2;
    const int wp = warp & 3;
    const int g = lane >> 2;
    const int t = lane & 3;
    const int row = 16 * wp + g;
    const uint32_t qa = smem_u32(q_s);
    const uint32_t rb = smem_u32(r_s);
    const uint32_t kb = wg * 64 * 128;          // this warpgroup's keys
    const uint32_t vb = wg * S::NB * S::V_BOX;  // ... and V columns
    const uint32_t pb = smem_u32(smem + S::OFF_P);
    const uint32_t pw = pb + wg * S::P_CH;      // the P keys it writes
    const float neg_inf = -__int_as_float(0x7f800000);

    // o[4i + 2r + c] = row + 8r, column wg·DH + 8i + 2t + c
    float o[DH / 2];
#pragma unroll
    for (int i = 0; i < DH / 2; ++i) o[i] = 0.0f;
    float m_run[2] = {neg_inf, neg_inf};
    float l_run[2] = {0.0f, 0.0f};  // over this warpgroup's keys
    // s[4i + 2r + c] = row + 8r, key 8i + 2t + c of this warpgroup's 64
    float s[32];

    // the ring as this warpgroup walks it: every wgmma group reads one
    // slot, released once the group after it has been issued and the
    // group itself has finished
    int pos = 0;  // ring position of the next chunk
    auto full_wait = [&]() { mbar_wait(&full[pos % RS], (pos / RS) & 1); };
    auto release_prev = [&]() {
      if (lane == 0) mbar_arrive(&empty[(pos - 1) % RS]);
    };
    // tile j's scores, d chunk by d chunk; the first group's wait also
    // finishes the previous tile's last P·V group
    auto scores = [&](bool after_pv) {
#pragma unroll 1
      for (int c = 0; c < NC; ++c) {
        full_wait();
        const uint32_t ks = rb + (pos % RS) * S::SLOT + kb;
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_m64n64k16_ss<F16>(
              s, wgmma_desc_k128(qa + c * S::Q_CH) + 2 * kk,
              wgmma_desc_k128(ks) + 2 * kk, (c > 0 || kk > 0) ? 1 : 0);
        wgmma_commit();
        if (c > 0 || after_pv) {
          wgmma_wait<1>();
          release_prev();
        }
        ++pos;
      }
      wgmma_wait<0>();
      release_prev();
#pragma unroll
      for (int e = 0; e < 32; ++e) reg_fence(s[e]);
#pragma unroll
      for (int e = 0; e < DH / 2; ++e) reg_fence(o[e]);
    };

    mbar_wait(q_full, 0);
    scores(false);
    for (int j = 0; j < n_kv; ++j) {
      // ---- online softmax (base 2, scale folded in); rows row, row + 8 --
      const int kv0 = j * WKV + wg * 64;
#pragma unroll
      for (int e = 0; e < 32; ++e) s[e] *= scale_log2;
      if (kv0 + 64 > Lk) {
#pragma unroll
        for (int e = 0; e < 32; ++e)
          if (kv0 + 8 * (e >> 2) + 2 * t + (e & 1) >= Lk) s[e] = neg_inf;
      }
      float mx[2] = {neg_inf, neg_inf};
#pragma unroll
      for (int e = 0; e < 32; ++e)
        mx[(e >> 1) & 1] = fmaxf(mx[(e >> 1) & 1], s[e]);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      }
      if (t == 0) {
        rmax[wg * WQ + row] = mx[0];
        rmax[wg * WQ + row + 8] = mx[1];
      }
      named_bar_sync(1, 256);
      // the row max over both warpgroups' keys: the same operands in the
      // same order in both, so the same bits
      float corr[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float m_new = fmaxf(
            m_run[r], fmaxf(rmax[row + 8 * r], rmax[WQ + row + 8 * r]));
        corr[r] = exp2f(m_run[r] - m_new);
        m_run[r] = m_new;
        l_run[r] *= corr[r];
      }
      // P into its K-major tile: row q's keys 8i + 2t, + 1 are 16-byte unit
      // i of the row, stored at unit i ^ (q & 7) (the 128-byte swizzle)
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const float p0 = exp2f(s[4 * i + 2 * r] - m_run[r]);
          const float p1 = exp2f(s[4 * i + 2 * r + 1] - m_run[r]);
          l_run[r] += p0 + p1;
          const int q = row + 8 * r;
          const uint32_t off = q * 128 + ((i ^ (q & 7)) << 4) + 4 * t;
          asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(pw + off),
                       "r"(Elem<F16>::pack(p0, p1)) : "memory");
        }
      fence_proxy_async();
      named_bar_sync(2, 256);
      // a multiply by 1 leaves the bits, so a warp whose rows kept their
      // max skips it
      if (__any_sync(0xffffffffu, corr[0] != 1.0f || corr[1] != 1.0f)) {
#pragma unroll
        for (int e = 0; e < DH / 2; ++e) o[e] *= corr[(e >> 1) & 1];
      }

      // ---- O += P V: 16 keys a group over both warpgroups' P ------------
#pragma unroll
      for (int kk = 0; kk < V_STEPS; ++kk) {
        full_wait();
        const uint32_t vs = rb + (pos % RS) * S::SLOT + vb;
        wgmma_fence();
        wgmma_pv_wide<F16, DH>(
            o, wgmma_desc_k128(pb + (kk >> 2) * S::P_CH) + 2 * (kk & 3),
            wgmma_desc_mn128(vs, S::V_BOX));
        wgmma_commit();
        if (kk > 0) {
          wgmma_wait<1>();
          release_prev();
        }
        ++pos;
      }
      if (j + 1 < n_kv) {
        scores(true);  // the next tile's, straight after this P·V
      } else {
        wgmma_wait<0>();
        release_prev();
#pragma unroll
        for (int e = 0; e < DH / 2; ++e) reg_fence(o[e]);
      }
    }

    // ---- the row sums over both warpgroups' keys, then the store ---------
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 1);
      l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 2);
    }
    if (t == 0) {
      lsum[wg * WQ + row] = l_run[0];
      lsum[wg * WQ + row + 8] = l_run[1];
    }
    named_bar_sync(3, 256);
    const float inv0 = 1.0f / (lsum[row] + lsum[WQ + row]);
    const float inv1 = 1.0f / (lsum[row + 8] + lsum[WQ + row + 8]);
    const int row0 = q0 + row;
    T* op = out + b * ob + h * oh;
#pragma unroll
    for (int i = 0; i < DH / 8; ++i) {
      const int c = wg * DH + i * 8 + 2 * t;
      if (row0 < Lq) {
        *reinterpret_cast<uint32_t*>(op + row0 * ol + c) =
            Elem<F16>::pack(o[4 * i] * inv0, o[4 * i + 1] * inv0);
      }
      if (row0 + 8 < Lq) {
        *reinterpret_cast<uint32_t*>(op + (row0 + 8) * ol + c) =
            Elem<F16>::pack(o[4 * i + 2] * inv1, o[4 * i + 3] * inv1);
      }
    }
  }
}

// 5-D tensor map of a (B, H, L, D) view read as (64, L, D/64, H, B): one
// box of `rows` keys and all D/64 column blocks lands as D/64 blocks of
// rows x 128 bytes one after another (the 128-byte swizzle within each),
// the MN-major layout P·V reads, in one TMA issue where a box a block took
// D/64. A dimension of extent 1 is never stepped, so it takes the stride D.
template <int D, bool F16>
bool make_v_blocks_map(CUtensorMap* map, const void* base, int B, int H,
                       int L, const long long* st, int rows) {
  const long long sb = B > 1 ? st[0] : D;
  const long long sh = H > 1 ? st[1] : D;
  const long long sl = L > 1 ? st[2] : D;
  const cuuint64_t dims[5] = {
      static_cast<cuuint64_t>(CHUNK), static_cast<cuuint64_t>(L),
      static_cast<cuuint64_t>(D / CHUNK), static_cast<cuuint64_t>(H),
      static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[4] = {static_cast<cuuint64_t>(sl) * 2,
                                 static_cast<cuuint64_t>(CHUNK) * 2,
                                 static_cast<cuuint64_t>(sh) * 2,
                                 static_cast<cuuint64_t>(sb) * 2};
  const cuuint32_t box[5] = {CHUNK, static_cast<cuuint32_t>(rows),
                             D / CHUNK, 1, 1};
  return make_map_nd(map, Elem<F16>::TMA, base, 5, dims, strides, box,
                     CU_TENSOR_MAP_SWIZZLE_128B);
}

template <int D, bool F16>
cudaError_t launch_wide(const void* q, const void* k, const void* v,
                        void* out, int B, int H, int Lq, int Lk,
                        const long long* st, float scale,
                        cudaStream_t stream) {
  using S = WShape<D>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_wide_kernel<D, F16>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      S::SMEM);
  if (attr != cudaSuccess) return attr;
  CUtensorMap tm_q, tm_k, tm_v;
  bool ok = make_bhld_map<D, F16>(&tm_q, q, B, H, Lq, st, WQ);
  ok = ok && make_bhld_map<D, F16>(&tm_k, k, B, H, Lk, st + 3, WKV);
  ok = ok && make_v_blocks_map<D, F16>(&tm_v, v, B, H, Lk, st + 6,
                                       S::V_KEYS);
  if (!ok) return cudaErrorInvalidValue;
  dim3 grid((Lq + WQ - 1) / WQ, H, B);
  flash_wide_kernel<D, F16><<<grid, WTHREADS, S::SMEM, stream>>>(
      tm_q, tm_k, tm_v, static_cast<typename Elem<F16>::T*>(out), Lq, Lk,
      st[9], st[10], st[11], scale * 1.4426950408889634f);
  return cudaGetLastError();
}

// One launch at head dim D (the wrapper checks D, Lk >= 1 and TMA's rule
// for the base and the strides); cudaErrorInvalidValue for another D.
template <bool F16>
int flash_dispatch(const void* q, const void* k, const void* v, void* out,
                   int B, int H, int Lq, int Lk, int D,
                   const long long* st, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 40:
      return launch<40, F16>(q, k, v, out, B, H, Lq, Lk, st, scale, s);
    case 64:
      return launch<64, F16>(q, k, v, out, B, H, Lq, Lk, st, scale, s);
    case 80:
      return launch<80, F16>(q, k, v, out, B, H, Lq, Lk, st, scale, s);
    case 96:
      return launch<96, F16>(q, k, v, out, B, H, Lq, Lk, st, scale, s);
    case 128:
      return launch<128, F16>(q, k, v, out, B, H, Lq, Lk, st, scale, s);
    case 160:
      return launch<160, F16>(q, k, v, out, B, H, Lq, Lk, st, scale, s);
    case 256:
      return launch<256, F16>(q, k, v, out, B, H, Lq, Lk, st, scale, s);
    case 384:
      return launch_wide<384, F16>(q, k, v, out, B, H, Lq, Lk, st, scale,
                                   s);
    case 512:
      return launch_wide<512, F16>(q, k, v, out, B, H, Lq, Lk, st, scale,
                                   s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace gguf_flash
