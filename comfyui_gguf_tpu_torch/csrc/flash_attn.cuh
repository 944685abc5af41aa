// K7: flash attention forward, non-causal, bf16 or f16 in and out: the
// body of flash_attn.cu's bf16 instances and flash_attn_f16.cu's f16 ones
// at head dims up to 256 (D = 384 and 512 take the wide-head body of
// flash_attn_wide.cuh, which also holds the dispatch over D; the f32
// instances are flash_attn_f32.cu's own 3xTF32 body).
//
// The f16 instances are this body with wgmma's f32.f16.f16 forms, FLOAT16
// tensor maps under the same 128-byte swizzle, and P's A fragments and the
// store packed as f16 (round to nearest even): the arithmetic of
// plain_attention in f16 (f32 logits and softmax, probabilities rounded to
// the value dtype, f32 accumulation of P·V), so not an approximation of
// it. An f16 value is 2 bytes like a bf16 one, so every shared-memory plan
// below holds for both.
//
// Replaces the library Pallas kernels the reference package calls from
// comfyui_gguf_tpu/nn/attention.py (_splash_attention and the flash branch
// of dot_product_attention):
//
//   out[b, h, i, :] = softmax_j(scale * q[b, h, i, :] . k[b, h, j, :]) v[b, h, j, :]
//
// What bounds it: bf16 tensor-core operations (4·L²·D per head at flux's
// L = 4608, D = 128), and beside them the exponentials of the softmax (one
// per score, on the special-function units at a quarter of the rate the
// tensor cores need at D = 128). Design (FlashAttention on Hopper's
// asynchronous units): a block owns 128 query rows of one (b, h); a
// producer warp loads them once by TMA and then streams the keys and values
// in tiles of 128 through a 2-stage ring of shared tiles (TMA, 128-byte
// swizzle, K and V completing on their own mbarriers), so the scores can
// start before V lands. Two consumer warpgroups own 64 query rows each:
// S = Q·Kᵀ is a wgmma with both operands in shared memory (K is K-major
// because D is contiguous), the online softmax (base 2, scale folded in)
// runs on the S accumulator in registers and keeps the running max, sum
// and the f32 output accumulator per row, and O += P·V takes P as the
// register-fed A operand (the S accumulator layout converts to bf16 A
// fragments in place) and V from shared memory with the transpose bit (V is
// MN-major). No L×L tensor touches global memory, and every q/k/v byte is
// read from global memory once per block. Neither a deeper ring (3 stages,
// K and V released apart) nor the two warpgroups taking turns at the tensor
// cores made it faster on the H100; what holds it is in PERF.md. Keys past Lk are zero-filled by
// TMA and masked to -inf; query rows past Lq are not stored. q/k/v may be
// strided views: their tensor maps are 4-D (D, L, H, B).
//
// Head dims that are no multiple of 64 (SD1's 40, 80 and 160, Lumina 2's
// 96) run the instance of the next multiple, DP: the tensor maps carry the
// true D and a box of whole 64-value chunks, so TMA zero-fills the columns
// past D. The pad columns add nothing to the scores, the pad columns of P·V
// come out zero and are not stored, and nothing is copied. At D = 96 that
// is a quarter of the 128-wide instance's products spent on zeros. At DP =
// 192 one K or V tile of 128 keys is 48 KB and a block would need 1 + 48 +
// 4 x 48 = 241 KB, past the 227 KB a block may have; that instance takes
// 64-key tiles (1 + 48 + 4 x 24 = 145 KB) and keeps the 2-stage ring, so
// loads still overlap the products. Its P·V is one m64n192k16 wgmma a
// 16-key step.
//
// D = 256 (AuraFlow's heads) takes 64-key tiles too: 1 + 64 (Q) + 4 x 32
// = 193 KB, where 128-key tiles would need 321 KB. A consumer thread then
// holds the 64 x 256 f32 O accumulator (128 registers), the 64 x 64 S
// accumulator (32) and the bf16 P fragments (16) beside the softmax state;
// the producer warpgroup gives its registers up (setmaxnreg 40, the
// consumers 232), which is what lets the three fit in one thread without
// spilling. P·V is one m64n256k16 wgmma a 16-key step, A (P) from
// registers and V from shared memory with the transpose bit, rather than
// two n128 halves: one instruction reads each P fragment once and issues
// half the wgmmas. The O rescale by the softmax correction is an in-place
// multiply of the accumulator registers and needs no temporary.

#pragma once

#include "common.cuh"
#include "tma.cuh"

namespace gguf_flash {

using namespace gguf_cuda;

// What the body needs of its element type: the wgmma operand form, the
// tensor maps' data type and the packing of two f32 values (round to
// nearest even), for P's A fragments and for the store.
template <bool F16>
struct Elem;

template <>
struct Elem<false> {
  using T = __nv_bfloat16;
  static constexpr CUtensorMapDataType TMA = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  static __device__ __forceinline__ uint32_t pack(float lo, float hi) {
    return pack_bf16x2(lo, hi);
  }
};

template <>
struct Elem<true> {
  using T = __half;
  static constexpr CUtensorMapDataType TMA = CU_TENSOR_MAP_DATA_TYPE_FLOAT16;
  static __device__ __forceinline__ uint32_t pack(float lo, float hi) {
    return pack_f16x2(lo, hi);
  }
};

constexpr int BQ = 128;      // query rows a block (2 consumer warpgroups)
constexpr int CHUNK = 64;    // d values a 128-byte swizzle row holds
constexpr int THREADS = 384; // 2 consumer warpgroups + the producer's

template <int D>
struct FShape {
  static constexpr int NC = (D + CHUNK - 1) / CHUNK;  // d chunks a row
  static constexpr int DP = NC * CHUNK;      // D padded to whole chunks
  static_assert(DP <= 256, "D past 256 takes flash_attn_wide.cuh");
  // keys a tile: 128, 64 past D = 128
  static constexpr int BKV = DP > 128 ? 64 : 128;
  static constexpr int CHUNK_Q = BQ * 128;   // bytes of one d chunk of Q
  static constexpr int CHUNK_KV = BKV * 128; // ... of K or V
  static constexpr int Q_BYTES = NC * CHUNK_Q;
  static constexpr int KV_BYTES = NC * CHUNK_KV;  // one K or V tile
  static constexpr int SMEM = 1024 + Q_BYTES + 4 * KV_BYTES + 128;
  static_assert(SMEM <= 232448, "past the shared memory of a block");
};

// S (+)= Q·Kᵀ over one 16-wide d step: 64 rows x BKV keys
template <bool F16, int BKV>
__device__ __forceinline__ void wgmma_qk(float (&s)[BKV / 2],
                                         uint64_t desc_q, uint64_t desc_k,
                                         int scale_d) {
  if constexpr (BKV == 128) {
    wgmma_m64n128k16_ss<F16>(s, desc_q, desc_k, scale_d);
  } else {
    wgmma_m64n64k16_ss<F16>(s, desc_q, desc_k, scale_d);
  }
}

// O += P·V over one 16-key step: 64 rows x DP output columns
template <bool F16, int DP>
__device__ __forceinline__ void wgmma_pv(float (&o)[DP / 2],
                                         const uint32_t (&a)[4],
                                         uint64_t desc_v) {
  if constexpr (DP == 256) {
    wgmma_m64n256k16_rs_tb<F16>(o, a, desc_v);
  } else if constexpr (DP == 192) {
    wgmma_m64n192k16_rs_tb<F16>(o, a, desc_v);
  } else if constexpr (DP == 128) {
    wgmma_m64n128k16_rs_tb<F16>(o, a, desc_v);
  } else {
    wgmma_m64n64k16_rs_tb<F16>(o, a, desc_v);
  }
}

template <int D, bool F16>
__global__ void __launch_bounds__(THREADS, 1)
flash_fwd_kernel(const __grid_constant__ CUtensorMap tm_q,  // (D, Lq, H, B)
                 const __grid_constant__ CUtensorMap tm_k,  // (D, Lk, H, B)
                 const __grid_constant__ CUtensorMap tm_v,  // (D, Lk, H, B)
                 typename Elem<F16>::T* __restrict__ out, int Lq,
                 int Lk,
                 long long ob, long long oh, long long ol,
                 float scale_log2) {
  using S = FShape<D>;
  using T = typename Elem<F16>::T;
  constexpr int BKV = S::BKV;
  constexpr int DP = S::DP;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t{1023});
  uint8_t* q_s = smem;                        // NC x (BQ, 128 B)
  uint8_t* k_s = q_s + S::Q_BYTES;            // 2 stages x NC x (BKV, 128 B)
  uint8_t* v_s = k_s + 2 * S::KV_BYTES;       // the same for V
  uint64_t* q_full = reinterpret_cast<uint64_t*>(v_s + 2 * S::KV_BYTES);
  uint64_t* k_full = q_full + 1;
  uint64_t* v_full = k_full + 2;
  uint64_t* empty = v_full + 2;

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int q0 = blockIdx.x * BQ;
  const int n_kv = (Lk + BKV - 1) / BKV;

  if (tid == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < 2; ++s) {
      mbar_init(&k_full[s], 1);
      mbar_init(&v_full[s], 1);
      mbar_init(&empty[s], 256);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (warp >= 8) {
    // ---- producer warpgroup: one lane issues every load ------------------
    // (register pool: 40 * 128 + 232 * 256 = 168 * 384, as in qmm_wgmma.cuh)
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (warp == 8 && lane == 0) {
      mbar_arrive_expect_tx(q_full, S::Q_BYTES);
      for (int c = 0; c < S::NC; ++c)
        tma_load_4d(q_s + c * S::CHUNK_Q, &tm_q, q_full, c * CHUNK, q0, h,
                    b);
      for (int j = 0; j < n_kv; ++j) {
        const int st = j & 1;
        mbar_wait(&empty[st], ((j >> 1) & 1) ^ 1);
        uint8_t* kd = k_s + st * S::KV_BYTES;
        uint8_t* vd = v_s + st * S::KV_BYTES;
        mbar_arrive_expect_tx(&k_full[st], S::KV_BYTES);
        for (int c = 0; c < S::NC; ++c)
          tma_load_4d(kd + c * S::CHUNK_KV, &tm_k, &k_full[st], c * CHUNK,
                      j * BKV, h, b);
        mbar_arrive_expect_tx(&v_full[st], S::KV_BYTES);
        for (int c = 0; c < S::NC; ++c)
          tma_load_4d(vd + c * S::CHUNK_KV, &tm_v, &v_full[st], c * CHUNK,
                      j * BKV, h, b);
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
    const float neg_inf = -__int_as_float(0x7f800000);

    // o[4i + 2r + c] = row g + 8r, column 8i + 2t + c of this warp's rows
    float o[DP / 2];
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) o[i] = 0.0f;
    float m_run[2] = {neg_inf, neg_inf};
    float l_run[2] = {0.0f, 0.0f};

    mbar_wait(q_full, 0);
    for (int j = 0; j < n_kv; ++j) {
      const int st = j & 1;
      const uint32_t ph = (j >> 1) & 1;
      const uint32_t kt = kb + st * S::KV_BYTES;
      const uint32_t vt = vb + st * S::KV_BYTES;

      // S = Q Kᵀ: 64 rows x BKV keys, k over DP in steps of 16
      float s[BKV / 2];
      mbar_wait(&k_full[st], ph);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk)
        wgmma_qk<F16, BKV>(
            s, wgmma_desc_k128(qa + (kk >> 2) * S::CHUNK_Q) + 2 * (kk & 3),
            wgmma_desc_k128(kt + (kk >> 2) * S::CHUNK_KV) + 2 * (kk & 3),
            kk > 0);
      wgmma_commit();
      wgmma_wait<0>();
#pragma unroll
      for (int i = 0; i < BKV / 2; ++i) reg_fence(s[i]);

      // online softmax (base 2, scale folded in); rows g and g+8
      const int kv0 = j * BKV;
#pragma unroll
      for (int i = 0; i < BKV / 2; ++i) s[i] *= scale_log2;
      if (kv0 + BKV > Lk) {
#pragma unroll
        for (int i = 0; i < BKV / 2; ++i)
          if (kv0 + 8 * (i >> 2) + 2 * t + (i & 1) >= Lk) s[i] = neg_inf;
      }
      float mx[2] = {m_run[0], m_run[1]};
#pragma unroll
      for (int i = 0; i < BKV / 2; ++i)
        mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
      float corr[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        corr[r] = exp2f(m_run[r] - mx[r]);
        m_run[r] = mx[r];
        l_run[r] *= corr[r];
      }
      // P as A fragments of the element type: keys 16kk .. 16kk+15 are S columns blocks
      // 2kk and 2kk+1, i.e. s[8kk .. 8kk+7]
      uint32_t pf[BKV / 16][4];
#pragma unroll
      for (int kk = 0; kk < BKV / 16; ++kk) {
        float p[8];
#pragma unroll
        for (int e = 0; e < 8; ++e)
          p[e] = exp2f(s[8 * kk + e] - mx[(e >> 1) & 1]);
        l_run[0] += (p[0] + p[1]) + (p[4] + p[5]);
        l_run[1] += (p[2] + p[3]) + (p[6] + p[7]);
        pf[kk][0] = Elem<F16>::pack(p[0], p[1]);
        pf[kk][1] = Elem<F16>::pack(p[2], p[3]);
        pf[kk][2] = Elem<F16>::pack(p[4], p[5]);
        pf[kk][3] = Elem<F16>::pack(p[6], p[7]);
      }
#pragma unroll
      for (int i = 0; i < DP / 2; ++i) o[i] *= corr[(i >> 1) & 1];

      // O += P V: 16 keys a step; V's d chunks lie CHUNK_KV apart
      mbar_wait(&v_full[st], ph);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BKV / 16; ++kk)
        wgmma_pv<F16, DP>(o, pf[kk],
                     wgmma_desc_mn128(vt + kk * 16 * 128, S::CHUNK_KV));
      wgmma_commit();
      wgmma_wait<0>();
#pragma unroll
      for (int i = 0; i < DP / 2; ++i) reg_fence(o[i]);
#pragma unroll
      for (int kk = 0; kk < BKV / 16; ++kk)
#pragma unroll
        for (int e = 0; e < 4; ++e) reg_fence(pf[kk][e]);
      mbar_arrive(&empty[st]);
    }

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 1);
      l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 2);
    }
    const float inv0 = 1.0f / l_run[0];
    const float inv1 = 1.0f / l_run[1];
    const int row0 = q0 + wg * 64 + w * 16 + g;
    T* op = out + b * ob + h * oh;
#pragma unroll
    for (int i = 0; i < D / 8; ++i) {
      const int c = i * 8 + 2 * t;
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

// 4-D tensor map of a (B, H, L, D) view (bf16, or f16 with F16) with
// element strides (sb, sh, sl) and unit stride along D; box: one
// 64-value d chunk of `rows` rows
// (past D, TMA fills the chunk with zeros). A dimension of extent 1 is
// never stepped, so it takes the stride D.
template <int D, bool F16>
bool make_bhld_map(CUtensorMap* map, const void* base, int B, int H, int L,
                   const long long* st, int rows) {
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
  const cuuint32_t box[4] = {CHUNK, static_cast<cuuint32_t>(rows), 1, 1};
  return make_map_nd(map, Elem<F16>::TMA, base, 4, dims,
                     strides, box, CU_TENSOR_MAP_SWIZZLE_128B);
}

template <int D, bool F16>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   int B, int H, int Lq, int Lk, const long long* st,
                   float scale, cudaStream_t stream) {
  using S = FShape<D>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_fwd_kernel<D, F16>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      S::SMEM);
  if (attr != cudaSuccess) return attr;
  CUtensorMap tm_q, tm_k, tm_v;
  bool ok = make_bhld_map<D, F16>(&tm_q, q, B, H, Lq, st, BQ);
  ok = ok && make_bhld_map<D, F16>(&tm_k, k, B, H, Lk, st + 3, S::BKV);
  ok = ok && make_bhld_map<D, F16>(&tm_v, v, B, H, Lk, st + 6, S::BKV);
  if (!ok) return cudaErrorInvalidValue;
  dim3 grid((Lq + BQ - 1) / BQ, H, B);
  flash_fwd_kernel<D, F16><<<grid, THREADS, S::SMEM, stream>>>(
      tm_q, tm_k, tm_v, static_cast<typename Elem<F16>::T*>(out), Lq, Lk,
      st[9], st[10], st[11], scale * 1.4426950408889634f);
  return cudaGetLastError();
}

}  // namespace gguf_flash
