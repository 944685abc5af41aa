// K7: flash attention forward, non-causal, bf16 in and out.
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
//
// D = 384 (the Wan 2.1 VAE's single-head mid-block attention, one head of
// the block's 384 channels over a frame's positions) does not fit one
// block: Q, two K tiles and two V tiles of 64 keys would need 1 + 96 + 4 x
// 48 = 289 KB. Its blocks split the output columns instead: grid z holds
// B x 3 blocks for each query tile, and block s owns output columns 128s ..
// 128s + 127. Each computes the scores over all of D (Q and the K tiles
// whole, 6 chunks of 64) and streams only its 128 columns of V, so a block
// needs 1 + 96 (Q) + 2 x 48 (K) + 2 x 16 (V) = 225 KB and keeps the
// 2-stage ring. The price is the score work done three times: 3 x 2·L²·D
// for Q·Kᵀ beside 2·L²·D for P·V, twice the operations of one pass, which
// a first instance that is right accepts (PERF.md has its time).
//
// D = 512 (the HunyuanVideo VAE's single-head mid-block attention: one head
// of the block's 512 channels over a frame's positions) splits the output
// columns as D = 384 does, 4 blocks of 128 per query tile. With 64-key
// tiles it would need 1 + 128 (Q) + 2 x 64 (K) + 2 x 16 (V) = 289 KB; of
// the layouts that fit, this instance takes 32-key tiles: 1 + 128 + 2 x 32
// + 2 x 8 = 209 KB, the 2-stage ring and the two consumer warpgroups kept,
// so nothing else of the body changes (S is one m64n32k16 wgmma a 16-wide
// d step, P two 16-key fragments). A 64-row, one-warpgroup block would fit
// at 225 KB with little room left, and K streamed in d chunks through a
// ring would need a second pipeline in the consumers. The price is again
// the scores: 4 x 2·L²·D for Q·Kᵀ beside 2·L²·D for P·V, 2.5 times the
// operations of one pass, and twice the tile steps of 64-key tiles.
#include "common.cuh"
#include "tma.cuh"

using namespace gguf_cuda;

namespace {

constexpr int BQ = 128;      // query rows a block (2 consumer warpgroups)
constexpr int CHUNK = 64;    // d values a 128-byte swizzle row holds
constexpr int THREADS = 384; // 2 consumer warpgroups + the producer's

template <int D>
struct FShape {
  static constexpr int NC = (D + CHUNK - 1) / CHUNK;  // d chunks a row
  static constexpr int DP = NC * CHUNK;      // D padded to whole chunks
  // keys a tile: 128, 64 past D = 128, 32 past D = 384
  static constexpr int BKV = DP > 384 ? 32 : DP > 128 ? 64 : 128;
  // output columns a block owns: all of them up to 256, else 128 (grid z
  // holds NSLICE blocks per (b, query tile), each a slice of V and out)
  static constexpr int DV = DP > 256 ? 128 : DP;
  static constexpr int NSLICE = DP / DV;
  static constexpr int CHUNK_Q = BQ * 128;   // bytes of one d chunk of Q
  static constexpr int CHUNK_KV = BKV * 128; // ... of K or V
  static constexpr int Q_BYTES = NC * CHUNK_Q;
  static constexpr int KV_BYTES = NC * CHUNK_KV;  // one K tile
  static constexpr int V_BYTES = DV / CHUNK * CHUNK_KV;  // one V tile
  static constexpr int SMEM =
      1024 + Q_BYTES + 2 * KV_BYTES + 2 * V_BYTES + 128;
  static_assert(SMEM <= 232448, "past the shared memory of a block");
  static_assert(NSLICE * DV == DP, "output slices cover D");
};

// S (+)= Q·Kᵀ over one 16-wide d step: 64 rows x BKV keys
template <int BKV>
__device__ __forceinline__ void wgmma_qk(float (&s)[BKV / 2],
                                         uint64_t desc_q, uint64_t desc_k,
                                         int scale_d) {
  if constexpr (BKV == 128) {
    wgmma_m64n128k16_ss(s, desc_q, desc_k, scale_d);
  } else if constexpr (BKV == 64) {
    wgmma_m64n64k16_ss(s, desc_q, desc_k, scale_d);
  } else {
    wgmma_m64n32k16_ss(s, desc_q, desc_k, scale_d);
  }
}

// O += P·V over one 16-key step: 64 rows x DP output columns
template <int DP>
__device__ __forceinline__ void wgmma_pv(float (&o)[DP / 2],
                                         const uint32_t (&a)[4],
                                         uint64_t desc_v) {
  if constexpr (DP == 256) {
    wgmma_m64n256k16_rs_tb(o, a, desc_v);
  } else if constexpr (DP == 192) {
    wgmma_m64n192k16_rs_tb(o, a, desc_v);
  } else if constexpr (DP == 128) {
    wgmma_m64n128k16_rs_tb(o, a, desc_v);
  } else {
    wgmma_m64n64k16_rs_tb(o, a, desc_v);
  }
}

template <int D>
__global__ void __launch_bounds__(THREADS, 1)
flash_fwd_kernel(const __grid_constant__ CUtensorMap tm_q,  // (D, Lq, H, B)
                 const __grid_constant__ CUtensorMap tm_k,  // (D, Lk, H, B)
                 const __grid_constant__ CUtensorMap tm_v,  // (D, Lk, H, B)
                 __nv_bfloat16* __restrict__ out, int Lq, int Lk,
                 long long ob, long long oh, long long ol,
                 float scale_log2) {
  using S = FShape<D>;
  constexpr int BKV = S::BKV;
  constexpr int DP = S::DP;
  constexpr int DV = S::DV;
  // the output columns this block stores: D's (the pad columns past D are
  // not stored), or its whole slice
  constexpr int DOUT = S::NSLICE > 1 ? DV : D;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t{1023});
  uint8_t* q_s = smem;                        // NC x (BQ, 128 B)
  uint8_t* k_s = q_s + S::Q_BYTES;            // 2 stages x NC x (BKV, 128 B)
  uint8_t* v_s = k_s + 2 * S::KV_BYTES;       // 2 stages x DV/64 x (BKV, 128 B)
  uint64_t* q_full = reinterpret_cast<uint64_t*>(v_s + 2 * S::V_BYTES);
  uint64_t* k_full = q_full + 1;
  uint64_t* v_full = k_full + 2;
  uint64_t* empty = v_full + 2;

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int b = blockIdx.z / S::NSLICE;
  const int col0 = (blockIdx.z % S::NSLICE) * DV;  // first output column
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
        uint8_t* vd = v_s + st * S::V_BYTES;
        mbar_arrive_expect_tx(&k_full[st], S::KV_BYTES);
        for (int c = 0; c < S::NC; ++c)
          tma_load_4d(kd + c * S::CHUNK_KV, &tm_k, &k_full[st], c * CHUNK,
                      j * BKV, h, b);
        mbar_arrive_expect_tx(&v_full[st], S::V_BYTES);
        for (int c = 0; c < DV / CHUNK; ++c)
          tma_load_4d(vd + c * S::CHUNK_KV, &tm_v, &v_full[st],
                      col0 + c * CHUNK, j * BKV, h, b);
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

    // o[4i + 2r + c] = row g + 8r, column col0 + 8i + 2t + c of this
    // warp's rows
    float o[DV / 2];
#pragma unroll
    for (int i = 0; i < DV / 2; ++i) o[i] = 0.0f;
    float m_run[2] = {neg_inf, neg_inf};
    float l_run[2] = {0.0f, 0.0f};

    mbar_wait(q_full, 0);
    for (int j = 0; j < n_kv; ++j) {
      const int st = j & 1;
      const uint32_t ph = (j >> 1) & 1;
      const uint32_t kt = kb + st * S::KV_BYTES;
      const uint32_t vt = vb + st * S::V_BYTES;

      // S = Q Kᵀ: 64 rows x BKV keys, k over DP in steps of 16
      float s[BKV / 2];
      mbar_wait(&k_full[st], ph);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk)
        wgmma_qk<BKV>(
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
      // P as bf16 A fragments: keys 16kk .. 16kk+15 are S columns blocks
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
        pf[kk][0] = pack_bf16x2(p[0], p[1]);
        pf[kk][1] = pack_bf16x2(p[2], p[3]);
        pf[kk][2] = pack_bf16x2(p[4], p[5]);
        pf[kk][3] = pack_bf16x2(p[6], p[7]);
      }
#pragma unroll
      for (int i = 0; i < DV / 2; ++i) o[i] *= corr[(i >> 1) & 1];

      // O += P V: 16 keys a step; V's d chunks lie CHUNK_KV apart
      mbar_wait(&v_full[st], ph);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BKV / 16; ++kk)
        wgmma_pv<DV>(o, pf[kk],
                     wgmma_desc_mn128(vt + kk * 16 * 128, S::CHUNK_KV));
      wgmma_commit();
      wgmma_wait<0>();
#pragma unroll
      for (int i = 0; i < DV / 2; ++i) reg_fence(o[i]);
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
    __nv_bfloat16* op = out + b * ob + h * oh;
#pragma unroll
    for (int i = 0; i < DOUT / 8; ++i) {
      const int c = col0 + i * 8 + 2 * t;
      if (row0 < Lq) {
        *reinterpret_cast<__nv_bfloat162*>(op + row0 * ol + c) =
            __floats2bfloat162_rn(o[4 * i] * inv0, o[4 * i + 1] * inv0);
      }
      if (row0 + 8 < Lq) {
        *reinterpret_cast<__nv_bfloat162*>(op + (row0 + 8) * ol + c) =
            __floats2bfloat162_rn(o[4 * i + 2] * inv1, o[4 * i + 3] * inv1);
      }
    }
  }
}

// 4-D tensor map of a (B, H, L, D) bf16 view with element strides (sb, sh,
// sl) and unit stride along D; box: one 64-value d chunk of `rows` rows
// (past D, TMA fills the chunk with zeros). A dimension of extent 1 is
// never stepped, so it takes the stride D.
template <int D>
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
  return make_map_nd(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, base, 4, dims,
                     strides, box, CU_TENSOR_MAP_SWIZZLE_128B);
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   int B, int H, int Lq, int Lk, const long long* st,
                   float scale, cudaStream_t stream) {
  using S = FShape<D>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_fwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      S::SMEM);
  if (attr != cudaSuccess) return attr;
  CUtensorMap tm_q, tm_k, tm_v;
  bool ok = make_bhld_map<D>(&tm_q, q, B, H, Lq, st, BQ);
  ok = ok && make_bhld_map<D>(&tm_k, k, B, H, Lk, st + 3, S::BKV);
  ok = ok && make_bhld_map<D>(&tm_v, v, B, H, Lk, st + 6, S::BKV);
  if (!ok) return cudaErrorInvalidValue;
  dim3 grid((Lq + BQ - 1) / BQ, H, B * S::NSLICE);
  flash_fwd_kernel<D><<<grid, THREADS, S::SMEM, stream>>>(
      tm_q, tm_k, tm_v, static_cast<__nv_bfloat16*>(out), Lq, Lk, st[9],
      st[10], st[11], scale * 1.4426950408889634f);
  return cudaGetLastError();
}

}  // namespace

// Dynamic shared memory of a launch at head dim D (0 for another D).
extern "C" int flash_attn_smem_bytes(int D) {
  switch (D) {
    case 40: return FShape<40>::SMEM;
    case 64: return FShape<64>::SMEM;
    case 80: return FShape<80>::SMEM;
    case 96: return FShape<96>::SMEM;
    case 128: return FShape<128>::SMEM;
    case 160: return FShape<160>::SMEM;
    case 256: return FShape<256>::SMEM;
    case 384: return FShape<384>::SMEM;
    case 512: return FShape<512>::SMEM;
    default: return 0;
  }
}

// Plain C entry (bound with ctypes). q/k/v/out are (B, H, L, D) views with
// unit stride along D; strides[12] = (b, h, l) element strides of q, k, v
// and out. The wrapper checks D in {40, 64, 80, 96, 128, 160, 256, 384,
// 512}, Lk >= 1,
// and TMA's rule for the base and the strides (multiples of 16 bytes).
// Returns cudaGetLastError().
extern "C" int flash_attn_launch(const void* q, const void* k, const void* v,
                                 void* out, int B, int H, int Lq, int Lk,
                                 int D, const long long* strides, float scale,
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
