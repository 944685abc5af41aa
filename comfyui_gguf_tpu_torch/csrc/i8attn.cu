// K6: int8 flash attention forward (SageAttention-style), head dim 128.
//
// Replaces the Pallas kernel of comfyui_gguf_tpu/ops/i8attn.py
// (_make_attn_kernel, launched by pallas_i8_attention). Operands come from
// the shared prep (ops/i8attn.py quantize_attn_inputs): per-row s8 q with the
// softmax scale folded into qs, per-row s8 mean-smoothed k, and either
// per-channel s8 v (mode "pv") or bf16 v (mode "qk"):
//
//   s[i, j]  = float(sum_d qq[i, d] * kq[j, d]) * qs[i] * ks[j]   (s32 exact)
//   online softmax over key tiles in f32 (running m, l, acc per row)
//   "pv":  pq = round_half_even(127 * p) as s8;  acc = acc*alpha + float(pq . vq)
//          out = acc * ((1/127) / l) * vs[d]
//   "qk":  acc = acc*alpha + bf16(p) . v (f32 accumulate);  out = acc / l
//
// p is quantized against the running row maximum, so the result depends on
// the key-tile size (64 here); the plain version takes the same tile size.
//
// What bounds it: int8 tensor-core operations (4·L²·D per head, the PV half
// at the bf16 rate in mode "qk") next to L² exponentials per head. Design:
// a 128-thread block owns 64 query rows of one (b, h), 16 per warp, with q
// held in registers as s8 mma A fragments. K and V tiles of 64 keys arrive
// by cp.async into two buffers, the next tile's copy in flight while this
// one computes. k stays (L, D) row-major, which is the "col" B operand of
// mma.m16n8k32 as it is. In mode "pv" the C fragment of the first product
// is not the A fragment of the second (an s8 A register holds four
// consecutive k), so the kernel permutes the KEY ORDER inside each chunk of
// 32 keys instead of shuffling: a thread packs the eight probabilities it
// already holds into its own A registers, and the v tile is transposed 4x4
// bytes at a time (__byte_perm) into a channel-major tile whose key order
// carries the same permutation. The s32 product of each key tile is
// converted to f32 and added to acc*alpha; nothing L×L reaches global
// memory. Keys past Lk are zero-filled and masked to -1e30; query rows past
// Lq are not stored.
#include "common.cuh"

using namespace gguf_cuda;

namespace {

constexpr int D = 128;
constexpr int BQ = 64;
constexpr int BKV = 64;
constexpr int THREADS = 128;
constexpr int KST = D + 16;          // s8 tile row stride (bytes)
constexpr int K_TILE = BKV * KST;    // one s8 (64, D) tile
constexpr int VT_ST = BKV + 16;      // channel-major v tile row stride
constexpr int VT_BYTES = D * VT_ST;
constexpr int VB_ST = D + 8;         // bf16 v tile row stride (elements)
constexpr int VB_TILE = BKV * VB_ST * 2;  // bytes
constexpr float NEG = -1e30f;

template <bool PV8>
constexpr int smem_bytes() {
  return PV8 ? 4 * K_TILE + VT_BYTES : 2 * K_TILE + 2 * VB_TILE;
}

template <bool PV8>
__global__ void __launch_bounds__(THREADS)
i8attn_kernel(const int8_t* __restrict__ qq,   // (BH, Lq, D)
              const float* __restrict__ qs,    // (BH, Lq)
              const int8_t* __restrict__ kq,   // (BH, Lk, D)
              const float* __restrict__ ks,    // (BH, Lk)
              const void* __restrict__ v,      // s8 or bf16, strided
              const float* __restrict__ vs,    // (BH, D), mode "pv"
              __nv_bfloat16* __restrict__ out, int H, int Lq, int Lk,
              long long vb, long long vh, long long vl, long long ob,
              long long oh, long long ol) {
  extern __shared__ __align__(16) int8_t smem[];
  int8_t* k_s = smem;               // 2 x (BKV, KST)
  int8_t* v_s = smem + 2 * K_TILE;  // "pv": 2 raw s8 tiles; "qk": 2 bf16
  int8_t* vt_s = smem + 4 * K_TILE;  // "pv": (D, VT_ST) channel-major

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int q0 = blockIdx.x * BQ;
  const long long bh = static_cast<long long>(b) * H + h;

  const int8_t* qp = qq + bh * Lq * D;
  const int8_t* kp = kq + bh * Lk * D;
  const float* ksp = ks + bh * Lk;

  // 64 rows x 128 bytes from an s8 (rows, D) array
  auto copy_s8 = [&](int8_t* dst, const int8_t* src, long long ls, int r0,
                     int n_rows) {
#pragma unroll
    for (int i = 0; i < BKV * (D / 16) / THREADS; ++i) {
      const int idx = tid + i * THREADS;
      const int row = idx >> 3;
      const int c = (idx & 7) * 16;
      const int r = r0 + row;
      const bool ok = r < n_rows;
      cp_async_16(dst + row * KST + c, ok ? src + r * ls + c : src,
                  ok ? 16 : 0);
    }
  };
  // 64 rows x D bf16 from a view with row stride ls (elements)
  auto copy_bf16 = [&](__nv_bfloat16* dst, const __nv_bfloat16* src,
                       long long ls, int r0, int n_rows) {
#pragma unroll
    for (int i = 0; i < BKV * (D / 8) / THREADS; ++i) {
      const int idx = tid + i * THREADS;
      const int row = idx >> 4;
      const int c = (idx & 15) * 8;
      const int r = r0 + row;
      const bool ok = r < n_rows;
      cp_async_16(&dst[row * VB_ST + c], ok ? src + r * ls + c : src,
                  ok ? 16 : 0);
    }
  };

  // q tile -> registers (A fragments), staged through the first K buffer
  copy_s8(k_s, qp, D, q0, Lq);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  uint32_t qf[D / 32][4];
#pragma unroll
  for (int kk = 0; kk < D / 32; ++kk) {
    const int row = warp * 16 + (lane & 15);
    ldmatrix_x4(qf[kk], k_s + row * KST + kk * 32 + (lane >> 4) * 16);
  }
  const int row0 = q0 + warp * 16 + (lane >> 2);
  const float qs0 = row0 < Lq ? qs[bh * Lq + row0] : 0.0f;
  const float qs1 = row0 + 8 < Lq ? qs[bh * Lq + row0 + 8] : 0.0f;

  float o[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) o[i][j] = 0.0f;
  float m_run[2] = {NEG, NEG};
  float l_run[2] = {0.0f, 0.0f};

  const int n_tiles = (Lk + BKV - 1) / BKV;
  __syncthreads();  // the q staging in k_s is consumed
  auto issue = [&](int t) {
    if (t < n_tiles) {
      copy_s8(k_s + (t & 1) * K_TILE, kp, D, t * BKV, Lk);
      if (PV8) {
        copy_s8(v_s + (t & 1) * K_TILE,
                static_cast<const int8_t*>(v) + b * vb + h * vh, vl, t * BKV,
                Lk);
      } else {
        copy_bf16(reinterpret_cast<__nv_bfloat16*>(v_s + (t & 1) * VB_TILE),
                  static_cast<const __nv_bfloat16*>(v) + b * vb + h * vh, vl,
                  t * BKV, Lk);
      }
    }
    cp_async_commit();
  };

  // raw (key, channel) s8 tile -> channel-major tile in the permuted key
  // order: byte 4w+e of a channel row, w = 8*kk + 4*hh + t, holds key
  // 32*kk + 16*hh + {2t, 2t+1, 8+2t, 9+2t}[e]  (the keys whose
  // probabilities thread t of a quad packs into one A register)
  auto transpose_v = [&](const int8_t* raw) {
    const int w = (lane & 7) + 8 * (warp & 1);
    const int base = (w >> 3) * 32 + ((w >> 2) & 1) * 16 + (w & 3) * 2;
    const int rows[4] = {base, base + 1, base + 8, base + 9};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int cq = (lane >> 3) + 4 * (warp >> 1) + 8 * i;
      uint32_t x[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        x[r] = *reinterpret_cast<const uint32_t*>(raw + rows[r] * KST +
                                                  cq * 4);
      }
      const uint32_t t0 = __byte_perm(x[0], x[1], 0x5140);
      const uint32_t t1 = __byte_perm(x[0], x[1], 0x7362);
      const uint32_t t2 = __byte_perm(x[2], x[3], 0x5140);
      const uint32_t t3 = __byte_perm(x[2], x[3], 0x7362);
      const uint32_t col[4] = {__byte_perm(t0, t2, 0x5410),
                               __byte_perm(t0, t2, 0x7632),
                               __byte_perm(t1, t3, 0x5410),
                               __byte_perm(t1, t3, 0x7632)};
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        *reinterpret_cast<uint32_t*>(vt_s + (cq * 4 + c) * VT_ST + w * 4) =
            col[c];
      }
    }
  };

  issue(0);
  for (int t = 0; t < n_tiles; ++t) {
    const int kv0 = t * BKV;
    issue(t + 1);  // into the buffers tile t-1 released
    cp_async_wait<1>();
    __syncthreads();  // tile t landed for every thread
    const int8_t* kt = k_s + (t & 1) * K_TILE;
    if (PV8) transpose_v(v_s + (t & 1) * K_TILE);

    // S = qq kqᵀ for this warp's 16 rows x 64 keys, exact in s32
    int s[BKV / 8][4];
#pragma unroll
    for (int i = 0; i < BKV / 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0;
#pragma unroll
    for (int kk = 0; kk < D / 32; ++kk) {
#pragma unroll
      for (int nj = 0; nj < BKV / 16; ++nj) {
        uint32_t bf[4];
        const int n = nj * 16 + (lane >> 4) * 8 + (lane & 7);
        const int c = kk * 2 + ((lane >> 3) & 1);
        ldmatrix_x4(bf, kt + n * KST + c * 16);
        mma_s8_16832(s[2 * nj], qf[kk], bf[0], bf[1]);
        mma_s8_16832(s[2 * nj + 1], qf[kk], bf[2], bf[3]);
      }
    }

    // f32 logits (s32 * qs) * ks, pad keys at -1e30; rows g and g+8
    float p[BKV / 8][4];
    float mx[2] = {m_run[0], m_run[1]};
#pragma unroll
    for (int ni = 0; ni < BKV / 8; ++ni) {
      const int c = kv0 + ni * 8 + (lane & 3) * 2;
      const bool ok0 = c < Lk;
      const bool ok1 = c + 1 < Lk;
      const float k0 = ok0 ? ksp[c] : 0.0f;
      const float k1 = ok1 ? ksp[c + 1] : 0.0f;
      p[ni][0] = ok0 ? __fmul_rn(__fmul_rn(__int2float_rn(s[ni][0]), qs0), k0)
                     : NEG;
      p[ni][1] = ok1 ? __fmul_rn(__fmul_rn(__int2float_rn(s[ni][1]), qs0), k1)
                     : NEG;
      p[ni][2] = ok0 ? __fmul_rn(__fmul_rn(__int2float_rn(s[ni][2]), qs1), k0)
                     : NEG;
      p[ni][3] = ok1 ? __fmul_rn(__fmul_rn(__int2float_rn(s[ni][3]), qs1), k1)
                     : NEG;
      mx[0] = fmaxf(mx[0], fmaxf(p[ni][0], p[ni][1]));
      mx[1] = fmaxf(mx[1], fmaxf(p[ni][2], p[ni][3]));
    }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      alpha[r] = __expf(m_run[r] - mx[r]);
      m_run[r] = mx[r];
      l_run[r] *= alpha[r];
    }
#pragma unroll
    for (int ni = 0; ni < BKV / 8; ++ni) {
      p[ni][0] = __expf(p[ni][0] - mx[0]);
      p[ni][1] = __expf(p[ni][1] - mx[0]);
      p[ni][2] = __expf(p[ni][2] - mx[1]);
      p[ni][3] = __expf(p[ni][3] - mx[1]);
      l_run[0] += p[ni][0] + p[ni][1];
      l_run[1] += p[ni][2] + p[ni][3];
    }

    if (PV8) {
      // pq = round(127 p) packed into this thread's own A registers:
      // chunk kk of 32 keys = S tiles 4kk..4kk+3; registers 0/1 (rows g,
      // g+8) take tiles 4kk, 4kk+1, registers 2/3 take tiles 4kk+2, 4kk+3
      uint32_t pa[BKV / 32][4];
      auto q8 = [](float x) {
        return static_cast<uint32_t>(__float2int_rn(__fmul_rn(x, 127.0f)));
      };
#pragma unroll
      for (int kk = 0; kk < BKV / 32; ++kk) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const float* a = p[4 * kk + 2 * half];
          const float* c = p[4 * kk + 2 * half + 1];
          pa[kk][2 * half] =
              q8(a[0]) | (q8(a[1]) << 8) | (q8(c[0]) << 16) | (q8(c[1]) << 24);
          pa[kk][2 * half + 1] =
              q8(a[2]) | (q8(a[3]) << 8) | (q8(c[2]) << 16) | (q8(c[3]) << 24);
        }
      }
      __syncthreads();  // the channel-major v tile is complete
#pragma unroll
      for (int nd = 0; nd < D / 16; ++nd) {
        int t0[4] = {0, 0, 0, 0};
        int t1[4] = {0, 0, 0, 0};
#pragma unroll
        for (int kk = 0; kk < BKV / 32; ++kk) {
          uint32_t bf[4];
          const int n = nd * 16 + (lane >> 4) * 8 + (lane & 7);
          const int c = kk * 2 + ((lane >> 3) & 1);
          ldmatrix_x4(bf, vt_s + n * VT_ST + c * 16);
          mma_s8_16832(t0, pa[kk], bf[0], bf[1]);
          mma_s8_16832(t1, pa[kk], bf[2], bf[3]);
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          o[2 * nd][j] = o[2 * nd][j] * alpha[j >> 1] + __int2float_rn(t0[j]);
          o[2 * nd + 1][j] =
              o[2 * nd + 1][j] * alpha[j >> 1] + __int2float_rn(t1[j]);
        }
      }
    } else {
      const __nv_bfloat16* vt =
          reinterpret_cast<const __nv_bfloat16*>(v_s + (t & 1) * VB_TILE);
      uint32_t pf[BKV / 16][4];
#pragma unroll
      for (int ni = 0; ni < BKV / 8; ++ni) {
        __nv_bfloat162 lo = __floats2bfloat162_rn(p[ni][0], p[ni][1]);
        __nv_bfloat162 hi = __floats2bfloat162_rn(p[ni][2], p[ni][3]);
        pf[ni >> 1][(ni & 1) * 2] = *reinterpret_cast<uint32_t*>(&lo);
        pf[ni >> 1][(ni & 1) * 2 + 1] = *reinterpret_cast<uint32_t*>(&hi);
      }
#pragma unroll
      for (int i = 0; i < D / 8; ++i) {
        o[i][0] *= alpha[0];
        o[i][1] *= alpha[0];
        o[i][2] *= alpha[1];
        o[i][3] *= alpha[1];
      }
#pragma unroll
      for (int kk = 0; kk < BKV / 16; ++kk) {
#pragma unroll
        for (int nd = 0; nd < D / 16; ++nd) {
          uint32_t bf[4];
          const int kr = kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
          ldmatrix_x4_trans(bf, &vt[kr * VB_ST + nd * 16 + (lane >> 4) * 8]);
          mma_bf16_16816(o[2 * nd], pf[kk], bf[0], bf[1]);
          mma_bf16_16816(o[2 * nd + 1], pf[kk], bf[2], bf[3]);
        }
      }
    }
    __syncthreads();  // tile t consumed before its buffers are refilled
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 1);
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 2);
  }
  __nv_bfloat16* op = out + b * ob + h * oh;
  const float inv0 = PV8 ? (1.0f / 127.0f) / l_run[0] : 1.0f / l_run[0];
  const float inv1 = PV8 ? (1.0f / 127.0f) / l_run[1] : 1.0f / l_run[1];
#pragma unroll
  for (int i = 0; i < D / 8; ++i) {
    const int c = i * 8 + (lane & 3) * 2;
    float c0 = 1.0f, c1 = 1.0f;
    if (PV8) {
      c0 = vs[bh * D + c];
      c1 = vs[bh * D + c + 1];
    }
    if (row0 < Lq) {
      *reinterpret_cast<__nv_bfloat162*>(op + row0 * ol + c) =
          __floats2bfloat162_rn(__fmul_rn(o[i][0] * inv0, c0),
                                __fmul_rn(o[i][1] * inv0, c1));
    }
    if (row0 + 8 < Lq) {
      *reinterpret_cast<__nv_bfloat162*>(op + (row0 + 8) * ol + c) =
          __floats2bfloat162_rn(__fmul_rn(o[i][2] * inv1, c0),
                                __fmul_rn(o[i][3] * inv1, c1));
    }
  }
}

template <bool PV8>
cudaError_t launch(const void* qq, const void* qs, const void* kq,
                   const void* ks, const void* v, const void* vs, void* out,
                   int B, int H, int Lq, int Lk, const long long* st,
                   cudaStream_t stream) {
  constexpr int smem = smem_bytes<PV8>();
  static const cudaError_t attr = cudaFuncSetAttribute(
      i8attn_kernel<PV8>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return attr;
  dim3 grid((Lq + BQ - 1) / BQ, H, B);
  i8attn_kernel<PV8><<<grid, THREADS, smem, stream>>>(
      static_cast<const int8_t*>(qq), static_cast<const float*>(qs),
      static_cast<const int8_t*>(kq), static_cast<const float*>(ks), v,
      static_cast<const float*>(vs), static_cast<__nv_bfloat16*>(out), H, Lq,
      Lk, st[0], st[1], st[2], st[3], st[4], st[5]);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry (bound with ctypes). qq (BH, Lq, D) and kq (BH, Lk, D) are
// contiguous s8, qs (BH, Lq) and ks (BH, Lk) contiguous f32. pv_int8 != 0:
// v is s8 and vs (BH, D) f32; else v is bf16 and vs is unused. v and out are
// (B, H, L, D) views with unit stride along D; strides[6] = (b, h, l) element
// strides of v and of out. The wrapper checks D == 128, Lk >= 1 and the
// 16-byte alignment of every v row. Returns cudaGetLastError().
extern "C" int i8attn_launch(const void* qq, const void* qs, const void* kq,
                             const void* ks, const void* v, const void* vs,
                             void* out, int B, int H, int Lq, int Lk, int D_,
                             int pv_int8, const long long* strides,
                             void* stream) {
  if (D_ != D) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (pv_int8) {
    return launch<true>(qq, qs, kq, ks, v, vs, out, B, H, Lq, Lk, strides, s);
  }
  return launch<false>(qq, qs, kq, ks, v, vs, out, B, H, Lq, Lk, strides, s);
}
