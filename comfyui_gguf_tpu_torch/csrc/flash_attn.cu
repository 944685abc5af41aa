// K7: flash attention forward, non-causal, bf16 in and out.
//
// Replaces the library Pallas kernels the reference package calls from
// comfyui_gguf_tpu/nn/attention.py (_splash_attention and the flash branch
// of dot_product_attention):
//
//   out[b, h, i, :] = softmax_j(scale * q[b, h, i, :] . k[b, h, j, :]) v[b, h, j, :]
//
// What bounds it: bf16 tensor-core operations (4·L²·D per head at flux's
// L = 4608, D = 128). Design (FlashAttention-2 on the warp-level tensor
// cores): a 128-thread block owns 64 query rows of one (b, h), 16 per warp,
// with q held in registers as mma A fragments. It walks the keys in tiles
// of 64: K and V tiles arrive in shared memory by cp.async into two
// buffers, the next tile's copy in flight while this one computes; S stays
// in registers, the online softmax keeps the
// running max m, sum l and the f32 output accumulator per row, and P feeds
// the P·V product straight from registers (the S accumulator layout is the
// A-operand layout). No L×L tensor touches global memory. Keys past Lk are
// zero-filled and masked to -inf; query rows past Lq are not stored.
#include "common.cuh"

using namespace gguf_cuda;

namespace {

constexpr int BQ = 64;
constexpr int BKV = 64;
constexpr int THREADS = 128;

template <int D>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const __nv_bfloat16* __restrict__ q,
                 const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v,
                 __nv_bfloat16* __restrict__ out, int H, int Lq, int Lk,
                 long long qb, long long qh, long long ql, long long kb,
                 long long kh, long long kl, long long vb, long long vh,
                 long long vl, long long ob, long long oh, long long ol,
                 float scale_log2) {
  constexpr int ST = D + 8;  // smem row stride (bf16)
  constexpr int VEC = D / 8;  // 16-byte vectors per row
  constexpr int TILE = BKV * ST;
  extern __shared__ __align__(16) __nv_bfloat16 smem[];
  __nv_bfloat16* ks_s = smem;             // 2 x (BKV, ST)
  __nv_bfloat16* vs_s = smem + 2 * TILE;  // 2 x (BKV, ST)

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int q0 = blockIdx.x * BQ;

  const __nv_bfloat16* qp = q + b * qb + h * qh;
  const __nv_bfloat16* kp = k + b * kb + h * kh;
  const __nv_bfloat16* vp = v + b * vb + h * vh;

  // tile of 64 rows x D from a (rows, D) view with row stride ls
  auto copy_tile = [&](__nv_bfloat16* dst, const __nv_bfloat16* src,
                       long long ls, int r0, int n_rows) {
#pragma unroll
    for (int i = 0; i < BKV * VEC / THREADS; ++i) {
      const int idx = tid + i * THREADS;
      const int row = idx / VEC;
      const int c = (idx % VEC) * 8;
      const int r = r0 + row;
      const bool ok = r < n_rows;
      const __nv_bfloat16* g = src + (ok ? r * ls + c : 0);
      cp_async_16(&dst[row * ST + c], g, ok ? 16 : 0);
    }
  };

  // q tile -> registers (A fragments), staged through the K buffer
  copy_tile(ks_s, qp, ql, q0, Lq);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  uint32_t qf[D / 16][4];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int row = warp * 16 + (lane & 15);
    ldmatrix_x4(qf[kk], &ks_s[row * ST + kk * 16 + (lane >> 4) * 8]);
  }

  float o[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) o[i][j] = 0.0f;
  const float neg_inf = -__int_as_float(0x7f800000);
  float m_run[2] = {neg_inf, neg_inf};
  float l_run[2] = {0.0f, 0.0f};

  const int n_tiles = (Lk + BKV - 1) / BKV;
  __syncthreads();  // the q staging in ks_s is consumed
  auto issue = [&](int t) {
    if (t < n_tiles) {
      copy_tile(ks_s + (t & 1) * TILE, kp, kl, t * BKV, Lk);
      copy_tile(vs_s + (t & 1) * TILE, vp, vl, t * BKV, Lk);
    }
    cp_async_commit();
  };
  issue(0);
  for (int t = 0; t < n_tiles; ++t) {
    const int kv0 = t * BKV;
    issue(t + 1);  // into the buffer tile t-1 released
    cp_async_wait<1>();
    __syncthreads();  // tile t landed for every thread
    const __nv_bfloat16* kt = ks_s + (t & 1) * TILE;
    const __nv_bfloat16* vt = vs_s + (t & 1) * TILE;

    // S = q kᵀ for this warp's 16 rows x 64 keys
    float s[BKV / 8][4];
#pragma unroll
    for (int i = 0; i < BKV / 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
      for (int nj = 0; nj < BKV / 16; ++nj) {
        uint32_t bf[4];
        const int kr = nj * 16 + (lane >> 4) * 8 + (lane & 7);
        ldmatrix_x4(bf, &kt[kr * ST + kk * 16 + ((lane >> 3) & 1) * 8]);
        mma_bf16_16816(s[2 * nj], qf[kk], bf[0], bf[1]);
        mma_bf16_16816(s[2 * nj + 1], qf[kk], bf[2], bf[3]);
      }
    }

    // online softmax (base 2, scale folded in); rows g and g+8 of the warp
    float mx[2] = {m_run[0], m_run[1]};
#pragma unroll
    for (int ni = 0; ni < BKV / 8; ++ni) {
      const int c = kv0 + ni * 8 + (lane & 3) * 2;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const bool valid = c + (j & 1) < Lk;
        s[ni][j] = valid ? s[ni][j] * scale_log2 : neg_inf;
        mx[j >> 1] = fmaxf(mx[j >> 1], s[ni][j]);
      }
    }
    float corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      corr[r] = exp2f(m_run[r] - mx[r]);
      m_run[r] = mx[r];
      l_run[r] *= corr[r];
    }
    uint32_t pf[BKV / 16][4];
#pragma unroll
    for (int ni = 0; ni < BKV / 8; ++ni) {
      const float p0 = exp2f(s[ni][0] - mx[0]);
      const float p1 = exp2f(s[ni][1] - mx[0]);
      const float p2 = exp2f(s[ni][2] - mx[1]);
      const float p3 = exp2f(s[ni][3] - mx[1]);
      l_run[0] += p0 + p1;
      l_run[1] += p2 + p3;
      __nv_bfloat162 lo = __floats2bfloat162_rn(p0, p1);
      __nv_bfloat162 hi = __floats2bfloat162_rn(p2, p3);
      // S tile ni is half of the k16 A fragment (ni / 2) of P·V
      pf[ni >> 1][(ni & 1) * 2] = *reinterpret_cast<uint32_t*>(&lo);
      pf[ni >> 1][(ni & 1) * 2 + 1] = *reinterpret_cast<uint32_t*>(&hi);
    }
#pragma unroll
    for (int i = 0; i < D / 8; ++i) {
      o[i][0] *= corr[0];
      o[i][1] *= corr[0];
      o[i][2] *= corr[1];
      o[i][3] *= corr[1];
    }

    // O += P V
#pragma unroll
    for (int kk = 0; kk < BKV / 16; ++kk) {
#pragma unroll
      for (int nd = 0; nd < D / 16; ++nd) {
        uint32_t bf[4];
        const int kr = kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
        ldmatrix_x4_trans(bf, &vt[kr * ST + nd * 16 + (lane >> 4) * 8]);
        mma_bf16_16816(o[2 * nd], pf[kk], bf[0], bf[1]);
        mma_bf16_16816(o[2 * nd + 1], pf[kk], bf[2], bf[3]);
      }
    }
    __syncthreads();  // tile t consumed before its buffer is refilled
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 1);
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 2);
  }
  const float inv0 = 1.0f / l_run[0];
  const float inv1 = 1.0f / l_run[1];
  const int row0 = q0 + warp * 16 + (lane >> 2);
  __nv_bfloat16* op = out + b * ob + h * oh;
#pragma unroll
  for (int i = 0; i < D / 8; ++i) {
    const int c = i * 8 + (lane & 3) * 2;
    if (row0 < Lq) {
      *reinterpret_cast<__nv_bfloat162*>(op + row0 * ol + c) =
          __floats2bfloat162_rn(o[i][0] * inv0, o[i][1] * inv0);
    }
    if (row0 + 8 < Lq) {
      *reinterpret_cast<__nv_bfloat162*>(op + (row0 + 8) * ol + c) =
          __floats2bfloat162_rn(o[i][2] * inv1, o[i][3] * inv1);
    }
  }
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   int B, int H, int Lq, int Lk, const long long* st,
                   float scale, cudaStream_t stream) {
  constexpr int smem = 4 * BKV * (D + 8) * 2;
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_fwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return attr;
  dim3 grid((Lq + BQ - 1) / BQ, H, B);
  flash_fwd_kernel<D><<<grid, THREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out),
      H, Lq, Lk, st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7],
      st[8], st[9], st[10], st[11], scale * 1.4426950408889634f);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry (bound with ctypes). q/k/v/out are (B, H, L, D) views with
// unit stride along D; strides[12] = (b, h, l) element strides of q, k, v
// and out. The wrapper checks D in {64, 128}, Lk >= 1, 16-byte alignment of
// every row. Returns cudaGetLastError().
extern "C" int flash_attn_launch(const void* q, const void* k, const void* v,
                                 void* out, int B, int H, int Lq, int Lk,
                                 int D, const long long* strides, float scale,
                                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 64) return launch<64>(q, k, v, out, B, H, Lq, Lk, strides,
                                 scale, s);
  if (D == 128) return launch<128>(q, k, v, out, B, H, Lq, Lk, strides,
                                   scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
