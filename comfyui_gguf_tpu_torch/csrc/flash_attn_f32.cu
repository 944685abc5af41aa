// K7's f32 instances: flash attention forward, non-causal, f32 in and out,
// on the FMA units.
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
// plain_attention does in f32. No TF32 (it rounds operands to 10 mantissa
// bits) and no 3xTF32: the products run as f32 FMAs, as the f32 body of
// the fused dequant-matmul (qmm_simt.cu) does.
//
// What bounds it: f32 FMAs, 4·L²·D operations per head (2·L²·D for
// Q·Kᵀ, as many for P·V) at the card's f32 rate outside the tensor
// cores; the softmax's exponentials are one per score beside 2·D FMAs
// per score.
// Design: a block of 256 threads owns 64 query rows of one (b, h). Q
// stays in shared memory for the whole block, transposed (d-major) and
// zero-filled past D and past Lq. The keys go by tiles of 64: K streams in
// chunks of 32 d values (transposed, zero-filled past Lk) and thread
// (ty, tx) of the 16 x 16 grid accumulates the scores of rows 4ty..4ty+3
// against keys 4tx..4tx+3 from two 16-byte shared loads a d step. The
// online softmax runs on those registers in base 2 (the scale folded into
// exp2f's argument, as the bf16 body does): a row's maximum is taken over
// the 16 threads of a half-warp by shuffles, each thread keeps a partial
// row sum (the 16 partials are added once at the end) and rescales its
// output registers. P goes to shared memory key-major, the V tile (64 keys
// x DV columns, zero-filled) beside it, and each thread accumulates rows
// 4ty..4ty+3 of columns 4tx + 64c .. +3 of O. Loads go through registers
// and are not overlapped with the products: a first instance that is
// right, whose time PERF.md records.
//
// Head dims: the scores run over D padded to 32 (zeros add nothing). A
// block owns DV output columns: D padded to 64 up to D = 128, else 128
// columns of a split (grid z holds B x NSLICE blocks per query tile, as
// flash_attn.cuh's D = 384 and 512 instances do), each block recomputing
// the scores over all of D. Shared memory: Q (D₃₂ x 68 floats), a K chunk
// (32 x 68), the V tile (64 x DV) and P (64 x 68): 93,696 bytes at D =
// 128 (two blocks an SM), 198,144 at D = 512.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;        // query rows a block
constexpr int BKV = 64;       // keys a tile
constexpr int DK = 32;        // d values of a K chunk
constexpr int THREADS = 256;  // a 16 x 16 grid of (ty, tx)
constexpr int LDT = BQ + 4;   // row length (floats) of the transposed tiles

// (b, h, l) element strides of q, k, v and out, by value
struct Strides {
  long long v[12];
};

template <int D>
struct F32Shape {
  static constexpr int DP = (D + DK - 1) / DK * DK;  // the scores' depth
  static constexpr int DV = D > 128 ? 128 : (D + 63) / 64 * 64;
  static constexpr int NSLICE = (D + DV - 1) / DV;
  static constexpr int NCOL = DV / 16;  // output columns a thread
  static constexpr int SMEM =
      (DP * LDT + DK * LDT + BKV * DV + BKV * LDT) * 4;
  static_assert(SMEM <= 232448, "past the shared memory of a block");
};

__device__ __forceinline__ float4 load4(const float* p, bool ok) {
  return ok ? *reinterpret_cast<const float4*>(p)
            : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
}

template <int D>
__global__ void __launch_bounds__(THREADS)
flash_simt_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ out,
                 int H, int Lq, int Lk, const Strides strides,
                 float scale_log2) {
  using S = F32Shape<D>;
  constexpr int DP = S::DP;
  constexpr int DV = S::DV;
  constexpr int NCOL = S::NCOL;
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);  // (DP, LDT): Q transposed
  float* ks = qs + DP * LDT;                     // (DK, LDT): K chunk
  float* vs = ks + DK * LDT;                     // (BKV, DV): V tile
  float* ps = vs + BKV * DV;                     // (BKV, LDT): P, key-major

  const long long* st = strides.v;
  const int tid = threadIdx.x;
  const int ty = tid >> 4;
  const int tx = tid & 15;
  const int b = blockIdx.z / S::NSLICE;
  const int col0 = (blockIdx.z % S::NSLICE) * DV;
  const int h = blockIdx.y;
  const int q0 = blockIdx.x * BQ;
  const float* qb = q + b * st[0] + h * st[1];
  const float* kb = k + b * st[3] + h * st[4];
  const float* vb = v + b * st[6] + h * st[7];

  // Q, transposed, zero past D and Lq
  for (int idx = tid; idx < BQ * (DP / 4); idx += THREADS) {
    const int row = idx / (DP / 4);
    const int d = (idx % (DP / 4)) * 4;
    const float4 x = load4(qb + (q0 + row) * st[2] + d,
                           q0 + row < Lq && d < D);
    qs[(d + 0) * LDT + row] = x.x;
    qs[(d + 1) * LDT + row] = x.y;
    qs[(d + 2) * LDT + row] = x.z;
    qs[(d + 3) * LDT + row] = x.w;
  }

  const float neg_inf = -__int_as_float(0x7f800000);
  float o[4][NCOL];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < NCOL; ++c) o[i][c] = 0.0f;
  float m_run[4], l_run[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m_run[i] = neg_inf;
    l_run[i] = 0.0f;
  }

  const int n_kv = (Lk + BKV - 1) / BKV;
  for (int j = 0; j < n_kv; ++j) {
    const int k0 = j * BKV;
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[i][e] = 0.0f;

    // S = Q Kᵀ over DP in chunks of DK
    for (int dc = 0; dc < DP; dc += DK) {
      __syncthreads();  // the last chunk's (and tile's) readers are done
      for (int idx = tid; idx < BKV * (DK / 4); idx += THREADS) {
        const int key = idx / (DK / 4);
        const int d = (idx % (DK / 4)) * 4;
        const float4 x = load4(kb + (k0 + key) * st[5] + dc + d,
                               k0 + key < Lk && dc + d < D);
        ks[(d + 0) * LDT + key] = x.x;
        ks[(d + 1) * LDT + key] = x.y;
        ks[(d + 2) * LDT + key] = x.z;
        ks[(d + 3) * LDT + key] = x.w;
      }
      __syncthreads();
#pragma unroll 8
      for (int dd = 0; dd < DK; ++dd) {
        const float4 a =
            *reinterpret_cast<const float4*>(qs + (dc + dd) * LDT + 4 * ty);
        const float4 bk =
            *reinterpret_cast<const float4*>(ks + dd * LDT + 4 * tx);
        const float av[4] = {a.x, a.y, a.z, a.w};
        const float bv[4] = {bk.x, bk.y, bk.z, bk.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[i][e] = fmaf(av[i], bv[e], s[i][e]);
      }
    }

    // the V tile: keys k0.., this block's columns, zero past Lk and D
    for (int idx = tid; idx < BKV * (DV / 4); idx += THREADS) {
      const int key = idx / (DV / 4);
      const int c = (idx % (DV / 4)) * 4;
      *reinterpret_cast<float4*>(vs + key * DV + c) =
          load4(vb + (k0 + key) * st[8] + col0 + c,
                k0 + key < Lk && col0 + c < D);
    }

    // online softmax (base 2, scale folded in) on rows 4ty + i
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = m_run[i];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[i][e] = k0 + 4 * tx + e < Lk ? s[i][e] * scale_log2 : neg_inf;
        mx = fmaxf(mx, s[i][e]);
      }
#pragma unroll
      for (int off = 1; off < 16; off <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float corr = exp2f(m_run[i] - mx);
      m_run[i] = mx;
      float sum = 0.0f;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[i][e] = exp2f(s[i][e] - mx);
        sum += s[i][e];
      }
      l_run[i] = l_run[i] * corr + sum;
#pragma unroll
      for (int c = 0; c < NCOL; ++c) o[i][c] *= corr;
    }
    // P key-major: column 4ty..4ty+3 of key row 4tx + e
#pragma unroll
    for (int e = 0; e < 4; ++e)
      *reinterpret_cast<float4*>(ps + (4 * tx + e) * LDT + 4 * ty) =
          make_float4(s[0][e], s[1][e], s[2][e], s[3][e]);
    __syncthreads();

    // O += P V
#pragma unroll 4
    for (int kk = 0; kk < BKV; ++kk) {
      const float4 p = *reinterpret_cast<const float4*>(ps + kk * LDT + 4 * ty);
      const float pv[4] = {p.x, p.y, p.z, p.w};
#pragma unroll
      for (int cc = 0; cc < NCOL / 4; ++cc) {
        const float4 x =
            *reinterpret_cast<const float4*>(vs + kk * DV + 4 * tx + 64 * cc);
        const float xv[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            o[i][4 * cc + e] = fmaf(pv[i], xv[e], o[i][4 * cc + e]);
      }
    }
  }

  // the 16 partial row sums, then the store of rows < Lq, columns < D
  float* ob = out + b * st[9] + h * st[10];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float l = l_run[i];
#pragma unroll
    for (int off = 1; off < 16; off <<= 1)
      l += __shfl_xor_sync(0xffffffffu, l, off);
    const float inv = 1.0f / l;
    const int row = q0 + 4 * ty + i;
    if (row >= Lq) continue;
#pragma unroll
    for (int cc = 0; cc < NCOL / 4; ++cc) {
      const int c = col0 + 4 * tx + 64 * cc;
      if (c < D)
        *reinterpret_cast<float4*>(ob + row * st[11] + c) =
            make_float4(o[i][4 * cc] * inv, o[i][4 * cc + 1] * inv,
                        o[i][4 * cc + 2] * inv, o[i][4 * cc + 3] * inv);
    }
  }
}

template <int D>
cudaError_t launch(const float* q, const float* k, const float* v,
                   float* out, int B, int H, int Lq, int Lk,
                   const long long* st, float scale,
                   cudaStream_t stream) {
  using S = F32Shape<D>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_simt_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      S::SMEM);
  if (attr != cudaSuccess) return attr;
  Strides strides;
  for (int i = 0; i < 12; ++i) strides.v[i] = st[i];
  dim3 grid((Lq + BQ - 1) / BQ, H, B * S::NSLICE);
  flash_simt_kernel<D><<<grid, THREADS, S::SMEM, stream>>>(
      q, k, v, out, H, Lq, Lk, strides, scale * 1.4426950408889634f);
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
// multiples of 4 elements (the wrapper checks); strides[12] = (b, h, l)
// element strides of q, k, v and out. D in {40, 64, 80, 96, 128, 160,
// 256, 384, 512}, Lk >= 1. Returns cudaGetLastError().
extern "C" int flash_attn_f32_launch(const void* q, const void* k,
                                     const void* v, void* out, int B, int H,
                                     int Lq, int Lk, int D,
                                     const long long* strides, float scale,
                                     void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* qf = static_cast<const float*>(q);
  const float* kf = static_cast<const float*>(k);
  const float* vf = static_cast<const float*>(v);
  float* of = static_cast<float*>(out);
  switch (D) {
    case 40:
      return launch<40>(qf, kf, vf, of, B, H, Lq, Lk, strides, scale, s);
    case 64:
      return launch<64>(qf, kf, vf, of, B, H, Lq, Lk, strides, scale, s);
    case 80:
      return launch<80>(qf, kf, vf, of, B, H, Lq, Lk, strides, scale, s);
    case 96:
      return launch<96>(qf, kf, vf, of, B, H, Lq, Lk, strides, scale, s);
    case 128:
      return launch<128>(qf, kf, vf, of, B, H, Lq, Lk, strides, scale, s);
    case 160:
      return launch<160>(qf, kf, vf, of, B, H, Lq, Lk, strides, scale, s);
    case 256:
      return launch<256>(qf, kf, vf, of, B, H, Lq, Lk, strides, scale, s);
    case 384:
      return launch<384>(qf, kf, vf, of, B, H, Lq, Lk, strides, scale, s);
    case 512:
      return launch<512>(qf, kf, vf, of, B, H, Lq, Lk, strides, scale, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
