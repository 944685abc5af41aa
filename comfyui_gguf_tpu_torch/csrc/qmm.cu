// K1/K2: fused dequantize + matmul over planar quantized weights.
//
// Replaces the Pallas kernels of comfyui_gguf_tpu/ops/qmatmul.py
// (_make_nib4_kernel and _make_int8_kernel, launched by pallas_qmm and, on a
// depth-stacked weight, by pallas_qmm_indexed). On the card the stacked case
// needs no kernel of its own: the wrapper passes the pointer of block i's
// view of the stacked tensors.
//
//   out[m, r] = epi( sum_k x[m, k] * W[k, r] ),
//   W[k, r]   = s[k/gs, r] * (q[k, r] - zp) + o[k/gs, r]
//
// Layout (the reference package's planar layout, kept as is): codes are
// K-major. nib4: byte row j holds k=j in its low nibble and k=j+Kp/2 in its
// high nibble. int8: one zero-point-folded code per element.
//
// What bounds it: at the w8a8 path's M=1 modulation projections, bytes (the
// packed weight is read once, ~5.6 bits per weight with f32 scales); on
// the bf16-fused path at M=4096, bf16 tensor-core operations. Design: each
// 256-thread block owns a 128x128 output tile and walks K in steps of 64
// logical rows through a 3-stage cp.async pipeline: per step the x tile,
// the raw code tile and the scale/offset rows it needs arrive in shared
// memory while earlier steps compute. The step's codes are then unpacked
// and scaled into a bf16 weight tile in shared memory (the dense weight
// never reaches global memory) and feed mma.sync m16n8k16 with an f32
// accumulator. Every code byte is read once per 128-row M-tile (a nib4 byte
// feeds both of its k rows), so at M <= 128 the weight streams exactly
// once.
#include "common.cuh"

using namespace gguf_cuda;

namespace {

constexpr int BM = 128;
constexpr int BN = 128;
constexpr int BK = 64;  // logical k rows per step
constexpr int STAGES = 3;
constexpr int THREADS = 256;
constexpr int XS = BK + 8;   // smem row stride (bf16) of the x tile
constexpr int WS = BN + 8;   // smem row stride (bf16) of the weight tile
constexpr int RS = BN + 16;  // smem row stride (bytes) of the raw codes
constexpr int X_BYTES = BM * XS * 2;
constexpr int Q_BYTES = BK * RS;            // up to 64 code rows
constexpr int S_BYTES = 4 * BN * 4;         // up to 4 scale rows, f32
constexpr int STAGE_BYTES = X_BYTES + Q_BYTES + 2 * S_BYTES;
constexpr int SMEM_BYTES = STAGES * STAGE_BYTES + BK * WS * 2;

template <bool NIB4, bool HAS_OFF>
__global__ void __launch_bounds__(THREADS)
qmm_kernel(const __nv_bfloat16* __restrict__ x,  // (M, K)
           const uint8_t* __restrict__ qs,       // (Kp/2 or Kp, Rp)
           const float* __restrict__ scales,     // (Kp/gs, Rp)
           const float* __restrict__ offsets,    // (Kp/gs, Rp) | null
           const float* __restrict__ bias,       // (R) | null
           __nv_bfloat16* __restrict__ out,      // (M, R)
           int M, int K, int Kp, int R, int Rp, int gs, float zp,
           int act_from) {
  // code rows per step, and rows of codes each thread unpacks (4 columns)
  constexpr int QROWS = NIB4 ? BK / 2 : BK;
  constexpr int CR = QROWS / 8;
  extern __shared__ __align__(16) uint8_t smem[];
  __nv_bfloat16* ws_s =
      reinterpret_cast<__nv_bfloat16*>(smem + STAGES * STAGE_BYTES);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int warp_m = warp >> 2;  // 2 x 64 rows
  const int warp_n = warp & 3;   // 4 x 32 columns
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  const int half = Kp / 2;
  const int n_steps = Kp / BK;
  // scale rows per step: nib4 holds QROWS/gs for the low nibbles, then as
  // many for the high nibbles; int8 holds QROWS/gs
  const int g_per = QROWS / gs;
  const int n_grp = NIB4 ? 2 * g_per : g_per;

  auto xs_of = [&](int st) {
    return reinterpret_cast<__nv_bfloat16*>(smem + st * STAGE_BYTES);
  };
  auto qs_of = [&](int st) { return smem + st * STAGE_BYTES + X_BYTES; };
  auto sc_of = [&](int st, int plane) {
    return reinterpret_cast<float*>(smem + st * STAGE_BYTES + X_BYTES +
                                    Q_BYTES + plane * S_BYTES);
  };

  auto issue = [&](int step) {
    if (step < n_steps) {
      const int st = step % STAGES;
      const int j0 = step * QROWS;  // first code row of the step
      __nv_bfloat16* xd = xs_of(st);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int v = tid + i * THREADS;
        const int row = v >> 3;
        const int c = (v & 7) * 8;
        int k;
        if constexpr (NIB4) {
          k = c < BK / 2 ? j0 + c : half + j0 + (c - BK / 2);
        } else {
          k = j0 + c;
        }
        const int m = m0 + row;
        const bool ok = m < M && k + 8 <= K;
        cp_async_16(xd + row * XS + c,
                    ok ? x + static_cast<size_t>(m) * K + k : x,
                    ok ? 16 : 0);
      }
      uint8_t* qd = qs_of(st);
#pragma unroll
      for (int i = 0; i < QROWS * 8 / THREADS; ++i) {
        const int v = tid + i * THREADS;
        const int row = v >> 3;
        const int c = (v & 7) * 16;
        cp_async_16(qd + row * RS + c,
                    qs + static_cast<size_t>(j0 + row) * Rp + n0 + c, 16);
      }
      if (tid < n_grp * 32) {
        const int r = tid >> 5;
        const int c = (tid & 31) * 4;
        const int g = (NIB4 && r >= g_per) ? (half + j0) / gs + r - g_per
                                           : j0 / gs + r;
        cp_async_16(sc_of(st, 0) + r * BN + c,
                    scales + static_cast<size_t>(g) * Rp + n0 + c, 16);
        if constexpr (HAS_OFF) {
          cp_async_16(sc_of(st, 1) + r * BN + c,
                      offsets + static_cast<size_t>(g) * Rp + n0 + c, 16);
        }
      }
    }
    cp_async_commit();
  };

  // unpack: thread (cg, rg) owns columns cg*4..+3 of code rows rg*CR..+CR-1
  const int cg = tid & 31;
  const int rg = tid >> 5;
  auto dequant = [&](int st) {
    const uint8_t* qd = qs_of(st);
    const int lg = (rg * CR) / gs;  // local scale row (low nibble / int8)
    const float4 s_lo = *reinterpret_cast<const float4*>(
        sc_of(st, 0) + lg * BN + cg * 4);
    float4 o_lo = make_float4(0.f, 0.f, 0.f, 0.f);
    float4 s_hi = s_lo, o_hi = o_lo;
    if constexpr (HAS_OFF) {
      o_lo = *reinterpret_cast<const float4*>(sc_of(st, 1) + lg * BN +
                                              cg * 4);
    }
    if constexpr (NIB4) {
      s_hi = *reinterpret_cast<const float4*>(sc_of(st, 0) +
                                              (g_per + lg) * BN + cg * 4);
      if constexpr (HAS_OFF) {
        o_hi = *reinterpret_cast<const float4*>(
            sc_of(st, 1) + (g_per + lg) * BN + cg * 4);
      }
    }
    const float slo[4] = {s_lo.x, s_lo.y, s_lo.z, s_lo.w};
    const float olo[4] = {o_lo.x, o_lo.y, o_lo.z, o_lo.w};
    const float shi[4] = {s_hi.x, s_hi.y, s_hi.z, s_hi.w};
    const float ohi[4] = {o_hi.x, o_hi.y, o_hi.z, o_hi.w};
#pragma unroll
    for (int i = 0; i < CR; ++i) {
      const int r = rg * CR + i;
      const uint32_t word =
          *reinterpret_cast<const uint32_t*>(qd + r * RS + cg * 4);
      float lo[4], hi[4];
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const uint32_t byte = (word >> (8 * b)) & 0xFFu;
        if constexpr (NIB4) {
          lo[b] = slo[b] * (static_cast<float>(byte & 0xFu) - zp);
          hi[b] = shi[b] * (static_cast<float>(byte >> 4) - zp);
          if constexpr (HAS_OFF) {
            lo[b] += olo[b];
            hi[b] += ohi[b];
          }
        } else {
          lo[b] = slo[b] * static_cast<float>(static_cast<int8_t>(byte));
          if constexpr (HAS_OFF) lo[b] += olo[b];
        }
      }
      __nv_bfloat162 p0 = __floats2bfloat162_rn(lo[0], lo[1]);
      __nv_bfloat162 p1 = __floats2bfloat162_rn(lo[2], lo[3]);
      uint2 u;
      u.x = *reinterpret_cast<uint32_t*>(&p0);
      u.y = *reinterpret_cast<uint32_t*>(&p1);
      *reinterpret_cast<uint2*>(&ws_s[r * WS + cg * 4]) = u;
      if constexpr (NIB4) {
        p0 = __floats2bfloat162_rn(hi[0], hi[1]);
        p1 = __floats2bfloat162_rn(hi[2], hi[3]);
        u.x = *reinterpret_cast<uint32_t*>(&p0);
        u.y = *reinterpret_cast<uint32_t*>(&p1);
        *reinterpret_cast<uint2*>(&ws_s[(BK / 2 + r) * WS + cg * 4]) = u;
      }
    }
  };

  float acc[4][4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[a][b][c] = 0.0f;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) issue(s);

  for (int step = 0; step < n_steps; ++step) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // stage `step` landed; compute(step-1) finished
    const int st = step % STAGES;
    dequant(st);
    issue(step + STAGES - 1);  // into the stage compute(step-1) released
    __syncthreads();  // weight tile complete
    const __nv_bfloat16* xt = xs_of(st);
#pragma unroll
    for (int ks = 0; ks < BK / 16; ++ks) {
      uint32_t af[4][4];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) {
        const int row = warp_m * 64 + mi * 16 + (lane & 15);
        ldmatrix_x4(af[mi], &xt[row * XS + ks * 16 + (lane >> 4) * 8]);
      }
#pragma unroll
      for (int nj = 0; nj < 2; ++nj) {
        uint32_t bf[4];
        const int krow = ks * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
        const int col = warp_n * 32 + nj * 16 + (lane >> 4) * 8;
        ldmatrix_x4_trans(bf, &ws_s[krow * WS + col]);
#pragma unroll
        for (int mi = 0; mi < 4; ++mi) {
          mma_bf16_16816(acc[mi][2 * nj], af[mi], bf[0], bf[1]);
          mma_bf16_16816(acc[mi][2 * nj + 1], af[mi], bf[2], bf[3]);
        }
      }
    }
  }

#pragma unroll
  for (int mi = 0; mi < 4; ++mi) {
    const int m = m0 + warp_m * 64 + mi * 16 + (lane >> 2);
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      const int n = n0 + warp_n * 32 + ni * 8 + (lane & 3) * 2;
      epilogue_store2(out, bias, act_from, M, R, m, n, acc[mi][ni][0],
                      acc[mi][ni][1]);
      epilogue_store2(out, bias, act_from, M, R, m + 8, n, acc[mi][ni][2],
                      acc[mi][ni][3]);
    }
  }
}

template <bool NIB4, bool HAS_OFF>
cudaError_t launch(const void* x, const void* qs, const void* scales,
                   const void* offsets, const void* bias, void* out, int M,
                   int K, int Kp, int R, int Rp, int gs, int zp, int act_from,
                   cudaStream_t stream) {
  static const cudaError_t attr = cudaFuncSetAttribute(
      qmm_kernel<NIB4, HAS_OFF>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      SMEM_BYTES);
  if (attr != cudaSuccess) return attr;
  dim3 grid((R + BN - 1) / BN, (M + BM - 1) / BM);
  qmm_kernel<NIB4, HAS_OFF><<<grid, THREADS, SMEM_BYTES, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const uint8_t*>(qs),
      static_cast<const float*>(scales), static_cast<const float*>(offsets),
      static_cast<const float*>(bias), static_cast<__nv_bfloat16*>(out), M, K,
      Kp, R, Rp, gs, static_cast<float>(zp), act_from);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry (bound with ctypes). Shapes are checked by the Python
// wrapper: Kp % 512 == 0, Rp % 128 == 0, R <= Rp, K <= Kp, K % 8 == 0,
// gs in {16, 32}, all pointers 16-byte aligned. Returns cudaGetLastError().
extern "C" int qmm_launch(const void* x, const void* qs, const void* scales,
                          const void* offsets, const void* bias, void* out,
                          int M, int K, int Kp, int R, int Rp, int gs, int zp,
                          int nib4, int act_from, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (nib4) {
    return offsets ? launch<true, true>(x, qs, scales, offsets, bias, out, M,
                                        K, Kp, R, Rp, gs, zp, act_from, s)
                   : launch<true, false>(x, qs, scales, offsets, bias, out,
                                         M, K, Kp, R, Rp, gs, zp, act_from,
                                         s);
  }
  return offsets ? launch<false, true>(x, qs, scales, offsets, bias, out, M,
                                       K, Kp, R, Rp, gs, zp, act_from, s)
                 : launch<false, false>(x, qs, scales, offsets, bias, out, M,
                                        K, Kp, R, Rp, gs, zp, act_from, s);
}
