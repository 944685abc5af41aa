// K8: GEMM rate probes — plain tiled matmuls that measure what the warp-level
// tensor-core path reaches on this card, without quantization epilogues.
//
// Replaces the Pallas probe kernels of tools_i8_microbench.py:
//   make_plain (K8a):  out = bf16( x @ w ),  bf16 x bf16 -> f32  or
//                                            s8 x s8 -> s32, no scales
//   make_w8a8  (K8b):  out = bf16( float(x @ w) * xs[m] * ws[r] ),  s8 x s8
// with x (M, K) row-major and w (K, R) K-major, as the reference feeds them.
//
// What bounds them: tensor-core operations (2·M·K·R). Design: a 256-thread
// block (2 x 4 warps) owns a 128 x BN output tile, BN in {128, 256}, and
// walks K in steps of 64 bytes through a STAGES-deep cp.async ring. bf16:
// ldmatrix (A) and ldmatrix.trans on the K-major w tile (B) feed
// mma.m16n8k16. s8: mma.m16n8k32 wants four consecutive k of one column per
// register but w is K-major, so each step transposes its raw tile 4x4 bytes
// at a time (__byte_perm) into an n-major, XOR-swizzled tile — the inner
// loop of the w8a8 kernel (i8mm.cu) at a templated tile width. The wrapper
// checks M % 128 == 0, K % 64 == 0, R % 256 == 0.
#include "common.cuh"

using namespace gguf_cuda;

namespace {

constexpr int BM = 128;
constexpr int THREADS = 256;

// ---------------------------------------------------------------- bf16 --
constexpr int BK16 = 32;          // bf16 k per step (64 bytes)
constexpr int XS16 = BK16 + 8;    // x tile row stride (elements)

template <int BN, int STAGES>
__global__ void __launch_bounds__(THREADS)
probe_bf16_kernel(const __nv_bfloat16* __restrict__ x,  // (M, K)
                  const __nv_bfloat16* __restrict__ w,  // (K, R)
                  __nv_bfloat16* __restrict__ out,      // (M, R)
                  int M, int K, int R) {
  constexpr int WS = BN + 8;      // w tile row stride (elements)
  constexpr int WN = BN / 4;      // columns per warp
  constexpr int X_EL = BM * XS16;
  constexpr int W_EL = BK16 * WS;
  extern __shared__ __align__(16) __nv_bfloat16 smem16[];
  __nv_bfloat16* x_s = smem16;                   // STAGES x (BM, XS16)
  __nv_bfloat16* w_s = smem16 + STAGES * X_EL;   // STAGES x (BK16, WS)

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int warp_m = warp >> 2;
  const int warp_n = warp & 3;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  const int n_steps = K / BK16;

  auto issue = [&](int step) {
    if (step < n_steps) {
      const int st = step % STAGES;
#pragma unroll
      for (int i = 0; i < BM * 4 / THREADS; ++i) {
        const int v = tid + i * THREADS;
        const int row = v >> 2;
        const int c = (v & 3) * 8;
        cp_async_16(x_s + st * X_EL + row * XS16 + c,
                    x + static_cast<size_t>(m0 + row) * K + step * BK16 + c,
                    16);
      }
#pragma unroll
      for (int i = 0; i < BK16 * (BN / 8) / THREADS; ++i) {
        const int v = tid + i * THREADS;
        const int row = v / (BN / 8);
        const int c = (v % (BN / 8)) * 8;
        cp_async_16(w_s + st * W_EL + row * WS + c,
                    w + static_cast<size_t>(step * BK16 + row) * R + n0 + c,
                    16);
      }
    }
    cp_async_commit();
  };

  float acc[4][WN / 8][4];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < WN / 8; ++b)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[a][b][c] = 0.0f;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) issue(s);

  for (int step = 0; step < n_steps; ++step) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // stage `step` landed; compute(step-1) finished
    issue(step + STAGES - 1);  // into the stage compute(step-1) released
    const __nv_bfloat16* xt = x_s + (step % STAGES) * X_EL;
    const __nv_bfloat16* wt = w_s + (step % STAGES) * W_EL;
#pragma unroll
    for (int kk = 0; kk < BK16 / 16; ++kk) {
      uint32_t af[4][4];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) {
        const int row = warp_m * 64 + mi * 16 + (lane & 15);
        ldmatrix_x4(af[mi], &xt[row * XS16 + kk * 16 + (lane >> 4) * 8]);
      }
#pragma unroll
      for (int nd = 0; nd < WN / 16; ++nd) {
        uint32_t bf[4];
        const int kr = kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
        ldmatrix_x4_trans(
            bf, &wt[kr * WS + warp_n * WN + nd * 16 + (lane >> 4) * 8]);
#pragma unroll
        for (int mi = 0; mi < 4; ++mi) {
          mma_bf16_16816(acc[mi][2 * nd], af[mi], bf[0], bf[1]);
          mma_bf16_16816(acc[mi][2 * nd + 1], af[mi], bf[2], bf[3]);
        }
      }
    }
  }

#pragma unroll
  for (int mi = 0; mi < 4; ++mi) {
    const int m = m0 + warp_m * 64 + mi * 16 + (lane >> 2);
#pragma unroll
    for (int ni = 0; ni < WN / 8; ++ni) {
      const int n = n0 + warp_n * WN + ni * 8 + (lane & 3) * 2;
      const float* a = acc[mi][ni];
      *reinterpret_cast<__nv_bfloat162*>(out + static_cast<size_t>(m) * R +
                                         n) = __floats2bfloat162_rn(a[0],
                                                                    a[1]);
      *reinterpret_cast<__nv_bfloat162*>(
          out + static_cast<size_t>(m + 8) * R + n) =
          __floats2bfloat162_rn(a[2], a[3]);
    }
  }
}

// ------------------------------------------------------------------ s8 --
constexpr int BK8 = 64;           // k bytes per step
constexpr int XS8 = BK8 + 16;     // x tile row stride (bytes)

// 16-byte chunk of row n of the n-major tile that holds logical chunk c
__device__ __forceinline__ int swz(int n, int c) {
  return c ^ (((n >> 1) ^ (n >> 3)) & 3);
}

template <int BN, int STAGES, bool RESCALE>
__global__ void __launch_bounds__(THREADS)
probe_s8_kernel(const int8_t* __restrict__ x,   // (M, K)
                const int8_t* __restrict__ w,   // (K, R)
                const float* __restrict__ xs,   // (M) at stride xs_stride
                const float* __restrict__ ws,   // (R)
                __nv_bfloat16* __restrict__ out,  // (M, R)
                int M, int K, int R, int xs_stride) {
  constexpr int RS = BN + 16;     // raw w tile row stride (bytes)
  constexpr int WN = BN / 4;      // columns per warp
  constexpr int X_BYTES = BM * XS8;
  constexpr int R_BYTES = BK8 * RS;
  extern __shared__ __align__(16) int8_t smem8[];
  int8_t* x_s = smem8;                          // STAGES x (BM, XS8)
  int8_t* r_s = smem8 + STAGES * X_BYTES;       // STAGES x (BK8, RS)
  int8_t* w_s = r_s + STAGES * R_BYTES;         // (BN, BK8) swizzled

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int warp_m = warp >> 2;
  const int warp_n = warp & 3;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  const int n_steps = K / BK8;

  auto issue = [&](int step) {
    if (step < n_steps) {
      const int st = step % STAGES;
#pragma unroll
      for (int i = 0; i < BM * 4 / THREADS; ++i) {
        const int v = tid + i * THREADS;
        const int row = v >> 2;
        const int c = (v & 3) * 16;
        cp_async_16(x_s + st * X_BYTES + row * XS8 + c,
                    x + static_cast<size_t>(m0 + row) * K + step * BK8 + c,
                    16);
      }
#pragma unroll
      for (int i = 0; i < BK8 * (BN / 16) / THREADS; ++i) {
        const int v = tid + i * THREADS;
        const int row = v / (BN / 16);
        const int c = (v % (BN / 16)) * 16;
        cp_async_16(r_s + st * R_BYTES + row * RS + c,
                    w + static_cast<size_t>(step * BK8 + row) * R + n0 + c,
                    16);
      }
    }
    cp_async_commit();
  };

  // raw (k, n) tile -> n-major swizzled tile, 4x4 bytes at a time
  const int nq0 = (warp & 3) * 8 + (lane >> 2);
  const int kq0 = (warp >> 2) * 8 + (lane & 3);
  auto transpose = [&](int st) {
    const int8_t* raw = r_s + st * R_BYTES;
#pragma unroll
    for (int jn = 0; jn < BN / 128; ++jn) {
      const int nq = nq0 + jn * 32;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int kq = kq0 + j * 4;
        uint32_t r[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          r[i] = *reinterpret_cast<const uint32_t*>(raw + (kq * 4 + i) * RS +
                                                    nq * 4);
        }
        const uint32_t t0 = __byte_perm(r[0], r[1], 0x5140);
        const uint32_t t1 = __byte_perm(r[0], r[1], 0x7362);
        const uint32_t t2 = __byte_perm(r[2], r[3], 0x5140);
        const uint32_t t3 = __byte_perm(r[2], r[3], 0x7362);
        const uint32_t col[4] = {__byte_perm(t0, t2, 0x5410),
                                 __byte_perm(t0, t2, 0x7632),
                                 __byte_perm(t1, t3, 0x5410),
                                 __byte_perm(t1, t3, 0x7632)};
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          const int n = nq * 4 + b;
          *reinterpret_cast<uint32_t*>(
              w_s + n * BK8 + swz(n, kq >> 2) * 16 + (kq & 3) * 4) = col[b];
        }
      }
    }
  };

  int acc[4][WN / 8][4];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < WN / 8; ++b)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[a][b][c] = 0;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) issue(s);

  for (int step = 0; step < n_steps; ++step) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // stage `step` landed; compute(step-1) finished
    const int st = step % STAGES;
    transpose(st);
    issue(step + STAGES - 1);  // into the stage compute(step-1) released
    __syncthreads();  // n-major tile complete
    const int8_t* xt = x_s + st * X_BYTES;
#pragma unroll
    for (int ks = 0; ks < BK8 / 32; ++ks) {
      uint32_t af[4][4];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) {
        const int row = warp_m * 64 + mi * 16 + (lane & 15);
        ldmatrix_x4(af[mi], xt + row * XS8 + ks * 32 + (lane >> 4) * 16);
      }
#pragma unroll
      for (int nj = 0; nj < WN / 16; ++nj) {
        uint32_t bf[4];
        const int n = warp_n * WN + nj * 16 + (lane >> 4) * 8 + (lane & 7);
        const int c = ks * 2 + ((lane >> 3) & 1);
        ldmatrix_x4(bf, w_s + n * BK8 + swz(n, c) * 16);
#pragma unroll
        for (int mi = 0; mi < 4; ++mi) {
          mma_s8_16832(acc[mi][2 * nj], af[mi], bf[0], bf[1]);
          mma_s8_16832(acc[mi][2 * nj + 1], af[mi], bf[2], bf[3]);
        }
      }
    }
  }

#pragma unroll
  for (int mi = 0; mi < 4; ++mi) {
    const int m = m0 + warp_m * 64 + mi * 16 + (lane >> 2);
    float xs0 = 1.0f, xs1 = 1.0f;
    if (RESCALE) {
      xs0 = xs[static_cast<size_t>(m) * xs_stride];
      xs1 = xs[static_cast<size_t>(m + 8) * xs_stride];
    }
#pragma unroll
    for (int ni = 0; ni < WN / 8; ++ni) {
      const int n = n0 + warp_n * WN + ni * 8 + (lane & 3) * 2;
      const int* a = acc[mi][ni];
      float v[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) v[j] = __int2float_rn(a[j]);
      if (RESCALE) {
        const float ws0 = ws[n];
        const float ws1 = ws[n + 1];
        v[0] = __fmul_rn(__fmul_rn(v[0], xs0), ws0);
        v[1] = __fmul_rn(__fmul_rn(v[1], xs0), ws1);
        v[2] = __fmul_rn(__fmul_rn(v[2], xs1), ws0);
        v[3] = __fmul_rn(__fmul_rn(v[3], xs1), ws1);
      }
      *reinterpret_cast<__nv_bfloat162*>(out + static_cast<size_t>(m) * R +
                                         n) = __floats2bfloat162_rn(v[0],
                                                                    v[1]);
      *reinterpret_cast<__nv_bfloat162*>(
          out + static_cast<size_t>(m + 8) * R + n) =
          __floats2bfloat162_rn(v[2], v[3]);
    }
  }
}

template <int BN, int STAGES>
cudaError_t launch_bf16(const void* x, const void* w, void* out, int M, int K,
                        int R, cudaStream_t stream) {
  constexpr int smem = STAGES * (BM * XS16 + BK16 * (BN + 8)) * 2;
  static const cudaError_t attr = cudaFuncSetAttribute(
      probe_bf16_kernel<BN, STAGES>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return attr;
  dim3 grid(R / BN, M / BM);
  probe_bf16_kernel<BN, STAGES><<<grid, THREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(x),
      static_cast<const __nv_bfloat16*>(w), static_cast<__nv_bfloat16*>(out),
      M, K, R);
  return cudaGetLastError();
}

template <int BN, int STAGES, bool RESCALE>
cudaError_t launch_s8(const void* x, const void* w, const void* xs,
                      const void* ws, void* out, int M, int K, int R,
                      int xs_stride, cudaStream_t stream) {
  constexpr int smem = STAGES * (BM * XS8 + BK8 * (BN + 16)) + BN * BK8;
  static const cudaError_t attr = cudaFuncSetAttribute(
      probe_s8_kernel<BN, STAGES, RESCALE>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return attr;
  dim3 grid(R / BN, M / BM);
  probe_s8_kernel<BN, STAGES, RESCALE><<<grid, THREADS, smem, stream>>>(
      static_cast<const int8_t*>(x), static_cast<const int8_t*>(w),
      static_cast<const float*>(xs), static_cast<const float*>(ws),
      static_cast<__nv_bfloat16*>(out), M, K, R, xs_stride);
  return cudaGetLastError();
}

}  // namespace

// Plain C entries (bound with ctypes). bn selects the block tile: 128
// (128x128, 4 stages) or 256 (128x256, 3 stages). Shapes are checked by the
// Python wrapper. Each returns cudaGetLastError().
extern "C" int gemm_probe_bf16_launch(const void* x, const void* w, void* out,
                                      int M, int K, int R, int bn,
                                      void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bn == 128) return launch_bf16<128, 4>(x, w, out, M, K, R, s);
  if (bn == 256) return launch_bf16<256, 3>(x, w, out, M, K, R, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// xs == null: raw s8 product cast to bf16 (K8a); else the w8a8 rescale (K8b)
// with xs read at element stride xs_stride.
extern "C" int gemm_probe_s8_launch(const void* x, const void* w,
                                    const void* xs, const void* ws, void* out,
                                    int M, int K, int R, int xs_stride, int bn,
                                    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool rescale = xs != nullptr;
  if (bn == 128) {
    return rescale ? launch_s8<128, 4, true>(x, w, xs, ws, out, M, K, R,
                                             xs_stride, s)
                   : launch_s8<128, 4, false>(x, w, xs, ws, out, M, K, R,
                                              xs_stride, s);
  }
  if (bn == 256) {
    return rescale ? launch_s8<256, 3, true>(x, w, xs, ws, out, M, K, R,
                                             xs_stride, s)
                   : launch_s8<256, 3, false>(x, w, xs, ws, out, M, K, R,
                                              xs_stride, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
