// K4: w8a8 matmul — s8 activations x s8 weights, exact s32 accumulation.
//
// Replaces the Pallas kernel of comfyui_gguf_tpu/ops/i8mm.py
// (_make_i8_kernel, launched by pallas_i8mm and, on a depth-stacked weight,
// by pallas_i8mm_indexed; the stacked case is this kernel launched on block
// i's view).
//
//   acc[m, r] = sum_k xq[m, k] * wq[k, r]              (exact, s32)
//   out[m, r] = epi( float(acc) * xs[m] * ws[r] )
//
// What bounds it: int8 tensor-core operations at the flux token shapes
// (M = 4096..4608, K = 3072..15360). Design: each 256-thread block owns a
// 128x128 output tile and walks K in steps of 64 bytes through a 4-stage
// cp.async pipeline (three steps of x and raw weight tiles in flight while
// one computes). mma.sync m16n8k32 wants four consecutive k of one column
// per register, but the weights are K-major, so each step transposes its
// raw tile 4x4 bytes at a time with __byte_perm into an n-major tile. That
// tile has unpadded 64-byte rows whose 16-byte chunks are XOR-swizzled, so
// both the transposed stores and the ldmatrix reads spread over the
// shared-memory banks. The f32 rescale and the shared epilogue (bias,
// GELU-tanh from a column) run on the accumulator before one bf16 store.
#include "common.cuh"

using namespace gguf_cuda;

namespace {

constexpr int BM = 128;
constexpr int BN = 128;
constexpr int BK = 64;  // k bytes per step
constexpr int STAGES = 4;
constexpr int THREADS = 256;
constexpr int XS = BK + 16;   // x tile row stride (bytes), padded
constexpr int RS = BN + 16;   // raw weight tile row stride (bytes), padded
constexpr int X_BYTES = BM * XS;
constexpr int R_BYTES = BK * RS;
constexpr int SMEM_BYTES = STAGES * (X_BYTES + R_BYTES) + BN * BK;

// 16-byte chunk of row n of the n-major tile that holds logical chunk c
__device__ __forceinline__ int swz(int n, int c) {
  return c ^ (((n >> 1) ^ (n >> 3)) & 3);
}

__global__ void __launch_bounds__(THREADS)
i8mm_kernel(const int8_t* __restrict__ xq,  // (M, K)
            const float* __restrict__ xs,   // (M)
            const int8_t* __restrict__ wq,  // (Kp, Rp)
            const float* __restrict__ ws,   // (Rp)
            const float* __restrict__ bias, // (R) | null
            __nv_bfloat16* __restrict__ out,  // (M, R)
            int M, int K, int Kp, int R, int Rp, int act_from) {
  extern __shared__ __align__(16) int8_t smem[];
  int8_t* x_s = smem;                             // STAGES x (BM, XS)
  int8_t* r_s = smem + STAGES * X_BYTES;          // STAGES x (BK, RS)
  int8_t* w_s = r_s + STAGES * R_BYTES;           // (BN, BK) swizzled

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int warp_m = warp >> 2;  // 2 x 64 rows
  const int warp_n = warp & 3;   // 4 x 32 columns
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  const int n_steps = Kp / BK;

  auto issue = [&](int step) {
    if (step < n_steps) {
      const int st = step % STAGES;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int v = tid + i * THREADS;
        const int row = v >> 2;
        const int c = (v & 3) * 16;
        const int k = step * BK + c;
        const int m = m0 + row;
        const bool ok = m < M && k + 16 <= K;
        cp_async_16(x_s + st * X_BYTES + row * XS + c,
                    ok ? xq + static_cast<size_t>(m) * K + k : xq,
                    ok ? 16 : 0);
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int v = tid + i * THREADS;
        const int row = v >> 3;
        const int c = (v & 7) * 16;
        cp_async_16(r_s + st * R_BYTES + row * RS + c,
                    wq + static_cast<size_t>(step * BK + row) * Rp + n0 + c,
                    16);
      }
    }
    cp_async_commit();
  };

  // raw (k, n) tile -> n-major swizzled tile: each thread transposes two
  // 4x4 byte blocks (k-quads kq0+j*4, n-quad nq)
  const int nq = (warp & 3) * 8 + (lane >> 2);
  const int kq0 = (warp >> 2) * 8 + (lane & 3);
  auto transpose = [&](int st) {
    const int8_t* raw = r_s + st * R_BYTES;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int kq = kq0 + j * 4;
      uint32_t w[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        w[i] = *reinterpret_cast<const uint32_t*>(
            raw + (kq * 4 + i) * RS + nq * 4);
      }
      const uint32_t t0 = __byte_perm(w[0], w[1], 0x5140);
      const uint32_t t1 = __byte_perm(w[0], w[1], 0x7362);
      const uint32_t t2 = __byte_perm(w[2], w[3], 0x5140);
      const uint32_t t3 = __byte_perm(w[2], w[3], 0x7362);
      const uint32_t col[4] = {__byte_perm(t0, t2, 0x5410),
                               __byte_perm(t0, t2, 0x7632),
                               __byte_perm(t1, t3, 0x5410),
                               __byte_perm(t1, t3, 0x7632)};
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const int n = nq * 4 + b;
        // k bytes kq*4..+3 = word (kq & 3) of logical chunk kq >> 2
        *reinterpret_cast<uint32_t*>(
            w_s + n * BK + swz(n, kq >> 2) * 16 + (kq & 3) * 4) = col[b];
      }
    }
  };

  int acc[4][4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b)
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
    for (int ks = 0; ks < BK / 32; ++ks) {
      uint32_t af[4][4];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) {
        const int row = warp_m * 64 + mi * 16 + (lane & 15);
        ldmatrix_x4(af[mi], xt + row * XS + ks * 32 + (lane >> 4) * 16);
      }
#pragma unroll
      for (int nj = 0; nj < 2; ++nj) {
        uint32_t bf[4];
        const int n = warp_n * 32 + nj * 16 + (lane >> 4) * 8 + (lane & 7);
        const int c = ks * 2 + ((lane >> 3) & 1);
        ldmatrix_x4(bf, w_s + n * BK + swz(n, c) * 16);
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
    const float xs0 = m < M ? xs[m] : 0.0f;
    const float xs1 = m + 8 < M ? xs[m + 8] : 0.0f;
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      const int n = n0 + warp_n * 32 + ni * 8 + (lane & 3) * 2;
      const float ws0 = ws[n];
      const float ws1 = ws[n + 1];
      const int* a = acc[mi][ni];
      // (acc * xs) * ws, rounded at each step as the plain version does
      auto rs = [](int v, float s, float w) {
        return __fmul_rn(__fmul_rn(__int2float_rn(v), s), w);
      };
      epilogue_store2(out, bias, act_from, M, R, m, n, rs(a[0], xs0, ws0),
                      rs(a[1], xs0, ws1));
      epilogue_store2(out, bias, act_from, M, R, m + 8, n,
                      rs(a[2], xs1, ws0), rs(a[3], xs1, ws1));
    }
  }
}

}  // namespace

// Plain C entry (bound with ctypes). Shapes are checked by the Python
// wrapper: Kp % 64 == 0, Rp % 128 == 0, R <= Rp, K <= Kp, K % 16 == 0, all
// pointers 16-byte aligned. Returns cudaGetLastError().
extern "C" int i8mm_launch(const void* xq, const void* xs, const void* wq,
                           const void* ws, const void* bias, void* out, int M,
                           int K, int Kp, int R, int Rp, int act_from,
                           void* stream) {
  static const cudaError_t attr = cudaFuncSetAttribute(
      i8mm_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  dim3 grid((R + BN - 1) / BN, (M + BM - 1) / BM);
  i8mm_kernel<<<grid, THREADS, SMEM_BYTES,
                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(xq), static_cast<const float*>(xs),
      static_cast<const int8_t*>(wq), static_cast<const float*>(ws),
      static_cast<const float*>(bias), static_cast<__nv_bfloat16*>(out), M, K,
      Kp, R, Rp, act_from);
  return static_cast<int>(cudaGetLastError());
}
