// K6 prep: the int8 quantization of q, k and v for the int8 flash attention
// (i8attn.cu), in two launches.
//
// Replaces the XLA ops of comfyui_gguf_tpu/ops/i8attn.py
// quantize_attn_inputs (its plain version: ops/i8attn.py
// kernel_operands(quantize_attn_inputs(...)), about a dozen torch ops that
// read and write the (B, H, L, D) tensors many times over):
//
//   k̄[d]  = mean_j k[j, d]                         (f32; softmax-invariant)
//   qq[i] = rint(q[i] / (amax_d |q[i]| / 127)),  qs[i] = amax·(scale/127)
//   kq[j] = the same on k[j] - k̄,                ks[j] = amax/127
//   "pv": vs[d] = amax_j |v[j, d]| / 127,  vq[j, d] = rint(v[j, d] / vs[d]),
//         written transposed and key-permuted: Vᵀ (BH, D, Lkp) as i8attn.cu
//         reads it
//
// with the reference's true division, its f32 reciprocal constants and
// round-half-even (ops/i8attn.py _INV127), so q's and v's codes and every
// scale but ks equal the plain version's bit for bit (amax is exact in any
// order); k's codes and ks can differ where the f32 mean's summation order
// differs from torch's.
//
// What bounds it: bytes. q, k and v are read as strided (B, L, 3, H, D)
// views without a gather, k and v twice (once for the per-channel
// reduction), and the three s8 tensors written once. Pass 1 (grid: key
// chunks x BH) sums k and takes |v|'s maximum per (bh, chunk, d) in a fixed
// order into a small scratch. Pass 2 (grid: 64-token tiles x BH) first
// folds the chunks in a fixed order (no float atomics: two launches give
// the same bits), then quantizes a row per warp, 16 bytes a lane, and for v
// stages the tile's codes in shared memory so that the transposed,
// permuted Vᵀ rows leave as coalesced stores. Rows past Lk up to Lkp (the
// key tile of i8attn.cu) get zero codes and zero scales.
//
// Head dims past 256 take a third launch and a wide pass 2 whose shared
// memory does not grow with D: pass 1 runs over 128-column chunks (grid z),
// a fold launch reduces the key chunks in the same fixed order once, and
// pass 2 reads each q or k row twice from the cache (its abs-max, then its
// codes) and stages v 128 columns at a time.
#include "common.cuh"

using namespace gguf_cuda;

namespace {

constexpr int THREADS = 256;
constexpr int ROWS = 64;                  // token rows of a pass-2 tile
constexpr float INV127 = 1.0f / 127.0f;   // f32(1/127), as the reference
constexpr float FLOOR = 1e-20f;

struct PrepArgs {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  long long sq[3], sk[3], sv[3];  // (b, h, l) element strides
  int H, Lq, Lk, Lkp, D, n_chunks, chunk_rows;
  float qscale;  // f32(f32(1/127) · scale)
  int8_t* qq;    // (BH, Lq, D)
  float* qs;     // (BH, Lq)
  int8_t* kq;    // (BH, Lk, D)
  float* ks;     // (BH, Lkp)
  int8_t* vt;    // (BH, D, Lkp), "pv"
  float* vs;     // (BH, D)
  float* part;   // (BH, n_chunks, 2, D): k sums, |v| maxima
};

__device__ __forceinline__ void bf16x8(const __nv_bfloat16* p, float* f) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xFFFF0000u);
  }
}

__device__ __forceinline__ void bf16x4(const __nv_bfloat16* p, float* f) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  f[0] = __uint_as_float(u.x << 16);
  f[1] = __uint_as_float(u.x & 0xFFFF0000u);
  f[2] = __uint_as_float(u.y << 16);
  f[3] = __uint_as_float(u.y & 0xFFFF0000u);
}

template <int E>
__device__ __forceinline__ void load_row(const __nv_bfloat16* p, float* f) {
  if constexpr (E == 8) {
    bf16x8(p, f);
  } else {
    bf16x4(p, f);
  }
}

// E codes (one per byte, lowest d first) to one store of E bytes
template <int E>
__device__ __forceinline__ void store_codes(int8_t* dst, const int* c) {
  uint32_t w[E / 4];
#pragma unroll
  for (int i = 0; i < E / 4; ++i)
    w[i] = (c[4 * i] & 0xFF) | ((c[4 * i + 1] & 0xFF) << 8) |
           ((c[4 * i + 2] & 0xFF) << 16) | ((c[4 * i + 3] & 0xFF) << 24);
  if constexpr (E == 8) {
    *reinterpret_cast<uint2*>(dst) = make_uint2(w[0], w[1]);
  } else {
    *reinterpret_cast<uint32_t*>(dst) = w[0];
  }
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

// Pass 1: per (bh, chunk, d), the sum of k and the maximum of |v| over the
// chunk's rows, each thread over rows rg, rg + RPI, ... in order, then the
// RPI row groups in order. D columns a block: all of a row, or the
// blockIdx.z-th 128 of a wider one.
template <int D, bool PV8>
__global__ void __launch_bounds__(THREADS)
prep_reduce_kernel(const PrepArgs a) {
  constexpr int TPR = D / 8;         // threads a row, 8 values each
  constexpr int RPI = THREADS / TPR; // rows an iteration
  __shared__ float red[2][RPI][D];
  const int bh = blockIdx.y;
  const int b = bh / a.H;
  const int h = bh - b * a.H;
  const int c0 = blockIdx.z * D;
  const int rg = threadIdx.x / TPR;
  const int d0 = (threadIdx.x % TPR) * 8;
  const int r0 = blockIdx.x * a.chunk_rows;
  const int r1 = min(a.Lk, r0 + a.chunk_rows);
  const __nv_bfloat16* kp = a.k + b * a.sk[0] + h * a.sk[1] + c0 + d0;
  const __nv_bfloat16* vp = a.v + b * a.sv[0] + h * a.sv[1] + c0 + d0;
  float sum[8], mx[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) sum[e] = mx[e] = 0.0f;
#pragma unroll 4
  for (int r = r0 + rg; r < r1; r += RPI) {
    float f[8];
    bf16x8(kp + r * a.sk[2], f);
#pragma unroll
    for (int e = 0; e < 8; ++e) sum[e] += f[e];
    if constexpr (PV8) {
      bf16x8(vp + r * a.sv[2], f);
#pragma unroll
      for (int e = 0; e < 8; ++e) mx[e] = fmaxf(mx[e], fabsf(f[e]));
    }
  }
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    red[0][rg][d0 + e] = sum[e];
    red[1][rg][d0 + e] = mx[e];
  }
  __syncthreads();
  const int d = threadIdx.x;
  if (d < D) {
    float s = 0.0f, m = 0.0f;
    for (int i = 0; i < RPI; ++i) {
      s += red[0][i][d];
      m = fmaxf(m, red[1][i][d]);
    }
    float* out = a.part + (static_cast<size_t>(bh) * a.n_chunks + blockIdx.x)
                              * 2 * a.D + c0;
    out[d] = s;
    out[a.D + d] = m;
  }
}

// The key chunks of pass 1 folded in order, as pass 2 of D <= 256 folds them
// itself: k's mean and v's scale of column d go to chunk 0's slots of the
// scratch (only this thread reads or writes column d), and vs is written.
template <bool PV8>
__global__ void __launch_bounds__(128) prep_fold_kernel(const PrepArgs a) {
  const int bh = blockIdx.y;
  const int d = blockIdx.x * 128 + threadIdx.x;
  float* pp = a.part + static_cast<size_t>(bh) * a.n_chunks * 2 * a.D;
  float s = 0.0f, m = 0.0f;
  for (int c = 0; c < a.n_chunks; ++c) {
    s += pp[c * 2 * a.D + d];
    m = fmaxf(m, pp[c * 2 * a.D + a.D + d]);
  }
  const float vsc = __fmul_rn(fmaxf(m, FLOOR), INV127);
  pp[d] = __fdiv_rn(s, static_cast<float>(a.Lk));
  pp[a.D + d] = vsc;
  a.vs[static_cast<size_t>(bh) * a.D + d] = PV8 ? vsc : 1.0f;
}

// Vᵀ rows d0 .. d0 + DC - 1 of one ROWS-key tile from its codes in shared
// memory (rows VST = DC + 4 bytes apart): word u (key positions 4u .. 4u+3)
// of a d row holds keys 16(u/4) + {2t, 2t+1, 8+2t, 9+2t}, t = u % 4
// (i8attn.cu's order). vrow points at row d0, key t0.
template <int DC>
__device__ __forceinline__ void store_vt(const int8_t* vcode, int8_t* vrow,
                                         int Lkp) {
  constexpr int VST = DC + 4;
  for (int idx = threadIdx.x; idx < DC * (ROWS / 4); idx += THREADS) {
    const int d = idx / (ROWS / 4);
    const int u = idx % (ROWS / 4);
    const int key = 16 * (u >> 2) + 2 * (u & 3);
    const uint8_t* col = reinterpret_cast<const uint8_t*>(vcode) + d;
    const uint32_t word = col[key * VST] | (col[(key + 1) * VST] << 8) |
                          (col[(key + 8) * VST] << 16) |
                          (col[(key + 9) * VST] << 24);
    *reinterpret_cast<uint32_t*>(vrow + static_cast<size_t>(d) * Lkp +
                                 4 * u) = word;
  }
}

// Pass 2: a tile of ROWS token rows of one bh; warp w quantizes rows
// t0 + w + 8i of q, k and (into shared memory) v.
template <int D, bool PV8>
__global__ void __launch_bounds__(THREADS)
prep_quant_kernel(const PrepArgs a) {
  constexpr int E = D / 32;         // values a lane of a row
  constexpr int RPW = ROWS / 8;     // rows a warp
  constexpr int VST = D + 4;        // row stride (bytes) of the v codes
  __shared__ float mean_s[D];
  __shared__ float vsc_s[D];
  __shared__ __align__(16) int8_t vcode[PV8 ? ROWS * VST : 4];
  const int bh = blockIdx.y;
  const int b = bh / a.H;
  const int h = bh - b * a.H;
  const int t0 = blockIdx.x * ROWS;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int dl = lane * E;  // this lane's first d

  // the chunks of pass 1, folded in order (every block gets the same bits)
  if (threadIdx.x < D) {
    const int d = threadIdx.x;
    const float* pp = a.part + static_cast<size_t>(bh) * a.n_chunks * 2 * D;
    float s = 0.0f, m = 0.0f;
    for (int c = 0; c < a.n_chunks; ++c) {
      s += pp[c * 2 * D + d];
      m = fmaxf(m, pp[c * 2 * D + D + d]);
    }
    mean_s[d] = __fdiv_rn(s, static_cast<float>(a.Lk));
    const float vsc = __fmul_rn(fmaxf(m, FLOOR), INV127);
    vsc_s[d] = vsc;
    if (blockIdx.x == 0) a.vs[static_cast<size_t>(bh) * D + d] =
        PV8 ? vsc : 1.0f;
  }
  __syncthreads();

  // one row: clamped abs-max over the warp, codes rint(x / (amax/127))
  auto quant = [&](float (&f)[E], int (&c)[E]) {
    float m = 0.0f;
#pragma unroll
    for (int e = 0; e < E; ++e) m = fmaxf(m, fabsf(f[e]));
    const float amax = fmaxf(warp_max(m), FLOOR);
    const float xs = __fmul_rn(amax, INV127);
#pragma unroll
    for (int e = 0; e < E; ++e) c[e] = __float2int_rn(__fdiv_rn(f[e], xs));
    return amax;
  };

  if (t0 < a.Lq) {
    const __nv_bfloat16* qp = a.q + b * a.sq[0] + h * a.sq[1] + dl;
    float f[RPW][E];
#pragma unroll
    for (int i = 0; i < RPW; ++i) {
      const int r = t0 + warp + 8 * i;
      if (r < a.Lq) load_row<E>(qp + r * a.sq[2], f[i]);
    }
#pragma unroll
    for (int i = 0; i < RPW; ++i) {
      const int r = t0 + warp + 8 * i;
      if (r >= a.Lq) break;
      int c[E];
      const float amax = quant(f[i], c);
      const size_t row = static_cast<size_t>(bh) * a.Lq + r;
      store_codes<E>(a.qq + row * D + dl, c);
      if (lane == 0) a.qs[row] = __fmul_rn(amax, a.qscale);
    }
  }
  if (t0 >= a.Lkp) return;
  {
    const __nv_bfloat16* kp = a.k + b * a.sk[0] + h * a.sk[1] + dl;
    float f[RPW][E];
#pragma unroll
    for (int i = 0; i < RPW; ++i) {
      const int r = t0 + warp + 8 * i;
      if (r < a.Lk) load_row<E>(kp + r * a.sk[2], f[i]);
    }
#pragma unroll
    for (int i = 0; i < RPW; ++i) {
      const int r = t0 + warp + 8 * i;
      const size_t row = static_cast<size_t>(bh) * a.Lk + r;
      if (r >= a.Lk) {
        if (lane == 0) a.ks[static_cast<size_t>(bh) * a.Lkp + r] = 0.0f;
        continue;
      }
#pragma unroll
      for (int e = 0; e < E; ++e) f[i][e] = __fsub_rn(f[i][e], mean_s[dl + e]);
      int c[E];
      const float amax = quant(f[i], c);
      store_codes<E>(a.kq + row * D + dl, c);
      if (lane == 0)
        a.ks[static_cast<size_t>(bh) * a.Lkp + r] = __fmul_rn(amax, INV127);
    }
  }
  if constexpr (PV8) {
    const __nv_bfloat16* vp = a.v + b * a.sv[0] + h * a.sv[1] + dl;
    float f[RPW][E];
#pragma unroll
    for (int i = 0; i < RPW; ++i) {
      const int r = t0 + warp + 8 * i;
      if (r < a.Lk) load_row<E>(vp + r * a.sv[2], f[i]);
    }
#pragma unroll
    for (int i = 0; i < RPW; ++i) {
      const int rl = warp + 8 * i;
      int c[E];
#pragma unroll
      for (int e = 0; e < E; ++e)
        c[e] = t0 + rl < a.Lk
                   ? __float2int_rn(__fdiv_rn(f[i][e], vsc_s[dl + e]))
                   : 0;
      // 4 bytes at a time: the rows lie VST = D + 4 bytes apart
#pragma unroll
      for (int e = 0; e < E; e += 4)
        store_codes<4>(vcode + rl * VST + dl + e, c + e);
    }
    __syncthreads();
    store_vt<D>(vcode, a.vt + static_cast<size_t>(bh) * D * a.Lkp + t0,
                a.Lkp);
  }
}

// Pass 2 at a head dim past 256 (a.D, a multiple of 128): pass 2's work
// with a lane holding 4 values of each 128-column chunk of a row. A q or k
// row is read twice (its clamped abs-max, then its codes); v's codes go
// through shared memory 128 columns at a time. k's mean and v's scales are
// the fold's (chunk 0's slots of the scratch).
template <bool PV8>
__global__ void __launch_bounds__(THREADS)
prep_quant_wide_kernel(const PrepArgs a) {
  constexpr int RPW = ROWS / 8;  // rows a warp
  constexpr int VST = 128 + 4;   // row stride (bytes) of the v codes
  __shared__ __align__(16) int8_t vcode[PV8 ? ROWS * VST : 4];
  const int D = a.D;
  const int bh = blockIdx.y;
  const int b = bh / a.H;
  const int h = bh - b * a.H;
  const int t0 = blockIdx.x * ROWS;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int dl = lane * 4;
  const float* mean = a.part + static_cast<size_t>(bh) * a.n_chunks * 2 * D;
  const float* vsc = mean + D;

  // codes rint((x - sub) / (amax / 127)) of a row, amax its clamped
  // abs-max; returns amax
  auto quant_row = [&](const __nv_bfloat16* src, const float* sub,
                       int8_t* dst) {
    float m = 0.0f;
    for (int c = dl; c < D; c += 128) {
      float f[4];
      bf16x4(src + c, f);
#pragma unroll
      for (int e = 0; e < 4; ++e)
        m = fmaxf(m, fabsf(sub ? __fsub_rn(f[e], sub[c + e]) : f[e]));
    }
    const float amax = fmaxf(warp_max(m), FLOOR);
    const float xs = __fmul_rn(amax, INV127);
    for (int c = dl; c < D; c += 128) {
      float f[4];
      int q[4];
      bf16x4(src + c, f);
#pragma unroll
      for (int e = 0; e < 4; ++e)
        q[e] = __float2int_rn(
            __fdiv_rn(sub ? __fsub_rn(f[e], sub[c + e]) : f[e], xs));
      store_codes<4>(dst + c, q);
    }
    return amax;
  };

  for (int i = 0; i < RPW; ++i) {
    const int r = t0 + warp + 8 * i;
    if (r >= a.Lq) break;
    const size_t row = static_cast<size_t>(bh) * a.Lq + r;
    const float amax = quant_row(
        a.q + b * a.sq[0] + h * a.sq[1] + r * a.sq[2], nullptr,
        a.qq + row * D);
    if (lane == 0) a.qs[row] = __fmul_rn(amax, a.qscale);
  }
  if (t0 >= a.Lkp) return;
  for (int i = 0; i < RPW; ++i) {
    const int r = t0 + warp + 8 * i;
    if (r >= a.Lk) {
      if (lane == 0) a.ks[static_cast<size_t>(bh) * a.Lkp + r] = 0.0f;
      continue;
    }
    const float amax = quant_row(
        a.k + b * a.sk[0] + h * a.sk[1] + r * a.sk[2], mean,
        a.kq + (static_cast<size_t>(bh) * a.Lk + r) * D);
    if (lane == 0)
      a.ks[static_cast<size_t>(bh) * a.Lkp + r] = __fmul_rn(amax, INV127);
  }
  if constexpr (PV8) {
    const __nv_bfloat16* vp = a.v + b * a.sv[0] + h * a.sv[1] + dl;
    for (int c0 = 0; c0 < D; c0 += 128) {
#pragma unroll
      for (int i = 0; i < RPW; ++i) {
        const int rl = warp + 8 * i;
        int q[4] = {0, 0, 0, 0};
        if (t0 + rl < a.Lk) {
          float f[4];
          bf16x4(vp + (t0 + rl) * a.sv[2] + c0, f);
#pragma unroll
          for (int e = 0; e < 4; ++e)
            q[e] = __float2int_rn(__fdiv_rn(f[e], vsc[c0 + dl + e]));
        }
        store_codes<4>(vcode + rl * VST + dl, q);
      }
      __syncthreads();
      store_vt<128>(vcode,
                    a.vt + (static_cast<size_t>(bh) * D + c0) * a.Lkp + t0,
                    a.Lkp);
      __syncthreads();
    }
  }
}

template <int D, bool PV8>
cudaError_t launch(const PrepArgs& a, int BH, cudaStream_t stream) {
  prep_reduce_kernel<D, PV8><<<dim3(a.n_chunks, BH), THREADS, 0, stream>>>(
      a);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const int rows = a.Lq > a.Lkp ? a.Lq : a.Lkp;
  prep_quant_kernel<D, PV8>
      <<<dim3((rows + ROWS - 1) / ROWS, BH), THREADS, 0, stream>>>(a);
  return cudaGetLastError();
}

// a head dim past 256: pass 1 by 128-column chunks, the fold, the wide
// pass 2
template <bool PV8>
cudaError_t launch_wide(const PrepArgs& a, int BH, cudaStream_t stream) {
  const int nc = a.D / 128;
  prep_reduce_kernel<128, PV8>
      <<<dim3(a.n_chunks, BH, nc), THREADS, 0, stream>>>(a);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  prep_fold_kernel<PV8><<<dim3(nc, BH), 128, 0, stream>>>(a);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const int rows = a.Lq > a.Lkp ? a.Lq : a.Lkp;
  prep_quant_wide_kernel<PV8>
      <<<dim3((rows + ROWS - 1) / ROWS, BH), THREADS, 0, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry (bound with ctypes). q (B, H, Lq, D), k and v (B, H, Lk, D)
// are bf16 views with unit stride along D and 16-byte aligned rows;
// strides[9] = (b, h, l) element strides of q, k and v. Lkp is Lk rounded
// up to i8attn.cu's key tile (a multiple of 64). The outputs are
// contiguous: qq (BH, Lq, D) s8, qs (BH, Lq) f32, kq (BH, Lk, D) s8, ks
// (BH, Lkp) f32, vt (BH, D, Lkp) s8 (pv_int8 only; else unused), vs (BH, D)
// f32 (all ones unless pv_int8); part is (BH, n_chunks, 2, D) f32 scratch,
// chunk_rows = ceil(Lk / n_chunks). D a multiple of 128. Returns
// cudaGetLastError().
extern "C" int i8attn_prep_launch(
    const void* q, const void* k, const void* v, const long long* strides,
    int B, int H, int Lq, int Lk, int Lkp, int D, int pv_int8, float qscale,
    void* qq, void* qs, void* kq, void* ks, void* vt, void* vs, void* part,
    int n_chunks, void* stream) {
  PrepArgs a;
  a.q = static_cast<const __nv_bfloat16*>(q);
  a.k = static_cast<const __nv_bfloat16*>(k);
  a.v = static_cast<const __nv_bfloat16*>(v);
  for (int i = 0; i < 3; ++i) {
    a.sq[i] = strides[i];
    a.sk[i] = strides[3 + i];
    a.sv[i] = strides[6 + i];
  }
  a.H = H;
  a.Lq = Lq;
  a.Lk = Lk;
  a.Lkp = Lkp;
  a.D = D;
  a.n_chunks = n_chunks;
  a.chunk_rows = (Lk + n_chunks - 1) / n_chunks;
  a.qscale = qscale;
  a.qq = static_cast<int8_t*>(qq);
  a.qs = static_cast<float*>(qs);
  a.kq = static_cast<int8_t*>(kq);
  a.ks = static_cast<float*>(ks);
  a.vt = static_cast<int8_t*>(vt);
  a.vs = static_cast<float*>(vs);
  a.part = static_cast<float*>(part);
  if (Lkp % ROWS != 0 || Lkp < Lk || Lk < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int BH = B * H;
  if (D == 128)
    return pv_int8 ? launch<128, true>(a, BH, s) : launch<128, false>(a, BH, s);
  if (D == 256)
    return pv_int8 ? launch<256, true>(a, BH, s) : launch<256, false>(a, BH, s);
  if (D > 0 && D % 128 == 0)
    return pv_int8 ? launch_wide<true>(a, BH, s) : launch_wide<false>(a, BH, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
