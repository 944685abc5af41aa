// K9 qk_norm_rope: the q/k RMS norms, the rotary embedding and the joint
// concatenation before an attention call, in one pass.
//
// K9 replaces no Pallas kernel: in the JAX package XLA fused these ops
// (comfyui_gguf_tpu/models/flux.py _qknorm and apply_rope, models/wan.py's
// full-width norms); in the port they were some 40-60 PyTorch launches an
// attention call, many of them full-width f32 passes. Its plain version is
// ops/qkrope.py plain_qk_norm_rope, literally nn/layers.py rms_norm, then
// nn/attention.py apply_rope, then torch.cat.
//
// For each token row of each source (a descriptor: q, k or v of one part of
// the joint sequence, read in place as a strided (B, L, H·D) view of the
// projection's output), in one read and one write:
//
//   y = round(x · rsqrt(mean over G of x² + eps) · gain)   (f32 statistic)
//   out = round(rotate(y))       (pairs: y0·c − y1·s, y1·c + y0·s, in f32)
//
// with the plain version's rounding points (to the activation dtype after the
// norm and after the rotation) and its products and sums unfused (__fmul_rn /
// __fadd_rn: no FMA contraction), in f32 for every activation type. G is the
// gain's length: a head (flux's per-head norm) or the whole row (Wan's full-
// width norm). A descriptor without a table is normalised only (Wan's cross-
// attention); one without gain and table is copied (flux's v, joined with the
// others). The output rows go to (B, L, H, D) storage at the part's row offset,
// so that K7 reads them as (B, H, L, D) views and the head merge after
// attention stays a view.
//
// What bounds it: bytes (a few flops an element). The design takes one row
// a warp, 8 contiguous elements a lane (16 bytes, 32 in f32), so a warp
// covers 256 columns an iteration and a head of D (a power of two up to
// 256) lies within D/8 lanes of one iteration: its statistic is a
// shuffle reduction over those lanes. Everything stays in registers; four
// iterations' loads are issued before their arithmetic. A lane's cos/sin
// pairs and a per-head gain are the same in every iteration and are read
// once a row. A full-width statistic takes a first pass over the row; the
// second reads it again from L1.
#include "common.cuh"

using namespace gguf_cuda;

namespace {

constexpr int MAX_DESC = 8;
constexpr int WARPS = 8;   // rows a block
constexpr int UNROLL = 4;  // iterations whose loads are in flight together
constexpr unsigned FULL = 0xffffffffu;

struct Desc {
  const void* x;  // (B, L, W) view: unit stride along W
  long long xb, xl;
  void* out;  // (B, L, W) rows at the part's row offset
  long long ob, ol;
  const float* gain;   // G values, or null: no norm
  const float* table;  // (cos, sin) pairs, D/2 a row, or null: no rotation
  long long tb, tl;
  int L, per_head;  // per_head: G == D, else G == W
};

struct Args {
  Desc d[MAX_DESC];
  long long start[MAX_DESC + 1];  // first row of each descriptor
  int n, W, D;
  float eps;
};

// the activation types (ET): 0 bf16, 1 f16, 2 f32; a lane's 8 elements are
// one 16-byte word (two in f32)
template <int ET>
__device__ __forceinline__ void unpack8(const uint4* w, float* f) {
  if constexpr (ET == 2) {
    const uint32_t u[8] = {w[0].x, w[0].y, w[0].z, w[0].w,
                           w[1].x, w[1].y, w[1].z, w[1].w};
#pragma unroll
    for (int i = 0; i < 8; ++i) f[i] = __uint_as_float(u[i]);
  } else {
    const uint32_t u[4] = {w[0].x, w[0].y, w[0].z, w[0].w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if constexpr (ET == 0) {
        f[2 * i] = __uint_as_float(u[i] << 16);
        f[2 * i + 1] = __uint_as_float(u[i] & 0xFFFF0000u);
      } else {
        const float2 h =
            __half22float2(*reinterpret_cast<const __half2*>(&u[i]));
        f[2 * i] = h.x;
        f[2 * i + 1] = h.y;
      }
    }
  }
}

template <int ET>
__device__ __forceinline__ void pack8(const float* f, uint4* w) {
  if constexpr (ET == 2) {
    w[0] = make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]),
                      __float_as_uint(f[2]), __float_as_uint(f[3]));
    w[1] = make_uint4(__float_as_uint(f[4]), __float_as_uint(f[5]),
                      __float_as_uint(f[6]), __float_as_uint(f[7]));
  } else if constexpr (ET == 0) {
    w[0] = make_uint4(pack_bf16x2(f[0], f[1]), pack_bf16x2(f[2], f[3]),
                      pack_bf16x2(f[4], f[5]), pack_bf16x2(f[6], f[7]));
  } else {
    w[0] = make_uint4(pack_f16x2(f[0], f[1]), pack_f16x2(f[2], f[3]),
                      pack_f16x2(f[4], f[5]), pack_f16x2(f[6], f[7]));
  }
}

// the nearest value of the activation type, back in f32
template <int ET>
__device__ __forceinline__ float round_et(float v) {
  if constexpr (ET == 0) {
    return __bfloat162float(__float2bfloat16_rn(v));
  } else if constexpr (ET == 1) {
    return __half2float(__float2half_rn(v));
  } else {
    return v;
  }
}

__device__ __forceinline__ void load8f(const float* p, float* f) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
  f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
  f[4] = b.x; f[5] = b.y; f[6] = b.z; f[7] = b.w;
}

template <int ET>
__global__ void __launch_bounds__(WARPS * 32)
    qk_norm_rope_kernel(const __grid_constant__ Args a) {
  constexpr int ES = ET == 2 ? 4 : 2;  // bytes an element
  constexpr int NV = ES / 2;           // 16-byte words a lane
  const long long row =
      static_cast<long long>(blockIdx.x) * WARPS + threadIdx.x / 32;
  if (row >= a.start[a.n]) return;  // whole warps leave together
  int i = 0;
  while (row >= a.start[i + 1]) ++i;
  const Desc& d = a.d[i];
  const long long r = row - a.start[i];
  const long long b = r / d.L, l = r - b * d.L;
  const int lane = threadIdx.x % 32;
  const int W = a.W, D = a.D;
  const uint4* x = reinterpret_cast<const uint4*>(
      static_cast<const char*>(d.x) + (b * d.xb + l * d.xl) * ES);
  uint4* o = reinterpret_cast<uint4*>(
      static_cast<char*>(d.out) + (b * d.ob + l * d.ol) * ES);
  const int nit = (W + 255) / 256;

  // a plain copy (v joining the joint buffer)
  if (d.gain == nullptr && d.table == nullptr) {
    for (int it = 0; it < nit; ++it) {
      const int v = (it * 256 + lane * 8) / 8 * NV;
      if (it * 256 + lane * 8 < W) {
#pragma unroll
        for (int j = 0; j < NV; ++j) o[v + j] = __ldg(x + v + j);
      }
    }
    return;
  }

  // the lane's column within its head is the same in every iteration (D
  // divides 256): its cos/sin pairs and a per-head gain are read once
  const int hc = (lane * 8) % D;
  float cs[8] = {}, g[8] = {};
  if (d.table != nullptr)
    load8f(d.table + b * d.tb + l * d.tl + hc, cs);
  if (d.gain != nullptr && d.per_head) load8f(d.gain + hc, g);

  const float inv_g = 1.f / (d.per_head ? D : W), eps = a.eps;
  float rinv = 0.f;
  if (d.gain != nullptr && !d.per_head) {  // the full-width statistic
    float ss = 0.f;
#pragma unroll 4
    for (int it = 0; it < nit; ++it) {
      const int c = it * 256 + lane * 8;
      if (c < W) {
        uint4 w[NV];
#pragma unroll
        for (int j = 0; j < NV; ++j) w[j] = __ldg(x + c / 8 * NV + j);
        float f[8];
        unpack8<ET>(w, f);
#pragma unroll
        for (int e = 0; e < 8; ++e)
          ss = __fadd_rn(ss, __fmul_rn(f[e], f[e]));
      }
    }
#pragma unroll
    for (int off = 16; off >= 1; off >>= 1)
      ss = __fadd_rn(ss, __shfl_xor_sync(FULL, ss, off));
    rinv = rsqrtf(__fadd_rn(__fmul_rn(ss, inv_g), eps));
  }

  for (int it0 = 0; it0 < nit; it0 += UNROLL) {
    uint4 w[UNROLL][NV];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int c = (it0 + u) * 256 + lane * 8;
      if (c < W) {
#pragma unroll
        for (int j = 0; j < NV; ++j) w[u][j] = __ldg(x + c / 8 * NV + j);
      }
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int c = (it0 + u) * 256 + lane * 8;
      const bool act = c < W;
      float f[8] = {};
      if (act) unpack8<ET>(w[u], f);
      if (d.gain != nullptr) {
        float rs = rinv;
        if (d.per_head) {  // every lane shuffles, idle ones with zeros
          float ss = 0.f;
#pragma unroll
          for (int e = 0; e < 8; ++e)
          ss = __fadd_rn(ss, __fmul_rn(f[e], f[e]));
          for (int off = D / 16; off >= 1; off >>= 1)
            ss = __fadd_rn(ss, __shfl_xor_sync(FULL, ss, off));
          rs = rsqrtf(__fadd_rn(__fmul_rn(ss, inv_g), eps));
        } else if (act) {
          load8f(d.gain + c, g);
        }
#pragma unroll
        for (int e = 0; e < 8; ++e)
          f[e] = round_et<ET>(__fmul_rn(__fmul_rn(f[e], rs), g[e]));
      }
      if (d.table != nullptr) {
#pragma unroll
        for (int p = 0; p < 4; ++p) {
          const float c0 = cs[2 * p], s0 = cs[2 * p + 1];
          const float x0 = f[2 * p], x1 = f[2 * p + 1];
          f[2 * p] = round_et<ET>(__fadd_rn(__fmul_rn(x0, c0),
                                            __fmul_rn(x1, -s0)));
          f[2 * p + 1] = round_et<ET>(__fadd_rn(__fmul_rn(x1, c0),
                                                __fmul_rn(x0, s0)));
        }
      }
      if (act) {
        uint4 out[NV];
        pack8<ET>(f, out);
#pragma unroll
        for (int j = 0; j < NV; ++j) o[c / 8 * NV + j] = out[j];
      }
    }
  }
}

template <int ET>
int launch(const long long* desc, int n, int B, int W, int D, float eps,
           cudaStream_t stream) {
  Args a{};
  a.n = n;
  a.W = W;
  a.D = D;
  a.eps = eps;
  a.start[0] = 0;
  for (int i = 0; i < n; ++i) {
    const long long* s = desc + 12 * i;
    Desc& d = a.d[i];
    d.x = reinterpret_cast<const void*>(s[0]);
    d.xb = s[1];
    d.xl = s[2];
    d.out = reinterpret_cast<void*>(s[3]);
    d.ob = s[4];
    d.ol = s[5];
    d.gain = reinterpret_cast<const float*>(s[6]);
    d.per_head = static_cast<int>(s[7]);
    d.table = reinterpret_cast<const float*>(s[8]);
    d.tb = s[9];
    d.tl = s[10];
    d.L = static_cast<int>(s[11]);
    if (d.L < 1) return static_cast<int>(cudaErrorInvalidValue);
    a.start[i + 1] = a.start[i] + static_cast<long long>(B) * d.L;
  }
  const long long blocks = (a.start[n] + WARPS - 1) / WARPS;
  qk_norm_rope_kernel<ET><<<static_cast<unsigned>(blocks), WARPS * 32, 0,
                            stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// desc: n descriptors of 12 values each: x, x's batch and row strides, out,
// out's batch and row strides (elements), gain (f32 or 0), per-head (G ==
// D), table (f32 or 0), its batch and row strides (floats), rows L. Every
// pointer 16-byte aligned, every row stride a multiple of 8 elements; W a
// multiple of 8 and of D; D a power of two from 16 to 256.
extern "C" int qk_norm_rope_launch(const long long* desc, int n, int B, int W,
                                   int D, int elem, float eps, void* stream) {
  if (n < 1 || n > MAX_DESC || B < 1 || W < 8 || W % 8 != 0 || D < 16 ||
      D > 256 || (D & (D - 1)) != 0 || W % D != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (elem) {
    case 0: return launch<0>(desc, n, B, W, D, eps, s);
    case 1: return launch<1>(desc, n, B, W, D, eps, s);
    case 2: return launch<2>(desc, n, B, W, D, eps, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
