// GGML block codecs on the host CPU (C++, threads), the port's own copy.
//
// The multi-threaded counterpart of quant/codecs.py and of the planar
// assembly in quant/planar.py: the encoders (Q4_0, Q8_0, Q4_K, Q5_K, Q6_K),
// the decoders (Q4_0, Q8_0, Q4_K, Q6_K), the component extraction of the
// K-quants (Q2_K .. Q6_K) and the two byte re-tilings of a planar weight.
// Every output is byte-equal to the numpy codec it stands for; the CPU
// tests (tests/test_torch_native.py) hold it so for f32 inputs and for
// f16- and bf16-rounded ones, at several thread counts.
//
// Two rules keep the bytes equal:
// * it is built with -ffp-contract=off (native/__init__.py), so no
//   `a * b + c` becomes one fused multiply-add: numpy rounds the product
//   first, and near-tie codes of f16/bf16-rounded blocks would move;
// * ties and signed zeros follow numpy: Q4_0's signed absmax is the FIRST
//   element of largest magnitude (np.argmax), starting from x[0].
//
// Each entry takes its thread count as its last argument, so the caller
// (torch.get_num_threads()) bounds it; the work is split over std::thread
// in contiguous ranges (no OpenMP: a compiler without its runtime builds
// this too, and no thread pool outlives a call). The symbols carry a ggqt_
// prefix, apart from those of the reference package's library.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <initializer_list>
#include <thread>
#include <vector>

namespace {

// ---------------------------------------------------------------------------
// float <-> half, round to nearest even (numpy's astype(np.float16))
// ---------------------------------------------------------------------------

inline uint16_t f32_to_f16(float f) {
    uint32_t x;
    std::memcpy(&x, &f, 4);
    const uint32_t sign = (x >> 16) & 0x8000u;
    uint32_t mant = x & 0x007fffffu;
    int32_t exp = (int32_t)((x >> 23) & 0xff) - 127 + 15;
    if (((x >> 23) & 0xff) == 0xff && mant) {
        // NaN stays NaN (quiet bit + the payload's high bits)
        return (uint16_t)(sign | 0x7e00u | (mant >> 13));
    }
    if (exp >= 31) return (uint16_t)(sign | 0x7c00u);  // inf / overflow
    if (exp <= 0) {
        if (exp < -10) return (uint16_t)sign;  // below half the least subnormal
        mant |= 0x00800000u;
        const uint32_t shift = (uint32_t)(14 - exp);
        const uint32_t half = 1u << (shift - 1);
        const uint32_t rounded =
            (mant + half - 1 + ((mant >> shift) & 1)) >> shift;
        return (uint16_t)(sign | rounded);
    }
    const uint32_t round_bit = 0x00001000u;
    if ((mant & round_bit) &&
        ((mant & (round_bit - 1)) || (mant & (round_bit << 1)))) {
        mant += round_bit;
        if (mant & 0x00800000u) {
            mant = 0;
            ++exp;
            if (exp >= 31) return (uint16_t)(sign | 0x7c00u);
        }
    }
    return (uint16_t)(sign | ((uint32_t)exp << 10) | (mant >> 13));
}

inline float f16_to_f32(uint16_t h) {
    const uint32_t sign = (uint32_t)(h & 0x8000u) << 16;
    uint32_t exp = (h >> 10) & 0x1f;
    uint32_t mant = h & 0x3ffu;
    uint32_t x;
    if (exp == 0) {
        if (mant == 0) {
            x = sign;
        } else {
            exp = 127 - 15 + 1;
            while (!(mant & 0x400u)) { mant <<= 1; --exp; }
            mant &= 0x3ffu;
            x = sign | (exp << 23) | (mant << 13);
        }
    } else if (exp == 31) {
        x = sign | 0x7f800000u | (mant << 13);
    } else {
        x = sign | ((exp - 15 + 127) << 23) | (mant << 13);
    }
    float f;
    std::memcpy(&f, &x, 4);
    return f;
}

// Runs body(i) for every i in [0, n) on up to nt threads, the calling one
// among them, each over one contiguous range of at least `grain` items. A
// thread that cannot be started leaves its range to the calling thread.
template <class Body>
void parallel_for(int64_t n, int nt, int64_t grain, Body body) {
    const int64_t t = std::max<int64_t>(
        1, std::min<int64_t>(nt, n / std::max<int64_t>(grain, 1)));
    auto run = [&](int64_t i) {
        for (int64_t k = n * i / t; k < n * (i + 1) / t; ++k) body(k);
    };
    std::vector<std::thread> pool;
    int64_t started = 1;
    try {
        pool.reserve((size_t)(t - 1));
        for (; started < t; ++started) pool.emplace_back(run, started);
    } catch (...) {
    }
    run(0);
    for (int64_t i = started; i < t; ++i) run(i);
    for (auto& th : pool) th.join();
}

// items a thread takes at least: blocks of 32 / 256 elements
constexpr int64_t GRAIN_32 = 1024, GRAIN_256 = 128;

inline float f16_round(float v) { return f16_to_f32(f32_to_f16(v)); }

inline float f16_at(const uint8_t* p) {
    return f16_to_f32((uint16_t)(p[0] | (p[1] << 8)));
}

inline void put_f16(uint8_t* p, float v) {
    const uint16_t h = f32_to_f16(v);
    p[0] = (uint8_t)(h & 0xff);
    p[1] = (uint8_t)(h >> 8);
}

// codecs._safe_inv
inline float safe_inv(float d) { return d != 0.0f ? 1.0f / d : 0.0f; }

inline float clampf(float v, float lo, float hi) {
    return std::min(hi, std::max(lo, v));
}

// numpy's clip(rint(v), lo, hi) for integer bounds under 2^22: clipping
// first gives the same integer, and adding and taking away 1.5 * 2^23 then
// rounds half to even in the default rounding mode (std::nearbyint is a
// library call on a baseline x86-64 build)
inline int rint_clip(float v, float lo, float hi) {
    const float c = clampf(v, lo, hi);
    return (int)((c + 0x1.8p23f) - 0x1.8p23f);
}

// numpy's clip(trunc(v), lo, hi), likewise: the cast truncates
inline int trunc_clip(float v, float lo, float hi) {
    return (int)clampf(v, lo, hi);
}

// ---------------------------------------------------------------------------
// Q8_0: 32 elements -> f16 d + 32 int8 (34 B)           codecs.encode_Q8_0
// ---------------------------------------------------------------------------

void enc_q8_0_block(const float* x, uint8_t* dst) {
    float amax = 0.f;
    for (int i = 0; i < 32; ++i) amax = std::max(amax, std::fabs(x[i]));
    const float d = f16_round(amax / 127.0f);
    put_f16(dst, d);
    const float inv = safe_inv(d);
    int8_t* q = (int8_t*)(dst + 2);
    for (int i = 0; i < 32; ++i)
        q[i] = (int8_t)rint_clip(x[i] * inv, -127.0f, 127.0f);
}

void dec_q8_0_block(const uint8_t* src, float* x) {
    const float d = f16_at(src);
    const int8_t* q = (const int8_t*)(src + 2);
    for (int i = 0; i < 32; ++i) x[i] = d * (float)q[i];
}

// ---------------------------------------------------------------------------
// Q4_0: 32 elements -> f16 d + 16 nibble bytes (18 B), zero point 8
//                                                        codecs.encode_Q4_0
// ---------------------------------------------------------------------------

void enc_q4_0_block(const float* x, uint8_t* dst) {
    // codecs._signed_absmax: the first element of largest magnitude
    float m = x[0], amax = std::fabs(x[0]);
    for (int i = 1; i < 32; ++i) {
        const float a = std::fabs(x[i]);
        if (a > amax) { amax = a; m = x[i]; }
    }
    const float d = f16_round(m / -8.0f);
    put_f16(dst, d);
    const float inv = safe_inv(d);
    uint8_t q[32];
    for (int i = 0; i < 32; ++i) {
        const float p = x[i] * inv;  // rounded before the add: no FMA
        q[i] = (uint8_t)trunc_clip(p + 8.5f, 0.0f, 15.0f);
    }
    for (int i = 0; i < 16; ++i)
        dst[2 + i] = (uint8_t)(q[i] | (q[16 + i] << 4));
}

void dec_q4_0_block(const uint8_t* src, float* x) {
    const float d = f16_at(src);
    for (int i = 0; i < 16; ++i) {
        x[i] = d * (float)((int)(src[2 + i] & 0x0F) - 8);
        x[16 + i] = d * (float)((int)(src[2 + i] >> 4) - 8);
    }
}

// ---------------------------------------------------------------------------
// Q4_K / Q5_K: 256 elements, 8 sub-blocks of 32, affine fit (144 / 176 B)
//                      codecs._affine_fit_sub + encode_Q4_K / encode_Q5_K
// ---------------------------------------------------------------------------

void pack_scale_min_k4(const uint8_t* sc, const uint8_t* mn, uint8_t* out12) {
    for (int i = 0; i < 4; ++i) {
        out12[i] = (uint8_t)((sc[i] & 0x3F) | ((sc[4 + i] >> 4) << 6));
        out12[4 + i] = (uint8_t)((mn[i] & 0x3F) | ((mn[4 + i] >> 4) << 6));
        out12[8 + i] = (uint8_t)((sc[4 + i] & 0x0F) | ((mn[4 + i] & 0x0F) << 4));
    }
}

template <int QMAX>
void affine_fit(const float* x, uint8_t* sc, uint8_t* mn, uint8_t* q,
                float* d16p, float* dmin16p) {
    float mn_sub[8], s_sub[8];
    float dmax = 0.f, mmax = 0.f;
    for (int s = 0; s < 8; ++s) {
        float lo = x[s * 32], hi = x[s * 32];
        for (int i = 1; i < 32; ++i) {
            lo = std::min(lo, x[s * 32 + i]);
            hi = std::max(hi, x[s * 32 + i]);
        }
        // max(0, -lo) + 0.0: +0.0 for a zero minimum of either sign
        mn_sub[s] = std::max(0.0f, -lo) + 0.0f;
        s_sub[s] = std::max(hi + mn_sub[s], 0.0f) / (float)QMAX;
        dmax = std::max(dmax, s_sub[s]);
        mmax = std::max(mmax, mn_sub[s]);
    }
    const float d16 = f16_round(dmax / 63.0f);
    const float dmin16 = f16_round(mmax / 63.0f);
    const float invd = safe_inv(d16), invm = safe_inv(dmin16);
    for (int s = 0; s < 8; ++s) {
        sc[s] = (uint8_t)rint_clip(s_sub[s] * invd, 0.0f, 63.0f);
        mn[s] = (uint8_t)rint_clip(mn_sub[s] * invm, 0.0f, 63.0f);
        const float S = d16 * (float)sc[s];
        const float M = dmin16 * (float)mn[s];
        const float invS = safe_inv(S);
        for (int i = 0; i < 32; ++i) {
            q[s * 32 + i] =
                (uint8_t)rint_clip((x[s * 32 + i] + M) * invS, 0.0f, (float)QMAX);
        }
    }
    *d16p = d16;
    *dmin16p = dmin16;
}

void enc_q4_k_block(const float* x, uint8_t* dst) {
    uint8_t sc[8], mn[8], q[256];
    float d16, dmin16;
    affine_fit<15>(x, sc, mn, q, &d16, &dmin16);
    put_f16(dst, d16);
    put_f16(dst + 2, dmin16);
    pack_scale_min_k4(sc, mn, dst + 4);
    uint8_t* qs = dst + 16;
    for (int g = 0; g < 4; ++g)
        for (int i = 0; i < 32; ++i)
            qs[g * 32 + i] = (uint8_t)(q[g * 64 + i] | (q[g * 64 + 32 + i] << 4));
}

void unpack_scale_min_k4(const uint8_t* s12, uint8_t* sc, uint8_t* mn) {
    for (int i = 0; i < 4; ++i) {
        sc[i] = s12[i] & 0x3F;
        mn[i] = s12[4 + i] & 0x3F;
        sc[4 + i] = (uint8_t)((s12[8 + i] & 0x0F) | ((s12[i] >> 2) & 0x30));
        mn[4 + i] = (uint8_t)((s12[8 + i] >> 4) | ((s12[4 + i] >> 2) & 0x30));
    }
}

// codecs.Components.combine: w = A * q + B with A = d * sc, B = -(dmin * mn)
void dec_q4_k_block(const uint8_t* src, float* x) {
    const float d = f16_at(src), dmin = f16_at(src + 2);
    uint8_t sc[8], mn[8];
    unpack_scale_min_k4(src + 4, sc, mn);
    const uint8_t* qs = src + 16;
    for (int g = 0; g < 4; ++g) {
        const float A0 = d * (float)sc[2 * g], B0 = -(dmin * (float)mn[2 * g]);
        const float A1 = d * (float)sc[2 * g + 1];
        const float B1 = -(dmin * (float)mn[2 * g + 1]);
        for (int i = 0; i < 32; ++i) {
            x[g * 64 + i] = A0 * (float)(qs[g * 32 + i] & 0x0F) + B0;
            x[g * 64 + 32 + i] = A1 * (float)(qs[g * 32 + i] >> 4) + B1;
        }
    }
}

void enc_q5_k_block(const float* x, uint8_t* dst) {
    uint8_t sc[8], mn[8], q[256];
    float d16, dmin16;
    affine_fit<31>(x, sc, mn, q, &d16, &dmin16);
    put_f16(dst, d16);
    put_f16(dst + 2, dmin16);
    pack_scale_min_k4(sc, mn, dst + 4);
    uint8_t* qh = dst + 16;
    uint8_t* qs = dst + 48;
    std::memset(qh, 0, 32);
    for (int s = 0; s < 8; ++s)
        for (int i = 0; i < 32; ++i)
            qh[i] |= (uint8_t)((q[s * 32 + i] >> 4) << s);
    for (int g = 0; g < 4; ++g)
        for (int i = 0; i < 32; ++i)
            qs[g * 32 + i] = (uint8_t)((q[g * 64 + i] & 0x0F) |
                                       ((q[g * 64 + 32 + i] & 0x0F) << 4));
}

// ---------------------------------------------------------------------------
// Q6_K: 256 elements, 16 sub-blocks of 16, signed 6-bit (210 B)
//                                                        codecs.encode_Q6_K
// ---------------------------------------------------------------------------

void enc_q6_k_block(const float* x, uint8_t* dst) {
    float s_sub[16];
    float dmax = 0.f;
    for (int s = 0; s < 16; ++s) {
        float a = 0.f;
        for (int i = 0; i < 16; ++i) a = std::max(a, std::fabs(x[s * 16 + i]));
        s_sub[s] = a / 31.0f;
        dmax = std::max(dmax, s_sub[s]);
    }
    const float d16 = f16_round(dmax / 127.0f);
    const float invd = safe_inv(d16);
    int8_t sc[16];
    uint8_t q[256];
    for (int s = 0; s < 16; ++s) {
        sc[s] = (int8_t)rint_clip(s_sub[s] * invd, 0.0f, 127.0f);
        const float invS = safe_inv(d16 * (float)sc[s]);
        for (int i = 0; i < 16; ++i) {
            q[s * 16 + i] =
                (uint8_t)(rint_clip(x[s * 16 + i] * invS, -32.0f, 31.0f) + 32);
        }
    }
    uint8_t* ql = dst;         // 128 B
    uint8_t* qh = dst + 128;   // 64 B
    uint8_t* scp = dst + 192;  // 16 B
    for (int h = 0; h < 2; ++h) {
        const uint8_t* qq = q + h * 128;
        for (int i = 0; i < 64; ++i)
            ql[h * 64 + i] = (uint8_t)((qq[i] & 0x0F) | ((qq[64 + i] & 0x0F) << 4));
        for (int i = 0; i < 32; ++i) {
            uint8_t b = 0;
            for (int s2 = 0; s2 < 4; ++s2)
                b |= (uint8_t)(((qq[s2 * 32 + i] >> 4) & 0x03) << (2 * s2));
            qh[h * 32 + i] = b;
        }
    }
    std::memcpy(scp, sc, 16);
    put_f16(dst + 208, d16);
}

// Q6_K's 256 codes in element order, -32..31 (codecs.components_Q6_K)
void unpack_q6_k_codes(const uint8_t* src, int8_t* q) {
    for (int h = 0; h < 2; ++h) {
        const uint8_t* l = src + h * 64;         // low nibbles
        const uint8_t* hh = src + 128 + h * 32;  // 2-bit highs
        int8_t* out = q + h * 128;
        for (int i = 0; i < 32; ++i) {
            out[i] = (int8_t)(((l[i] & 0x0F) | ((hh[i] & 3) << 4)) - 32);
            out[32 + i] = (int8_t)(((l[32 + i] & 0x0F) | (((hh[i] >> 2) & 3) << 4)) - 32);
            out[64 + i] = (int8_t)(((l[i] >> 4) | (((hh[i] >> 4) & 3) << 4)) - 32);
            out[96 + i] = (int8_t)(((l[32 + i] >> 4) | (((hh[i] >> 6) & 3) << 4)) - 32);
        }
    }
}

// codecs.Components.combine: w = (d * sc) * q
void dec_q6_k_block(const uint8_t* src, float* x) {
    const int8_t* sc = (const int8_t*)(src + 192);
    const float d = f16_at(src + 208);
    int8_t q[256];
    unpack_q6_k_codes(src, q);
    for (int s = 0; s < 16; ++s) {
        const float A = d * (float)sc[s];
        for (int i = 0; i < 16; ++i) x[s * 16 + i] = A * (float)q[s * 16 + i];
    }
}

// ---------------------------------------------------------------------------
// byte tiles: an 8 x 8 byte transpose in eight 64-bit words (little endian)
// ---------------------------------------------------------------------------

inline uint64_t load8(const void* p) {
    uint64_t v;
    std::memcpy(&v, p, 8);
    return v;
}

inline void store8(void* p, uint64_t v) { std::memcpy(p, &v, 8); }

// x[i] holds row i (byte c = column c); afterwards x[c] holds column c
inline void transpose8x8(uint64_t* x) {
    for (int i = 0; i < 4; ++i) {  // swap the off-diagonal 4 x 4 blocks
        const uint64_t a = x[i], b = x[i + 4];
        x[i] = (a & 0x00000000FFFFFFFFull) | (b << 32);
        x[i + 4] = (a >> 32) | (b & 0xFFFFFFFF00000000ull);
    }
    for (int i : {0, 1, 4, 5}) {  // ... the 2 x 2 blocks inside them
        const uint64_t a = x[i], b = x[i + 2];
        x[i] = (a & 0x0000FFFF0000FFFFull) | ((b & 0x0000FFFF0000FFFFull) << 16);
        x[i + 2] = ((a >> 16) & 0x0000FFFF0000FFFFull) | (b & 0xFFFF0000FFFF0000ull);
    }
    for (int i : {0, 2, 4, 6}) {  // ... and the bytes inside those
        const uint64_t a = x[i], b = x[i + 1];
        x[i] = (a & 0x00FF00FF00FF00FFull) | ((b & 0x00FF00FF00FF00FFull) << 8);
        x[i + 1] = ((a >> 8) & 0x00FF00FF00FF00FFull) | (b & 0xFF00FF00FF00FF00ull);
    }
}

// dst (J, rp) from the rows of src (R, ld): dst[j, r] = f(src row r, j) for
// j < J, r < R, and 0 for R <= r < rp. `word(row, j)` gives the 8 bytes
// f(row, j .. j + 7) as one word, `byte(row, j)` one byte. Bands of 64
// output rows go to the threads; in a band, 8 source rows at a time are
// read 64 bytes each and written as 8-byte pieces of 64 output rows.
template <class Word, class Byte>
void retile(uint8_t* dst, int64_t R, int64_t J, int64_t rp, int nt,
            Word word, Byte byte) {
    const int64_t band = 64;
    const int64_t n_bands = (J + band - 1) / band;
    const int64_t R8 = R - R % 8;
    parallel_for(n_bands, nt, 1 + (1 << 15) / (band * std::max<int64_t>(R, 1)),
                 [&](int64_t b) {
        const int64_t j0 = b * band, j1 = std::min(J, j0 + band);
        const int64_t j8 = j0 + (j1 - j0) / 8 * 8;
        for (int64_t r0 = 0; r0 < R8; r0 += 8) {
            for (int64_t j = j0; j < j8; j += 8) {
                uint64_t x[8];
                for (int i = 0; i < 8; ++i) x[i] = word(r0 + i, j);
                transpose8x8(x);
                for (int c = 0; c < 8; ++c) store8(dst + (j + c) * rp + r0, x[c]);
            }
            for (int64_t j = j8; j < j1; ++j)
                for (int i = 0; i < 8; ++i) dst[j * rp + r0 + i] = byte(r0 + i, j);
        }
        for (int64_t j = j0; j < j1; ++j) {
            for (int64_t r = R8; r < R; ++r) dst[j * rp + r] = byte(r, j);
            std::memset(dst + j * rp + R, 0, (size_t)(rp - R));
        }
    });
}

}  // namespace

// ---------------------------------------------------------------------------
// C API
// ---------------------------------------------------------------------------

extern "C" {

// qtype codes of gguf.constants.GGMLQuantizationType
enum { GGQ_Q4_0 = 2, GGQ_Q8_0 = 8, GGQ_Q4_K = 12, GGQ_Q5_K = 13,
       GGQ_Q6_K = 14 };

int ggqt_block_size(int qtype) {
    switch (qtype) {
        case GGQ_Q4_0: case GGQ_Q8_0: return 32;
        case GGQ_Q4_K: case GGQ_Q5_K: case GGQ_Q6_K: return 256;
        default: return 0;
    }
}

int ggqt_type_size(int qtype) {
    switch (qtype) {
        case GGQ_Q4_0: return 18;
        case GGQ_Q8_0: return 34;
        case GGQ_Q4_K: return 144;
        case GGQ_Q5_K: return 176;
        case GGQ_Q6_K: return 210;
        default: return 0;
    }
}

// src: n floats (n % block == 0) -> dst: n / block * type_size bytes
int ggqt_quantize(int qtype, const float* src, uint8_t* dst, int64_t n,
                  int nt) {
    const int bs = ggqt_block_size(qtype), ts = ggqt_type_size(qtype);
    if (!bs || n % bs || nt < 1) return -1;
    parallel_for(n / bs, nt, bs == 32 ? GRAIN_32 : GRAIN_256, [&](int64_t b) {
        const float* x = src + b * bs;
        uint8_t* d = dst + b * ts;
        switch (qtype) {
            case GGQ_Q4_0: enc_q4_0_block(x, d); break;
            case GGQ_Q8_0: enc_q8_0_block(x, d); break;
            case GGQ_Q4_K: enc_q4_k_block(x, d); break;
            case GGQ_Q5_K: enc_q5_k_block(x, d); break;
            case GGQ_Q6_K: enc_q6_k_block(x, d); break;
        }
    });
    return 0;
}

// src: n / block blocks -> dst: n floats (Q4_0, Q8_0, Q4_K, Q6_K)
int ggqt_dequantize(int qtype, const uint8_t* src, float* dst, int64_t n,
                    int nt) {
    const int bs = ggqt_block_size(qtype), ts = ggqt_type_size(qtype);
    if (!bs || n % bs || qtype == GGQ_Q5_K || nt < 1) return -1;
    parallel_for(n / bs, nt, bs == 32 ? GRAIN_32 : GRAIN_256, [&](int64_t b) {
        const uint8_t* s = src + b * ts;
        float* x = dst + b * bs;
        switch (qtype) {
            case GGQ_Q4_0: dec_q4_0_block(s, x); break;
            case GGQ_Q8_0: dec_q8_0_block(s, x); break;
            case GGQ_Q4_K: dec_q4_k_block(s, x); break;
            case GGQ_Q6_K: dec_q6_k_block(s, x); break;
        }
    });
    return 0;
}

// The component extraction of codecs.components_Q*_K, per block: q (256
// codes in element order), A (the per-group scales) and, for the formats
// with a minimum, B (the per-group offsets), with the numpy extractors'
// f16 -> f32 conversions and products.

// Q4_K (144 B): q u8 0..15, A = d * sc (8), B = -(dmin * mn) (8)
int ggqt_extract_q4k(const uint8_t* blocks, uint8_t* q, float* A, float* B,
                     int64_t n_blocks, int nt) {
    if (nt < 1) return -1;
    parallel_for(n_blocks, nt, GRAIN_256, [&](int64_t b) {
        const uint8_t* src = blocks + b * 144;
        const float d = f16_at(src), dmin = f16_at(src + 2);
        uint8_t sc[8], mn[8];
        unpack_scale_min_k4(src + 4, sc, mn);
        for (int i = 0; i < 8; ++i) {
            A[b * 8 + i] = d * (float)sc[i];
            B[b * 8 + i] = -(dmin * (float)mn[i]);
        }
        const uint8_t* qs = src + 16;  // 4 groups of 32 bytes
        uint8_t* qb = q + b * 256;
        for (int g = 0; g < 4; ++g)
            for (int i = 0; i < 32; ++i) {
                qb[g * 64 + i] = (uint8_t)(qs[g * 32 + i] & 0x0F);
                qb[g * 64 + 32 + i] = (uint8_t)(qs[g * 32 + i] >> 4);
            }
    });
    return 0;
}

// Q5_K (176 B): q u8 0..31 (qh bit j is sub-block j's fifth bit), A, B as Q4_K
int ggqt_extract_q5k(const uint8_t* blocks, uint8_t* q, float* A, float* B,
                     int64_t n_blocks, int nt) {
    if (nt < 1) return -1;
    parallel_for(n_blocks, nt, GRAIN_256, [&](int64_t b) {
        const uint8_t* src = blocks + b * 176;
        const float d = f16_at(src), dmin = f16_at(src + 2);
        uint8_t sc[8], mn[8];
        unpack_scale_min_k4(src + 4, sc, mn);
        for (int i = 0; i < 8; ++i) {
            A[b * 8 + i] = d * (float)sc[i];
            B[b * 8 + i] = -(dmin * (float)mn[i]);
        }
        const uint8_t* qh = src + 16;  // 32 bytes of fifth bits
        const uint8_t* qs = src + 48;  // 4 groups of 32 low-nibble bytes
        uint8_t* qb = q + b * 256;
        for (int g = 0; g < 4; ++g)
            for (int i = 0; i < 32; ++i) {
                qb[g * 64 + i] = (uint8_t)((qs[g * 32 + i] & 0x0F) |
                                           (((qh[i] >> (2 * g)) & 1) << 4));
                qb[g * 64 + 32 + i] = (uint8_t)((qs[g * 32 + i] >> 4) |
                                                (((qh[i] >> (2 * g + 1)) & 1) << 4));
            }
    });
    return 0;
}

// Q6_K (210 B): q i8 -32..31, A = d * sc (16, signed 8-bit scales)
int ggqt_extract_q6k(const uint8_t* blocks, int8_t* q, float* A,
                     int64_t n_blocks, int nt) {
    if (nt < 1) return -1;
    parallel_for(n_blocks, nt, GRAIN_256, [&](int64_t b) {
        const uint8_t* src = blocks + b * 210;
        const int8_t* sc = (const int8_t*)(src + 192);
        const float d = f16_at(src + 208);
        for (int i = 0; i < 16; ++i) A[b * 16 + i] = d * (float)sc[i];
        unpack_q6_k_codes(src, q + b * 256);
    });
    return 0;
}

// Q3_K (110 B): q i8 = low2 - 4 * (1 - high bit), A = d * (6-bit scale - 32)
int ggqt_extract_q3k(const uint8_t* blocks, int8_t* q, float* A,
                     int64_t n_blocks, int nt) {
    if (nt < 1) return -1;
    parallel_for(n_blocks, nt, GRAIN_256, [&](int64_t b) {
        const uint8_t* src = blocks + b * 110;
        const uint8_t* hmask = src;        // 32 bytes of high bits
        const uint8_t* qs = src + 32;      // 64 bytes of 2-bit lows
        const uint8_t* scales = src + 96;  // 12-byte 6-bit scale table
        const float d = f16_at(src + 108);
        for (int j = 0; j < 16; ++j) {
            const int lo4 = j < 8 ? (scales[j] & 0x0F) : (scales[j - 8] >> 4);
            const int hi2 = (scales[8 + (j & 3)] >> (2 * (j >> 2))) & 3;
            A[b * 16 + j] = d * (float)((int8_t)(lo4 | (hi2 << 4)) - 32);
        }
        for (int h = 0; h < 2; ++h)
            for (int s = 0; s < 4; ++s) {
                int8_t* out = q + b * 256 + h * 128 + s * 32;
                const int sh = h * 4 + s;  // the hmask bit of this sub-block
                for (int i = 0; i < 32; ++i) {
                    const int lo = (qs[h * 32 + i] >> (2 * s)) & 3;
                    const int hb = (hmask[i] >> sh) & 1;
                    out[i] = (int8_t)(lo - ((hb ^ 1) << 2));
                }
            }
    });
    return 0;
}

// Q2_K (84 B): q u8 0..3, A = d * (scale & 15), B = -(dmin * (scale >> 4))
int ggqt_extract_q2k(const uint8_t* blocks, uint8_t* q, float* A, float* B,
                     int64_t n_blocks, int nt) {
    if (nt < 1) return -1;
    parallel_for(n_blocks, nt, GRAIN_256, [&](int64_t b) {
        const uint8_t* src = blocks + b * 84;
        const uint8_t* scales = src;   // 16 bytes: scale low, min high
        const uint8_t* qs = src + 16;  // 64 bytes of 2-bit codes
        const float d = f16_at(src + 80), dmin = f16_at(src + 82);
        for (int i = 0; i < 16; ++i) {
            A[b * 16 + i] = d * (float)(scales[i] & 0x0F);
            B[b * 16 + i] = -(dmin * (float)(scales[i] >> 4));
        }
        for (int h = 0; h < 2; ++h)
            for (int s = 0; s < 4; ++s) {
                uint8_t* out = q + b * 256 + h * 128 + s * 32;
                for (int i = 0; i < 32; ++i)
                    out[i] = (uint8_t)((qs[h * 32 + i] >> (2 * s)) & 3);
            }
    });
    return 0;
}

// The planar re-tiling of quant/planar.py: codes (R, K) row-major -> a
// K-major plane with R padded to rp by zero lanes.

// nib4: dst (K/2, rp), dst[j, r] = q[r, j] | q[r, j + K/2] << 4
int ggqt_pack_nib4_planar(const uint8_t* q, uint8_t* dst, int64_t R,
                          int64_t K, int64_t rp, int nt) {
    if (K % 2 || rp < R || nt < 1) return -1;
    const int64_t Kh = K / 2;
    retile(dst, R, Kh, rp, nt,
           [=](int64_t r, int64_t j) {
               const uint8_t* row = q + r * K + j;
               return load8(row) | ((load8(row + Kh) << 4) & 0xF0F0F0F0F0F0F0F0ull);
           },
           [=](int64_t r, int64_t j) {
               const uint8_t* row = q + r * K + j;
               return (uint8_t)(row[0] | (uint8_t)(row[Kh] << 4));
           });
    return 0;
}

// int8: dst (K, rp), dst[j, r] = q[r, j]
int ggqt_transpose_i8(const int8_t* q, int8_t* dst, int64_t R, int64_t K,
                      int64_t rp, int nt) {
    if (rp < R || nt < 1) return -1;
    const uint8_t* u = (const uint8_t*)q;
    retile((uint8_t*)dst, R, K, rp, nt,
           [=](int64_t r, int64_t j) { return load8(u + r * K + j); },
           [=](int64_t r, int64_t j) { return u[r * K + j]; });
    return 0;
}

}  // extern "C"
