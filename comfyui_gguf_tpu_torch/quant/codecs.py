"""GGML quantization block codecs (numpy, host-side).

The port's own copy of ``comfyui_gguf_tpu/quant/codecs.py``: the same
decoders (exact GGML block semantics, llama.cpp ggml-quants.c) and the same
encoders (direct affine/absmax fits that produce valid GGML blocks). The
reference package's multi-threaded C++ codec library is not carried over;
the numpy decoders here are the bit-exact path it was checked against.

These run at load/convert time on the host. The on-device inference path
uses the planar re-tiled layout (quant/planar.py) and the CUDA kernels
(ops/).
"""

from __future__ import annotations

import numpy as np

from ..gguf.constants import (
    GGML_QUANT_SIZES,
    K_SCALE_SIZE,
    QK_K,
    GGMLQuantizationType,
)

Q = GGMLQuantizationType

# 16-entry non-linear codebook shared by IQ4_NL / IQ4_XS (llama.cpp kvalues_iq4nl)
IQ4_KVALUES = np.array(
    [-127, -104, -83, -65, -49, -35, -22, -10, 1, 13, 25, 38, 53, 69, 89, 113],
    dtype=np.int8,
)


# --------------------------------------------------------------------------
# helpers
# --------------------------------------------------------------------------

def _f16(b: np.ndarray) -> np.ndarray:
    """View little-endian byte pairs as float16 -> float32."""
    return b.reshape(b.shape[0], -1).view("<f2").astype(np.float32)


def _to_f16_bytes(x: np.ndarray) -> np.ndarray:
    return x.astype("<f2").view(np.uint8)


def _u8(blocks: np.ndarray) -> np.ndarray:
    if blocks.dtype != np.uint8:
        blocks = blocks.view(np.uint8)
    return blocks


def _split(blocks: np.ndarray, *widths: int):
    """Split (n, type_size) bytes into consecutive field columns."""
    out = []
    ofs = 0
    for w in widths:
        out.append(blocks[:, ofs : ofs + w])
        ofs += w
    out.append(blocks[:, ofs:])
    return out


def _unpack_nibbles_16(qs: np.ndarray) -> np.ndarray:
    """GGUF 32-block nibble order: elems 0..15 = low nibbles, 16..31 = high.

    qs: (n, k*16) bytes -> (n, k*32) values, per 16-byte group.
    """
    n = qs.shape[0]
    g = qs.reshape(n, -1, 16)
    return np.concatenate([g & 0x0F, g >> 4], axis=-1).reshape(n, -1)


def _pack_nibbles_16(q: np.ndarray) -> np.ndarray:
    """Inverse of _unpack_nibbles_16. q: (n, k*32) values 0..15."""
    n = q.shape[0]
    g = q.reshape(n, -1, 32).astype(np.uint8)
    return (g[:, :, :16] | (g[:, :, 16:] << 4)).reshape(n, -1)


def _safe_inv(d: np.ndarray) -> np.ndarray:
    with np.errstate(divide="ignore", invalid="ignore"):
        inv = np.where(d != 0.0, 1.0 / np.where(d != 0.0, d, 1.0), 0.0)
    return inv


def _signed_absmax(x: np.ndarray, axis: int = -1) -> np.ndarray:
    """Value with the largest magnitude (keeping its sign) along axis."""
    idx = np.argmax(np.abs(x), axis=axis, keepdims=True)
    return np.take_along_axis(x, idx, axis=axis)


def _nearest_codebook_idx(v: np.ndarray, kvalues: np.ndarray) -> np.ndarray:
    kv = kvalues.astype(np.float32)
    mid = (kv[:-1] + kv[1:]) / 2.0
    return np.searchsorted(mid, v, side="left").astype(np.uint8)


# --------------------------------------------------------------------------
# decode: full precision carriers
# --------------------------------------------------------------------------

def decode_F32(blocks: np.ndarray) -> np.ndarray:
    return _u8(blocks).reshape(blocks.shape[0], -1).view("<f4").astype(np.float32)


def decode_F16(blocks: np.ndarray) -> np.ndarray:
    return _f16(_u8(blocks))


def decode_BF16(blocks: np.ndarray) -> np.ndarray:
    u16 = _u8(blocks).reshape(blocks.shape[0], -1).view("<u2").astype(np.uint32)
    return (u16 << 16).view(np.float32).astype(np.float32)


# --------------------------------------------------------------------------
# component extraction: every quant format decomposes as
#     w = A * (q - zp) + B        (B optional; per-group A/B along the block)
# with integer codes q. This is the single source of truth: full decode
# combines components; the planar re-tiling (quant/planar.py) packs them.
# --------------------------------------------------------------------------

class Components:
    """q: (n, block) small-int codes; scales/offsets: (n, block//gs) f32."""

    __slots__ = ("q", "scales", "offsets", "zero_point", "group_size")

    def __init__(self, q, scales, offsets=None, zero_point=0, group_size=32):
        self.q = q
        self.scales = scales
        self.offsets = offsets
        self.zero_point = zero_point
        self.group_size = group_size

    def combine(self) -> np.ndarray:
        """Bit-exact GGML dequantization from components (all f32 math)."""
        n, block = self.q.shape
        gs = self.group_size
        A = np.repeat(self.scales, gs, axis=1)
        qf = self.q.astype(np.float32)
        if self.zero_point:
            qf = qf - np.float32(self.zero_point)
        w = A * qf
        if self.offsets is not None:
            w = w + np.repeat(self.offsets, gs, axis=1)
        return w


def components_Q8_0(blocks: np.ndarray) -> Components:
    d, qs = _split(_u8(blocks), 2)
    return Components(qs.view(np.int8), _f16(d))


def components_Q4_0(blocks: np.ndarray) -> Components:
    d, qs = _split(_u8(blocks), 2)
    return Components(_unpack_nibbles_16(qs), _f16(d), zero_point=8)


def components_Q4_1(blocks: np.ndarray) -> Components:
    d, m, qs = _split(_u8(blocks), 2, 2)
    return Components(_unpack_nibbles_16(qs), _f16(d), offsets=_f16(m))


def _unpack_qh32(qh_bytes: np.ndarray) -> np.ndarray:
    """(n, 4) bytes = one LE uint32 of per-element high bits -> (n, 32) 0/1."""
    qh = qh_bytes.reshape(qh_bytes.shape[0], 4).view("<u4").astype(np.uint32)
    shifts = np.arange(32, dtype=np.uint32)[None, :]
    return ((qh >> shifts) & 1).astype(np.uint8)


def components_Q5_0(blocks: np.ndarray) -> Components:
    d, qh, qs = _split(_u8(blocks), 2, 4)
    q = _unpack_nibbles_16(qs) | (_unpack_qh32(qh) << 4)
    return Components(q, _f16(d), zero_point=16)


def components_Q5_1(blocks: np.ndarray) -> Components:
    d, m, qh, qs = _split(_u8(blocks), 2, 2, 4)
    q = _unpack_nibbles_16(qs) | (_unpack_qh32(qh) << 4)
    return Components(q, _f16(d), offsets=_f16(m))


def components_IQ4_NL(blocks: np.ndarray) -> Components:
    d, qs = _split(_u8(blocks), 2)
    return Components(IQ4_KVALUES[_unpack_nibbles_16(qs)], _f16(d))


def decode_Q8_0(blocks: np.ndarray) -> np.ndarray:
    return components_Q8_0(blocks).combine()


def decode_Q4_0(blocks: np.ndarray) -> np.ndarray:
    return components_Q4_0(blocks).combine()


def decode_Q4_1(blocks: np.ndarray) -> np.ndarray:
    return components_Q4_1(blocks).combine()


def decode_Q5_0(blocks: np.ndarray) -> np.ndarray:
    return components_Q5_0(blocks).combine()


def decode_Q5_1(blocks: np.ndarray) -> np.ndarray:
    return components_Q5_1(blocks).combine()


def decode_IQ4_NL(blocks: np.ndarray) -> np.ndarray:
    return components_IQ4_NL(blocks).combine()


# --------------------------------------------------------------------------
# decode: K-quants (256-element superblocks)
# --------------------------------------------------------------------------

def _unpack_scale_min_k4(scales12: np.ndarray):
    """Unpack the 12-byte 6-bit scale/min table of Q4_K/Q5_K -> (sc, mn) u8[...,8].

    Layout (llama.cpp): bytes 0-3 carry sc[0..3] low6 (+ sc[4..7] high2 in top
    bits), bytes 4-7 carry mn[0..3] low6 (+ mn[4..7] high2), bytes 8-11 carry
    sc[4..7] low4 | mn[4..7] low4.
    """
    n = scales12.shape[0]
    s = scales12.reshape(n, 12)
    a, b, c = s[:, 0:4], s[:, 4:8], s[:, 8:12]
    sc = np.concatenate([a & 0x3F, (c & 0x0F) | ((a >> 2) & 0x30)], axis=1)
    mn = np.concatenate([b & 0x3F, (c >> 4) | ((b >> 2) & 0x30)], axis=1)
    return sc, mn


def _pack_scale_min_k4(sc: np.ndarray, mn: np.ndarray) -> np.ndarray:
    """Inverse of _unpack_scale_min_k4. sc/mn: (n, 8) values 0..63."""
    sc = sc.astype(np.uint8)
    mn = mn.astype(np.uint8)
    a = (sc[:, 0:4] & 0x3F) | ((sc[:, 4:8] >> 4) << 6)
    b = (mn[:, 0:4] & 0x3F) | ((mn[:, 4:8] >> 4) << 6)
    c = (sc[:, 4:8] & 0x0F) | ((mn[:, 4:8] & 0x0F) << 4)
    return np.concatenate([a, b, c], axis=1)


def components_Q4_K(blocks: np.ndarray) -> Components:
    blocks = _u8(blocks)
    d, dmin, scales, qs = _split(blocks, 2, 2, K_SCALE_SIZE)
    sc, mn = _unpack_scale_min_k4(scales)
    n = blocks.shape[0]
    # qs: 4 groups of 32 bytes; each group -> sub-block 2g (lo), 2g+1 (hi)
    g = qs.reshape(n, 4, 32)
    q = np.concatenate([g & 0x0F, g >> 4], axis=-1).reshape(n, QK_K)
    A = _f16(d) * sc.astype(np.float32)  # (n, 8)
    B = -(_f16(dmin) * mn.astype(np.float32))
    return Components(q, A, offsets=B, group_size=32)


def components_Q5_K(blocks: np.ndarray) -> Components:
    blocks = _u8(blocks)
    d, dmin, scales, qh, qs = _split(blocks, 2, 2, K_SCALE_SIZE, QK_K // 8)
    sc, mn = _unpack_scale_min_k4(scales)
    n = blocks.shape[0]
    g = qs.reshape(n, 4, 32)
    ql = np.concatenate([g & 0x0F, g >> 4], axis=-1).reshape(n, 8, 32)
    shifts = np.arange(8, dtype=np.uint8)[None, :, None]
    hb = (qh.reshape(n, 1, 32) >> shifts) & 1  # (n, 8, 32): bit j -> sub j
    q = (ql | (hb << 4)).reshape(n, QK_K)
    A = _f16(d) * sc.astype(np.float32)
    B = -(_f16(dmin) * mn.astype(np.float32))
    return Components(q, A, offsets=B, group_size=32)


def components_Q6_K(blocks: np.ndarray) -> Components:
    blocks = _u8(blocks)
    ql, qh, scales, d = _split(blocks, QK_K // 2, QK_K // 4, QK_K // 16)
    n = blocks.shape[0]
    sc = scales.view(np.int8).astype(np.float32)  # (n, 16)
    gl = ql.reshape(n, 2, 64)
    lo = np.concatenate([gl & 0x0F, gl >> 4], axis=-1).reshape(n, QK_K)
    gh = qh.reshape(n, 2, 32)
    shifts = np.array([0, 2, 4, 6], dtype=np.uint8)[None, None, :, None]
    hi = ((gh[:, :, None, :] >> shifts) & 0x03).reshape(n, QK_K)
    q = (lo | (hi << 4)).astype(np.int8) - 32
    return Components(q, _f16(d) * sc, group_size=16)


def components_Q3_K(blocks: np.ndarray) -> Components:
    blocks = _u8(blocks)
    hmask, qs, scales, d = _split(blocks, QK_K // 8, QK_K // 4, 12)
    n = blocks.shape[0]
    ls = scales[:, :8]
    hs = scales[:, 8:12]
    lo4 = np.concatenate([ls & 0x0F, ls >> 4], axis=1)  # idx = half*8 + i
    shifts = np.array([0, 2, 4, 6], dtype=np.uint8)[None, :, None]
    hi2 = ((hs[:, None, :] >> shifts) & 0x03).reshape(n, 16)  # idx = s*4 + i
    sc = (lo4 | (hi2 << 4)).astype(np.int8) - 32  # (n, 16)

    gq = qs.reshape(n, 2, 32)
    shifts = np.array([0, 2, 4, 6], dtype=np.uint8)[None, None, :, None]
    ql = ((gq[:, :, None, :] >> shifts) & 0x03).reshape(n, QK_K)
    shifts8 = np.arange(8, dtype=np.uint8)[None, :, None]
    qh = ((hmask[:, None, :] >> shifts8) & 0x01).reshape(n, QK_K)
    q = ql.astype(np.int8) - (((qh ^ 1) << 2)).astype(np.int8)
    return Components(q, _f16(d) * sc.astype(np.float32), group_size=16)


def components_Q2_K(blocks: np.ndarray) -> Components:
    blocks = _u8(blocks)
    scales, qs, d, dmin = _split(blocks, QK_K // 16, QK_K // 4, 2)
    n = blocks.shape[0]
    A = _f16(d) * (scales & 0x0F).astype(np.float32)  # (n, 16)
    B = -(_f16(dmin) * (scales >> 4).astype(np.float32))
    gq = qs.reshape(n, 2, 32)
    shifts = np.array([0, 2, 4, 6], dtype=np.uint8)[None, None, :, None]
    q = ((gq[:, :, None, :] >> shifts) & 0x03).reshape(n, QK_K)
    return Components(q, A, offsets=B, group_size=16)


def components_IQ4_XS(blocks: np.ndarray) -> Components:
    blocks = _u8(blocks)
    d, scales_h, scales_l, qs = _split(blocks, 2, 2, QK_K // 64)
    n = blocks.shape[0]
    sh = scales_h.reshape(n, 2).view("<u2").astype(np.uint32)  # (n, 1)
    shifts2 = (2 * np.arange(8, dtype=np.uint32))[None, :]
    hi2 = ((sh >> shifts2) & 0x03).astype(np.uint8)  # (n, 8)
    # llama.cpp order: sub j low4 = (scales_l[j//2] >> 4*(j&1)) & 0xF
    sl = np.empty((n, 8), dtype=np.uint8)
    sl[:, 0::2] = scales_l & 0x0F
    sl[:, 1::2] = scales_l >> 4
    sc = (sl | (hi2 << 4)).astype(np.int8) - 32  # (n, 8)
    g = qs.reshape(n, 8, 16)
    idx = np.concatenate([g & 0x0F, g >> 4], axis=-1).reshape(n, QK_K)
    A = _f16(d) * sc.astype(np.float32)
    return Components(IQ4_KVALUES[idx], A, group_size=32)


def decode_Q4_K(blocks: np.ndarray) -> np.ndarray:
    return components_Q4_K(blocks).combine()


def decode_Q5_K(blocks: np.ndarray) -> np.ndarray:
    return components_Q5_K(blocks).combine()


def decode_Q6_K(blocks: np.ndarray) -> np.ndarray:
    return components_Q6_K(blocks).combine()


def decode_Q3_K(blocks: np.ndarray) -> np.ndarray:
    return components_Q3_K(blocks).combine()


def decode_Q2_K(blocks: np.ndarray) -> np.ndarray:
    return components_Q2_K(blocks).combine()


def decode_IQ4_XS(blocks: np.ndarray) -> np.ndarray:
    return components_IQ4_XS(blocks).combine()


# --------------------------------------------------------------------------
# encode
# --------------------------------------------------------------------------

def encode_F32(x: np.ndarray) -> np.ndarray:
    return x.astype("<f4").view(np.uint8)


def encode_F16(x: np.ndarray) -> np.ndarray:
    return _to_f16_bytes(x)


def encode_BF16(x: np.ndarray) -> np.ndarray:
    # round-to-nearest-even f32 -> bf16; exp==0xFF (NaN/Inf) must NOT go
    # through the integer rounding trick: a low-mantissa NaN would round
    # to +Inf and 0xFFFFFFFF would wrap the uint32 add to +0.0 — truncate
    # those instead (preserves NaN payload high bits and infinities)
    u = x.astype("<f4").view(np.uint32)
    rounded = ((u + 0x7FFF + ((u >> 16) & 1)) >> 16).astype(np.uint32)
    exp_ones = (u & 0x7F800000) == 0x7F800000
    is_nan = exp_ones & ((u & 0x007FFFFF) != 0)
    # NaN: set the quiet bit so low-payload NaNs don't truncate to Inf;
    # Inf: plain truncation
    special = np.where(is_nan, (u >> 16) | 0x0040, u >> 16)
    out = np.where(exp_ones, special, rounded)
    return out.astype("<u2").view(np.uint8)


def encode_Q8_0(x: np.ndarray) -> np.ndarray:
    x = x.reshape(-1, 32).astype(np.float32)
    amax = np.abs(x).max(axis=-1, keepdims=True)
    d = (amax / 127.0).astype(np.float16).astype(np.float32)
    q = np.clip(np.rint(x * _safe_inv(d)), -127, 127).astype(np.int8)
    return np.concatenate([_to_f16_bytes(d), q.view(np.uint8)], axis=1)


def encode_Q4_0(x: np.ndarray) -> np.ndarray:
    x = x.reshape(-1, 32).astype(np.float32)
    m = _signed_absmax(x)
    d = (m / -8.0).astype(np.float16).astype(np.float32)
    q = np.clip(np.trunc(x * _safe_inv(d) + 8.5), 0, 15).astype(np.uint8)
    return np.concatenate([_to_f16_bytes(d), _pack_nibbles_16(q)], axis=1)


def encode_Q4_1(x: np.ndarray) -> np.ndarray:
    x = x.reshape(-1, 32).astype(np.float32)
    mn = x.min(axis=-1, keepdims=True)
    mx = x.max(axis=-1, keepdims=True)
    d = ((mx - mn) / 15.0).astype(np.float16).astype(np.float32)
    mn16 = mn.astype(np.float16).astype(np.float32)
    q = np.clip(np.trunc((x - mn16) * _safe_inv(d) + 0.5), 0, 15).astype(np.uint8)
    return np.concatenate(
        [_to_f16_bytes(d), _to_f16_bytes(mn16), _pack_nibbles_16(q)], axis=1
    )


def _pack_qh32(hb: np.ndarray) -> np.ndarray:
    """(n, 32) 0/1 -> (n, 4) LE uint32 bytes."""
    shifts = np.arange(32, dtype=np.uint32)[None, :]
    word = (hb.astype(np.uint32) << shifts).sum(axis=1, dtype=np.uint32)
    return word.astype("<u4").view(np.uint8).reshape(-1, 4)


def encode_Q5_0(x: np.ndarray) -> np.ndarray:
    x = x.reshape(-1, 32).astype(np.float32)
    m = _signed_absmax(x)
    d = (m / -16.0).astype(np.float16).astype(np.float32)
    q = np.clip(np.trunc(x * _safe_inv(d) + 16.5), 0, 31).astype(np.uint8)
    return np.concatenate(
        [_to_f16_bytes(d), _pack_qh32(q >> 4), _pack_nibbles_16(q & 0x0F)], axis=1
    )


def encode_Q5_1(x: np.ndarray) -> np.ndarray:
    x = x.reshape(-1, 32).astype(np.float32)
    mn = x.min(axis=-1, keepdims=True)
    mx = x.max(axis=-1, keepdims=True)
    d = ((mx - mn) / 31.0).astype(np.float16).astype(np.float32)
    mn16 = mn.astype(np.float16).astype(np.float32)
    q = np.clip(np.trunc((x - mn16) * _safe_inv(d) + 0.5), 0, 31).astype(np.uint8)
    return np.concatenate(
        [
            _to_f16_bytes(d),
            _to_f16_bytes(mn16),
            _pack_qh32(q >> 4),
            _pack_nibbles_16(q & 0x0F),
        ],
        axis=1,
    )


def encode_IQ4_NL(x: np.ndarray) -> np.ndarray:
    x = x.reshape(-1, 32).astype(np.float32)
    m = _signed_absmax(x)
    d = (m / -127.0).astype(np.float16).astype(np.float32)
    v = x * _safe_inv(d)
    idx = _nearest_codebook_idx(v, IQ4_KVALUES)
    return np.concatenate([_to_f16_bytes(d), _pack_nibbles_16(idx)], axis=1)


def _affine_fit_sub(x: np.ndarray, qmax: int, sc_levels: int):
    """Per-sub-block affine fit: x ~ S*q - M with q in [0, qmax].

    x: (n, subs, sub_len). Returns d, dmin (n,1), sc, mn (n,subs) ints,
    and q (n, subs, sub_len).
    """
    # + 0.0 canonicalizes -0.0 (the reference's C++ codec writes +0.0)
    mn_sub = np.maximum(0.0, -x.min(axis=-1)) + 0.0  # (n, subs)
    rng = x.max(axis=-1) + mn_sub
    s_sub = np.maximum(rng, 0.0) / qmax
    d = s_sub.max(axis=-1, keepdims=True) / sc_levels
    dmin = mn_sub.max(axis=-1, keepdims=True) / sc_levels
    d16 = d.astype(np.float16).astype(np.float32)
    dmin16 = dmin.astype(np.float16).astype(np.float32)
    sc = np.clip(np.rint(s_sub * _safe_inv(d16)), 0, sc_levels).astype(np.uint8)
    mn = np.clip(np.rint(mn_sub * _safe_inv(dmin16)), 0, sc_levels).astype(np.uint8)
    S = d16[:, :, None] * sc[:, :, None].astype(np.float32)
    M = dmin16[:, :, None] * mn[:, :, None].astype(np.float32)
    q = np.clip(np.rint((x + M) * _safe_inv(S)), 0, qmax).astype(np.uint8)
    return d16, dmin16, sc, mn, q


def encode_Q4_K(x: np.ndarray) -> np.ndarray:
    x = x.reshape(-1, 8, 32).astype(np.float32)
    d, dmin, sc, mn, q = _affine_fit_sub(x, 15, 63)
    scales = _pack_scale_min_k4(sc, mn)
    g = q.reshape(-1, 4, 64)
    qs = (g[:, :, :32] | (g[:, :, 32:] << 4)).reshape(-1, 128)
    return np.concatenate([_to_f16_bytes(d), _to_f16_bytes(dmin), scales, qs], axis=1)


def encode_Q5_K(x: np.ndarray) -> np.ndarray:
    x = x.reshape(-1, 8, 32).astype(np.float32)
    d, dmin, sc, mn, q = _affine_fit_sub(x, 31, 63)
    scales = _pack_scale_min_k4(sc, mn)
    ql = q & 0x0F
    g = ql.reshape(-1, 4, 64)
    qs = (g[:, :, :32] | (g[:, :, 32:] << 4)).reshape(-1, 128)
    hb = (q >> 4).astype(np.uint8)  # (n, 8, 32)
    shifts = np.arange(8, dtype=np.uint8)[None, :, None]
    qh = (hb << shifts).sum(axis=1, dtype=np.uint32).astype(np.uint8)  # (n, 32)
    return np.concatenate(
        [_to_f16_bytes(d), _to_f16_bytes(dmin), scales, qh, qs], axis=1
    )


def encode_Q6_K(x: np.ndarray) -> np.ndarray:
    x = x.reshape(-1, 16, 16).astype(np.float32)
    amax = np.abs(x).max(axis=-1)  # (n, 16)
    s_sub = amax / 31.0
    d = s_sub.max(axis=-1, keepdims=True) / 127.0
    d16 = d.astype(np.float16).astype(np.float32)
    sc = np.clip(np.rint(s_sub * _safe_inv(d16)), 0, 127).astype(np.int8)
    S = d16[:, :, None] * sc[:, :, None].astype(np.float32)
    q = (
        np.clip(np.rint(x * _safe_inv(S)), -32, 31).astype(np.int16) + 32
    ).astype(np.uint8)
    qf = q.reshape(-1, 256)
    lo = qf & 0x0F
    gl = lo.reshape(-1, 2, 2, 64)  # (n, half, nibble, byte)
    ql = (gl[:, :, 0, :] | (gl[:, :, 1, :] << 4)).reshape(-1, 128)
    hi = (qf >> 4).reshape(-1, 2, 4, 32)  # (n, half, shift, byte)
    shifts = np.array([0, 2, 4, 6], dtype=np.uint8)[None, None, :, None]
    qh = (hi << shifts).sum(axis=2, dtype=np.uint32).astype(np.uint8).reshape(-1, 64)
    return np.concatenate([ql, qh, sc.view(np.uint8), _to_f16_bytes(d16)], axis=1)


def encode_Q3_K(x: np.ndarray) -> np.ndarray:
    x = x.reshape(-1, 16, 16).astype(np.float32)
    amax = np.abs(x).max(axis=-1)
    s_sub = amax / 4.0
    d = s_sub.max(axis=-1, keepdims=True) / 31.0
    d16 = d.astype(np.float16).astype(np.float32)
    sc = np.clip(np.rint(s_sub * _safe_inv(d16)), 0, 31).astype(np.int8)  # >= 0
    S = d16[:, :, None] * sc[:, :, None].astype(np.float32)
    q = np.clip(np.rint(x * _safe_inv(S)), -4, 3).astype(np.int16) + 4  # 0..7
    qf = q.reshape(-1, 256).astype(np.uint8)
    lo2 = (qf & 0x03).reshape(-1, 2, 4, 32)
    shifts = np.array([0, 2, 4, 6], dtype=np.uint8)[None, None, :, None]
    qs = (lo2 << shifts).sum(axis=2, dtype=np.uint32).astype(np.uint8).reshape(-1, 64)
    hb = (qf >> 2).reshape(-1, 8, 32)  # bit index = elem//32
    shifts8 = np.arange(8, dtype=np.uint8)[None, :, None]
    hmask = (hb << shifts8).sum(axis=1, dtype=np.uint32).astype(np.uint8)  # (n, 32)
    # scales: 16 6-bit values (sc + 32)
    v6 = (sc.astype(np.int16) + 32).astype(np.uint8)  # (n, 16)
    lb = (v6[:, :8] & 0x0F) | ((v6[:, 8:] & 0x0F) << 4)  # (n, 8)
    h2 = (v6 >> 4).reshape(-1, 4, 4)  # idx = s*4 + i
    shifts4 = np.array([0, 2, 4, 6], dtype=np.uint8)[None, :, None]
    hbytes = (h2 << shifts4).sum(axis=1, dtype=np.uint32).astype(np.uint8)  # (n, 4)
    scales = np.concatenate([lb, hbytes], axis=1)
    return np.concatenate([hmask, qs, scales, _to_f16_bytes(d16)], axis=1)


def encode_Q2_K(x: np.ndarray) -> np.ndarray:
    x = x.reshape(-1, 16, 16).astype(np.float32)
    d16, dmin16, sc, mn, q = _affine_fit_sub(x, 3, 15)
    scales = (sc | (mn << 4)).astype(np.uint8)  # (n, 16)
    lo2 = q.reshape(-1, 256).astype(np.uint8).reshape(-1, 2, 4, 32)
    shifts = np.array([0, 2, 4, 6], dtype=np.uint8)[None, None, :, None]
    qs = (lo2 << shifts).sum(axis=2, dtype=np.uint32).astype(np.uint8).reshape(-1, 64)
    return np.concatenate(
        [scales, qs, _to_f16_bytes(d16), _to_f16_bytes(dmin16)], axis=1
    )


def encode_IQ4_XS(x: np.ndarray) -> np.ndarray:
    x = x.reshape(-1, 8, 32).astype(np.float32)
    amax = np.abs(x).max(axis=-1)  # (n, 8)
    t_sub = amax / 113.0
    d = t_sub.max(axis=-1, keepdims=True) / 31.0
    d16 = d.astype(np.float16).astype(np.float32)
    sc6 = np.clip(np.rint(t_sub * _safe_inv(d16)), 0, 31).astype(np.uint8) + 32
    dl = d16[:, :, None] * (sc6.astype(np.float32) - 32.0)[:, :, None]
    v = x * _safe_inv(dl)
    idx = _nearest_codebook_idx(v, IQ4_KVALUES)  # (n, 8, 32)
    qs = (idx[:, :, :16] | (idx[:, :, 16:] << 4)).reshape(-1, 128)
    sl = (sc6 & 0x0F).astype(np.uint8)
    scales_l = (sl[:, 0::2] | (sl[:, 1::2] << 4)).astype(np.uint8)  # (n, 4)
    hi2 = (sc6 >> 4).astype(np.uint32)  # (n, 8)
    shifts2 = (2 * np.arange(8, dtype=np.uint32))[None, :]
    sh = (hi2 << shifts2).sum(axis=1, dtype=np.uint32).astype("<u2")
    scales_h = sh.view(np.uint8).reshape(-1, 2)
    return np.concatenate([_to_f16_bytes(d16), scales_h, scales_l, qs], axis=1)


# --------------------------------------------------------------------------
# registries / public API
# --------------------------------------------------------------------------

COMPONENT_EXTRACTORS = {
    Q.Q8_0: components_Q8_0,
    Q.Q4_0: components_Q4_0,
    Q.Q4_1: components_Q4_1,
    Q.Q5_0: components_Q5_0,
    Q.Q5_1: components_Q5_1,
    Q.Q2_K: components_Q2_K,
    Q.Q3_K: components_Q3_K,
    Q.Q4_K: components_Q4_K,
    Q.Q5_K: components_Q5_K,
    Q.Q6_K: components_Q6_K,
    Q.IQ4_NL: components_IQ4_NL,
    Q.IQ4_XS: components_IQ4_XS,
}

_SCALAR_VIEWS = {Q.I8: "<i1", Q.I16: "<i2", Q.I32: "<i4",
                 Q.I64: "<i8", Q.F64: "<f8"}


def decode_Q8_1(blocks: np.ndarray) -> np.ndarray:
    """36-byte block: d (f16), s (f16, = d·Σq, dot-product cache only),
    32 int8 quants; dequant is d·q (llama.cpp block_q8_1)."""
    d = blocks[:, :2].copy().view("<f2").astype(np.float32)
    qs = blocks[:, 4:].copy().view(np.int8).astype(np.float32)
    return d * qs


DECODERS = {
    Q.F32: decode_F32,
    Q.F16: decode_F16,
    Q.BF16: decode_BF16,
    Q.Q8_1: decode_Q8_1,
    Q.Q8_0: decode_Q8_0,
    Q.Q4_0: decode_Q4_0,
    Q.Q4_1: decode_Q4_1,
    Q.Q5_0: decode_Q5_0,
    Q.Q5_1: decode_Q5_1,
    Q.Q2_K: decode_Q2_K,
    Q.Q3_K: decode_Q3_K,
    Q.Q4_K: decode_Q4_K,
    Q.Q5_K: decode_Q5_K,
    Q.Q6_K: decode_Q6_K,
    Q.IQ4_NL: decode_IQ4_NL,
    Q.IQ4_XS: decode_IQ4_XS,
}

ENCODERS = {
    Q.F32: encode_F32,
    Q.F16: encode_F16,
    Q.BF16: encode_BF16,
    Q.Q8_0: encode_Q8_0,
    Q.Q4_0: encode_Q4_0,
    Q.Q4_1: encode_Q4_1,
    Q.Q5_0: encode_Q5_0,
    Q.Q5_1: encode_Q5_1,
    Q.Q2_K: encode_Q2_K,
    Q.Q3_K: encode_Q3_K,
    Q.Q4_K: encode_Q4_K,
    Q.Q5_K: encode_Q5_K,
    Q.Q6_K: encode_Q6_K,
    Q.IQ4_NL: encode_IQ4_NL,
    Q.IQ4_XS: encode_IQ4_XS,
}


# llama.cpp importance-matrix ("IQ") formats whose decode requires the
# large constant codebook tables compiled into llama.cpp (iq1s_grid:
# 2048×u64, iq2xxs_grid: 256×u64, iq2xs_grid: 512×u64, iq2s_grid:
# 1024×u64, iq3xxs_grid: 256×u32, iq3s_grid: 512×u32, plus the shared
# ksigns_iq2xs 128×u8 sign LUT). Those tables are NOT derivable from the
# block layout and are present neither in the reference snapshot nor in
# this environment (no `gguf` pkg, no llama.cpp checkout — the reference
# decodes these via its gguf-pkg fallback, reference dequant.py:26-28).
# The formats stay load-blocked with an actionable error until a decoder
# is dropped in through register_decoder() below; the skipped golden
# test tests/test_codecs.py::test_iq_codebook_golden documents the
# expected table shapes, and test_register_decoder_seam exercises the
# registration contract.
CODEBOOK_BLOCKED = frozenset({
    Q.IQ1_S, Q.IQ1_M, Q.IQ2_XXS, Q.IQ2_XS, Q.IQ2_S, Q.IQ3_XXS, Q.IQ3_S,
})


class MissingCodebookError(NotImplementedError):
    """An IQ1/IQ2/IQ3 tensor was encountered but the llama.cpp codebook
    grid tables needed to decode it aren't registered."""


def can_decode(qtype: GGMLQuantizationType) -> bool:
    """True if `dequantize` can handle this qtype (block decoder or
    scalar view)."""
    qtype = GGMLQuantizationType(qtype)
    return qtype in DECODERS or qtype in _SCALAR_VIEWS


def require_decoder(qtype: GGMLQuantizationType, context: str = ""):
    """DECODERS lookup with an actionable failure instead of a KeyError.

    context: optional 'tensor blk.0.ffn_up.weight'-style suffix naming
    what triggered the lookup.
    """
    qtype = GGMLQuantizationType(qtype)
    dec = DECODERS.get(qtype)
    if dec is not None:
        return dec
    where = f" ({context})" if context else ""
    if qtype in CODEBOOK_BLOCKED:
        raise MissingCodebookError(
            f"cannot decode {qtype.name}{where}: this llama.cpp "
            "importance-matrix format needs the codebook grid tables "
            "compiled into llama.cpp (iq*_grid / ksigns_iq2xs), which "
            "are not bundled here. Workarounds: (a) requantize the "
            "checkpoint from a higher-precision GGUF (F16/Q8_0/Q4_K...) "
            "with tools/quantize.py, or (b) obtain the grid tables and "
            "register a decoder via "
            "comfyui_gguf_tpu_torch.quant.codecs.register_decoder().")
    raise NotImplementedError(
        f"no decoder for GGUF quantization type {qtype.name}{where}")


def register_decoder(qtype: GGMLQuantizationType, decode,
                     components=None, encode=None) -> None:
    """Registration seam for decoders this build can't bundle (the
    codebook-blocked IQ formats above, or future GGUF additions).

    decode(blocks: uint8 (n_blocks, type_size)) -> float32
    (n_blocks, block_elems); components (optional) additionally exposes
    the planar A/B/q decomposition used by the fused kernels —
    without it the format loads through eager dequant only.
    """
    qtype = GGMLQuantizationType(qtype)
    DECODERS[qtype] = decode
    if components is not None:
        COMPONENT_EXTRACTORS[qtype] = components
    if encode is not None:
        ENCODERS[qtype] = encode


def dequantize(data: np.ndarray, qtype: GGMLQuantizationType,
               shape: tuple[int, ...]) -> np.ndarray:
    """Raw packed bytes -> float32 array of logical ``shape``.

    Host-side equivalent of reference dequant.py:30-44.
    """
    qtype = GGMLQuantizationType(qtype)
    if qtype == Q.F32:
        return np.ascontiguousarray(data).view("<f4").reshape(shape).astype(np.float32)
    if qtype == Q.F16:
        return (
            np.ascontiguousarray(data).view("<f2").reshape(shape).astype(np.float32)
        )
    if qtype in _SCALAR_VIEWS:  # exotic GGUF scalar payloads (token maps
        # etc.) the reference covers via its gguf-pkg fallback
        return (np.ascontiguousarray(data).view(_SCALAR_VIEWS[qtype])
                .reshape(shape).astype(np.float32))
    block, type_size = GGML_QUANT_SIZES[qtype]
    raw = np.ascontiguousarray(data).view(np.uint8).reshape(-1, type_size)
    out = require_decoder(qtype)(raw)
    return out.reshape(shape)


def quantize(x: np.ndarray, qtype: GGMLQuantizationType) -> np.ndarray:
    """float array -> packed GGUF payload bytes (n_blocks, type_size)."""
    qtype = GGMLQuantizationType(qtype)
    enc = ENCODERS.get(qtype)
    if enc is None:
        raise NotImplementedError(f"no encoder for {qtype.name}")
    block, type_size = GGML_QUANT_SIZES[qtype]
    n = x.size
    if n % block != 0:
        raise ValueError(f"{n} elements not divisible by block {block} ({qtype.name})")
    out = enc(np.ascontiguousarray(x, dtype=np.float32).reshape(-1))
    return out.reshape(-1, type_size)
