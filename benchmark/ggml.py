"""GGUF block formats, as the files store them: the benchmark's own encoder
(weights are made from the seed at the format's byte layout) and the plain
decoders the references read those bytes back with.

Q4_K: superblocks of 256 weights, 144 bytes: d (f16), dmin (f16), 12 bytes
of 6-bit (scale, min) pairs for eight 32-weight sub-blocks, 128 bytes of
4-bit codes; w = d * sc * q - dmin * m. Q8_0: blocks of 32 weights, 34
bytes: d (f16) and 32 int8 codes; w = d * q. The layouts are llama.cpp's.

Plain torch on any device; imports nothing of the program under test.
"""

from __future__ import annotations

import torch

# format -> (weights per block, bytes per block)
BLOCK = {"Q4_K": (256, 144), "Q8_0": (32, 34)}
# bytes per element of the formats stored as plain arrays
PLAIN = {"F32": 4, "F16": 2, "BF16": 2}


def nbytes(fmt: str, numel: int) -> int:
    """Bytes of ``numel`` weights stored in ``fmt``."""
    if fmt in PLAIN:
        return PLAIN[fmt] * numel
    per, size = BLOCK[fmt]
    if numel % per:
        raise ValueError(f"{numel} weights do not tile {fmt} blocks")
    return numel // per * size


def _f16_bytes(x: torch.Tensor) -> torch.Tensor:
    """(n,) float -> (n, 2) little-endian f16 bytes."""
    return x.to(torch.float16).reshape(-1, 1).view(torch.uint8)


def _bytes_f16(b: torch.Tensor) -> torch.Tensor:
    """(n, 2) uint8 -> (n,) float32."""
    return b.contiguous().view(torch.float16).reshape(-1).to(torch.float32)


def encode_q4_k(w: torch.Tensor) -> torch.Tensor:
    """(..., K) float, K a multiple of 256 -> (n_blocks, 144) uint8, blocks
    in row-major order. Each 32-weight sub-block spans [min(w, 0), max(w)]
    in 15 steps; the superblock's d and dmin are the largest sub-block
    scale and offset over 63, rounded to f16."""
    x = w.reshape(-1, 8, 32).to(torch.float32)
    n = x.shape[0]
    lo = x.amin(dim=-1).clamp(max=0.0)
    hi = x.amax(dim=-1)
    scale = (hi - lo) / 15.0  # (n, 8)
    offset = -lo
    d = (scale.amax(dim=-1) / 63.0).to(torch.float16).to(torch.float32)
    dmin = (offset.amax(dim=-1) / 63.0).to(torch.float16).to(torch.float32)
    sc = torch.where(d[:, None] > 0, scale / d[:, None].clamp(min=1e-30),
                     torch.zeros_like(scale)).round().clamp(0, 63)
    m = torch.where(dmin[:, None] > 0,
                    offset / dmin[:, None].clamp(min=1e-30),
                    torch.zeros_like(offset)).round().clamp(0, 63)
    step = (d[:, None] * sc)[..., None]  # (n, 8, 1)
    base = (dmin[:, None] * m)[..., None]
    q = torch.where(step > 0, (x + base) / step.clamp(min=1e-30),
                    torch.zeros_like(x)).round().clamp(0, 15)
    q = q.to(torch.uint8).reshape(n, 4, 2, 32)
    qs = (q[:, :, 0] | (q[:, :, 1] << 4)).reshape(n, 128)
    sc = sc.to(torch.uint8)
    m = m.to(torch.uint8)
    a = (sc[:, :4] & 0x3F) | ((sc[:, 4:] >> 4) << 6)
    b = (m[:, :4] & 0x3F) | ((m[:, 4:] >> 4) << 6)
    c = (sc[:, 4:] & 0x0F) | ((m[:, 4:] & 0x0F) << 4)
    return torch.cat([_f16_bytes(d), _f16_bytes(dmin), a, b, c, qs], dim=1)


def decode_q4_k(blocks: torch.Tensor) -> torch.Tensor:
    """(n_blocks, 144) uint8 -> (n_blocks * 256,) float32."""
    blocks = blocks.reshape(-1, 144)
    n = blocks.shape[0]
    d = _bytes_f16(blocks[:, 0:2])
    dmin = _bytes_f16(blocks[:, 2:4])
    s = blocks[:, 4:16].to(torch.int32)
    a, b, c = s[:, 0:4], s[:, 4:8], s[:, 8:12]
    sc = torch.cat([a & 0x3F, (c & 0x0F) | ((a >> 6) << 4)], dim=1)
    m = torch.cat([b & 0x3F, (c >> 4) | ((b >> 6) << 4)], dim=1)
    g = blocks[:, 16:].to(torch.int32).reshape(n, 4, 32)
    q = torch.stack([g & 0x0F, g >> 4], dim=2).reshape(n, 8, 32)
    w = (d[:, None, None] * sc[..., None].to(torch.float32)
         * q.to(torch.float32)
         - (dmin[:, None] * m.to(torch.float32))[..., None])
    return w.reshape(-1)


def encode_q8_0(w: torch.Tensor) -> torch.Tensor:
    """(..., K) float, K a multiple of 32 -> (n_blocks, 34) uint8."""
    x = w.reshape(-1, 32).to(torch.float32)
    d = (x.abs().amax(dim=-1) / 127.0).to(torch.float16).to(torch.float32)
    q = torch.where(d[:, None] > 0, x / d[:, None].clamp(min=1e-30),
                    torch.zeros_like(x)).round().clamp(-127, 127)
    return torch.cat([_f16_bytes(d), q.to(torch.int8).view(torch.uint8)],
                     dim=1)


def decode_q8_0(blocks: torch.Tensor) -> torch.Tensor:
    """(n_blocks, 34) uint8 -> (n_blocks * 32,) float32."""
    blocks = blocks.reshape(-1, 34)
    d = _bytes_f16(blocks[:, 0:2])
    q = blocks[:, 2:].contiguous().view(torch.int8).to(torch.float32)
    return (d[:, None] * q).reshape(-1)


ENCODE = {"Q4_K": encode_q4_k, "Q8_0": encode_q8_0}
DECODE = {"Q4_K": decode_q4_k, "Q8_0": decode_q8_0}


def decode(fmt: str, data: torch.Tensor, shape) -> torch.Tensor:
    """Stored bytes or values of ``fmt`` -> float32 tensor of ``shape``."""
    if fmt in DECODE:
        return DECODE[fmt](data).reshape(shape)
    return data.to(torch.float32).reshape(shape)
