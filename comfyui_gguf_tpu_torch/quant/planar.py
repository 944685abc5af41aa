"""Planar re-tiling of GGML quantized tensors (PyTorch port).

Port of ``comfyui_gguf_tpu/quant/planar.py``. Every 2-D quantized weight is
re-tiled once at load into a structure-of-arrays form:

    w[k, r] = scales[k // gs, r] * (q[k, r] - zero_point) + offsets[k // gs, r]

This slice keeps the reference package's byte layout exactly, so weights
carry across as a copy and the CUDA kernels are checked against the same
bytes as the Pallas kernels:

  * stored **K-major**: ``qs`` is (K-rows, Rp), out-features R padded to a
    multiple of 128 (sometimes a little more, see ``_components_to_planar``);
  * K padded to a multiple of 512 with zero-scale pad codes;
  * ``nib4``: 4-bit codes two per byte with a **global split along K** —
    ``qs[j, r]`` holds the code for k=j in its low nibble and k=j+Kp/2 in its
    high nibble;
  * ``int8``: one zero-point-folded int8 code per element;
  * scale and offset planes in float32, or in bfloat16 on request
    (``scale_dtype``): every consumer widens them to float32 exactly and
    runs the same float32 arithmetic.

A layout shaped for Hopper (n-major tiles, interleaved scales) is a later
change; the kernels here read this one.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from ..gguf.constants import GGMLQuantizationType
from . import codecs

Q = GGMLQuantizationType

# formats whose codes fit in a nibble and keep a packed 4-bit plane
_NIB4_TYPES = frozenset({Q.Q4_0, Q.Q4_1, Q.Q4_K, Q.Q2_K})

# out-feature padding granularity of the shared layout
LANE = 128


def _lcm(a: int, b: int) -> int:
    return a * b // math.gcd(a, b)


def _best_tile(total: int, align: int, cap: int) -> int | None:
    """Largest divisor of ``total`` that is a multiple of ``align`` and
    ≤ ``cap``."""
    best = None
    for d in range(align, min(total, cap) + 1, align):
        if total % d == 0:
            best = d
    return best


def _pad_for_deep_tiles(base: int, step: int, tile_of, target: int) -> int:
    """Smallest ``base + i·step`` (i ≥ 0, ≤6.25% over ``base``) whose
    best tile per ``tile_of`` reaches ``target``; ``base`` if none does."""
    cand = base
    while cand <= base + base // 16:
        if tile_of(cand) >= target:
            return cand
        cand += step
    return base


@dataclasses.dataclass(frozen=True)
class PlanarQuant:
    """Packed quantized 2-D weight in planar K-major layout.

    ``shape`` is the LOGICAL torch-order weight shape (out=R, in=K); tensor
    fields are stored transposed with R padded. Fields may carry a leading
    depth axis (a depth-stacked group); ``self[i]`` is block i as views.
    """

    qs: torch.Tensor  # nib4: (Kp//2, Rp) uint8 | int8: (Kp, Rp) int8
    scales: torch.Tensor  # (Kp//gs, Rp) float32 or bfloat16
    offsets: torch.Tensor | None  # (Kp//gs, Rp) as scales, or None
    qtype: int
    layout: str  # "nib4" | "int8"
    group_size: int
    zero_point: int
    shape: tuple[int, int]  # logical (R, K)

    @property
    def out_features(self) -> int:
        return self.shape[0]

    @property
    def in_features(self) -> int:
        return self.shape[1]

    @property
    def padded_out(self) -> int:
        return self.qs.shape[-1]

    @property
    def padded_in(self) -> int:
        return self.qs.shape[-2] * (2 if self.layout == "nib4" else 1)

    @property
    def nbytes_packed(self) -> int:
        n = self.qs.numel() * self.qs.element_size()
        n += self.scales.numel() * self.scales.element_size()
        if self.offsets is not None:
            n += self.offsets.numel() * self.offsets.element_size()
        return n

    def __getitem__(self, i: int) -> "PlanarQuant":
        """Depth slice i of a stacked weight: views, no copy."""
        return dataclasses.replace(
            self, qs=self.qs[i], scales=self.scales[i],
            offsets=None if self.offsets is None else self.offsets[i])

    def to(self, device) -> "PlanarQuant":
        return dataclasses.replace(
            self, qs=self.qs.to(device), scales=self.scales.to(device),
            offsets=None if self.offsets is None else self.offsets.to(device))


def planarize(data: np.ndarray, qtype: GGMLQuantizationType,
              shape: tuple[int, int], device="cpu",
              scale_dtype=torch.float32) -> PlanarQuant:
    """Re-tile raw GGUF packed blocks into PlanarQuant (host-side, one-time).

    data: (n_blocks, type_size) uint8 (as produced by gguf.reader).
    shape: logical (out=R, in=K) weight shape.
    scale_dtype: float32, or bfloat16 to halve the scale and offset bytes
    (Q4_K drops from 0.75 to 0.625 bytes a weight; the ~2^-9 relative
    rounding of a scale sits far below the quantization noise).
    """
    qtype = GGMLQuantizationType(qtype)
    if len(shape) != 2:
        raise ValueError(f"planarize needs 2-D logical shape, got {shape}")
    R, K = int(shape[0]), int(shape[1])
    comp = codecs.COMPONENT_EXTRACTORS[qtype](np.ascontiguousarray(data))
    out = _components_to_planar(comp.q, comp.scales, comp.offsets, qtype,
                                comp.zero_point, comp.group_size, (R, K),
                                scale_dtype=scale_dtype)
    return out.to(device)


def _components_to_planar(q, scales, offsets, qtype, zero_point, gs,
                          shape, scale_dtype=torch.float32) -> PlanarQuant:
    """Assemble a PlanarQuant (CPU tensors) from extracted components.

    K is padded up to a multiple of 512 (zero-contribution pad codes, zero
    scales), then K and R are padded within a ≤6.25% byte-waste cap to
    sizes with deep tile divisors — the reference package's rule, kept so
    both packages hold identical bytes. Pad codes dequantize to exactly 0;
    pad output columns are never returned. The scale and offset planes are
    rounded once from float32 to ``scale_dtype`` (round to nearest even).
    """
    if scale_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"scale_dtype must be float32 or bfloat16, got "
                         f"{scale_dtype}")
    R, K = shape
    kp = _pad_for_deep_tiles(
        -(-K // 512) * 512, 512,
        lambda kpc: _best_tile(
            kpc // (2 if qtype in _NIB4_TYPES else 1),
            _lcm(128, 8 * gs), 1536) or 0,
        target=512)
    if kp != K:
        q = q.reshape(R, K)
        qpad = np.full((R, kp - K), zero_point, dtype=q.dtype)
        q = np.concatenate([q, qpad], axis=1)
        scales = np.concatenate(
            [scales.reshape(R, K // gs),
             np.zeros((R, (kp - K) // gs), dtype=np.float32)], axis=1)
        if offsets is not None:
            offsets = np.concatenate(
                [offsets.reshape(R, K // gs),
                 np.zeros((R, (kp - K) // gs), dtype=np.float32)], axis=1)
        K = kp
    rp = _pad_for_deep_tiles(
        -(-R // LANE) * LANE, LANE,
        lambda rpc: _best_tile(rpc, LANE, 512) or 0, target=384)
    pad = rp - R
    scales_t = np.pad(scales.reshape(R, K // gs).T, ((0, 0), (0, pad)))
    offsets_t = (None if offsets is None
                 else np.pad(offsets.reshape(R, K // gs).T,
                             ((0, 0), (0, pad))))
    if qtype in _NIB4_TYPES:
        qt = q.reshape(R, K).astype(np.uint8).T
        packed = qt[: K // 2] | (qt[K // 2:] << 4)
        qs = np.pad(packed, ((0, 0), (0, pad)))
        layout, zp = "nib4", zero_point
    else:
        qi = q.reshape(R, K).astype(np.int16) - int(zero_point)
        if qi.min(initial=0) < -128 or qi.max(initial=0) > 127:
            raise ValueError(f"{qtype!r}: codes out of int8 range")
        qs = np.pad(qi.astype(np.int8).T, ((0, 0), (0, pad)))
        layout, zp = "int8", 0
    return PlanarQuant(
        qs=torch.from_numpy(np.ascontiguousarray(qs)),
        scales=torch.from_numpy(
            np.ascontiguousarray(scales_t, dtype=np.float32)).to(scale_dtype),
        offsets=(None if offsets_t is None else torch.from_numpy(
            np.ascontiguousarray(offsets_t, dtype=np.float32)).to(
                scale_dtype)),
        qtype=int(qtype), layout=layout, group_size=gs, zero_point=zp,
        shape=(R, shape[1]),
    )


def unpack_codes(p: PlanarQuant) -> torch.Tensor:
    """Integer codes in logical order, shape (Kp, Rp)."""
    if p.layout == "nib4":
        return torch.cat([p.qs & 0x0F, p.qs >> 4], dim=-2)
    return p.qs


def dequantize_padded(p: PlanarQuant) -> torch.Tensor:
    """Dense float32 (…, Kp, Rp) in the padded domain (pad codes have zero
    scales and dequantize to exactly 0)."""
    q = unpack_codes(p).to(torch.float32)
    if p.zero_point:
        q = q - float(p.zero_point)
    gs = p.group_size
    w = p.scales.to(torch.float32).repeat_interleave(gs, dim=-2) * q
    if p.offsets is not None:
        w = w + p.offsets.to(torch.float32).repeat_interleave(gs, dim=-2)
    return w


def dequantize_kmajor(p: PlanarQuant, dtype=torch.float32) -> torch.Tensor:
    """Dense (K, R) weight (i.e. W^T), logical R and K (un-padded).

    Bit-identical (in float32) to codecs.dequantize of the original blocks.
    """
    w = dequantize_padded(p)
    return w[..., : p.in_features, : p.out_features].to(dtype)


def dequantize(p: PlanarQuant, dtype=torch.float32) -> torch.Tensor:
    """Dense logical torch-order (out=R, in=K) weight."""
    return dequantize_kmajor(p, dtype).transpose(-1, -2)
