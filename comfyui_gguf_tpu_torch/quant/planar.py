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

from .. import native
from ..gguf.constants import GGMLQuantizationType
from ..observability import span
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


def padded_in_dim(K: int, qtype, gs: int) -> int:
    """Kp of a planar weight with K in-features: a multiple of 512, then up
    to 6.25% more where that gives the code plane deeper k tiles."""
    return _pad_for_deep_tiles(
        -(-K // 512) * 512, 512,
        lambda kpc: _best_tile(
            kpc // (2 if qtype in _NIB4_TYPES else 1),
            _lcm(128, 8 * gs), 1536) or 0,
        target=512)


def padded_out_dim(R: int) -> int:
    """Rp of a planar weight with R out-features: a multiple of ``LANE``,
    then up to 6.25% more where that gives deeper r tiles."""
    return _pad_for_deep_tiles(
        -(-R // LANE) * LANE, LANE,
        lambda rpc: _best_tile(rpc, LANE, 512) or 0, target=384)


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
    comp = _extract(data, qtype)
    out = _components_to_planar(comp.q, comp.scales, comp.offsets, qtype,
                                comp.zero_point, comp.group_size, (R, K),
                                scale_dtype=scale_dtype)
    with span("loader.copy", out.nbytes_packed):
        return out.to(device)


def _extract(data: np.ndarray, qtype) -> codecs.Components:
    """The stored blocks' codes, scales and offsets (span
    ``loader.decode``, the stored bytes)."""
    with span("loader.decode", data.nbytes):
        return codecs.COMPONENT_EXTRACTORS[qtype](np.ascontiguousarray(data))


def nib4_plane(q: np.ndarray, rp: int) -> np.ndarray:
    """(R, K) codes → the (K/2, rp) nib4 plane, zero lanes past R: the
    numpy version of ``native.pack_nib4_planar``."""
    R, K = q.shape
    qt = q.astype(np.uint8).T
    packed = qt[: K // 2] | (qt[K // 2:] << 4)
    return np.pad(packed, ((0, 0), (0, rp - R)))


def int8_plane(q: np.ndarray, rp: int) -> np.ndarray:
    """(R, K) int8 codes → the (K, rp) plane, zero lanes past R: the numpy
    version of ``native.transpose_i8``."""
    return np.pad(q.T, ((0, 0), (0, rp - q.shape[0])))


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
    with span("loader.pack"):
        return _pack(q, scales, offsets, qtype, zero_point, gs, shape,
                     scale_dtype)


def _pack(q, scales, offsets, qtype, zero_point, gs, shape,
          scale_dtype) -> PlanarQuant:
    R, K = shape
    kp = padded_in_dim(K, qtype, gs)
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
    rp = padded_out_dim(R)
    pad = rp - R
    scales_t = np.pad(scales.reshape(R, K // gs).T, ((0, 0), (0, pad)))
    offsets_t = (None if offsets is None
                 else np.pad(offsets.reshape(R, K // gs).T,
                             ((0, 0), (0, pad))))
    # the (R, K) -> (K, R) byte transposes run on the host codec library
    if qtype in _NIB4_TYPES:
        qs = native.pack_nib4_planar(q.reshape(R, K), rp)
        layout, zp = "nib4", zero_point
    else:
        qi = q.reshape(R, K).astype(np.int16) - int(zero_point)
        if qi.min(initial=0) < -128 or qi.max(initial=0) > 127:
            raise ValueError(f"{qtype!r}: codes out of int8 range")
        qs = native.transpose_i8(qi.astype(np.int8), rp)
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


# ---------------------------------------------------------------------------
# tensor-parallel shards
# ---------------------------------------------------------------------------

def _shard_index_sets(total: int, n_shards: int, groups, gran: int,
                      what: str) -> list[np.ndarray]:
    """Per-shard index arrays along a split axis.

    ``groups``: segment lengths summing to ``total`` (e.g. a fused qkv's
    head groups). Each segment splits uniformly and shard s takes the s-th
    slice of every segment, so a head-uniform split of a fused [q|k|v]
    weight gives each shard its own heads of all three. Per-shard slices
    must align to ``gran`` (the quant group size along K; 1 along R).
    """
    groups = [total] if groups is None else list(groups)
    if sum(groups) != total:
        raise ValueError(f"groups {groups} don't sum to {what}={total}")
    idx: list[list[int]] = [[] for _ in range(n_shards)]
    base = 0
    for g in groups:
        if g % n_shards:
            raise ValueError(f"segment {g} not divisible by {n_shards}")
        per = g // n_shards
        if per % gran:
            raise ValueError(
                f"per-shard slice {per} not a multiple of granularity "
                f"{gran} ({what} split)")
        for s in range(n_shards):
            idx[s].extend(range(base + s * per, base + (s + 1) * per))
        base += g
    return [np.asarray(i, dtype=np.int64) for i in idx]


def _stack_shards(shards: list[PlanarQuant], dim: int = 0) -> PlanarQuant:
    """PlanarQuants of one shape stacked along a new leading axis ``dim``
    of every field."""
    first = shards[0]
    return dataclasses.replace(
        first, qs=torch.stack([s.qs for s in shards], dim),
        scales=torch.stack([s.scales for s in shards], dim),
        offsets=(None if first.offsets is None
                 else torch.stack([s.offsets for s in shards], dim)))


def planarize_shards(data: np.ndarray, qtype: GGMLQuantizationType,
                     shape: tuple[int, int], n_shards: int, axis: str = "r",
                     groups=None) -> PlanarQuant:
    """Shard-aware re-tiling for tensor parallelism: ONE PlanarQuant whose
    fields lead with the shard axis (n_shards, ...); ``shard_view(p, s)``
    is shard s.

    * ``axis="r"`` (column parallel): out-features split, each shard
      lane-padded on its own.
    * ``axis="k"`` (row parallel): in-features split, each chunk re-tiled on
      its own (the nib4 global K split pairs rows j and j+Kp/2 in one byte,
      which must not straddle shards).

    The split happens on the extracted components (codes and per-group
    scales), so a K cut needs only quant-group alignment (16/32), not the
    256-element superblock; each chunk re-pads K to 512 itself.
    ``groups``: segment lengths along the split axis of a fused weight;
    shard s takes the s-th uniform slice of every segment.
    """
    qtype = GGMLQuantizationType(qtype)
    R, K = int(shape[0]), int(shape[1])
    comp = _extract(data, qtype)
    gs = comp.group_size
    q = comp.q.reshape(R, K)
    scales = comp.scales.reshape(R, K // gs)
    offsets = (None if comp.offsets is None
               else comp.offsets.reshape(R, K // gs))
    shards = []
    if axis == "r":
        for ridx in _shard_index_sets(R, n_shards, groups, 1, "R"):
            shards.append(_components_to_planar(
                q[ridx], scales[ridx],
                None if offsets is None else offsets[ridx],
                qtype, comp.zero_point, gs, (len(ridx), K)))
    elif axis == "k":
        for kidx in _shard_index_sets(K, n_shards, groups, gs, "K"):
            gidx = kidx[::gs] // gs  # the scale planes' group rows
            shards.append(_components_to_planar(
                np.ascontiguousarray(q[:, kidx]), scales[:, gidx],
                None if offsets is None else offsets[:, gidx],
                qtype, comp.zero_point, gs, (R, len(kidx))))
    else:
        raise ValueError(f"axis must be 'r' or 'k', got {axis!r}")
    return _stack_shards(shards)


def _assemble_kmajor(q, scales, offsets, p: PlanarQuant,
                     shape: tuple[int, int]) -> PlanarQuant:
    """A PlanarQuant from logical-domain K-major components on any device:
    ``q`` (…, K, R) codes as stored (nib4 raw, int8 zero-point folded),
    ``scales`` / ``offsets`` (…, K/gs, R). The padding and packing rules of
    ``_components_to_planar``, in torch."""
    R, K = shape
    gs = p.group_size
    kp, rp = padded_in_dim(K, p.qtype, gs), padded_out_dim(R)
    pad_code = p.zero_point if p.layout == "nib4" else 0
    q = _pad_const(q, (0, 0, 0, kp - K), pad_code)
    q = _pad_const(q, (0, rp - R, 0, 0), 0)

    def plane(t):
        return None if t is None else _pad_const(
            t, (0, rp - R, 0, (kp - K) // gs), 0)

    if p.layout == "nib4":
        qs = q[..., : kp // 2, :] | (q[..., kp // 2:, :] << 4)
    else:
        qs = q
    return dataclasses.replace(
        p, qs=qs.contiguous(), scales=plane(scales).contiguous(),
        offsets=(None if offsets is None else plane(offsets).contiguous()),
        shape=(R, K))


def _pad_const(t: torch.Tensor, pad, value) -> torch.Tensor:
    """``torch.nn.functional.pad`` with a constant, for integer tensors
    too."""
    return torch.nn.functional.pad(t, pad, value=value)


def shard_planar(p: PlanarQuant, n_shards: int, axis: str = "r",
                 groups=None, index: int | None = None) -> PlanarQuant:
    """``planarize_shards`` of an already planar weight (any leading depth
    axes), on its own device: the same bytes as ``planarize_shards`` of
    the blocks ``p`` was made from. Fields lead with the shard axis; with
    ``index``, only shard ``index`` is built (no shard axis)."""
    R, K = p.shape
    gs = p.group_size
    codes = unpack_codes(p)[..., :K, :R]
    scales = p.scales[..., : K // gs, :R]
    offsets = None if p.offsets is None else p.offsets[..., : K // gs, :R]
    if axis == "r":
        sets = _shard_index_sets(R, n_shards, groups, 1, "R")
    elif axis == "k":
        sets = _shard_index_sets(K, n_shards, groups, gs, "K")
    else:
        raise ValueError(f"axis must be 'r' or 'k', got {axis!r}")
    picks = range(n_shards) if index is None else (index,)
    shards = []
    for s in picks:
        ix = torch.as_tensor(sets[s], device=codes.device)
        if axis == "r":
            shards.append(_assemble_kmajor(
                codes[..., ix], scales[..., ix],
                None if offsets is None else offsets[..., ix], p,
                (len(ix), K)))
        else:
            gx = ix[::gs] // gs
            shards.append(_assemble_kmajor(
                codes[..., ix, :], scales[..., gx, :],
                None if offsets is None else offsets[..., gx, :], p,
                (R, len(ix))))
    return shards[0] if index is not None else _stack_shards(shards)


@dataclasses.dataclass(frozen=True)
class TPShard:
    """A tensor-parallel-sharded weight leaf.

    Wraps a packed weight (``PlanarQuant`` / ``I8Planar``) or a dense one.
    Built by ``parallel.tp_spec``, its fields lead with the shard axis;
    each rank keeps its own shard (``shard_view``), and ``nn.layers.linear``
    runs the collective its mode names over the mesh axis ``axis``:

    * ``"col"``: out-features split; the local output IS the shard's
      columns, no collective (qkv, mlp-up; a bias is pre-split to match).
    * ``"row"``: in-features split; a local contraction over the K chunk,
      then one all-reduce replicates the output (attention out, mlp-down;
      the bias is added once, after it).
    * ``"gather"``: column split whose output must be replicated
      (modulation projections): local matmul and bias, then a tiled
      all-gather, which restores the original column order of contiguous
      splits.
    """

    inner: object
    mode: str  # "col" | "row" | "gather"
    axis: str = "tp"

    def __getitem__(self, i) -> "TPShard":
        """Leading-axis slice (shard, then depth): views, no copy."""
        return dataclasses.replace(self, inner=self.inner[i])


@dataclasses.dataclass(frozen=True)
class TPNormShard:
    """A norm scale (or its bias) whose INPUT feature axis is sharded.

    Some archs (Wan) apply full-width RMS norms to q/k before the head
    split; under column-parallel q/k a rank holds D/tp features, so
    ``nn.layers.rms_norm`` / ``layer_norm`` reduce the statistics over
    ``axis`` against the true ``full_dim`` and apply the local slice of
    the scale.
    """

    weight: torch.Tensor  # the local (D/tp,) slice, maybe with lead axes
    axis: str
    full_dim: int

    def __getitem__(self, i) -> "TPNormShard":
        return dataclasses.replace(self, weight=self.weight[i])


def shard_view(leaf, index: int = 0):
    """Shard ``index`` of a leaf whose fields lead with the shard axis
    (``PlanarQuant``, ``I8Planar``, ``TPShard``, ``TPNormShard`` or a
    tensor): views, no copy."""
    return leaf[index]
