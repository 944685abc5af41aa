"""Fused dequantize + matmul (PyTorch port of comfyui_gguf_tpu/ops/qmatmul.py).

Two implementations of one function, ``epi(x @ W^T)`` with W kept packed:

* ``qmm_cuda`` — wrapper of the hand-written CUDA kernels of ``csrc/qmm.cu``,
  ``qmm_int8.cu``, ``qmm_smallm.cu`` and ``qmm_simt.cu`` (K1 for the nib4
  layout, K2 for the int8 layout). The dense weight never
  reaches device memory; the LoRA rank term (``lora_h @ lora_up``, in the
  LoRA instances of ``qmm_lora.cu``, ``qmm_int8_lora.cu`` and
  ``qmm_smallm.cu``), bias and GELU-tanh run on the f32 accumulator.
  Three kernel bodies, picked from the shape and ``dequant_dtype`` by
  ``qmm_route``: a weight-streaming split-K body for M <= ``SMALL_M_MAX``
  rows of x (bound by the bytes of the packed weight), a TMA + ``wgmma``
  body for every larger M in bf16 or f16 (bound by tensor-core operations),
  whose K may be split over a cluster of blocks where its output tiles are
  too few for the card (``wgmma_split_plan``), and an f32 SIMT body for f32
  at M > 8 (bound by the card's f32 FMA rate: the reference's f32 product
  has no tensor-core type). Each computes in the reference's
  ``dequant_dtype`` (bfloat16, float16 or float32: the weight and x rounded
  to it, as ``pallas_qmm`` casts them); all read float32 or bfloat16 scale
  planes.
* ``plain_quantized_matmul`` — the plain PyTorch version, the counterpart
  of the reference's ``xla_qmm`` + ``_host_epilogue``: dequantize to a
  dense weight, one f32-accumulated matmul, then the unfused epilogue.

``quantized_matmul`` dispatches by device alone: a CUDA tensor launches the
kernel (or raises), a CPU tensor takes the plain version. A depth-stacked
weight needs nothing extra: ``pq[i]`` is a view, and the kernel reads block
i's bytes in place (the reference's scalar-prefetch ``pallas_qmm_indexed``).
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from .. import _build
from ..quant.planar import PlanarQuant, dequantize_kmajor


def plain_qmm(x: torch.Tensor, pq: PlanarQuant, *,
              dequant_dtype=torch.bfloat16, out_dtype=None) -> torch.Tensor:
    """x: (..., K) @ W^T -> (..., R): dequantize, then one matmul with f32
    accumulation over ``dequant_dtype`` operands."""
    w = dequantize_kmajor(pq, dequant_dtype)  # (K, R)
    out = torch.matmul(x.to(dequant_dtype).to(torch.float32),
                       w.to(torch.float32))
    return out.to(out_dtype or x.dtype)


def _host_epilogue(out, bias, act_from_col, lora_h=None, lora_up=None):
    """Unfused epilogue of the plain path: LoRA rank delta, bias, then
    GELU-tanh on columns >= act_from_col (0 = the whole output)."""
    if lora_h is not None:
        dt = lora_h.dtype
        delta = torch.matmul(
            lora_h.reshape(-1, lora_h.shape[-1]).to(torch.float32),
            lora_up.to(dt).to(torch.float32))
        out = out + delta.reshape(*out.shape[:-1],
                                  lora_up.shape[1]).to(out.dtype)
    if bias is not None:
        out = out + bias.to(out.dtype)
    if act_from_col is not None:
        def act(t):
            return F.gelu(t.to(torch.float32),
                          approximate="tanh").to(t.dtype)

        if act_from_col == 0:
            out = act(out)
        else:
            out = torch.cat([out[..., :act_from_col],
                             act(out[..., act_from_col:])], dim=-1)
    return out


def plain_quantized_matmul(x, pq: PlanarQuant, *,
                           dequant_dtype=torch.bfloat16, out_dtype=None,
                           bias=None, act_from_col=None, lora_h=None,
                           lora_up=None) -> torch.Tensor:
    """The plain PyTorch version of the fused kernel (any device)."""
    return _host_epilogue(
        plain_qmm(x, pq, dequant_dtype=dequant_dtype, out_dtype=out_dtype),
        bias, act_from_col, lora_h, lora_up)


# --- the dispatch rule and the host arithmetic of the two kernel bodies ---

SMALL_M_MAX = 8  # rows of x the split-K body takes (the N of its mma)
N_SM = 132  # SMs of the card the grids are sized for (H100 SXM)
_STRIP = 128  # columns per split-K block
_SMALLM_BLOCKS = 2 * N_SM  # blocks wanted: 2 a SM (tools_qmm_cuda.py)
_SMALLM_SMEM_MAX = 96 * 1024  # leaves room for two blocks a SM
WGMMA_TILE = (128, 128)  # (tokens, out-features) of a wgmma sub-tile
# time of a 128-token tile spent unpacking the weight, relative to its
# tensor-core time (measured on the H100 with tools_qmm_cuda.py)
_UNPACK_SHARE = 1.5
WGMMA_SPLITS = (1, 2, 4, 8)  # blocks of a K-split cluster (8: portable max)
# blocks of the wgmma body resident at once in clusters of each size
# (cudaOccupancyMaxActiveClusters x size on the H100 SXM; chip_smoke.py
# phase 2 prints them as qmm_wgmma_resident_blocks)
_RESIDENT = {1: N_SM, 2: N_SM, 4: 120, 8: 120}
# a block's fixed time (the ring's fill, the epilogue) and the cluster's
# reduction per 128 tokens, in units of one K step's tensor-core time at
# 128 tokens (0.275 us on the H100; fitted to the (nt, split) sweep of
# chip_smoke.py phase 3 at Pile-T5's and T5-xxl's shapes: 3.2 us and 1.75
# us)
_FIXED_STEPS = 11.6
_REDUCE_STEPS = 6.4


def smallm_plan(m: int, kp: int, r: int, nib4: bool, esize: int = 2):
    """(split, shared-memory bytes) of the split-K launch, or None where
    that body does not take the shape.

    A block owns a 128-column strip and ``1/split`` of the code rows
    (Kp/2 rows for nib4, Kp for int8; slices are whole units of 16 rows);
    the ``split`` blocks of a strip form one cluster (at most 8). The split
    is the smallest that puts 2 blocks on each SM, or else the largest
    whose x slice (8 rows of ``esize``-byte elements: 2 for bf16 and f16,
    4 for f32; 8 elements of padding a row, one plane per nibble) fits in
    shared memory beside the 4 KB of partial sums.
    """
    if not 1 <= m <= SMALL_M_MAX:
        return None
    code_rows = kp // 2 if nib4 else kp
    strips = -(-r // _STRIP)
    best = None
    for split in range(1, 9):
        if code_rows % (16 * split):
            continue
        x_bytes = ((2 if nib4 else 1) * SMALL_M_MAX
                   * (code_rows // split + 8) * esize)
        red_bytes = 4 * SMALL_M_MAX * _STRIP * 4
        smem = max(x_bytes, red_bytes) + SMALL_M_MAX * _STRIP * 4
        if smem > _SMALLM_SMEM_MAX:
            continue
        best = (split, smem)
        if strips * split >= _SMALLM_BLOCKS:
            break
    return best


# the operand types of the kernels: dequant_dtype -> its bytes
QMM_DTYPES = {torch.bfloat16: 2, torch.float16: 2, torch.float32: 4}


def qmm_route(m: int, kp: int, r: int, nib4: bool,
              dtype=torch.bfloat16) -> str:
    """Which kernel body takes (M, padded K, R, layout) at ``dtype`` (the
    dequant dtype): "smallm", "wgmma" (bf16 and f16) or "simt" (f32)."""
    if smallm_plan(m, kp, r, nib4, QMM_DTYPES[dtype]) is not None:
        return "smallm"
    return "simt" if dtype == torch.float32 else "wgmma"


def wgmma_plan(m: int, r: int) -> tuple[int, int, int, int]:
    """(token sub-tiles, token tiles, out-feature tiles, persistent blocks)
    of the wgmma launch.

    An output tile is 128 out-features by ``nt`` x 128 tokens, nt 1 or 2;
    one block a SM walks tiles t, t + blocks, ...; tile t covers token tile
    t % token_tiles of out-feature tile t // token_tiles. A 256-token tile
    unpacks each weight element once for twice the tokens, a 128-token tile
    leaves a shorter last wave: the choice is the smaller modelled time,
    waves x (nt + ``_UNPACK_SHARE``).
    """
    r_tiles = -(-r // WGMMA_TILE[1])

    def cost(nt):
        tiles = -(-m // (nt * WGMMA_TILE[0])) * r_tiles
        return -(-tiles // N_SM) * (nt + _UNPACK_SHARE)

    nt = 2 if m > WGMMA_TILE[0] and cost(2) < cost(1) else 1
    m_tiles = -(-m // (nt * WGMMA_TILE[0]))
    return nt, m_tiles, r_tiles, min(m_tiles * r_tiles, N_SM)


def wgmma_split_ok(kp: int, nt: int, split: int) -> bool:
    """Whether the wgmma body takes a K split of ``split`` blocks: each
    walks an even number of 64-wide K steps, and the tile's 16·nt groups of
    accumulators divide evenly among the ranks that reduce them."""
    return (split in WGMMA_SPLITS and (kp // 64) % (2 * split) == 0
            and (16 * nt) % split == 0)


def wgmma_cost(m: int, kp: int, r: int, nt: int, split: int) -> float:
    """Modelled time of the wgmma body at (nt, split), in K steps of one
    128-token tile: waves x a block's time. A block walks its K slice at
    nt + ``_UNPACK_SHARE`` a step (the unpack adds to the tensor cores, it
    does not hide), plus ``_FIXED_STEPS`` and, in a cluster, the
    reduction's ``_REDUCE_STEPS`` per 128 tokens."""
    tiles = -(-m // (nt * WGMMA_TILE[0])) * -(-r // WGMMA_TILE[1])
    blocks = tiles * split
    waves = -(-blocks // _RESIDENT[split])
    block = ((kp // 64) // split * (nt + _UNPACK_SHARE) + _FIXED_STEPS
             + (_REDUCE_STEPS * nt if split > 1 else 0.0))
    return waves * block


def wgmma_split_plan(m: int, kp: int, r: int) -> tuple[int, int]:
    """(token sub-tiles, K split) of the wgmma launch: the pair of least
    ``wgmma_cost``, ties to the smaller split, then to nt 1.

    Where tiles are few (the encoders' 256-512 tokens) the blocks of one
    output tile form a cluster along K and each walks 1/split of it, so
    the card fills and 256-token tiles unpack each weight element once for
    twice the tokens; where they are many, split stays 1 and the blocks
    are persistent.
    """
    best = None
    for nt in ((1, 2) if m > WGMMA_TILE[0] else (1,)):
        for split in WGMMA_SPLITS:
            if not wgmma_split_ok(kp, nt, split):
                continue
            c = wgmma_cost(m, kp, r, nt, split)
            if best is None or c < best[0]:
                best = (c, nt, split)
    return best[1], best[2]


# tuned (token sub-tiles, K split) of the wgmma body by shape:
# {(m bucket, Kp, Rp, layout): (nt, split)}. Filled by ops.autotune (timed
# on the card) or loaded from the JSON named by $GGUF_TPU_TILE_CACHE;
# consulted before ``wgmma_split_plan``. Empty unless one of those fills it.
# m is bucketed to the next power of two so batch jitter reuses entries.
# The key has no dequant dtype and no LoRA: an entry drives every wgmma
# instance of its shape (bf16 or f16, with or without a LoRA epilogue),
# whichever one it was timed on.
SHAPE_TILES: dict = {}


def _m_bucket(m: int) -> int:
    return 1 << max(0, (m - 1)).bit_length() if m > 0 else 1


def shape_key(m: int, kp: int, rp: int, layout: str) -> tuple:
    """The ``SHAPE_TILES`` key of a launch: (m rounded up to a power of
    two, padded K, padded R, "nib4" | "int8")."""
    return (_m_bucket(m), kp, rp, layout)


def wgmma_tiles(m: int, kp: int, r: int, rp: int, layout: str,
                tiles=None) -> tuple[int, int]:
    """(token sub-tiles, K split) of a wgmma launch: ``tiles`` if given,
    else the ``SHAPE_TILES`` entry of its shape, else ``wgmma_split_plan``'s
    pick. A given or tabled pair the body cannot take raises
    ``ValueError``."""
    source = "tiles="
    if tiles is None:
        source = "SHAPE_TILES entry"
        tiles = SHAPE_TILES.get(shape_key(m, kp, rp, layout))
        if tiles is None:
            return wgmma_split_plan(m, kp, r)
    nt, split = tiles
    if not (nt in (1, 2) and wgmma_split_ok(kp, nt, split)):
        raise ValueError(f"{source} nt={nt} split={split} for "
                         f"{shape_key(m, kp, rp, layout)} does not fit "
                         f"Kp={kp}")
    return nt, split


I8MM_TILE_M = 128  # tokens per K4 tile (2 consumer warpgroups x 64)
I8MM_WIDTHS = (256, 128)  # out-features per K4 tile
# time of a 128-wide K4 tile relative to half a 256-wide one: 1.09-1.13 at
# equal waves on the H100 (tools_i8mm_flash_cuda.py times both widths),
# rounded up for the x tiles a narrow tile reads twice as often (at K =
# 15360 x outgrows the L2, and the narrow tile lost about 9% where waves
# alone favoured it)
_NARROW_COST = 1.2


def i8mm_plan(m: int, r: int) -> tuple[int, int, int, int]:
    """(out-feature tile width, token tiles, out-feature tiles, persistent
    blocks) of the w8a8 kernel's launch (K4, ``csrc/i8mm.cu``).

    An output tile is 128 tokens by 256 or 128 out-features; one block a SM
    walks the tiles. A 256-wide tile reads each x tile once for twice the
    out-features, a 128-wide one leaves a shorter last wave where tiles are
    few (flux's 512-token text stream: 144 tiles at 256 wide, 1.09 waves).
    The choice is the smaller modelled time, waves x the time of one tile
    (2 for 256 wide, ``_NARROW_COST`` for 128), with ties to 256.
    """
    m_tiles = -(-m // I8MM_TILE_M)

    def cost(bn):
        tiles = m_tiles * -(-r // bn)
        return -(-tiles // N_SM) * (2 if bn == 256 else _NARROW_COST)

    bn = 128 if cost(128) < cost(256) else 256
    n_tiles = -(-r // bn)
    return bn, m_tiles, n_tiles, min(m_tiles * n_tiles, N_SM)


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """Contiguous and 16-byte aligned (a copy only where it is not)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


LORA_RANK_STEP = 16  # rank columns of one bf16 wgmma k-step


def prep_lora(lora_h: torch.Tensor, lora_up: torch.Tensor, m: int, r: int,
              rp: int, dtype=torch.bfloat16):
    """The kernels' layout of the LoRA rank operands (the counterpart of the
    reference's ``_prep_lora``, whose pad to 128 lanes is a TPU tile rule).

    lora_h (..., Σr) is the rank intermediate x @ downᵀ, lora_up (Σr, R) the
    scale-folded upᵀ, as ``lora.rank_factorize`` gives them. Returns (h, up,
    rk): h (m, rk) and up (rp, rk) in ``dtype``, the kernel's operand type,
    to which both are rounded as the reference's ``_prep_lora`` casts them to
    dequant_dtype (``pallas_i8mm`` to bfloat16); contiguous and 16-byte
    aligned, the rank contiguous; up is the up factor itself (not
    transposed), rows past R zero; rk is Σr zero-padded to a multiple of
    ``LORA_RANK_STEP`` (padded rank columns add exact zeros). One layout
    serves every kernel body: the K-major B operand of K4, the K-major A
    operand of the K1/K2 wgmma body, rows of the split-K body's FMAs and the
    f32 body's rank steps. Any rank is taken. Raises on shapes that do not
    fit."""
    if lora_h is None or lora_up is None:
        raise ValueError("LoRA operands come in pairs: lora_h and lora_up")
    if dtype not in QMM_DTYPES:
        raise TypeError(f"the kernels have no {dtype} LoRA operands")
    lora_h, lora_up = lora_h.to(dtype), lora_up.to(dtype)
    sr = lora_up.shape[0] if lora_up.dim() == 2 else -1
    if sr < 1 or lora_up.shape[1] != r or lora_h.shape[-1] != sr:
        raise ValueError(f"LoRA operands h {tuple(lora_h.shape)}, upᵀ "
                         f"{tuple(lora_up.shape)} do not fit (..., r) and "
                         f"(r, {r})")
    h = lora_h.reshape(-1, sr)
    if h.shape[0] != m:
        raise ValueError(f"lora_h has {h.shape[0]} rows for {m} rows of x")
    rk = -(-sr // LORA_RANK_STEP) * LORA_RANK_STEP
    h = _aligned(F.pad(h, (0, rk - sr)) if rk != sr else h)
    up = lora_up.t()  # rank_factorize's upᵀ is a view of the up factor
    if not (rk == sr and rp == r and up.is_contiguous()
            and up.data_ptr() % 16 == 0):
        up = torch.zeros((rp, rk), dtype=dtype, device=lora_up.device)
        up[:r, :sr] = lora_up.t()
    return h, up, rk


def qmm_cuda(x: torch.Tensor, pq: PlanarQuant, *, bias=None,
             act_from_col: int | None = None, out_dtype=None, lora_h=None,
             lora_up=None, tiles: tuple[int, int] | None = None,
             dequant_dtype=torch.bfloat16) -> torch.Tensor:
    """Launch the fused dequant-matmul kernel (K1 nib4 / K2 int8), the
    body ``qmm_route`` names for the shape and ``dequant_dtype``; with
    ``lora_h``/``lora_up`` (see ``prep_lora``) that body's LoRA instance.

    x: (..., K) CUDA tensor, cast to ``dequant_dtype`` (bfloat16, float16 or
    float32: the kernel's operand type, to which it also rounds the weight);
    pq: 2-D planar weight (a depth slice of a stacked one is fine), float32
    or bfloat16 scale planes. ``tiles``: the wgmma body's (token sub-tiles,
    K split) instead of ``wgmma_tiles``' (the ``SHAPE_TILES`` entry, else
    ``wgmma_split_plan``'s pick), for measurements and tests.
    Output (..., R) in ``out_dtype`` (default x.dtype): the bf16 instances
    write bf16, the f16 and f32 ones f32, rounded once to ``out_dtype``.
    """
    R, K = pq.shape
    dev = x.device
    if not x.is_cuda:
        raise ValueError("qmm_cuda takes CUDA tensors")
    if dequant_dtype not in QMM_DTYPES:
        raise NotImplementedError(
            f"the fused dequant-matmul kernels compute in "
            f"{', '.join(map(str, QMM_DTYPES))}, not {dequant_dtype}")
    if pq.qs.dim() != 2:
        raise ValueError(f"qmm_cuda takes a 2-D weight, got qs "
                         f"{tuple(pq.qs.shape)} (index a stacked weight)")
    nib4 = pq.layout == "nib4"
    kc, rp = pq.qs.shape
    kp = kc * 2 if nib4 else kc
    gs = pq.group_size
    want_q = torch.uint8 if nib4 else torch.int8
    sdt = pq.scales.dtype
    if (pq.qs.dtype != want_q or sdt not in (torch.float32, torch.bfloat16)
            or (pq.offsets is not None and pq.offsets.dtype != sdt)):
        raise TypeError(f"planar dtypes {pq.qs.dtype}/{sdt}/"
                        f"{None if pq.offsets is None else pq.offsets.dtype}")
    if (kp % 512 or rp % 128 or R > rp or K > kp or K % 8
            or gs not in (16, 32)
            or (pq.offsets is not None and pq.zero_point)):
        raise ValueError(f"untileable planar weight: shape {pq.shape}, "
                         f"padded ({kp}, {rp}), group {gs}, zero point "
                         f"{pq.zero_point}")
    for t in (pq.qs, pq.scales, pq.offsets):
        if t is not None and (t.device != dev or not t.is_contiguous()):
            raise ValueError("planar tensors must be contiguous on x's "
                             "device")
    if pq.scales.shape != (kp // gs, rp):
        raise ValueError(f"scales {tuple(pq.scales.shape)} != "
                         f"{(kp // gs, rp)}")
    lead = x.shape[:-1]
    x2 = _aligned(x.reshape(-1, K).to(dequant_dtype))
    m = x2.shape[0]
    bf16 = dequant_dtype == torch.bfloat16
    out = torch.empty((m, R), dtype=torch.bfloat16 if bf16 else torch.float32,
                      device=dev)
    # the instances' suffix: none for bf16
    sfx = "" if bf16 else "_f16" if dequant_dtype == torch.float16 else "_f32"
    if m:
        b = None
        if bias is not None:
            b = _aligned(bias.to(device=dev, dtype=torch.float32))
            if b.shape != (R,):
                raise ValueError(f"bias {tuple(b.shape)} != ({R},)")
        ptrs = [x2, pq.qs, pq.scales, pq.offsets, b]
        if any(t is not None and t.data_ptr() % 16 for t in ptrs):
            raise ValueError("planar tensors must be 16-byte aligned")
        lora = lora_h is not None or lora_up is not None
        if lora:
            h, up, rk = prep_lora(lora_h, lora_up, m, R, rp, dequant_dtype)
            if h.device != dev or up.device != dev:
                raise ValueError("LoRA operands must be on x's device")
        lib = _build.lib()
        ptrs = (x2.data_ptr(), pq.qs.data_ptr(), pq.scales.data_ptr(),
                None if pq.offsets is None else pq.offsets.data_ptr(),
                None if b is None else b.data_ptr(), out.data_ptr())
        dims = (m, K, kp, R, rp, gs, int(pq.zero_point))
        act = -1 if act_from_col is None else int(act_from_col)
        sbf16 = int(sdt == torch.bfloat16)
        stream = ctypes.c_void_p(_build.stream_handle(dev))
        name = "qmm_nib4" if nib4 else "qmm_int8"
        plan = smallm_plan(m, kp, R, nib4, QMM_DTYPES[dequant_dtype])
        if plan is not None:
            name += "_smallm"
            if lora:
                launch = getattr(lib, f"qmm_smallm{sfx}_lora_launch")
                rc = launch(*ptrs, h.data_ptr(), up.data_ptr(), *dims, rk,
                            int(nib4), act, plan[0], sbf16, stream)
            else:
                launch = getattr(lib, "qmm_smallm_ex_launch" if bf16
                                 else f"qmm_smallm{sfx}_launch")
                rc = launch(*ptrs, *dims, int(nib4), act, plan[0], sbf16,
                            stream)
        elif dequant_dtype == torch.float32:
            name += "_simt"
            if lora:
                rc = lib.qmm_simt_lora_launch(
                    *ptrs, h.data_ptr(), up.data_ptr(), *dims, rk,
                    int(nib4), act, sbf16, stream)
            else:
                rc = lib.qmm_simt_launch(*ptrs, *dims, int(nib4), act, sbf16,
                                         stream)
        else:
            lay = "nib4" if nib4 else "int8"
            nt, split = wgmma_tiles(m, kp, R, rp, lay, tiles)
            if lora:
                launch = getattr(lib, f"qmm_wgmma_{lay}{sfx}_lora_launch")
                rc = launch(*ptrs, h.data_ptr(), up.data_ptr(), *dims, rk,
                            act, nt, split, sbf16, stream)
            else:
                launch = getattr(lib, f"qmm_wgmma_{lay}_split_launch" if bf16
                                 else f"qmm_wgmma_{lay}{sfx}_launch")
                rc = launch(*ptrs, *dims, act, nt, split, sbf16, stream)
        if lora:
            name += "_lora"
        name += sfx
        _build.check(rc, name + " launch")
        _build.count(name)
    return out.reshape(*lead, R).to(out_dtype or x.dtype)


def quantized_matmul(x: torch.Tensor, pq: PlanarQuant, *,
                     dequant_dtype=torch.bfloat16, out_dtype=None,
                     bias=None, act_from_col: int | None = None,
                     lora_h=None, lora_up=None) -> torch.Tensor:
    """x @ W^T with packed planar W (+ the LoRA rank term h @ upᵀ, bias,
    GELU-tanh from a column).

    CUDA tensors launch the kernel in ``dequant_dtype`` (bfloat16, float16
    or float32; another dtype raises); CPU tensors take the plain version.
    """
    if x.is_cuda:
        return qmm_cuda(x, pq, bias=bias, act_from_col=act_from_col,
                        out_dtype=out_dtype, lora_h=lora_h, lora_up=lora_up,
                        dequant_dtype=dequant_dtype)
    return plain_quantized_matmul(
        x, pq, dequant_dtype=dequant_dtype, out_dtype=out_dtype, bias=bias,
        act_from_col=act_from_col, lora_h=lora_h, lora_up=lora_up)
