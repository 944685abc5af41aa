"""Fused dequantize + matmul (PyTorch port of comfyui_gguf_tpu/ops/qmatmul.py).

Two implementations of one function, ``epi(x @ W^T)`` with W kept packed:

* ``qmm_cuda`` — wrapper of the hand-written CUDA kernels of ``csrc/qmm.cu``,
  ``qmm_int8.cu`` and ``qmm_smallm.cu`` (K1 for the nib4 layout, K2 for the
  int8 layout). The dense weight never
  reaches device memory; the LoRA rank term (``lora_h @ lora_up``, in the
  LoRA instances of ``qmm_lora.cu``, ``qmm_int8_lora.cu`` and
  ``qmm_smallm.cu``), bias and GELU-tanh run on the f32 accumulator.
  Two kernel bodies, picked from the shape alone by ``qmm_route``: a
  weight-streaming split-K body for M <= ``SMALL_M_MAX`` rows of x (bound by
  the bytes of the packed weight) and a TMA + ``wgmma`` body for every larger
  M (bound by tensor-core operations).
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


def smallm_plan(m: int, kp: int, r: int, nib4: bool):
    """(split, shared-memory bytes) of the split-K launch, or None where
    that body does not take the shape.

    A block owns a 128-column strip and ``1/split`` of the code rows
    (Kp/2 rows for nib4, Kp for int8; slices are whole units of 16 rows);
    the ``split`` blocks of a strip form one cluster (at most 8). The split
    is the smallest that puts 2 blocks on each SM, or else the largest
    whose x slice (8 rows of bf16, 8 elements of padding a row, one plane
    per nibble) fits in shared memory beside the 4 KB of partial sums.
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
                   * (code_rows // split + 8) * 2)
        red_bytes = 4 * SMALL_M_MAX * _STRIP * 4
        smem = max(x_bytes, red_bytes) + SMALL_M_MAX * _STRIP * 4
        if smem > _SMALLM_SMEM_MAX:
            continue
        best = (split, smem)
        if strips * split >= _SMALLM_BLOCKS:
            break
    return best


def qmm_route(m: int, kp: int, r: int, nib4: bool) -> str:
    """Which kernel body takes (M, padded K, R, layout): "smallm" or
    "wgmma"."""
    return "smallm" if smallm_plan(m, kp, r, nib4) is not None else "wgmma"


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
              rp: int):
    """The kernels' layout of the LoRA rank operands (the counterpart of the
    reference's ``_prep_lora``, whose pad to 128 lanes is a TPU tile rule).

    lora_h (..., Σr) is the rank intermediate x @ downᵀ, lora_up (Σr, R) the
    scale-folded upᵀ, as ``lora.rank_factorize`` gives them. Returns (h, up,
    rk): h (m, rk) and up (rp, rk) bfloat16, contiguous and 16-byte aligned,
    the rank contiguous; up is the up factor itself (not transposed), rows
    past R zero; rk is Σr zero-padded to a multiple of ``LORA_RANK_STEP``
    (padded rank columns add exact zeros). One layout serves the three
    kernel bodies: the K-major B operand of K4, the K-major A operand of
    the K1/K2 wgmma body, and rows of the split-K body's FMAs. Any rank is
    taken. Raises on another dtype or on shapes that do not fit."""
    if lora_h is None or lora_up is None:
        raise ValueError("LoRA operands come in pairs: lora_h and lora_up")
    if lora_h.dtype != torch.bfloat16 or lora_up.dtype != torch.bfloat16:
        raise TypeError(
            f"the CUDA kernels take bfloat16 LoRA operands (the patch dtype, "
            f"QuantConfig.patch_dtype), got {lora_h.dtype} / "
            f"{lora_up.dtype}")
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
        up = torch.zeros((rp, rk), dtype=torch.bfloat16,
                         device=lora_up.device)
        up[:r, :sr] = lora_up.t()
    return h, up, rk


def qmm_cuda(x: torch.Tensor, pq: PlanarQuant, *, bias=None,
             act_from_col: int | None = None, out_dtype=None, lora_h=None,
             lora_up=None) -> torch.Tensor:
    """Launch the fused dequant-matmul kernel (K1 nib4 / K2 int8), the
    body ``qmm_route`` names for the shape; with ``lora_h``/``lora_up``
    (see ``prep_lora``) that body's LoRA instance.

    x: (..., K) CUDA tensor (cast to bf16, as the kernel's operands are);
    pq: 2-D planar weight (a depth slice of a stacked one is fine).
    Output (..., R) in ``out_dtype`` (default x.dtype), written as bf16.
    """
    R, K = pq.shape
    dev = x.device
    if not x.is_cuda:
        raise ValueError("qmm_cuda takes CUDA tensors")
    if pq.qs.dim() != 2:
        raise ValueError(f"qmm_cuda takes a 2-D weight, got qs "
                         f"{tuple(pq.qs.shape)} (index a stacked weight)")
    nib4 = pq.layout == "nib4"
    kc, rp = pq.qs.shape
    kp = kc * 2 if nib4 else kc
    gs = pq.group_size
    want_q = torch.uint8 if nib4 else torch.int8
    if pq.qs.dtype != want_q or pq.scales.dtype != torch.float32:
        raise TypeError(f"planar dtypes {pq.qs.dtype}/{pq.scales.dtype}")
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
    x2 = _aligned(x.reshape(-1, K).to(torch.bfloat16))
    m = x2.shape[0]
    out = torch.empty((m, R), dtype=torch.bfloat16, device=dev)
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
            h, up, rk = prep_lora(lora_h, lora_up, m, R, rp)
            if h.device != dev or up.device != dev:
                raise ValueError("LoRA operands must be on x's device")
        lib = _build.lib()
        ptrs = (x2.data_ptr(), pq.qs.data_ptr(), pq.scales.data_ptr(),
                None if pq.offsets is None else pq.offsets.data_ptr(),
                None if b is None else b.data_ptr(), out.data_ptr())
        dims = (m, K, kp, R, rp, gs, int(pq.zero_point))
        act = -1 if act_from_col is None else int(act_from_col)
        stream = ctypes.c_void_p(_build.stream_handle(dev))
        name = "qmm_nib4" if nib4 else "qmm_int8"
        plan = smallm_plan(m, kp, R, nib4)
        if plan is not None:
            name += "_smallm"
            if lora:
                rc = lib.qmm_smallm_lora_launch(
                    *ptrs, h.data_ptr(), up.data_ptr(), *dims, rk,
                    int(nib4), act, plan[0], stream)
            else:
                rc = lib.qmm_smallm_launch(*ptrs, *dims, int(nib4), act,
                                           plan[0], stream)
        else:
            nt = wgmma_plan(m, R)[0]
            if lora:
                launch = (lib.qmm_wgmma_nib4_lora_launch if nib4
                          else lib.qmm_wgmma_int8_lora_launch)
                rc = launch(*ptrs, h.data_ptr(), up.data_ptr(), *dims, rk,
                            act, nt, stream)
            else:
                launch = (lib.qmm_wgmma_nib4_launch if nib4
                          else lib.qmm_wgmma_int8_launch)
                rc = launch(*ptrs, *dims, act, nt, stream)
        if lora:
            name += "_lora"
        _build.check(rc, name + " launch")
        _build.count(name)
    return out.reshape(*lead, R).to(out_dtype or x.dtype)


def quantized_matmul(x: torch.Tensor, pq: PlanarQuant, *,
                     dequant_dtype=torch.bfloat16, out_dtype=None,
                     bias=None, act_from_col: int | None = None,
                     lora_h=None, lora_up=None) -> torch.Tensor:
    """x @ W^T with packed planar W (+ the LoRA rank term h @ upᵀ, bias,
    GELU-tanh from a column).

    CUDA tensors launch the kernel; CPU tensors take the plain version.
    """
    if x.is_cuda:
        if dequant_dtype != torch.bfloat16:
            raise NotImplementedError(
                f"the CUDA kernel dequantizes to bfloat16, not "
                f"{dequant_dtype}")
        return qmm_cuda(x, pq, bias=bias, act_from_col=act_from_col,
                        out_dtype=out_dtype, lora_h=lora_h, lora_up=lora_up)
    return plain_quantized_matmul(
        x, pq, dequant_dtype=dequant_dtype, out_dtype=out_dtype, bias=bias,
        act_from_col=act_from_col, lora_h=lora_h, lora_up=lora_up)
