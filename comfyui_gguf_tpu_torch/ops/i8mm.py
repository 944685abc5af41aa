"""w8a8 matmul (PyTorch port of comfyui_gguf_tpu/ops/i8mm.py).

Per matmul: activations are quantized per token row (quant/i8.quantize_rows,
a torch op), the contraction runs over int8 operands with an exact integer
accumulator, and one f32 rescale ``acc·xs[m]·ws[r]`` precedes the shared
epilogue (the LoRA rank term ``lora_h @ lora_up``, bias, then GELU-tanh
from a column).

* ``i8mm_cuda`` — wrapper of the hand-written CUDA kernel ``csrc/i8mm.cu``
  (K4, a TMA + ``wgmma`` GEMM whose tile width ``ops.qmatmul.i8mm_plan``
  picks; on a depth-stacked weight it runs on block i's view, which is what
  the reference's ``pallas_i8mm_indexed`` (K5) did by scalar prefetch), and
  of its LoRA instance ``csrc/i8mm_lora.cu``.
* ``plain_i8mm`` — the plain PyTorch version (the reference's
  ``xla_i8mm``), on IDENTICAL integer operands.

``i8_matmul`` dispatches by device alone.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from .. import _build
from ..quant.i8 import I8Planar, quantize_rows
from .qmatmul import I8MM_WIDTHS, _aligned, i8mm_plan, prep_lora


def _gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    # the reference kernel epilogue's formula (ops/qmatmul.py _gelu_tanh)
    c = 0.7978845608028654  # sqrt(2/pi)
    return 0.5 * x * (1.0 + torch.tanh(c * (x + 0.044715 * x * x * x)))


def plain_i8mm(x: torch.Tensor, ip: I8Planar, *, out_dtype=None, bias=None,
               act_from_col: int | None = None, lora_h=None,
               lora_up=None) -> torch.Tensor:
    """Same-math path: shared quantize_rows, exact integer product, f32
    rescale, then lora -> bias -> gelu on f32 before the one output cast.

    The integer product runs as a float64 matmul of the int8 operands,
    which is exact here (every partial sum stays below 2^53) and runs on
    any device.
    """
    out_dtype = out_dtype or x.dtype
    R, K = ip.shape
    lead = x.shape[:-1]
    x2 = x.reshape(-1, K)
    kp = ip.padded_in
    if kp != K:
        x2 = F.pad(x2, (0, kp - K))
    xq, xs = quantize_rows(x2)
    acc = torch.matmul(xq.to(torch.float64), ip.qs.to(torch.float64).t())
    accf = acc.to(torch.float32) * xs * ip.scales.to(torch.float32)
    accf = accf[:, :R]
    if lora_h is not None:
        lh = lora_h.reshape(-1, lora_h.shape[-1])
        accf = accf + torch.matmul(
            lh.to(torch.float32),
            lora_up.to(lh.dtype).to(torch.float32))[:, :R]
    if bias is not None:
        accf = accf + bias.to(torch.float32)[None, :]
    if act_from_col is not None:
        if act_from_col == 0:
            accf = _gelu_tanh(accf)
        else:
            accf = torch.cat([accf[:, :act_from_col],
                              _gelu_tanh(accf[:, act_from_col:])], dim=1)
    return accf.to(out_dtype).reshape(*lead, R)


def i8mm_cuda(x: torch.Tensor, ip: I8Planar, *, bias=None,
              act_from_col: int | None = None, out_dtype=None, lora_h=None,
              lora_up=None) -> torch.Tensor:
    """Quantize x per row, then launch the w8a8 kernel (K4). x: (..., K)
    CUDA tensor; ip: 2-D int8 weight (a depth slice of a stacked one is
    fine). Output (..., R) in ``out_dtype`` (default x.dtype)."""
    R, K = ip.shape
    if not x.is_cuda:
        raise ValueError("i8mm_cuda takes CUDA tensors")
    xq, xs = quantize_rows(x.reshape(-1, K))
    out = i8mm_cuda_q(xq, xs, ip, bias=bias, act_from_col=act_from_col,
                      lora_h=lora_h, lora_up=lora_up)
    return out.reshape(*x.shape[:-1], R).to(out_dtype or x.dtype)


def i8mm_cuda_q(xq: torch.Tensor, xs: torch.Tensor, ip: I8Planar, *,
                bias=None, act_from_col: int | None = None,
                bn: int | None = None, lora_h=None,
                lora_up=None) -> torch.Tensor:
    """The K4 launch on already-quantized rows: xq (M, K) int8, xs (M, 1)
    float32 -> (M, R) bf16; with ``lora_h``/``lora_up`` (see
    ``ops.qmatmul.prep_lora``) its LoRA instance. ``bn`` (128 or 256)
    overrides the tile width that ``i8mm_plan`` picks. The kernel stores
    its rows by TMA, whose row strides are multiples of 16 bytes: where R is
    not a multiple of 8 the result is a view of rows padded to one."""
    R, K = ip.shape
    dev = xq.device
    if ip.qs.dim() != 2:
        raise ValueError(f"i8mm takes a 2-D weight, got qs "
                         f"{tuple(ip.qs.shape)} (index a stacked weight)")
    rp, kp = ip.qs.shape
    if ip.qs.dtype != torch.int8 or ip.scales.dtype != torch.float32:
        raise TypeError(f"i8 dtypes {ip.qs.dtype}/{ip.scales.dtype}")
    if kp % 128 or rp % 128 or R > rp or K > kp or K % 16:
        raise ValueError(f"untileable int8 weight: shape {ip.shape}, "
                         f"padded ({rp}, {kp})")
    if bn is not None and bn not in I8MM_WIDTHS:
        raise ValueError(f"tile width {bn} not in {I8MM_WIDTHS}")
    for t in (ip.qs, ip.scales):
        if t.device != dev or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("int8 weight tensors must be contiguous, "
                             "16-byte aligned, on the activations' device")
    if xq.dtype != torch.int8 or xq.dim() != 2 or xq.shape[1] != K:
        raise ValueError(f"xq {xq.dtype} {tuple(xq.shape)}: want int8 "
                         f"(M, {K})")
    xq, xs = _aligned(xq), _aligned(xs.to(torch.float32))
    m = xq.shape[0]
    ldo = -(-R // 8) * 8
    out = torch.empty((m, ldo), dtype=torch.bfloat16, device=dev)
    if m:
        b = None
        if bias is not None:
            b = _aligned(bias.to(device=dev, dtype=torch.float32))
            if b.shape != (R,):
                raise ValueError(f"bias {tuple(b.shape)} != ({R},)")
        ptrs = (xq.data_ptr(), xs.data_ptr(), ip.qs.data_ptr(),
                ip.scales.data_ptr(), None if b is None else b.data_ptr(),
                out.data_ptr())
        act = -1 if act_from_col is None else int(act_from_col)
        bn = bn or i8mm_plan(m, R)[0]
        stream = ctypes.c_void_p(_build.stream_handle(dev))
        if lora_h is not None or lora_up is not None:
            # rounded to bf16 whatever their dtype, as the reference's
            # pallas_i8mm rounds them (its xla_i8mm, like plain_i8mm,
            # computes in theirs)
            h, up, rk = prep_lora(lora_h, lora_up, m, R, rp, torch.bfloat16)
            if h.device != dev or up.device != dev:
                raise ValueError("LoRA operands must be on x's device")
            rc = _build.lib().i8mm_lora_launch(
                *ptrs, h.data_ptr(), up.data_ptr(), m, K, kp, R, rp, ldo, rk,
                act, bn, stream)
            name = "i8mm_lora"
        else:
            rc = _build.lib().i8mm_launch(*ptrs, m, K, kp, R, rp, ldo, act,
                                          bn, stream)
            name = "i8mm"
        _build.check(rc, name + " launch")
        _build.count(name)
    return out[:, :R]


def i8_matmul(x: torch.Tensor, ip: I8Planar, *, out_dtype=None, bias=None,
              act_from_col: int | None = None, lora_h=None,
              lora_up=None) -> torch.Tensor:
    """w8a8 x @ W^T (+ the LoRA rank term h @ upᵀ, bias, GELU-tanh from a
    column): CUDA tensors launch the kernel, CPU tensors take the plain
    version."""
    if x.is_cuda:
        return i8mm_cuda(x, ip, bias=bias, act_from_col=act_from_col,
                         out_dtype=out_dtype, lora_h=lora_h, lora_up=lora_up)
    return plain_i8mm(x, ip, out_dtype=out_dtype, bias=bias,
                      act_from_col=act_from_col, lora_h=lora_h,
                      lora_up=lora_up)
