"""Fused dequantize + matmul (PyTorch port of comfyui_gguf_tpu/ops/qmatmul.py).

Two implementations of one function, ``epi(x @ W^T)`` with W kept packed:

* ``qmm_cuda`` — wrapper of the hand-written CUDA kernel ``csrc/qmm.cu``
  (K1 for the nib4 layout, K2 for the int8 layout). The dense weight never
  reaches device memory; bias and GELU-tanh run on the f32 accumulator.
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


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """Contiguous and 16-byte aligned (a copy only where it is not)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def qmm_cuda(x: torch.Tensor, pq: PlanarQuant, *, bias=None,
             act_from_col: int | None = None, out_dtype=None) -> torch.Tensor:
    """Launch the fused dequant-matmul kernel (K1 nib4 / K2 int8).

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
            or gs not in (16, 32)):
        raise ValueError(f"untileable planar weight: shape {pq.shape}, "
                         f"padded ({kp}, {rp}), group {gs}")
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
        lib = _build.lib()
        rc = lib.qmm_launch(
            x2.data_ptr(), pq.qs.data_ptr(), pq.scales.data_ptr(),
            None if pq.offsets is None else pq.offsets.data_ptr(),
            None if b is None else b.data_ptr(), out.data_ptr(),
            m, K, kp, R, rp, gs, int(pq.zero_point), int(nib4),
            -1 if act_from_col is None else int(act_from_col),
            ctypes.c_void_p(_build.stream_handle(dev)))
        _build.check(rc, "qmm_launch")
        _build.count("qmm_nib4" if nib4 else "qmm_int8")
    return out.reshape(*lead, R).to(out_dtype or x.dtype)


def quantized_matmul(x: torch.Tensor, pq: PlanarQuant, *,
                     dequant_dtype=torch.bfloat16, out_dtype=None,
                     bias=None, act_from_col: int | None = None,
                     lora_h=None, lora_up=None) -> torch.Tensor:
    """x @ W^T with packed planar W (+ bias, GELU-tanh from a column).

    CUDA tensors launch the kernel; CPU tensors take the plain version.
    """
    if x.is_cuda:
        if lora_h is not None:
            raise NotImplementedError(
                "LoRA operands in the kernel epilogue arrive with the LoRA "
                "slice of the port")
        if dequant_dtype != torch.bfloat16:
            raise NotImplementedError(
                f"the CUDA kernel dequantizes to bfloat16, not "
                f"{dequant_dtype}")
        return qmm_cuda(x, pq, bias=bias, act_from_col=act_from_col,
                        out_dtype=out_dtype)
    return plain_quantized_matmul(
        x, pq, dequant_dtype=dequant_dtype, out_dtype=out_dtype, bias=bias,
        act_from_col=act_from_col, lora_h=lora_h, lora_up=lora_up)
