"""Quantization-aware functional layers (PyTorch port of
comfyui_gguf_tpu/nn/layers.py).

A weight leaf is a dense tensor, a packed ``PlanarQuant`` or an
``I8Planar``. Packed weights never materialize on the device: ``linear``
routes them through the fused kernels (ops/). Dense 2-D weights take a
plain ``torch.matmul`` with f32 accumulation, as the reference leaves them
to XLA. Norms keep f32 statistics.

Images keep the reference's channel-minor (B, H, W, C) order at every public
function; ``conv2d`` hands them to ``F.conv2d`` as channels-last views.

Not ported yet: ``conv3d``, the tensor-parallel branches (the parallelism
slice) and LoRA-patched weights (the LoRA slice), which raise
``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch
import torch.nn.functional as F

from ..ops.i8mm import i8_matmul
from ..ops.qmatmul import _host_epilogue, quantized_matmul
from ..quant.i8 import I8Planar, dequantize_i8
from ..quant.planar import PlanarQuant, dequantize as planar_dequantize


@dataclasses.dataclass(frozen=True)
class QuantConfig:
    """Runtime dequant policy (the reference loader's ``dequant_dtype``
    knob; its LoRA ``patch_dtype`` arrives with the LoRA slice). Kernel or
    plain path follows the device."""

    dequant_dtype: Any = torch.bfloat16
    compute_dtype: Any = torch.bfloat16


DEFAULT_CONFIG = QuantConfig()


def _no_lora(weight):
    if hasattr(weight, "patches") and hasattr(weight, "base"):
        raise NotImplementedError(
            "LoRA-patched weights arrive with the LoRA slice of the port")


def is_quantized(leaf) -> bool:
    return isinstance(leaf, (PlanarQuant, I8Planar))


def out_features(weight) -> int:
    """Logical out-features (R) of a dense or packed linear weight."""
    if is_quantized(weight):
        return weight.out_features
    return int(weight.shape[-2])  # dense (…, R, K)


def in_features(weight) -> int:
    """Logical in-features (K) of a dense or packed linear weight."""
    if is_quantized(weight):
        return weight.in_features
    return int(weight.shape[-1])


def materialize(leaf, dtype=torch.float32) -> torch.Tensor:
    """Dense logical-shape weight from any leaf (debug / fallback path)."""
    _no_lora(leaf)
    if isinstance(leaf, PlanarQuant):
        return planar_dequantize(leaf, dtype)
    if isinstance(leaf, I8Planar):
        return dequantize_i8(leaf, dtype)
    return leaf.to(dtype)


def _dense_linear(x, weight, cfg: QuantConfig):
    cd = cfg.compute_dtype
    out = torch.matmul(x.to(cd).to(torch.float32),
                       weight.to(cd).to(torch.float32).T)
    return out.to(x.dtype)


def linear(x: torch.Tensor, weight, bias=None, *,
           cfg: QuantConfig = DEFAULT_CONFIG) -> torch.Tensor:
    """x: (..., K) -> (..., R). weight: PlanarQuant, I8Planar or dense
    (R, K)."""
    _no_lora(weight)
    if isinstance(weight, I8Planar):
        out = i8_matmul(x, weight, out_dtype=x.dtype)
    elif isinstance(weight, PlanarQuant):
        out = quantized_matmul(x, weight, dequant_dtype=cfg.dequant_dtype,
                               out_dtype=x.dtype)
    else:
        out = _dense_linear(x, weight, cfg)
    if bias is not None:
        out = out + bias.to(out.dtype)
    return out


def linear_gelu(x: torch.Tensor, weight, bias=None, *, tail_from: int = 0,
                cfg: QuantConfig = DEFAULT_CONFIG) -> torch.Tensor:
    """linear() then GELU-tanh on output columns >= ``tail_from`` (0 = the
    whole output); for packed weights bias and activation run in the
    kernel epilogue on the f32 accumulator."""
    _no_lora(weight)
    if isinstance(weight, I8Planar):
        return i8_matmul(x, weight, out_dtype=x.dtype, bias=bias,
                         act_from_col=tail_from)
    if isinstance(weight, PlanarQuant):
        return quantized_matmul(x, weight, dequant_dtype=cfg.dequant_dtype,
                                out_dtype=x.dtype, bias=bias,
                                act_from_col=tail_from)
    return _host_epilogue(linear(x, weight, None, cfg=cfg), bias, tail_from)


def layer_norm(x: torch.Tensor, weight=None, bias=None, *,
               eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm with optional affine, f32 statistics."""
    if weight is None and bias is None:
        # one fused op: statistics and normalization in f32, one rounding
        # to x's dtype at the end, as below
        return F.layer_norm(x, (x.shape[-1],), eps=eps)
    xf = x.to(torch.float32)
    mu = xf.mean(dim=-1, keepdim=True)
    var = (xf - mu).square().mean(dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    if weight is not None:
        y = y * materialize(weight, torch.float32)
    if bias is not None:
        y = y + materialize(bias, torch.float32)
    return y.to(x.dtype)


def rms_norm(x: torch.Tensor, weight=None, *, eps: float = 1e-6,
             offset: float = 0.0) -> torch.Tensor:
    """RMSNorm (T5/Llama style), f32 statistics; ``offset=1.0`` for (1+w)
    parameterizations."""
    xf = x.to(torch.float32)
    var = xf.square().mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    if weight is not None:
        y = y * (materialize(weight, torch.float32) + offset)
    return y.to(x.dtype)


def embedding(ids: torch.Tensor, table, *,
              cfg: QuantConfig = DEFAULT_CONFIG) -> torch.Tensor:
    """ids: int (...,) -> (..., D). table: dense (V, D), or a packed
    (V, D) weight, of which only the looked-up rows are dequantized (to
    ``cfg.dequant_dtype``), never the whole table."""
    _no_lora(table)
    ids = ids.to(torch.long)
    if isinstance(table, I8Planar):
        sub = I8Planar(qs=table.qs[ids.reshape(-1)],
                       scales=table.scales[..., ids.reshape(-1)],
                       qtype=table.qtype,
                       shape=(ids.numel(), table.shape[1]))
        rows = dequantize_i8(sub, cfg.dequant_dtype)
        return rows.reshape(*ids.shape, table.shape[1])
    if isinstance(table, PlanarQuant):
        flat = ids.reshape(-1)
        sub = dataclasses.replace(
            table, qs=table.qs[:, flat], scales=table.scales[:, flat],
            offsets=(None if table.offsets is None
                     else table.offsets[:, flat]),
            shape=(flat.numel(), table.shape[1]))
        rows = planar_dequantize(sub, cfg.dequant_dtype)
        return rows.reshape(*ids.shape, table.shape[1])
    return table[ids]


def group_norm(x: torch.Tensor, weight=None, bias=None, *,
               num_groups: int = 32, eps: float = 1e-6) -> torch.Tensor:
    """GroupNorm over channel-minor (B, ..., C) input, f32 statistics over
    each group's positions and channels, written out in the reference's
    order of operations."""
    c = x.shape[-1]
    xf = x.to(torch.float32).reshape(x.shape[0], -1, num_groups,
                                     c // num_groups)
    mu = xf.mean(dim=(1, 3), keepdim=True)
    xf = xf - mu
    var = xf.square().mean(dim=(1, 3), keepdim=True)
    y = (xf * torch.rsqrt(var + eps)).reshape(x.shape)
    if weight is not None:
        y = y * materialize(weight, torch.float32)
    if bias is not None:
        y = y + materialize(bias, torch.float32)
    return y.to(x.dtype)


def conv2d(x: torch.Tensor, weight, bias=None, *, stride=1, padding=0,
           cfg: QuantConfig = DEFAULT_CONFIG) -> torch.Tensor:
    """2-D conv, (B, H, W, C) activations, weight (O, I, kh, kw) dense or
    packed. Operands are rounded to ``cfg.compute_dtype`` and accumulated
    in f32. ``padding`` is an int or ((top, bottom), (left, right)).

    The reference computes this outside any hand-written kernel, and so
    does the port: ``F.conv2d`` on a channels-last view.
    """
    cd = cfg.compute_dtype
    w = materialize(weight, cd)
    xc = x.to(cd).permute(0, 3, 1, 2)  # NCHW view of channels-last storage
    if not isinstance(padding, int):
        (pt, pb), (pl, pr) = padding
        xc = F.pad(xc, (pl, pr, pt, pb))
        padding = 0
    if x.is_cuda:
        out = F.conv2d(xc, w.contiguous(memory_format=torch.channels_last),
                       stride=stride, padding=padding)
    else:  # the CPU has no f32-accumulating bf16 conv: widen the operands
        out = F.conv2d(xc.to(torch.float32), w.to(torch.float32),
                       stride=stride, padding=padding)
    out = out.permute(0, 2, 3, 1).to(x.dtype)
    if bias is not None:
        out = out + bias.to(out.dtype)
    return out
