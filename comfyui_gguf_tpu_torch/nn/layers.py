"""Quantization-aware functional layers (PyTorch port of
comfyui_gguf_tpu/nn/layers.py).

A weight leaf is a dense tensor, a packed ``PlanarQuant`` or an
``I8Planar``. Packed weights never materialize on the device: ``linear``
routes them through the fused kernels (ops/). Dense 2-D weights take a
plain ``torch.matmul`` with f32 accumulation, as the reference leaves them
to XLA. Norms keep f32 statistics.

Images keep the reference's channel-minor (B, H, W, C) order at every public
function; ``conv2d`` hands them to ``F.conv2d`` as channels-last views.

A ``lora.PatchedWeight`` leaf carries LoRA patches on any of these
bases: rank patches on a packed base ride the fused kernel's epilogue as
one (h, upᵀ) pair (``lora.rank_factorize``), GLoRA's weight term rewrites
the kernel's input, and dense-delta patches (diff, LoHa, LoKr) and dense
bases take the unfused epilogue (``lora.apply_patch_epilogue``).

Not ported yet: ``conv3d`` and the tensor-parallel branches (the
parallelism slice).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch
import torch.nn.functional as F

from ..lora import (PatchedWeight, apply_patch_epilogue,
                    apply_patch_prologue, rank_factorize)
from ..ops.i8mm import i8_matmul
from ..ops.qmatmul import _host_epilogue, quantized_matmul
from ..quant.i8 import I8Planar, dequantize_i8
from ..quant.planar import PlanarQuant, dequantize as planar_dequantize


@dataclasses.dataclass(frozen=True)
class QuantConfig:
    """Runtime dequant policy: the reference loader's ``dequant_dtype`` and
    LoRA ``patch_dtype`` knobs. Kernel or plain path follows the device; on
    the card the kernels take bfloat16 LoRA operands."""

    dequant_dtype: Any = torch.bfloat16
    patch_dtype: Any = None  # None = follow dequant_dtype
    compute_dtype: Any = torch.bfloat16

    @property
    def effective_patch_dtype(self):
        return self.patch_dtype or self.dequant_dtype


DEFAULT_CONFIG = QuantConfig()


def is_quantized(leaf) -> bool:
    return isinstance(leaf, (PlanarQuant, I8Planar))


def out_features(weight) -> int:
    """Logical out-features (R) of a dense, packed or LoRA-patched linear
    weight."""
    if isinstance(weight, PatchedWeight):
        return out_features(weight.base)
    if is_quantized(weight):
        return weight.out_features
    return int(weight.shape[-2])  # dense (…, R, K)


def in_features(weight) -> int:
    """Logical in-features (K) of a dense, packed or LoRA-patched linear
    weight."""
    if isinstance(weight, PatchedWeight):
        return in_features(weight.base)
    if is_quantized(weight):
        return weight.in_features
    return int(weight.shape[-1])


def materialize(leaf, dtype=torch.float32) -> torch.Tensor:
    """Dense logical-shape weight from any leaf (debug / fallback path).
    A PatchedWeight folds its LoRA deltas into the dense result."""
    if isinstance(leaf, PatchedWeight):
        w = materialize(leaf.base, torch.float32)
        shape = w.shape
        # conv weights (O, I, kh, kw) fold to the (O, I·kh·kw) matrix the
        # rank factors were trained against (kohya LoCon flattens the same
        # way)
        w = w.reshape(shape[0], -1)
        w0 = w
        for p in leaf.patches:
            if p.a1 is not None:  # GLoRA: + s·W@a2@a1
                w = w + p.scale * (w0 @ p.a2.to(torch.float32)
                                   @ p.a1.to(torch.float32))
            if p.diff is not None:
                w = w + p.scale * p.diff.to(torch.float32).reshape(w.shape)
            elif p.up is not None:
                down = p.down.to(torch.float32)
                if p.mid is not None:
                    down = p.mid.to(torch.float32) @ down
                delta = p.up.to(torch.float32) @ down
                w = w + p.scale * delta.reshape(w.shape)
        return w.reshape(shape).to(dtype)
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


def _packed_matmul(x, weight, cfg: QuantConfig, **kw):
    """The fused kernel (or its plain version) of a packed weight; ``kw``
    carries bias, act_from_col and the LoRA operands."""
    if isinstance(weight, I8Planar):
        return i8_matmul(x, weight, out_dtype=x.dtype, **kw)
    return quantized_matmul(x, weight, dequant_dtype=cfg.dequant_dtype,
                            out_dtype=x.dtype, **kw)


def linear(x: torch.Tensor, weight, bias=None, *,
           cfg: QuantConfig = DEFAULT_CONFIG) -> torch.Tensor:
    """x: (..., K) -> (..., R). weight: PlanarQuant, I8Planar, dense (R, K)
    or ``lora.PatchedWeight`` over one of them: rank patches on a packed
    base ride the kernel's epilogue, the others take the unfused one."""
    patches = None
    fac = None  # (h, upᵀ) rank factorization for the kernel epilogue
    x_in = x  # the epilogue's b-branches see the unrewritten input
    pdt = cfg.effective_patch_dtype
    if isinstance(weight, PatchedWeight):
        patches, weight = weight.patches, weight.base
        if any(p.a1 is not None for p in patches):
            x = apply_patch_prologue(x, patches, patch_dtype=pdt)
        if is_quantized(weight):
            # dense-delta patches (diff / LoHa / LoKr) give None and take
            # the unfused epilogue below
            fac = rank_factorize(x_in, patches, patch_dtype=pdt)
    if is_quantized(weight):
        lh, lu = fac if fac is not None else (None, None)
        out = _packed_matmul(x, weight, cfg, lora_h=lh, lora_up=lu)
    else:
        out = _dense_linear(x, weight, cfg)
    if patches and fac is None:
        out = apply_patch_epilogue(x_in, out, patches, patch_dtype=pdt)
    if bias is not None:
        out = out + bias.to(out.dtype)
    return out


def linear_gelu(x: torch.Tensor, weight, bias=None, *, tail_from: int = 0,
                cfg: QuantConfig = DEFAULT_CONFIG) -> torch.Tensor:
    """linear() then GELU-tanh on output columns >= ``tail_from`` (0 = the
    whole output). For packed weights bias and activation run in the
    kernel epilogue on the f32 accumulator, after the LoRA rank term (so the
    patch equals patching W); only dense-delta patches and dense weights
    take the unfused composition."""
    base, patches = weight, None
    if isinstance(weight, PatchedWeight):
        base, patches = weight.base, weight.patches
    if is_quantized(base):
        pdt = cfg.effective_patch_dtype
        fac = (None if patches is None
               else rank_factorize(x, patches, patch_dtype=pdt))
        if patches is None or fac is not None:
            xk = x
            if patches is not None and any(p.a1 is not None
                                           for p in patches):
                xk = apply_patch_prologue(x, patches, patch_dtype=pdt)
            lh, lu = fac if fac is not None else (None, None)
            return _packed_matmul(xk, base, cfg, bias=bias,
                                  act_from_col=tail_from, lora_h=lh,
                                  lora_up=lu)
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
    ``cfg.dequant_dtype``), never the whole table. A LoRA-patched table is
    not taken, as in the reference."""
    if isinstance(table, PatchedWeight):
        raise TypeError("embedding takes no LoRA-patched table")
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
