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

A ``quant.planar.TPShard`` leaf is a tensor-parallel shard: ``linear``
runs the local matmul and the collective its mode names (``_tp_linear``)
over the mesh of the enclosing ``parallel.collectives.active`` scope, and
a ``TPNormShard`` norm scale reduces its statistics over that mesh.
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
from ..parallel import collectives
from ..quant.planar import (PlanarQuant, TPNormShard, TPShard,
                            dequantize as planar_dequantize)


@dataclasses.dataclass(frozen=True)
class QuantConfig:
    """Runtime dequant policy: the reference loader's ``dequant_dtype`` and
    LoRA ``patch_dtype`` knobs. Kernel or plain path follows the device; on
    the card the fused kernels compute in ``dequant_dtype`` and round the
    LoRA rank operands to it (the w8a8 kernel to bfloat16), as the
    reference's kernels do."""

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
    weight; of a ``TPShard``, what ``linear`` returns on a rank: the
    shard's columns, or all of them for a "gather" weight."""
    if isinstance(weight, TPShard):
        n = (collectives.axis_size(weight.axis) if weight.mode == "gather"
             else 1)
        return n * out_features(weight.inner)
    if isinstance(weight, PatchedWeight):
        return out_features(weight.base)
    if is_quantized(weight):
        return weight.out_features
    return int(weight.shape[-2])  # dense (…, R, K)


def in_features(weight) -> int:
    """Logical in-features (K) of a dense, packed or LoRA-patched linear
    weight (a ``TPShard``'s own, as ``out_features``)."""
    if isinstance(weight, TPShard):
        return in_features(weight.inner)
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
    """x (B, ..., K) @ Wᵀ in f32 on operands rounded to the compute dtype,
    each sample alone (``_each_sample``)."""
    cd = cfg.compute_dtype
    wt = weight.to(cd).to(torch.float32).T
    out = _each_sample(
        lambda xs: torch.matmul(xs.to(cd).to(torch.float32), wt), x)
    return out.to(x.dtype)


def _packed_matmul(x, weight, cfg: QuantConfig, **kw):
    """The fused kernel (or its plain version) of a packed weight; ``kw``
    carries bias, act_from_col and the LoRA operands."""
    if isinstance(weight, I8Planar):
        return i8_matmul(x, weight, out_dtype=x.dtype, **kw)
    return quantized_matmul(x, weight, dequant_dtype=cfg.dequant_dtype,
                            out_dtype=x.dtype, **kw)


def _tp_linear(x, weight: TPShard, bias, cfg, inner_fn, **inner_kw):
    """The collective of a ``TPShard`` weight around its local matmul:
    "row" all-reduces in the output's dtype and adds the bias once after
    it; "gather" adds the local bias, then all-gathers the columns; "col"
    is local."""
    if weight.mode == "row":
        out = collectives.psum(
            inner_fn(x, weight.inner, None, cfg=cfg, **inner_kw),
            weight.axis)
        if bias is not None:
            out = out + bias.to(out.dtype)
        return out
    if weight.mode not in ("col", "gather"):
        raise ValueError(f"unknown TPShard mode {weight.mode!r}")
    out = inner_fn(x, weight.inner, bias, cfg=cfg, **inner_kw)
    if weight.mode == "gather":
        return collectives.all_gather(out, weight.axis, dim=-1)
    return out


def linear(x: torch.Tensor, weight, bias=None, *,
           cfg: QuantConfig = DEFAULT_CONFIG) -> torch.Tensor:
    """x: (..., K) -> (..., R). weight: PlanarQuant, I8Planar, dense (R, K)
    or ``lora.PatchedWeight`` over one of them: rank patches on a packed
    base ride the kernel's epilogue, the others take the unfused one. A
    ``TPShard`` runs its shard and its collective (``_tp_linear``)."""
    if isinstance(weight, TPShard):
        return _tp_linear(x, weight, bias, cfg, linear)
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
    take the unfused composition.

    A ``TPShard``: "col" fuses bias and GELU into its shard's kernel
    (``tail_from`` is then the shard-local column), and so does "gather"
    over its whole output; "row" applies GELU to the full output after the
    all-reduce (GELU of a sum is not the sum of GELUs) and refuses
    ``tail_from`` > 0. A gather weight with ``tail_from`` > 0 activates the
    global columns after the gather (the reference would take the offset
    as shard-local; no table of either package does this)."""
    if isinstance(weight, TPShard):
        if weight.mode == "col" or (weight.mode == "gather"
                                    and not tail_from):
            return _tp_linear(x, weight, bias, cfg, linear_gelu,
                              tail_from=tail_from)
        if weight.mode == "row" and tail_from:
            raise ValueError(
                "linear_gelu(tail_from>0) is unsupported for row-parallel "
                "TPShard weights (a local offset against a full-width "
                "output)")
        return _host_epilogue(_tp_linear(x, weight, bias, cfg, linear),
                              None, tail_from)
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
    """LayerNorm with optional affine, f32 statistics. A ``TPNormShard``
    weight marks x's feature axis as sharded: the statistics reduce over
    its mesh axis against the full width."""
    if isinstance(weight, TPNormShard):
        xf = x.to(torch.float32)
        n = float(weight.full_dim)
        mu = collectives.psum(xf.sum(dim=-1, keepdim=True), weight.axis) / n
        ss = collectives.psum((xf - mu).square().sum(dim=-1, keepdim=True),
                              weight.axis)
        y = (xf - mu) * torch.rsqrt(ss / n + eps)
        y = y * weight.weight.to(torch.float32)
        if bias is not None:
            b = bias.weight if isinstance(bias, TPNormShard) else bias
            y = y + materialize(b, torch.float32)
        return y.to(x.dtype)
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
    parameterizations. A ``TPNormShard`` weight reduces the sum of squares
    over its mesh axis against the full width (full-width norms over
    column-sharded activations, Wan's q/k norms)."""
    xf = x.to(torch.float32)
    if isinstance(weight, TPNormShard):
        ss = collectives.psum(xf.square().sum(dim=-1, keepdim=True),
                              weight.axis)
        y = xf * torch.rsqrt(ss / float(weight.full_dim) + eps)
        return (y * (weight.weight.to(torch.float32) + offset)).to(x.dtype)
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


def _each_sample(fn, x: torch.Tensor, *args, **kw) -> torch.Tensor:
    """``fn`` on each batch element of ``x`` alone, concatenated.

    cuDNN picks a convolution's algorithm, cuBLAS a dense matmul's kernel
    (GEMV at one row, GEMM at more) and the reduction kernels their split
    by the whole tensor's shape, so a batched call sums a sample in another
    order than the same sample alone. A served request would then depend
    on the batch it shares, and a UNet's CFG step (the difference of two
    forwards, times the scale) carries that to 1e-2 of the latent and more.
    Per sample, a request gives the same bits at every batch size
    (``tools_batch_invariance_cuda.py`` checks it and times the cost). The
    fused kernels and attention are row-independent already."""
    if x.shape[0] == 1:
        return fn(x, *args, **kw)
    return torch.cat([fn(x[i:i + 1], *args, **kw)
                      for i in range(x.shape[0])])


def group_norm(x: torch.Tensor, weight=None, bias=None, *,
               num_groups: int = 32, eps: float = 1e-6) -> torch.Tensor:
    """GroupNorm over channel-minor (B, ..., C) input, f32 statistics over
    each group's positions and channels, written out in the reference's
    order of operations; each sample alone (``_each_sample``)."""
    return _each_sample(_group_norm, x, weight, bias, num_groups, eps)


def _group_norm(x, weight, bias, num_groups: int, eps: float):
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
    does the port: ``F.conv2d`` on a channels-last view, each sample alone
    (``_each_sample``).
    """
    cd = cfg.compute_dtype
    w = materialize(weight, cd)
    # the CPU has no f32-accumulating bf16 conv: widen the operands there
    w = (w.contiguous(memory_format=torch.channels_last) if x.is_cuda
         else w.to(torch.float32))
    xc = x.to(cd).permute(0, 3, 1, 2)  # NCHW view of channels-last storage
    if not isinstance(padding, int):
        (pt, pb), (pl, pr) = padding
        xc = F.pad(xc, (pl, pr, pt, pb))
        padding = 0
    out = _each_sample(lambda xs: F.conv2d(xs.to(w.dtype), w, stride=stride,
                                           padding=padding), xc)
    out = out.permute(0, 2, 3, 1).to(x.dtype)
    if bias is not None:
        out = out + bias.to(out.dtype)
    return out


def conv3d(x: torch.Tensor, weight, bias=None, *, stride=1, padding=0,
           cfg: QuantConfig = DEFAULT_CONFIG) -> torch.Tensor:
    """3-D conv (the video patch embeds and VAEs), (B, T, H, W, C)
    activations, weight (O, I, kt, kh, kw) dense or packed. Operands are
    rounded to ``cfg.compute_dtype`` and accumulated in f32. ``stride`` is
    an int or a triple; ``padding`` an int or ((front, back), (top,
    bottom), (left, right)).

    The reference computes this outside any hand-written kernel, and so
    does the port: ``F.conv3d`` on a channels-last-3d view, each sample
    alone (``_each_sample``), as ``conv2d``.
    """
    cd = cfg.compute_dtype
    w = materialize(weight, cd)
    # the CPU has no f32-accumulating bf16 conv: widen the operands there
    w = (w.contiguous(memory_format=torch.channels_last_3d) if x.is_cuda
         else w.to(torch.float32))
    xc = x.to(cd).permute(0, 4, 1, 2, 3)  # NCDHW view of NDHWC storage
    if not isinstance(padding, int):
        (pf, pk), (pt, pb), (pl, pr) = padding
        xc = F.pad(xc, (pl, pr, pt, pb, pf, pk))
        padding = 0
    out = _each_sample(lambda xs: F.conv3d(xs.to(w.dtype), w, stride=stride,
                                           padding=padding), xc)
    out = out.permute(0, 2, 3, 4, 1).to(x.dtype)
    if bias is not None:
        out = out + bias.to(out.dtype)
    return out
