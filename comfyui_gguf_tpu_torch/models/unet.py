"""SD1 / SDXL UNet (PyTorch port of comfyui_gguf_tpu/models/unet.py).

The sgm ``input_blocks/middle_block/output_blocks`` graph, introspected
from the state dict: each numbered block is classified by its sub-keys
(``.0.op`` downsample conv, ``.0.in_layers`` ResBlock, ``.N.norm`` +
``.N.proj_in`` SpatialTransformer with its depth counted from its
transformer_blocks, trailing upsample conv), so SD1, SD2 and SDXL layouts
load from the same code without per-arch tables.

(B, H, W, C) activations throughout, as in the reference; convolutions go
through ``nn.layers.conv2d`` (outside any hand-written kernel, as the
reference leaves them to XLA), the linears through ``nn.layers.linear`` and
so the fused kernels, and attention, heads-major over H·W tokens with
cross-attention against the CLIP context, through the flash kernel (SD1's
head dims 40, 80 and 160 included).
"""

from __future__ import annotations

import dataclasses
import re

import torch
import torch.nn.functional as F

from ..nn.attention import dot_product_attention
from ..nn.layers import (QuantConfig, DEFAULT_CONFIG, conv2d, group_norm,
                         layer_norm, linear)
from .flux import timestep_embedding


@dataclasses.dataclass(frozen=True)
class UNetConfig:
    model_channels: int
    context_dim: int
    adm_in_channels: int | None  # SDXL pooled+size embeds (2816); None = SD1
    head_dim: int | None  # SDXL: 64; SD1 uses fixed num_heads
    num_heads: int | None  # SD1: 8

    @staticmethod
    def from_state_dict(sd) -> "UNetConfig":
        mc = int(sd["input_blocks.0.0.weight"].shape[0])
        ctx = None
        for k in sd:
            if k.endswith(".attn2.to_k.weight"):
                ctx = int(sd[k].shape[1])
                break
        if "label_emb.0.0.weight" in sd:
            adm = int(sd["label_emb.0.0.weight"].shape[1])
            return UNetConfig(mc, ctx or 2048, adm, head_dim=64,
                              num_heads=None)
        return UNetConfig(mc, ctx or 768, None, head_dim=None, num_heads=8)


# ---------------------------------------------------------------------------
# building blocks
# ---------------------------------------------------------------------------

def _silu(x: torch.Tensor) -> torch.Tensor:
    return F.silu(x.to(torch.float32)).to(x.dtype)


def _resblock(params, p: str, x, emb, qcfg):
    h = group_norm(x, params[f"{p}.in_layers.0.weight"],
                   params[f"{p}.in_layers.0.bias"], eps=1e-5)
    h = conv2d(_silu(h), params[f"{p}.in_layers.2.weight"],
               params[f"{p}.in_layers.2.bias"], padding=1, cfg=qcfg)
    eo = linear(_silu(emb), params[f"{p}.emb_layers.1.weight"],
                params[f"{p}.emb_layers.1.bias"], cfg=qcfg)
    h = h + eo[:, None, None, :].to(h.dtype)
    h = group_norm(h, params[f"{p}.out_layers.0.weight"],
                   params[f"{p}.out_layers.0.bias"], eps=1e-5)
    h = conv2d(_silu(h), params[f"{p}.out_layers.3.weight"],
               params[f"{p}.out_layers.3.bias"], padding=1, cfg=qcfg)
    if f"{p}.skip_connection.weight" in params:
        x = conv2d(x, params[f"{p}.skip_connection.weight"],
                   params[f"{p}.skip_connection.bias"], cfg=qcfg)
    return x + h


def _mh_attn(q, k, v, n_heads: int):
    """(B, L, H·D) projections → heads-major views → (B, Lq, H·D)."""
    B, Lq, D = q.shape
    Lk = k.shape[1]
    hd = D // n_heads
    kd = k.shape[2] // n_heads
    q = q.reshape(B, Lq, n_heads, hd).transpose(1, 2)
    k = k.reshape(B, Lk, n_heads, kd).transpose(1, 2)
    v = v.reshape(B, Lk, n_heads, kd).transpose(1, 2)
    out = dot_product_attention(q, k, v)
    return out.transpose(1, 2).reshape(B, Lq, D)


def _basic_block(params, p: str, x, context, n_heads: int, qcfg):
    # self-attention
    h = layer_norm(x, params[f"{p}.norm1.weight"], params[f"{p}.norm1.bias"])
    q = linear(h, params[f"{p}.attn1.to_q.weight"], cfg=qcfg)
    k = linear(h, params[f"{p}.attn1.to_k.weight"], cfg=qcfg)
    v = linear(h, params[f"{p}.attn1.to_v.weight"], cfg=qcfg)
    a = _mh_attn(q, k, v, n_heads)
    x = x + linear(a, params[f"{p}.attn1.to_out.0.weight"],
                   params[f"{p}.attn1.to_out.0.bias"], cfg=qcfg)
    # cross-attention
    h = layer_norm(x, params[f"{p}.norm2.weight"], params[f"{p}.norm2.bias"])
    q = linear(h, params[f"{p}.attn2.to_q.weight"], cfg=qcfg)
    k = linear(context, params[f"{p}.attn2.to_k.weight"], cfg=qcfg)
    v = linear(context, params[f"{p}.attn2.to_v.weight"], cfg=qcfg)
    a = _mh_attn(q, k, v, n_heads)
    x = x + linear(a, params[f"{p}.attn2.to_out.0.weight"],
                   params[f"{p}.attn2.to_out.0.bias"], cfg=qcfg)
    # GEGLU feed-forward (exact GELU on the gate half)
    h = layer_norm(x, params[f"{p}.norm3.weight"], params[f"{p}.norm3.bias"])
    h = linear(h, params[f"{p}.ff.net.0.proj.weight"],
               params[f"{p}.ff.net.0.proj.bias"], cfg=qcfg)
    a, gate = torch.chunk(h, 2, dim=-1)
    h = a * F.gelu(gate.to(torch.float32)).to(a.dtype)
    return x + linear(h, params[f"{p}.ff.net.2.weight"],
                      params[f"{p}.ff.net.2.bias"], cfg=qcfg)


def _spatial_transformer(params, p: str, x, context, cfg: UNetConfig, qcfg):
    B, H, W, C = x.shape
    n_heads = cfg.num_heads or C // cfg.head_dim
    h = group_norm(x, params[f"{p}.norm.weight"], params[f"{p}.norm.bias"],
                   eps=1e-6)
    w_in = params[f"{p}.proj_in.weight"]
    if len(w_in.shape) == 2:  # SDXL stores proj_in/out as linear
        h = linear(h.reshape(B, H * W, C), w_in, params[f"{p}.proj_in.bias"],
                   cfg=qcfg)
    else:  # SD1: 1x1 convs
        h = conv2d(h, w_in, params[f"{p}.proj_in.bias"], cfg=qcfg)
        h = h.reshape(B, H * W, C)
    i = 0
    while f"{p}.transformer_blocks.{i}.norm1.weight" in params:
        h = _basic_block(params, f"{p}.transformer_blocks.{i}", h, context,
                         n_heads, qcfg)
        i += 1
    w_out = params[f"{p}.proj_out.weight"]
    if len(w_out.shape) == 2:
        h = linear(h, w_out, params[f"{p}.proj_out.bias"], cfg=qcfg)
        h = h.reshape(B, H, W, C)
    else:
        h = conv2d(h.reshape(B, H, W, C), w_out,
                   params[f"{p}.proj_out.bias"], cfg=qcfg)
    return x + h


def _apply_numbered_block(params, prefix: str, x, emb, context, cfg, qcfg):
    """One input/output block entry: iterate its sub-modules by index."""
    j = 0
    while True:
        p = f"{prefix}.{j}"
        if f"{p}.op.weight" in params:  # downsample
            # the LDM/SGM UNet Downsample is a symmetric padding=1 stride-2
            # conv (the asymmetric (0, 1) pad belongs to the VAE encoder)
            x = conv2d(x, params[f"{p}.op.weight"], params[f"{p}.op.bias"],
                       stride=2, padding=1, cfg=qcfg)
        elif f"{p}.in_layers.0.weight" in params:  # resblock
            x = _resblock(params, p, x, emb, qcfg)
        elif f"{p}.norm.weight" in params and f"{p}.proj_in.weight" in params:
            x = _spatial_transformer(params, p, x, context, cfg, qcfg)
        elif f"{p}.conv.weight" in params:  # nearest 2x upsample + conv
            x = x.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)
            x = conv2d(x, params[f"{p}.conv.weight"],
                       params[f"{p}.conv.bias"], padding=1, cfg=qcfg)
        elif f"{p}.weight" in params:  # bare conv (input_blocks.0.0)
            x = conv2d(x, params[f"{p}.weight"], params.get(f"{p}.bias"),
                       padding=1, cfg=qcfg)
        else:
            break
        j += 1
    return x


def _count_blocks(params, section: str) -> int:
    n = -1
    pat = re.compile(rf"^{section}\.(\d+)\.")
    for k in params:
        m = pat.match(k)
        if m:
            n = max(n, int(m.group(1)))
    return n + 1


def forward(params, cfg: UNetConfig, x, timesteps, context, y=None,
            qcfg: QuantConfig = DEFAULT_CONFIG) -> torch.Tensor:
    """x (B, H, W, C) latent, timesteps (B,) discrete-schedule floats,
    context (B, L, context_dim) CLIP states, y (B, adm_in) SDXL vector →
    eps (B, H, W, C)."""
    temb = timestep_embedding(timesteps, cfg.model_channels, time_factor=1.0)
    emb = linear(temb.to(x.dtype), params["time_embed.0.weight"],
                 params["time_embed.0.bias"], cfg=qcfg)
    emb = linear(_silu(emb), params["time_embed.2.weight"],
                 params["time_embed.2.bias"], cfg=qcfg)
    if cfg.adm_in_channels is not None:
        if y is None:
            raise ValueError("SDXL UNet needs the pooled/size vector y")
        v = linear(y.to(x.dtype), params["label_emb.0.0.weight"],
                   params["label_emb.0.0.bias"], cfg=qcfg)
        v = linear(_silu(v), params["label_emb.0.2.weight"],
                   params["label_emb.0.2.bias"], cfg=qcfg)
        emb = emb + v

    hs = []
    h = x
    for i in range(_count_blocks(params, "input_blocks")):
        h = _apply_numbered_block(params, f"input_blocks.{i}", h, emb,
                                  context, cfg, qcfg)
        hs.append(h)

    h = _apply_numbered_block(params, "middle_block", h, emb, context, cfg,
                              qcfg)

    for i in range(_count_blocks(params, "output_blocks")):
        h = torch.cat([h, hs.pop()], dim=-1)
        h = _apply_numbered_block(params, f"output_blocks.{i}", h, emb,
                                  context, cfg, qcfg)

    h = group_norm(h, params["out.0.weight"], params["out.0.bias"], eps=1e-5)
    return conv2d(_silu(h), params["out.2.weight"], params["out.2.bias"],
                  padding=1, cfg=qcfg)
