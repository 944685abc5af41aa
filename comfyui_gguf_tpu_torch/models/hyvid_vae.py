"""HunyuanVideo causal 3-D VAE, decoder and encoder (PyTorch port of
comfyui_gguf_tpu/models/hyvid_vae.py), channel-minor (B, T, H, W, C).

The public diffusers ``AutoencoderKLHunyuanVideo`` module layout, the
naming HunyuanVideo checkpoints ship with:

* ``*.conv.weight``: every conv is a CausalConv3d wrapper whose temporal
  padding is front-only (kt − 1 zero frames, so frame t never sees t+1),
  spatial padding symmetric.
* ResNet blocks ``resnets.{i}.{norm1,conv1,norm2,conv2}``: GroupNorm (32
  groups, statistics over T×H×W per group) and SiLU, ``conv_shortcut``
  where the width changes.
* The mid block ``mid_block.resnets.{0,1}`` around per-frame single-head
  spatial attention ``mid_block.attentions.0`` (group_norm, to_q/k/v,
  to_out.0 linears) through ``dot_product_attention``: on the card the
  flash kernel K7 at D = the block's width (512 in the published VAE).
  q/k/v keep the projections' dtype, as the reference's do: f32 for the
  f32 latents the pipelines decode, on K7's f32 instance.
* ``up_blocks.{i}.upsamplers.0.conv``: nearest ×2 in space, and in time
  on the deepest ``temporal_ups`` stages (the first frame stays single: T
  → 2T − 1), then a causal conv.
* ``decoder.conv_norm_out`` + SiLU + ``decoder.conv_out``.

The graph is read from the keys (block counts and widths come from the
weights), as in the reference. Frame bookkeeping: latent T ↔ pixel
1 + 4(T − 1), spatial 8×.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from ..nn.attention import dot_product_attention
from ..nn.layers import DEFAULT_CONFIG, QuantConfig, conv3d, group_norm, linear

F32 = torch.float32


def _silu(x: torch.Tensor) -> torch.Tensor:
    return F.silu(x.to(F32)).to(x.dtype)


def _gn3d(x, w, b, groups: int = 32):
    """GroupNorm over (T, H, W) per channel group."""
    B, T, H, W, C = x.shape
    y = group_norm(x.reshape(B, T * H, W, C), w, b, num_groups=groups)
    return y.reshape(B, T, H, W, C)


def _cconv(params, p, x, *, stride=(1, 1, 1), cfg=DEFAULT_CONFIG):
    """CausalConv3d at key prefix ``p`` (diffusers wraps it as ``p.conv``):
    kt − 1 zero frames in front, none behind."""
    key = f"{p}.conv.weight" if f"{p}.conv.weight" in params else f"{p}.weight"
    w = params[key]
    kt, kh, kw = (int(s) for s in w.shape[2:])
    pad = ((kt - 1, 0), ((kh - 1) // 2,) * 2, ((kw - 1) // 2,) * 2)
    return conv3d(x, w, params.get(key[:-len("weight")] + "bias"),
                  stride=stride, padding=pad, cfg=cfg)


def _has(params, p) -> bool:
    return f"{p}.conv.weight" in params or f"{p}.weight" in params


def _resnet(params, p, x, qcfg):
    h = _gn3d(x, params[f"{p}.norm1.weight"], params[f"{p}.norm1.bias"])
    h = _cconv(params, f"{p}.conv1", _silu(h), cfg=qcfg)
    h = _gn3d(h, params[f"{p}.norm2.weight"], params[f"{p}.norm2.bias"])
    h = _cconv(params, f"{p}.conv2", _silu(h), cfg=qcfg)
    if _has(params, f"{p}.conv_shortcut"):
        x = _cconv(params, f"{p}.conv_shortcut", x, cfg=qcfg)
    return x + h


def _mid_attn(params, p, x, qcfg):
    """Per-frame single-head spatial attention (diffusers Attention)."""
    B, T, H, W, C = x.shape
    h = _gn3d(x, params[f"{p}.group_norm.weight"],
              params[f"{p}.group_norm.bias"])
    h2 = h.reshape(B * T, H * W, C)

    def proj(name, t):
        return linear(t, params[f"{p}.{name}.weight"],
                      params.get(f"{p}.{name}.bias"), cfg=qcfg)

    # heads-major (B·T, 1, H·W, C): ONE head over all spatial positions
    q, k, v = (proj(n, h2)[:, None] for n in ("to_q", "to_k", "to_v"))
    o = dot_product_attention(q, k, v).reshape(B * T, H * W, C)
    return x + proj("to_out.0", o).reshape(B, T, H, W, C)


def _upsample(params, p, x, temporal: bool, qcfg):
    """Nearest ×2 in space (and in time when ``temporal``: the first frame
    stays single, T → 2T − 1), then the causal conv."""
    if temporal and x.shape[1] > 1:
        x = torch.cat([x[:, :1], x[:, 1:].repeat_interleave(2, dim=1)],
                      dim=1)
    x = x.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)
    return _cconv(params, f"{p}.conv", x, cfg=qcfg)


def _walk_blocks(params, prefix, slot):
    i = 0
    while any(k.startswith(f"{prefix}.{slot}.{i}.") for k in params):
        yield f"{prefix}.{slot}.{i}"
        i += 1


def _mid(params, side, x, qcfg):
    """The mid block: resnets, the attention after the first."""
    attn = f"{side}.mid_block.attentions.0"
    has_attn = any(k.startswith(attn + ".") for k in params)
    for rp in _walk_blocks(params, f"{side}.mid_block", "resnets"):
        x = _resnet(params, rp, x, qcfg)
        if rp.endswith(".0") and has_attn:
            x = _mid_attn(params, attn, x, qcfg)
    return x


@dataclasses.dataclass(frozen=True)
class HyVidVAEConfig:
    z_channels: int
    temporal_ups: int = 2  # 4× temporal compression

    @staticmethod
    def from_state_dict(sd) -> "HyVidVAEConfig":
        k = ("decoder.conv_in.conv.weight"
             if "decoder.conv_in.conv.weight" in sd
             else "decoder.conv_in.weight")
        return HyVidVAEConfig(z_channels=int(sd[k].shape[1]))


def decode(params, cfg: HyVidVAEConfig, z: torch.Tensor,
           qcfg: QuantConfig = DEFAULT_CONFIG) -> torch.Tensor:
    """z: (B, T, H/8, W/8, z) → video (B, 1 + 4(T − 1), H, W, 3) in
    [-1, 1]."""
    if _has(params, "post_quant_conv"):
        z = _cconv(params, "post_quant_conv", z, cfg=qcfg)
    x = _cconv(params, "decoder.conv_in", z, cfg=qcfg)
    x = _mid(params, "decoder", x, qcfg)
    for bi, bp in enumerate(_walk_blocks(params, "decoder", "up_blocks")):
        for rp in _walk_blocks(params, bp, "resnets"):
            x = _resnet(params, rp, x, qcfg)
        if any(k.startswith(f"{bp}.upsamplers.0.") for k in params):
            # time doubles at the deepest temporal_ups stages (the mirror of
            # the encoder's last downsamplers): 1 + k → 1 + 2k → 1 + 4k
            x = _upsample(params, f"{bp}.upsamplers.0", x,
                          bi < cfg.temporal_ups, qcfg)
    x = _gn3d(x, params["decoder.conv_norm_out.weight"],
              params["decoder.conv_norm_out.bias"])
    return _cconv(params, "decoder.conv_out", _silu(x), cfg=qcfg)


def encode(params, cfg: HyVidVAEConfig, x: torch.Tensor,
           qcfg: QuantConfig = DEFAULT_CONFIG) -> torch.Tensor:
    """video (B, 1 + 4k, H, W, 3) → the latent mean (B, 1 + k, H/8, W/8,
    z)."""
    h = _cconv(params, "encoder.conv_in", x, cfg=qcfg)
    blocks = list(_walk_blocks(params, "encoder", "down_blocks"))
    for bi, bp in enumerate(blocks):
        for rp in _walk_blocks(params, bp, "resnets"):
            h = _resnet(params, rp, h, qcfg)
        if any(k.startswith(f"{bp}.downsamplers.0.") for k in params):
            temporal = bi >= len(blocks) - 1 - cfg.temporal_ups
            # causal stride 2: the front padding takes 1 + 2k frames to
            # 1 + k
            h = _cconv(params, f"{bp}.downsamplers.0.conv", h,
                       stride=(2, 2, 2) if temporal else (1, 2, 2),
                       cfg=qcfg)
    h = _mid(params, "encoder", h, qcfg)
    h = _gn3d(h, params["encoder.conv_norm_out.weight"],
              params["encoder.conv_norm_out.bias"])
    h = _cconv(params, "encoder.conv_out", _silu(h), cfg=qcfg)
    if _has(params, "quant_conv"):
        h = _cconv(params, "quant_conv", h, cfg=qcfg)
    return h[..., : h.shape[-1] // 2]  # the mean half


def decode_tiled(params, cfg: HyVidVAEConfig, z: torch.Tensor, tile: int = 32,
                 overlap: int = 8,
                 qcfg: QuantConfig = DEFAULT_CONFIG) -> torch.Tensor:
    """Spatially tiled ``decode`` (``vae.tiled_apply_video``): the temporal
    law stays exact, per-tile norms are the usual tiled-VAE
    approximation."""
    from .vae import tiled_apply_video

    return tiled_apply_video(
        lambda zt: decode(params, cfg, zt, qcfg=qcfg), z, tile, overlap)


def decode_auto(params, cfg: HyVidVAEConfig, z: torch.Tensor,
                qcfg: QuantConfig = DEFAULT_CONFIG) -> torch.Tensor:
    """``decode``, spatially tiled when ``GGUF_TPU_VAE_TILE`` (the latent
    tile side) is set and exceeded."""
    from .vae import _tile_env

    t = _tile_env()
    if t and (z.shape[2] > t or z.shape[3] > t):
        return decode_tiled(params, cfg, z, tile=t,
                            overlap=max(t // 4, 1), qcfg=qcfg)
    return decode(params, cfg, z, qcfg=qcfg)
