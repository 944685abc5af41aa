"""Wan 2.1 causal 3-D video VAE, encoder and decoder (PyTorch port of
comfyui_gguf_tpu/models/wan_vae.py), channel-minor (B, T, H, W, C).

The original Wan-Video module layout, whose checkpoints ComfyUI loads:

* ``CausalConv3d``: a 3-D conv whose temporal padding is front-only (2·pad_t,
  0), so frame t never sees t+1; spatial padding symmetric.
* ``RMS_norm`` (video form): x/‖x‖₂ over channels · √C · gamma.
* ``ResidualBlock``: RMS, SiLU, conv, RMS, SiLU, conv, plus a 1×1×1
  shortcut (keys ``residual.{0,3}.gamma``, ``residual.{2,6}.weight``,
  ``shortcut.weight``).
* ``Resample``: nearest ×2 + conv per frame (``resample.1.*``, channels
  halve); ``upsample3d`` adds ``time_conv`` (C → 2C, k = (3,1,1)) whose
  output interleaves to double T; ``downsample2d`` is an asymmetric
  zero pad and a stride-2 conv, ``downsample3d`` adds a stride-(2,1,1)
  causal time conv.
* ``AttentionBlock``: per-frame single-head spatial attention (``norm.gamma``,
  ``to_qkv``, ``proj``) through ``dot_product_attention``: on the card the
  flash kernel K7 at D = the block's width (384 at Wan 2.1's mid-block).
  K7 takes bf16 q/k/v, so the block rounds them to the compute dtype, as
  the convolutions round their operands, on the CPU too; the reference's
  TPU flash kernel takes the f32 activations as they are (ROADMAP queue 3).

The graph is read from the keys (block kinds and widths come from the
weights), as in the reference. Frame bookkeeping: latent T maps to pixel
1 + 4(T − 1); the decoder's two temporal doublings give 4T frames, of
which the leading 2^n − 1 warm-up frames are trimmed.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from ..nn.attention import dot_product_attention
from ..nn.layers import DEFAULT_CONFIG, QuantConfig, conv2d, conv3d

F32 = torch.float32


def _silu(x: torch.Tensor) -> torch.Tensor:
    return F.silu(x.to(F32)).to(x.dtype)


def _rms(x: torch.Tensor, gamma) -> torch.Tensor:
    """Wan's RMS_norm (video): channels L2-normalized, times √C · gamma."""
    xf = x.to(F32)
    n = xf * torch.rsqrt(xf.square().sum(dim=-1, keepdim=True) + 1e-12)
    g = gamma.to(F32).reshape(-1)
    return (n * (x.shape[-1] ** 0.5) * g).to(x.dtype)


def _causal_conv3d(x, w, b, *, stride=(1, 1, 1), cfg=DEFAULT_CONFIG):
    """x: (B, T, H, W, C); w: (O, I, kt, kh, kw). Temporal padding front
    only."""
    kt, kh, kw = (int(s) for s in w.shape[2:])
    pad = ((kt - 1, 0), ((kh - 1) // 2,) * 2, ((kw - 1) // 2,) * 2)
    return conv3d(x, w, b, stride=stride, padding=pad, cfg=cfg)


def _per_frame(fn, x):
    """A 2-D op on (B, T, H, W, C), T folded into the batch."""
    B, T, H, W, C = x.shape
    y = fn(x.reshape(B * T, H, W, C))
    return y.reshape(B, T, *y.shape[1:])


def _residual_block(params, p, x, qcfg):
    h = _rms(x, params[f"{p}.residual.0.gamma"])
    h = _causal_conv3d(_silu(h), params[f"{p}.residual.2.weight"],
                       params.get(f"{p}.residual.2.bias"), cfg=qcfg)
    h = _rms(h, params[f"{p}.residual.3.gamma"])
    h = _causal_conv3d(_silu(h), params[f"{p}.residual.6.weight"],
                       params.get(f"{p}.residual.6.bias"), cfg=qcfg)
    if f"{p}.shortcut.weight" in params:
        x = _causal_conv3d(x, params[f"{p}.shortcut.weight"],
                           params.get(f"{p}.shortcut.bias"), cfg=qcfg)
    return x + h


def _attention_block(params, p, x, qcfg):
    """Single-head spatial attention per frame."""
    h = _rms(x, params[f"{p}.norm.gamma"])

    def attn2d(hf):
        N, H, W, C = hf.shape
        qkv = conv2d(hf, params[f"{p}.to_qkv.weight"],
                     params.get(f"{p}.to_qkv.bias"), cfg=qcfg)
        # heads-major (N, 1, H·W, C): ONE head over all spatial positions;
        # q, k and v are column slices of the projection, read in place
        qkv = qkv.reshape(N, 1, H * W, 3 * C).to(qcfg.compute_dtype)
        q, k, v = qkv[..., :C], qkv[..., C:2 * C], qkv[..., 2 * C:]
        o = dot_product_attention(q, k, v).reshape(N, H, W, C).to(hf.dtype)
        return conv2d(o, params[f"{p}.proj.weight"],
                      params.get(f"{p}.proj.bias"), cfg=qcfg)

    return x + _per_frame(attn2d, h)


def _upsample(params, p, x, qcfg):
    """Resample upsample2d/3d: an optional temporal doubling, then nearest
    ×2 and a conv per frame (channels halve)."""
    tc = f"{p}.time_conv.weight"
    if tc in params:
        B, T, H, W, C = x.shape
        h = _causal_conv3d(x, params[tc], params.get(f"{p}.time_conv.bias"),
                           cfg=qcfg)  # (B, T, H, W, 2C)
        h = h.reshape(B, T, H, W, 2, C)
        x = h.permute(0, 1, 4, 2, 3, 5).reshape(B, 2 * T, H, W, C)

    def up2d(hf):
        hf = hf.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)
        return conv2d(hf, params[f"{p}.resample.1.weight"],
                      params.get(f"{p}.resample.1.bias"), padding=1,
                      cfg=qcfg)

    return _per_frame(up2d, x)


def _downsample(params, p, x, qcfg):
    """Resample downsample2d/3d: an asymmetrically padded stride-2 conv per
    frame, then an optional stride-2 causal time conv."""
    def down2d(hf):
        return conv2d(hf, params[f"{p}.resample.1.weight"],
                      params.get(f"{p}.resample.1.bias"), stride=2,
                      padding=((0, 1), (0, 1)), cfg=qcfg)

    x = _per_frame(down2d, x)
    tc = f"{p}.time_conv.weight"
    if tc in params:
        x = _causal_conv3d(x, params[tc], params.get(f"{p}.time_conv.bias"),
                           stride=(2, 1, 1), cfg=qcfg)
    return x


def _block_kind(params, p):
    if f"{p}.residual.0.gamma" in params:
        return "res"
    if f"{p}.norm.gamma" in params:
        return "attn"
    if f"{p}.resample.1.weight" in params or f"{p}.time_conv.weight" in params:
        return "resample"
    return None


def _walk(params, prefix):
    """(kind, path) of the sequential block indices under prefix."""
    i = 0
    while True:
        p = f"{prefix}.{i}"
        kind = _block_kind(params, p)
        if kind is None:
            return
        yield kind, p
        i += 1


@dataclasses.dataclass(frozen=True)
class WanVAEConfig:
    z_channels: int
    scale_factor: float = 1.0  # per-channel mean/std applied by the caller

    @staticmethod
    def from_state_dict(sd) -> "WanVAEConfig":
        return WanVAEConfig(z_channels=int(sd["decoder.conv1.weight"]
                                           .shape[1]))


def decode(params, cfg: WanVAEConfig, z: torch.Tensor,
           qcfg: QuantConfig = DEFAULT_CONFIG) -> torch.Tensor:
    """z: (B, T, H/8, W/8, z) → video (B, 1 + 4(T − 1), H, W, 3) in
    [-1, 1]."""
    if "conv2.weight" in params:  # the post-quant 1×1×1 conv
        z = _causal_conv3d(z, params["conv2.weight"],
                           params.get("conv2.bias"), cfg=qcfg)
    x = _causal_conv3d(z, params["decoder.conv1.weight"],
                       params.get("decoder.conv1.bias"), cfg=qcfg)
    for kind, p in _walk(params, "decoder.middle"):
        x = (_residual_block(params, p, x, qcfg) if kind == "res"
             else _attention_block(params, p, x, qcfg))
    n_time_up = 0
    for kind, p in _walk(params, "decoder.upsamples"):
        if kind == "res":
            x = _residual_block(params, p, x, qcfg)
        else:
            if f"{p}.time_conv.weight" in params:
                n_time_up += 1
            x = _upsample(params, p, x, qcfg)
    x = _rms(x, params["decoder.head.0.gamma"])
    x = _causal_conv3d(_silu(x), params["decoder.head.2.weight"],
                       params.get("decoder.head.2.bias"), cfg=qcfg)
    trim = (1 << n_time_up) - 1  # the causal warm-up frames
    return x[:, trim:] if trim else x


def encode(params, cfg: WanVAEConfig, x: torch.Tensor,
           qcfg: QuantConfig = DEFAULT_CONFIG) -> torch.Tensor:
    """video (B, 1 + 4k, H, W, 3) → the latent mean (B, 1 + k, H/8, W/8,
    z)."""
    n_time_down = sum(
        1 for kind, p in _walk(params, "encoder.downsamples")
        if kind == "resample" and f"{p}.time_conv.weight" in params)
    # causal warm-up: the first frame repeated so that T' lands on 1 + k
    lead = (1 << n_time_down) - 1
    if lead:
        x = torch.cat([x[:, :1].expand(-1, lead, -1, -1, -1), x], dim=1)
    h = _causal_conv3d(x, params["encoder.conv1.weight"],
                       params.get("encoder.conv1.bias"), cfg=qcfg)
    for kind, p in _walk(params, "encoder.downsamples"):
        h = (_residual_block(params, p, h, qcfg) if kind == "res"
             else _downsample(params, p, h, qcfg))
    for kind, p in _walk(params, "encoder.middle"):
        h = (_residual_block(params, p, h, qcfg) if kind == "res"
             else _attention_block(params, p, h, qcfg))
    h = _rms(h, params["encoder.head.0.gamma"])
    h = _causal_conv3d(_silu(h), params["encoder.head.2.weight"],
                       params.get("encoder.head.2.bias"), cfg=qcfg)
    if "conv1.weight" in params:  # the quant conv on (mean, logvar)
        h = _causal_conv3d(h, params["conv1.weight"],
                           params.get("conv1.bias"), cfg=qcfg)
    return h[..., : h.shape[-1] // 2]  # the mean half


def decode_tiled(params, cfg: WanVAEConfig, z: torch.Tensor, tile: int = 32,
                 overlap: int = 8,
                 qcfg: QuantConfig = DEFAULT_CONFIG) -> torch.Tensor:
    """Spatially tiled ``decode`` (256² pixel tiles at the default): peak
    activation memory bounded by one tile × the whole clip. The temporal
    law stays exact (the causal convs see every frame); per-tile norms are
    the usual tiled-VAE approximation."""
    from .vae import tiled_apply_video

    return tiled_apply_video(
        lambda zt: decode(params, cfg, zt, qcfg=qcfg), z, tile, overlap)


def decode_auto(params, cfg: WanVAEConfig, z: torch.Tensor,
                qcfg: QuantConfig = DEFAULT_CONFIG) -> torch.Tensor:
    """``decode``, spatially tiled when ``GGUF_TPU_VAE_TILE`` (the latent
    tile side) is set and exceeded, the image VAE's opt-in."""
    from .vae import _tile_env

    t = _tile_env()
    if t and (z.shape[2] > t or z.shape[3] > t):
        return decode_tiled(params, cfg, z, tile=t,
                            overlap=max(t // 4, 1), qcfg=qcfg)
    return decode(params, cfg, z, qcfg=qcfg)
