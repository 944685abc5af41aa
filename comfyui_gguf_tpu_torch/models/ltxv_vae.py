"""LTX-Video causal 3-D VAE, encoder and decoder (PyTorch port of
comfyui_gguf_tpu/models/ltxv_vae.py), channel-minor (B, T, H, W, C).

The published LTX-Video autoencoder's convention (Lightricks LTX-Video /
diffusers ``AutoencoderKLLTXVideo``, the 0.9.0 family):

* Pixel-shuffle compression: the encoder space-to-depths each frame by
  ``patch_size`` (4) before conv_in and the decoder depth-to-spaces back
  after conv_out; with the striding levels that is 1:32 in space and 1:8
  in time, into 128 latent channels.
* ``CausalConv3d``: front-only temporal padding that REPLICATES the first
  frame (not zeros, unlike the HunyuanVideo VAE's), so frame t never sees
  t+1; the weight lives on an inner conv, ``*.conv.weight``.
* Residual blocks without affine norms: ``RMSNorm(elementwise_affine=
  False)`` → SiLU → causal conv, twice, plus a ``conv_shortcut`` where
  the width changes (``res_blocks.{j}.conv{1,2}.conv.weight``).
* Down path: a strided causal conv per level (``downsamplers.0.conv``);
  whether a level strides time too comes from ``spatio_temporal_scaling``.
  Up path: ``upsamplers.0.conv`` to C·(st·sh·sw) channels rearranged
  depth-to-space over (t, h, w), channel-major (st, sh, sw, c), then the
  causal warm-up frame trimmed where time doubled.
* Latents are normalized by the checkpoint's per-channel statistics
  ``per_channel_statistics.{mean,std}-of-means``.

The level count, widths and residual-block count are read from the keys;
the stride flags and the patch size are config with the 0.9 defaults.
Frame bookkeeping: latent T decodes to 1 + 8(T − 1) pixel frames.
"""

from __future__ import annotations

import dataclasses
import re

import numpy as np
import torch
import torch.nn.functional as F

from ..nn.layers import DEFAULT_CONFIG, QuantConfig, conv3d

F32 = torch.float32


def _silu(x: torch.Tensor) -> torch.Tensor:
    return F.silu(x.to(F32)).to(x.dtype)


def _rms_noaffine(x: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    xf = x.to(F32)
    v = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(v + eps)).to(x.dtype)


def _causal_conv3d(x, w, b, *, stride=(1, 1, 1), cfg=DEFAULT_CONFIG):
    """x: (B, T, H, W, C); w: (O, I, kt, kh, kw). The temporal padding is
    kt − 1 copies of the first frame in front, none behind."""
    kt, kh, kw = (int(s) for s in w.shape[2:])
    if kt > 1:
        x = torch.cat([x[:, :1].expand(-1, kt - 1, -1, -1, -1), x], dim=1)
    pad = ((0, 0), ((kh - 1) // 2,) * 2, ((kw - 1) // 2,) * 2)
    return conv3d(x, w, b, stride=stride, padding=pad, cfg=cfg)


def _space_to_depth(x: torch.Tensor, p: int) -> torch.Tensor:
    """(B, T, H, W, C) → (B, T, H/p, W/p, C·p²), channel-major (ph, pw,
    c)."""
    B, T, H, W, C = x.shape
    x = x.reshape(B, T, H // p, p, W // p, p, C)
    return x.permute(0, 1, 2, 4, 3, 5, 6).reshape(B, T, H // p, W // p,
                                                  p * p * C)


def _depth_to_space(x: torch.Tensor, p: int) -> torch.Tensor:
    """(B, T, H, W, C·p²) → (B, T, H·p, W·p, C)."""
    B, T, H, W, C = x.shape
    c = C // (p * p)
    x = x.reshape(B, T, H, W, p, p, c)
    return x.permute(0, 1, 2, 4, 3, 5, 6).reshape(B, T, H * p, W * p, c)


def _depth_to_spacetime(x: torch.Tensor, st: int, sh: int,
                        sw: int) -> torch.Tensor:
    """(B, T, H, W, C·st·sh·sw) → (B, T·st, H·sh, W·sw, C), channel-major
    factor order (st, sh, sw, c): the decoder's pixel-shuffle upsampler."""
    B, T, H, W, C = x.shape
    c = C // (st * sh * sw)
    x = x.reshape(B, T, H, W, st, sh, sw, c)
    x = x.permute(0, 1, 4, 2, 5, 3, 6, 7)
    return x.reshape(B, T * st, H * sh, W * sw, c)


@dataclasses.dataclass(frozen=True)
class LTXVVAEConfig:
    latent_channels: int = 128
    patch_size: int = 4
    # per down/up level: does the level also stride / upsample time?
    spatio_temporal_scaling: tuple[bool, ...] = (True, True, True, False)
    n_levels: int = 4
    res_blocks_per_level: int = 2

    @property
    def spatial_factor(self) -> int:
        # the last level never strides (n_levels − 1 downsamplers)
        return self.patch_size * (1 << (self.n_levels - 1))

    @property
    def temporal_factor(self) -> int:
        return 1 << sum(self.spatio_temporal_scaling[: self.n_levels - 1])

    @staticmethod
    def from_state_dict(sd) -> "LTXVVAEConfig":
        levels, res = set(), set()
        for k in sd:
            m = re.match(r"(?:decoder|encoder)\.(?:up|down)_blocks\."
                         r"(\d+)\.res_blocks\.(\d+)\.", k)
            if m:
                levels.add(int(m.group(1)))
                res.add(int(m.group(2)))
        n_levels = (max(levels) + 1) if levels else 4
        lat = None
        if "decoder.conv_in.conv.weight" in sd:
            lat = int(sd["decoder.conv_in.conv.weight"].shape[1])
        return LTXVVAEConfig(
            latent_channels=lat or 128,
            spatio_temporal_scaling=tuple([True] * (n_levels - 1) + [False]),
            n_levels=n_levels,
            res_blocks_per_level=(max(res) + 1) if res else 2)


def detect_ltxv_vae(keys) -> bool:
    return any(".res_blocks.0.conv1.conv.weight" in k for k in keys)


def _res_block(params, p, x, qcfg):
    h = _causal_conv3d(_silu(_rms_noaffine(x)),
                       params[f"{p}.conv1.conv.weight"],
                       params.get(f"{p}.conv1.conv.bias"), cfg=qcfg)
    h = _causal_conv3d(_silu(_rms_noaffine(h)),
                       params[f"{p}.conv2.conv.weight"],
                       params.get(f"{p}.conv2.conv.bias"), cfg=qcfg)
    sc = params.get(f"{p}.conv_shortcut.conv.weight")
    if sc is not None:
        x = _causal_conv3d(x, sc, params.get(f"{p}.conv_shortcut.conv.bias"),
                           cfg=qcfg)
    return x + h


def _statistics(params, like):
    mu = params.get("per_channel_statistics.mean-of-means")
    std = params.get("per_channel_statistics.std-of-means")
    if mu is None or std is None:
        return None
    return (torch.as_tensor(mu).to(like.device, like.dtype),
            torch.as_tensor(std).to(like.device, like.dtype))


def encode(params, cfg: LTXVVAEConfig, video: torch.Tensor, *,
           sample: bool = False, generator: torch.Generator | None = None,
           noise=None, qcfg: QuantConfig = DEFAULT_CONFIG) -> torch.Tensor:
    """(B, T_pix, H, W, 3) in [-1, 1] → the latent (B, T_lat, H/32, W/32,
    C), normalized by the per-channel statistics; T_pix must be 1 + 8k.
    ``sample`` draws z = mean + σ·ε, ε from ``noise`` (the caller's, of the
    latent's shape) or else from ``generator`` (a ``torch.Generator`` on
    the video's device; a fresh one seeded 0 when None)."""
    x = _space_to_depth(video, cfg.patch_size)
    x = _causal_conv3d(x, params["encoder.conv_in.conv.weight"],
                       params.get("encoder.conv_in.conv.bias"), cfg=qcfg)
    for i in range(cfg.n_levels):
        base = f"encoder.down_blocks.{i}"
        for j in range(cfg.res_blocks_per_level):
            x = _res_block(params, f"{base}.res_blocks.{j}", x, qcfg)
        dw = params.get(f"{base}.downsamplers.0.conv.weight")
        if dw is not None:
            st = 2 if cfg.spatio_temporal_scaling[i] else 1
            # a causal stride: the first frame once more in front, so that
            # 1 + 2k frames give 1 + k (the first latent frame keeps frame 0
            # alone)
            if st == 2:
                x = torch.cat([x[:, :1], x], dim=1)
            x = _causal_conv3d(x, dw,
                               params.get(f"{base}.downsamplers.0.conv.bias"),
                               stride=(st, 2, 2), cfg=qcfg)
    for j in range(cfg.res_blocks_per_level):
        x = _res_block(params, f"encoder.mid_block.res_blocks.{j}", x, qcfg)
    x = _causal_conv3d(_silu(_rms_noaffine(x)),
                       params["encoder.conv_out.conv.weight"],
                       params.get("encoder.conv_out.conv.bias"), cfg=qcfg)
    mean, logvar = torch.chunk(x, 2, dim=-1)
    z = mean
    if sample:
        if noise is None:
            if generator is None:
                generator = torch.Generator(device=mean.device).manual_seed(0)
            noise = torch.randn(mean.shape, generator=generator,
                                device=mean.device, dtype=F32)
        if not isinstance(noise, torch.Tensor):
            noise = torch.from_numpy(np.array(noise, np.float32))
        eps = noise.to(mean.device, mean.dtype)
        z = mean + torch.exp(0.5 * logvar.clamp(-30, 20)) * eps
    stats = _statistics(params, z)
    if stats is not None:
        z = (z - stats[0]) / stats[1]
    return z


def decode(params, cfg: LTXVVAEConfig, z: torch.Tensor, *,
           qcfg: QuantConfig = DEFAULT_CONFIG) -> torch.Tensor:
    """latent (B, T_lat, h, w, C) → video (B, 1 + 8(T_lat − 1), 32h, 32w,
    3) in [-1, 1]."""
    stats = _statistics(params, z)
    if stats is not None:
        z = z * stats[1] + stats[0]
    x = _causal_conv3d(z, params["decoder.conv_in.conv.weight"],
                       params.get("decoder.conv_in.conv.bias"), cfg=qcfg)
    for j in range(cfg.res_blocks_per_level):
        x = _res_block(params, f"decoder.mid_block.res_blocks.{j}", x, qcfg)
    for i in range(cfg.n_levels):
        base = f"decoder.up_blocks.{i}"
        uw = params.get(f"{base}.upsamplers.0.conv.weight")
        if uw is not None:
            # the mirror of an encoder level: levels run deep → shallow
            st = 2 if cfg.spatio_temporal_scaling[cfg.n_levels - 1 - i] else 1
            x = _causal_conv3d(x, uw,
                               params.get(f"{base}.upsamplers.0.conv.bias"),
                               cfg=qcfg)
            x = _depth_to_spacetime(x, st, 2, 2)
            if st == 2:
                x = x[:, 1:]  # the causal warm-up frame
        for j in range(cfg.res_blocks_per_level):
            x = _res_block(params, f"{base}.res_blocks.{j}", x, qcfg)
    x = _causal_conv3d(_silu(_rms_noaffine(x)),
                       params["decoder.conv_out.conv.weight"],
                       params.get("decoder.conv_out.conv.bias"), cfg=qcfg)
    return _depth_to_space(x, cfg.patch_size)


def decode_tiled(params, cfg: LTXVVAEConfig, z: torch.Tensor, tile: int = 16,
                 overlap: int = 4, *,
                 qcfg: QuantConfig = DEFAULT_CONFIG) -> torch.Tensor:
    """Spatially tiled ``decode`` (512² pixel tiles at the default, the 32×
    pixel-shuffle factor), see ``vae.tiled_apply_video``."""
    from .vae import tiled_apply_video

    return tiled_apply_video(
        lambda zt: decode(params, cfg, zt, qcfg=qcfg), z, tile, overlap)


def decode_auto(params, cfg: LTXVVAEConfig, z: torch.Tensor, *,
                qcfg: QuantConfig = DEFAULT_CONFIG) -> torch.Tensor:
    """``decode``, spatially tiled when ``GGUF_TPU_VAE_TILE`` (the latent
    tile side) is set and exceeded."""
    from .vae import _tile_env

    t = _tile_env()
    if t and (z.shape[2] > t or z.shape[3] > t):
        return decode_tiled(params, cfg, z, tile=t,
                            overlap=max(t // 4, 1), qcfg=qcfg)
    return decode(params, cfg, z, qcfg=qcfg)
