"""AutoencoderKL VAE (SD / SDXL / Flux latent codec), PyTorch port of
comfyui_gguf_tpu/models/vae.py.

Implements the sgm/``first_stage_model`` key format that Flux
``ae.safetensors`` and SD-family VAEs use: ``decoder.mid.block_1`` /
``decoder.up.{i}.block.{j}`` / ``decoder.mid.attn_1.{q,k,v,proj_out}``.

Public tensors keep the reference's channel-minor (B, H, W, C) order;
``nn.conv2d`` runs them as channels-last views. Spatial attention in the mid
block is single-head over H·W tokens, written out as in the reference (it is
not one of its hand-written kernels).
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch
import torch.nn.functional as F

from ..nn.layers import DEFAULT_CONFIG, QuantConfig, conv2d, group_norm


@dataclasses.dataclass(frozen=True)
class VAEConfig:
    z_channels: int = 16  # flux/sd3: 16, sd1/sdxl: 4
    base_ch: int = 128
    ch_mult: tuple[int, ...] = (1, 2, 4, 4)
    num_res_blocks: int = 2
    scale_factor: float = 0.3611  # flux; sd1: 0.18215, sdxl: 0.13025
    shift_factor: float = 0.1159  # flux; 0.0 for sd1/sdxl
    has_quant_conv: bool = False  # sd1/sdxl wrap latents in (post_)quant_conv

    @staticmethod
    def from_state_dict(sd) -> "VAEConfig":
        def shape(k):
            v = sd[k]
            return v.shape if hasattr(v, "shape") else np.asarray(v).shape

        z = int(shape("decoder.conv_in.weight")[1])
        has_qc = "post_quant_conv.weight" in sd
        # introspect geometry from the decoder keys (SD/SDXL/flux all use
        # base 128 × (1,2,4,4), but tiny/test and exotic VAEs differ)
        base = int(shape("decoder.conv_out.weight")[1])
        levels = 0
        while f"decoder.up.{levels}.block.0.conv1.weight" in sd:
            levels += 1
        nres = 0
        while f"decoder.up.0.block.{nres}.conv1.weight" in sd:
            nres += 1
        if levels:
            ch_mult = tuple(
                int(shape(f"decoder.up.{i}.block.{nres - 1}.conv1.weight"
                          )[0]) // base
                for i in range(levels))
            geo = dict(base_ch=base, ch_mult=ch_mult,
                       num_res_blocks=max(nres - 1, 1))
        else:
            geo = {}
        if z == 4:
            return VAEConfig(z_channels=4, scale_factor=0.18215,
                             shift_factor=0.0, has_quant_conv=has_qc,
                             **geo)
        return VAEConfig(z_channels=z, has_quant_conv=has_qc, **geo)


def _silu(x: torch.Tensor) -> torch.Tensor:
    return F.silu(x.to(torch.float32)).to(x.dtype)


def _resnet(params, prefix, x, qcfg):
    h = group_norm(x, params[f"{prefix}.norm1.weight"],
                   params[f"{prefix}.norm1.bias"])
    h = conv2d(_silu(h), params[f"{prefix}.conv1.weight"],
               params[f"{prefix}.conv1.bias"], padding=1, cfg=qcfg)
    h = group_norm(h, params[f"{prefix}.norm2.weight"],
                   params[f"{prefix}.norm2.bias"])
    h = conv2d(_silu(h), params[f"{prefix}.conv2.weight"],
               params[f"{prefix}.conv2.bias"], padding=1, cfg=qcfg)
    if f"{prefix}.nin_shortcut.weight" in params:
        x = conv2d(x, params[f"{prefix}.nin_shortcut.weight"],
                   params[f"{prefix}.nin_shortcut.bias"], cfg=qcfg)
    return x + h


def _mid_attn(params, prefix, x, qcfg):
    B, H, W, C = x.shape
    h = group_norm(x, params[f"{prefix}.norm.weight"],
                   params[f"{prefix}.norm.bias"])

    def proj(name):
        return conv2d(h, params[f"{prefix}.{name}.weight"],
                      params[f"{prefix}.{name}.bias"],
                      cfg=qcfg).reshape(B, H * W, C)

    q, k, v = proj("q"), proj("k"), proj("v")
    logits = torch.matmul(q.to(torch.float32),
                          k.to(torch.float32).transpose(-1, -2)) * (C ** -0.5)
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    del logits
    # the reference's probs·v has no widened accumulator type: the CPU
    # widens to f32 (as XLA does there), the card takes the bf16 product
    # with its f32 accumulator
    if x.is_cuda:
        out = torch.matmul(probs, v)
    else:
        out = torch.matmul(probs.to(torch.float32),
                           v.to(torch.float32)).to(v.dtype)
    out = conv2d(out.reshape(B, H, W, C), params[f"{prefix}.proj_out.weight"],
                 params[f"{prefix}.proj_out.bias"], cfg=qcfg)
    return x + out


def _upsample(params, prefix, x, qcfg):
    x = x.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)  # nearest
    return conv2d(x, params[f"{prefix}.conv.weight"],
                  params[f"{prefix}.conv.bias"], padding=1, cfg=qcfg)


def decode(params, cfg: VAEConfig, z: torch.Tensor,
           qcfg: QuantConfig = DEFAULT_CONFIG) -> torch.Tensor:
    """Latent (B, h, w, z_channels) → image (B, 8h, 8w, 3) in [-1, 1]."""
    z = z.to(torch.float32) / cfg.scale_factor + cfg.shift_factor
    z = z.to(torch.bfloat16)
    if cfg.has_quant_conv and "post_quant_conv.weight" in params:
        z = conv2d(z, params["post_quant_conv.weight"],
                   params["post_quant_conv.bias"], cfg=qcfg)

    h = conv2d(z, params["decoder.conv_in.weight"],
               params["decoder.conv_in.bias"], padding=1, cfg=qcfg)
    h = _resnet(params, "decoder.mid.block_1", h, qcfg)
    h = _mid_attn(params, "decoder.mid.attn_1", h, qcfg)
    h = _resnet(params, "decoder.mid.block_2", h, qcfg)

    n_levels = len(cfg.ch_mult)
    for i in reversed(range(n_levels)):
        for j in range(cfg.num_res_blocks + 1):
            h = _resnet(params, f"decoder.up.{i}.block.{j}", h, qcfg)
        if i > 0:
            h = _upsample(params, f"decoder.up.{i}.upsample", h, qcfg)

    h = group_norm(h, params["decoder.norm_out.weight"],
                   params["decoder.norm_out.bias"])
    img = conv2d(_silu(h), params["decoder.conv_out.weight"],
                 params["decoder.conv_out.bias"], padding=1, cfg=qcfg)
    return img.to(torch.float32)


def _downsample(params, prefix, x, qcfg):
    # asymmetric (0,1) pad then stride-2 conv (sgm convention)
    return conv2d(x, params[f"{prefix}.conv.weight"],
                  params[f"{prefix}.conv.bias"], stride=2,
                  padding=((0, 1), (0, 1)), cfg=qcfg)


def encode(params, cfg: VAEConfig, img: torch.Tensor,
           qcfg: QuantConfig = DEFAULT_CONFIG,
           generator: torch.Generator | None = None) -> torch.Tensor:
    """Image (B, H, W, 3) in [-1, 1] → latent (B, H/8, W/8, z).

    Deterministic (mean) unless ``generator`` is given.
    """
    h = conv2d(img.to(torch.bfloat16), params["encoder.conv_in.weight"],
               params["encoder.conv_in.bias"], padding=1, cfg=qcfg)
    n_levels = len(cfg.ch_mult)
    for i in range(n_levels):
        for j in range(cfg.num_res_blocks):
            h = _resnet(params, f"encoder.down.{i}.block.{j}", h, qcfg)
        if i < n_levels - 1:
            h = _downsample(params, f"encoder.down.{i}.downsample", h, qcfg)
    h = _resnet(params, "encoder.mid.block_1", h, qcfg)
    h = _mid_attn(params, "encoder.mid.attn_1", h, qcfg)
    h = _resnet(params, "encoder.mid.block_2", h, qcfg)
    h = group_norm(h, params["encoder.norm_out.weight"],
                   params["encoder.norm_out.bias"])
    moments = conv2d(_silu(h), params["encoder.conv_out.weight"],
                     params["encoder.conv_out.bias"], padding=1, cfg=qcfg)
    if cfg.has_quant_conv and "quant_conv.weight" in params:
        moments = conv2d(moments, params["quant_conv.weight"],
                         params["quant_conv.bias"], cfg=qcfg)
    mean, logvar = moments.to(torch.float32).chunk(2, dim=-1)
    if generator is not None:
        std = torch.exp(0.5 * logvar.clamp(-30.0, 20.0))
        mean = mean + std * torch.randn(mean.shape, generator=generator,
                                        device=mean.device)
    return (mean - cfg.shift_factor) * cfg.scale_factor


# -- tiled decode/encode ------------------------------------------------------
#
# Memory-bounded VAE for large resolutions. A static tile grid (last tile
# shifted to fit) walked by a Python loop, where the reference scans it.
# Overlapping tiles are blended with a separable linear feather ramp
# ((t+1)/feather at every edge) and normalized by the accumulated weight, so
# coverage is exact wherever a single tile writes and a convex blend in
# overlaps.

def _tile_positions(size: int, tile: int, stride: int) -> list[int]:
    if size <= tile:
        return [0]
    pos = list(range(0, size - tile + 1, stride))
    if pos[-1] != size - tile:
        pos.append(size - tile)
    return pos


def _feather_mask(th: int, tw: int, feather: int, device) -> torch.Tensor:
    """(th, tw, 1) separable linear ramp mask; interior value 1. The
    feather clamps to half the side per axis so degenerate tiles (one
    dimension smaller than the overlap — panorama strips) stay legal."""
    def ramp(n):
        w = torch.ones((n,), dtype=torch.float32, device=device)
        f = min(feather, n // 2)
        if f > 0:
            r = (torch.arange(f, dtype=torch.float32, device=device)
                 + 1.0) / f
            w[:f] *= r
            w[n - f:] *= r.flip(0)
        return w
    return (ramp(th)[:, None] * ramp(tw)[None, :])[..., None]


def _blend_tiles(fn, x, positions, in_tile, in_scale, out_shape, out_tile,
                 out_scale, feather):
    """Run ``fn`` on the (in_tile) windows of x at positions·in_scale and
    feather-blend the results into ``out_shape`` at positions·out_scale."""
    th, tw = out_tile
    mask = _feather_mask(th, tw, feather, x.device)
    out = torch.zeros(out_shape, dtype=torch.float32, device=x.device)
    wsum = torch.zeros((1, *out_shape[1:3], 1), dtype=torch.float32,
                       device=x.device)
    for pi, pj in positions:
        i, j = pi * in_scale, pj * in_scale
        xt = x[:, i:i + in_tile[0], j:j + in_tile[1]]
        yt = fn(xt).to(torch.float32) * mask
        oi, oj = pi * out_scale, pj * out_scale
        out[:, oi:oi + th, oj:oj + tw] += yt
        wsum[:, oi:oi + th, oj:oj + tw] += mask[None]
    return out / wsum.clamp_min(1e-8)


def tiled_apply(fn, x: torch.Tensor, tile: int, overlap: int, factor: int,
                out_channels: int) -> torch.Tensor:
    """Apply ``fn`` ((B, tile, tile, C) → (B, tile·factor, tile·factor,
    out_channels)) over an overlapping tile grid of ``x`` and feather-blend.

    ``factor`` is the spatial scale of fn (8 for VAE decode)."""
    B, H, W, C = x.shape
    if H <= tile and W <= tile:
        return fn(x)
    overlap = min(overlap, tile // 2)
    stride = tile - overlap
    pos = [(i, j) for i in _tile_positions(H, tile, stride)
           for j in _tile_positions(W, tile, stride)]
    th_in, tw_in = min(tile, H), min(tile, W)
    return _blend_tiles(
        fn, x, pos, (th_in, tw_in), 1,
        (B, H * factor, W * factor, out_channels),
        (th_in * factor, tw_in * factor), factor, overlap * factor)


def spatial_factor(cfg: VAEConfig) -> int:
    """Pixel/latent scale: one 2× resample per level transition."""
    return 2 ** (len(cfg.ch_mult) - 1)


def decode_tiled(params, cfg: VAEConfig, z: torch.Tensor, tile: int = 64,
                 overlap: int = 16,
                 qcfg: QuantConfig = DEFAULT_CONFIG) -> torch.Tensor:
    """Tiled ``decode``: latent tiles of ``tile``² (512² pixels at the
    default) with ``overlap`` latent pixels of feathered overlap. Peak
    activation memory is bounded by one tile regardless of image size
    (GroupNorm statistics become per-tile — the standard tiled-VAE
    approximation)."""
    return tiled_apply(lambda zt: decode(params, cfg, zt, qcfg=qcfg),
                       z, tile, overlap, factor=spatial_factor(cfg),
                       out_channels=3)


def encode_tiled(params, cfg: VAEConfig, img: torch.Tensor, tile: int = 512,
                 overlap: int = 128,
                 qcfg: QuantConfig = DEFAULT_CONFIG) -> torch.Tensor:
    """Tiled ``encode`` (deterministic mean): pixel tiles of ``tile``²
    encoded independently; the downscale happens inside the tile fn so
    blending runs in latent space (tile/overlap must be multiples of the
    VAE's spatial factor)."""
    f = spatial_factor(cfg)
    if tile % f or overlap % f:
        raise ValueError(f"tile/overlap must be multiples of {f}")
    B, H, W, C = img.shape
    if H <= tile and W <= tile:
        return encode(params, cfg, img, qcfg=qcfg)
    lt, lov = tile // f, overlap // f
    lH, lW = H // f, W // f
    overlap_l = min(lov, lt // 2)
    stride = lt - overlap_l
    pos = [(i, j) for i in _tile_positions(lH, lt, stride)
           for j in _tile_positions(lW, lt, stride)]
    tl, tw = min(lt, lH), min(lt, lW)
    return _blend_tiles(
        lambda xt: encode(params, cfg, xt, qcfg=qcfg), img, pos,
        (tl * f, tw * f), f, (B, lH, lW, cfg.z_channels), (tl, tw), 1,
        overlap_l)


def _tile_env() -> int:
    v = os.environ.get("GGUF_TPU_VAE_TILE", "").strip()
    return int(v) if v else 0


def decode_auto(params, cfg: VAEConfig, z: torch.Tensor,
                qcfg: QuantConfig = DEFAULT_CONFIG) -> torch.Tensor:
    """``decode``, tiling when ``GGUF_TPU_VAE_TILE=<latent tile side>`` is
    set and the latent exceeds it (the reference's opt-in knob, name and
    rule kept)."""
    t = _tile_env()
    if t and (z.shape[1] > t or z.shape[2] > t):
        return decode_tiled(params, cfg, z, tile=t,
                            overlap=max(t // 4, 1), qcfg=qcfg)
    return decode(params, cfg, z, qcfg=qcfg)


def encode_auto(params, cfg: VAEConfig, img: torch.Tensor,
                qcfg: QuantConfig = DEFAULT_CONFIG,
                generator: torch.Generator | None = None) -> torch.Tensor:
    """``encode`` with the same opt-in tiling (threshold in latent units,
    like decode). Tiled encode is deterministic (mean)."""
    t = _tile_env()
    f = spatial_factor(cfg)
    if t and (img.shape[1] > t * f or img.shape[2] > t * f):
        return encode_tiled(params, cfg, img, tile=t * f,
                            overlap=max(t // 4, 1) * f, qcfg=qcfg)
    return encode(params, cfg, img, qcfg=qcfg, generator=generator)


def tiled_apply_video(fn, x: torch.Tensor, tile: int,
                      overlap: int) -> torch.Tensor:
    """Spatially tiled application of a video-VAE decode: ``fn`` (B, T, th,
    tw, C) → (B, T', th·f, tw·f, C'). T and the temporal law stay whole
    (causal convs make temporal tiling stateful; H·W dominates a video's
    activations, so spatial tiling is the memory lever). The output
    geometry (f, T', C') is read from the first tile's result, so any
    spatial factor works. Tiles are feather-blended in f32 in the
    reference's order."""
    B, T, H, W, C = x.shape
    if H <= tile and W <= tile:
        return fn(x)
    overlap = min(overlap, tile // 2)
    stride = tile - overlap
    th_in, tw_in = min(tile, H), min(tile, W)
    pos = [(i, j) for i in _tile_positions(H, tile, stride)
           for j in _tile_positions(W, tile, stride)]
    out = wsum = mask = None
    for i, j in pos:
        yt = fn(x[:, :, i:i + th_in, j:j + tw_in]).to(torch.float32)
        if out is None:
            _, t_out, th, tw, c_out = yt.shape
            f = th // th_in
            if th != th_in * f or tw != tw_in * f:
                raise ValueError(
                    f"non-integral or asymmetric spatial factor: in "
                    f"({th_in}, {tw_in}) -> out {tuple(yt.shape)}")
            mask = _feather_mask(th, tw, overlap * f, x.device)
            out = torch.zeros((B, t_out, H * f, W * f, c_out),
                              dtype=torch.float32, device=x.device)
            wsum = torch.zeros((1, 1, H * f, W * f, 1), dtype=torch.float32,
                               device=x.device)
        oi, oj = i * f, j * f
        out[:, :, oi:oi + th, oj:oj + tw] += yt * mask
        wsum[:, :, oi:oi + th, oj:oj + tw] += mask
    return out / wsum.clamp_min(1e-8)
