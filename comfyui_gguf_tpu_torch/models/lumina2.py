"""Lumina Image 2.0 NextDiT, arch "lumina2" (PyTorch port of
comfyui_gguf_tpu/models/lumina2.py).

A NextDiT block: sandwich RMS norms around the attention and the FFN, a
scale-only adaLN of 4 chunks (scale and gate twice, the gates squashed by
tanh), a fused qkv with a per-head RMS qk-norm, the SwiGLU FFN, and 3-axis
RoPE over position ids (caption tokens along axis 0, image rows and
columns along axes 1 and 2). The context refiner runs the caption tokens
through unmodulated blocks, the noise refiner the image tokens through
modulated ones; the main layers run on the concatenated [caption, image]
sequence. Lumina 2's heads are 96 wide (2304 / 24), which K7 runs on its
128-wide instance.

``forward_stacked`` runs the main layers as a Python loop over views of
the stacked weights (``flux.block_view``); the refiners stay flat, as in
the reference.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

from ..nn.attention import dot_product_attention
from ..nn.layers import DEFAULT_CONFIG, QuantConfig, linear, rms_norm
from .flux import (apply_rope, block_subtree, block_view, rope_freqs,
                   stack_block_groups, timestep_embedding)


@dataclasses.dataclass(frozen=True)
class Lumina2Config:
    dim: int
    n_layers: int
    n_refiner: int
    n_heads: int
    patch_size: int = 2
    in_channels: int = 16
    cap_dim: int = 2304
    axes_dim: tuple[int, ...] = (32, 32, 32)
    # a head dim that is not dim // n_heads (tensor-parallel shards divide
    # the heads and keep the true head dim)
    head_dim_override: int | None = None

    @property
    def head_dim(self) -> int:
        if self.head_dim_override is not None:
            return self.head_dim_override
        return self.dim // self.n_heads

    @staticmethod
    def from_state_dict(sd) -> "Lumina2Config":
        def shape(k):
            return tuple(sd[k].shape)

        dim, in_feat = shape("x_embedder.weight")
        hd = int(shape("layers.0.attention.q_norm.weight")[0])
        n = _count(sd, "layers")
        nr = _count(sd, "noise_refiner")
        third = 2 * (hd // 6)
        return Lumina2Config(
            dim=int(dim), n_layers=n, n_refiner=nr,
            n_heads=int(dim) // hd, in_channels=int(in_feat) // 4,
            cap_dim=int(shape("cap_embedder.1.weight")[1]),
            axes_dim=(hd - 2 * third, third, third))


def _count(params, section: str) -> int:
    n = 0
    while f"{section}.{n}.attention.qkv.weight" in params:
        n += 1
    return n


def _silu(x: torch.Tensor) -> torch.Tensor:
    return F.silu(x.to(torch.float32)).to(x.dtype)


def _block(p: dict, x, vec, pe, cfg: Lumina2Config, qcfg):
    """One NextDiT block over its UNPREFIXED param subtree ``p``;
    ``vec=None`` (the context refiner) runs it unmodulated."""
    H = cfg.n_heads
    if vec is not None and "adaLN_modulation.1.weight" in p:
        mod = linear(_silu(vec), p["adaLN_modulation.1.weight"],
                     p.get("adaLN_modulation.1.bias"), cfg=qcfg)
        sc_msa, g_msa, sc_mlp, g_mlp = torch.chunk(mod[:, None, :], 4,
                                                   dim=-1)
        g_msa = torch.tanh(g_msa.to(torch.float32)).to(x.dtype)
        g_mlp = torch.tanh(g_mlp.to(torch.float32)).to(x.dtype)
    else:
        sc_msa = sc_mlp = torch.zeros((1, 1, 1), dtype=x.dtype,
                                      device=x.device)
        g_msa = g_mlp = torch.ones((1, 1, 1), dtype=x.dtype, device=x.device)

    h = rms_norm(x, p.get("attention_norm1.weight")) * (1 + sc_msa)
    qkv = linear(h, p["attention.qkv.weight"], p.get("attention.qkv.bias"),
                 cfg=qcfg)
    B, L, _ = h.shape
    hd = cfg.head_dim
    q, k, v = (a.reshape(B, L, H, hd).transpose(1, 2)
               for a in torch.chunk(qkv, 3, dim=-1))
    q = rms_norm(q, p["attention.q_norm.weight"], eps=1e-6)
    k = rms_norm(k, p["attention.k_norm.weight"], eps=1e-6)
    if pe is not None:
        q = apply_rope(q, pe)
        k = apply_rope(k, pe)
    # v stays a view of the fused projection: K7 reads it in place
    a = dot_product_attention(q, k, v).transpose(1, 2).reshape(B, L, H * hd)
    a = linear(a, p["attention.out.weight"], p.get("attention.out.bias"),
               cfg=qcfg)
    x = x + g_msa * rms_norm(a, p.get("attention_norm2.weight"))

    h = rms_norm(x, p.get("ffn_norm1.weight")) * (1 + sc_mlp)
    w1 = linear(h, p["feed_forward.w1.weight"], cfg=qcfg)
    w3 = linear(h, p["feed_forward.w3.weight"], cfg=qcfg)
    ff = linear(_silu(w1) * w3, p["feed_forward.w2.weight"], cfg=qcfg)
    return x + g_mlp * rms_norm(ff, p.get("ffn_norm2.weight"))


def _position_ids(B: int, Lc: int, h_tok: int, w_tok: int, device):
    """(B, Lc, 3) caption ids (position on axis 0) and (B, h·w, 3) image
    ids (axis 0 at Lc, rows on axis 1, columns on axis 2)."""
    cap_ids = np.zeros((1, Lc, 3), np.int32)
    cap_ids[0, :, 0] = np.arange(Lc)
    img_ids = np.zeros((1, h_tok * w_tok, 3), np.int32)
    img_ids[0, :, 0] = Lc
    img_ids[0, :, 1] = np.repeat(np.arange(h_tok), w_tok)
    img_ids[0, :, 2] = np.tile(np.arange(w_tok), h_tok)
    return tuple(torch.as_tensor(a, device=device).expand(B, -1, 3)
                 for a in (cap_ids, img_ids))


def _prelude(params, cfg: Lumina2Config, latent, cap, timesteps, qcfg):
    B, Hh, Ww, C = latent.shape
    p = cfg.patch_size
    h_tok, w_tok = Hh // p, Ww // p

    xp = latent.reshape(B, h_tok, p, w_tok, p, C).permute(0, 1, 3, 5, 2, 4)
    xp = xp.reshape(B, h_tok * w_tok, C * p * p)
    x = linear(xp, params["x_embedder.weight"],
               params.get("x_embedder.bias"), cfg=qcfg)

    t = timestep_embedding(timesteps, 256, time_factor=1.0).to(x.dtype)
    vec = linear(t, params["t_embedder.mlp.0.weight"],
                 params.get("t_embedder.mlp.0.bias"), cfg=qcfg)
    vec = linear(_silu(vec), params["t_embedder.mlp.2.weight"],
                 params.get("t_embedder.mlp.2.bias"), cfg=qcfg)

    c = rms_norm(cap, params.get("cap_embedder.0.weight"))
    c = linear(c, params["cap_embedder.1.weight"],
               params.get("cap_embedder.1.bias"), cfg=qcfg)

    Lc = c.shape[1]
    cap_ids, img_ids = _position_ids(B, Lc, h_tok, w_tok, x.device)
    pe_cap = rope_freqs(cap_ids, cfg.axes_dim)
    pe_img = rope_freqs(img_ids, cfg.axes_dim)

    for i in range(_count(params, "context_refiner")):
        c = _block(block_subtree(params, f"context_refiner.{i}."), c, None,
                   pe_cap, cfg, qcfg)
    for i in range(cfg.n_refiner):
        x = _block(block_subtree(params, f"noise_refiner.{i}."), x, vec,
                   pe_img, cfg, qcfg)

    cx = torch.cat([c.to(x.dtype), x], dim=1)
    pe = torch.cat([pe_cap, pe_img], dim=1)
    return cx, vec.to(x.dtype), pe, Lc, (B, Hh, Ww, C, h_tok, w_tok)


def _head(params, cfg: Lumina2Config, x, vec, dims, qcfg):
    """The final layer: a 2-chunk (shift, scale) modulation, or a
    scale-only one of one chunk."""
    B, Hh, Ww, C, h_tok, w_tok = dims
    p = cfg.patch_size
    x = rms_norm(x, params.get("norm_final.weight"))
    mod = linear(_silu(vec.to(x.dtype)),
                 params["final_layer.adaLN_modulation.1.weight"],
                 params.get("final_layer.adaLN_modulation.1.bias"), cfg=qcfg)
    if mod.shape[-1] == 2 * cfg.dim:
        shift, scale = torch.chunk(mod[:, None, :], 2, dim=-1)
        x = x * (1 + scale) + shift
    else:
        x = x * (1 + mod[:, None, :])
    x = linear(x, params["final_layer.linear.weight"],
               params.get("final_layer.linear.bias"), cfg=qcfg)
    x = x.reshape(B, h_tok, w_tok, p, p, C)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(B, Hh, Ww, C)


def forward(params, cfg: Lumina2Config, latent, cap, timesteps,
            qcfg: QuantConfig = DEFAULT_CONFIG) -> torch.Tensor:
    """latent (B, H, W, C) NHWC, cap (B, Lc, cap_dim) caption states,
    timesteps (B,) in [0, 1] → velocity latent (B, H, W, C)."""
    cx, vec, pe, Lc, dims = _prelude(params, cfg, latent, cap, timesteps,
                                     qcfg)
    for i in range(cfg.n_layers):
        cx = _block(block_subtree(params, f"layers.{i}."), cx, vec, pe, cfg,
                    qcfg)
    return _head(params, cfg, cx[:, Lc:], vec, dims, qcfg)


def stack_lumina2_params(params: dict, cfg: Lumina2Config) -> dict:
    """Flat params → {non-layer keys, "layers": stacked subtree}; the
    context and noise refiners (a few blocks) stay flat."""
    return stack_block_groups(params, [("layers", cfg.n_layers)],
                              arch="lumina2")


def forward_stacked(sparams: dict, cfg: Lumina2Config, latent, cap,
                    timesteps,
                    qcfg: QuantConfig = DEFAULT_CONFIG) -> torch.Tensor:
    """forward() over stack_lumina2_params() output — identical math, one
    loop over views of the stacked main layers."""
    cx, vec, pe, Lc, dims = _prelude(sparams, cfg, latent, cap, timesteps,
                                     qcfg)
    for i in range(cfg.n_layers):
        cx = _block(block_view(sparams["layers"], i), cx, vec, pe, cfg, qcfg)
    return _head(sparams, cfg, cx[:, Lc:], vec, dims, qcfg)
