"""AuraFlow DiT, arch "aura" (PyTorch port of
comfyui_gguf_tpu/models/aura.py).

An MMDiT over AuraFlow's own key names: a learned positional table
(cropped to the image's tokens) and register tokens prepended to the text
stream; double layers with separate cond (``w1*``/``mlpC``/``modC``) and
image (``w2*``/``mlpX``/``modX``) parameters and a joint attention; single
layers over the concatenation (``w1*``/``mlp``/``modCX``); the gated MLP
``c_proj(silu(c_fc1 x) · c_fc2 x)``; 6-chunk modulations, a 2-chunk final
``modF``; and a per-head LayerNorm of q and k without affine weights (it
has no keys, so it always runs). Heads are 256 wide (hidden / 256 of
them), which K7 runs on its 256-wide instance.

``forward_stacked`` is the reference's ``lax.scan`` over each layer kind as
a Python loop over views of the stacked weights (``flux.block_view``).
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from ..nn.attention import dot_product_attention
from ..nn.layers import DEFAULT_CONFIG, QuantConfig, layer_norm, linear
from .flux import (block_subtree, block_view, stack_block_groups,
                   timestep_embedding)


@dataclasses.dataclass(frozen=True)
class AuraConfig:
    hidden: int
    n_heads: int
    depth_double: int
    depth_single: int
    patch_size: int = 2
    in_channels: int = 4
    cond_dim: int = 2048
    n_register_tokens: int = 8

    @staticmethod
    def from_state_dict(sd) -> "AuraConfig":
        def shape(k):
            return tuple(sd[k].shape)

        hidden, in_feat = shape("init_x_linear.weight")
        nd = 0
        while f"double_layers.{nd}.attn.w2q.weight" in sd:
            nd += 1
        ns = 0
        while f"single_layers.{ns}.attn.w1q.weight" in sd:
            ns += 1
        return AuraConfig(
            hidden=int(hidden), n_heads=int(hidden) // 256,
            depth_double=nd, depth_single=ns,
            in_channels=int(in_feat) // 4,
            cond_dim=int(shape("cond_seq_linear.weight")[1]),
            n_register_tokens=int(shape("register_tokens")[-2]))


def _silu(x: torch.Tensor) -> torch.Tensor:
    return F.silu(x.to(torch.float32)).to(x.dtype)


def _mlp(params, p: str, x, qcfg):
    """c_proj(silu(c_fc1 x) · c_fc2 x)."""
    a = linear(x, params[f"{p}.c_fc1.weight"], params.get(f"{p}.c_fc1.bias"),
               cfg=qcfg)
    b = linear(x, params[f"{p}.c_fc2.weight"], params.get(f"{p}.c_fc2.bias"),
               cfg=qcfg)
    return linear(_silu(a) * b, params[f"{p}.c_proj.weight"],
                  params.get(f"{p}.c_proj.bias"), cfg=qcfg)


def _mod(params, key: str, vec, n: int, qcfg):
    out = linear(_silu(vec), params[f"{key}.1.weight"],
                 params.get(f"{key}.1.bias"), cfg=qcfg)
    return torch.chunk(out[:, None, :], n, dim=-1)


def _heads(x, n: int):
    B, L, D = x.shape
    return x.reshape(B, L, n, D // n).transpose(1, 2)


def _qk_norm(x):
    """Per-head LayerNorm over the head dim, no affine, eps 1e-5 (the
    published implementation's nn.LayerNorm default)."""
    return layer_norm(x, eps=1e-5)


def _attn_joint(q, k, v):
    out = dot_product_attention(q, k, v)
    B, H, L, D = out.shape
    return out.transpose(1, 2).reshape(B, L, H * D)


def _qkv(p, prefix: str, x, H: int, qcfg):
    q = _qk_norm(_heads(linear(x, p[f"attn.{prefix}q.weight"], cfg=qcfg), H))
    k = _qk_norm(_heads(linear(x, p[f"attn.{prefix}k.weight"], cfg=qcfg), H))
    v = _heads(linear(x, p[f"attn.{prefix}v.weight"], cfg=qcfg), H)
    return q, k, v


def _double_layer(p: dict, c, x, vec, cfg: AuraConfig, qcfg):
    """One double layer over its UNPREFIXED param subtree ``p``."""
    H = cfg.n_heads
    c_sh1, c_sc1, c_g1, c_sh2, c_sc2, c_g2 = _mod(p, "modC", vec, 6, qcfg)
    x_sh1, x_sc1, x_g1, x_sh2, x_sc2, x_g2 = _mod(p, "modX", vec, 6, qcfg)
    c_mod = layer_norm(c) * (1 + c_sc1) + c_sh1
    x_mod = layer_norm(x) * (1 + x_sc1) + x_sh1

    cq, ck, cv = _qkv(p, "w1", c_mod, H, qcfg)
    xq, xk, xv = _qkv(p, "w2", x_mod, H, qcfg)
    a = _attn_joint(torch.cat([cq, xq], dim=2), torch.cat([ck, xk], dim=2),
                    torch.cat([cv, xv], dim=2))
    Lc = c.shape[1]
    c_a, x_a = a[:, :Lc], a[:, Lc:]

    c = c + c_g1 * linear(c_a, p["attn.w1o.weight"], cfg=qcfg)
    c = c + c_g2 * _mlp(p, "mlpC", layer_norm(c) * (1 + c_sc2) + c_sh2, qcfg)
    x = x + x_g1 * linear(x_a, p["attn.w2o.weight"], cfg=qcfg)
    x = x + x_g2 * _mlp(p, "mlpX", layer_norm(x) * (1 + x_sc2) + x_sh2, qcfg)
    return c, x


def _single_layer(p: dict, cx, vec, cfg: AuraConfig, qcfg):
    """One single layer over its UNPREFIXED param subtree ``p``."""
    sh1, sc1, g1, sh2, sc2, g2 = _mod(p, "modCX", vec, 6, qcfg)
    m = layer_norm(cx) * (1 + sc1) + sh1
    a = _attn_joint(*_qkv(p, "w1", m, cfg.n_heads, qcfg))
    cx = cx + g1 * linear(a, p["attn.w1o.weight"], cfg=qcfg)
    return cx + g2 * _mlp(p, "mlp", layer_norm(cx) * (1 + sc2) + sh2, qcfg)


def _prelude(params, cfg: AuraConfig, latent, cond, timesteps, qcfg):
    B, Hh, Ww, C = latent.shape
    p = cfg.patch_size
    h_tok, w_tok = Hh // p, Ww // p

    # patchify (C, ph, pw order) → init_x_linear + the cropped positional
    # table
    xp = latent.reshape(B, h_tok, p, w_tok, p, C).permute(0, 1, 3, 5, 2, 4)
    xp = xp.reshape(B, h_tok * w_tok, C * p * p)
    x = linear(xp, params["init_x_linear.weight"],
               params.get("init_x_linear.bias"), cfg=qcfg)
    pos = params["positional_encoding"]
    if pos.dim() == 2:
        pos = pos[None]
    x = x + pos[:, : x.shape[1]].to(x.dtype)

    t = timestep_embedding(timesteps, 256, time_factor=1.0).to(x.dtype)
    vec = linear(t, params["t_embedder.mlp.0.weight"],
                 params.get("t_embedder.mlp.0.bias"), cfg=qcfg)
    vec = linear(_silu(vec), params["t_embedder.mlp.2.weight"],
                 params.get("t_embedder.mlp.2.bias"), cfg=qcfg)

    c = linear(cond, params["cond_seq_linear.weight"], cfg=qcfg)
    regs = params["register_tokens"]
    if regs.dim() == 2:
        regs = regs[None]
    c = torch.cat([regs.to(c.dtype).expand(B, regs.shape[-2], c.shape[-1]),
                   c], dim=1)
    return c.to(x.dtype), x, vec.to(x.dtype), (B, Hh, Ww, C, h_tok, w_tok)


def _head(params, cfg: AuraConfig, x, vec, dims, qcfg):
    B, Hh, Ww, C, h_tok, w_tok = dims
    p = cfg.patch_size
    shift, scale = _mod(params, "modF", vec, 2, qcfg)
    x = layer_norm(x) * (1 + scale) + shift
    x = linear(x, params["final_linear.weight"], cfg=qcfg)
    x = x.reshape(B, h_tok, w_tok, C, p, p)
    return x.permute(0, 1, 4, 2, 5, 3).reshape(B, Hh, Ww, C)


def forward(params, cfg: AuraConfig, latent, cond, timesteps,
            qcfg: QuantConfig = DEFAULT_CONFIG) -> torch.Tensor:
    """latent (B, H, W, C) NHWC, cond (B, L, cond_dim) Pile-T5 states,
    timesteps (B,) in [0, 1] → velocity latent (B, H, W, C)."""
    c, x, vec, dims = _prelude(params, cfg, latent, cond, timesteps, qcfg)
    for i in range(cfg.depth_double):
        c, x = _double_layer(block_subtree(params, f"double_layers.{i}."),
                             c, x, vec, cfg, qcfg)
    cx = torch.cat([c, x], dim=1)
    for i in range(cfg.depth_single):
        cx = _single_layer(block_subtree(params, f"single_layers.{i}."),
                           cx, vec, cfg, qcfg)
    return _head(params, cfg, cx[:, c.shape[1]:], vec, dims, qcfg)


def stack_aura_params(params: dict, cfg: AuraConfig) -> dict:
    """Flat params → {non-layer keys, "double_layers": stacked subtree,
    "single_layers": stacked subtree} (copies the layer weights once)."""
    return stack_block_groups(params,
                              [("double_layers", cfg.depth_double),
                               ("single_layers", cfg.depth_single)],
                              arch="aura")


def forward_stacked(sparams: dict, cfg: AuraConfig, latent, cond, timesteps,
                    qcfg: QuantConfig = DEFAULT_CONFIG) -> torch.Tensor:
    """forward() over stack_aura_params() output — identical math, one loop
    per layer kind over views of the stacked weights."""
    c, x, vec, dims = _prelude(sparams, cfg, latent, cond, timesteps, qcfg)
    for i in range(cfg.depth_double):
        c, x = _double_layer(block_view(sparams["double_layers"], i), c, x,
                             vec, cfg, qcfg)
    cx = torch.cat([c, x], dim=1)
    for i in range(cfg.depth_single):
        cx = _single_layer(block_view(sparams["single_layers"], i), cx, vec,
                           cfg, qcfg)
    return _head(sparams, cfg, cx[:, c.shape[1]:], vec, dims, qcfg)
