"""SD3 / SD3.5 MMDiT (PyTorch port of comfyui_gguf_tpu/models/sd3.py).

The joint context/latent transformer over the original sgm/mmdit key
format: SD3-medium, SD3.5-large (per-head QK RMSNorm) and SD3.5-medium
(dual-attention ``x_block.attn2`` blocks). Every block linear goes through
``nn.layers.linear`` and so through the fused kernels; the MLP's GELU-tanh
rides the kernel epilogue (``linear_gelu``).

``forward_stacked`` is the reference's ``lax.scan`` over the depth-stacked
joint blocks as a Python loop over views of the stacked weights
(``flux.block_view``), then the unrolled pre-only last block.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from ..nn.attention import dot_product_attention
from ..nn.layers import (QuantConfig, DEFAULT_CONFIG, layer_norm, linear,
                         linear_gelu, materialize, rms_norm)
from .flux import (block_subtree, block_view, stack_block_groups,
                   timestep_embedding)


@dataclasses.dataclass(frozen=True)
class SD3Config:
    hidden: int
    depth: int
    n_heads: int
    patch_size: int = 2
    in_channels: int = 16
    context_dim: int = 4096
    pooled_dim: int = 2048
    pos_embed_max: int = 192  # pos_embed grid side (sd3 family: 192)
    dual_attn_layers: tuple[int, ...] = ()  # sd3.5-medium
    qk_norm: bool = False  # sd3.5

    @staticmethod
    def from_state_dict(sd) -> "SD3Config":
        def shape(k):
            return tuple(sd[k].shape)

        hidden = shape("joint_blocks.0.x_block.attn.qkv.weight")[1]
        depth = 0
        while f"joint_blocks.{depth}.x_block.attn.qkv.weight" in sd:
            depth += 1
        pe = shape("pos_embed")
        pos_max = int(round(pe[-2] ** 0.5)) if len(pe) == 3 else 192
        dual = tuple(
            i for i in range(depth)
            if f"joint_blocks.{i}.x_block.attn2.qkv.weight" in sd)
        qk = "joint_blocks.0.x_block.attn.ln_q.weight" in sd
        # per-head qk-norm weights carry the true head dim; the family
        # default is 64 (sd3-medium 1536/24, sd3.5-large 2432/38)
        hd = (int(shape("joint_blocks.0.x_block.attn.ln_q.weight")[0])
              if qk else 64)
        return SD3Config(
            hidden=int(hidden), depth=depth, n_heads=int(hidden) // hd,
            context_dim=int(shape("context_embedder.weight")[1]),
            pooled_dim=int(shape("y_embedder.mlp.0.weight")[1]),
            pos_embed_max=pos_max, dual_attn_layers=dual, qk_norm=qk)


def _silu(x: torch.Tensor) -> torch.Tensor:
    return F.silu(x.to(torch.float32)).to(x.dtype)


def _mlp(params, prefix: str, x, qcfg):
    h = linear_gelu(x, params[f"{prefix}.mlp.fc1.weight"],
                    params.get(f"{prefix}.mlp.fc1.bias"), cfg=qcfg)
    return linear(h, params[f"{prefix}.mlp.fc2.weight"],
                  params.get(f"{prefix}.mlp.fc2.bias"), cfg=qcfg)


def _timestep_mlp(params, prefix: str, emb, qcfg):
    h = linear(emb, params[f"{prefix}.mlp.0.weight"],
               params.get(f"{prefix}.mlp.0.bias"), cfg=qcfg)
    return linear(_silu(h), params[f"{prefix}.mlp.2.weight"],
                  params.get(f"{prefix}.mlp.2.bias"), cfg=qcfg)


def _qkv_heads(params, prefix: str, x, n_heads: int, qk_norm: bool, qcfg):
    """qkv + optional per-head RMS qk-norm → (B, H, L, D) triple (views of
    the fused projection where no norm rewrites them)."""
    B, L, _ = x.shape
    qkv = linear(x, params[f"{prefix}.qkv.weight"],
                 params.get(f"{prefix}.qkv.bias"), cfg=qcfg)
    q, k, v = (a.reshape(B, L, n_heads, -1).transpose(1, 2)
               for a in torch.chunk(qkv, 3, dim=-1))
    if qk_norm:
        q = rms_norm(q, params[f"{prefix}.ln_q.weight"], eps=1e-6)
        k = rms_norm(k, params[f"{prefix}.ln_k.weight"], eps=1e-6)
    return q, k, v


def _attn_out(attn, params, prefix: str, qcfg):
    B, H, L, D = attn.shape
    out = attn.transpose(1, 2).reshape(B, L, H * D)
    return linear(out, params[f"{prefix}.proj.weight"],
                  params.get(f"{prefix}.proj.bias"), cfg=qcfg)


def _modulation(params, prefix: str, vec, n: int, qcfg):
    out = linear(_silu(vec), params[f"{prefix}.adaLN_modulation.1.weight"],
                 params.get(f"{prefix}.adaLN_modulation.1.bias"), cfg=qcfg)
    return torch.chunk(out[:, None, :], n, dim=-1)


def _joint_block(p: dict, ctx, x, vec, cfg: SD3Config, qcfg):
    """One MMDiT joint block over its UNPREFIXED param subtree ``p``.
    pre_only (the last block: no context output) and dual attention are
    detected from the subtree's key set."""
    cb, xb = "context_block", "x_block"
    H = cfg.n_heads
    pre_only = f"{cb}.attn.proj.weight" not in p
    dual = f"{xb}.attn2.qkv.weight" in p

    if pre_only:
        c_shift, c_scale = _modulation(p, cb, vec, 2, qcfg)
    else:
        (c_shift, c_scale, c_gate, c_shift2, c_scale2,
         c_gate2) = _modulation(p, cb, vec, 6, qcfg)
    xm = _modulation(p, xb, vec, 9 if dual else 6, qcfg)
    x_shift, x_scale, x_gate, x_shift2, x_scale2, x_gate2 = xm[:6]

    ctx_mod = layer_norm(ctx, eps=1e-6) * (1 + c_scale) + c_shift
    x_norm = layer_norm(x, eps=1e-6)
    x_mod = x_norm * (1 + x_scale) + x_shift

    cq, ck, cv = _qkv_heads(p, f"{cb}.attn", ctx_mod, H, cfg.qk_norm, qcfg)
    xq, xk, xv = _qkv_heads(p, f"{xb}.attn", x_mod, H, cfg.qk_norm, qcfg)
    q = torch.cat([cq, xq], dim=2)
    k = torch.cat([ck, xk], dim=2)
    v = torch.cat([cv, xv], dim=2)
    attn = dot_product_attention(q, k, v)
    Lc = ctx.shape[1]
    c_attn, x_attn = attn[:, :, :Lc], attn[:, :, Lc:]

    x = x + x_gate * _attn_out(x_attn, p, f"{xb}.attn", qcfg)
    if dual:
        x2_shift, x2_scale, x2_gate = xm[6:]
        x_mod2 = x_norm * (1 + x2_scale) + x2_shift
        q2, k2, v2 = _qkv_heads(p, f"{xb}.attn2", x_mod2, H, cfg.qk_norm,
                                qcfg)
        attn2 = dot_product_attention(q2, k2, v2)
        x = x + x2_gate * _attn_out(attn2, p, f"{xb}.attn2", qcfg)
    h = layer_norm(x, eps=1e-6) * (1 + x_scale2) + x_shift2
    x = x + x_gate2 * _mlp(p, xb, h, qcfg)

    if pre_only:
        return None, x
    ctx = ctx + c_gate * _attn_out(c_attn, p, f"{cb}.attn", qcfg)
    h = layer_norm(ctx, eps=1e-6) * (1 + c_scale2) + c_shift2
    ctx = ctx + c_gate2 * _mlp(p, cb, h, qcfg)
    return ctx, x


def cropped_pos_embed(params, cfg: SD3Config, h_tok: int,
                      w_tok: int) -> torch.Tensor:
    """Center-crop the (1, max², D) pos-embed grid to (1, h·w, D)."""
    pe = params["pos_embed"]
    if pe.dim() == 2:
        pe = pe[None]
    m = cfg.pos_embed_max
    grid = pe.reshape(1, m, m, -1)
    top = (m - h_tok) // 2
    left = (m - w_tok) // 2
    crop = grid[:, top: top + h_tok, left: left + w_tok]
    return crop.reshape(1, h_tok * w_tok, -1)


def _prelude(params, cfg: SD3Config, latent, context, pooled, timesteps,
             qcfg):
    B, Hh, Ww, C = latent.shape
    p = cfg.patch_size
    h_tok, w_tok = Hh // p, Ww // p

    # conv patchify == linear over patches flattened in (C, ph, pw) order
    # (the OIHW conv kernel layout), in f32 on the materialized weight as
    # the reference leaves it to XLA
    wp = materialize(params["x_embedder.proj.weight"], torch.float32)
    D = wp.shape[0]
    xp = latent.reshape(B, h_tok, p, w_tok, p, C).permute(0, 1, 3, 5, 2, 4)
    xp = xp.reshape(B, h_tok * w_tok, C * p * p)
    x = torch.matmul(xp.to(torch.float32),
                     wp.reshape(D, C * p * p).T).to(latent.dtype)
    if "x_embedder.proj.bias" in params:
        x = x + params["x_embedder.proj.bias"].to(x.dtype)
    x = x + cropped_pos_embed(params, cfg, h_tok, w_tok).to(x.dtype)

    temb = timestep_embedding(timesteps, 256)
    vec = _timestep_mlp(params, "t_embedder", temb, qcfg)
    vec = vec + _timestep_mlp(params, "y_embedder", pooled, qcfg)
    # keep the conditioning vector in activation dtype: the f32 timestep
    # embedding must not promote every modulated stream to f32
    vec = vec.to(x.dtype)

    ctx = linear(context, params["context_embedder.weight"],
                 params.get("context_embedder.bias"), cfg=qcfg)
    # f32 conditioning (CLIP/T5 states) must not promote the joint streams
    ctx = ctx.to(x.dtype)
    return ctx, x, vec, (h_tok, w_tok)


def _final(params, cfg: SD3Config, x, vec, toks, qcfg):
    h_tok, w_tok = toks
    B = x.shape[0]
    p = cfg.patch_size
    mod = linear(_silu(vec), params["final_layer.adaLN_modulation.1.weight"],
                 params.get("final_layer.adaLN_modulation.1.bias"), cfg=qcfg)
    shift, scale = torch.chunk(mod[:, None, :], 2, dim=-1)
    x = layer_norm(x, eps=1e-6) * (1 + scale) + shift
    out = linear(x, params["final_layer.linear.weight"],
                 params.get("final_layer.linear.bias"), cfg=qcfg)

    # unpatchify: token vectors are (ph, pw, C)-ordered (MMDiT convention)
    C = out.shape[-1] // (p * p)
    out = out.reshape(B, h_tok, w_tok, p, p, C)
    return out.permute(0, 1, 3, 2, 4, 5).reshape(B, h_tok * p, w_tok * p, C)


def forward(params, cfg: SD3Config, latent, context, pooled, timesteps,
            qcfg: QuantConfig = DEFAULT_CONFIG) -> torch.Tensor:
    """latent (B, H, W, C) NHWC, context (B, L, context_dim),
    pooled (B, pooled_dim), timesteps (B,) in [0, 1] → velocity latent."""
    ctx, x, vec, toks = _prelude(params, cfg, latent, context, pooled,
                                 timesteps, qcfg)
    for i in range(cfg.depth):
        ctx, x = _joint_block(block_subtree(params, f"joint_blocks.{i}."),
                              ctx, x, vec, cfg, qcfg)
    return _final(params, cfg, x, vec, toks, qcfg)


def stack_sd3_params(params: dict, cfg: SD3Config) -> dict:
    """Flat GGUF-keyed params → {non-block keys, stacked block groups,
    "joint_blocks_last": the final (pre-only context) block kept flat}.

    sd3 / sd3.5-large: one homogeneous "joint_blocks" group of depth − 1.
    sd3.5-medium: the dual-attention blocks (extra ``attn2`` keys) form a
    contiguous prefix in the published checkpoints, so they stack as their
    own "joint_blocks_dual" group ahead of the plain group. A
    non-contiguous dual layout raises (use ``forward``)."""
    dual = cfg.dual_attn_layers
    if dual and dual != tuple(range(len(dual))):
        raise ValueError(
            "dual-attention layers are not a contiguous prefix "
            f"({dual}); use forward() for this checkpoint")
    n_dual = len(dual)
    n_plain = cfg.depth - 1 - n_dual

    def renamed(out_key, lo, hi):
        return {f"{out_key}.{i - lo}.{k.split('.', 2)[2]}": v
                for i in range(lo, hi)
                for k, v in params.items()
                if k.startswith(f"joint_blocks.{i}.")}

    flat = {k: v for k, v in params.items()
            if not k.startswith("joint_blocks.")}
    groups = [("joint_blocks", n_plain)]
    flat.update(renamed("joint_blocks", n_dual, cfg.depth - 1))
    if n_dual:
        groups.insert(0, ("joint_blocks_dual", n_dual))
        flat.update(renamed("joint_blocks_dual", 0, n_dual))
    out = stack_block_groups(flat, groups, arch="sd3")
    out["joint_blocks_last"] = block_subtree(
        params, f"joint_blocks.{cfg.depth - 1}.")
    return out


def forward_stacked(sparams: dict, cfg: SD3Config, latent, context, pooled,
                    timesteps,
                    qcfg: QuantConfig = DEFAULT_CONFIG) -> torch.Tensor:
    """forward() over stack_sd3_params() output — identical math, one loop
    per stacked group over views of its weights, then the pre-only last
    block."""
    ctx, x, vec, toks = _prelude(sparams, cfg, latent, context, pooled,
                                 timesteps, qcfg)
    n_dual = len(cfg.dual_attn_layers)
    groups = [("joint_blocks", cfg.depth - 1 - n_dual)]
    if "joint_blocks_dual" in sparams:  # sd3.5-medium prefix group
        groups.insert(0, ("joint_blocks_dual", n_dual))
    for key, n in groups:
        for i in range(n):
            ctx, x = _joint_block(block_view(sparams[key], i), ctx, x, vec,
                                  cfg, qcfg)
    _, x = _joint_block(sparams["joint_blocks_last"], ctx, x, vec, cfg, qcfg)
    return _final(sparams, cfg, x, vec, toks, qcfg)
