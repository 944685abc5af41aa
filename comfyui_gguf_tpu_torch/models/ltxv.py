"""LTX-Video DiT, arch "ltxv" (PyTorch port of
comfyui_gguf_tpu/models/ltxv.py).

A PixArt-lineage video transformer over flattened latent voxels: a
per-block learned ``scale_shift_table`` added to one shared adaLN
projection (``adaln_single``), RMS-normed modulated self-attention with
3-axis RoPE, an un-modulated cross-attention to T5 states, a GELU-tanh
feed-forward and a 2-chunk modulated head. The qk-norm is across heads
(one RMS over the full inner dim, a weight of length dim, before the head
split) as the published implementation has it, or per head (a weight of
length head_dim, after the split), told apart by the weight's length.
Attention runs through ``dot_product_attention`` (K7 on the card, D = 64:
self-attention over the L voxels, cross-attention at Lk = the T5 length).

RoPE positions come from the caller as (B, L, 3) voxel coordinates
(frame, row, col) through flux's ``rope_freqs`` / ``apply_rope``.
``forward_stacked`` runs the blocks as a Python loop over views of the
stacked weights (``flux.block_view``), no copy.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from ..nn.attention import dot_product_attention
from ..nn.layers import DEFAULT_CONFIG, QuantConfig, linear, rms_norm
from .flux import (_silu, apply_rope, block_subtree, block_view, rope_freqs,
                   stack_block_groups, timestep_embedding)
from .wan import _gelu, _heads, _unheads


@dataclasses.dataclass(frozen=True)
class LTXVConfig:
    dim: int
    n_layers: int
    n_heads: int
    in_channels: int
    caption_dim: int = 4096
    head_dim: int = 64

    @property
    def axes_dim(self) -> tuple[int, int, int]:
        hd = self.head_dim  # 64 → (24, 20, 20)
        hw = 2 * (hd // 6)
        return (hd - 2 * hw, hw, hw)

    @staticmethod
    def from_state_dict(sd) -> "LTXVConfig":
        dim, in_ch = (int(s) for s in sd["patchify_proj.weight"].shape)
        n = 0
        while f"transformer_blocks.{n}.attn1.to_q.weight" in sd:
            n += 1
        cap = int(sd["caption_projection.linear_1.weight"].shape[1])
        return LTXVConfig(dim=dim, n_layers=n, n_heads=dim // 64,
                          in_channels=in_ch, caption_dim=cap)


def _lin(params, key, x, qcfg):
    return linear(x, params[f"{key}.weight"], params.get(f"{key}.bias"),
                  cfg=qcfg)


def _attention(params, p, xq, xkv, n_heads, qcfg, pe=None):
    q = _lin(params, f"{p}.to_q", xq, qcfg)
    k = _lin(params, f"{p}.to_k", xkv, qcfg)
    v = _lin(params, f"{p}.to_v", xkv, qcfg)
    qn, kn = params.get(f"{p}.q_norm.weight"), params.get(f"{p}.k_norm.weight")
    across = qn is not None and qn.numel() == q.shape[-1]
    if across:  # one RMS over the full inner dim, before the split
        q, k = rms_norm(q, qn, eps=1e-6), rms_norm(k, kn, eps=1e-6)
    q, k, v = _heads(q, n_heads), _heads(k, n_heads), _heads(v, n_heads)
    # per head, after the split (with one head both layouts coincide, and
    # ``across`` keeps the weight from applying twice)
    if qn is not None and not across and qn.numel() == q.shape[-1]:
        q, k = rms_norm(q, qn, eps=1e-6), rms_norm(k, kn, eps=1e-6)
    if pe is not None:
        q, k = apply_rope(q, pe), apply_rope(k, pe)
    return _lin(params, f"{p}.to_out.0",
                _unheads(dot_product_attention(q, k, v)), qcfg)


def _block(p, x, e6, ctx, pe, cfg: LTXVConfig, qcfg):
    """One LTXV block over its UNPREFIXED param subtree ``p``."""
    ss = (p["scale_shift_table"].reshape(1, 6, cfg.dim) + e6).to(x.dtype)
    sh1, sc1, g1, sh2, sc2, g2 = [ss[:, j][:, None] for j in range(6)]

    h = rms_norm(x, eps=1e-6) * (1 + sc1) + sh1
    x = x + g1 * _attention(p, "attn1", h, h, cfg.n_heads, qcfg, pe=pe)
    # cross-attention on the un-modulated residual (PixArt convention)
    x = x + _attention(p, "attn2", x, ctx, cfg.n_heads, qcfg)
    h = rms_norm(x, eps=1e-6) * (1 + sc2) + sh2
    h = _gelu(_lin(p, "ff.net.0.proj", h, qcfg))
    return x + g2 * _lin(p, "ff.net.2", h, qcfg)


def _prelude(params, cfg: LTXVConfig, tokens, ids, context, timesteps, qcfg):
    x = _lin(params, "patchify_proj", tokens, qcfg)
    # the shared adaLN: sinusoid → 2-layer MLP → a 6-chunk projection
    pre = "adaln_single.emb.timestep_embedder"
    e = _lin(params, f"{pre}.linear_1",
             timestep_embedding(timesteps, 256).to(x.dtype), qcfg)
    e = _lin(params, f"{pre}.linear_2", _silu(e.to(x.dtype)), qcfg)
    e6 = _lin(params, "adaln_single.linear", _silu(e.to(x.dtype)), qcfg)
    e6 = e6.reshape(-1, 6, cfg.dim)

    ctx = _gelu(_lin(params, "caption_projection.linear_1", context, qcfg))
    ctx = _lin(params, "caption_projection.linear_2", ctx.to(x.dtype), qcfg)
    pe = rope_freqs(ids, cfg.axes_dim)
    return x, ctx.to(x.dtype), e, e6.to(x.dtype), pe


def _head(params, cfg: LTXVConfig, x, e, qcfg):
    fin = (params["scale_shift_table"].reshape(1, 2, cfg.dim)
           + e.reshape(-1, 1, cfg.dim)).to(x.dtype)
    shift, scale = fin[:, 0][:, None], fin[:, 1][:, None]
    x = rms_norm(x, eps=1e-6) * (1 + scale) + shift
    return _lin(params, "proj_out", x, qcfg)


def forward(params, cfg: LTXVConfig, tokens: torch.Tensor, ids: torch.Tensor,
            context: torch.Tensor, timesteps: torch.Tensor,
            qcfg: QuantConfig = DEFAULT_CONFIG) -> torch.Tensor:
    """tokens (B, L, in_channels) latent voxels, ids (B, L, 3) positions,
    context (B, Lc, caption_dim), timesteps (B,) in [0, 1] → the velocity
    tokens, same shape."""
    x, ctx, e, e6, pe = _prelude(params, cfg, tokens, ids, context,
                                 timesteps, qcfg)
    for i in range(cfg.n_layers):
        x = _block(block_subtree(params, f"transformer_blocks.{i}."),
                   x, e6, ctx, pe, cfg, qcfg)
    return _head(params, cfg, x, e, qcfg)


def stack_ltxv_params(params: dict, cfg: LTXVConfig) -> dict:
    """Flat params → {non-block keys, "transformer_blocks": stacked
    subtree} (copies the block weights once; LTXV blocks are
    homogeneous)."""
    return stack_block_groups(
        params, [("transformer_blocks", cfg.n_layers)], arch="ltxv")


def forward_stacked(sparams: dict, cfg: LTXVConfig, tokens, ids, context,
                    timesteps, qcfg: QuantConfig = DEFAULT_CONFIG):
    """forward() over stack_ltxv_params() output — identical math, one loop
    over views of the stacked blocks."""
    x, ctx, e, e6, pe = _prelude(sparams, cfg, tokens, ids, context,
                                 timesteps, qcfg)
    for i in range(cfg.n_layers):
        x = _block(block_view(sparams["transformer_blocks"], i), x, e6, ctx,
                   pe, cfg, qcfg)
    return _head(sparams, cfg, x, e, qcfg)
