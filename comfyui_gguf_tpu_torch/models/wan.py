"""Wan 2.1 video DiT, t2v, arch "wan" (PyTorch port of
comfyui_gguf_tpu/models/wan.py).

A (1,2,2) ``conv3d`` patch embed over (B, F, H, W, C) latents; a
sinusoidal time embedding → a per-block 6-chunk modulation added to a
learned per-block table; self-attention with 3-D RoPE and full-width RMS
q/k norms; cross-attention to UMT5 text states; a GELU-tanh FFN; a 2-chunk
modulated head. Attention runs through ``dot_product_attention`` (K7 on
the card, D = 128: self-attention at Lq = Lk, cross-attention at Lk = the
text length).

``rope_3d``, ``_apply_rope``, ``_heads``, ``_unheads`` and ``_attn`` are
shared with models/cosmos.py, as in the reference. ``forward_stacked``
runs the blocks as a Python loop over views of the stacked weights
(``flux.block_view``), no copy.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

from ..nn.attention import (apply_rope, dot_product_attention,
                            split_heads as _heads)
from ..nn.layers import (DEFAULT_CONFIG, QuantConfig, conv3d, layer_norm,
                         linear)
from ..observability import span
from ..ops import qkrope
from ..quant.planar import TPNormShard
from .flux import (block_subtree, block_view, stack_block_groups,
                   timestep_embedding)


@dataclasses.dataclass(frozen=True)
class WanConfig:
    dim: int
    ffn_dim: int
    n_heads: int
    n_layers: int
    in_channels: int = 16
    out_channels: int = 16
    text_dim: int = 4096
    patch: tuple[int, int, int] = (1, 2, 2)
    # tensor parallelism divides n_heads on each rank; the true head dim
    # (and the RoPE axes made from it) is pinned here
    # (parallel/tp_spec.py's wrappers)
    head_dim_override: int | None = None

    @property
    def head_dim(self) -> int:
        if self.head_dim_override is not None:
            return self.head_dim_override
        return self.dim // self.n_heads

    @property
    def axes_dim(self) -> tuple[int, int, int]:
        # Wan's split of a head over (t, h, w): h = w = hd // 3 rounded to
        # even, t the remainder
        hd = self.head_dim
        hw = 2 * (hd // 6)
        return (hd - 2 * hw, hw, hw)

    @staticmethod
    def from_state_dict(sd) -> "WanConfig":
        def shape(k):
            return tuple(sd[k].shape)

        pe = shape("patch_embedding.weight")  # (dim, C, 1, 2, 2)
        dim = pe[0]
        n = 0
        while f"blocks.{n}.self_attn.q.weight" in sd:
            n += 1
        out_c = shape("head.head.weight")[0] // (pe[2] * pe[3] * pe[4])
        # the Wan family has 128-wide heads (1.3B: 1536/12, 14B: 5120/40)
        return WanConfig(
            dim=int(dim), ffn_dim=int(shape("blocks.0.ffn.0.weight")[0]),
            n_heads=int(dim) // 128, n_layers=n, in_channels=int(pe[1]),
            out_channels=int(out_c),
            text_dim=int(shape("text_embedding.0.weight")[1]),
            patch=(int(pe[2]), int(pe[3]), int(pe[4])))


def rope_3d(f: int, h: int, w: int, axes_dim, theta: float = 10_000.0,
            device=None) -> torch.Tensor:
    """(L, hd/2, 2) cos/sin table over (t, y, x) factored positions,
    computed in numpy float32 as the reference computes it."""
    parts = []
    grids = np.meshgrid(np.arange(f), np.arange(h), np.arange(w),
                        indexing="ij")
    for i, d in enumerate(axes_dim):
        pos = grids[i].reshape(-1).astype(np.float32)
        omega = 1.0 / (theta ** (np.arange(0, d, 2, dtype=np.float32) / d))
        ang = pos[:, None] * omega[None]
        parts.append(np.stack([np.cos(ang), np.sin(ang)], axis=-1))
    return torch.from_numpy(np.concatenate(parts, axis=1)).to(device)


def _apply_rope(x: torch.Tensor, pe: torch.Tensor) -> torch.Tensor:
    """x (B, H, L, D); pe (L, D/2, 2)."""
    return apply_rope(x, pe[None])


def _unheads(x: torch.Tensor) -> torch.Tensor:
    B, H, L, D = x.shape
    return x.transpose(1, 2).reshape(B, L, H * D)


def _attn(q, k, v):
    return _unheads(dot_product_attention(q, k, v))


def _norm_rope(p, name: str, q, k, v, n_heads: int, pe):
    """Wan's full-width q/k RMS norms (before the head split) and RoPE
    where ``pe`` is given: (B, H, L, D) q, k, v. A ``TPNormShard`` gain
    (``parallel/tp_spec.py``'s norm over a column-split row) reduces its
    statistics over the mesh axis, which K9 does not: the composition."""
    gq, gk = p[f"{name}.norm_q.weight"], p[f"{name}.norm_k.weight"]
    op = (qkrope.plain_qk_norm_rope if isinstance(gq, TPNormShard)
          else qkrope.qk_norm_rope)
    return op([(q, k, v, gq, gk)], n_heads, pe)


def _gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x.to(torch.float32), approximate="tanh").to(x.dtype)


def _silu(x: torch.Tensor) -> torch.Tensor:
    return F.silu(x.to(torch.float32)).to(x.dtype)


def _block(p, x, e0, ctx, pe, cfg: WanConfig, qcfg):
    """One Wan block over its UNPREFIXED param subtree ``p``."""
    H = cfg.n_heads

    def proj(name, t):
        return linear(t, p[f"{name}.weight"], p.get(f"{name}.bias"),
                      cfg=qcfg)

    def attend(q, k, v, name, rope):
        with span("forward.qk_rope"):
            q, k, v = _norm_rope(p, name, q, k, v, H, pe if rope else None)
        o = dot_product_attention(q, k, v)
        with span("forward.qk_rope"):
            return _unheads(o)

    with span("forward.norm_mod"):
        # 6-chunk modulation: learned table + time projection
        mod = (p["modulation"].reshape(1, 6, cfg.dim)
               + e0.reshape(-1, 6, cfg.dim)).to(x.dtype)
        sh1, sc1, g1, sh2, sc2, g2 = [mod[:, j][:, None] for j in range(6)]
        h = layer_norm(x, eps=1e-6) * (1 + sc1) + sh1
    a = attend(proj("self_attn.q", h), proj("self_attn.k", h),
               proj("self_attn.v", h), "self_attn", rope=True)
    a = proj("self_attn.o", a)
    with span("forward.gate_res"):
        x = x + g1 * a

    # cross attention (an affine LN on its input)
    with span("forward.norm_mod"):
        h = layer_norm(x, p.get("norm3.weight"), p.get("norm3.bias"),
                       eps=1e-6)
    a = attend(proj("cross_attn.q", h), proj("cross_attn.k", ctx),
               proj("cross_attn.v", ctx), "cross_attn", rope=False)
    a = proj("cross_attn.o", a)
    with span("forward.gate_res"):
        x = x + a

    with span("forward.norm_mod"):
        h = layer_norm(x, eps=1e-6) * (1 + sc2) + sh2
    h = proj("ffn.2", _gelu(proj("ffn.0", h)))
    with span("forward.gate_res"):
        return x + g2 * h


def _prelude(params, cfg: WanConfig, latent, context, timesteps, qcfg):
    B, Fr, Hh, Ww, C = latent.shape
    pt, ph, pw = cfg.patch
    x = conv3d(latent, params["patch_embedding.weight"],
               params.get("patch_embedding.bias"), stride=cfg.patch,
               padding=0, cfg=qcfg)
    f, h, w = Fr // pt, Hh // ph, Ww // pw
    x = x.reshape(B, f * h * w, cfg.dim)

    def lin(name, t):
        return linear(t, params[f"{name}.weight"], params.get(f"{name}.bias"),
                      cfg=qcfg)

    ctx = lin("text_embedding.2", _gelu(lin("text_embedding.0", context)))
    ctx = ctx.to(x.dtype)
    e = lin("time_embedding.0", timestep_embedding(timesteps, 256).to(x.dtype))
    e = lin("time_embedding.2", _silu(e.to(x.dtype)))
    e0 = lin("time_projection.1", _silu(e.to(x.dtype)))
    pe = rope_3d(f, h, w, cfg.axes_dim, device=x.device)
    return x, ctx, e, e0, pe, (B, Fr, Hh, Ww, f, h, w)


def _head(params, cfg: WanConfig, x, e, dims, qcfg):
    B, Fr, Hh, Ww, f, h, w = dims
    pt, ph, pw = cfg.patch
    hm = (params["head.modulation"].reshape(1, 2, cfg.dim)
          + e.reshape(-1, 1, cfg.dim)).to(x.dtype)
    shift, scale = hm[:, 0][:, None], hm[:, 1][:, None]
    with span("forward.norm_mod"):
        x = layer_norm(x, eps=1e-6) * (1 + scale) + shift
    x = linear(x, params["head.head.weight"], params.get("head.head.bias"),
               cfg=qcfg)
    x = x.reshape(B, f, h, w, pt, ph, pw, cfg.out_channels)
    x = x.permute(0, 1, 4, 2, 5, 3, 6, 7)
    return x.reshape(B, Fr, Hh, Ww, cfg.out_channels)


def forward(params, cfg: WanConfig, latent: torch.Tensor,
            context: torch.Tensor, timesteps: torch.Tensor,
            qcfg: QuantConfig = DEFAULT_CONFIG) -> torch.Tensor:
    """latent (B, F, H, W, C) NDHWC, context (B, L, text_dim), timesteps
    (B,) in [0, 1] → the velocity latent, same shape."""
    with span("forward.prelude"):
        x, ctx, e, e0, pe, dims = _prelude(params, cfg, latent, context,
                                           timesteps, qcfg)
    for i in range(cfg.n_layers):
        with span("forward.block"):
            x = _block(block_subtree(params, f"blocks.{i}."), x, e0, ctx,
                       pe, cfg, qcfg)
    with span("forward.final"):
        return _head(params, cfg, x, e, dims, qcfg)


def stack_wan_params(params: dict, cfg: WanConfig) -> dict:
    """Flat params → {non-block keys, "blocks": stacked subtree} (copies
    the block weights once; Wan t2v blocks are homogeneous)."""
    return stack_block_groups(params, [("blocks", cfg.n_layers)], arch="wan")


def forward_stacked(sparams: dict, cfg: WanConfig, latent, context,
                    timesteps, qcfg: QuantConfig = DEFAULT_CONFIG):
    """forward() over stack_wan_params() output — identical math, one loop
    over views of the stacked blocks."""
    with span("forward.prelude"):
        x, ctx, e, e0, pe, dims = _prelude(sparams, cfg, latent, context,
                                           timesteps, qcfg)
    for i in range(cfg.n_layers):
        with span("forward.block"):
            x = _block(block_view(sparams["blocks"], i), x, e0, ctx, pe,
                       cfg, qcfg)
    with span("forward.final"):
        return _head(sparams, cfg, x, e, dims, qcfg)
