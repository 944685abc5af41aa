"""NVIDIA Cosmos Predict2 DiT, arch "cosmos" (PyTorch port of
comfyui_gguf_tpu/models/cosmos.py).

Per block three adaLN modulations (self-attention, cross-attention, MLP),
each (shift, scale, gate) from the timestep vector; RMS-qk self-attention
with 3-D RoPE; cross-attention to T5 text states; a GELU-tanh MLP
(``layer1`` / ``layer2``). The patch embed is a linear over (1, 2, 2)
patches of the (B, F, H, W, C) latent. The ``adaln_modulation_*`` keys are
modulation keys, so a w8a8 tree keeps them planar and they run the split-K
body of the fused dequant-matmul at M = batch. Shares ``rope_3d``,
``_apply_rope``, ``_heads`` and ``_attn`` with models/wan.py, as in the
reference.

``forward_stacked`` runs the blocks as a Python loop over views of the
stacked weights (``flux.block_view``), no copy.
"""

from __future__ import annotations

import dataclasses

import torch

from ..nn.layers import (DEFAULT_CONFIG, QuantConfig, layer_norm, linear,
                         rms_norm)
from .flux import (block_subtree, block_view, stack_block_groups,
                   timestep_embedding)
from .wan import _apply_rope, _attn, _gelu, _heads, _silu, rope_3d


@dataclasses.dataclass(frozen=True)
class CosmosConfig:
    dim: int
    n_layers: int
    n_heads: int
    in_channels: int = 16
    text_dim: int = 1024
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
        hd = self.head_dim
        hw = 2 * (hd // 6)
        return (hd - 2 * hw, hw, hw)

    @staticmethod
    def from_state_dict(sd) -> "CosmosConfig":
        def shape(k):
            return tuple(sd[k].shape)

        dim = shape("blocks.0.mlp.layer1.weight")[1]
        qn = shape("blocks.0.self_attn.q_norm.weight")[0]
        n = 0
        while f"blocks.{n}.mlp.layer1.weight" in sd:
            n += 1
        return CosmosConfig(
            dim=int(dim), n_layers=n, n_heads=int(dim) // int(qn),
            text_dim=int(shape("blocks.0.cross_attn.k_proj.weight")[1]))


def _mod3(p, key, vec, qcfg):
    out = linear(_silu(vec), p[f"{key}.1.weight"], p.get(f"{key}.1.bias"),
                 cfg=qcfg)
    if f"{key}.2.weight" in p:  # an extra Linear in the Sequential
        out = linear(out, p[f"{key}.2.weight"], p.get(f"{key}.2.bias"),
                     cfg=qcfg)
    return torch.chunk(out[:, None, :], 3, dim=-1)


def _proj_heads(p, name, x, H, qcfg, norm=None):
    h = _heads(linear(x, p[f"{name}.weight"], p.get(f"{name}.bias"),
                      cfg=qcfg), H)
    if norm is not None and f"{norm}.weight" in p:
        h = rms_norm(h, p[f"{norm}.weight"], eps=1e-6)
    return h


def _block(bp, x, ctx, vec, pe, cfg: CosmosConfig, qcfg):
    """One Cosmos block over its UNPREFIXED param subtree ``bp``."""
    H = cfg.n_heads

    def out_proj(name, a):
        return linear(a, bp[f"{name}.output_proj.weight"],
                      bp.get(f"{name}.output_proj.bias"), cfg=qcfg)

    sh, sc, g = _mod3(bp, "adaln_modulation_self_attn", vec, qcfg)
    h = layer_norm(x, eps=1e-6) * (1 + sc) + sh
    q = _proj_heads(bp, "self_attn.q_proj", h, H, qcfg, "self_attn.q_norm")
    k = _proj_heads(bp, "self_attn.k_proj", h, H, qcfg, "self_attn.k_norm")
    v = _proj_heads(bp, "self_attn.v_proj", h, H, qcfg)
    a = _attn(_apply_rope(q, pe), _apply_rope(k, pe), v)
    x = x + g * out_proj("self_attn", a)

    sh, sc, g = _mod3(bp, "adaln_modulation_cross_attn", vec, qcfg)
    h = layer_norm(x, eps=1e-6) * (1 + sc) + sh
    q = _proj_heads(bp, "cross_attn.q_proj", h, H, qcfg, "cross_attn.q_norm")
    k = _proj_heads(bp, "cross_attn.k_proj", ctx, H, qcfg,
                    "cross_attn.k_norm")
    v = _proj_heads(bp, "cross_attn.v_proj", ctx, H, qcfg)
    x = x + g * out_proj("cross_attn", _attn(q, k, v))

    sh, sc, g = _mod3(bp, "adaln_modulation_mlp", vec, qcfg)
    h = layer_norm(x, eps=1e-6) * (1 + sc) + sh
    h = linear(h, bp["mlp.layer1.weight"], bp.get("mlp.layer1.bias"),
               cfg=qcfg)
    h = linear(_gelu(h), bp["mlp.layer2.weight"], bp.get("mlp.layer2.bias"),
               cfg=qcfg)
    return x + g * h


def _prelude(params, cfg: CosmosConfig, latent, context, timesteps, qcfg):
    B, Fr, Hh, Ww, C = latent.shape
    pt, ph, pw = cfg.patch
    f, h_, w_ = Fr // pt, Hh // ph, Ww // pw
    xp = latent.reshape(B, f, pt, h_, ph, w_, pw, C)
    xp = xp.permute(0, 1, 3, 5, 7, 2, 4, 6).reshape(
        B, f * h_ * w_, C * pt * ph * pw)
    key = ("x_embedder.proj.1.weight"
           if "x_embedder.proj.1.weight" in params
           else "x_embedder.proj.weight")
    x = linear(xp, params[key], params.get(key.replace("weight", "bias")),
               cfg=qcfg)

    pre = ("t_embedder.1" if "t_embedder.1.linear_1.weight" in params
           else "t_embedder")
    vec = linear(timestep_embedding(timesteps, 256).to(x.dtype),
                 params[f"{pre}.linear_1.weight"],
                 params.get(f"{pre}.linear_1.bias"), cfg=qcfg)
    vec = linear(_silu(vec).to(x.dtype), params[f"{pre}.linear_2.weight"],
                 params.get(f"{pre}.linear_2.bias"), cfg=qcfg)
    if "t_embedding_norm.weight" in params:
        vec = rms_norm(vec, params["t_embedding_norm.weight"], eps=1e-6)
    pe = rope_3d(f, h_, w_, cfg.axes_dim, device=x.device)
    return (x, context.to(x.dtype), vec.to(x.dtype), pe,
            (B, Fr, Hh, Ww, C, f, h_, w_))


def _head(params, cfg: CosmosConfig, x, vec, dims, qcfg):
    B, Fr, Hh, Ww, C, f, h_, w_ = dims
    pt, ph, pw = cfg.patch
    if "final_layer.adaln_modulation.1.weight" in params:
        mod = linear(_silu(vec).to(x.dtype),
                     params["final_layer.adaln_modulation.1.weight"],
                     params.get("final_layer.adaln_modulation.1.bias"),
                     cfg=qcfg)
        chunks = torch.chunk(mod[:, None, :], mod.shape[-1] // cfg.dim,
                             dim=-1)
        sh, sc = chunks[0], chunks[1]
    else:
        sh = sc = torch.zeros((1, 1, 1), dtype=x.dtype, device=x.device)
    x = layer_norm(x, eps=1e-6) * (1 + sc) + sh
    x = linear(x, params["final_layer.linear.weight"],
               params.get("final_layer.linear.bias"), cfg=qcfg)
    x = x.reshape(B, f, h_, w_, C, pt, ph, pw)
    x = x.permute(0, 1, 5, 2, 6, 3, 7, 4)
    return x.reshape(B, Fr, Hh, Ww, C)


def forward(params, cfg: CosmosConfig, latent: torch.Tensor,
            context: torch.Tensor, timesteps: torch.Tensor,
            qcfg: QuantConfig = DEFAULT_CONFIG) -> torch.Tensor:
    """latent (B, F, H, W, C) NDHWC, context (B, L, text_dim), timesteps
    (B,) → the velocity latent, same shape."""
    x, ctx, vec, pe, dims = _prelude(params, cfg, latent, context,
                                     timesteps, qcfg)
    for i in range(cfg.n_layers):
        x = _block(block_subtree(params, f"blocks.{i}."), x, ctx, vec, pe,
                   cfg, qcfg)
    return _head(params, cfg, x, vec, dims, qcfg)


def stack_cosmos_params(params: dict, cfg: CosmosConfig) -> dict:
    """Flat params → {non-block keys, "blocks": stacked subtree} (copies
    the block weights once; Cosmos blocks are homogeneous)."""
    return stack_block_groups(params, [("blocks", cfg.n_layers)],
                              arch="cosmos")


def forward_stacked(sparams: dict, cfg: CosmosConfig, latent, context,
                    timesteps, qcfg: QuantConfig = DEFAULT_CONFIG):
    """forward() over stack_cosmos_params() output — identical math, one
    loop over views of the stacked blocks."""
    x, ctx, vec, pe, dims = _prelude(sparams, cfg, latent, context,
                                     timesteps, qcfg)
    for i in range(cfg.n_layers):
        x = _block(block_view(sparams["blocks"], i), x, ctx, vec, pe, cfg,
                   qcfg)
    return _head(sparams, cfg, x, vec, dims, qcfg)
