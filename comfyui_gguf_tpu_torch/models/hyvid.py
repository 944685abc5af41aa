"""HunyuanVideo DiT, arch "hyvid" (PyTorch port of
comfyui_gguf_tpu/models/hyvid.py).

A flux-lineage double/single-stream video transformer with HunyuanVideo's
own key names (flat ``img_attn_qkv``, ``img_mod.linear``, ``mlp.fc1``): a
(1,2,2) ``conv3d`` patch embed over (B, F, H, W, C) latents, an LLM-token
refiner for the text stream (``txt_in``), 3-axis RoPE on the image tokens
and RMS q/k norms per head. Attention runs through
``dot_product_attention`` (K7 on the card, D = 128: the joint image+text
length in every block, the text length in the refiner).

``rope_3d``, ``_apply_rope``, ``_heads`` and ``_attn`` come from
models/wan.py, as in the reference. ``forward_stacked`` runs the blocks as
a Python loop over views of the stacked weights (``flux.block_view``), no
copy.
"""

from __future__ import annotations

import dataclasses

import torch

from ..nn.layers import (DEFAULT_CONFIG, QuantConfig, conv3d, in_features,
                         layer_norm, linear, linear_gelu, out_features,
                         rms_norm)
from .flux import (_mlp_embed, _silu, block_subtree, block_view,
                   stack_block_groups, timestep_embedding)
from .wan import _apply_rope, _attn, _heads, rope_3d


@dataclasses.dataclass(frozen=True)
class HyVidConfig:
    hidden: int
    n_heads: int
    depth_double: int
    depth_single: int
    mlp_ratio: float = 4.0
    in_channels: int = 16
    text_dim: int = 4096
    patch: tuple[int, int, int] = (1, 2, 2)
    guidance_embed: bool = True
    # the reference's tensor-parallel path divides n_heads per shard and
    # keeps the true head dim (and the RoPE axes derived from it) here
    head_dim_override: int | None = None

    @property
    def head_dim(self) -> int:
        if self.head_dim_override is not None:
            return self.head_dim_override
        return self.hidden // self.n_heads

    @property
    def axes_dim(self) -> tuple[int, int, int]:
        hd = self.head_dim  # HunyuanVideo: 128 → (16, 56, 56)
        hw = 2 * ((hd - hd // 8) // 4)
        return (hd - 2 * hw, hw, hw)

    @staticmethod
    def from_state_dict(sd) -> "HyVidConfig":
        def shape(k):
            return tuple(sd[k].shape)

        pe = shape("img_in.proj.weight")  # (hid, C, pt, ph, pw)
        hidden = pe[0]
        nd = 0
        while f"double_blocks.{nd}.img_attn_qkv.weight" in sd:
            nd += 1
        ns = 0
        while f"single_blocks.{ns}.linear1.weight" in sd:
            ns += 1
        qn = shape("double_blocks.0.img_attn_q_norm.weight")[0]
        return HyVidConfig(
            hidden=int(hidden), n_heads=int(hidden) // int(qn),
            depth_double=nd, depth_single=ns, in_channels=int(pe[1]),
            text_dim=int(shape("txt_in.input_embedder.weight")[1]),
            patch=(int(pe[2]), int(pe[3]), int(pe[4])),
            guidance_embed="guidance_in.in_layer.weight" in sd)


def _lin(params, key, x, qcfg):
    return linear(x, params[f"{key}.weight"], params.get(f"{key}.bias"),
                  cfg=qcfg)


def _mod(params, key, vec, n, qcfg):
    """silu(vec) → ``key``.linear → n chunks, each (B, 1, hidden)."""
    out = _lin(params, f"{key}.linear", _silu(vec), qcfg)
    return torch.chunk(out[:, None, :], n, dim=-1)


def _token_refiner(params, txt, t_emb, qcfg):
    """txt_in: the input embedder, the timestep (+ pooled context) vector,
    then the refiner blocks (self-attention in heads of 128)."""
    x = _lin(params, "txt_in.input_embedder", txt, qcfg)
    if "txt_in.t_embedder.mlp.in_layer.weight" in params:
        vec = _mlp_embed(params, "txt_in.t_embedder.mlp", t_emb, qcfg)
    else:  # the mlp stored as a Sequential: .0 and .2
        vec = _lin(params, "txt_in.t_embedder.mlp.2",
                   _silu(_lin(params, "txt_in.t_embedder.mlp.0", t_emb,
                              qcfg)), qcfg)
    if "txt_in.c_embedder.linear_1.weight" in params:
        c = _lin(params, "txt_in.c_embedder.linear_1", x.mean(dim=1), qcfg)
        vec = vec + _lin(params, "txt_in.c_embedder.linear_2", _silu(c),
                         qcfg)

    i = 0
    base = "txt_in.individual_token_refiner.blocks"
    nh = max(1, x.shape[-1] // 128)
    while f"{base}.{i}.self_attn_qkv.weight" in params:
        p = f"{base}.{i}"
        g1, g2 = torch.chunk(_lin(params, f"{p}.adaLN_modulation.1",
                                  _silu(vec), qcfg)[:, None, :], 2, dim=-1)
        h = layer_norm(x, params.get(f"{p}.norm1.weight"),
                       params.get(f"{p}.norm1.bias"), eps=1e-6)
        q, k, v = torch.chunk(_lin(params, f"{p}.self_attn_qkv", h, qcfg),
                              3, dim=-1)
        a = _attn(_heads(q, nh), _heads(k, nh), _heads(v, nh))
        x = x + g1 * _lin(params, f"{p}.self_attn_proj", a, qcfg)
        h = layer_norm(x, params.get(f"{p}.norm2.weight"),
                       params.get(f"{p}.norm2.bias"), eps=1e-6)
        h = _silu(_lin(params, f"{p}.mlp.fc1", h, qcfg))
        x = x + g2 * _lin(params, f"{p}.mlp.fc2", h, qcfg)
        i += 1
    return x


def _double_block(p, img, txt, vec, pe, cfg: HyVidConfig, qcfg):
    """One double block over its UNPREFIXED param subtree ``p``: image
    tokens first, then text, in the joint attention; RoPE on the image
    tokens only."""
    H = cfg.n_heads
    i_sh1, i_sc1, i_g1, i_sh2, i_sc2, i_g2 = _mod(p, "img_mod", vec, 6, qcfg)
    t_sh1, t_sc1, t_g1, t_sh2, t_sc2, t_g2 = _mod(p, "txt_mod", vec, 6, qcfg)

    img_mod = layer_norm(img, eps=1e-6) * (1 + i_sc1) + i_sh1
    txt_mod = layer_norm(txt, eps=1e-6) * (1 + t_sc1) + t_sh1
    iq, ik, iv = (_heads(a, H) for a in torch.chunk(
        _lin(p, "img_attn_qkv", img_mod, qcfg), 3, dim=-1))
    tq, tk, tv = (_heads(a, H) for a in torch.chunk(
        _lin(p, "txt_attn_qkv", txt_mod, qcfg), 3, dim=-1))
    iq = _apply_rope(rms_norm(iq, p["img_attn_q_norm.weight"], eps=1e-6), pe)
    ik = _apply_rope(rms_norm(ik, p["img_attn_k_norm.weight"], eps=1e-6), pe)
    tq = rms_norm(tq, p["txt_attn_q_norm.weight"], eps=1e-6)
    tk = rms_norm(tk, p["txt_attn_k_norm.weight"], eps=1e-6)

    a = _attn(torch.cat([iq, tq], dim=2), torch.cat([ik, tk], dim=2),
              torch.cat([iv, tv], dim=2))
    L_img = img.shape[1]
    img_a, txt_a = a[:, :L_img], a[:, L_img:]

    img = img + i_g1 * _lin(p, "img_attn_proj", img_a, qcfg)
    h = layer_norm(img, eps=1e-6) * (1 + i_sc2) + i_sh2
    h = linear_gelu(h, p["img_mlp.fc1.weight"], p.get("img_mlp.fc1.bias"),
                    cfg=qcfg)
    img = img + i_g2 * _lin(p, "img_mlp.fc2", h, qcfg)

    txt = txt + t_g1 * _lin(p, "txt_attn_proj", txt_a, qcfg)
    h = layer_norm(txt, eps=1e-6) * (1 + t_sc2) + t_sh2
    h = linear_gelu(h, p["txt_mlp.fc1.weight"], p.get("txt_mlp.fc1.bias"),
                    cfg=qcfg)
    txt = txt + t_g2 * _lin(p, "txt_mlp.fc2", h, qcfg)
    return img, txt


def _single_block(p, x, vec, pe, L_img, cfg: HyVidConfig, qcfg):
    """One single block over its UNPREFIXED param subtree ``p``."""
    H = cfg.n_heads
    # linear1 fuses [q|k|v|mlp]; the boundary comes from the weights'
    # logical sizes: linear1 out = 3h + m and linear2 in = h + m, so 3h =
    # 3·(out1 − in2)/2, whatever the mlp width
    hid3 = 3 * (out_features(p["linear1.weight"])
                - in_features(p["linear2.weight"])) // 2
    shift, scale, gate = _mod(p, "modulation", vec, 3, qcfg)
    x_mod = layer_norm(x, eps=1e-6) * (1 + scale) + shift
    # GELU on the mlp tail columns (>= hid3), in the kernel epilogue
    h = linear_gelu(x_mod, p["linear1.weight"], p.get("linear1.bias"),
                    tail_from=hid3, cfg=qcfg)
    qkv, act = h[..., :hid3], h[..., hid3:]
    q, k, v = (_heads(a, H) for a in torch.chunk(qkv, 3, dim=-1))
    q = rms_norm(q, p["q_norm.weight"], eps=1e-6)
    k = rms_norm(k, p["k_norm.weight"], eps=1e-6)
    # the text tokens carry no 3-D position
    q = torch.cat([_apply_rope(q[:, :, :L_img], pe), q[:, :, L_img:]], dim=2)
    k = torch.cat([_apply_rope(k[:, :, :L_img], pe), k[:, :, L_img:]], dim=2)
    a = _attn(q, k, v)
    out = _lin(p, "linear2", torch.cat([a, act], dim=-1), qcfg)
    return x + gate * out


def _prelude(params, cfg: HyVidConfig, latent, txt, timesteps, guidance,
             qcfg):
    B, Fr, Hh, Ww, C = latent.shape
    pt, ph, pw = cfg.patch
    img = conv3d(latent, params["img_in.proj.weight"],
                 params.get("img_in.proj.bias"), stride=cfg.patch,
                 padding=0, cfg=qcfg)
    f, h, w = Fr // pt, Hh // ph, Ww // pw
    img = img.reshape(B, f * h * w, cfg.hidden)

    temb = timestep_embedding(timesteps, 256).to(img.dtype)
    vec = _mlp_embed(params, "time_in", temb, qcfg)
    if cfg.guidance_embed and guidance is not None:
        vec = vec + _mlp_embed(
            params, "guidance_in",
            timestep_embedding(guidance, 256).to(img.dtype), qcfg)
    txt = _token_refiner(params, txt, temb, qcfg).to(img.dtype)
    vec = vec.to(img.dtype)
    pe = rope_3d(f, h, w, cfg.axes_dim, device=img.device)
    return img, txt, vec, pe, (B, Fr, Hh, Ww, C, f, h, w)


def _final(params, cfg: HyVidConfig, img, vec, dims, qcfg):
    B, Fr, Hh, Ww, C, f, h, w = dims
    pt, ph, pw = cfg.patch
    mod = _lin(params, "final_layer.adaLN_modulation.1", _silu(vec), qcfg)
    shift, scale = torch.chunk(mod[:, None, :], 2, dim=-1)
    img = layer_norm(img, eps=1e-6) * (1 + scale) + shift
    img = _lin(params, "final_layer.linear", img, qcfg)
    img = img.reshape(B, f, h, w, pt, ph, pw, C)
    img = img.permute(0, 1, 4, 2, 5, 3, 6, 7)
    return img.reshape(B, Fr, Hh, Ww, C)


def forward(params, cfg: HyVidConfig, latent: torch.Tensor, txt: torch.Tensor,
            timesteps: torch.Tensor, guidance: torch.Tensor | None = None,
            qcfg: QuantConfig = DEFAULT_CONFIG) -> torch.Tensor:
    """latent (B, F, H, W, C) NDHWC, txt (B, L, text_dim) LLM states,
    timesteps (B,) in [0, 1], guidance (B,) the embedded guidance (×1000,
    as the pipelines bind it) → the velocity latent, same shape."""
    img, txt, vec, pe, dims = _prelude(params, cfg, latent, txt, timesteps,
                                       guidance, qcfg)
    for i in range(cfg.depth_double):
        img, txt = _double_block(block_subtree(params, f"double_blocks.{i}."),
                                 img, txt, vec, pe, cfg, qcfg)
    x = torch.cat([img, txt], dim=1)
    L_img = img.shape[1]
    for i in range(cfg.depth_single):
        x = _single_block(block_subtree(params, f"single_blocks.{i}."),
                          x, vec, pe, L_img, cfg, qcfg)
    return _final(params, cfg, x[:, :L_img], vec, dims, qcfg)


def stack_hyvid_params(params: dict, cfg: HyVidConfig) -> dict:
    """Flat params → {non-block keys, "double_blocks": stacked subtree,
    "single_blocks": stacked subtree} (copies the block weights once; the
    blocks of each kind are homogeneous)."""
    return stack_block_groups(params,
                              [("double_blocks", cfg.depth_double),
                               ("single_blocks", cfg.depth_single)],
                              arch="hyvid")


def forward_stacked(sparams: dict, cfg: HyVidConfig, latent, txt, timesteps,
                    guidance=None, qcfg: QuantConfig = DEFAULT_CONFIG):
    """forward() over stack_hyvid_params() output — identical math, one
    loop per block kind over views of the stacked weights."""
    img, txt, vec, pe, dims = _prelude(sparams, cfg, latent, txt, timesteps,
                                       guidance, qcfg)
    for i in range(cfg.depth_double):
        img, txt = _double_block(block_view(sparams["double_blocks"], i),
                                 img, txt, vec, pe, cfg, qcfg)
    x = torch.cat([img, txt], dim=1)
    L_img = img.shape[1]
    for i in range(cfg.depth_single):
        x = _single_block(block_view(sparams["single_blocks"], i), x, vec,
                          pe, L_img, cfg, qcfg)
    return _final(sparams, cfg, x[:, :L_img], vec, dims, qcfg)
