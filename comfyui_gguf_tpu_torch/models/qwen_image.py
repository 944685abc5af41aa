"""Qwen-Image MMDiT, arch "qwen_image" (PyTorch port of
comfyui_gguf_tpu/models/qwen_image.py).

A flux-lineage joint-attention double-stream transformer with the
diffusers-style keys Qwen-Image files carry (``transformer_blocks.N.attn.
to_q`` for the image stream, ``attn.add_q_proj`` for the text stream,
per-head RMS ``norm_q`` / ``norm_added_q``), conditioned on Qwen2.5-VL text
states. Per block: 6-chunk image and text modulations (``img_mod.1`` /
``txt_mod.1``) of a timestep-only vector, joint attention over [text,
image] through ``dot_product_attention`` (K7 on the card), GELU-tanh MLPs
(the GELU in the fused kernels' epilogue, ``linear_gelu``), 3-axis RoPE.

``forward_stacked`` runs the blocks as a Python loop over views of the
stacked weights (``flux.block_view``), no copy.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from ..nn.attention import dot_product_attention
from ..nn.layers import (DEFAULT_CONFIG, QuantConfig, layer_norm, linear,
                         linear_gelu, rms_norm)
from .flux import (apply_rope, block_subtree, block_view, rope_freqs,
                   stack_block_groups, timestep_embedding)


@dataclasses.dataclass(frozen=True)
class QwenImageConfig:
    hidden: int
    n_layers: int
    n_heads: int
    in_channels: int = 64
    context_dim: int = 3584
    axes_dim: tuple[int, ...] = (16, 56, 56)
    theta: int = 10_000

    @staticmethod
    def from_state_dict(sd) -> "QwenImageConfig":
        def shape(k):
            return tuple(sd[k].shape)

        hidden, in_ch = shape("img_in.weight")
        hd = int(shape("transformer_blocks.0.attn.norm_q.weight")[0])
        n = 0
        while f"transformer_blocks.{n}.attn.to_q.weight" in sd:
            n += 1
        third = 2 * ((hd - hd // 8) // 4)
        return QwenImageConfig(
            hidden=int(hidden), n_layers=n, n_heads=int(hidden) // hd,
            in_channels=int(in_ch),
            context_dim=int(shape("txt_in.weight")[1]),
            axes_dim=(hd - 2 * third, third, third))


def _silu(x: torch.Tensor) -> torch.Tensor:
    return F.silu(x.to(torch.float32)).to(x.dtype)


def _heads(x: torch.Tensor, n: int) -> torch.Tensor:
    B, L, D = x.shape
    return x.reshape(B, L, n, D // n).transpose(1, 2)


def _mod(p, key, vec, qcfg):
    out = linear(_silu(vec), p[f"{key}.1.weight"], p.get(f"{key}.1.bias"),
                 cfg=qcfg)
    return torch.chunk(out[:, None, :], 6, dim=-1)


def _proj(p, name, x, qcfg):
    return linear(x, p[f"attn.{name}.weight"], p.get(f"attn.{name}.bias"),
                  cfg=qcfg)


def _mlp(p, stream, x, qcfg):
    pre = f"{stream}_mlp.net."
    h = linear_gelu(x, p[pre + "0.proj.weight"], p.get(pre + "0.proj.bias"),
                    cfg=qcfg)
    return linear(h, p[pre + "2.weight"], p.get(pre + "2.bias"), cfg=qcfg)


def _block(p: dict, img, txt, vec, pe, cfg: QwenImageConfig, qcfg):
    """One MMDiT block over its UNPREFIXED param subtree ``p``."""
    H = cfg.n_heads
    i_sh1, i_sc1, i_g1, i_sh2, i_sc2, i_g2 = _mod(p, "img_mod", vec, qcfg)
    t_sh1, t_sc1, t_g1, t_sh2, t_sc2, t_g2 = _mod(p, "txt_mod", vec, qcfg)

    img_mod = layer_norm(img, eps=1e-6) * (1 + i_sc1) + i_sh1
    txt_mod = layer_norm(txt, eps=1e-6) * (1 + t_sc1) + t_sh1

    def qk(name, norm, x):
        return rms_norm(_heads(_proj(p, name, x, qcfg), H),
                        p[f"attn.{norm}.weight"], eps=1e-6)

    iq, ik = qk("to_q", "norm_q", img_mod), qk("to_k", "norm_k", img_mod)
    iv = _heads(_proj(p, "to_v", img_mod, qcfg), H)
    tq = qk("add_q_proj", "norm_added_q", txt_mod)
    tk = qk("add_k_proj", "norm_added_k", txt_mod)
    tv = _heads(_proj(p, "add_v_proj", txt_mod, qcfg), H)

    q = apply_rope(torch.cat([tq, iq], dim=2), pe)
    k = apply_rope(torch.cat([tk, ik], dim=2), pe)
    v = torch.cat([tv, iv], dim=2)
    a = dot_product_attention(q, k, v)
    B, Hn, L, D = a.shape
    a = a.transpose(1, 2).reshape(B, L, Hn * D)
    L_txt = txt.shape[1]
    txt_a, img_a = a[:, :L_txt], a[:, L_txt:]

    img = img + i_g1 * _proj(p, "to_out.0", img_a, qcfg)
    txt = txt + t_g1 * _proj(p, "to_add_out", txt_a, qcfg)

    img = img + i_g2 * _mlp(p, "img", layer_norm(img, eps=1e-6)
                            * (1 + i_sc2) + i_sh2, qcfg)
    txt = txt + t_g2 * _mlp(p, "txt", layer_norm(txt, eps=1e-6)
                            * (1 + t_sc2) + t_sh2, qcfg)
    return img, txt


def _prelude(params, cfg: QwenImageConfig, img, img_ids, txt, txt_ids,
             timesteps, qcfg):
    img = linear(img, params["img_in.weight"], params.get("img_in.bias"),
                 cfg=qcfg)
    if "txt_norm.weight" in params:
        txt = rms_norm(txt, params["txt_norm.weight"], eps=1e-6)
    txt = linear(txt, params["txt_in.weight"], params.get("txt_in.bias"),
                 cfg=qcfg).to(img.dtype)

    pre = "time_text_embed.timestep_embedder."
    vec = linear(timestep_embedding(timesteps, 256).to(img.dtype),
                 params[pre + "linear_1.weight"],
                 params.get(pre + "linear_1.bias"), cfg=qcfg)
    vec = linear(_silu(vec.to(img.dtype)), params[pre + "linear_2.weight"],
                 params.get(pre + "linear_2.bias"), cfg=qcfg)

    ids = torch.cat([txt_ids, img_ids], dim=1)
    pe = rope_freqs(ids, cfg.axes_dim, cfg.theta)
    return img, txt, vec, pe


def _head(params, img, vec, qcfg):
    mod = linear(_silu(vec.to(img.dtype)), params["norm_out.linear.weight"],
                 params.get("norm_out.linear.bias"), cfg=qcfg)
    sc, sh = torch.chunk(mod[:, None, :], 2, dim=-1)
    img = layer_norm(img, eps=1e-6) * (1 + sc) + sh
    return linear(img, params["proj_out.weight"], params.get("proj_out.bias"),
                  cfg=qcfg)


def forward(params, cfg: QwenImageConfig, img, img_ids, txt, txt_ids,
            timesteps, qcfg: QuantConfig = DEFAULT_CONFIG) -> torch.Tensor:
    """img (B, L_img, in_channels) patchified tokens, txt (B, L_txt,
    context_dim), ids (B, L, 3) RoPE positions → (B, L_img, in_channels)
    velocity tokens."""
    img, txt, vec, pe = _prelude(params, cfg, img, img_ids, txt, txt_ids,
                                 timesteps, qcfg)
    for i in range(cfg.n_layers):
        img, txt = _block(block_subtree(params, f"transformer_blocks.{i}."),
                          img, txt, vec, pe, cfg, qcfg)
    return _head(params, img, vec, qcfg)


def stack_qwen_params(params: dict, cfg: QwenImageConfig) -> dict:
    """Flat params → {non-block keys, "transformer_blocks": stacked
    subtree} (copies the block weights once; the blocks are homogeneous)."""
    return stack_block_groups(params, [("transformer_blocks", cfg.n_layers)],
                              arch="qwen-image")


def forward_stacked(sparams: dict, cfg: QwenImageConfig, img, img_ids, txt,
                    txt_ids, timesteps,
                    qcfg: QuantConfig = DEFAULT_CONFIG) -> torch.Tensor:
    """forward() over stack_qwen_params() output — identical math, one loop
    over views of the stacked blocks."""
    img, txt, vec, pe = _prelude(sparams, cfg, img, img_ids, txt, txt_ids,
                                 timesteps, qcfg)
    for i in range(cfg.n_layers):
        img, txt = _block(block_view(sparams["transformer_blocks"], i), img,
                          txt, vec, pe, cfg, qcfg)
    return _head(sparams, img, vec, qcfg)
