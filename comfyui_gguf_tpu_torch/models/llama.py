"""Llama-family text encoders, the llama / qwen3 / qwen3vl archs (PyTorch
port of comfyui_gguf_tpu/models/llama.py).

The forward graph over the HF-style keys the loader remaps llama.cpp's
names to (``maps.LLAMA_SD_MAP``; the loader also undoes llama.cpp's GQA row
permutation of a "llama" file): RMSNorm, rotate-half rotary embeddings
(with Qwen-VL's M-RoPE split over 3-D position ids), grouped-query
attention, optional per-head q/k RMS norms (Qwen3) and the SwiGLU MLP.
Every linear goes through ``nn.layers.linear``, so through the fused
kernels on a packed tree. The attention is written out in torch ops, as
the reference writes it in einsums (it is no Pallas call): a causal mask
plus the pad mask added to f32 logits.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

from ..nn.layers import (DEFAULT_CONFIG, QuantConfig, embedding, linear,
                         rms_norm)


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    hidden: int
    n_layers: int
    n_heads: int
    n_kv_heads: int
    intermediate: int
    vocab_size: int
    head_dim: int
    rope_theta: float = 500_000.0
    eps: float = 1e-5
    qk_norm: bool = False  # qwen3
    # Qwen-VL multimodal rope: rotary half-dims split over the (temporal,
    # height, width) position streams — (16, 24, 24) at head_dim 128. Only
    # read when encode() receives 3-D position_ids.
    mrope_section: tuple | None = None

    @staticmethod
    def from_state_dict(sd, n_heads: int = 32,
                        rope_theta: float = 500_000.0) -> "LlamaConfig":
        """Dims from the weights. ``n_heads`` is not in the shapes: the
        default 32 is the loader's GQA un-permute assumption."""
        def shape(k):
            return tuple(sd[k].shape)

        vocab, hidden = shape("model.embed_tokens.weight")
        q_out = shape("model.layers.0.self_attn.q_proj.weight")[0]
        kv_out = shape("model.layers.0.self_attn.k_proj.weight")[0]
        inter = shape("model.layers.0.mlp.gate_proj.weight")[0]
        n = 0
        while f"model.layers.{n}.input_layernorm.weight" in sd:
            n += 1
        head_dim = q_out // n_heads
        return LlamaConfig(
            hidden=int(hidden), n_layers=n, n_heads=n_heads,
            n_kv_heads=int(kv_out) // head_dim, intermediate=int(inter),
            vocab_size=int(vocab), head_dim=head_dim, rope_theta=rope_theta,
            qk_norm="model.layers.0.self_attn.q_norm.weight" in sd)


def _rope(x: torch.Tensor, pos: torch.Tensor, theta: float,
          mrope_section=None) -> torch.Tensor:
    """x (B, H, L, D), rotate-half rotary embedding (the HF Llama form).

    ``pos`` (B, L) is standard rope; (3, B, L) is Qwen-VL M-RoPE: rotary
    half-dim j takes its position from stream
    ``repeat([t, h, w], mrope_section)[j]``."""
    B, H, L, D = x.shape
    inv = 1.0 / (theta ** (torch.arange(0, D, 2, dtype=torch.float32,
                                        device=x.device) / D))
    pos = pos.to(device=x.device, dtype=torch.float32)
    if pos.dim() == 3:  # (3, B, L) multimodal position streams
        if mrope_section is None:
            # Qwen-VL's 2:3:3 over the D/2 rotary half-dims
            hw = (D // 2) * 3 // 8
            mrope_section = (D // 2 - 2 * hw, hw, hw)
        sec = np.asarray(mrope_section)
        if int(sec.sum()) != D // 2:
            raise ValueError(f"mrope_section {tuple(sec)} does not split "
                             f"{D // 2} rotary half-dims")
        stream = torch.as_tensor(np.repeat(np.arange(3), sec),
                                 device=x.device)
        # ang[b, l, j] = pos[stream[j], b, l] · inv[j]
        ang = (pos[stream].permute(1, 2, 0)[:, None]
               * inv[None, None, None])
    else:
        ang = pos[:, None, :, None] * inv[None, None, None]
    cos, sin = torch.cos(ang), torch.sin(ang)
    xf = x.to(torch.float32)
    x1, x2 = xf[..., : D // 2], xf[..., D // 2:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def _attn(params, p: str, x, mask, pos, cfg: LlamaConfig, qcfg):
    B, L, _ = x.shape
    H, KV, D = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim

    def proj(name, n):
        y = linear(x, params[f"{p}.{name}.weight"],
                   params.get(f"{p}.{name}.bias"), cfg=qcfg)
        return y.reshape(B, L, n, D).transpose(1, 2)

    q, k, v = proj("q_proj", H), proj("k_proj", KV), proj("v_proj", KV)
    if cfg.qk_norm:
        q = rms_norm(q, params[f"{p}.q_norm.weight"], eps=cfg.eps)
        k = rms_norm(k, params[f"{p}.k_norm.weight"], eps=cfg.eps)
    q = _rope(q, pos, cfg.rope_theta, cfg.mrope_section)
    k = _rope(k, pos, cfg.rope_theta, cfg.mrope_section)
    if KV != H:
        k = k.repeat_interleave(H // KV, dim=1)
        v = v.repeat_interleave(H // KV, dim=1)
    logits = torch.matmul(q.to(torch.float32),
                          k.to(torch.float32).transpose(-1, -2)) * D ** -0.5
    probs = torch.softmax(logits + mask, dim=-1).to(v.dtype)
    out = torch.matmul(probs, v)
    out = out.transpose(1, 2).reshape(B, L, H * D)
    return linear(out, params[f"{p}.o_proj.weight"],
                  params.get(f"{p}.o_proj.bias"), cfg=qcfg)


def encode(params, cfg: LlamaConfig, ids: torch.Tensor, mask=None,
           qcfg: QuantConfig = DEFAULT_CONFIG, dtype=torch.bfloat16,
           return_layers: tuple[int, ...] = (),
           inputs_embeds: torch.Tensor | None = None,
           position_ids: torch.Tensor | None = None) -> dict:
    """ids (B, L) → {"last_hidden": (B, L, hidden), "layers": {i: the
    hidden state entering layer i}} for each i in ``return_layers``.

    ``mask`` (B, L), 1 for real tokens, masks pad keys. ``inputs_embeds``
    (B, L, hidden) replaces the token embedding (Qwen-VL splices vision
    embeddings in); ``position_ids`` is (B, L), or (3, B, L) for Qwen-VL's
    M-RoPE streams."""
    B, L = ids.shape
    dev = ids.device
    if inputs_embeds is not None:
        x = inputs_embeds.to(dtype)
    else:
        x = embedding(ids, params["model.embed_tokens.weight"],
                      cfg=qcfg).to(dtype)
    if position_ids is not None:
        pos = position_ids
    else:
        pos = torch.arange(L, device=dev)[None].expand(B, L)

    neg = torch.finfo(torch.float32).min
    causal = torch.triu(torch.full((L, L), neg, device=dev),
                        diagonal=1)[None, None]
    if mask is not None:
        causal = causal + torch.where(
            mask.to(dev)[:, None, None, :] > 0, 0.0, neg)

    grabbed = {}
    for i in range(cfg.n_layers):
        if i in return_layers:
            grabbed[i] = x
        p = f"model.layers.{i}"
        h = rms_norm(x, params[f"{p}.input_layernorm.weight"], eps=cfg.eps)
        x = x + _attn(params, f"{p}.self_attn", h, causal, pos, cfg, qcfg)
        h = rms_norm(x, params[f"{p}.post_attention_layernorm.weight"],
                     eps=cfg.eps)
        gate = linear(h, params[f"{p}.mlp.gate_proj.weight"], cfg=qcfg)
        up = linear(h, params[f"{p}.mlp.up_proj.weight"], cfg=qcfg)
        act = F.silu(gate.to(torch.float32)).to(dtype) * up
        x = x + linear(act, params[f"{p}.mlp.down_proj.weight"], cfg=qcfg)

    last = rms_norm(x, params["model.norm.weight"], eps=cfg.eps)
    return {"last_hidden": last, "layers": grabbed}
