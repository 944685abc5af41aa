"""CLIP text encoders (CLIP-L / CLIP-G) for diffusion conditioning (PyTorch
port of comfyui_gguf_tpu/models/clip.py).

A functional implementation over the HF ``text_model.*`` key format, with
an open_clip (``transformer.resblocks.*``) remap for bigG checkpoints.

Returns final hidden states, penultimate hidden states (the "clip skip -2"
layer SD pipelines condition on), and the projected pooled embedding.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

from ..nn.layers import (DEFAULT_CONFIG, QuantConfig, embedding, layer_norm,
                         linear, materialize)

@dataclasses.dataclass(frozen=True)
class CLIPTextConfig:
    hidden: int
    n_layers: int
    n_heads: int
    intermediate: int
    vocab_size: int = 49408
    max_positions: int = 77
    # CLIP-L (OpenAI) uses quick-gelu; CLIP-G (open_clip bigG) plain gelu
    act: str = "quick_gelu"
    eps: float = 1e-5
    # when set, pooled output reads the FIRST eos position instead of
    # argmax(ids) — required once textual-inversion tokens (ids above the
    # eos id) are appended to the vocabulary
    eos_token_id: int | None = None

    @staticmethod
    def from_state_dict(sd) -> "CLIPTextConfig":
        def shape(k):
            v = sd[k]
            return v.shape if hasattr(v, "shape") else np.asarray(v).shape

        vocab, hidden = shape("text_model.embeddings.token_embedding.weight")
        maxpos = shape("text_model.embeddings.position_embedding.weight")[0]
        inter = shape("text_model.encoder.layers.0.mlp.fc1.weight")[0]
        n = 0
        while f"text_model.encoder.layers.{n}.layer_norm1.weight" in sd:
            n += 1
        return CLIPTextConfig(
            hidden=int(hidden), n_layers=n, n_heads=int(hidden) // 64,
            intermediate=int(inter), vocab_size=int(vocab),
            max_positions=int(maxpos),
            # OpenAI towers (CLIP-L 768, and the original 1024 ViT-H
            # did not ship a text tower) use quick-gelu; open_clip towers
            # (bigG 1280, SD2's ViT-H 1024) use plain gelu. Hidden size
            # alone misclassifies open_clip ViT-H — remap_open_clip
            # callers should pass act="gelu" explicitly (see
            # config_for_open_clip); the size heuristic covers the two
            # common GGUF cases (CLIP-L / CLIP-G)
            act="gelu" if int(hidden) >= 1024 else "quick_gelu",
            eos_token_id=49407 if int(vocab) == 49408 else None,
        )


# open_clip (bigG) key names -> HF naming; in_proj splitting handled in
# remap_open_clip below
OPEN_CLIP_SD_MAP = {
    "token_embedding.weight":
        "text_model.embeddings.token_embedding.weight",
    "positional_embedding":
        "text_model.embeddings.position_embedding.weight",
    "transformer.resblocks.": "text_model.encoder.layers.",
    ".ln_1.": ".layer_norm1.",
    ".ln_2.": ".layer_norm2.",
    ".mlp.c_fc.": ".mlp.fc1.",
    ".mlp.c_proj.": ".mlp.fc2.",
    ".attn.out_proj.": ".self_attn.out_proj.",
    "ln_final.": "text_model.final_layer_norm.",
}


def config_for_open_clip(sd: dict) -> "CLIPTextConfig":
    """Config for an open_clip-provenance tower: plain GELU regardless
    of hidden size (open_clip never uses quick-gelu)."""
    return dataclasses.replace(CLIPTextConfig.from_state_dict(sd), act="gelu")


def remap_open_clip(sd: dict) -> dict:
    """open_clip text tower → HF CLIPTextModel naming (splits fused
    ``attn.in_proj`` into q/k/v)."""
    out = {}
    for k, v in sd.items():
        for s, d in OPEN_CLIP_SD_MAP.items():
            k = k.replace(s, d)
        out[k] = v
    for k in list(out):
        if ".attn.in_proj_weight" in k or ".attn.in_proj_bias" in k:
            v = out.pop(k)
            arr = v if isinstance(v, np.ndarray) else np.asarray(v)
            q, kk, vv = np.split(arr, 3, axis=0)
            leaf = "weight" if k.endswith("weight") else "bias"
            base = k.split(".attn.in_proj_")[0]
            out[f"{base}.self_attn.q_proj.{leaf}"] = q
            out[f"{base}.self_attn.k_proj.{leaf}"] = kk
            out[f"{base}.self_attn.v_proj.{leaf}"] = vv
    return out


def _act(x: torch.Tensor, kind: str) -> torch.Tensor:
    xf = x.to(torch.float32)
    if kind == "quick_gelu":
        y = xf * torch.sigmoid(1.702 * xf)
    else:
        y = F.gelu(xf)
    return y.to(x.dtype)


def _self_attn(params, prefix, x, mask, n_heads, qcfg):
    B, L, D = x.shape
    hd = D // n_heads
    scale = hd ** -0.5

    def proj(name):
        return linear(x, params[f"{prefix}.{name}.weight"],
                      params.get(f"{prefix}.{name}.bias"), cfg=qcfg)

    q = proj("q_proj").reshape(B, L, n_heads, hd).permute(0, 2, 1, 3)
    k = proj("k_proj").reshape(B, L, n_heads, hd).permute(0, 2, 1, 3)
    v = proj("v_proj").reshape(B, L, n_heads, hd).permute(0, 2, 1, 3)
    logits = torch.matmul(q.to(torch.float32),
                          k.to(torch.float32).transpose(-1, -2)) * scale
    logits = logits + mask
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    out = torch.matmul(probs.to(torch.float32),
                       v.to(torch.float32)).to(v.dtype)
    out = out.permute(0, 2, 1, 3).reshape(B, L, D)
    return linear(out, params[f"{prefix}.out_proj.weight"],
                  params.get(f"{prefix}.out_proj.bias"), cfg=qcfg)


def encode(params, cfg: CLIPTextConfig, ids: torch.Tensor,
           qcfg: QuantConfig = DEFAULT_CONFIG, dtype=torch.float32):
    """ids (B, L) → dict(last_hidden, penultimate, pooled).

    pooled = final-LN hidden at the EOT position (the first
    ``eos_token_id`` when the config sets one, else the highest token id),
    projected by ``text_projection`` when present.
    """
    B, L = ids.shape
    ids = ids.to(torch.long)
    tok = embedding(ids, params["text_model.embeddings.token_embedding.weight"],
                    cfg=qcfg)
    pos = params["text_model.embeddings.position_embedding.weight"][:L]
    x = (tok + pos[None]).to(dtype)

    causal = torch.triu(
        torch.full((L, L), torch.finfo(torch.float32).min, device=x.device),
        diagonal=1)[None, None]

    penultimate = None
    for i in range(cfg.n_layers):
        p = f"text_model.encoder.layers.{i}"
        if i == cfg.n_layers - 1:
            penultimate = x
        h = layer_norm(x, params[f"{p}.layer_norm1.weight"],
                       params.get(f"{p}.layer_norm1.bias"), eps=cfg.eps)
        x = x + _self_attn(params, f"{p}.self_attn", h, causal, cfg.n_heads,
                           qcfg)
        h = layer_norm(x, params[f"{p}.layer_norm2.weight"],
                       params.get(f"{p}.layer_norm2.bias"), eps=cfg.eps)
        h = linear(h, params[f"{p}.mlp.fc1.weight"],
                   params.get(f"{p}.mlp.fc1.bias"), cfg=qcfg)
        h = _act(h, cfg.act)
        x = x + linear(h, params[f"{p}.mlp.fc2.weight"],
                       params.get(f"{p}.mlp.fc2.bias"), cfg=qcfg)

    last = layer_norm(x, params["text_model.final_layer_norm.weight"],
                      params.get("text_model.final_layer_norm.bias"),
                      eps=cfg.eps)

    if cfg.eos_token_id is not None:
        has_eos = ids == cfg.eos_token_id
        eot = torch.argmax(has_eos.to(torch.int32), dim=-1)  # first EOS
        # no EOS at all (truncated prompt from a tokenizer that dropped
        # it): pool the LAST position, not argmax's 0 (= BOS state)
        eot = torch.where(has_eos.any(dim=-1), eot, ids.shape[-1] - 1)
    else:
        eot = torch.argmax(ids, dim=-1)  # EOT has the highest token id
    pooled = last[torch.arange(B, device=last.device), eot]
    proj = params.get("text_projection.weight",
                      params.get("text_projection"))
    if proj is not None:
        w = materialize(proj, torch.float32)
        if w.shape[0] == pooled.shape[-1] and "text_projection.weight" not in \
                params:
            pooled = pooled.to(torch.float32) @ w  # open_clip convention
        else:
            pooled = pooled.to(torch.float32) @ w.T
        pooled = pooled.to(last.dtype)
    return {"last_hidden": last, "penultimate": penultimate, "pooled": pooled}
