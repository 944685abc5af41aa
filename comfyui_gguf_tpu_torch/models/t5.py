"""T5 / UMT5 text encoder (PyTorch port of comfyui_gguf_tpu/models/t5.py).

A functional implementation over the flat remapped state dict, with every
matmul routed through the quant-aware ``nn.linear`` so packed weights hit
the fused kernel (K2 for a Q8_0 file).

Graph semantics follow the public T5 architecture (t5-v1_1: RMSNorm,
gated-GELU FFN, relative-position-bucket attention bias, no attention
scaling). UMT5's per-layer relative bias is auto-detected from the keys.
The attention is written out, as in the reference (f32 logits, additive
bias, f32 softmax): it is not one of the reference's hand-written kernels.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
import torch.nn.functional as F

from ..nn.layers import (DEFAULT_CONFIG, QuantConfig, embedding, linear,
                         rms_norm)


@dataclasses.dataclass(frozen=True)
class T5Config:
    d_model: int
    d_ff: int
    n_layers: int
    n_heads: int
    d_kv: int
    vocab_size: int
    rel_buckets: int = 32
    rel_max_distance: int = 128
    eps: float = 1e-6

    @staticmethod
    def from_gguf_fields(reader) -> "T5Config":
        """Build from llama.cpp ``t5.*`` / ``t5encoder.*`` metadata keys."""
        arch = reader.get_str("general.architecture") or "t5"

        def g(suffix):
            return reader.get_int(f"{arch}.{suffix}")

        return T5Config(
            d_model=g("embedding_length"),
            d_ff=g("feed_forward_length"),
            n_layers=g("block_count"),
            n_heads=g("attention.head_count"),
            d_kv=g("attention.key_length") or
            (g("embedding_length") // g("attention.head_count")),
            vocab_size=g("vocab_size") or 32128,
            rel_buckets=g("attention.relative_buckets_count") or 32,
        )

    @staticmethod
    def from_state_dict(sd) -> "T5Config":
        """Infer dims from weight shapes (works on any loaded dict)."""
        def shape(k):
            v = sd[k]
            return v.shape if hasattr(v, "shape") else np.asarray(v).shape

        vocab, d_model = shape("shared.weight")
        d_ff = shape("encoder.block.0.layer.1.DenseReluDense.wi_0.weight")[0]
        n_layers = 0
        while f"encoder.block.{n_layers}.layer.0.layer_norm.weight" in sd:
            n_layers += 1
        rel = shape(
            "encoder.block.0.layer.0.SelfAttention.relative_attention_bias.weight"
        )
        n_heads = rel[1] if len(rel) == 2 else rel[-1]
        q_out = shape("encoder.block.0.layer.0.SelfAttention.q.weight")[0]
        return T5Config(
            d_model=int(d_model), d_ff=int(d_ff), n_layers=int(n_layers),
            n_heads=int(n_heads), d_kv=int(q_out) // int(n_heads),
            vocab_size=int(vocab), rel_buckets=int(rel[0]),
        )


def relative_position_bucket(rel_pos: torch.Tensor, num_buckets: int = 32,
                             max_distance: int = 128) -> torch.Tensor:
    """T5's bidirectional log-bucketed relative position (public
    algorithm)."""
    num_buckets //= 2
    ret = torch.where(rel_pos > 0, num_buckets, 0)
    n = rel_pos.abs()
    max_exact = num_buckets // 2
    is_small = n < max_exact
    val_large = max_exact + (
        torch.log(n.to(torch.float32) / max_exact + 1e-6)
        / math.log(max_distance / max_exact)
        * (num_buckets - max_exact)
    ).to(torch.int32)
    val_large = torch.clamp(val_large, max=num_buckets - 1)
    return ret + torch.where(is_small, n, val_large)


def _rel_bias(params, cfg: T5Config, seq_len: int, layer: int,
              qcfg: QuantConfig, device) -> torch.Tensor:
    """(1, H, L, L) additive attention bias from the relative-bias table."""
    key = (f"encoder.block.{layer}.layer.0.SelfAttention."
           "relative_attention_bias.weight")
    if key not in params:  # vanilla T5: layer-0 table shared by all layers
        key = ("encoder.block.0.layer.0.SelfAttention."
               "relative_attention_bias.weight")
    table = params[key]  # (rel_buckets, n_heads)
    pos = torch.arange(seq_len, device=device)
    buckets = relative_position_bucket(
        pos[None, :] - pos[:, None], cfg.rel_buckets, cfg.rel_max_distance
    )  # (L, L)
    bias = embedding(buckets, table, cfg=qcfg)  # (L, L, H)
    return bias.permute(2, 0, 1)[None].to(torch.float32)


def _attention(params, cfg: T5Config, x: torch.Tensor, bias: torch.Tensor,
               mask, layer: int, qcfg: QuantConfig) -> torch.Tensor:
    pre = f"encoder.block.{layer}.layer.0.SelfAttention."
    B, L, _ = x.shape
    H, Dk = cfg.n_heads, cfg.d_kv

    q = linear(x, params[pre + "q.weight"], cfg=qcfg)
    k = linear(x, params[pre + "k.weight"], cfg=qcfg)
    v = linear(x, params[pre + "v.weight"], cfg=qcfg)
    q = q.reshape(B, L, H, Dk).permute(0, 2, 1, 3)
    k = k.reshape(B, L, H, Dk).permute(0, 2, 1, 3)
    v = v.reshape(B, L, H, Dk).permute(0, 2, 1, 3)

    # T5 applies no 1/sqrt(d) scaling — the bias absorbs the scale
    logits = torch.matmul(q.to(torch.float32),
                          k.to(torch.float32).transpose(-1, -2))
    logits = logits + bias
    if mask is not None:
        neg = torch.finfo(torch.float32).min
        keep = mask[:, None, None, :] > 0
        logits = logits + torch.where(keep, 0.0, neg)
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    out = torch.matmul(probs.to(torch.float32),
                       v.to(torch.float32)).to(v.dtype)
    out = out.permute(0, 2, 1, 3).reshape(B, L, H * Dk)
    return linear(out, params[pre + "o.weight"], cfg=qcfg)


def _ffn(params, cfg: T5Config, x: torch.Tensor, layer: int,
         qcfg: QuantConfig) -> torch.Tensor:
    pre = f"encoder.block.{layer}.layer.1.DenseReluDense."
    gate = linear(x, params[pre + "wi_0.weight"], cfg=qcfg)
    up = linear(x, params[pre + "wi_1.weight"], cfg=qcfg)
    h = F.gelu(gate.to(torch.float32), approximate="tanh").to(up.dtype) * up
    return linear(h, params[pre + "wo.weight"], cfg=qcfg)


def encode(params, cfg: T5Config, ids: torch.Tensor, mask=None,
           qcfg: QuantConfig = DEFAULT_CONFIG,
           dtype=torch.bfloat16) -> torch.Tensor:
    """Token ids (B, L) → final hidden states (B, L, d_model)."""
    x = embedding(ids, params["shared.weight"], cfg=qcfg).to(dtype)
    L = ids.shape[1]
    shared_bias = None
    for i in range(cfg.n_layers):
        per_layer = (f"encoder.block.{i}.layer.0.SelfAttention."
                     "relative_attention_bias.weight") in params
        if per_layer or shared_bias is None:
            bias = _rel_bias(params, cfg, L, i, qcfg, x.device)
            if not per_layer:
                shared_bias = bias
        else:
            bias = shared_bias
        pre = f"encoder.block.{i}."
        h = rms_norm(x, params[pre + "layer.0.layer_norm.weight"], eps=cfg.eps)
        x = x + _attention(params, cfg, h, bias, mask, i, qcfg)
        h = rms_norm(x, params[pre + "layer.1.layer_norm.weight"], eps=cfg.eps)
        x = x + _ffn(params, cfg, h, i, qcfg)
    return rms_norm(x, params["encoder.final_layer_norm.weight"], eps=cfg.eps)
