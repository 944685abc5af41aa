"""Plain float32 reference of the Wan 2.1 text-to-video transformer's
velocity, written from Wan-AI's published model (github.com/Wan-Video/
Wan2.1, ``wan/modules/model.py``): a (1, 2, 2) patch embedding, a
sinusoidal time embedding projected to a six-way modulation added to each
block's learned table, self-attention with full-width RMS q/k norms and
3-axis RoPE, cross-attention to the text states, a GELU-tanh FFN and a
two-way modulated head. Reads the stored GGUF blocks through
``refops.Weights``; imports nothing of the program under test.
"""

from __future__ import annotations

import torch

from refops import (apply_rope, attention, gelu_tanh, heads, layer_norm,
                    linear, rms_norm, rope_table, silu, timestep_embedding,
                    unheads)


def axes_dim(head_dim: int):
    """Wan's split of a head over (t, h, w): h = w = 2·(D // 6), t the
    rest."""
    hw = 2 * (head_dim // 6)
    return (head_dim - 2 * hw, hw, hw)


def prelude(W, c: dict, latent, ctx, t):
    """The patch embedding, text embedding, time embedding and RoPE table:
    (x, ctx, e, e0, (cos, sin))."""
    B, Fr, Hh, Ww, C = latent.shape
    pt, ph, pw = c["patch_size"]
    D, nh = c["dim"], c["num_heads"]
    f, h, w = Fr // pt, Hh // ph, Ww // pw
    # the patch embedding as a product over (c, kt, kh, kw) patches
    x = latent.reshape(B, f, pt, h, ph, w, pw, C)
    x = x.permute(0, 1, 3, 5, 7, 2, 4, 6).reshape(B, f * h * w, -1)
    x = x @ W("patch_embedding.weight").reshape(D, -1).t() \
        + W("patch_embedding.bias")
    ctx = linear(gelu_tanh(linear(ctx, W, "text_embedding.0")), W,
                 "text_embedding.2")
    e = linear(silu(linear(timestep_embedding(t), W, "time_embedding.0")),
               W, "time_embedding.2")
    e0 = linear(silu(e), W, "time_projection.1").reshape(B, 6, D)
    grid = torch.stack(torch.meshgrid(
        torch.arange(f), torch.arange(h), torch.arange(w), indexing="ij"),
        dim=-1).reshape(-1, 3).to(latent.device)
    return x, ctx, e, e0, rope_table(grid, axes_dim(D // nh))


def block(W, c: dict, i: int, x, e0, ctx, rope):
    D, nh = c["dim"], c["num_heads"]
    cos, sin = rope
    p = f"blocks.{i}."
    mod = W(p + "modulation").reshape(1, 6, D) + e0
    sh1, sc1, g1, sh2, sc2, g2 = (mod[:, j, None] for j in range(6))
    y = layer_norm(x) * (1 + sc1) + sh1
    q = rms_norm(linear(y, W, p + "self_attn.q"),
                 W(p + "self_attn.norm_q.weight"))
    k = rms_norm(linear(y, W, p + "self_attn.k"),
                 W(p + "self_attn.norm_k.weight"))
    v = linear(y, W, p + "self_attn.v")
    a = attention(apply_rope(heads(q, nh), cos, sin),
                  apply_rope(heads(k, nh), cos, sin), heads(v, nh))
    x = x + g1 * linear(unheads(a), W, p + "self_attn.o")
    y = layer_norm(x, W(p + "norm3.weight"), W(p + "norm3.bias"))
    q = rms_norm(linear(y, W, p + "cross_attn.q"),
                 W(p + "cross_attn.norm_q.weight"))
    k = rms_norm(linear(ctx, W, p + "cross_attn.k"),
                 W(p + "cross_attn.norm_k.weight"))
    v = linear(ctx, W, p + "cross_attn.v")
    a = attention(heads(q, nh), heads(k, nh), heads(v, nh))
    x = x + linear(unheads(a), W, p + "cross_attn.o")
    y = layer_norm(x) * (1 + sc2) + sh2
    return x + g2 * linear(gelu_tanh(linear(y, W, p + "ffn.0")), W,
                           p + "ffn.2")


def head(W, c: dict, x, e, shape):
    """The modulated head and the unpatchify back to ``shape`` (B, F, H,
    W, C)."""
    B, Fr, Hh, Ww, C = shape
    D = c["dim"]
    pt, ph, pw = c["patch_size"]
    f, h, w = Fr // pt, Hh // ph, Ww // pw
    hm = W("head.modulation").reshape(1, 2, D) + e[:, None]
    x = layer_norm(x) * (1 + hm[:, 1, None]) + hm[:, 0, None]
    x = linear(x, W, "head.head")
    x = x.reshape(B, f, h, w, pt, ph, pw, C).permute(0, 1, 4, 2, 5, 3, 6, 7)
    return x.reshape(B, Fr, Hh, Ww, C)


def velocity(W, c: dict, latent, ctx, t):
    """latent (B, F, H, W, C), ctx (B, Lt, text_dim), t (B,) sigma -> the
    velocity latent of the same shape, float32 throughout."""
    x, ctx, e, e0, rope = prelude(W, c, latent, ctx, t)
    for i in range(c["num_layers"]):
        x = block(W, c, i, x, e0, ctx, rope)
    return head(W, c, x, e, latent.shape)
