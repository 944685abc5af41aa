"""Plain float32 reference of the FLUX.1 transformer's velocity, written
from Black Forest Labs' published model (github.com/black-forest-labs/flux,
``flux/model.py`` and ``flux/modules/layers.py``): double-stream blocks
with joint text + image attention, single-stream blocks with the fused
qkv + MLP projection, adaLN modulation from the timestep, guidance and
pooled-text vector, 3-axis RoPE and QK-RMSNorm. Reads the stored GGUF
blocks through ``refops.Weights``; imports nothing of the program under
test.
"""

from __future__ import annotations

import torch

from refops import (apply_rope, attention, gelu_tanh, layer_norm, linear,
                    rms_norm, rope_table, silu, timestep_embedding, unheads)


def _mlp_embed(W, name, x):
    h = linear(x, W, f"{name}.in_layer")
    return linear(silu(h), W, f"{name}.out_layer")


def _mod(W, name, vec, n):
    out = linear(silu(vec), W, f"{name}.lin")
    return out[:, None, :].chunk(n, dim=-1)


def _qk(W, name, q, k):
    return (rms_norm(q, W(f"{name}.query_norm.scale")),
            rms_norm(k, W(f"{name}.key_norm.scale")))


def _split_qkv(x, n):
    B, L, _ = x.shape
    q, k, v = x.reshape(B, L, 3, n, -1).permute(2, 0, 3, 1, 4)
    return q, k, v


def prelude(W, c: dict, img, img_ids, txt, t, y, guidance):
    """Input embeddings, the conditioning vector and the RoPE table:
    (img, txt, vec, (cos, sin))."""
    img = linear(img, W, "img_in")
    txt = linear(txt, W, "txt_in")
    vec = _mlp_embed(W, "time_in", timestep_embedding(t))
    vec = vec + _mlp_embed(W, "guidance_in", timestep_embedding(guidance))
    vec = vec + _mlp_embed(W, "vector_in", y)
    Lt = txt.shape[1]
    pos = torch.cat([torch.zeros((Lt, 3), device=img_ids.device,
                                 dtype=img_ids.dtype), img_ids])
    return img, txt, vec, rope_table(pos, c["axes_dims_rope"])


def _attn(q, k, v, rope):
    cos, sin = rope
    return unheads(attention(apply_rope(q, cos, sin),
                             apply_rope(k, cos, sin), v))


def double_block(W, c: dict, i: int, img, txt, vec, rope):
    H = c["num_attention_heads"]
    p = f"double_blocks.{i}."
    Lt = txt.shape[1]
    im = _mod(W, p + "img_mod", vec, 6)
    tm = _mod(W, p + "txt_mod", vec, 6)
    ih = layer_norm(img) * (1 + im[1]) + im[0]
    th = layer_norm(txt) * (1 + tm[1]) + tm[0]
    iq, ik, iv = _split_qkv(linear(ih, W, p + "img_attn.qkv"), H)
    tq, tk, tv = _split_qkv(linear(th, W, p + "txt_attn.qkv"), H)
    iq, ik = _qk(W, p + "img_attn.norm", iq, ik)
    tq, tk = _qk(W, p + "txt_attn.norm", tq, tk)
    a = _attn(torch.cat([tq, iq], 2), torch.cat([tk, ik], 2),
              torch.cat([tv, iv], 2), rope)
    ta, ia = a[:, :Lt], a[:, Lt:]
    img = img + im[2] * linear(ia, W, p + "img_attn.proj")
    h = layer_norm(img) * (1 + im[4]) + im[3]
    img = img + im[5] * linear(gelu_tanh(linear(h, W, p + "img_mlp.0")), W,
                               p + "img_mlp.2")
    txt = txt + tm[2] * linear(ta, W, p + "txt_attn.proj")
    h = layer_norm(txt) * (1 + tm[4]) + tm[3]
    txt = txt + tm[5] * linear(gelu_tanh(linear(h, W, p + "txt_mlp.0")), W,
                               p + "txt_mlp.2")
    return img, txt


def single_block(W, c: dict, i: int, x, vec, rope):
    H, hid = c["num_attention_heads"], c["hidden"]
    p = f"single_blocks.{i}."
    shift, scale, gate = _mod(W, p + "modulation", vec, 3)
    h = linear(layer_norm(x) * (1 + scale) + shift, W, p + "linear1")
    q, k, v = _split_qkv(h[..., :3 * hid], H)
    q, k = _qk(W, p + "norm", q, k)
    out = linear(torch.cat([_attn(q, k, v, rope),
                            gelu_tanh(h[..., 3 * hid:])], dim=-1), W,
                 p + "linear2")
    return x + gate * out


def final(W, c: dict, img, vec):
    shift, scale = linear(silu(vec), W,
                          "final_layer.adaLN_modulation.1")[:, None].chunk(
                              2, dim=-1)
    return linear(layer_norm(img) * (1 + scale) + shift, W,
                  "final_layer.linear")


def velocity(W, c: dict, img, img_ids, txt, t, y, guidance):
    """img (B, L, C·4) patch tokens, img_ids (L, 3) their (0, row, col)
    positions, txt (B, Lt, context), t (B,) sigma, y (B, vec), guidance
    (B,) -> the velocity tokens (B, L, C·4), float32 throughout."""
    img, txt, vec, rope = prelude(W, c, img, img_ids, txt, t, y, guidance)
    for i in range(c["num_layers"]):
        img, txt = double_block(W, c, i, img, txt, vec, rope)
    x = torch.cat([txt, img], dim=1)
    for i in range(c["num_single_layers"]):
        x = single_block(W, c, i, x, vec, rope)
    return final(W, c, x[:, txt.shape[1]:], vec)
