"""Plain references of what FLUX.1 text to image runs besides the
transformer (``flux_ref.py``), written from the published algorithms and
models:

- the two tokenizers: T5's sentencepiece unigram model (spaces as "▁" with
  a leading one, the segmentation of highest total score, "</s>" appended,
  padded with 0 to the length) and CLIP's byte-level BPE (lower case, words
  split on white space, each word's symbols merged pair by pair in
  merge-rank order with "</w>" on its last, "<|startoftext|>" and
  "<|endoftext|>" around, cut to the length keeping the last, padded with
  "<|endoftext|>");
- the T5-v1.1 encoder (Hugging Face ``T5EncoderModel``: RMS norms, the
  layer-0 relative-position bias in log buckets, unscaled attention masked
  to the prompt, a gated-GELU FFN);
- the CLIP-L text model (``CLIPTextModel``: causal attention, quick GELU,
  pooled at the first end-of-text token);
- the VAE decoder (``AutoencoderKL``'s: the latent unscaled and unshifted,
  resnets under 32-group norms, one single-head attention in the middle,
  nearest 2× upsampling).

Float32 throughout; imports nothing of the program under test.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from refops import (act, gelu_tanh, heads, layer_norm, linear, rms_norm,
                    silu, unheads)

SPACE = "▁"


def t5_ids(text: str, pieces: list[str], scores: list[float],
           length: int) -> tuple[list[int], list[int]]:
    """(ids, mask) of ``text``; ``pieces[:3]`` are <pad>, </s>, <unk>."""
    s = (" " + text).replace(" ", SPACE)
    index = {p: i for i, p in enumerate(pieces) if i >= 3
             and not p.startswith("<unused_")}
    longest = max(len(p) for p in index)
    best = [0.0] + [float("-inf")] * len(s)
    back = [None] * (len(s) + 1)
    for i in range(len(s)):
        if best[i] == float("-inf"):
            continue
        for j in range(i + 1, min(len(s), i + longest) + 1):
            t = index.get(s[i:j])
            if t is not None and best[i] + scores[t] > best[j]:
                best[j], back[j] = best[i] + scores[t], (i, t)
    ids, j = [], len(s)
    while j > 0:
        i, t = back[j]
        ids.append(t)
        j = i
    ids = ids[::-1][: length - 1] + [1]
    return (ids + [0] * (length - len(ids)),
            [1] * len(ids) + [0] * (length - len(ids)))


def clip_ids(text: str, vocab: dict, merges: list[str],
             length: int) -> list[int]:
    rank = {tuple(m.split(" ")): r for r, m in enumerate(merges)}
    ids = [vocab["<|startoftext|>"]]
    for word in text.lower().split():
        parts = list(word[:-1]) + [word[-1] + "</w>"]
        while len(parts) > 1:
            pairs = [(rank.get((a, b)), k)
                     for k, (a, b) in enumerate(zip(parts, parts[1:]))
                     if (a, b) in rank]
            if not pairs:
                break
            _, k = min(pairs)
            parts = parts[:k] + [parts[k] + parts[k + 1]] + parts[k + 2:]
        ids += [vocab[p] for p in parts]
    eot = vocab["<|endoftext|>"]
    ids = ids[: length - 1] + [eot]
    return ids + [eot] * (length - len(ids))


def _masked_attention(q, k, v, bias, scale: float = 1.0):
    """softmax(q kᵀ · scale + bias) v over (B, H, L, D)."""
    p = torch.softmax((q @ k.transpose(-1, -2)) * scale + bias, dim=-1)
    return act(p @ v)


def t5_bucket(rel, buckets: int, max_distance: int):
    """T5's bidirectional relative-position bucket of ``rel`` = key −
    query position."""
    buckets //= 2
    out = (rel > 0).long() * buckets
    n = rel.abs()
    exact = buckets // 2
    large = exact + (torch.log(n.float() / exact)
                     / math.log(max_distance / exact)
                     * (buckets - exact)).long()
    large = large.clamp(max=buckets - 1)
    return out + torch.where(n < exact, n, large)


def t5_states(W, c: dict, ids, mask):
    """ids, mask (B, L) -> the encoder's final states (B, L, d_model)."""
    L, H = ids.shape[1], c["num_heads"]
    x = W("shared.weight")[ids]
    pos = torch.arange(L, device=ids.device)
    bucket = t5_bucket(pos[None, :] - pos[:, None],
                       c["relative_attention_num_buckets"],
                       c["relative_attention_max_distance"])
    table = W("encoder.block.0.layer.0.SelfAttention.relative_attention_"
              "bias.weight")
    bias = table[bucket].permute(2, 0, 1)[None] + torch.where(
        mask[:, None, None, :] > 0, 0.0, torch.finfo(torch.float32).min)
    eps = c["layer_norm_epsilon"]
    for i in range(c["num_layers"]):
        p = f"encoder.block.{i}.layer."
        h = rms_norm(x, W(p + "0.layer_norm.weight"), eps)
        a = p + "0.SelfAttention."
        q, k, v = (heads(linear(h, W, a + m), H) for m in "qkv")
        x = x + linear(unheads(_masked_attention(q, k, v, bias)), W, a + "o")
        h = rms_norm(x, W(p + "1.layer_norm.weight"), eps)
        f = p + "1.DenseReluDense."
        x = x + linear(gelu_tanh(linear(h, W, f + "wi_0"))
                       * linear(h, W, f + "wi_1"), W, f + "wo")
    return rms_norm(x, W("encoder.final_layer_norm.weight"), eps)


def clip_pooled(W, c: dict, ids):
    """ids (B, 77) -> the final-norm state at each prompt's first
    end-of-text token (the highest id), (B, hidden)."""
    B, L = ids.shape
    H, eps = c["num_attention_heads"], c["layer_norm_eps"]
    e = "text_model.embeddings."
    x = W(e + "token_embedding.weight")[ids] \
        + W(e + "position_embedding.weight")[:L]
    causal = torch.triu(torch.full((L, L), torch.finfo(torch.float32).min,
                                   device=ids.device), diagonal=1)
    scale = 1.0 / math.sqrt(c["hidden_size"] // H)

    def norm(x, name):
        return layer_norm(x, W(name + ".weight"), W(name + ".bias"), eps)

    for i in range(c["num_hidden_layers"]):
        p = f"text_model.encoder.layers.{i}."
        h = norm(x, p + "layer_norm1")
        q, k, v = (heads(linear(h, W, p + f"self_attn.{m}_proj"), H)
                   for m in "qkv")
        x = x + linear(unheads(_masked_attention(q, k, v, causal, scale)), W,
                       p + "self_attn.out_proj")
        h = linear(norm(x, p + "layer_norm2"), W, p + "mlp.fc1")
        h = act(h * torch.sigmoid(1.702 * h))
        x = x + linear(h, W, p + "mlp.fc2")
    last = norm(x, "text_model.final_layer_norm")
    eot = torch.argmax((ids == ids.max(dim=-1, keepdim=True).values).int(),
                       dim=-1)
    return last[torch.arange(B, device=ids.device), eot]


def _conv(W, name, x, pad: int = 1):
    return act(F.conv2d(x, W(name + ".weight"), W(name + ".bias"),
                        padding=pad))


def _group_norm(W, name, x):
    return act(F.group_norm(x, 32, W(name + ".weight"), W(name + ".bias"),
                            1e-6))


def _resnet(W, name, x):
    h = _conv(W, name + ".conv1", silu(_group_norm(W, name + ".norm1", x)))
    h = _conv(W, name + ".conv2", silu(_group_norm(W, name + ".norm2", h)))
    if name + ".nin_shortcut.weight" in W.raw:
        x = _conv(W, name + ".nin_shortcut", x, 0)
    return x + h


def _mid_attention(W, name, x):
    B, C, Hh, Ww = x.shape
    h = _group_norm(W, name + ".norm", x)
    q, k, v = (_conv(W, f"{name}.{m}", h, 0).reshape(B, 1, C, Hh * Ww)
               .transpose(-1, -2) for m in "qkv")
    a = _masked_attention(q, k, v, 0.0, 1.0 / math.sqrt(C))
    return x + _conv(W, name + ".proj_out",
                     a.transpose(-1, -2).reshape(B, C, Hh, Ww), 0)


def vae_decode(W, c: dict, z):
    """Latent (B, h, w, C) -> image (B, 8h, 8w, 3), unclamped."""
    x = z.permute(0, 3, 1, 2) / c["scaling_factor"] + c["shift_factor"]
    x = _conv(W, "decoder.conv_in", x)
    x = _resnet(W, "decoder.mid.block_1", x)
    x = _mid_attention(W, "decoder.mid.attn_1", x)
    x = _resnet(W, "decoder.mid.block_2", x)
    for i in reversed(range(len(c["block_out_channels"]))):
        for j in range(c["layers_per_block"] + 1):
            x = _resnet(W, f"decoder.up.{i}.block.{j}", x)
        if i > 0:
            x = F.interpolate(x, scale_factor=2.0, mode="nearest")
            x = _conv(W, f"decoder.up.{i}.upsample.conv", x)
    x = silu(_group_norm(W, "decoder.norm_out", x))
    return _conv(W, "decoder.conv_out", x).permute(0, 2, 3, 1)
