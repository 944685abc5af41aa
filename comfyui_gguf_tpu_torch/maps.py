"""llama.cpp → original-model key remapping tables.

These name correspondences are format facts established by the llama.cpp
conversion scripts; the reference carries the same tables at loader.py:144-191
and reverses the llama.cpp GQA head permutation at loader.py:201-211.
"""

from __future__ import annotations

import numpy as np

# llama.cpp T5 names -> HF T5 names (reference loader.py:144-159)
T5_SD_MAP = {
    "enc.": "encoder.",
    ".blk.": ".block.",
    "token_embd": "shared",
    "output_norm": "final_layer_norm",
    "attn_q": "layer.0.SelfAttention.q",
    "attn_k": "layer.0.SelfAttention.k",
    "attn_v": "layer.0.SelfAttention.v",
    "attn_o": "layer.0.SelfAttention.o",
    "attn_norm": "layer.0.layer_norm",
    "attn_rel_b": "layer.0.SelfAttention.relative_attention_bias",
    "ffn_up": "layer.1.DenseReluDense.wi_1",
    "ffn_down": "layer.1.DenseReluDense.wo",
    "ffn_gate": "layer.1.DenseReluDense.wi_0",
    "ffn_norm": "layer.1.layer_norm",
}

# llama.cpp Llama/Qwen names -> HF names (reference loader.py:161-178)
LLAMA_SD_MAP = {
    "blk.": "model.layers.",
    "attn_norm": "input_layernorm",
    "attn_q_norm.": "self_attn.q_norm.",
    "attn_k_norm.": "self_attn.k_norm.",
    "attn_v_norm.": "self_attn.v_norm.",
    "attn_q": "self_attn.q_proj",
    "attn_k": "self_attn.k_proj",
    "attn_v": "self_attn.v_proj",
    "attn_output": "self_attn.o_proj",
    "ffn_up": "mlp.up_proj",
    "ffn_down": "mlp.down_proj",
    "ffn_gate": "mlp.gate_proj",
    "ffn_norm": "post_attention_layernorm",
    "token_embd": "model.embed_tokens",
    "output_norm": "model.norm",
    "output.weight": "lm_head.weight",
}

# llama.cpp mmproj names -> Qwen2VL vision names (reference loader.py:180-191)
CLIP_VISION_SD_MAP = {
    "mm.": "visual.merger.mlp.",
    "v.post_ln.": "visual.merger.ln_q.",
    "v.patch_embd": "visual.patch_embed.proj",
    "v.blk.": "visual.blocks.",
    "ffn_up": "mlp.up_proj",
    "ffn_down": "mlp.down_proj",
    "ffn_gate": "mlp.gate_proj",
    "attn_out.": "attn.proj.",
    "ln1.": "norm1.",
    "ln2.": "norm2.",
}


def sd_map_replace(raw_sd: dict, key_map: dict[str, str]) -> dict:
    """Substring-rewrite every key (reference loader.py:193-199)."""
    out = {}
    for k, v in raw_sd.items():
        for s, d in key_map.items():
            k = k.replace(s, d)
        out[k] = v
    return out


def unpermute_gqa_rows(x: np.ndarray, n_head: int) -> np.ndarray:
    """Reverse llama.cpp's interleaved rotary-pair row layout for q/k.

    llama.cpp's convert script reorders each head's rows so rotary pairs are
    interleaved; this is its inverse (reference loader.py:201-211). Operates
    on whole rows (dim 0), so it is valid on packed quantized rows too as
    long as the row byte-stride is uniform.
    """
    h = n_head
    r = x.shape[0]
    return (
        x.reshape(h, r // h // 2, 2, *x.shape[1:])
        .swapaxes(1, 2)
        .reshape(x.shape)
    )
