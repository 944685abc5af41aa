"""HiDream-I1 DiT, arch "hidream" (PyTorch port of
comfyui_gguf_tpu/models/hidream.py).

An MMDiT with mixture-of-experts FFNs: a per-block ``adaLN_modulation``
whose chunk count comes from its shape (12 on double blocks, 6 per stream;
6 on single blocks), image attention ``attn1.to_q/k/v/out`` with the text
stream's ``*_t`` twins and per-head RMS qk-norms (joint attention over
[image, text] through ``dot_product_attention``, K7 on the card), and the
MoE FFN on the image stream: a shared SwiGLU expert plus routed experts
weighted by the global softmax of an f32 router (``ff_i.gate``, a
high-precision key), top-k kept and not renormalized.

``moe_ffn`` dispatches by ``MOE_DISPATCH``: "dense" runs every expert on
every token, mask-weighted (exact); "capacity" gathers each expert's routed
tokens up to a capacity and scatter-adds their outputs (equal to dense
where no expert overflows); "ep" splits the experts over ``EP_AXIS`` of
``EP_MESH`` (``parallel/ep.py``).

``forward_stacked`` runs both block kinds as Python loops over views of the
stacked weights (``flux.block_view``), the experts leaf-stacked as
(depth, E, …) and sliced per expert without a copy.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

from ..nn.attention import dot_product_attention
from ..nn.layers import (DEFAULT_CONFIG, QuantConfig, layer_norm, linear,
                         rms_norm)
from .flux import (_stack_leaves, apply_rope, block_view, rope_freqs,
                   stack_block_groups, timestep_embedding)


@dataclasses.dataclass(frozen=True)
class HiDreamConfig:
    hidden: int
    n_heads: int
    depth_double: int
    depth_single: int
    n_experts: int
    top_k: int = 2
    patch_size: int = 2
    in_channels: int = 16
    # 3-axis RoPE over (frame, row, col) ids: (64, 32, 32) at head dim 128
    axes_dim: tuple = (64, 32, 32)
    theta: int = 10_000

    @staticmethod
    def from_state_dict(sd) -> "HiDreamConfig":
        def shape(k):
            return tuple(sd[k].shape)

        hd = int(shape(
            "double_stream_blocks.0.block.attn1.q_rms_norm.weight")[0])
        hidden = int(shape(
            "double_stream_blocks.0.block.attn1.to_q.weight")[0])

        def count(fmt):
            n = 0
            while fmt.format(n) in sd:
                n += 1
            return n

        return HiDreamConfig(
            hidden=hidden, n_heads=hidden // hd,
            depth_double=count("double_stream_blocks.{}.block.attn1.to_q"
                               ".weight"),
            depth_single=count("single_stream_blocks.{}.block.attn1.to_q"
                               ".weight"),
            n_experts=count("double_stream_blocks.0.block.ff_i.experts.{}"
                            ".w1.weight"),
            axes_dim=(hd // 2, hd // 4, hd // 4))


MOE_DISPATCH = "dense"  # "dense" (exact) | "capacity" (top-k gathers)
MOE_CAPACITY_FACTOR = 1.5
# HiDream's MoEGate (DeepSeek lineage) keeps the GLOBAL softmax scores of
# the top-k experts un-renormalized (norm_topk_prob=False): the weights of
# a 4-expert top-2 routing sum to < 1. Flip for models that renormalize.
MOE_RENORM_PROBS = False

# "ep": expert-parallel dispatch over EP_AXIS of EP_MESH (each rank runs
# its E/n experts of the stacked tree, one all-reduce combines them;
# parallel/ep.py). Without a mesh or a stacked expert tree "ep" runs dense.
EP_MESH = None
EP_AXIS = "ep"


def _silu(x: torch.Tensor) -> torch.Tensor:
    return F.silu(x.to(torch.float32)).to(x.dtype)


def _heads(x: torch.Tensor, n: int) -> torch.Tensor:
    B, L, D = x.shape
    return x.reshape(B, L, n, D // n).transpose(1, 2)


def _swiglu_w(w: dict, x, qcfg):
    """SwiGLU over weights {"w1", "w2", "w3"}."""
    a = linear(x, w["w1"], cfg=qcfg)
    b = linear(x, w["w3"], cfg=qcfg)
    return linear(_silu(a) * b, w["w2"], cfg=qcfg)


def _swiglu(params, p, x, qcfg):
    return _swiglu_w({w: params[f"{p}.{w}.weight"] for w in ("w1", "w2",
                                                             "w3")}, x, qcfg)


def stack_moe_experts(params: dict, n_experts: int) -> dict:
    """Flat per-expert keys ``{p}.experts.{e}.w{1,2,3}.weight`` → one
    stacked subtree ``{p}.experts_stacked`` = {"w1": (E, …), …} per MoE;
    the per-expert keys are dropped."""
    prefixes = sorted({k.split(".experts.")[0] for k in params
                       if ".experts." in k})
    out = {k: v for k, v in params.items() if ".experts." not in k}
    for p in prefixes:
        out[f"{p}.experts_stacked"] = {
            w: _stack_leaves([params[f"{p}.experts.{e}.{w}.weight"]
                              for e in range(n_experts)])
            for w in ("w1", "w2", "w3")}
    return out


def _routing_probs(params, p, x, n_experts, top_k, qcfg):
    """(T…, E) routing weights in ``x``'s dtype (zero off the top k) and
    k."""
    logits = linear(x, params[f"{p}.gate.weight"], cfg=qcfg).to(
        torch.float32)
    k = min(top_k, n_experts)
    thresh = torch.topk(logits, k, dim=-1).values[..., -1:]
    if MOE_RENORM_PROBS:
        masked = torch.where(logits >= thresh, logits, float("-inf"))
        return torch.softmax(masked, dim=-1).to(x.dtype), k
    probs = torch.softmax(logits, dim=-1)
    probs = torch.where(logits >= thresh, probs, 0.0)
    return probs.to(x.dtype), k


def capacity(T: int, k: int, n_experts: int) -> int:
    """Tokens each expert takes in "capacity" dispatch: ⌈cf·T·k/E⌉ rounded
    up to a multiple of 8, at most T."""
    C = -(-int(MOE_CAPACITY_FACTOR * T * k) // n_experts)
    return min(-(-C // 8) * 8, T)


def moe_ffn(params, p, x, n_experts, top_k, qcfg):
    """The shared expert plus the softmax-top-k routed experts.

    "dense" computes every expert on every token and weights each by its
    routing probability (zero off the top k): exact, E/k times the routed
    FLOPs. "capacity" gathers each expert's routed tokens (routed first, in
    a stable order) up to ``capacity`` and scatter-adds their weighted
    outputs in f32 (exact: an expert's indices are unique); equal to dense
    where no expert overflows, else the overflowing tokens lose that
    expert (the Switch/GShard drop)."""
    out = _swiglu(params, f"{p}.shared_experts", x, qcfg)
    if n_experts == 0:
        return out
    probs, k = _routing_probs(params, p, x, n_experts, top_k, qcfg)
    stacked = params.get(f"{p}.experts_stacked")
    if (stacked is not None and MOE_DISPATCH == "ep"
            and EP_MESH is not None):
        # the rank's experts and one all-reduce: exact against dense (the
        # masked probabilities are zero off the top k)
        from ..parallel.ep import ep_moe_inline

        return out + ep_moe_inline(lambda w, xx: _swiglu_w(w, xx, qcfg),
                                   stacked, x, probs, EP_MESH, EP_AXIS)

    def expert(e, xx):
        if stacked is not None:
            return _swiglu_w({w: leaf[e] for w, leaf in stacked.items()}, xx,
                             qcfg)
        return _swiglu(params, f"{p}.experts.{e}", xx, qcfg)

    if MOE_DISPATCH != "capacity":
        for e in range(n_experts):
            out = out + probs[..., e: e + 1] * expert(e, x)
        return out

    B, L, D = x.shape
    T = B * L
    C = capacity(T, k, n_experts)
    x2, p2 = x.reshape(T, D), probs.reshape(T, n_experts)
    acc = torch.zeros((T, D), dtype=torch.float32, device=x.device)
    for e in range(n_experts):
        routed = p2[:, e] > 0
        idx = torch.argsort((~routed).to(torch.uint8), stable=True)[:C]
        ye = expert(e, x2[idx][None])[0]
        w = (p2[idx, e] * routed[idx].to(p2.dtype))[:, None]
        acc.index_add_(0, idx, (ye * w).to(torch.float32))
    return out + acc.reshape(B, L, D).to(out.dtype)


def _adaln(params, p, vec, qcfg, dim):
    mod = linear(_silu(vec), params[f"{p}.adaLN_modulation.1.weight"],
                 params.get(f"{p}.adaLN_modulation.1.bias"), cfg=qcfg)
    return torch.chunk(mod[:, None, :], mod.shape[-1] // dim, dim=-1)


def _attn_joint(params, p, img_mod, txt_mod, H, qcfg, pe=None):
    """Joint attention over [image, text] (image alone on single blocks)
    → (B, L, H·D)."""
    def proj(name, x):
        return _heads(linear(x, params[f"{p}.attn1.{name}.weight"],
                             params.get(f"{p}.attn1.{name}.bias"),
                             cfg=qcfg), H)

    def norm(name, t):
        return rms_norm(t, params[f"{p}.attn1.{name}.weight"], eps=1e-6)

    q = norm("q_rms_norm", proj("to_q", img_mod))
    k = norm("k_rms_norm", proj("to_k", img_mod))
    v = proj("to_v", img_mod)
    if txt_mod is not None:
        q = torch.cat([q, norm("q_rms_norm_t", proj("to_q_t", txt_mod))],
                      dim=2)
        k = torch.cat([k, norm("k_rms_norm_t", proj("to_k_t", txt_mod))],
                      dim=2)
        v = torch.cat([v, proj("to_v_t", txt_mod)], dim=2)
    if pe is not None:
        q, k = apply_rope(q, pe), apply_rope(k, pe)
    a = dot_product_attention(q, k, v)
    B, Hn, L, D = a.shape
    return a.transpose(1, 2).reshape(B, L, Hn * D)


def _out(params, p, name, a, qcfg):
    return linear(a, params[f"{p}.attn1.{name}.weight"],
                  params.get(f"{p}.attn1.{name}.bias"), cfg=qcfg)


def _double_block(params, p, img, txt, vec, cfg: HiDreamConfig, qcfg,
                  pe=None):
    """One double-stream block over ``params``' keys under ``p``."""
    (i_sh1, i_sc1, i_g1, i_sh2, i_sc2, i_g2,
     t_sh1, t_sc1, t_g1, t_sh2, t_sc2, t_g2) = _adaln(params, p, vec, qcfg,
                                                      cfg.hidden)[:12]
    img_mod = layer_norm(img, eps=1e-6) * (1 + i_sc1) + i_sh1
    txt_mod = layer_norm(txt, eps=1e-6) * (1 + t_sc1) + t_sh1
    a = _attn_joint(params, p, img_mod, txt_mod, cfg.n_heads, qcfg, pe=pe)
    L_img = img.shape[1]
    img = img + i_g1 * _out(params, p, "to_out", a[:, :L_img], qcfg)
    txt = txt + t_g1 * _out(params, p, "to_out_t", a[:, L_img:], qcfg)

    h = layer_norm(img, eps=1e-6) * (1 + i_sc2) + i_sh2
    img = img + i_g2 * moe_ffn(params, f"{p}.ff_i", h, cfg.n_experts,
                               cfg.top_k, qcfg)
    h = layer_norm(txt, eps=1e-6) * (1 + t_sc2) + t_sh2
    txt = txt + t_g2 * _swiglu(params, f"{p}.ff_t", h, qcfg)
    return img, txt


def _single_block(params, p, x, vec, cfg: HiDreamConfig, qcfg, pe=None):
    sh1, sc1, g1, sh2, sc2, g2 = _adaln(params, p, vec, qcfg,
                                        cfg.hidden)[:6]
    h = layer_norm(x, eps=1e-6) * (1 + sc1) + sh1
    a = _attn_joint(params, p, h, None, cfg.n_heads, qcfg, pe=pe)
    x = x + g1 * _out(params, p, "to_out", a, qcfg)
    h = layer_norm(x, eps=1e-6) * (1 + sc2) + sh2
    return x + g2 * moe_ffn(params, f"{p}.ff_i", h, cfg.n_experts,
                            cfg.top_k, qcfg)


def _prelude(params, cfg: HiDreamConfig, latent, t5_states, llama_states,
             pooled, timesteps, qcfg):
    B, Hh, Ww, C = latent.shape
    p = cfg.patch_size
    h_tok, w_tok = Hh // p, Ww // p

    xp = latent.reshape(B, h_tok, p, w_tok, p, C).permute(0, 1, 3, 5, 2, 4)
    xp = xp.reshape(B, h_tok * w_tok, C * p * p)
    img = linear(xp, params["x_embedder.proj.weight"],
                 params.get("x_embedder.proj.bias"), cfg=qcfg)

    def mlp(pre, x):
        h = linear(x, params[f"{pre}.mlp.0.weight"],
                   params.get(f"{pre}.mlp.0.bias"), cfg=qcfg)
        return linear(_silu(h.to(img.dtype)), params[f"{pre}.mlp.2.weight"],
                      params.get(f"{pre}.mlp.2.bias"), cfg=qcfg)

    vec = mlp("t_embedder", timestep_embedding(timesteps, 256).to(img.dtype))
    vec = vec + mlp("p_embedder", pooled.to(img.dtype))

    # the caption projections in the published order: 0..N-2 take the
    # llama states, the last one the T5 states
    n_proj = 0
    while f"caption_projection.{n_proj}.linear.weight" in params:
        n_proj += 1

    def cap(i, states):
        return linear(states, params[f"caption_projection.{i}.linear.weight"],
                      params.get(f"caption_projection.{i}.linear.bias"),
                      cfg=qcfg)

    txt = torch.cat([cap(i, llama_states) for i in range(n_proj - 1)]
                    + [cap(n_proj - 1, t5_states)], dim=1)

    # flux-style ids over [image, text]: image tokens (0, row, col), text
    # tokens zero (the identity rotation)
    ids = np.zeros((1, h_tok * w_tok + txt.shape[1], 3), np.int32)
    ids[0, : h_tok * w_tok, 1] = np.repeat(np.arange(h_tok), w_tok)
    ids[0, : h_tok * w_tok, 2] = np.tile(np.arange(w_tok), h_tok)
    pe = rope_freqs(torch.from_numpy(ids).to(img.device), cfg.axes_dim,
                    cfg.theta)
    return img, txt, vec, pe, (B, Hh, Ww, C, h_tok, w_tok)


def _finale(params, cfg: HiDreamConfig, img, vec, dims, qcfg):
    B, Hh, Ww, C, h_tok, w_tok = dims
    p = cfg.patch_size
    mod = linear(_silu(vec.to(img.dtype)),
                 params["final_layer.adaLN_modulation.1.weight"],
                 params.get("final_layer.adaLN_modulation.1.bias"), cfg=qcfg)
    shift, scale = torch.chunk(mod[:, None, :], 2, dim=-1)
    img = layer_norm(img, eps=1e-6) * (1 + scale) + shift
    img = linear(img, params["final_layer.linear.weight"],
                 params.get("final_layer.linear.bias"), cfg=qcfg)
    img = img.reshape(B, h_tok, w_tok, p, p, C)
    return img.permute(0, 1, 3, 2, 4, 5).reshape(B, Hh, Ww, C)


def forward(params, cfg: HiDreamConfig, latent, t5_states, llama_states,
            pooled, timesteps,
            qcfg: QuantConfig = DEFAULT_CONFIG) -> torch.Tensor:
    """latent (B, H, W, C) NHWC; t5 / llama states (B, L, D_enc); pooled
    (B, D_pool); timesteps (B,) → velocity latent (B, H, W, C)."""
    img, txt, vec, pe, dims = _prelude(params, cfg, latent, t5_states,
                                       llama_states, pooled, timesteps,
                                       qcfg)
    L_img = img.shape[1]
    for i in range(cfg.depth_double):
        img, txt = _double_block(params, f"double_stream_blocks.{i}.block",
                                 img, txt, vec, cfg, qcfg, pe)
    x = torch.cat([img, txt], dim=1)
    for i in range(cfg.depth_single):
        x = _single_block(params, f"single_stream_blocks.{i}.block", x, vec,
                          cfg, qcfg, pe)
    return _finale(params, cfg, x[:, :L_img], vec, dims, qcfg)


def stack_hidream_params(params: dict, cfg: HiDreamConfig) -> dict:
    """Flat params → {non-block keys, "double_stream_blocks",
    "single_stream_blocks": stacked subtrees}; the experts are leaf-stacked
    first (``stack_moe_experts``), so each ``experts_stacked`` leaf is
    (depth, E, …). Copies the block weights once."""
    if any(".experts." in k for k in params):
        params = stack_moe_experts(params, cfg.n_experts)
    return stack_block_groups(params,
                              [("double_stream_blocks", cfg.depth_double),
                               ("single_stream_blocks", cfg.depth_single)],
                              arch="hidream")


def forward_stacked(sparams: dict, cfg: HiDreamConfig, latent, t5_states,
                    llama_states, pooled, timesteps,
                    qcfg: QuantConfig = DEFAULT_CONFIG) -> torch.Tensor:
    """forward() over stack_hidream_params() output — identical math, one
    loop per block kind over views of the stacked blocks."""
    img, txt, vec, pe, dims = _prelude(sparams, cfg, latent, t5_states,
                                       llama_states, pooled, timesteps,
                                       qcfg)
    L_img = img.shape[1]
    for i in range(cfg.depth_double):
        img, txt = _double_block(
            block_view(sparams["double_stream_blocks"], i), "block", img,
            txt, vec, cfg, qcfg, pe)
    x = torch.cat([img, txt], dim=1)
    for i in range(cfg.depth_single):
        x = _single_block(block_view(sparams["single_stream_blocks"], i),
                          "block", x, vec, cfg, qcfg, pe)
    return _finale(sparams, cfg, x[:, :L_img], vec, dims, qcfg)
