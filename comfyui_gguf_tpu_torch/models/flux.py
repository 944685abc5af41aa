"""Flux DiT (PyTorch port of comfyui_gguf_tpu/models/flux.py).

Double-stream / single-stream rectified-flow transformer over the flat
GGUF state dict (BFL key naming): 3-axis RoPE, QK-RMSNorm, double blocks
with joint text+image attention, single blocks with fused qkv+mlp, adaLN
modulation from timestep + guidance + pooled-CLIP vector. Every hot matmul
goes through ``nn.layers.linear`` and so through the fused kernels.

``forward_stacked`` is the reference's ``lax.scan`` over depth-stacked
weights as a Python loop: block i's weights are views (``leaf[i]``) of the
stacked tensors, and the kernels read them in place. LoRA-patched leaves
stack too (their base and each patch's factors along depth), so the patched
blocks run the kernels' LoRA instances on views.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
import torch.nn.functional as F

from ..lora import LoRAPatch, PatchedWeight
from ..nn.attention import dot_product_attention
from ..nn.layers import (QuantConfig, DEFAULT_CONFIG, in_features,
                         layer_norm, linear, linear_gelu, out_features,
                         rms_norm)
from ..quant.i8 import I8Planar
from ..quant.planar import PlanarQuant


@dataclasses.dataclass(frozen=True)
class FluxConfig:
    in_channels: int = 64  # 16 latent ch × 2×2 patch
    hidden: int = 3072
    n_heads: int = 24
    depth_double: int = 19
    depth_single: int = 38
    mlp_ratio: float = 4.0
    axes_dim: tuple[int, ...] = (16, 56, 56)
    theta: int = 10_000
    context_dim: int = 4096
    vec_dim: int = 768
    guidance_embed: bool = True

    @property
    def head_dim(self) -> int:
        return self.hidden // self.n_heads

    @staticmethod
    def from_state_dict(sd) -> "FluxConfig":
        def shape(k):
            return tuple(sd[k].shape)

        hidden, in_ch = shape("img_in.weight")
        _, ctx = shape("txt_in.weight")
        _, vec = shape("vector_in.in_layer.weight")
        nd = 0
        while f"double_blocks.{nd}.img_mod.lin.weight" in sd:
            nd += 1
        ns = 0
        while f"single_blocks.{ns}.linear1.weight" in sd:
            ns += 1
        qn = shape("double_blocks.0.img_attn.norm.query_norm.scale")[0]
        return FluxConfig(
            in_channels=int(in_ch), hidden=int(hidden),
            n_heads=int(hidden) // int(qn), depth_double=nd, depth_single=ns,
            context_dim=int(ctx), vec_dim=int(vec),
            guidance_embed="guidance_in.in_layer.weight" in sd,
        )


# ---------------------------------------------------------------------------
# embeddings
# ---------------------------------------------------------------------------

def timestep_embedding(t: torch.Tensor, dim: int,
                       max_period: float = 10_000.0,
                       time_factor: float = 1000.0) -> torch.Tensor:
    """Sinusoidal embedding, BFL convention (t scaled by 1000, cos|sin)."""
    t = time_factor * t.to(torch.float32)
    half = dim // 2
    freqs = torch.exp(
        -math.log(max_period)
        * torch.arange(half, dtype=torch.float32, device=t.device) / half)
    args = t[:, None] * freqs[None]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


def rope_freqs(ids: torch.Tensor, axes_dim,
               theta: float = 10_000.0) -> torch.Tensor:
    """Position ids (B, L, n_axes) → rotation (B, L, D/2, 2) as (cos, sin)."""
    parts = []
    for i, d in enumerate(axes_dim):
        pos = ids[..., i].to(torch.float32)  # (B, L)
        omega = 1.0 / (theta ** (torch.arange(
            0, d, 2, dtype=torch.float32, device=ids.device) / d))
        angles = pos[..., None] * omega  # (B, L, d/2)
        parts.append(torch.stack([torch.cos(angles), torch.sin(angles)],
                                 dim=-1))
    return torch.cat(parts, dim=2)  # (B, L, D/2, 2)


def apply_rope(x: torch.Tensor, pe: torch.Tensor) -> torch.Tensor:
    """x: (B, H, L, D); pe: (B, L, D/2, 2) — rotate adjacent pairs.

    real = x0·cos − x1·sin and imag = x0·sin + x1·cos, computed as
    x·[cos, cos] + swap(x)·[−sin, sin]: the same products and sums in
    float32 (a + (−b) is a − b exactly), without strided half-pair ops.
    """
    B, H, L, D = x.shape
    xf = x.to(torch.float32).reshape(B, H, L, D // 2, 2)
    cos = pe[:, None, :, :, :1]
    sin = pe[:, None, :, :, 1:]
    out = xf * torch.cat([cos, cos], dim=-1) \
        + xf.flip(-1) * torch.cat([-sin, sin], dim=-1)
    return out.reshape(B, H, L, D).to(x.dtype)


def make_img_ids(h_tok: int, w_tok: int, batch: int) -> np.ndarray:
    """(B, h*w, 3) position ids: axis0 unused, axis1 row, axis2 col."""
    ids = np.zeros((h_tok, w_tok, 3), dtype=np.int32)
    ids[..., 1] = np.arange(h_tok)[:, None]
    ids[..., 2] = np.arange(w_tok)[None, :]
    return np.broadcast_to(ids.reshape(1, -1, 3), (batch, h_tok * w_tok, 3))


# ---------------------------------------------------------------------------
# building blocks
# ---------------------------------------------------------------------------

def _silu(x: torch.Tensor) -> torch.Tensor:
    return F.silu(x.to(torch.float32)).to(x.dtype)


def _mlp_embed(params, prefix: str, x, qcfg):
    h = linear(x, params[f"{prefix}.in_layer.weight"],
               params.get(f"{prefix}.in_layer.bias"), cfg=qcfg)
    return linear(_silu(h), params[f"{prefix}.out_layer.weight"],
                  params.get(f"{prefix}.out_layer.bias"), cfg=qcfg)


def _modulation(params, prefix: str, vec, n: int, qcfg):
    """silu(vec) → lin → n chunks of hidden, each (B, 1, hidden)."""
    out = linear(_silu(vec), params[f"{prefix}.lin.weight"],
                 params.get(f"{prefix}.lin.bias"), cfg=qcfg)
    return torch.chunk(out[:, None, :], n, dim=-1)


def _qknorm(params, prefix: str, q, k):
    q = rms_norm(q, params[f"{prefix}.query_norm.scale"], eps=1e-6)
    k = rms_norm(k, params[f"{prefix}.key_norm.scale"], eps=1e-6)
    return q, k


def _attention(q, k, v, pe):
    """(B, H, L, D) heads-major attention with RoPE; returns (B, L, H*D)."""
    q = apply_rope(q, pe)
    k = apply_rope(k, pe)
    B, H, L, D = q.shape
    out = dot_product_attention(q, k, v)  # (B, H, L, D)
    return out.transpose(1, 2).reshape(B, L, H * D)


def _split_heads(x, n_heads: int):
    """(B, L, 3*hidden) fused qkv → 3 × (B, H, L, D) views."""
    B, L, _ = x.shape
    qkv = x.reshape(B, L, 3, n_heads, -1)
    return tuple(qkv[:, :, i].transpose(1, 2) for i in range(3))


def block_subtree(params, prefix: str) -> dict:
    """Per-block param view: strips ``prefix`` from matching keys."""
    n = len(prefix)
    return {k[n:]: v for k, v in params.items() if k.startswith(prefix)}


def _double_block(p: dict, img, txt, vec, pe, cfg: FluxConfig, qcfg):
    """One double-stream block over its UNPREFIXED param subtree ``p``."""
    H = cfg.n_heads
    i_shift1, i_scale1, i_gate1, i_shift2, i_scale2, i_gate2 = _modulation(
        p, "img_mod", vec, 6, qcfg)
    t_shift1, t_scale1, t_gate1, t_shift2, t_scale2, t_gate2 = _modulation(
        p, "txt_mod", vec, 6, qcfg)

    img_mod = layer_norm(img, eps=1e-6) * (1 + i_scale1) + i_shift1
    txt_mod = layer_norm(txt, eps=1e-6) * (1 + t_scale1) + t_shift1

    iq, ik, iv = _split_heads(
        linear(img_mod, p["img_attn.qkv.weight"],
               p.get("img_attn.qkv.bias"), cfg=qcfg), H)
    tq, tk, tv = _split_heads(
        linear(txt_mod, p["txt_attn.qkv.weight"],
               p.get("txt_attn.qkv.bias"), cfg=qcfg), H)
    iq, ik = _qknorm(p, "img_attn.norm", iq, ik)
    tq, tk = _qknorm(p, "txt_attn.norm", tq, tk)

    # joint attention, text stream first (BFL ordering)
    q = torch.cat([tq, iq], dim=2)
    k = torch.cat([tk, ik], dim=2)
    v = torch.cat([tv, iv], dim=2)
    attn = _attention(q, k, v, pe)
    L_txt = txt.shape[1]
    txt_attn, img_attn = attn[:, :L_txt], attn[:, L_txt:]

    img = img + i_gate1 * linear(img_attn, p["img_attn.proj.weight"],
                                 p.get("img_attn.proj.bias"), cfg=qcfg)
    h = layer_norm(img, eps=1e-6) * (1 + i_scale2) + i_shift2
    h = linear_gelu(h, p["img_mlp.0.weight"], p.get("img_mlp.0.bias"),
                    cfg=qcfg)
    img = img + i_gate2 * linear(h, p["img_mlp.2.weight"],
                                 p.get("img_mlp.2.bias"), cfg=qcfg)

    txt = txt + t_gate1 * linear(txt_attn, p["txt_attn.proj.weight"],
                                 p.get("txt_attn.proj.bias"), cfg=qcfg)
    h = layer_norm(txt, eps=1e-6) * (1 + t_scale2) + t_shift2
    h = linear_gelu(h, p["txt_mlp.0.weight"], p.get("txt_mlp.0.bias"),
                    cfg=qcfg)
    txt = txt + t_gate2 * linear(h, p["txt_mlp.2.weight"],
                                 p.get("txt_mlp.2.bias"), cfg=qcfg)
    return img, txt


def _single_block(p: dict, x, vec, pe, cfg: FluxConfig, qcfg):
    """One single-stream block over its unprefixed param subtree."""
    H = cfg.n_heads
    # linear1 fuses [q|k|v|mlp]: linear1 out = 3h+m, linear2 in = h+m
    hid3 = 3 * (out_features(p["linear1.weight"])
                - in_features(p["linear2.weight"])) // 2

    shift, scale, gate = _modulation(p, "modulation", vec, 3, qcfg)
    x_mod = layer_norm(x, eps=1e-6) * (1 + scale) + shift

    # fused linear1: qkv columns pass through, mlp columns get the GELU in
    # the kernel epilogue
    h = linear_gelu(x_mod, p["linear1.weight"], p.get("linear1.bias"),
                    tail_from=hid3, cfg=qcfg)
    qkv, act = h[..., :hid3], h[..., hid3:]
    q, k, v = _split_heads(qkv, H)
    q, k = _qknorm(p, "norm", q, k)
    attn = _attention(q, k, v, pe)
    out = linear(torch.cat([attn, act], dim=-1),
                 p["linear2.weight"], p.get("linear2.bias"), cfg=qcfg)
    return x + gate * out


# ---------------------------------------------------------------------------
# full forward
# ---------------------------------------------------------------------------

def _prelude(params, cfg: FluxConfig, img, img_ids, txt, txt_ids,
             timesteps, y, guidance, qcfg):
    """Input embeddings + conditioning vector + RoPE table."""
    img = linear(img, params["img_in.weight"], params.get("img_in.bias"),
                 cfg=qcfg)
    txt = linear(txt, params["txt_in.weight"], params.get("txt_in.bias"),
                 cfg=qcfg)

    vec = _mlp_embed(params, "time_in",
                     timestep_embedding(timesteps, 256), qcfg)
    if cfg.guidance_embed:
        if guidance is None:
            raise ValueError("guidance-distilled model needs guidance values")
        vec = vec + _mlp_embed(params, "guidance_in",
                               timestep_embedding(guidance, 256), qcfg)
    vec = vec + _mlp_embed(params, "vector_in", y, qcfg)
    # keep the conditioning vector in activation dtype
    vec = vec.to(img.dtype)

    ids = torch.cat([txt_ids, img_ids], dim=1)
    pe = rope_freqs(ids, cfg.axes_dim, cfg.theta)
    return img, txt, vec, pe


def _final(params, img, vec, qcfg):
    """Final adaLN + projection to velocity tokens."""
    mod = linear(_silu(vec), params["final_layer.adaLN_modulation.1.weight"],
                 params.get("final_layer.adaLN_modulation.1.bias"), cfg=qcfg)
    shift, scale = torch.chunk(mod[:, None, :], 2, dim=-1)
    img = layer_norm(img, eps=1e-6) * (1 + scale) + shift
    return linear(img, params["final_layer.linear.weight"],
                  params.get("final_layer.linear.bias"), cfg=qcfg)


def forward(params, cfg: FluxConfig, img, img_ids, txt, txt_ids, timesteps,
            y, guidance=None, qcfg: QuantConfig = DEFAULT_CONFIG):
    """Patchified latent tokens → predicted flow velocity tokens.

    img: (B, L_img, in_channels); txt: (B, L_txt, context_dim);
    *_ids: (B, L, 3) RoPE position ids; y: (B, vec_dim) pooled CLIP.
    """
    img, txt, vec, pe = _prelude(params, cfg, img, img_ids, txt, txt_ids,
                                 timesteps, y, guidance, qcfg)
    for i in range(cfg.depth_double):
        img, txt = _double_block(block_subtree(params, f"double_blocks.{i}."),
                                 img, txt, vec, pe, cfg, qcfg)
    x = torch.cat([txt, img], dim=1)
    for i in range(cfg.depth_single):
        x = _single_block(block_subtree(params, f"single_blocks.{i}."),
                          x, vec, pe, cfg, qcfg)
    img = x[:, txt.shape[1]:]
    return _final(params, img, vec, qcfg)


# ---------------------------------------------------------------------------
# stacked-params forward (a loop over views of the stacked weights)
# ---------------------------------------------------------------------------

def _stack_opt(ts):
    return None if ts[0] is None else torch.stack(ts)


def _stack_leaves(leaves, key: str = ""):
    first = leaves[0]
    if isinstance(first, dict):  # a nested subtree (HiDream's experts)
        return {k: _stack_leaves([l[k] for l in leaves], f"{key}.{k}")
                for k in first}
    if any(isinstance(l, PatchedWeight) for l in leaves):
        # blocks stack only where every block carries patches of the same
        # kinds, ranks and scales (the reference's tree map refuses other
        # structures)
        def sig(l):
            if not isinstance(l, PatchedWeight):
                return None
            return tuple((p.scale,) + tuple(
                None if t is None else tuple(t.shape)
                for t in (p.up, p.down, p.mid, p.diff, p.a1, p.a2))
                for p in l.patches)
        if len({sig(l) for l in leaves}) > 1:
            raise ValueError(
                f"the blocks' LoRA patches of {key or 'a leaf'} differ "
                "(some patched, some not, or other ranks or scales): such "
                "blocks do not stack; use forward()")
        def stacked_patch(j):
            fields = {f: _stack_opt([getattr(l.patches[j], f)
                                     for l in leaves])
                      for f in ("up", "down", "mid", "diff", "a1", "a2")}
            return LoRAPatch(scale=first.patches[j].scale, **fields)

        patches = tuple(stacked_patch(j) for j in range(len(first.patches)))
        return PatchedWeight(_stack_leaves([l.base for l in leaves], key),
                             patches)
    if isinstance(first, PlanarQuant):
        return dataclasses.replace(
            first, qs=torch.stack([l.qs for l in leaves]),
            scales=torch.stack([l.scales for l in leaves]),
            offsets=(None if first.offsets is None
                     else torch.stack([l.offsets for l in leaves])))
    if isinstance(first, I8Planar):
        return dataclasses.replace(
            first, qs=torch.stack([l.qs for l in leaves]),
            scales=torch.stack([l.scales for l in leaves]))
    return torch.stack(leaves)


def stack_block_groups(params: dict, groups, arch: str = "") -> dict:
    """Flat GGUF-keyed params → {non-block keys, out_key: depth-stacked
    subtree per group}; blocks live under ``{out_key}.{i}.`` and every
    block of a group must expose the same keys."""
    prefixes = tuple(f"{g[0]}." for g in groups)
    out = {k: v for k, v in params.items() if not k.startswith(prefixes)}
    for out_key, n in groups:
        subs = [block_subtree(params, f"{out_key}.{i}.") for i in range(n)]
        if len({frozenset(s) for s in subs}) > 1:
            raise ValueError(f"non-homogeneous {arch or out_key} blocks; "
                             "use forward()")
        out[out_key] = ({k: _stack_leaves([s[k] for s in subs],
                                          f"{out_key}.*.{k}")
                         for k in subs[0]} if subs else {})
    return out


def stack_flux_params(params: dict, cfg: FluxConfig) -> dict:
    """Flat params → {non-block keys, "double_blocks": stacked subtree,
    "single_blocks": stacked subtree} (copies the block weights once)."""
    return stack_block_groups(params,
                              [("double_blocks", cfg.depth_double),
                               ("single_blocks", cfg.depth_single)],
                              arch="flux")


def block_view(stacked: dict, i: int) -> dict:
    """Block i of a stacked subtree: every leaf is a view, no copy (a
    PatchedWeight's base and factors too; nested subtrees alike)."""
    return {k: block_view(v, i) if isinstance(v, dict) else v[i]
            for k, v in stacked.items()}


def forward_stacked(sparams: dict, cfg: FluxConfig, img, img_ids, txt,
                    txt_ids, timesteps, y, guidance=None,
                    qcfg: QuantConfig = DEFAULT_CONFIG):
    """forward() over stack_flux_params() output — identical math, one
    loop per block kind over views of the stacked weights."""
    img, txt, vec, pe = _prelude(sparams, cfg, img, img_ids, txt, txt_ids,
                                 timesteps, y, guidance, qcfg)
    for i in range(cfg.depth_double):
        img, txt = _double_block(block_view(sparams["double_blocks"], i),
                                 img, txt, vec, pe, cfg, qcfg)
    x = torch.cat([txt, img], dim=1)
    for i in range(cfg.depth_single):
        x = _single_block(block_view(sparams["single_blocks"], i),
                          x, vec, pe, cfg, qcfg)
    img = x[:, txt.shape[1]:]
    return _final(sparams, img, vec, qcfg)


# ---------------------------------------------------------------------------
# latent patchify helpers (2×2)
# ---------------------------------------------------------------------------

def patchify(latent: torch.Tensor) -> torch.Tensor:
    """(B, H, W, C) latent → (B, H/2*W/2, C*4) tokens."""
    B, H, W, C = latent.shape
    x = latent.reshape(B, H // 2, 2, W // 2, 2, C)
    return x.permute(0, 1, 3, 5, 2, 4).reshape(B, (H // 2) * (W // 2), C * 4)


def unpatchify(tokens: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """(B, h/2*w/2, C*4) tokens → (B, h, w, C) latent."""
    B, L, D = tokens.shape
    C = D // 4
    x = tokens.reshape(B, h // 2, w // 2, C, 2, 2)
    return x.permute(0, 1, 4, 2, 5, 3).reshape(B, h, w, C)
