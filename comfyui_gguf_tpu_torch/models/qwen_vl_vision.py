"""Qwen2-VL / Qwen2.5-VL vision tower, the mmproj sidecar's forward graph
(PyTorch port of comfyui_gguf_tpu/models/qwen_vl_vision.py).

The loader merges the sidecar's weights as ``visual.*`` keys
(``loader.gguf_mmproj_loader``: split q/k/v re-fused, the two patch-embed
chunks stacked to the 5-D temporal kernel). This module runs them: a ViT
with 2-axis rotary embeddings, Qwen2.5's window attention (same-window
masking, full attention in the blocks of ``fullatt_block_indexes``),
SwiGLU (2.5) or quick-GELU (2.0) MLPs told apart by the key set, and the
2×2 patch merger. Qwen-Image-Edit conditions the Qwen2.5-VL text encoder on
an image through it (``pipeline.qwen_vl_encode_with_image``).

The attention is written out in torch ops as the reference writes it in
einsums (it is no Pallas call): f32 logits, the window mask, softmax.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

from ..nn.layers import (DEFAULT_CONFIG, QuantConfig, layer_norm, linear,
                         materialize, rms_norm)


@dataclasses.dataclass(frozen=True)
class QwenVLVisionConfig:
    dim: int
    n_layers: int
    n_heads: int
    out_dim: int
    patch_size: int = 14
    temporal_patch: int = 2
    merge_size: int = 2
    # Qwen2.5-VL: window attention except in these blocks; a window spans
    # 112 px = 8 patches = 4 merged cells. Qwen2-VL: every block full.
    fullatt_block_indexes: tuple[int, ...] = (7, 15, 23, 31)
    window_cells: int = 4  # window side in merged cells
    use_window_attention: bool = True

    @staticmethod
    def from_state_dict(sd) -> "QwenVLVisionConfig":
        def shape(k):
            return tuple(sd[k].shape)

        pe = shape("visual.patch_embed.proj.weight")  # (dim, 3, t, p, p)
        n = 0
        while f"visual.blocks.{n}.attn.qkv.weight" in sd:
            n += 1
        # 2.5-VL has gated MLPs and RMS norms, 2.0 fc-style MLPs and LN
        is_25 = "visual.blocks.0.mlp.gate_proj.weight" in sd
        return QwenVLVisionConfig(
            dim=int(pe[0]), n_layers=n, n_heads=int(pe[0]) // 80,
            out_dim=int(shape("visual.merger.mlp.2.weight")[0]),
            patch_size=int(pe[-1]),
            temporal_patch=int(pe[2]) if len(pe) == 5 else 2,
            use_window_attention=is_25)


def _rot_half(x: torch.Tensor) -> torch.Tensor:
    a, b = torch.chunk(x, 2, dim=-1)
    return torch.cat([-b, a], dim=-1)


def _rope_2d(h: int, w: int, head_dim: int, theta: float = 10_000.0):
    """(L, head_dim) float32 cos and sin over half-split (row, col)
    positions, computed on the host as the reference does."""
    half = head_dim // 2
    omega = 1.0 / (theta ** (np.arange(0, half, 2, dtype=np.float32) / half))
    rows = np.repeat(np.arange(h), w).astype(np.float32)
    cols = np.tile(np.arange(w), h).astype(np.float32)
    ang = np.concatenate([rows[:, None] * omega[None],
                          cols[:, None] * omega[None]], axis=1)
    ang = np.concatenate([ang, ang], axis=1)
    return (torch.from_numpy(np.cos(ang).astype(np.float32)),
            torch.from_numpy(np.sin(ang).astype(np.float32)))


def _window_ids(h: int, w: int, merge: int, cells: int) -> np.ndarray:
    """Window id of each pre-merge token, (h*w,) int32."""
    rows, cols = np.divmod(np.arange(h * w), w)
    win_r, win_c = rows // merge // cells, cols // merge // cells
    n_wc = -(-(w // merge) // cells)
    return (win_r * n_wc + win_c).astype(np.int32)


def forward(params, cfg: QwenVLVisionConfig, pixels: torch.Tensor,
            qcfg: QuantConfig = DEFAULT_CONFIG) -> torch.Tensor:
    """pixels (h_patches, w_patches, C·tp·p·p) patch vectors
    (``extract_patches``) → (h/merge · w/merge, out_dim) merged vision
    embeddings."""
    hp, wp, _ = pixels.shape
    L, D, H = hp * wp, cfg.dim, cfg.n_heads
    hd = D // H
    dev = pixels.device

    # the patch embed: an f32 product on the materialized 5-D kernel
    wk = materialize(params["visual.patch_embed.proj.weight"],
                     torch.float32).reshape(D, -1)
    x = torch.matmul(pixels.reshape(L, -1).to(torch.float32), wk.T)
    if "visual.patch_embed.proj.bias" in params:
        x = x + params["visual.patch_embed.proj.bias"].to(x.dtype)
    x = x.to(torch.bfloat16)[None]  # (1, L, D)

    cos, sin = (t.to(dev) for t in _rope_2d(hp, wp, hd))
    wid = torch.from_numpy(_window_ids(hp, wp, cfg.merge_size,
                                       cfg.window_cells)).to(dev)
    win_mask = torch.where(wid[None, :] == wid[:, None], 0.0,
                           torch.finfo(torch.float32).min)[None, None]

    def norm(x, base):
        if f"{base}.bias" in params:
            return layer_norm(x, params[f"{base}.weight"],
                              params[f"{base}.bias"], eps=1e-6)
        return rms_norm(x, params[f"{base}.weight"], eps=1e-6)

    def lin(h, base):
        return linear(h, params[f"{base}.weight"], params.get(f"{base}.bias"),
                      cfg=qcfg)

    for i in range(cfg.n_layers):
        p = f"visual.blocks.{i}"
        full = (not cfg.use_window_attention
                or i in cfg.fullatt_block_indexes)
        h = norm(x, f"{p}.norm1")
        q, k, v = (a.reshape(1, L, H, hd).transpose(1, 2)
                   for a in torch.chunk(lin(h, f"{p}.attn.qkv"), 3, dim=-1))
        qf, kf = q.to(torch.float32), k.to(torch.float32)
        q = (qf * cos + _rot_half(qf) * sin).to(x.dtype)
        k = (kf * cos + _rot_half(kf) * sin).to(x.dtype)
        logits = torch.matmul(q.to(torch.float32),
                              k.to(torch.float32).transpose(-1, -2)) \
            * (hd ** -0.5)
        if not full:
            logits = logits + win_mask
        probs = torch.softmax(logits, dim=-1).to(v.dtype)
        a = torch.matmul(probs, v).transpose(1, 2).reshape(1, L, D)
        x = x + lin(a, f"{p}.attn.proj")

        h = norm(x, f"{p}.norm2")
        if f"{p}.mlp.gate_proj.weight" in params:  # 2.5: SwiGLU
            g = lin(h, f"{p}.mlp.gate_proj")
            m = F.silu(g.to(torch.float32)).to(h.dtype) * lin(
                h, f"{p}.mlp.up_proj")
        else:  # 2.0: fc, then quick-GELU
            mf = lin(h, f"{p}.mlp.up_proj").to(torch.float32)
            m = (mf * torch.sigmoid(1.702 * mf)).to(h.dtype)
        x = x + lin(m, f"{p}.mlp.down_proj")

    # the merger: ln_q per token, then merge² spatial neighbours
    x = norm(x, "visual.merger.ln_q")[0]
    m = cfg.merge_size
    x = x.reshape(hp // m, m, wp // m, m, D).permute(0, 2, 1, 3, 4)
    x = x.reshape((hp // m) * (wp // m), m * m * D)
    x = lin(x, "visual.merger.mlp.0")
    x = F.gelu(x.to(torch.float32)).to(x.dtype)  # exact erf
    return lin(x, "visual.merger.mlp.2")


def extract_patches(image: np.ndarray, patch: int = 14,
                    temporal: int = 2) -> np.ndarray:
    """(H, W, 3) float image → (h_patches, w_patches, 3·temporal·p·p) patch
    vectors, channel-major then temporal (the kernel's (C, t, ph, pw)
    flattening), the image repeated along the temporal patch axis (the
    single-image convention)."""
    H, W, C = image.shape
    hp, wp = H // patch, W // patch
    x = image[: hp * patch, : wp * patch]
    x = x.reshape(hp, patch, wp, patch, C).transpose(0, 2, 4, 1, 3)
    x = x.reshape(hp, wp, C, patch * patch)
    x = np.repeat(x[:, :, :, None, :], temporal, axis=3)
    return x.reshape(hp, wp, C * temporal * patch * patch)
