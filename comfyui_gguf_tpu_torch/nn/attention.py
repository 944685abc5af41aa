"""Attention (PyTorch port of comfyui_gguf_tpu/nn/attention.py).

``dot_product_attention`` keeps the reference's contract: q/k/v in
(B, H, L, D) heads-major layout, softmax scale D^-0.5 by default, k and v
cast to q's dtype, and cross-attention with Lq != Lk.

* ``flash_attn_cuda`` — wrapper of the hand-written flash-attention kernel
  ``csrc/flash_attn.cu`` (K7), bf16, D in {64, 128}.
* ``plain_attention`` — the plain PyTorch version, the arithmetic of
  ``jax.nn.dot_product_attention``: f32 logits, f32 softmax, probabilities
  in the value dtype, f32-accumulated probs·v.

The reference's splash/flash block-size and padding machinery is specific
to the TPU kernels and has no counterpart: the CUDA kernel masks the ragged
key tile itself.
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build


def plain_attention(q, k, v, scale: float) -> torch.Tensor:
    """softmax(scale · q kᵀ) v on (B, H, L, D) tensors, one step at a time."""
    logits = torch.matmul(q.to(torch.float32),
                          k.to(torch.float32).transpose(-1, -2)) * scale
    probs = torch.softmax(logits, dim=-1).to(k.dtype)
    out = torch.matmul(probs.to(torch.float32), v.to(torch.float32))
    return out.to(q.dtype)


def _row_aligned(t: torch.Tensor) -> torch.Tensor:
    """A view whose rows start on 16 bytes (D contiguous); a copy only
    where the given view is not."""
    ok = (t.stride(-1) == 1 and t.data_ptr() % 16 == 0
          and all(s % 8 == 0 for s in t.stride()[:-1]))
    return t if ok else t.contiguous()


def flash_attn_cuda(q, k, v, scale: float) -> torch.Tensor:
    """Launch the flash-attention kernel (K7).

    q: (B, H, Lq, D), k/v: (B, H, Lk, D), bf16 CUDA tensors (strided views
    with unit stride along D are fine). Returns (B, H, Lq, D) bf16 whose
    storage is (B, Lq, H, D), so merging heads afterwards is free.
    """
    B, H, Lq, D = q.shape
    Lk = k.shape[2]
    if not q.is_cuda:
        raise ValueError("flash_attn_cuda takes CUDA tensors")
    if any(t.dtype != torch.bfloat16 for t in (q, k, v)):
        raise NotImplementedError("the flash kernel takes bfloat16 q/k/v")
    if D not in (64, 128):
        raise NotImplementedError(
            f"head dim {D}: the flash kernel has instances for 64 and 128")
    if k.shape != (B, H, Lk, D) or v.shape != (B, H, Lk, D) or Lk < 1:
        raise ValueError(f"k/v shapes {tuple(k.shape)} {tuple(v.shape)} "
                         f"do not match q {tuple(q.shape)}")
    q, k, v = _row_aligned(q), _row_aligned(k), _row_aligned(v)
    out = torch.empty((B, Lq, H, D), dtype=torch.bfloat16,
                      device=q.device).permute(0, 2, 1, 3)
    if Lq:
        strides = (ctypes.c_longlong * 12)(
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            *out.stride()[:3])
        rc = _build.lib().flash_attn_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            B, H, Lq, Lk, D, strides, float(scale),
            ctypes.c_void_p(_build.stream_handle(q.device)))
        _build.check(rc, "flash_attn_launch")
        _build.count("flash_attn")
    return out


def dot_product_attention(q, k, v, scale: float | None = None):
    """q/k/v: (B, H, L, D) heads-major -> (B, H, Lq, D).

    Softmax scale defaults to D^-0.5. CUDA tensors launch the flash kernel;
    CPU tensors take the plain version.
    """
    D = q.shape[-1]
    if scale is None:
        scale = D ** -0.5
    # cross-attention k/v may arrive in another dtype (f32 text states vs
    # bf16 latents); harmonize on the query dtype
    k = k.to(q.dtype)
    v = v.to(q.dtype)
    if q.is_cuda:
        return flash_attn_cuda(q, k, v, float(scale))
    return plain_attention(q, k, v, float(scale))
