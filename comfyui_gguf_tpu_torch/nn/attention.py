"""Attention (PyTorch port of comfyui_gguf_tpu/nn/attention.py).

``dot_product_attention`` keeps the reference's contract: q/k/v in
(B, H, L, D) heads-major layout, softmax scale D^-0.5 by default, k and v
cast to q's dtype, and cross-attention with Lq != Lk.

* ``flash_attn_cuda`` — wrapper of the hand-written flash-attention kernel
  ``csrc/flash_attn.cu`` (K7): bf16 CUDA tensors, head dims
  ``FLASH_HEAD_DIMS`` (40, 80, 96 and 160 run the 64-, 128-, 128- and
  192-wide instances on zero-filled pad columns; 256 has a 256-wide
  instance on 64-key tiles; 384, the Wan VAE's single-head mid-block, an
  instance whose blocks own 128 output columns each; 512, the HunyuanVideo
  VAE's, the same split on 32-key tiles). Any other head dim or dtype on
  the card raises ``NotImplementedError`` (no route exists for it yet), and so
  does a view TMA cannot read; the same call on CPU tensors takes the plain
  version.
* ``plain_attention`` — the plain PyTorch version, the arithmetic of
  ``jax.nn.dot_product_attention``: f32 logits, f32 softmax, probabilities
  in the value dtype, f32-accumulated probs·v.
* ``sequence_parallel(axis)`` — a scope in which self-attention calls
  (Lq == Lk) run ring attention over that mesh axis (parallel/ring.py;
  the sequence is split over the axis) and cross-attention calls (Lq !=
  Lk, replicated text k/v) keep the normal dispatch. The video forwards
  then run sequence-parallel unmodified.
* ``attention_i8(mode)`` — a scope that routes eligible self-attention calls
  through the int8 flash-attention kernel (ops/i8attn.py, K6): "pv" both
  products in int8, "qk" the QK product only, "" off. The default comes
  from ``GGUF_TPU_ATTN_I8`` (the reference's variable, name kept). The
  scope is read at call time, on every call; nothing caches the route.

The reference's splash/flash block-size and padding machinery is specific
to the TPU kernels and has no counterpart: the CUDA kernels mask the ragged
key tile themselves.
"""

from __future__ import annotations

import contextlib
import contextvars
import ctypes
import os

import torch

from .. import _build

# int8 attention: "pv" = full int8 (QK + PV), "qk" = QK only
# (accuracy-conservative), "" = off. Env default; override per scope with
# `attention_i8(...)`.
_I8_ALLOWED = ("", "qk", "pv", "0", "1")


def _i8_env_default() -> str:
    v = os.environ.get("GGUF_TPU_ATTN_I8", "")
    if v not in _I8_ALLOWED:
        raise ValueError(
            f"GGUF_TPU_ATTN_I8={v!r}: expected one of {_I8_ALLOWED} "
            "('pv'/'1' full int8, 'qk' QK-dot only, ''/'0' off)")
    return v


_I8_MODE: contextvars.ContextVar[str] = contextvars.ContextVar(
    "gguf_attn_i8", default=_i8_env_default())

# the mesh axis of the enclosing sequence_parallel scope
_SP_AXIS: contextvars.ContextVar[str | None] = contextvars.ContextVar(
    "gguf_sp_axis", default=None)


@contextlib.contextmanager
def sequence_parallel(axis_name: str):
    """Route attention through ``parallel.ring`` in the enclosed calls.

    Calls with Lq == Lk are sequence-split self-attention (the ring over
    ``axis_name`` of the active mesh, ``parallel.collectives.active``);
    calls with Lq != Lk are cross-attention to replicated k/v (text
    states), exact locally, and take the normal dispatch."""
    tok = _SP_AXIS.set(axis_name)
    try:
        yield
    finally:
        _SP_AXIS.reset(tok)


@contextlib.contextmanager
def attention_i8(mode: str = "pv"):
    """Route eligible self-attention calls through the int8 kernel for
    the enclosed scope. mode: "pv" (full int8) | "qk" (QK dot only) |
    "" (off)."""
    if mode not in _I8_ALLOWED:
        raise ValueError(f"attention_i8 mode {mode!r}")
    tok = _I8_MODE.set(mode)
    try:
        yield
    finally:
        _I8_MODE.reset(tok)


def plain_attention(q, k, v, scale: float) -> torch.Tensor:
    """softmax(scale · q kᵀ) v on (B, H, L, D) tensors, one step at a time."""
    logits = torch.matmul(q.to(torch.float32),
                          k.to(torch.float32).transpose(-1, -2)) * scale
    probs = torch.softmax(logits, dim=-1).to(k.dtype)
    out = torch.matmul(probs.to(torch.float32), v.to(torch.float32))
    return out.to(q.dtype)


# head dims the flash kernel has instances for
FLASH_HEAD_DIMS = (40, 64, 80, 96, 128, 160, 256, 384, 512)


def flash_attn_cuda(q, k, v, scale: float) -> torch.Tensor:
    """Launch the flash-attention kernel (K7).

    q: (B, H, Lq, D), k/v: (B, H, Lk, D), bf16 CUDA tensors; strided views
    are read in place where TMA can read them (unit stride along D, base and
    other strides multiples of 16 bytes, as every (B, L, H·D) projection of
    a head dim in ``FLASH_HEAD_DIMS`` is) and refused otherwise. Returns
    (B, H, Lq, D) bf16 whose storage is (B, Lq, H, D), so merging heads
    afterwards is free.
    """
    B, H, Lq, D = q.shape
    Lk = k.shape[2]
    if not q.is_cuda:
        raise ValueError("flash_attn_cuda takes CUDA tensors")
    if any(t.dtype != torch.bfloat16 for t in (q, k, v)):
        raise NotImplementedError("the flash kernel takes bfloat16 q/k/v")
    if D not in FLASH_HEAD_DIMS:
        raise NotImplementedError(
            f"head dim {D}: the flash kernel has instances for "
            f"{', '.join(map(str, FLASH_HEAD_DIMS))}, and the card has no "
            f"other attention route yet (CPU tensors take plain_attention)")
    if k.shape != (B, H, Lk, D) or v.shape != (B, H, Lk, D) or Lk < 1:
        raise ValueError(f"k/v shapes {tuple(k.shape)} {tuple(v.shape)} "
                         f"do not match q {tuple(q.shape)}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not _build.is_row_aligned(t):
            raise ValueError(
                f"{name} (shape {tuple(t.shape)}, strides {t.stride()}) is "
                f"a view TMA cannot read: it needs unit stride along D and a "
                f"base and strides that are multiples of 16 bytes")
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
        _build.count(f"flash_attn_d{D}")
    return out


def dot_product_attention(q, k, v, scale: float | None = None):
    """q/k/v: (B, H, L, D) heads-major -> (B, H, Lq, D).

    Softmax scale defaults to D^-0.5. Inside ``sequence_parallel``, a
    self-attention call runs the ring instead. CUDA tensors launch the
    flash kernel;
    CPU tensors take the plain version. Under ``attention_i8`` a call inside
    the int8 gate (ops/i8attn.py ``i8_attention_ok``) takes the int8 path
    instead — its kernel on the card, its plain version on the CPU; a call
    outside the gate is not affected.
    """
    D = q.shape[-1]
    if scale is None:
        scale = D ** -0.5
    # cross-attention k/v may arrive in another dtype (f32 text states vs
    # bf16 latents); harmonize on the query dtype
    k = k.to(q.dtype)
    v = v.to(q.dtype)
    sp = _SP_AXIS.get()
    if sp is not None and q.shape[2] == k.shape[2]:
        from ..parallel.ring import ring_attention_local

        out = ring_attention_local(q.transpose(1, 2), k.transpose(1, 2),
                                   v.transpose(1, 2), sp, float(scale))
        return out.transpose(1, 2)
    i8_mode = _I8_MODE.get()
    if i8_mode not in ("", "0"):
        from ..ops.i8attn import i8_attention_ok, i8_dot_product_attention

        if i8_attention_ok(q, k):
            return i8_dot_product_attention(
                q, k, v, scale=float(scale),
                pv_int8=i8_mode in ("pv", "1"))
    if q.is_cuda:
        return flash_attn_cuda(q, k, v, float(scale))
    return plain_attention(q, k, v, float(scale))
