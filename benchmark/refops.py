"""Plain float32 building blocks of the references (models/*_ref.py):
norms, activations, RoPE, attention and a weight reader over the stored
blocks. Written from the architectures' published descriptions; imports
nothing of the program under test.

Every matrix product here runs in true float32: the references switch
TF32 off (``strict_f32``), or a float32 product on the H100 would round
its operands to 10 mantissa bits. Inside ``rounded(dtype)`` every
activation an op here produces is rounded to ``dtype``: the reference one
precision below the configurations' bf16, which the check's control puts
in the program's place.
"""

from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F

import ggml


@contextlib.contextmanager
def strict_f32():
    """TF32 off for matmuls and convolutions inside the block."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


_ROUND = None  # the rounding ``rounded`` sets, else None


@contextlib.contextmanager
def rounded(dtype):
    """Every activation of the ops below rounded to ``dtype`` (an 8-bit
    float: each row scaled to the type's largest value first, as an 8-bit
    path scales its tensors)."""
    global _ROUND
    top = float(torch.finfo(dtype).max)

    def rnd(x):
        s = x.abs().amax(dim=-1, keepdim=True).clamp(min=1e-30) / top
        return (x / s).to(dtype).to(x.dtype) * s

    saved, _ROUND = _ROUND, rnd
    try:
        yield
    finally:
        _ROUND = saved


def act(x: torch.Tensor) -> torch.Tensor:
    """``x`` as the current precision holds it (see ``rounded``)."""
    return x if _ROUND is None else _ROUND(x)


class Weights:
    """The stored weights, decoded to float32 on ``device`` when read.

    ``raw`` maps each key to (format, shape, stored array): GGUF blocks
    for a quantized format, the values themselves for F32 / F16. Nothing
    the program derived from them is read."""

    def __init__(self, raw: dict, device):
        self.raw = raw
        self.device = torch.device(device)

    def __call__(self, key: str) -> torch.Tensor:
        fmt, shape, data = self.raw[key]
        t = torch.from_numpy(data).to(self.device)
        return ggml.decode(fmt, t, shape)

    def get(self, key: str):
        return self(key) if key in self.raw else None


def linear(x, W: Weights, name: str) -> torch.Tensor:
    """x (..., K) @ W[name.weight]ᵀ + W[name.bias]."""
    y = x @ W(f"{name}.weight").t()
    b = W.get(f"{name}.bias")
    return act(y if b is None else y + b)


def layer_norm(x, weight=None, bias=None, eps: float = 1e-6):
    return act(F.layer_norm(x, (x.shape[-1],), weight, bias, eps))


def rms_norm(x, weight, eps: float = 1e-6):
    return act(x * torch.rsqrt(x.square().mean(dim=-1, keepdim=True) + eps)
               * weight)


def gelu_tanh(x):
    return act(F.gelu(x, approximate="tanh"))


def silu(x):
    return act(F.silu(x))


def timestep_embedding(t, dim: int = 256, max_period: float = 10_000.0):
    """Sinusoidal embedding of t·1000 (the BFL / Wan convention), cos|sin."""
    t = 1000.0 * t.to(torch.float32)
    half = dim // 2
    freqs = torch.exp(-math.log(max_period) * torch.arange(
        half, dtype=torch.float32, device=t.device) / half)
    args = t[:, None] * freqs[None]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


def rope_table(pos: torch.Tensor, axes_dim, theta: float = 10_000.0):
    """pos (L, n_axes) -> (cos, sin), each (L, D/2): axis i rotates d_i/2
    adjacent pairs at frequencies theta^(-2j/d_i)."""
    angs = []
    for i, d in enumerate(axes_dim):
        omega = 1.0 / (theta ** (torch.arange(
            0, d, 2, dtype=torch.float64, device=pos.device) / d))
        angs.append(pos[:, i].to(torch.float64)[:, None] * omega[None])
    ang = torch.cat(angs, dim=1)
    return torch.cos(ang).to(torch.float32), torch.sin(ang).to(torch.float32)


def apply_rope(x, cos, sin):
    """x (B, H, L, D): each adjacent pair (x0, x1) -> (x0 cos - x1 sin,
    x0 sin + x1 cos)."""
    x0, x1 = x[..., 0::2], x[..., 1::2]
    out = torch.stack([x0 * cos - x1 * sin, x0 * sin + x1 * cos], dim=-1)
    return out.flatten(-2)


def attention(q, k, v, score_elems: int = 1 << 29):
    """softmax(q kᵀ / sqrt(D)) v over (B, H, L, D), queries in chunks of at
    most ``score_elems`` scores, so that a long sequence's scores fit."""
    B, H, _, D = q.shape
    scale = 1.0 / math.sqrt(D)
    q_chunk = max(64, score_elems // (B * H * k.shape[2]))
    out = torch.empty_like(q)
    for s in range(0, q.shape[2], q_chunk):
        sc = (q[:, :, s:s + q_chunk] @ k.transpose(-1, -2)) * scale
        out[:, :, s:s + q_chunk] = torch.softmax(sc, dim=-1) @ v
    return act(out)


def heads(x, n: int):
    """(B, L, n*D) -> (B, n, L, D)."""
    B, L, W = x.shape
    return x.reshape(B, L, n, W // n).transpose(1, 2)


def unheads(x):
    B, H, L, D = x.shape
    return x.transpose(1, 2).reshape(B, L, H * D)
