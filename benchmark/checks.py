"""What the drivers' checks share: keeping a sample of a layer call's
operands and output on the timed path, the plain float32 reference of
that call, and the exact test of a sampler update."""

from __future__ import annotations

import math
import sys
import time

import torch
import torch.nn.functional as F

import refops

CONV_ROWS = 4  # output rows of a convolution kept (a band, all columns)


class SetupClock:
    """The phases of a driver's set-up: each ``mark`` logged to standard
    error and kept in ``marks`` as seconds since the clock started (the
    run's result carries them, so a spread in ``setup_s`` shows its
    phase)."""

    def __init__(self):
        self.t0 = time.perf_counter()
        self.marks: dict = {}

    def mark(self, phase: str, msg: str) -> None:
        t = time.perf_counter() - self.t0
        self.marks[phase] = t
        print(f"[setup {t:7.2f}s] {msg}", file=sys.stderr, flush=True)


def rel(a, b) -> float:
    a, b = a.double(), b.double()
    return float((a - b).norm() / b.norm().clamp(min=1e-30))


def patchify(latent: torch.Tensor) -> torch.Tensor:
    """(B, H, W, C) -> (B, H/2 · W/2, C · 4) 2 × 2 patch tokens."""
    B, H, W, C = latent.shape
    x = latent.reshape(B, H // 2, 2, W // 2, 2, C)
    return x.permute(0, 1, 3, 5, 2, 4).reshape(B, (H // 2) * (W // 2), 4 * C)


def _rows(s, n: int, k: int) -> torch.Tensor:
    idx = sorted(int(i) for i in s.rng.choice(n, size=min(n, k),
                                              replace=False))
    return torch.as_tensor(idx, device=s.device)


def keep_call(s, name, args, kw, out) -> dict:
    """A sample of one layer call (drawn from ``s.rng``): ``check_rows``
    rows of a linear, as many query rows of 2 heads of one lane's
    attention, a band of ``CONV_ROWS`` output rows of a convolution with
    the input rows it reads; ``key`` is the weight's stored key
    (``s.keys`` by data pointer; None for a weight the file does not
    hold)."""
    rows = s.traffic["check_rows"]
    if name == "dot_product_attention":
        q, k, v = args[:3]
        scale = kw.get("scale", args[3] if len(args) > 3 else None)
        b = int(s.rng.integers(q.shape[0]))
        h = _rows(s, q.shape[1], 2)
        r = _rows(s, q.shape[2], rows)
        return {"q": q[b][h][:, r].clone(), "k": k[b][h].clone(),
                "v": v[b][h].clone(), "out": out[b][h][:, r].clone(),
                "scale": scale}
    w = args[1]
    key = s.keys.get((w.qs if hasattr(w, "qs") else w).data_ptr())
    bias = kw.get("bias", args[2] if len(args) > 2 else None)
    if name == "conv2d":
        x = args[0]
        kh, pad = w.shape[2], kw.get("padding", 0)
        r0 = int(s.rng.integers(out.shape[1] - CONV_ROWS + 1))
        lo, hi = r0 - pad, r0 + CONV_ROWS - 1 - pad + kh
        band = x[:1, max(lo, 0):min(hi, x.shape[1])]
        band = F.pad(band, (0, 0, 0, 0, max(0, -lo),
                            max(0, hi - x.shape[1])))
        return {"key": key, "bias": bias is not None, "pad": pad,
                "x": band.clone(), "out": out[:1, r0:r0 + CONV_ROWS].clone()}
    x2, o2 = args[0].reshape(-1, args[0].shape[-1]), \
        out.reshape(-1, out.shape[-1])
    r = _rows(s, x2.shape[0], rows)
    return {"key": key, "bias": bias is not None,
            "gelu_from": (kw.get("tail_from", 0)
                          if name == "linear_gelu" else None),
            "x": x2[r].clone(), "out": o2[r].clone()}


def op_gap(W, kind, rec) -> float:
    """The kept call's output against the f32 reference of the call on
    the same operands, the weight decoded from the stored blocks."""
    f32 = torch.float32
    if kind == "attention":
        q, k, v = (rec[n].to(f32) for n in ("q", "k", "v"))
        scale = rec["scale"] or 1.0 / math.sqrt(q.shape[-1])
        p = torch.softmax((q @ k.transpose(-1, -2)) * scale, dim=-1)
        return rel(rec["out"], p @ v)
    key = rec["key"]
    bias = W(key[: -len("weight")] + "bias") if rec["bias"] else None
    if kind == "conv":
        y = F.conv2d(rec["x"].to(f32).permute(0, 3, 1, 2), W(key), bias,
                     padding=(0, rec["pad"]))
        return rel(rec["out"], y.permute(0, 2, 3, 1))
    y = rec["x"].to(f32) @ W(key).reshape(-1, rec["x"].shape[-1]).t()
    if bias is not None:
        y = y + bias
    if rec["gelu_from"] is not None:
        t = rec["gelu_from"]
        y = torch.cat([y[:, :t], refops.gelu_tanh(y[:, t:])], dim=1)
    return rel(rec["out"], y)


def update_miss(x, x_next, s_cur, s_next, v, mag) -> int:
    """Values of ``x_next`` that are not the nearest of their type to x +
    (s_next - s_cur)·v (v and its magnitudes ``mag`` in float64; the
    sigmas per lane, subtracted in float32 as the sampler does), beyond
    float32's own rounding of the sum."""
    ds = (s_next - s_cur).to(torch.float32).double()
    ds = ds.reshape(-1, *([1] * (v.ndim - 1)))
    xd = x.double()
    want = xd + ds * v
    fi = torch.finfo(x_next.dtype)
    o = x_next.double()
    ulp = torch.exp2(torch.floor(torch.log2(o.abs().clamp(min=fi.tiny)))) \
        * fi.eps
    slack = 2.0 ** -21 * (xd.abs() + ds.abs() * mag)
    return int(((o - want).abs() > 0.5 * ulp + slack).sum())
