"""GEMM rate probes (PyTorch port of the kernels of tools_i8_microbench.py).

Plain matmuls without quantization epilogues, to read what the tensor
cores reach on x (M, K) row-major times w:

* ``probe_bf16`` — bf16 x bf16 -> f32, cast to bf16 (the reference's
  ``make_plain`` at bf16); w (K, R) row-major, as the reference feeds it;
* ``probe_s8`` — s8 x s8 -> s32, cast to bf16, no scales (``make_plain`` at
  int8); w (R, K), K contiguous: the out-feature-major layout of the
  model's int8 weights (quant/i8.py) and the only B form s8 ``wgmma``
  reads, so ``out = x @ w.T``;
* ``probe_w8a8`` — s8 x s8 -> s32 on the same (R, K) w, then
  ``acc·xs[m]·ws[r]`` -> bf16 (``make_w8a8``); xs is (M, 1) or (M, n) with
  the scale in column 0.

Each is a wrapper of a hand-written CUDA kernel of ``csrc/gemm_probe.cu``
(K8: the persistent TMA + ``wgmma`` GEMM of the w8a8 matmul) with a block
tile of 128 x ``bn`` (128 or 256), and has a plain PyTorch version beside
it. A probe dispatches by device alone: CUDA tensors launch the kernel, CPU
tensors take the plain version.
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build

TILES = (128, 256)  # block-tile widths the kernels are instantiated for


def plain_probe_bf16(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """f32 matmul of the bf16 operands, cast to bf16."""
    return torch.matmul(x.to(torch.float32),
                        w.to(torch.float32)).to(torch.bfloat16)


def _int_product(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    # exact: a float64 matmul of the int8 operands (every partial sum
    # stays below 2^53), as the w8a8 plain version computes it
    return torch.matmul(x.to(torch.float64), w.to(torch.float64))


def plain_probe_s8(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Exact integer product x @ w.T (w (R, K)), cast s32 -> f32 -> bf16."""
    return _int_product(x, w.t()).to(torch.float32).to(torch.bfloat16)


def plain_probe_w8a8(x, w, xs, ws) -> torch.Tensor:
    """Exact integer product x @ w.T (w (R, K)), then (acc·xs[m])·ws[r] in
    f32 -> bf16."""
    acc = _int_product(x, w.t()).to(torch.float32)
    return (acc * xs[:, :1].to(torch.float32)
            * ws.reshape(1, -1).to(torch.float32)).to(torch.bfloat16)


def _check(x, w, dtype, bn):
    """(M, K, R) of a probe: w is (K, R) at bf16, (R, K) at s8."""
    kdim = 1 if dtype == torch.int8 else 0
    if x.dim() != 2 or w.dim() != 2 or x.shape[1] != w.shape[kdim]:
        raise ValueError(f"probe shapes {tuple(x.shape)} and w "
                         f"{tuple(w.shape)} ({'R, K' if kdim else 'K, R'})")
    if x.dtype != dtype or w.dtype != dtype:
        raise TypeError(f"probe operands must be {dtype}, got {x.dtype} and "
                        f"{w.dtype}")
    M, K = x.shape
    R = w.shape[1 - kdim]
    if bn not in TILES:
        raise ValueError(f"block tile width {bn}: have {TILES}")
    if M % 128 or K % 64 or R % 256:
        raise ValueError(f"probe kernels take M % 128 == 0, K % 64 == 0, "
                         f"R % 256 == 0; got ({M}, {K}, {R})")
    for t in (x, w):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("probe operands must be contiguous and 16-byte "
                             "aligned")
    return M, K, R


def probe_bf16(x: torch.Tensor, w: torch.Tensor, bn: int = 128):
    if not x.is_cuda:
        return plain_probe_bf16(x, w)
    M, K, R = _check(x, w, torch.bfloat16, bn)
    out = torch.empty((M, R), dtype=torch.bfloat16, device=x.device)
    rc = _build.lib().gemm_probe_bf16_launch(
        x.data_ptr(), w.data_ptr(), out.data_ptr(), M, K, R, bn,
        ctypes.c_void_p(_build.stream_handle(x.device)))
    _build.check(rc, "gemm_probe_bf16_launch")
    _build.count("gemm_probe_bf16")
    return out


def _launch_s8(x, w, xs, ws, bn, name):
    M, K, R = _check(x, w, torch.int8, bn)
    out = torch.empty((M, R), dtype=torch.bfloat16, device=x.device)
    rc = _build.lib().gemm_probe_s8_launch(
        x.data_ptr(), w.data_ptr(),
        None if xs is None else xs.data_ptr(),
        None if ws is None else ws.data_ptr(), out.data_ptr(), M, K, R,
        0 if xs is None else xs.stride(0), bn,
        ctypes.c_void_p(_build.stream_handle(x.device)))
    _build.check(rc, "gemm_probe_s8_launch")
    _build.count(name)
    return out


def probe_s8(x: torch.Tensor, w: torch.Tensor, bn: int = 128):
    if not x.is_cuda:
        return plain_probe_s8(x, w)
    return _launch_s8(x, w, None, None, bn, "gemm_probe_s8")


def probe_w8a8(x, w, xs, ws, bn: int = 128):
    if not x.is_cuda:
        return plain_probe_w8a8(x, w, xs, ws)
    M, R = x.shape[0], w.shape[0]
    if (xs.dtype != torch.float32 or xs.dim() != 2 or xs.shape[0] != M
            or xs.stride(1) != 1):
        raise ValueError(f"xs {xs.dtype} {tuple(xs.shape)}: want float32 "
                         f"({M}, n) with the scale in column 0")
    ws = ws.reshape(-1)
    if ws.dtype != torch.float32 or ws.shape[0] != R or not ws.is_contiguous():
        raise ValueError(f"ws {ws.dtype} {tuple(ws.shape)}: want float32 "
                         f"({R},)")
    return _launch_s8(x, w, xs, ws, bn, "gemm_probe_w8a8")
