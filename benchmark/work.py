"""The work a call needs, counted from its shapes: (FLOPs, bytes). Each
input byte is counted read once and each output byte written once,
whatever a kernel reads again. Every configuration here computes in bf16,
so every FLOP is counted at the bf16 peak and every activation at two
bytes, whichever path the program takes today."""

from __future__ import annotations

import ggml


def linear_work(m: int, k: int, r: int, fmt: str) -> tuple:
    """x (m, K) @ Wᵀ (K → R): the weight read once in its stored format
    (GGUF blocks, or F16 / F32 values), bf16 activations in and out."""
    return (2.0 * m * k * r, ggml.nbytes(fmt, r * k) + 2.0 * m * (k + r))


def attention_work(b: int, h: int, lq: int, lk: int, d: int) -> tuple:
    """softmax(q kᵀ) v in one kernel: QKᵀ and PV, q, k, v and the output
    in bf16."""
    return (4.0 * b * h * lq * lk * d, 2.0 * b * h * d * (2 * lq + 2 * lk))


def gemm_work(b: int, m: int, k: int, n: int) -> tuple:
    """A batched GEMM (b × (m, k) @ (k, n)) written out in the program
    (attention outside the kernels), bf16 operands."""
    return (2.0 * b * m * k * n, 2.0 * b * (m * k + k * n + m * n))


def conv_work(h: int, w: int, cin: int, cout: int, k: int) -> tuple:
    """A stride-1 'same' k × k convolution over an h × w image, bf16
    weight and activations."""
    return (2.0 * h * w * cin * cout * k * k,
            2.0 * (cout * cin * k * k + h * w * (cin + cout)))
