#!/usr/bin/env python3
"""Microbenchmark: int8 vs bf16 tensor-core GEMM rate on this card.

The CUDA counterpart of ``tools_i8_microbench.py``: the same problem
(M 4096, K 3072, R 12288) and the same variants by name, run through the
hand-written probe kernels of ``comfyui_gguf_tpu_torch/csrc/gemm_probe.cu``
(the persistent TMA + ``wgmma`` GEMM of the w8a8 matmul). x is (M, K)
row-major; w is (K, R) row-major at bf16, as the reference feeds it, and
(R, K) K-contiguous at s8, the model's int8 weight layout and the only B
form s8 ``wgmma`` reads:

  * bf16 x bf16 -> f32 baseline
  * s8 x s8 -> s32, no scales (raw integer rate)
  * w8a8 epilogue-rescale: s32 sum over K, one per-row (xs) x per-column
    (ws) f32 rescale at the end — the shape of ops/i8mm.py's kernel
  * the same with xs as (M, 1) instead of (M, 128)

each at both block-tile widths the kernels are built for (bn = 128, 256).
Where the reference varies the K tile, this one varies the block tile: the
CUDA kernels walk K in fixed 128-byte steps.

Run from the root of a checkout on a machine with an NVIDIA GPU and nvcc:

    python3 tools_i8_microbench_cuda.py

Each variant is first held against its plain PyTorch version (exactly equal
for the integer variants, relative L2 <= 5e-3 for bf16), then timed with
CUDA events around a CUDA graph of 10 launches. One line per variant with
milliseconds and T(FL)OP/s; the last two lines time the library calls
``torch.matmul`` (bf16) and ``torch._int_mm`` (s8 -> s32, no bf16 cast, B
in the TN form cuBLASLt's int8 path reads) on the same operands as
yardsticks. The card's name and power limit head the output, since the
rates depend on the limit.
"""

from __future__ import annotations

import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
M, K, R = 4096, 3072, 12288


def main() -> int:
    sys.path.insert(0, HERE)
    import torch

    from comfyui_gguf_tpu_torch._timing import graph_ms, rel_l2
    from comfyui_gguf_tpu_torch.ops import gemm_probe as gp

    if not torch.cuda.is_available():
        print("tools_i8_microbench_cuda: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"{smi}; torch {torch.__version__} CUDA {torch.version.cuda}; "
          f"M={M} K={K} R={R}", flush=True)

    gen = torch.Generator(device="cuda").manual_seed(0)
    xb = torch.randn((M, K), generator=gen, device="cuda").bfloat16()
    wb = torch.randn((K, R), generator=gen, device="cuda").bfloat16()
    x8 = torch.randint(-127, 128, (M, K), generator=gen, device="cuda",
                       dtype=torch.int8)
    w8 = torch.randint(-127, 128, (R, K), generator=gen, device="cuda",
                       dtype=torch.int8)
    xs = torch.rand((M, 128), generator=gen, device="cuda") * 1e-3 + 1e-3
    xs1 = xs[:, :1].contiguous()
    ws = torch.rand((1, R), generator=gen, device="cuda") * 1e-3 + 1e-3
    ops = 2.0 * M * K * R

    want_bf16 = gp.plain_probe_bf16(xb, wb)
    want_s8 = gp.plain_probe_s8(x8, w8)
    want_w8a8 = gp.plain_probe_w8a8(x8, w8, xs, ws)
    failed = []

    def run(tag, fn, want, exact):
        got = fn()
        torch.cuda.synchronize()
        ok = (torch.equal(got, want) if exact
              else rel_l2(got, want) <= 5e-3)
        if not ok:
            failed.append(tag)
        ms = graph_ms([fn])
        print(f"{tag:28s}: {ms:7.3f} ms  {ops / ms / 1e9:6.1f} T/s  "
              f"{'ok' if ok else 'DISAGREES with its plain version'}",
              flush=True)

    for bn in gp.TILES:
        run(f"bf16 bn={bn}", lambda: gp.probe_bf16(xb, wb, bn=bn),
            want_bf16, False)
        run(f"s8 raw bn={bn}", lambda: gp.probe_s8(x8, w8, bn=bn),
            want_s8, True)
        run(f"w8a8 rescale bn={bn}",
            lambda: gp.probe_w8a8(x8, w8, xs, ws, bn=bn), want_w8a8, True)
        run(f"w8a8 rescale xs1 bn={bn}",
            lambda: gp.probe_w8a8(x8, w8, xs1, ws, bn=bn), want_w8a8, True)
    for tag, fn in (("library torch.matmul bf16", lambda: torch.matmul(xb, wb)),
                    ("library torch._int_mm s8",
                     lambda: torch._int_mm(x8, w8.t()))):
        ms = graph_ms([fn])
        print(f"{tag:28s}: {ms:7.3f} ms  {ops / ms / 1e9:6.1f} T/s",
              flush=True)
    if failed:
        print(f"FAILED: {failed}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
