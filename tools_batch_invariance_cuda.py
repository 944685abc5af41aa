#!/usr/bin/env python3
"""Check that a UNet forward gives each sample the same bits at every batch
size, and time what that costs.

    python3 tools_batch_invariance_cuda.py [--batch N]

The convolutions, group norms and dense matmuls of ``nn/layers.py`` run
each sample alone (``_each_sample``): cuDNN, cuBLAS and the reduction
kernels pick their algorithm by the whole tensor's shape, so a batched
call sums a sample in another order, and through a CFG-mixed UNet step a
served request would depend on the batch it shares. This tool builds
SDXL at its published dims (seed-made Q4_K, then ``requantize_i8()``),
runs one forward at batch N (default 4) and the first sample alone, and
reports whether the two agree bit for bit and the forward's time; then the
same with ``_each_sample`` bypassed (the batched calls), for comparison.
Times are host seconds around synchronized forwards (two warm-ups, mean of
three), on one card.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--batch", type=int, default=4)
    args = ap.parse_args()

    import torch

    from comfyui_gguf_tpu_torch._timing import rel_l2
    from comfyui_gguf_tpu_torch.gguf.constants import (
        GGMLQuantizationType as Q)
    from comfyui_gguf_tpu_torch.models import testing, unet
    from comfyui_gguf_tpu_torch.nn import layers
    from comfyui_gguf_tpu_torch.nn.layers import QuantConfig
    from comfyui_gguf_tpu_torch.pipeline import DiffusionModel

    if not torch.cuda.is_available():
        print("tools_batch_invariance_cuda: no CUDA device", file=sys.stderr)
        return 1
    dev = "cuda"
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"{torch.cuda.get_device_name(0)}; nvidia-smi: {smi}")

    params = testing.sdxl_random_params(testing.SDXL_DIMS, qtype=Q.Q4_K,
                                        seed=0, device=dev)
    model = DiffusionModel(arch="sdxl", params=params,
                           config=unet.UNetConfig.from_state_dict(params),
                           qcfg=QuantConfig(),
                           device=torch.device(dev)).requantize_i8()
    B = args.batch
    g = torch.Generator(device=dev).manual_seed(1)
    x = torch.randn((B, 128, 128, 4), generator=g, device=dev).bfloat16()
    ctx = torch.randn((B, 77, 2048), generator=g, device=dev).bfloat16()
    y = torch.randn((B, 2816), generator=g, device=dev).bfloat16()
    t = torch.linspace(999.0, 100.0, B, device=dev)

    def forward(n):
        return model.forward(x[:n], t[:n], ctx[:n], y[:n])

    def seconds(n):
        for _ in range(2):
            forward(n)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(3):
            forward(n)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / 3

    each_sample = layers._each_sample
    try:
        for mode in ("per sample", "batched"):
            if mode == "batched":
                layers._each_sample = lambda fn, a, *r, **k: fn(a, *r, **k)
            with torch.no_grad():
                both = forward(B)[:1].float()
                one = forward(1).float()
                torch.cuda.synchronize()
                s_b, s_1 = seconds(B), seconds(1)
            print(f"{mode}: sample 0 at batch {B} vs alone: bits equal "
                  f"{torch.equal(both, one)}, rel L2 {rel_l2(both, one):.3e};"
                  f" forward at batch {B} {s_b * 1e3:.1f} ms, at batch 1 "
                  f"{s_1 * 1e3:.1f} ms ({s_b / B * 1e3:.1f} ms a sample)")
    finally:
        layers._each_sample = each_sample
    return 0


if __name__ == "__main__":
    sys.exit(main())
