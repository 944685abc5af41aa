#!/usr/bin/env python3
"""Time the w8a8 matmul (K4), flash attention (K7) and int8 flash
attention (K6, with its prep kernel) at flux's shapes.

    python3 tools_i8mm_flash_cuda.py

K4 runs at both of its tile widths and with each epilogue the model uses
(none, bias, bias + GELU-tanh from a column), the width ``i8mm_plan`` picks
marked with ``*``, beside one ``torch._int_mm`` call on the same operands
in the TN form cuBLASLt's int8 path reads (s32 out, no epilogue). K7 runs at
the flux shapes beside ``scaled_dot_product_attention``. K6 runs in both
modes at head dims 128 and 256 beside its prep kernel, the plain prep
(``quantize_attn_inputs``) and SDPA. Every result is checked against the
plain version first (K4 within one bf16 ulp, K7 within 1e-2 relative L2,
K6 within 2e-3 of the plain version at its own key tile); times are CUDA
events around a CUDA graph of ten launches. The port never calls the
library functions timed here.
"""

from __future__ import annotations

import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

# name, M, K, R, GELU from this column (None: no GELU)
I8MM_SHAPES = [
    ("linear1", 4608, 3072, 21504, 9216),
    ("linear2", 4608, 15360, 3072, None),
    ("img qkv", 4096, 3072, 9216, None),
    ("img mlp.0", 4096, 3072, 12288, 0),
    ("txt qkv", 512, 3072, 9216, None),
    ("txt mlp.0", 512, 3072, 12288, 0),
]
# name, B, H, Lq, Lk, D
FLASH_SHAPES = [
    ("flux joint", 1, 24, 4608, 4608, 128),
    ("odd length D=64", 1, 24, 4250, 4250, 64),
    ("cross", 1, 24, 4096, 512, 128),
]
# name, B, H, L, D
I8ATTN_SHAPES = [
    ("flux joint", 1, 24, 4608, 128),
    ("gated odd", 1, 24, 4480, 128),
    ("D=256", 1, 12, 4608, 256),
]


def main() -> int:
    import torch

    from comfyui_gguf_tpu_torch._timing import graph_ms, rel_l2
    from comfyui_gguf_tpu_torch.gguf.constants import (
        GGMLQuantizationType as Q)
    from comfyui_gguf_tpu_torch.models.testing import random_planar
    from comfyui_gguf_tpu_torch.nn.attention import (flash_attn_cuda,
                                                     plain_attention)
    from comfyui_gguf_tpu_torch.ops.i8attn import (i8_attention_cuda_q,
                                                   kernel_block_kv,
                                                   plain_i8_attention_q,
                                                   plain_operands,
                                                   prep_cuda,
                                                   quantize_attn_inputs)
    from comfyui_gguf_tpu_torch.ops.i8mm import i8mm_cuda_q, plain_i8mm
    from comfyui_gguf_tpu_torch.ops.qmatmul import I8MM_WIDTHS, i8mm_plan
    from comfyui_gguf_tpu_torch.quant.i8 import quantize_rows, requantize_i8

    if not torch.cuda.is_available():
        print("tools_i8mm_flash_cuda: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"{smi}; torch {torch.__version__} CUDA {torch.version.cuda}")
    gen = torch.Generator(device="cuda").manual_seed(0)
    sdpa = torch.nn.functional.scaled_dot_product_attention

    print("K4 i8mm, ms by tile width (* = i8mm_plan's pick)")
    for name, M, K, R, act in I8MM_SHAPES:
        ip = requantize_i8(random_planar(Q.Q4_K, (R, K), gen,
                                         device="cuda"))
        x = torch.randn((M, K), generator=gen,
                        device="cuda").to(torch.bfloat16)
        bias = torch.randn((R,), generator=gen, device="cuda") * 0.1
        xq, xs = quantize_rows(x)
        pick = i8mm_plan(M, R)[0]
        epilogues = [("none", None, None), ("bias", bias, None)]
        if act is not None:
            epilogues.append((f"bias+gelu@{act}", bias, act))
        cells = []
        for ename, b, a in epilogues:
            want = plain_i8mm(x, ip, bias=b, act_from_col=a).float()
            for bn in I8MM_WIDTHS:
                got = i8mm_cuda_q(xq, xs, ip, bias=b, act_from_col=a,
                                  bn=bn).float()
                _, e = torch.frexp(torch.maximum(got.abs(), want.abs()))
                if bool(((got - want).abs()
                         > torch.ldexp(torch.ones_like(got), e - 8)).any()):
                    raise SystemExit(f"{name} {ename} bn={bn}: more than one "
                                     f"bf16 ulp from the plain version")
                ms = graph_ms([lambda b=b, a=a, bn=bn: i8mm_cuda_q(
                    xq, xs, ip, bias=b, act_from_col=a, bn=bn)])
                cells.append(f"{ename} bn={bn}{'*' if bn == pick else ''} "
                             f"{ms:.4f}")
        w_rk = ip.qs[:R, :K]
        lib = graph_ms([lambda: torch._int_mm(xq, w_rk.t())])
        print(f"  {name:10s} M={M} {K}->{R}: " + " | ".join(cells)
              + f" | _int_mm TN {lib:.4f}", flush=True)

    print("K7 flash attention, ms")
    for name, B, H, Lq, Lk, D in FLASH_SHAPES:
        q, k, v = (torch.randn((B, H, L, D), generator=gen,
                               device="cuda").to(torch.bfloat16)
                   for L in (Lq, Lk, Lk))
        scale = D ** -0.5
        err = rel_l2(flash_attn_cuda(q, k, v, scale),
                     plain_attention(q, k, v, scale))
        if not err <= 1e-2:
            raise SystemExit(f"{name}: rel L2 {err} from the plain version")
        ms = graph_ms([lambda: flash_attn_cuda(q, k, v, scale)])
        lib = graph_ms([lambda: sdpa(q, k, v, scale=scale)])
        print(f"  {name:16s} B={B} H={H} Lq={Lq} Lk={Lk} D={D}: {ms:.4f} "
              f"| sdpa {lib:.4f}", flush=True)

    print("K6 int8 flash attention (+ prep kernel), ms")
    for name, B, H, L, D in I8ATTN_SHAPES:
        q, k, v = (torch.randn((B, H, L, D), generator=gen,
                               device="cuda").to(torch.bfloat16)
                   for _ in range(3))
        k = k + 1.0
        scale = D ** -0.5
        for mode in ("pv", "qk"):
            pv = mode == "pv"
            ops = prep_cuda(q, k, v, scale=scale, pv_int8=pv)
            got = i8_attention_cuda_q(*ops, B=B, H=H, pv_int8=pv)
            want = plain_i8_attention_q(*plain_operands(*ops, pv_int8=pv),
                                        pv_int8=pv,
                                        block_kv=kernel_block_kv(D))
            err = rel_l2(got, want.to(torch.bfloat16).reshape(B, H, L, D))
            if not err <= 2e-3:
                raise SystemExit(f"K6 {name} {mode}: rel L2 {err} from the "
                                 f"plain version")
            ms = graph_ms([lambda: i8_attention_cuda_q(*ops, B=B, H=H,
                                                       pv_int8=pv)])
            prep = graph_ms([lambda: prep_cuda(q, k, v, scale=scale,
                                               pv_int8=pv)])
            plain = graph_ms([lambda: quantize_attn_inputs(
                q, k, v, scale, pv_int8=pv)])
            lib = graph_ms([lambda: sdpa(q, k, v, scale=scale)])
            print(f"  {name:10s} {mode} B={B} H={H} L={L} D={D}: {ms:.4f} "
                  f"+ prep {prep:.4f} (plain prep {plain:.4f}) | sdpa "
                  f"{lib:.4f}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
