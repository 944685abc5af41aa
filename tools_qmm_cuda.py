#!/usr/bin/env python3
"""Sweep the launch parameters of the fused dequant-matmul kernels (K1/K2).

    python3 tools_qmm_cuda.py

``ops/qmatmul.py`` picks three things from the shape alone: the number of
128-token sub-tiles of a wgmma output tile (``wgmma_plan``: 1 or 2), the
K split of the bf16 split-K body (``smallm_plan``: 1..8) and that of the
f32 split-K body (``smallm_f32_plan``, whose ``_SMALLM_F32_SPLIT_COST`` was
fitted to this sweep). This tool times every
choice at the main paths' shapes on the card (CUDA events around a CUDA
graph, enough weight copies to keep the L2 cold where a model would find it
cold), checks each result against the plain version, and marks the choice
the wrapper makes, so the two rules can be held against measurement. It
calls the C entries directly; the port's own code always goes through
``qmm_cuda``.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

# name, format, M, K, R, weight copies
WGMMA_SHAPES = [
    ("flux linear1", "Q4_K", 4608, 3072, 21504, 1),
    ("flux img qkv", "Q4_K", 4096, 3072, 9216, 1),
    ("Q8_0 3072->3072", "Q8_0", 4608, 3072, 3072, 1),
    ("Q6_K 3072->3072", "Q6_K", 4608, 3072, 3072, 1),
    ("T5 wi", "Q8_0", 512, 4096, 10240, 2),
    ("T5 wo", "Q8_0", 512, 10240, 4096, 2),
    ("T5 q/k/v/o", "Q8_0", 512, 4096, 4096, 4),
    ("M=9 modulation", "Q4_K", 9, 3072, 18432, 2),
]
SMALLM_SHAPES = [
    ("double-block modulation M=1", "Q4_K", 1, 3072, 18432, 4),
    ("double-block modulation M=8", "Q4_K", 8, 3072, 18432, 4),
    ("single-block modulation M=1", "Q4_K", 1, 3072, 9216, 6),
    ("Q6_K modulation M=1", "Q6_K", 1, 3072, 18432, 2),
]
# the f32 split-K body (dequant_dtype float32) at flux's modulations
SMALLM_F32_SHAPES = [
    ("double-block modulation M=1", "Q4_K", 1, 3072, 18432, 4),
    ("double-block img_mod M=1", "Q8_0", 1, 3072, 18432, 2),
    ("double-block modulation M=2", "Q4_K", 2, 3072, 18432, 4),
    ("single-block modulation M=1", "Q4_K", 1, 3072, 9216, 6),
]


def main() -> int:
    import torch

    from comfyui_gguf_tpu_torch import _build
    from comfyui_gguf_tpu_torch._timing import graph_ms, rel_l2
    from comfyui_gguf_tpu_torch.gguf.constants import (
        GGMLQuantizationType as Q)
    from comfyui_gguf_tpu_torch.models.testing import random_planar
    from comfyui_gguf_tpu_torch.ops.qmatmul import (plain_quantized_matmul,
                                                    smallm_f32_plan,
                                                    smallm_f32_smem,
                                                    smallm_plan, wgmma_plan)

    if not torch.cuda.is_available():
        print("tools_qmm_cuda: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"{smi}; torch {torch.__version__} CUDA {torch.version.cuda}")
    lib = _build.lib()
    gen = torch.Generator(device="cuda").manual_seed(0)

    def launch(x, pq, *, nt=None, split=None, f32_split=None):
        R, K = pq.shape
        nib4 = pq.layout == "nib4"
        kp = pq.padded_in
        out = torch.empty((x.shape[0], R), dtype=x.dtype, device="cuda")
        ptrs = (x.data_ptr(), pq.qs.data_ptr(), pq.scales.data_ptr(),
                None if pq.offsets is None else pq.offsets.data_ptr(), None,
                out.data_ptr())
        dims = (x.shape[0], K, kp, R, pq.padded_out, pq.group_size,
                int(pq.zero_point))
        stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
        if f32_split is not None:
            mt = smallm_f32_plan(x.shape[0], kp, R, nib4)[0]
            rc = lib.qmm_smallm_f32_launch(
                *ptrs, *dims, int(nib4), -1, mt, f32_split,
                smallm_f32_smem(kp, nib4, f32_split, mt), 0, stream)
        elif split is None:
            fn = (lib.qmm_wgmma_nib4_launch if nib4
                  else lib.qmm_wgmma_int8_launch)
            rc = fn(*ptrs, *dims, -1, nt, stream)
        else:
            rc = lib.qmm_smallm_launch(*ptrs, *dims, int(nib4), -1, split,
                                       stream)
        _build.check(rc, "qmm launch")
        return out

    def sweep(shapes, key, values, chosen, dt=torch.bfloat16, tol=5e-3):
        for name, fmt, M, K, R, copies in shapes:
            ws = [random_planar(Q[fmt], (R, K), gen, device="cuda")
                  for _ in range(copies)]
            x = torch.randn((M, K), generator=gen, device="cuda").to(dt)
            want = plain_quantized_matmul(x, ws[0], dequant_dtype=dt)
            pick = chosen(M, ws[0])
            cells = []
            for v in values:
                code_rows = ws[0].qs.shape[0]
                if key != "nt" and code_rows % (16 * v):
                    continue
                err = rel_l2(launch(x, ws[0], **{key: v}), want)
                if not err <= tol:
                    raise SystemExit(f"{name} {key}={v}: rel L2 {err}")
                ms = graph_ms([lambda w=w: launch(x, w, **{key: v})
                               for w in ws])
                cells.append(f"{key}={v}{'*' if v == pick else ''} "
                             f"{ms:.4f} ms")
            print(f"{name:30s} {fmt} M={M} {K}->{R}: " + " | ".join(cells),
                  flush=True)

    print("wgmma body, 128-token sub-tiles a tile (* = wgmma_plan's pick)")
    sweep(WGMMA_SHAPES, "nt", (1, 2),
          lambda M, pq: wgmma_plan(M, pq.shape[0])[0])
    print("split-K body, cluster size along K (* = smallm_plan's pick)")
    sweep(SMALLM_SHAPES, "split", (1, 2, 3, 4, 6, 8),
          lambda M, pq: smallm_plan(M, pq.padded_in, pq.shape[0],
                                    pq.layout == "nib4")[0])
    print("f32 split-K body, cluster size along K "
          "(* = smallm_f32_plan's pick)")
    torch.backends.cuda.matmul.allow_tf32 = False  # the plain version in f32
    sweep(SMALLM_F32_SHAPES, "f32_split", (1, 2, 3, 4, 6, 8),
          lambda M, pq: smallm_f32_plan(M, pq.padded_in, pq.shape[0],
                                        pq.layout == "nib4")[1],
          torch.float32, 1e-5)
    return 0


if __name__ == "__main__":
    sys.exit(main())
