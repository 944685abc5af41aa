#!/usr/bin/env python3
"""A/B fingerprint of the port's unpatched fused-matmul kernels: one
checkout against another on one card.

Run from the root of a checkout on a machine with an NVIDIA H100:

    python3 tools_kernel_ab_cuda.py [--ref DIR]

Each fingerprint runs in a process of its own that imports the package of
one checkout: it builds the kernels, runs the unpatched launches of K1/K2
(both bodies), K4 (both tile widths) and the K8 probes at main-path shapes
on inputs made from fixed seeds, and records for each its time (CUDA
events over a CUDA graph) and a sha256 digest of its output bytes, with
the raw ``ptxas`` lines of the fused matmuls' sources (each fingerprint
builds the kernels afresh, in a temporary directory). Without ``--ref``
it fingerprints this checkout once; with it, DIR (another checkout, e.g.
the parent commit unpacked with ``git archive``) and this one in turns:
DIR, this, this, DIR. This process parses the ``ptxas`` lines with this
checkout's ``_build.ptxas_entries`` and prints each instance's registers
and spills, each row's times and whether the digests of the two checkouts
agree (the same bits). An instance that gained a last template argument
of 0 (the LoRA flag, off) counts as the same instance. The last lines are
the card's ``nvidia-smi`` name and power limit and one JSON object.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

HERE = os.path.dirname(os.path.abspath(__file__))
AB_SOURCES = ("qmm", "i8mm", "gemm_probe")


def fingerprint(root: str) -> int:
    """Run the rows with the package of checkout ``root``; print one JSON
    line: the rows and the raw ptxas lines."""
    sys.path.insert(0, root)
    import torch

    if not torch.cuda.is_available():
        print("tools_kernel_ab_cuda: no CUDA device", file=sys.stderr)
        return 1
    from comfyui_gguf_tpu_torch import _build
    from comfyui_gguf_tpu_torch._timing import graph_ms
    from comfyui_gguf_tpu_torch.gguf.constants import (
        GGMLQuantizationType as Q)
    from comfyui_gguf_tpu_torch.models.testing import random_planar
    from comfyui_gguf_tpu_torch.ops import gemm_probe as gp
    from comfyui_gguf_tpu_torch.ops.i8mm import i8mm_cuda_q
    from comfyui_gguf_tpu_torch.ops.qmatmul import I8MM_WIDTHS, qmm_cuda
    from comfyui_gguf_tpu_torch.quant.i8 import quantize_rows, requantize_i8

    # a fresh build in a directory of its own: a reused library has no
    # ptxas report
    _build.BUILD_DIR = Path(tempfile.mkdtemp(prefix="kernel_ab_"))
    _build.lib()
    shutil.rmtree(_build.BUILD_DIR, ignore_errors=True)
    ptxas = {src: lines for src, lines
             in _build.BUILD_REPORT.get("ptxas", {}).items()
             if src.startswith(AB_SOURCES)}
    dev = "cuda"
    gen = torch.Generator(device=dev).manual_seed(4321)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(
            torch.bfloat16)

    rows = {}

    def record(name, fn):
        out = fn()
        torch.cuda.synchronize()
        digest = hashlib.sha256(
            out.contiguous().view(torch.uint8).cpu().numpy().tobytes()
        ).hexdigest()[:16]
        rows[name] = dict(ms=graph_ms([fn]), sha256=digest)

    for name, qtype, M, K, R, act in (
            ("K1 split-K mod M=1 3072->18432 Q4_K", Q.Q4_K, 1, 3072, 18432,
             None),
            ("K1 wgmma qkv M=4096 3072->9216 Q4_K", Q.Q4_K, 4096, 3072,
             9216, None),
            ("K1 wgmma linear1 M=4608 3072->21504 gelu@9216", Q.Q4_K, 4608,
             3072, 21504, 9216),
            ("K2 split-K mod M=1 3072->18432 Q6_K", Q.Q6_K, 1, 3072, 18432,
             None),
            ("K2 wgmma T5 q M=512 4096->4096 Q8_0", Q.Q8_0, 512, 4096, 4096,
             None)):
        w = random_planar(qtype, (R, K), gen, device=dev)
        x = randn(M, K)
        bias = torch.randn(R, generator=gen, device=dev) * 0.1
        record(name, lambda: qmm_cuda(x, w, bias=bias, act_from_col=act))
    for name, M, K, R, act in (
            ("K4 linear1 M=4608 3072->21504 gelu@9216", 4608, 3072, 21504,
             9216),
            ("K4 linear2 M=4608 15360->3072", 4608, 15360, 3072, None),
            ("K4 txt qkv M=512 3072->9216", 512, 3072, 9216, None)):
        ip = requantize_i8(random_planar(Q.Q4_K, (R, K), gen, device=dev))
        xq, xs = quantize_rows(randn(M, K))
        bias = torch.randn(R, generator=gen, device=dev) * 0.1
        for bn in I8MM_WIDTHS:
            record(f"{name} bn={bn}", lambda: i8mm_cuda_q(
                xq, xs, ip, bias=bias, act_from_col=act, bn=bn))
    M, K, R = 4096, 3072, 12288
    x8 = torch.randint(-127, 128, (M, K), generator=gen, device=dev,
                       dtype=torch.int8)
    w8 = torch.randint(-127, 128, (R, K), generator=gen, device=dev,
                       dtype=torch.int8)
    xb, wb = randn(M, K), randn(K, R)
    for bn in gp.TILES:
        record(f"K8 bf16 bn={bn}", lambda: gp.probe_bf16(xb, wb, bn=bn))
        record(f"K8 s8 bn={bn}", lambda: gp.probe_s8(x8, w8, bn=bn))
    print(json.dumps({"rows": rows, "ptxas": ptxas}))
    return 0


def same_instance(ref: str, this: str) -> bool:
    return this == ref or this == ref[:-1] + ",0>"


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--ref", help="another checkout to compare this one "
                                  "with")
    ap.add_argument("--fingerprint", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.fingerprint:
        return fingerprint(args.fingerprint)

    sys.path.insert(0, HERE)
    from comfyui_gguf_tpu_torch._build import ptxas_entries

    ref = os.path.abspath(args.ref) if args.ref else None
    order = [ref, HERE, HERE, ref] if ref else [HERE]
    runs = []
    for root in order:
        p = subprocess.run([sys.executable, os.path.abspath(__file__),
                            "--fingerprint", root], capture_output=True,
                           text=True, timeout=900)
        if p.returncode != 0:
            print(p.stdout[-4000:] + p.stderr[-4000:], file=sys.stderr)
            return p.returncode
        runs.append((root, json.loads(p.stdout.strip().splitlines()[-1])))

    def entries(run):
        return {(src, name): (used, spill)
                for src, lines in sorted(run["ptxas"].items())
                for name, used, spill in ptxas_entries(lines)}

    mine = entries(runs[order.index(HERE)][1])
    for (src, name), (used, spill) in mine.items():
        print(f"ptxas {src} {name}: {used}; {spill}")
    verdict = {"this": HERE, "ref": ref, "rows": {}}
    if ref:
        theirs = entries(runs[0][1])
        same = True
        for (src, name), got in theirs.items():
            match = [v for (s, n), v in mine.items()
                     if s == src and same_instance(name, n)]
            ok = match == [got]
            same = same and ok
            print(f"ptxas {src} {name} in {ref}: {got[0]}; {got[1]} -> "
                  f"{'same' if ok else 'DIFFERS'} here")
        verdict["ptxas_same"] = same
    for name in runs[0][1]["rows"]:
        by_root = {}
        for root, run in runs:
            by_root.setdefault(root, []).append(run["rows"][name])
        times = {r: [v["ms"] for v in vs] for r, vs in by_root.items()}
        digests = {v["sha256"] for vs in by_root.values() for v in vs}
        verdict["rows"][name] = dict(ms=times, same_bits=len(digests) == 1,
                                     sha256=sorted(digests))
        print(f"{name}: " + "; ".join(
            f"{os.path.basename(r)} " + " ".join(f"{t:.4f}" for t in ts)
            + " ms" for r, ts in times.items())
            + f"; {'same bits' if len(digests) == 1 else 'BITS DIFFER'}")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0])
    print(json.dumps(verdict))
    return 0


if __name__ == "__main__":
    sys.exit(main())
