"""The kernel-name -> family map the benchmark reads device traces with: a
frozen copy of the program's own map (``tools/read_trace.py``), so that the
yardstick stays fixed while the program changes, with three additions:
cuBLAS's ``nvjet`` GEMMs (Hopper) as dense GEMMs, convolutions as their own
family, and PyTorch's bundled attention kernels as attention.

Each family belongs to one class: ``linear`` (the quantized matmuls and
library GEMMs), ``attention``, ``conv``, or ``torch_ops`` (everything
else: elementwise, norms, RoPE, copies, memsets).
"""

from __future__ import annotations

import re

# (substring of the kernel name, family), first match wins: the program's
# kernels by their function names
KERNEL_FAMILIES = (
    ("qmm_wgmma_kernel", "K1/K2 qmm (wgmma)"),
    ("qmm_smallm_kernel", "K1/K2 qmm (split-K)"),
    ("qmm_smallm_fma_kernel", "K1/K2 qmm (split-K)"),
    ("qmm_simt_kernel", "K1/K2 qmm (f32 SIMT)"),
    ("gemm_wgmma_kernel", "K4 i8mm"),
    ("flash_fwd_kernel", "K7 flash_attn"),
    ("flash_tf32_kernel", "K7 flash_attn"),
    ("flash_wide_kernel", "K7 flash_attn"),
    ("i8attn_kernel", "K6 i8attn"),
    ("prep_reduce_kernel", "K6 prep"),
    ("prep_quant_kernel", "K6 prep"),
    ("prep_fold_kernel", "K6 prep"),
    ("prep_quant_wide_kernel", "K6 prep"),
)
# (regex on the lowercased name, family) for library kernels
LIBRARY_FAMILIES = (
    (r"fmha|flash_attn|efficient_attention|attention", "library attention"),
    (r"convolve|convolution|conv[123]d|fprop|dgrad|wgrad|implicit_gemm",
     "convolution"),
    (r"gemm|gemv|cutlass|xmma|nvjet", "dense GEMM (cuBLAS)"),
    (r"memset", "memset"),
    (r"memcpy|copy", "copy/memcpy"),
    (r"elementwise|reduce|softmax|norm", "elementwise/reduce"),
)
OTHER = "other"

CLASS = {
    "K1/K2 qmm (wgmma)": "linear", "K1/K2 qmm (split-K)": "linear",
    "K1/K2 qmm (f32 SIMT)": "linear", "K4 i8mm": "linear",
    "dense GEMM (cuBLAS)": "linear",
    "K7 flash_attn": "attention", "K6 i8attn": "attention",
    "K6 prep": "attention", "library attention": "attention",
    "convolution": "conv",
}


def family(name: str, cat: str = "kernel") -> str:
    if cat == "gpu_memcpy":
        return "copy/memcpy"
    if cat == "gpu_memset":
        return "memset"
    for key, fam in KERNEL_FAMILIES:
        if key in name:
            return fam
    low = name.lower()
    for pat, fam in LIBRARY_FAMILIES:
        if re.search(pat, low):
            return fam
    return OTHER


def klass(fam: str) -> str:
    return CLASS.get(fam, "torch_ops")
