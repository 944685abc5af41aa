"""Build and bind the port's hand-written CUDA kernels.

The sources under ``csrc/`` have a plain C interface. At first use they are
compiled with ``nvcc`` for ``sm_90a`` — one ``nvcc -c`` per source, all
started together — and linked into one shared library under ``_build/``
(git-ignored), named by a digest of the sources, flags and compiler so a
changed source or toolkit rebuilds and an unchanged one loads at once. The
library is loaded with ``ctypes``; pointers travel as ``c_void_p`` and
every entry returns ``cudaGetLastError()``, which ``check`` turns into an
exception.

Nothing here runs at import: the CPU tests import every module, and there
is no ``nvcc`` without the CUDA toolkit.

Each kernel wrapper also counts its launches here (``count``), so a run can
show that the main path went through the kernels.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
SOURCES = ("qmm.cu", "qmm_int8.cu", "qmm_lora.cu", "qmm_int8_lora.cu",
           "qmm_f16.cu", "qmm_int8_f16.cu", "qmm_lora_f16.cu",
           "qmm_int8_lora_f16.cu", "qmm_smallm.cu", "qmm_smallm_f16.cu",
           "qmm_smallm_f32.cu", "qmm_simt.cu", "i8mm.cu", "i8mm_lora.cu",
           "flash_attn.cu", "i8attn.cu", "i8attn_prep.cu", "gemm_probe.cu")
HEADERS = ("common.cuh", "qmm_common.cuh", "qmm_wgmma.cuh", "qmm_smallm.cuh",
           "gemm_wgmma.cuh", "tma.cuh")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC")

_VP = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    # x, qs, scales, offsets, bias, out, M, K, Kp, R, Rp, gs, zp, act_from,
    # token sub-tiles, stream
    "qmm_wgmma_nib4_launch": [_VP] * 6 + [_I] * 9 + [_VP],
    "qmm_wgmma_int8_launch": [_VP] * 6 + [_I] * 9 + [_VP],
    # the same with a K split over a cluster and the scale planes' type:
    # ..., act_from, token sub-tiles, K split, bf16 scales, stream
    "qmm_wgmma_nib4_split_launch": [_VP] * 6 + [_I] * 11 + [_VP],
    "qmm_wgmma_int8_split_launch": [_VP] * 6 + [_I] * 11 + [_VP],
    # x, qs, scales, offsets, bias, out, h, up, M, K, Kp, R, Rp, gs, zp,
    # rk, act_from, token sub-tiles, K split, bf16 scales, stream
    "qmm_wgmma_nib4_lora_launch": [_VP] * 8 + [_I] * 12 + [_VP],
    "qmm_wgmma_int8_lora_launch": [_VP] * 8 + [_I] * 12 + [_VP],
    # the f16 instances (f16 x, h and up; f32 out), arguments as above
    "qmm_wgmma_nib4_f16_launch": [_VP] * 6 + [_I] * 11 + [_VP],
    "qmm_wgmma_int8_f16_launch": [_VP] * 6 + [_I] * 11 + [_VP],
    "qmm_wgmma_nib4_f16_lora_launch": [_VP] * 8 + [_I] * 12 + [_VP],
    "qmm_wgmma_int8_f16_lora_launch": [_VP] * 8 + [_I] * 12 + [_VP],
    # the f32 body (f32 x, h and up; f32 out): x, qs, scales, offsets,
    # bias, out, [h, up,] M, K, Kp, R, Rp, gs, zp, [rk,] nib4, act_from,
    # bf16 scales, stream
    "qmm_simt_launch": [_VP] * 6 + [_I] * 10 + [_VP],
    "qmm_simt_lora_launch": [_VP] * 8 + [_I] * 11 + [_VP],
    # token sub-tiles, K split -> resident blocks of the wgmma body
    "qmm_wgmma_resident_blocks": [_I, _I],
    # x, qs, scales, offsets, bias, out, M, K, Kp, R, Rp, gs, zp, nib4,
    # act_from, K split, stream
    "qmm_smallm_launch": [_VP] * 6 + [_I] * 10 + [_VP],
    # the same and the scale planes' type (bf16 scales) before the stream
    "qmm_smallm_ex_launch": [_VP] * 6 + [_I] * 11 + [_VP],
    # x, qs, scales, offsets, bias, out, h, up, M, K, Kp, R, Rp, gs, zp, rk,
    # nib4, act_from, K split, bf16 scales, stream
    "qmm_smallm_lora_launch": [_VP] * 8 + [_I] * 12 + [_VP],
    # the f16 and f32 instances (x, h and up of that type; f32 out),
    # arguments as qmm_smallm_ex_launch / qmm_smallm_lora_launch
    "qmm_smallm_f16_launch": [_VP] * 6 + [_I] * 11 + [_VP],
    "qmm_smallm_f16_lora_launch": [_VP] * 8 + [_I] * 12 + [_VP],
    "qmm_smallm_f32_launch": [_VP] * 6 + [_I] * 11 + [_VP],
    "qmm_smallm_f32_lora_launch": [_VP] * 8 + [_I] * 12 + [_VP],
    # xq, xs, wq, ws, bias, out, M, K, Kp, R, Rp, out row stride,
    # act_from, tile width, stream
    "i8mm_launch": [_VP] * 6 + [_I] * 8 + [_VP],
    # xq, xs, wq, ws, bias, out, h, up, M, K, Kp, R, Rp, out row stride,
    # rk, act_from, tile width, stream
    "i8mm_lora_launch": [_VP] * 8 + [_I] * 9 + [_VP],
    # q, k, v, out, B, H, Lq, Lk, D, strides[12], scale, stream
    "flash_attn_launch": [_VP] * 4 + [_I] * 5
    + [ctypes.POINTER(ctypes.c_longlong), ctypes.c_float, _VP],
    # qq, qs, kq, ks, v, vs, out, B, H, Lq, Lk, Lkp, D, pv_int8,
    # strides[6], stream
    "i8attn_launch": [_VP] * 7 + [_I] * 7
    + [ctypes.POINTER(ctypes.c_longlong), _VP],
    # q, k, v, strides[9], B, H, Lq, Lk, Lkp, D, pv_int8, qscale, qq, qs,
    # kq, ks, vt, vs, scratch, n_chunks, stream
    "i8attn_prep_launch": [_VP] * 3 + [ctypes.POINTER(ctypes.c_longlong)]
    + [_I] * 7 + [ctypes.c_float] + [_VP] * 7 + [_I, _VP],
    # dynamic shared memory of a launch: tile width / head dim (and mode)
    "i8mm_smem_bytes": [_I],
    "flash_attn_smem_bytes": [_I],
    "i8attn_smem_bytes": [_I, _I],
    # x, w, out, M, K, R, bn, stream
    "gemm_probe_bf16_launch": [_VP] * 3 + [_I] * 4 + [_VP],
    # x, w, xs, ws, out, M, K, R, xs_stride, bn, stream
    "gemm_probe_s8_launch": [_VP] * 5 + [_I] * 5 + [_VP],
}

# launches per kernel since the last reset_launch_counts(); a "_lora" entry
# counts the launches of that kernel's LoRA instance (and only those), an
# "_f16" / "_f32" entry those of its f16 / f32 instances (the bf16 ones have
# no suffix; the f32 body of the fused dequant-matmul at M > 8 is
# "qmm_*_simt_f32"), a "flash_attn_d<D>" entry those of the flash kernel's
# head-dim-D instance (each also counts under "flash_attn")
LAUNCHES = {"qmm_nib4": 0, "qmm_int8": 0, "qmm_nib4_smallm": 0,
            "qmm_int8_smallm": 0, "i8mm": 0, "qmm_nib4_lora": 0,
            "qmm_int8_lora": 0, "qmm_nib4_smallm_lora": 0,
            "qmm_int8_smallm_lora": 0, "i8mm_lora": 0, "flash_attn": 0,
            "flash_attn_d40": 0, "flash_attn_d64": 0, "flash_attn_d80": 0,
            "flash_attn_d96": 0, "flash_attn_d128": 0,
            "flash_attn_d160": 0, "flash_attn_d256": 0,
            "flash_attn_d384": 0, "flash_attn_d512": 0,
            "i8attn_pv": 0, "i8attn_qk": 0, "i8attn_prep": 0,
            "gemm_probe_bf16": 0,
            "gemm_probe_s8": 0, "gemm_probe_w8a8": 0}
# the fused dequant-matmul's f16 / f32 instances: body -> its dtypes
_QMM_DTYPES = {"": ("_f16",), "_smallm": ("_f16", "_f32"),
               "_simt": ("_f32",)}
for _lay in ("nib4", "int8"):
    for _body, _dts in _QMM_DTYPES.items():
        for _dt in _dts:
            for _lora in ("", "_lora"):
                LAUNCHES[f"qmm_{_lay}{_body}{_lora}{_dt}"] = 0

# what the last build in this process did (read by chip_smoke.py)
BUILD_REPORT: dict = {}

_lock = threading.Lock()
_lib = None


def count(kernel: str) -> None:
    LAUNCHES[kernel] += 1


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def nvcc() -> str:
    """Path of nvcc: $CUDA_HOME/bin, /usr/local/cuda/bin, then $PATH."""
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").exists():
            return str(Path(root) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels build only "
                           "where the CUDA toolkit is installed")
    return found


def _digest(exe: str) -> str:
    """Digest of the sources, the flags and the compiler (its path and its
    ``--version``), so a new toolkit rebuilds."""
    version = subprocess.run([exe, "--version"], capture_output=True,
                             text=True, check=True).stdout
    h = hashlib.sha256(" ".join((exe, *NVCC_FLAGS, version)).encode())
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile every source in parallel and link the shared library;
    returns its path (an existing build of the same sources is reused)."""
    exe = nvcc()
    target = BUILD_DIR / f"libgguf_kernels_{_digest(exe)}.so"
    if target.exists():
        BUILD_REPORT.update(cached=True, path=str(target))
        return target
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    work = BUILD_DIR / f"tmp_{os.getpid()}_{threading.get_ident()}"
    work.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    procs = {}
    for src in SOURCES:
        obj = work / (src + ".o")
        cmd = [exe, *NVCC_FLAGS, "-Xptxas", "-v", "-c", str(CSRC / src),
               "-o", str(obj)]
        procs[src] = (obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    ptxas, errors = {}, []
    for src, (obj, p) in procs.items():
        out, err = p.communicate()
        ptxas[src] = [ln for ln in (out + err).splitlines()
                      if "ptxas" in ln or "registers" in ln
                      or "spill" in ln]
        if p.returncode != 0:
            errors.append(f"{src}:\n{out}{err}")
    if errors:
        raise RuntimeError("nvcc failed:\n" + "\n".join(errors))
    t_compile = time.perf_counter() - t0
    tmp_lib = work / "lib.so"
    link = subprocess.run(
        [exe, *NVCC_FLAGS, "-shared", "-o", str(tmp_lib),
         *[str(obj) for obj, _ in procs.values()]],
        capture_output=True, text=True)
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed:\n{link.stdout}{link.stderr}")
    os.replace(tmp_lib, target)
    shutil.rmtree(work, ignore_errors=True)
    BUILD_REPORT.update(cached=False, path=str(target),
                        compile_s=t_compile,
                        total_s=time.perf_counter() - t0, ptxas=ptxas)
    return target


def ptxas_entries(lines):
    """(kernel<template args>, "Used ..." text, spill text) per compiled
    entry of one source's ptxas lines (``BUILD_REPORT["ptxas"][src]``);
    the template arguments are the integers and booleans of the mangled
    name."""
    out, name, spill = [], None, ""
    for ln in lines:
        if "Compiling entry function" in ln:
            m = re.search(r"(?<=\d)([a-z][a-z_]*_kernel)I((?:L[bi]\d+E)+)E",
                          ln)
            args = re.findall(r"L[bi](\d+)E", m.group(2)) if m else []
            name = (m.group(1) + "<" + ",".join(args) + ">"
                    if m else ln.split("'")[1][:60])
        elif "spill" in ln:
            spill = ln.strip()
        elif "Used" in ln and name is not None:
            out.append((name, ln.split(":", 1)[1].strip(), spill))
            name, spill = None, ""
    return out


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    with _lock:
        if _lib is None:
            handle = ctypes.CDLL(str(build()))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(handle, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = handle
    return _lib


def check(rc: int, what: str) -> None:
    """Raise if a C entry reported a CUDA error (a refused launch never
    runs, and a later synchronize would not report it)."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc} at launch")


def stream_handle(device) -> int:
    import torch

    return torch.cuda.current_stream(device).cuda_stream


def is_row_aligned(t) -> bool:
    """Whether a 2-byte tensor's rows start on 16 bytes (unit stride along
    the last dim, base and other strides multiples of 16 bytes) and its
    other strides are non-zero: what the kernels' tensor maps step by."""
    return (t.stride(-1) == 1 and t.data_ptr() % 16 == 0
            and all(s % 8 == 0 and (s > 0 or n == 1)
                    for s, n in zip(t.stride()[:-1], t.shape[:-1])))


def row_aligned(t):
    """A view of tensor ``t`` that ``is_row_aligned``; a copy only where
    the given view is not."""
    return t if is_row_aligned(t) else t.contiguous()
