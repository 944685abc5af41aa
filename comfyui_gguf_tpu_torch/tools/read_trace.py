"""Summarize a torch.profiler Chrome trace: device time by kernel family
(CLI; the PyTorch port's counterpart of comfyui_gguf_tpu/tools/read_xplane.py).

Usage: python -m comfyui_gguf_tpu_torch.tools.read_trace <trace.json or dir> [top_n]

Reads the ``trace.json`` that ``observability.trace`` writes and prints the
total duration, call count and share of each kernel family on the card
(the hand-written kernels K1/K2, K4, K6, K7 by body, cuBLAS/cutlass GEMMs,
PyTorch's elementwise and reduction kernels, copies, memsets, the rest),
with an example kernel name. ``module_ms`` gives the device time of each
``observability.annotate`` / ``record_function`` region. ``chip_smoke.py``
keys its per-forward breakdown on ``_label``, so one map names the kernels.
"""

from __future__ import annotations

import glob
import json
import os
import re
import sys

# trace categories of work on the card: kernels, copies, memsets
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
# category of an annotated region's span on the card's timeline
REGION_CATS = ("gpu_user_annotation",)

# (substring of the kernel name, family), first match wins: the port's
# kernels by the function names in csrc/
_KERNEL_FAMILIES = (
    ("qmm_wgmma_kernel", "K1/K2 qmm (wgmma)"),
    ("qmm_smallm_kernel", "K1/K2 qmm (split-K)"),
    ("qmm_simt_kernel", "K1/K2 qmm (f32 SIMT)"),
    ("gemm_wgmma_kernel", "K4 i8mm"),
    ("flash_fwd_kernel", "K7 flash_attn"),
    ("i8attn_kernel", "K6 i8attn"),
    ("prep_reduce_kernel", "K6 prep"),
    ("prep_quant_kernel", "K6 prep"),
    ("prep_fold_kernel", "K6 prep"),
    ("prep_quant_wide_kernel", "K6 prep"),
)
# (regex on the lowercased name, family) for library kernels
_LIBRARY_FAMILIES = (
    (r"gemm|gemv|cutlass|xmma", "dense GEMM (cuBLAS)"),
    (r"memset", "memset"),
    (r"memcpy|copy", "copy/memcpy"),
    (r"elementwise|reduce|softmax|norm", "elementwise/reduce"),
)
OTHER = "other"
# the families that are not kernels of the port or dense GEMMs
NON_KERNEL_FAMILIES = ("elementwise/reduce", "copy/memcpy", "memset", OTHER)

# the layout of a K1/K2 instance: its first template argument (NIB4),
# demangled ("<true, ...") or mangled ("ILb1E")
_NIB4_ARG = re.compile(r"qmm_\w+_kernel(?:<\s*(true|false)|ILb([01])E)")


def _find_trace(path: str) -> str:
    if os.path.isfile(path):
        return path
    hits = sorted(glob.glob(os.path.join(path, "**", "*.json"),
                            recursive=True), key=os.path.getmtime)
    if not hits:
        raise FileNotFoundError(f"no trace .json under {path}")
    return hits[-1]  # latest capture


def _label(name: str, layouts: bool = False) -> str:
    """Collapse a CUDA kernel name to its family. ``layouts``: K1/K2
    families name the layout of the instance, "K1" (nib4) or "K2" (int8),
    where the name shows it."""
    for key, fam in _KERNEL_FAMILIES:
        if key in name:
            if layouts and fam.startswith("K1/K2"):
                m = _NIB4_ARG.search(name)
                if m:
                    nib4 = (m.group(1) or m.group(2)) in ("true", "1")
                    fam = ("K1" if nib4 else "K2") + fam[len("K1/K2"):]
            return fam
    low = name.lower()
    for pat, fam in _LIBRARY_FAMILIES:
        if re.search(pat, low):
            return fam
    return OTHER


def _events(path: str):
    with open(_find_trace(path)) as f:
        data = json.load(f)
    evs = data["traceEvents"] if isinstance(data, dict) else data
    return [e for e in evs if e.get("ph") == "X"]


def summarize(path: str, top_n: int = 20, cats=DEVICE_CATS,
              layouts: bool = False) -> list[dict]:
    """Rows {"op", "ms", "count", "share", "example"} by family, longest
    first; shares are of the total over every family (not only the rows
    shown). ``cats``: the trace categories summed (the card's kernels,
    copies and memsets by default)."""
    rows: dict[str, dict] = {}
    for e in _events(path):
        cat = e.get("cat", "")
        if cat not in cats:
            continue
        name = e.get("name", "?")
        lab = ("copy/memcpy" if cat == "gpu_memcpy"
               else "memset" if cat == "gpu_memset"
               else _label(name, layouts))
        r = rows.setdefault(lab, {"op": lab, "ms": 0.0, "count": 0,
                                  "example": name[:100]})
        r["ms"] += float(e.get("dur", 0.0)) / 1e3
        r["count"] += 1
    out = sorted(rows.values(), key=lambda r: -r["ms"])
    total = sum(r["ms"] for r in out)
    for r in out:
        r["share"] = r["ms"] / total if total else 0.0
    return out[:top_n]


def module_ms(path: str, cats=REGION_CATS) -> dict[str, tuple[float, int]]:
    """Time per annotated region on the card's timeline (the span of its
    kernels): {region name: (total ms, times it ran)}. ``cats``: the trace
    categories read (the regions' device-side spans by default)."""
    out: dict[str, list] = {}
    for e in _events(path):
        if e.get("cat", "") not in cats:
            continue
        r = out.setdefault(e.get("name", "?"), [0.0, 0])
        r[0] += float(e.get("dur", 0.0)) / 1e3
        r[1] += 1
    return {k: (v[0], v[1]) for k, v in out.items()}


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    if not argv:
        print(__doc__)
        return 1
    top_n = int(argv[1]) if len(argv) > 1 else 20
    rows = summarize(argv[0], top_n)
    # grand total over all families (shares were computed against it), not
    # the truncated display
    total = (rows[0]["ms"] / rows[0]["share"]
             if rows and rows[0]["share"] else 0.0)
    shown = sum(r["ms"] for r in rows)
    print(f"{'op':<24}{'ms':>10}{'calls':>8}{'share':>8}  example")
    for r in rows:
        print(f"{r['op']:<24}{r['ms']:>10.2f}{r['count']:>8}"
              f"{r['share']:>8.1%}  {r['example'][:60]}")
    print(f"{'TOTAL (all ops)':<24}{total:>10.2f}   shown {shown:.2f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
