"""GGUF inspector: print (qtype, shape, name) for every tensor and a census
of the qtypes (CLI; PyTorch port of comfyui_gguf_tpu/tools/read_tensors.py,
the same text on stdout).

Usage:  python -m comfyui_gguf_tpu_torch.tools.read_tensors model.gguf [--all]
"""

from __future__ import annotations

import argparse
from collections import Counter

from ..gguf.constants import GGMLQuantizationType as Q
from ..gguf.reader import GGUFReader


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("path")
    ap.add_argument("--all", action="store_true",
                    help="include F32 tensors (reference hides them)")
    args = ap.parse_args(argv)

    reader = GGUFReader(args.path)
    arch = reader.get_str("general.architecture")
    print(f"arch: {arch}  version: {reader.version}  "
          f"tensors: {len(reader.tensors)}")
    census: Counter = Counter()
    for t in reader.tensors:
        census[t.qtype.name] += 1
        if t.qtype == Q.F32 and not args.all:
            continue
        print(f"{t.qtype.name:8s} {str(t.shape):24s} {t.name}")
    print("census: " + ", ".join(f"{k} ({v})" for k, v in census.items()))


if __name__ == "__main__":
    main()
