"""CRLF → LF normalizer (CLI; PyTorch port of
comfyui_gguf_tpu/tools/fix_lines_ending.py): normalize text files in place.

Usage:  python -m comfyui_gguf_tpu_torch.tools.fix_lines_ending FILE [FILE...]
"""

from __future__ import annotations

import argparse


def fix_file(path: str) -> bool:
    """Returns True if the file was modified."""
    with open(path, "rb") as fh:
        data = fh.read()
    fixed = data.replace(b"\r\n", b"\n")
    if fixed == data:
        return False
    with open(path, "wb") as fh:
        fh.write(fixed)
    return True


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("files", nargs="+")
    args = ap.parse_args(argv)
    for f in args.files:
        print(f"{f}: {'fixed' if fix_file(f) else 'ok'}")


if __name__ == "__main__":
    main()
