"""Re-inject >4-D tensors into a quantized GGUF (CLI; PyTorch port of
comfyui_gguf_tpu/tools/fix_5d_tensors.py, writing the same bytes).

GGUF tensor infos carry at most 4 dims, so HyVid/Wan conv3d patch-embed
kernels are dumped to a safetensors sidecar at conversion
(tools/convert.py NDSidecar) and appended back here as F32 after
quantization, in the sidecar's stored order. The 5-D shape is carried in
``comfy.gguf.orig_shape`` metadata and the tensor stored 4-D with the two
leading dims merged; the loader's orig-shape path restores it. The sidecar
is read by the port's own ``_safetensors``.

Usage:  python -m comfyui_gguf_tpu_torch.tools.fix_5d_tensors \
            --src model-Q4_K_S.gguf --fix fix_5d_tensors_wan.safetensors
"""

from __future__ import annotations

import argparse
import logging

import numpy as np

from .. import _safetensors
from ..gguf.constants import GGUFValueType
from ..gguf.reader import GGUFReader
from ..gguf.writer import GGUFWriter

log = logging.getLogger(__name__)


def fix_file(src: str, fix: str, dst: str | None = None) -> str:
    extra = {k: v.float().numpy()
             for k, v in _safetensors.load_file(fix).items()}
    if dst is None:
        # suffix-only: str.replace would rewrite a ".gguf" embedded
        # anywhere in the path (e.g. a ".gguf.bak" directory)
        dst = (src[: -len(".gguf")] + "-5d.gguf"
               if src.endswith(".gguf") else src + "-5d.gguf")
        if dst == src:
            raise ValueError("refusing to overwrite input; pass --dst")

    reader = GGUFReader(src)
    arch = reader.get_str("general.architecture")
    writer = GGUFWriter(arch)
    for key, val in reader.fields.items():
        if key == "general.architecture":
            continue
        writer.add_field(key, val.type, val.value, val.item_type)
    for t in reader.tensors:
        writer.add_tensor(t.name, np.ascontiguousarray(t.data),
                          raw_dtype=t.qtype, raw_shape=t.shape)

    for key, data in extra.items():
        data = data.astype(np.float32)
        shape5 = data.shape
        stored = data.reshape(-1, *shape5[-3:])  # merge leading dims → 4-D
        writer.add_tensor(key, stored)
        writer.add_field(f"comfy.gguf.orig_shape.{key}", GGUFValueType.ARRAY,
                         [int(x) for x in shape5], GGUFValueType.INT32)
        log.info("appended %s %s as F32 (stored 4-D %s)", key, shape5,
                 stored.shape)

    writer.write_to_file(dst)
    return dst


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--src", required=True, help="quantized .gguf")
    ap.add_argument("--fix", required=True, help="sidecar .safetensors")
    ap.add_argument("--dst", help="output .gguf")
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    print(fix_file(args.src, args.fix, args.dst))


if __name__ == "__main__":
    main()
