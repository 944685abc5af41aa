"""safetensors/ckpt → F16/BF16 GGUF converter (CLI; PyTorch port of
comfyui_gguf_tpu/tools/convert.py, writing the same bytes).

Detects the architecture by key fingerprints, applies the per-tensor dtype
policy, rearranges tensors whose row width breaks 256-wide quant blocks
(recording ``comfy.gguf.orig_shape`` metadata), dumps >4-D tensors to a
safetensors sidecar, and writes the GGUF. ``.safetensors`` files are read
and the sidecar written by the port's own ``_safetensors`` (no
``safetensors`` package); ``.ckpt`` / ``.pt`` / ``.bin`` / ``.pth`` files
through ``torch.load(..., weights_only=True)``.

Usage:  python -m comfyui_gguf_tpu_torch.tools.convert --src model.safetensors
"""

from __future__ import annotations

import argparse
import logging
import os

import numpy as np

from .. import _safetensors
from ..archs import ArchSpec, detect_arch
from ..gguf.constants import (
    GGML_QUANT_VERSION,
    GGMLQuantizationType,
    GGUFValueType,
    LlamaFileType,
    MAX_TENSOR_DIMS,
)
from ..gguf.writer import GGUFWriter
from ..quant import codecs

log = logging.getLogger(__name__)

QUANTIZATION_THRESHOLD = 1024  # ≤ this many params → keep F32
REARRANGE_THRESHOLD = 512
MAX_TENSOR_NAME_LENGTH = 127


def load_state_dict(path: str) -> dict[str, np.ndarray]:
    """Load .safetensors / .ckpt / .pt / .bin / .pth → numpy state dict."""
    import torch

    if path.endswith(".safetensors"):
        return strip_prefix(_safetensors.load_state_dict(path))
    sd = torch.load(path, map_location="cpu", weights_only=True)
    for k in ("model", "module", "state_dict"):
        if k in sd and isinstance(sd[k], dict):
            sd = sd[k]
    return strip_prefix({
        k: v.float().numpy() if v.dtype == torch.bfloat16 else v.numpy()
        for k, v in sd.items() if hasattr(v, "numpy")
    })


def strip_prefix(sd: dict) -> dict:
    """Drop a common ``model.diffusion_model.`` / ``model.`` wrapper
    prefix."""
    for prefix in ("model.diffusion_model.", "model."):
        if any(k.startswith(prefix) for k in sd):
            stripped = {
                k[len(prefix):]: v for k, v in sd.items()
                if k.startswith(prefix)
            }
            if stripped:
                return stripped
    return sd


class NDSidecar:
    """Collects >4-D tensors that GGUF cannot carry; saved as a safetensors
    sidecar for tools/fix_5d_tensors.py re-injection after quantization."""

    def __init__(self, arch: str, dst_dir: str):
        self.path = os.path.join(dst_dir or ".", f"fix_5d_tensors_{arch}.safetensors")
        self.tensors: dict[str, np.ndarray] = {}

    def add(self, key: str, data: np.ndarray):
        log.warning(">4-D tensor needs sidecar fix: %s %s", key, data.shape)
        self.tensors[key] = data

    def save(self):
        if not self.tensors:
            return None
        if os.path.isfile(self.path):
            raise RuntimeError(f"5D tensor fix file already exists: {self.path}")
        _safetensors.save_file(
            {k: v.astype(np.float32) for k, v in self.tensors.items()},
            self.path)
        return self.path


def handle_tensors(writer: GGUFWriter, sd: dict[str, np.ndarray],
                   spec: ArchSpec, use_bf16_base: bool,
                   sidecar: NDSidecar | None):
    """Per-tensor dtype policy + shape fix."""
    for key in list(sd):
        if any(s in key for s in spec.keys_ignore):
            continue
        data = np.asarray(sd[key])
        if len(key.encode("utf-8")) > MAX_TENSOR_NAME_LENGTH:
            raise ValueError(f"tensor name too long: {key!r}")
        if data.dtype.kind == "f" and not np.isfinite(data).all():
            # a NaN/Inf weight quantizes to garbage downstream — surface
            # it here (the checkpoint is corrupt or half-trained)
            log.warning("non-finite values in %s (%d of %d)", key,
                        int((~np.isfinite(data)).sum()), data.size)

        n_dims = data.ndim
        n_params = data.size

        if n_dims > MAX_TENSOR_DIMS:
            if sidecar is None:
                raise NotImplementedError(
                    f">4-D tensor {key} {data.shape} needs --sidecar support"
                )
            sidecar.add(key, data)
            continue

        qtype = (GGMLQuantizationType.BF16 if use_bf16_base
                 else GGMLQuantizationType.F16)
        if (n_dims <= 1 or n_params <= QUANTIZATION_THRESHOLD
                or any(s in key for s in spec.keys_hiprec)):
            qtype = GGMLQuantizationType.F32

        # any n_dims>1 tensor at or above the size threshold whose last dim
        # isn't a 256 multiple is flattened to (N/256, 256) so the block
        # quantizer can take it (covers SD1/SDXL 4-D convs and narrow 2-D
        # projections; orig_shape restores on load)
        orig_shape = None
        if (spec.shape_fix and n_dims > 1
                and n_params >= REARRANGE_THRESHOLD
                and n_params % 256 == 0
                and data.shape[-1] % 256 != 0):
            orig_shape = data.shape
            data = data.reshape(n_params // 256, 256)

        payload = codecs.quantize(data.astype(np.float32), qtype)
        writer.add_tensor(key, payload, raw_dtype=qtype, raw_shape=data.shape)
        if orig_shape is not None:
            writer.add_field(
                f"comfy.gguf.orig_shape.{key}", GGUFValueType.ARRAY,
                [int(x) for x in orig_shape], GGUFValueType.INT32,
            )


def convert_file(src: str, dst: str | None = None,
                 use_bf16_base: bool = False) -> str:
    sd = load_state_dict(src)
    spec = detect_arch(sd.keys())
    log.info("detected architecture: %s", spec.arch)

    if dst is None:
        base = os.path.splitext(src)[0]
        dst = f"{base}-{'BF16' if use_bf16_base else 'F16'}.gguf"

    writer = GGUFWriter(spec.arch)
    writer.add_quantization_version(GGML_QUANT_VERSION)
    writer.add_file_type(LlamaFileType.MOSTLY_BF16 if use_bf16_base
                         else LlamaFileType.MOSTLY_F16)

    sidecar = NDSidecar(spec.arch, os.path.dirname(dst)) \
        if spec.has_nd_tensors else None
    if sidecar is not None and os.path.isfile(sidecar.path):
        # fail BEFORE minutes of conversion work, not after the GGUF is
        # written (a stale sidecar next to a fresh GGUF injects
        # mismatched 5-D weights in fix_5d_tensors)
        raise RuntimeError(
            f"5D tensor fix file already exists: {sidecar.path} — "
            "remove it (stale from a previous run) before converting")
    handle_tensors(writer, sd, spec, use_bf16_base, sidecar)
    writer.write_to_file(dst)
    if sidecar is not None:
        sp = sidecar.save()
        if sp:
            log.warning("wrote >4-D sidecar %s — run fix_5d_tensors after "
                        "quantization", sp)
    return dst


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--src", required=True, help="source checkpoint")
    ap.add_argument("--dst", help="output .gguf path")
    ap.add_argument("--bf16", action="store_true",
                    help="store base precision as BF16 instead of F16")
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    out = convert_file(args.src, args.dst, use_bf16_base=args.bf16)
    print(out)


if __name__ == "__main__":
    main()
