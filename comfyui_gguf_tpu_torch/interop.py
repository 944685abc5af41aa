"""Carry a parameter tree from the reference package into the port.

``params_from_numpy(tree, device)`` takes the reference package's parameter
tree with its leaves already converted to numpy (for example by
``jax.tree.map(np.asarray, tree)`` on the reference side) and returns the
port's tree. Leaves are recognised by their fields, so this module needs
nothing of the reference package:

* a **planar** leaf has ``qs``, ``scales``, ``offsets``, ``qtype``,
  ``layout``, ``group_size``, ``zero_point`` and ``shape``;
* an **int8** leaf has ``qs``, ``scales``, ``qtype`` and ``shape``;
* a plain array is a dense weight: the float32 leaves of a T5, CLIP or VAE
  tree, a bfloat16 flux embedder, a conv weight, which is (O, I, kh, kw)
  in both packages;
* a **LoRA-patched** leaf has ``base`` (any of these leaves) and
  ``patches``, each patch with ``up``, ``down``, ``mid``, ``diff``,
  ``scale``, ``a1`` and ``a2`` (absent factors are None);
* a nested dict is a stacked group (or any subtree).

So one numpy tree serves both packages, whichever model it belongs to:
the flux trees (LoRA-patched ones too), the Wan, Cosmos, HunyuanVideo and
LTX-Video trees (flat or stacked, planar or int8; the Wan and HunyuanVideo
patch embeds 5-D conv kernels), a T5 tree with Q8_0 planar linears, dense
CLIP, image-VAE and Wan, HunyuanVideo and LTX-Video VAE state dicts (the
video VAEs' 3-D kernels (O, I, kt, kh, kw) in both packages).

The planar byte layout is the same in both packages, so the carry is a
copy; the int8 codes are the same values, stored transposed in the port
((Rp, Kp), out-feature-major), so they are transposed once. bfloat16 arrays (``ml_dtypes.bfloat16``, which ``torch.from_numpy``
refuses) travel as their 16-bit patterns.
"""

from __future__ import annotations

import numpy as np
import torch

from ._device import resolve_device
from .lora import LoRAPatch, PatchedWeight
from .quant.i8 import I8Planar
from .quant.planar import PlanarQuant

_PLANAR_FIELDS = ("qs", "scales", "offsets", "qtype", "layout",
                  "group_size", "zero_point", "shape")
_I8_FIELDS = ("qs", "scales", "qtype", "shape")
_PATCH_FIELDS = ("up", "down", "mid", "diff", "scale", "a1", "a2")


def tensor_from_numpy(a, device) -> torch.Tensor:
    """numpy array (bfloat16 included) -> tensor on ``device``."""
    a = np.ascontiguousarray(a)
    if not a.flags.writeable:  # a read-only buffer must not back a tensor
        a = a.copy()
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16).to(
            device)
    return torch.from_numpy(a).to(device)


def _patch(p, device) -> LoRAPatch:
    def t(a):
        return None if a is None else tensor_from_numpy(a, device)

    return LoRAPatch(up=t(p.up), down=t(p.down), mid=t(p.mid),
                     diff=t(p.diff), scale=float(p.scale), a1=t(p.a1),
                     a2=t(p.a2))


def _leaf(v, device):
    if hasattr(v, "base") and hasattr(v, "patches") and all(
            all(hasattr(p, f) for f in _PATCH_FIELDS) for p in v.patches):
        return PatchedWeight(_leaf(v.base, device),
                             tuple(_patch(p, device) for p in v.patches))
    if all(hasattr(v, f) for f in _PLANAR_FIELDS):
        return PlanarQuant(
            qs=tensor_from_numpy(v.qs, device),
            # float32 or bfloat16 planes (the reference's scale_dtype), kept
            scales=tensor_from_numpy(v.scales, device),
            offsets=(None if v.offsets is None else
                     tensor_from_numpy(v.offsets, device)),
            qtype=int(v.qtype), layout=str(v.layout),
            group_size=int(v.group_size), zero_point=int(v.zero_point),
            shape=tuple(int(d) for d in v.shape))
    if all(hasattr(v, f) for f in _I8_FIELDS):
        return I8Planar(qs=tensor_from_numpy(np.swapaxes(v.qs, -1, -2),
                                             device),
                        scales=tensor_from_numpy(v.scales, device),
                        qtype=int(v.qtype),
                        shape=tuple(int(d) for d in v.shape))
    if isinstance(v, dict):
        return {k: _leaf(x, device) for k, x in v.items()}
    return tensor_from_numpy(v, device)


def params_from_numpy(tree: dict, device="cuda") -> dict:
    """The reference package's (numpy-leaved) param tree -> the port's."""
    device = resolve_device(device)
    return {k: _leaf(v, device) for k, v in tree.items()}
