"""Planar checkpoint cache: save/load re-tiled param trees (PyTorch port of
comfyui_gguf_tpu/checkpoint.py).

GGUF → planar re-tiling is a one-time host-side cost; this module makes it a
cache: the planarized tree round-trips through one ``.npz`` file whose
arrays are already in device layout, so a warm load is a read and a copy to
the card.

Format (the reference's): numpy ``.npz`` (zip of .npy). Each PlanarQuant
leaf writes its arrays under ``<key>/qs``, ``<key>/scales``,
``<key>/offsets`` plus one JSON metadata row; I8Planar leaves ``<key>/qs``
and ``<key>/scales``; dense leaves ``<key>/dense``. bf16 arrays are
bit-cast to uint16 (npz has no bfloat16 dtype).

The int8 (w8a8) codes: the port stores ``I8Planar.qs`` out-feature-major,
(Rp, Kp), the reference's codes transposed. The port writes
``"layout": "rk"`` in each i8 row and its codes as it holds them; a row
without that field was written by the reference package, (Kp, Rp), and its
codes are transposed once on load (as ``interop`` does).
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from ._device import resolve_device
from .quant.i8 import I8Planar
from .quant.planar import PlanarQuant

_MAGIC = "comfyui-gguf-tpu-planar-v1"
_I8_LAYOUT = "rk"  # (Rp, Kp): out-feature-major, K contiguous


def _to_np(x):
    if isinstance(x, np.ndarray):
        return x, str(x.dtype)
    t = x.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
    return t.numpy(), str(t.dtype).removeprefix("torch.")


def _from_np(a: np.ndarray, dtype: str, device) -> torch.Tensor:
    if dtype == "bfloat16":
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.int16)).view(
            torch.bfloat16)
    else:
        t = torch.from_numpy(np.ascontiguousarray(a))
    return t.to(device)


def save_params(path: str, params: dict) -> None:
    """Write a flat param tree (planar, int8 and dense leaves) to one
    ``.npz`` (``.npz`` is appended to a path without it)."""
    # np.savez silently appends ".npz" to bare paths; normalize up front so
    # save_params(p) / load_params(p) agree on the on-disk name
    if not str(path).endswith(".npz"):
        path = f"{path}.npz"
    arrays: dict[str, np.ndarray] = {}
    meta: dict[str, dict] = {}
    for key, v in params.items():
        if isinstance(v, PlanarQuant):
            qs, qs_dt = _to_np(v.qs)
            sc, sc_dt = _to_np(v.scales)
            arrays[f"{key}/qs"] = qs
            arrays[f"{key}/scales"] = sc
            m = {"kind": "planar", "qtype": int(v.qtype), "layout": v.layout,
                 "group_size": v.group_size, "zero_point": v.zero_point,
                 "shape": list(v.shape), "qs_dtype": qs_dt,
                 "sc_dtype": sc_dt}
            if v.offsets is not None:
                of, of_dt = _to_np(v.offsets)
                arrays[f"{key}/offsets"] = of
                m["of_dtype"] = of_dt
            meta[key] = m
        elif isinstance(v, I8Planar):
            qs, qs_dt = _to_np(v.qs)
            sc, sc_dt = _to_np(v.scales)
            arrays[f"{key}/qs"] = qs
            arrays[f"{key}/scales"] = sc
            meta[key] = {"kind": "i8", "qtype": int(v.qtype),
                         "shape": list(v.shape), "qs_dtype": qs_dt,
                         "sc_dtype": sc_dt, "layout": _I8_LAYOUT}
        else:
            a, dt = _to_np(v if isinstance(v, torch.Tensor)
                           else np.asarray(v))
            if a.dtype == object:
                # np.savez would pickle it and load_params could never read
                # it back: fail now with the offending key (detach LoRA
                # patches, flatten stacked groups before caching)
                raise TypeError(
                    f"save_params: {key!r} is not an array leaf "
                    f"({type(v).__name__}); detach patches / flatten "
                    "custom leaves before caching")
            arrays[f"{key}/dense"] = a
            meta[key] = {"kind": "dense", "dtype": dt}
    arrays["__meta__"] = np.frombuffer(
        json.dumps({"magic": _MAGIC, "keys": meta}).encode(), dtype=np.uint8)
    np.savez(path, **arrays)


def load_params(path: str, device="cuda") -> dict:
    """Read a file of ``save_params`` (either package's) onto ``device``
    (the card unless the caller asks for the CPU)."""
    device = resolve_device(device)
    if not str(path).endswith(".npz") and not os.path.exists(path):
        path = f"{path}.npz"
    with np.load(path) as z:
        head = json.loads(bytes(z["__meta__"]).decode())
        if head.get("magic") != _MAGIC:
            raise ValueError(f"{path}: not a planar checkpoint")
        out: dict[str, object] = {}
        for key, m in head["keys"].items():
            if m["kind"] == "dense":
                out[key] = _from_np(z[f"{key}/dense"], m["dtype"], device)
            elif m["kind"] == "i8":
                qs = z[f"{key}/qs"]
                if m.get("layout") != _I8_LAYOUT:  # the reference's (Kp, Rp)
                    qs = np.swapaxes(qs, -1, -2)
                out[key] = I8Planar(
                    qs=_from_np(qs, m["qs_dtype"], device),
                    scales=_from_np(z[f"{key}/scales"], m["sc_dtype"],
                                    device),
                    qtype=int(m["qtype"]), shape=tuple(m["shape"]))
            else:
                offsets = None
                if f"{key}/offsets" in z:
                    offsets = _from_np(z[f"{key}/offsets"], m["of_dtype"],
                                       device).to(torch.float32)
                out[key] = PlanarQuant(
                    qs=_from_np(z[f"{key}/qs"], m["qs_dtype"], device),
                    scales=_from_np(z[f"{key}/scales"], m["sc_dtype"],
                                    device).to(torch.float32),
                    offsets=offsets,
                    qtype=int(m["qtype"]), layout=m["layout"],
                    group_size=int(m["group_size"]),
                    zero_point=int(m["zero_point"]),
                    shape=tuple(m["shape"]),
                )
    return out
