"""A reader and a writer for the safetensors file format, so that the port
needs no package for it.

The format: an 8-byte little-endian header length, a JSON header mapping
each tensor name to ``{"dtype", "shape", "data_offsets": [begin, end]}``
(offsets relative to the end of the header; an optional ``__metadata__``
entry), then the raw little-endian tensor bytes.
"""

from __future__ import annotations

import json
import struct

import numpy as np
import torch

# safetensors dtype tag -> (numpy dtype of the stored bytes, torch dtype)
_DTYPES = {
    "F32": (np.dtype("<f4"), torch.float32),
    "F16": (np.dtype("<f2"), torch.float16),
    "BF16": (np.dtype("<u2"), torch.bfloat16),
    "I8": (np.dtype("i1"), torch.int8),
    "I32": (np.dtype("<i4"), torch.int32),
    "I64": (np.dtype("<i8"), torch.int64),
}
_TAG_OF = {t: tag for tag, (_, t) in _DTYPES.items()}


def load_file(path: str) -> dict[str, torch.Tensor]:
    """Every tensor of a safetensors file, on the CPU, in its stored dtype."""
    with open(path, "rb") as f:
        head = f.read(8)
        if len(head) != 8:
            raise ValueError(f"{path}: too short for a safetensors file")
        (n,) = struct.unpack("<Q", head)
        header = json.loads(f.read(n).decode("utf-8"))
        payload = f.read()
    out = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        if info["dtype"] not in _DTYPES:
            raise NotImplementedError(
                f"{path}: tensor {name!r} has dtype {info['dtype']}; this "
                f"reader takes {sorted(_DTYPES)}")
        np_dt, torch_dt = _DTYPES[info["dtype"]]
        begin, end = info["data_offsets"]
        shape = tuple(info["shape"])
        count = int(np.prod(shape, dtype=np.int64))
        if end - begin != count * np_dt.itemsize or end > len(payload):
            raise ValueError(f"{path}: tensor {name!r} has offsets "
                             f"{begin}:{end} for shape {shape}")
        arr = np.frombuffer(payload, dtype=np_dt, count=count,
                            offset=begin).astype(np_dt.newbyteorder("="))
        t = torch.from_numpy(arr.reshape(shape))
        out[name] = t.view(torch.bfloat16) if torch_dt == torch.bfloat16 \
            else t
    return out


def load_state_dict(path: str) -> dict[str, np.ndarray]:
    """A safetensors file as numpy arrays, bf16/f16 widened to f32 (the
    reference's ``_load_safetensors_sd``)."""
    return {
        k: (v.float().numpy() if v.dtype in (torch.bfloat16, torch.float16)
            else v.numpy())
        for k, v in load_file(path).items()
    }


def save_file(tensors: dict, path: str, metadata: dict | None = None) -> None:
    """Write torch tensors or numpy arrays as a safetensors file."""
    header, blobs, offset = {}, [], 0
    if metadata:
        header["__metadata__"] = {str(k): str(v) for k, v in metadata.items()}
    for name, t in tensors.items():
        t = torch.as_tensor(t).detach().cpu().contiguous()
        if t.dtype not in _TAG_OF:
            raise NotImplementedError(
                f"tensor {name!r} has dtype {t.dtype}; this writer takes "
                f"{sorted(map(str, _TAG_OF))}")
        np_dt, _ = _DTYPES[_TAG_OF[t.dtype]]
        raw = (t.view(torch.int16) if t.dtype == torch.bfloat16 else t)
        data = raw.numpy().astype(np_dt if t.dtype != torch.bfloat16
                                  else np.dtype("<i2"), copy=False).tobytes()
        header[name] = {"dtype": _TAG_OF[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + len(data)]}
        blobs.append(data)
        offset += len(data)
    head = json.dumps(header, separators=(",", ":")).encode("utf-8")
    head += b" " * (-len(head) % 8)  # keep the payload 8-byte aligned
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(head)))
        f.write(head)
        for b in blobs:
            f.write(b)
