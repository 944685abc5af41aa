"""Pure-Python GGUF reader with zero-copy mmap tensor access.

Replaces the reference's use of ``gguf.GGUFReader`` (reference loader.py:55)
plus its typed field accessors (reference loader.py:16-49). Tensor payloads
are exposed as numpy views into a single ``np.memmap`` so nothing is copied
into RAM until a consumer touches the pages — the same lazy-load behavior the
reference gets from the gguf package (reference loader.py:104-106).
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field

import numpy as np

from .constants import (
    GGML_QUANT_SIZES,
    GGUF_DEFAULT_ALIGNMENT,
    GGUF_MAGIC,
    GGMLQuantizationType,
    GGUFValueType,
    align_up,
)

_SCALAR_FMT: dict[GGUFValueType, str] = {
    GGUFValueType.UINT8: "<B",
    GGUFValueType.INT8: "<b",
    GGUFValueType.UINT16: "<H",
    GGUFValueType.INT16: "<h",
    GGUFValueType.UINT32: "<I",
    GGUFValueType.INT32: "<i",
    GGUFValueType.FLOAT32: "<f",
    GGUFValueType.BOOL: "<?",
    GGUFValueType.UINT64: "<Q",
    GGUFValueType.INT64: "<q",
    GGUFValueType.FLOAT64: "<d",
}

_SCALAR_NP: dict[GGUFValueType, np.dtype] = {
    GGUFValueType.UINT8: np.dtype("<u1"),
    GGUFValueType.INT8: np.dtype("<i1"),
    GGUFValueType.UINT16: np.dtype("<u2"),
    GGUFValueType.INT16: np.dtype("<i2"),
    GGUFValueType.UINT32: np.dtype("<u4"),
    GGUFValueType.INT32: np.dtype("<i4"),
    GGUFValueType.FLOAT32: np.dtype("<f4"),
    GGUFValueType.BOOL: np.dtype("<u1"),
    GGUFValueType.UINT64: np.dtype("<u8"),
    GGUFValueType.INT64: np.dtype("<i8"),
    GGUFValueType.FLOAT64: np.dtype("<f8"),
}

# dtype of the typed numpy view for "torch/numpy-compatible" tensor types
_DIRECT_NP_DTYPE: dict[GGMLQuantizationType, np.dtype] = {
    GGMLQuantizationType.F32: np.dtype("<f4"),
    GGMLQuantizationType.F16: np.dtype("<f2"),
    GGMLQuantizationType.F64: np.dtype("<f8"),
    GGMLQuantizationType.I8: np.dtype("<i1"),
    GGMLQuantizationType.I16: np.dtype("<i2"),
    GGMLQuantizationType.I32: np.dtype("<i4"),
    GGMLQuantizationType.I64: np.dtype("<i8"),
}


@dataclass
class GGUFValue:
    """One decoded metadata entry."""

    type: GGUFValueType
    value: object  # python scalar/str, or list for ARRAY
    item_type: GGUFValueType | None = None  # set when type == ARRAY


@dataclass
class GGUFTensorInfo:
    """Tensor-info table entry + a lazy view of its packed payload.

    ``dims`` is in GGUF order (fastest-varying first); ``shape`` is the
    numpy/torch order the rest of the framework uses — the reference performs
    the same reversal at loader.py:110.
    """

    name: str
    qtype: GGMLQuantizationType
    dims: tuple[int, ...]
    offset: int  # relative to data-section start
    data: np.ndarray = field(repr=False, default=None)

    @property
    def shape(self) -> tuple[int, ...]:
        return tuple(reversed(self.dims))

    @property
    def n_elements(self) -> int:
        n = 1
        for d in self.dims:
            n *= d
        return n

    @property
    def n_bytes(self) -> int:
        # blocks_for raises on non-block-divisible element counts — a
        # silent floor here would map a truncated payload and surface as
        # an opaque reshape error deep inside dequantize
        from .constants import blocks_for

        _, type_size = GGML_QUANT_SIZES[self.qtype]
        try:
            return blocks_for(self.n_elements, self.qtype) * type_size
        except ValueError as e:
            raise BadGGUFError(f"tensor {self.name!r}: {e}") from None


class BadGGUFError(ValueError):
    pass


class GGUFReader:
    """Parse a GGUF v2/v3 (little-endian) file.

    Attributes:
      fields: key -> GGUFValue
      tensors: list[GGUFTensorInfo] in file order
      alignment: data-section alignment in effect
    """

    def __init__(self, path: str):
        self.path = path
        self._buf = np.memmap(path, mode="r", dtype=np.uint8)
        view = memoryview(self._buf)

        magic, version = struct.unpack_from("<II", view, 0)
        if magic != GGUF_MAGIC:
            raise BadGGUFError(f"Not a GGUF file (bad magic): {path}")
        if version not in (2, 3):
            raise BadGGUFError(f"Unsupported GGUF version {version}: {path}")
        self.version = version

        n_tensors, n_kv = struct.unpack_from("<QQ", view, 8)
        pos = 24

        self.fields: dict[str, GGUFValue] = {}
        for _ in range(n_kv):
            key, pos = self._read_string(view, pos)
            vtype, pos = self._read_scalar(view, pos, GGUFValueType.UINT32)
            vtype = GGUFValueType(vtype)
            val, pos = self._read_value(view, pos, vtype)
            self.fields[key] = val

        self.alignment = int(
            self.get_int("general.alignment") or GGUF_DEFAULT_ALIGNMENT
        )

        self.tensors: list[GGUFTensorInfo] = []
        for _ in range(n_tensors):
            name, pos = self._read_string(view, pos)
            n_dims, pos = self._read_scalar(view, pos, GGUFValueType.UINT32)
            dims = struct.unpack_from(f"<{n_dims}Q", view, pos)
            pos += 8 * n_dims
            raw_type, pos = self._read_scalar(view, pos, GGUFValueType.UINT32)
            offset, pos = self._read_scalar(view, pos, GGUFValueType.UINT64)
            self.tensors.append(
                GGUFTensorInfo(
                    name=name,
                    qtype=GGMLQuantizationType(raw_type),
                    dims=tuple(int(d) for d in dims),
                    offset=int(offset),
                )
            )

        data_start = align_up(pos, self.alignment)
        self.data_offset = data_start

        for t in self.tensors:
            start = data_start + t.offset
            raw = self._buf[start : start + t.n_bytes]
            np_dtype = _DIRECT_NP_DTYPE.get(t.qtype)
            if np_dtype is not None:
                t.data = raw.view(np_dtype).reshape(t.shape)
            elif t.qtype == GGMLQuantizationType.BF16:
                t.data = raw.view(np.uint16).reshape(t.shape)
            else:
                block, type_size = GGML_QUANT_SIZES[t.qtype]
                t.data = raw.view(np.uint8).reshape(-1, type_size)

    # -- typed field accessors (role of reference loader.py:16-49) ----------

    def get_field(self, key: str) -> GGUFValue | None:
        return self.fields.get(key)

    def get_str(self, key: str) -> str | None:
        f = self.fields.get(key)
        if f is None:
            return None
        if f.type != GGUFValueType.STRING:
            raise TypeError(f"GGUF key {key}: expected STRING, got {f.type!r}")
        return f.value

    def get_int(self, key: str) -> int | None:
        f = self.fields.get(key)
        if f is None:
            return None
        return int(f.value)

    def get_float(self, key: str) -> float | None:
        f = self.fields.get(key)
        if f is None:
            return None
        return float(f.value)

    def get_bool(self, key: str) -> bool | None:
        f = self.fields.get(key)
        if f is None:
            return None
        return bool(f.value)

    def get_list(self, key: str) -> list | None:
        f = self.fields.get(key)
        if f is None:
            return None
        if f.type != GGUFValueType.ARRAY:
            raise TypeError(f"GGUF key {key}: expected ARRAY, got {f.type!r}")
        return f.value

    def get_orig_shape(self, tensor_name: str) -> tuple[int, ...] | None:
        """Decode ``comfy.gguf.orig_shape.{name}`` metadata.

        Same validation as reference loader.py:16-24: must be an ARRAY of
        INT32.
        """
        f = self.fields.get(f"comfy.gguf.orig_shape.{tensor_name}")
        if f is None:
            return None
        if f.type != GGUFValueType.ARRAY or f.item_type != GGUFValueType.INT32:
            raise TypeError(
                f"Bad original shape metadata for {tensor_name}: "
                f"expected ARRAY of INT32, got {f.type}/{f.item_type}"
            )
        return tuple(int(v) for v in f.value)

    # -- low-level parsing ---------------------------------------------------

    @staticmethod
    def _read_scalar(view, pos: int, vtype: GGUFValueType):
        fmt = _SCALAR_FMT[vtype]
        (val,) = struct.unpack_from(fmt, view, pos)
        return val, pos + struct.calcsize(fmt)

    @staticmethod
    def _read_string(view, pos: int):
        (length,) = struct.unpack_from("<Q", view, pos)
        pos += 8
        s = bytes(view[pos : pos + length]).decode("utf-8", errors="replace")
        return s, pos + length

    def _read_value(self, view, pos: int, vtype: GGUFValueType):
        if vtype == GGUFValueType.STRING:
            s, pos = self._read_string(view, pos)
            return GGUFValue(vtype, s), pos
        if vtype == GGUFValueType.ARRAY:
            (item_type,) = struct.unpack_from("<I", view, pos)
            item_type = GGUFValueType(item_type)
            (count,) = struct.unpack_from("<Q", view, pos + 4)
            pos += 12
            if item_type == GGUFValueType.STRING:
                out = []
                for _ in range(count):
                    s, pos = self._read_string(view, pos)
                    out.append(s)
            elif item_type == GGUFValueType.ARRAY:
                out = []
                for _ in range(count):
                    v, pos = self._read_value(view, pos, item_type)
                    out.append(v.value)
            else:
                dt = _SCALAR_NP[item_type]
                nbytes = dt.itemsize * count
                arr = np.frombuffer(view, dtype=dt, count=count, offset=pos)
                if item_type == GGUFValueType.BOOL:
                    out = [bool(x) for x in arr]
                else:
                    out = arr.tolist()
                pos += nbytes
            return GGUFValue(vtype, out, item_type=item_type), pos
        val, pos = self._read_scalar(view, pos, vtype)
        if vtype == GGUFValueType.BOOL:
            val = bool(val)
        return GGUFValue(vtype, val), pos

