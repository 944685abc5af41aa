"""Pure-Python GGUF v3 writer.

Replaces the reference's use of ``gguf.GGUFWriter`` (reference
tools/convert.py:344-353). Streams tensor payloads to disk with correct
alignment; metadata supports every GGUFValueType including nested arrays.
"""

from __future__ import annotations

import struct

import numpy as np

from .constants import (
    GGML_QUANT_SIZES,
    GGUF_DEFAULT_ALIGNMENT,
    GGUF_MAGIC,
    GGUF_VERSION,
    GGMLQuantizationType,
    GGUFValueType,
    LlamaFileType,
    align_up,
)

_SCALAR_FMT = {
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


def _guess_scalar_type(v) -> GGUFValueType:
    if isinstance(v, bool):
        return GGUFValueType.BOOL
    if isinstance(v, int):
        return GGUFValueType.INT32 if -(2**31) <= v < 2**31 else GGUFValueType.INT64
    if isinstance(v, float):
        return GGUFValueType.FLOAT32
    if isinstance(v, str):
        return GGUFValueType.STRING
    raise TypeError(f"Cannot infer GGUF value type for {type(v)}")


class GGUFWriter:
    def __init__(self, arch: str, alignment: int = GGUF_DEFAULT_ALIGNMENT):
        self.alignment = alignment
        self._kv: list[tuple[str, GGUFValueType, object, GGUFValueType | None]] = []
        self._tensors: list[tuple[str, tuple[int, ...], GGMLQuantizationType, bytes]] = []
        self.add_string("general.architecture", arch)

    # -- metadata -------------------------------------------------------------

    def add_field(self, key: str, vtype: GGUFValueType, value,
                  item_type: GGUFValueType | None = None):
        self._kv.append((key, vtype, value, item_type))

    def add_string(self, key: str, value: str):
        self.add_field(key, GGUFValueType.STRING, value)

    def add_uint32(self, key: str, value: int):
        self.add_field(key, GGUFValueType.UINT32, int(value))

    def add_int32(self, key: str, value: int):
        self.add_field(key, GGUFValueType.INT32, int(value))

    def add_uint64(self, key: str, value: int):
        self.add_field(key, GGUFValueType.UINT64, int(value))

    def add_float32(self, key: str, value: float):
        self.add_field(key, GGUFValueType.FLOAT32, float(value))

    def add_bool(self, key: str, value: bool):
        self.add_field(key, GGUFValueType.BOOL, bool(value))

    def add_array(self, key: str, values, item_type: GGUFValueType | None = None):
        values = list(values)
        if item_type is None:
            if not values:
                raise ValueError(f"cannot infer item type for empty array {key}")
            item_type = _guess_scalar_type(values[0])
        self.add_field(key, GGUFValueType.ARRAY, values, item_type)

    def add_quantization_version(self, v: int):
        self.add_uint32("general.quantization_version", v)

    def add_file_type(self, ftype: LlamaFileType):
        self.add_uint32("general.file_type", int(ftype))

    # -- tensors ----------------------------------------------------------------

    def add_tensor(
        self,
        name: str,
        data: np.ndarray,
        raw_dtype: GGMLQuantizationType | None = None,
        raw_shape: tuple[int, ...] | None = None,
    ):
        """Register a tensor.

        ``data`` is either a typed numpy array (f32/f16 — qtype inferred) or
        packed quant bytes with ``raw_dtype``+``raw_shape`` (logical shape,
        numpy order) given explicitly. For packed data with raw_shape omitted,
        ``data.shape`` is interpreted as the logical shape only for typed
        arrays.
        """
        if raw_dtype is None:
            if data.dtype == np.float32:
                raw_dtype = GGMLQuantizationType.F32
            elif data.dtype == np.float16:
                raw_dtype = GGMLQuantizationType.F16
            elif data.dtype == np.int32:
                raw_dtype = GGMLQuantizationType.I32
            else:
                raise TypeError(f"cannot infer qtype for dtype {data.dtype}")
            shape = data.shape
        else:
            raw_dtype = GGMLQuantizationType(raw_dtype)
            if raw_shape is not None:
                shape = tuple(raw_shape)
            elif raw_dtype in (
                GGMLQuantizationType.F32,
                GGMLQuantizationType.F16,
                GGMLQuantizationType.BF16,
            ):
                shape = data.shape
            else:
                raise ValueError(
                    f"packed tensor {name!r} needs raw_shape (logical shape)"
                )

        payload = np.ascontiguousarray(data).tobytes()
        block, type_size = GGML_QUANT_SIZES[raw_dtype]
        n_elements = int(np.prod(shape)) if shape else 1
        expect = n_elements // block * type_size
        if len(payload) != expect:
            raise ValueError(
                f"tensor {name!r}: payload {len(payload)}B != expected {expect}B "
                f"for shape {shape} qtype {raw_dtype.name}"
            )
        if len(name.encode("utf-8")) > 127:
            raise ValueError(f"tensor name too long (>127 bytes): {name!r}")
        dims = tuple(reversed(shape))  # GGUF order
        self._tensors.append((name, dims, raw_dtype, payload))

    # -- serialization ----------------------------------------------------------

    def write_to_file(self, path: str):
        with open(path, "wb") as fh:
            fh.write(struct.pack("<IIQQ", GGUF_MAGIC, GGUF_VERSION,
                                 len(self._tensors), len(self._kv)))
            for key, vtype, value, item_type in self._kv:
                fh.write(self._enc_string(key))
                fh.write(struct.pack("<I", int(vtype)))
                fh.write(self._enc_value(vtype, value, item_type))

            offset = 0
            offsets = []
            for name, dims, qtype, payload in self._tensors:
                offsets.append(offset)
                fh.write(self._enc_string(name))
                fh.write(struct.pack("<I", len(dims)))
                fh.write(struct.pack(f"<{len(dims)}Q", *dims))
                fh.write(struct.pack("<I", int(qtype)))
                fh.write(struct.pack("<Q", offset))
                offset = align_up(offset + len(payload), self.alignment)

            pad = align_up(fh.tell(), self.alignment) - fh.tell()
            fh.write(b"\x00" * pad)
            data_start = fh.tell()
            for (name, dims, qtype, payload), off in zip(self._tensors, offsets):
                fh.write(b"\x00" * (data_start + off - fh.tell()))
                fh.write(payload)

    def _enc_string(self, s: str) -> bytes:
        b = s.encode("utf-8")
        return struct.pack("<Q", len(b)) + b

    def _enc_value(self, vtype: GGUFValueType, value,
                   item_type: GGUFValueType | None) -> bytes:
        if vtype == GGUFValueType.STRING:
            return self._enc_string(value)
        if vtype == GGUFValueType.ARRAY:
            out = [struct.pack("<IQ", int(item_type), len(value))]
            for v in value:
                out.append(self._enc_value(item_type, v, None))
            return b"".join(out)
        return struct.pack(_SCALAR_FMT[vtype], value)

