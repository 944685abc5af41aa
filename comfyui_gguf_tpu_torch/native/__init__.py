"""The host block codecs: numpy arrays in and out of the port's C++ library.

``quant_kernels.cc`` (C++ on ``std::thread``) is built at first use by
``_build.host_lib`` with the host C++ compiler (``$CXX``, else ``c++``)
into ``_build/``, never at import. Its outputs are byte-equal to the numpy
codecs of ``quant/codecs.py`` and the numpy assembly of
``quant/planar.py``, which stay as the plain version: the tests' oracle and
the path for what the library does not cover.

Coverage:

* encode (``quantize``): Q4_0, Q8_0, Q4_K, Q5_K, Q6_K
  (``NATIVE_ENCODE_QTYPES``);
* decode (``dequantize``): Q4_0, Q8_0, Q4_K, Q6_K (``NATIVE_DECODE_QTYPES``);
* component extraction: Q4_K, Q5_K, Q6_K, Q3_K, Q2_K (``extract_*``);
* the planar re-tilings: the nib4 pack and the int8 transpose.

``quant/codecs.py`` and ``quant/planar.py`` send every covered call here;
any other qtype goes to its numpy codec. There is no fallback for a
covered one: a compiler that is missing or fails raises ``RuntimeError``
with its output, at the first call. Each call runs on
``torch.get_num_threads()`` threads.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from .. import _build
from ..gguf.constants import GGML_QUANT_SIZES, GGMLQuantizationType

# qtype codes (GGMLQuantizationType) the library encodes / decodes:
# Q4_0 Q8_0 Q4_K Q5_K Q6_K / Q4_0 Q8_0 Q4_K Q6_K
NATIVE_ENCODE_QTYPES = frozenset({2, 8, 12, 13, 14})
NATIVE_DECODE_QTYPES = frozenset({2, 8, 12, 14})


def available(qtype: int, *, decode: bool = False) -> bool:
    """Whether the library covers encoding (decoding) ``qtype``."""
    table = NATIVE_DECODE_QTYPES if decode else NATIVE_ENCODE_QTYPES
    return int(qtype) in table


def _threads() -> int:
    return max(1, torch.get_num_threads())


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def _call(name: str, *args) -> None:
    rc = getattr(_build.host_lib(), name)(*args)
    if rc != 0:
        raise RuntimeError(f"{name} refused its arguments (rc {rc})")


def _sizes(qtype: int) -> tuple[int, int]:
    return GGML_QUANT_SIZES[GGMLQuantizationType(qtype)]


def _blocks(blocks: np.ndarray, type_size: int) -> np.ndarray:
    """Packed blocks as a contiguous (n, type_size) uint8 array."""
    raw = np.ascontiguousarray(blocks).view(np.uint8).reshape(-1)
    if raw.size % type_size:
        raise ValueError(f"{raw.size} bytes are not whole blocks of "
                         f"{type_size}")
    return raw.reshape(-1, type_size)


def quantize(x: np.ndarray, qtype: int) -> np.ndarray:
    """float array → packed (n_blocks, type_size) uint8 blocks, as
    ``codecs.ENCODERS[qtype]``."""
    q = int(qtype)
    if q not in NATIVE_ENCODE_QTYPES:
        raise ValueError(f"the host codecs do not encode qtype {q}")
    block, type_size = _sizes(q)
    x = np.ascontiguousarray(x, dtype=np.float32).reshape(-1)
    if x.size % block:
        raise ValueError(f"{x.size} elements are not whole blocks of {block}")
    out = np.empty((x.size // block, type_size), dtype=np.uint8)
    _call("ggqt_quantize", q, _ptr(x, ctypes.c_float),
          _ptr(out, ctypes.c_uint8), x.size, _threads())
    return out


def dequantize(blocks: np.ndarray, qtype: int,
               n_elements: int) -> np.ndarray:
    """Packed blocks → float32 (n_elements,), as ``codecs.DECODERS``."""
    q = int(qtype)
    if q not in NATIVE_DECODE_QTYPES:
        raise ValueError(f"the host codecs do not decode qtype {q}")
    block, type_size = _sizes(q)
    raw = _blocks(blocks, type_size)
    if n_elements % block or raw.shape[0] * block != n_elements:
        # a short buffer would make the decoder read past its end
        raise ValueError(f"qtype {q}: {raw.shape[0]} blocks do not hold "
                         f"{n_elements} elements")
    out = np.empty(n_elements, dtype=np.float32)
    _call("ggqt_dequantize", q, _ptr(raw, ctypes.c_uint8),
          _ptr(out, ctypes.c_float), n_elements, _threads())
    return out


def _extract(sym: str, type_size: int, ngroups: int, signed: bool,
             blocks: np.ndarray):
    raw = _blocks(blocks, type_size)
    n = raw.shape[0]
    q = np.empty((n, 256), dtype=np.int8 if signed else np.uint8)
    A = np.empty((n, ngroups), dtype=np.float32)
    if signed:
        _call(sym, _ptr(raw, ctypes.c_uint8), _ptr(q, ctypes.c_int8),
              _ptr(A, ctypes.c_float), n, _threads())
        return q, A
    B = np.empty((n, ngroups), dtype=np.float32)
    _call(sym, _ptr(raw, ctypes.c_uint8), _ptr(q, ctypes.c_uint8),
          _ptr(A, ctypes.c_float), _ptr(B, ctypes.c_float), n,
          _threads())
    return q, A, B


def extract_q4k(blocks: np.ndarray):
    """(n, 144) Q4_K blocks → (q (n, 256) u8, A (n, 8), B (n, 8) f32):
    ``codecs.components_Q4_K``'s q, scales and offsets."""
    return _extract("ggqt_extract_q4k", 144, 8, False, blocks)


def extract_q5k(blocks: np.ndarray):
    """(n, 176) Q5_K blocks → (q u8, A (n, 8), B (n, 8)), as
    ``codecs.components_Q5_K``."""
    return _extract("ggqt_extract_q5k", 176, 8, False, blocks)


def extract_q2k(blocks: np.ndarray):
    """(n, 84) Q2_K blocks → (q u8, A (n, 16), B (n, 16)), as
    ``codecs.components_Q2_K``."""
    return _extract("ggqt_extract_q2k", 84, 16, False, blocks)


def extract_q6k(blocks: np.ndarray):
    """(n, 210) Q6_K blocks → (q (n, 256) i8, A (n, 16) f32), as
    ``codecs.components_Q6_K``."""
    return _extract("ggqt_extract_q6k", 210, 16, True, blocks)


def extract_q3k(blocks: np.ndarray):
    """(n, 110) Q3_K blocks → (q i8, A (n, 16)), as
    ``codecs.components_Q3_K``."""
    return _extract("ggqt_extract_q3k", 110, 16, True, blocks)


def _plane_args(q: np.ndarray, rp: int, dtype):
    if q.ndim != 2:
        raise ValueError(f"codes must be (R, K), got shape {q.shape}")
    R, K = q.shape
    if rp < R:
        raise ValueError(f"padded width {rp} < {R} rows")
    return np.ascontiguousarray(q, dtype=dtype), R, K


def pack_nib4_planar(q: np.ndarray, rp: int) -> np.ndarray:
    """(R, K) uint8 codes → the (K/2, rp) nib4 plane: byte [j, r] holds
    code (r, j) in its low nibble and (r, j + K/2) in its high one, zero
    lanes past R (``planar.nib4_plane``)."""
    q, R, K = _plane_args(q, rp, np.uint8)
    if K % 2:
        raise ValueError(f"nib4 needs an even K, got {K}")
    out = np.empty((K // 2, rp), dtype=np.uint8)
    _call("ggqt_pack_nib4_planar", _ptr(q, ctypes.c_uint8),
          _ptr(out, ctypes.c_uint8), R, K, rp, _threads())
    return out


def transpose_i8(q: np.ndarray, rp: int) -> np.ndarray:
    """(R, K) int8 codes → the (K, rp) int8 plane, zero lanes past R
    (``planar.int8_plane``)."""
    q, R, K = _plane_args(q, rp, np.int8)
    out = np.empty((K, rp), dtype=np.int8)
    _call("ggqt_transpose_i8", _ptr(q, ctypes.c_int8),
          _ptr(out, ctypes.c_int8), R, K, rp, _threads())
    return out
