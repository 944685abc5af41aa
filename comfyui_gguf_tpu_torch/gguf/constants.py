"""GGUF / GGML container constants.

The port's own copy of ``comfyui_gguf_tpu/gguf/constants.py``: the GGUF v3
on-disk format and the GGML quantization type table, so the port depends on
nothing but numpy and torch.

Format references: the ggml quantization block sizes and the GGUF spec
(github.com/ggml-org/ggml/blob/master/docs/gguf.md).
"""

from __future__ import annotations

import enum

GGUF_MAGIC = 0x46554747  # little-endian "GGUF"
GGUF_VERSION = 3
GGUF_DEFAULT_ALIGNMENT = 32

# Metadata key used by the reference converter to preserve shapes that were
# rearranged to satisfy 256-wide quant blocks (reference tools/convert.py:295,
# loader.py:16-24).
ORIG_SHAPE_KEY = "comfy.gguf.orig_shape.{name}"

MAX_TENSOR_DIMS = 4  # GGUF tensor-info carries at most 4 dims


class GGUFValueType(enum.IntEnum):
    UINT8 = 0
    INT8 = 1
    UINT16 = 2
    INT16 = 3
    UINT32 = 4
    INT32 = 5
    FLOAT32 = 6
    BOOL = 7
    STRING = 8
    ARRAY = 9
    UINT64 = 10
    INT64 = 11
    FLOAT64 = 12


class GGMLQuantizationType(enum.IntEnum):
    F32 = 0
    F16 = 1
    Q4_0 = 2
    Q4_1 = 3
    # 4, 5 were Q4_2 / Q4_3 (removed upstream)
    Q5_0 = 6
    Q5_1 = 7
    Q8_0 = 8
    Q8_1 = 9
    Q2_K = 10
    Q3_K = 11
    Q4_K = 12
    Q5_K = 13
    Q6_K = 14
    Q8_K = 15
    IQ2_XXS = 16
    IQ2_XS = 17
    IQ3_XXS = 18
    IQ1_S = 19
    IQ4_NL = 20
    IQ3_S = 21
    IQ2_S = 22
    IQ4_XS = 23
    I8 = 24
    I16 = 25
    I32 = 26
    I64 = 27
    F64 = 28
    IQ1_M = 29
    BF16 = 30


QK_K = 256  # K-quant superblock length
K_SCALE_SIZE = 12  # bytes of packed 6-bit scale/min pairs in Q4_K/Q5_K

# (elements per block, bytes per block). Matches ggml's GGML_QUANT_SIZES as
# exercised by reference dequant.py:34 and the byte math in its decoders.
GGML_QUANT_SIZES: dict[GGMLQuantizationType, tuple[int, int]] = {
    GGMLQuantizationType.F32: (1, 4),
    GGMLQuantizationType.F16: (1, 2),
    GGMLQuantizationType.Q4_0: (32, 18),
    GGMLQuantizationType.Q4_1: (32, 20),
    GGMLQuantizationType.Q5_0: (32, 22),
    GGMLQuantizationType.Q5_1: (32, 24),
    GGMLQuantizationType.Q8_0: (32, 34),
    GGMLQuantizationType.Q8_1: (32, 36),
    GGMLQuantizationType.Q2_K: (256, 84),
    GGMLQuantizationType.Q3_K: (256, 110),
    GGMLQuantizationType.Q4_K: (256, 144),
    GGMLQuantizationType.Q5_K: (256, 176),
    GGMLQuantizationType.Q6_K: (256, 210),
    GGMLQuantizationType.Q8_K: (256, 292),
    GGMLQuantizationType.IQ2_XXS: (256, 66),
    GGMLQuantizationType.IQ2_XS: (256, 74),
    GGMLQuantizationType.IQ3_XXS: (256, 98),
    GGMLQuantizationType.IQ1_S: (256, 50),
    GGMLQuantizationType.IQ4_NL: (32, 18),
    GGMLQuantizationType.IQ3_S: (256, 110),
    GGMLQuantizationType.IQ2_S: (256, 82),
    GGMLQuantizationType.IQ4_XS: (256, 136),
    GGMLQuantizationType.I8: (1, 1),
    GGMLQuantizationType.I16: (1, 2),
    GGMLQuantizationType.I32: (1, 4),
    GGMLQuantizationType.I64: (1, 8),
    GGMLQuantizationType.F64: (1, 8),
    GGMLQuantizationType.IQ1_M: (256, 56),
    GGMLQuantizationType.BF16: (1, 2),
}


class LlamaFileType(enum.IntEnum):
    """``general.file_type`` values (subset used by the converter/quantizer).

    Mirrors llama.cpp's llama_ftype; the reference writes MOSTLY_F16 /
    MOSTLY_BF16 at conversion (tools/convert.py:324,330) and the patched
    quantizer maps these to per-tensor recipes (tools/lcpp.patch:129-255).
    """

    ALL_F32 = 0
    MOSTLY_F16 = 1
    MOSTLY_Q4_0 = 2
    MOSTLY_Q4_1 = 3
    MOSTLY_Q8_0 = 7
    MOSTLY_Q5_0 = 8
    MOSTLY_Q5_1 = 9
    MOSTLY_Q2_K = 10
    MOSTLY_Q3_K_S = 11
    MOSTLY_Q3_K_M = 12
    MOSTLY_Q3_K_L = 13
    MOSTLY_Q4_K_S = 14
    MOSTLY_Q4_K_M = 15
    MOSTLY_Q5_K_S = 16
    MOSTLY_Q5_K_M = 17
    MOSTLY_Q6_K = 18
    MOSTLY_IQ4_NL = 25
    MOSTLY_IQ4_XS = 30
    MOSTLY_BF16 = 32

    @property
    def default_qtype(self) -> GGMLQuantizationType:
        return _FTYPE_DEFAULT_QTYPE[self]


T = GGMLQuantizationType
_FTYPE_DEFAULT_QTYPE = {
    LlamaFileType.ALL_F32: T.F32,
    LlamaFileType.MOSTLY_F16: T.F16,
    LlamaFileType.MOSTLY_BF16: T.BF16,
    LlamaFileType.MOSTLY_Q4_0: T.Q4_0,
    LlamaFileType.MOSTLY_Q4_1: T.Q4_1,
    LlamaFileType.MOSTLY_Q5_0: T.Q5_0,
    LlamaFileType.MOSTLY_Q5_1: T.Q5_1,
    LlamaFileType.MOSTLY_Q8_0: T.Q8_0,
    LlamaFileType.MOSTLY_Q2_K: T.Q2_K,
    LlamaFileType.MOSTLY_Q3_K_S: T.Q3_K,
    LlamaFileType.MOSTLY_Q3_K_M: T.Q3_K,
    LlamaFileType.MOSTLY_Q3_K_L: T.Q3_K,
    LlamaFileType.MOSTLY_Q4_K_S: T.Q4_K,
    LlamaFileType.MOSTLY_Q4_K_M: T.Q4_K,
    LlamaFileType.MOSTLY_Q5_K_S: T.Q5_K,
    LlamaFileType.MOSTLY_Q5_K_M: T.Q5_K,
    LlamaFileType.MOSTLY_Q6_K: T.Q6_K,
    LlamaFileType.MOSTLY_IQ4_NL: T.IQ4_NL,
    LlamaFileType.MOSTLY_IQ4_XS: T.IQ4_XS,
}
del T

GGML_QUANT_VERSION = 2


def blocks_for(n_elements: int, qtype: GGMLQuantizationType) -> int:
    block, _ = GGML_QUANT_SIZES[qtype]
    if n_elements % block != 0:
        raise ValueError(
            f"{n_elements} elements not divisible by {qtype.name} block size {block}"
        )
    return n_elements // block


def nbytes_for(n_elements: int, qtype: GGMLQuantizationType) -> int:
    _, type_size = GGML_QUANT_SIZES[qtype]
    return blocks_for(n_elements, qtype) * type_size


def bits_per_weight(qtype: GGMLQuantizationType) -> float:
    block, type_size = GGML_QUANT_SIZES[qtype]
    return type_size * 8.0 / block


def align_up(x: int, a: int) -> int:
    """Round ``x`` up to a multiple of ``a`` (GGUF data-section
    alignment; shared by reader and writer)."""
    return (x + a - 1) // a * a
