"""Mixed-precision GGUF quantizer (CLI; PyTorch port of
comfyui_gguf_tpu/tools/quantize.py, writing the same bytes).

F16/BF16/F32 GGUF → Q2_K…Q8_0 GGUF with the per-tensor recipe of
ComfyUI-GGUF's patched ``llama-quantize``:

* tier bumps for sensitive tensors — attn_v / fused-qkv / ffn_down raised
  one-two qtypes per ftype (``tensor_qtype``);
* per-arch exclusion lists keeping embedders / modulation / final layers
  unquantized (``archs.py``);
* only 2-D tensors quantized for image models;
* row-width check: in-features % block != 0 → F16 fallback;
* T5 relative-position bias never quantized;
* TEXT models (t5 / llama families) routed through stock llama.cpp's
  ``llama_tensor_get_type`` policy (``text_tensor_qtype``).

IQ ftypes are refused for image models, and an architecture that is
neither an image model nor a known text encoder is an error. The block
encoders are the port's numpy codecs (``quant/codecs.py``); the
reference's optional C++ fast path is not part of the port.

Usage:  python -m comfyui_gguf_tpu_torch.tools.quantize --src m-F16.gguf \
            --ftype Q4_K_M [--dst out.gguf]
"""

from __future__ import annotations

import argparse
import logging

import numpy as np

from ..archs import IMG_ARCH_LIST, TXT_ARCH_LIST, get_arch_spec
from ..gguf.constants import GGMLQuantizationType, LlamaFileType, QK_K
from ..gguf.reader import GGUFReader
from ..gguf.writer import GGUFWriter
from ..quant import codecs

Q = GGMLQuantizationType
F = LlamaFileType
log = logging.getLogger(__name__)

# name fragments identifying sensitive tensor classes
ATTN_V_PATTERNS = ("attn_v.weight", ".to_v.weight", ".v.weight",
                   ".attn.w1v.weight", ".attn.w2v.weight",
                   "_attn.v_proj.weight")
QKV_PATTERNS = ("attn_qkv.weight", "attn.qkv.weight", "attention.qkv.weight")
FFN_DOWN_PATTERNS = (".ffn.2.weight", ".ff.net.2.weight",
                     ".mlp.layer2.weight", ".adaln_modulation_mlp.2.weight",
                     ".feed_forward.w2.weight")


def _is_attn_v(name: str) -> bool:
    return any(p in name for p in ATTN_V_PATTERNS)


def _is_qkv(name: str) -> bool:
    return any(p in name for p in QKV_PATTERNS)


def _is_ffn_down(name: str) -> bool:
    if "ffn_down" in name:
        return True
    if "experts." in name and ".w2.weight" in name:
        return True
    return any(p in name for p in FFN_DOWN_PATTERNS)


class QuantState:
    """Running counters used by layer-position-dependent rules."""

    def __init__(self, n_attention_wv: int = 0, n_ffn_down: int = 0,
                 n_gqa: int = 1):
        self.i_attention_wv = 0
        self.i_ffn_down = 0
        self.n_fallback = 0
        # totals + GQA ratio feed the text-model layer-position rules
        # (llama.cpp llama_tensor_get_type); unused by the image recipe
        self.n_attention_wv = n_attention_wv
        self.n_ffn_down = n_ffn_down
        self.n_gqa = n_gqa


def tensor_qtype(name: str, shape: tuple[int, ...], ftype: LlamaFileType,
                 qs: QuantState) -> GGMLQuantizationType:
    """Per-tensor qtype selection for image models (the patched
    llama-quantize's ``img_tensor_get_type``)."""
    new_type = ftype.default_qtype

    if _is_attn_v(name):
        if ftype == F.MOSTLY_Q2_K:
            new_type = Q.Q3_K
        elif ftype == F.MOSTLY_Q3_K_M:
            new_type = Q.Q5_K if qs.i_attention_wv < 2 else Q.Q4_K
        elif ftype == F.MOSTLY_Q3_K_L:
            new_type = Q.Q5_K
        elif ftype in (F.MOSTLY_Q4_K_M, F.MOSTLY_Q5_K_M):
            new_type = Q.Q6_K
        elif ftype == F.MOSTLY_Q4_K_S and qs.i_attention_wv < 4:
            new_type = Q.Q5_K
        qs.i_attention_wv += 1
    elif _is_qkv(name):
        if ftype in (F.MOSTLY_Q3_K_M, F.MOSTLY_Q3_K_L):
            new_type = Q.Q4_K
        elif ftype == F.MOSTLY_Q4_K_M:
            new_type = Q.Q5_K
        elif ftype == F.MOSTLY_Q5_K_M:
            new_type = Q.Q6_K
    elif _is_ffn_down(name):
        if ftype == F.MOSTLY_Q3_K_M:
            new_type = Q.Q4_K
        elif ftype == F.MOSTLY_Q3_K_L:
            new_type = Q.Q5_K
        elif ftype == F.MOSTLY_Q4_K_S:
            new_type = Q.Q5_K
        elif ftype in (F.MOSTLY_Q4_K_M, F.MOSTLY_Q5_K_M):
            new_type = Q.Q6_K
        elif ftype == F.MOSTLY_Q4_0:
            new_type = Q.Q4_1
        elif ftype == F.MOSTLY_Q5_0:
            new_type = Q.Q5_1
        qs.i_ffn_down += 1

    # row-width sanity: rows must hold whole blocks (every format)
    from ..gguf.constants import GGML_QUANT_SIZES

    block = GGML_QUANT_SIZES[new_type][0]
    if block > 1 and shape[-1] % block != 0:
        log.warning("%s: row width %d %% %d != 0 — F16 fallback",
                    name, shape[-1], block)
        new_type = Q.F16
        qs.n_fallback += 1
    return new_type


def _use_more_bits(i_layer: int, n_layers: int) -> bool:
    """llama.cpp's use_more_bits: bump the first and last eighth of the
    layers plus every third layer in between."""
    return (i_layer < n_layers // 8 or i_layer >= 7 * n_layers // 8
            or (i_layer - n_layers // 8) % 3 == 2)


# misaligned-row conversion ladder for text models (llama.cpp quantizes to
# the nearest narrower format whose block divides the row instead of
# falling all the way back to F16)
_TEXT_ROW_FALLBACK = {
    Q.Q2_K: Q.IQ4_NL, Q.Q3_K: Q.IQ4_NL, Q.IQ4_XS: Q.IQ4_NL,
    Q.Q4_K: Q.Q5_0, Q.Q5_K: Q.Q5_1, Q.Q6_K: Q.Q8_0,
}


def text_tensor_qtype(name: str, shape: tuple[int, ...],
                      ftype: LlamaFileType,
                      qs: QuantState) -> GGMLQuantizationType:
    """Per-tensor qtype selection for TEXT models (t5 / llama families).

    Ports the non-imatrix core of llama.cpp's ``llama_tensor_get_type``
    (src/llama-quant.cpp) — the policy stock ``llama-quantize`` applies to
    text-encoder GGUFs (the patched binary's ``img_tensor_get_type`` only
    replaces it for image archs).
    Name fragments match llama.cpp tensor naming, which covers both llama
    (``blk.N.attn_v.weight``) and t5 (``enc.blk.N.attn_v.weight``).
    MoE/Falcon/70B special cases are out of scope (no text encoder the
    loader supports hits them).
    """
    new_type = ftype.default_qtype

    if name in ("output.weight", "dec.output.weight"):
        # keep the logits projection high-precision for every K ftype
        if shape[-1] % QK_K != 0:
            new_type = Q.Q8_0
        elif new_type not in (Q.Q8_0, Q.F16, Q.BF16, Q.F32):
            new_type = Q.Q6_K
    elif "attn_v.weight" in name:
        if ftype == F.MOSTLY_Q2_K:
            new_type = Q.Q4_K if qs.n_gqa >= 4 else Q.Q3_K
        elif ftype == F.MOSTLY_Q3_K_M:
            new_type = Q.Q5_K if qs.i_attention_wv < 2 else Q.Q4_K
        elif ftype == F.MOSTLY_Q3_K_L:
            new_type = Q.Q5_K
        elif (ftype in (F.MOSTLY_Q4_K_M, F.MOSTLY_Q5_K_M)
                and _use_more_bits(qs.i_attention_wv, qs.n_attention_wv)):
            new_type = Q.Q6_K
        elif ftype == F.MOSTLY_Q4_K_S and qs.i_attention_wv < 4:
            new_type = Q.Q5_K
        qs.i_attention_wv += 1
    elif "attn_qkv.weight" in name:
        if ftype in (F.MOSTLY_Q3_K_M, F.MOSTLY_Q3_K_L):
            new_type = Q.Q4_K
        elif ftype == F.MOSTLY_Q4_K_M:
            new_type = Q.Q5_K
        elif ftype == F.MOSTLY_Q5_K_M:
            new_type = Q.Q6_K
    elif "attn_output.weight" in name:
        if ftype == F.MOSTLY_Q2_K:
            new_type = Q.Q3_K
        elif ftype == F.MOSTLY_Q3_K_M:
            new_type = Q.Q4_K
        elif ftype == F.MOSTLY_Q3_K_L:
            new_type = Q.Q5_K
    elif "ffn_down" in name:
        i, n = qs.i_ffn_down, max(qs.n_ffn_down, 1)
        if ftype == F.MOSTLY_Q2_K:
            new_type = Q.Q3_K
        elif ftype == F.MOSTLY_Q3_K_M:
            new_type = Q.Q5_K if i < n // 16 else Q.Q4_K
        elif ftype == F.MOSTLY_Q3_K_L:
            new_type = Q.Q5_K
        elif ftype == F.MOSTLY_Q4_K_M and _use_more_bits(i, n):
            new_type = Q.Q6_K
        elif ftype == F.MOSTLY_Q5_K_M and _use_more_bits(i, n):
            new_type = Q.Q6_K
        elif ftype == F.MOSTLY_Q4_K_S and i < n // 8:
            new_type = Q.Q5_K
        elif ftype == F.MOSTLY_Q4_0 and i < n // 8:
            new_type = Q.Q4_1
        elif ftype == F.MOSTLY_Q5_0 and i < n // 8:
            new_type = Q.Q5_1
        qs.i_ffn_down += 1

    # misaligned rows: walk llama.cpp's conversion ladder, then F16
    from ..gguf.constants import GGML_QUANT_SIZES

    while True:
        block = GGML_QUANT_SIZES[new_type][0]
        if block <= 1 or shape[-1] % block == 0:
            return new_type
        nxt = _TEXT_ROW_FALLBACK.get(new_type)
        if nxt is None or nxt == new_type:
            log.warning("%s: row width %d incompatible — F16 fallback",
                        name, shape[-1])
            qs.n_fallback += 1
            return Q.F16
        new_type = nxt


def should_quantize(name: str, shape: tuple[int, ...], arch: str) -> bool:
    """Exclusion rules (the arch's no-quant lists, 2-D only for image
    models, the T5 relative-position bias)."""
    if "attn_rel_b.weight" in name:
        return False
    if arch in IMG_ARCH_LIST:
        if len(shape) != 2:
            return False
        spec = get_arch_spec(arch)
        if spec is not None:
            if any(s in name for s in spec.keys_noquant):
                return False
            if name in spec.keys_noquant_exact:
                return False
        return True
    # text models: llama.cpp's gating — only .weight tensors of rank >= 2
    # (norm vectors, biases, and the 1-D position tables stay as-is)
    return name.endswith(".weight") and len(shape) >= 2


_FTYPE_BY_NAME = {f.name.replace("MOSTLY_", ""): f for f in LlamaFileType}


def quantize_file(src: str, dst: str | None, ftype_name: str) -> str:
    ftype = _FTYPE_BY_NAME[ftype_name.upper()]
    reader = GGUFReader(src)
    arch = reader.get_str("general.architecture")
    if arch is None:
        raise ValueError(f"{src}: missing general.architecture")
    # IQ ftypes are refused for image models
    if arch in IMG_ARCH_LIST and ftype in (F.MOSTLY_IQ4_NL, F.MOSTLY_IQ4_XS):
        raise ValueError(
            f"{ftype_name}: IQ quantization types are not supported for "
            f"image models (arch {arch!r})")
    # image archs get the patched recipe (tensor_qtype); text archs the
    # stock-llama.cpp policy (text_tensor_qtype)
    is_img = arch in IMG_ARCH_LIST
    if not is_img and arch not in TXT_ARCH_LIST:
        raise ValueError(
            f"arch {arch!r}: unknown architecture — neither an image model "
            f"(lcpp.patch recipe) nor a supported text encoder "
            f"(llama.cpp recipe)")

    if dst is None:
        base = src
        for suf in ("-F16.gguf", "-BF16.gguf", "-F32.gguf", ".gguf"):
            if base.endswith(suf):
                base = base[: -len(suf)]
                break
        dst = f"{base}-{ftype_name.upper()}.gguf"

    writer = GGUFWriter(arch)
    for key, val in reader.fields.items():
        if key in ("general.architecture", "general.file_type"):
            continue
        writer.add_field(key, val.type, val.value, val.item_type)
    writer.add_file_type(ftype)

    if is_img:
        qs = QuantState()
    else:
        # text rules are layer-position-dependent: precount the wv /
        # ffn_down populations and read the GQA ratio from metadata
        n_wv = sum(1 for t in reader.tensors if "attn_v.weight" in t.name)
        n_fd = sum(1 for t in reader.tensors if "ffn_down" in t.name
                   and t.name.endswith(".weight"))
        heads = reader.get_int(f"{arch}.attention.head_count") or 0
        heads_kv = reader.get_int(f"{arch}.attention.head_count_kv") or 0
        n_gqa = heads // heads_kv if heads and heads_kv else 1
        qs = QuantState(n_attention_wv=n_wv, n_ffn_down=n_fd, n_gqa=n_gqa)

    n_quantized = 0
    total_in = total_out = 0
    for t in reader.tensors:
        src_bpw = t.n_bytes / max(t.n_elements, 1)
        total_in += t.n_bytes
        if (t.qtype not in (Q.F16, Q.BF16, Q.F32)
                or not should_quantize(t.name, t.shape, arch)):
            writer.add_tensor(t.name, np.ascontiguousarray(t.data),
                              raw_dtype=t.qtype, raw_shape=t.shape)
            total_out += t.n_bytes
            continue
        new_type = (tensor_qtype if is_img else text_tensor_qtype)(
            t.name, t.shape, ftype, qs)
        if new_type == t.qtype:
            writer.add_tensor(t.name, np.ascontiguousarray(t.data),
                              raw_dtype=t.qtype, raw_shape=t.shape)
            total_out += t.n_bytes
            continue
        f32 = codecs.dequantize(t.data, t.qtype, t.shape)
        payload = codecs.quantize(f32, new_type)
        writer.add_tensor(t.name, payload, raw_dtype=new_type,
                          raw_shape=t.shape)
        total_out += payload.nbytes
        n_quantized += 1
        del f32
        log.debug("%s: %s -> %s", t.name, t.qtype.name, new_type.name)

    writer.write_to_file(dst)
    log.info("quantized %d tensors; %.1f MB -> %.1f MB (%d fallbacks)",
             n_quantized, total_in / 1e6, total_out / 1e6, qs.n_fallback)
    return dst


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--src", required=True, help="F16/BF16 .gguf input")
    ap.add_argument("--dst", help="output .gguf")
    ap.add_argument("--ftype", required=True,
                    help="target ftype, e.g. Q4_K_M, Q4_K_S, Q8_0, Q5_K_M")
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    print(quantize_file(args.src, args.dst, args.ftype))


if __name__ == "__main__":
    main()
