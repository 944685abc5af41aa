"""GGUF → PyTorch state-dict loading (port of comfyui_gguf_tpu/loader.py).

* Stage 1, ``gguf_sd_loader``: file → ``{key: QTensor}`` lazy records over
  the file mmap, with architecture detection/validation, prefix stripping,
  ``comfy.gguf.orig_shape`` metadata and the 1-D BF16 fix — nothing is
  decoded yet.
* Stage 2, ``to_torch_params``: conforming 2-D quantized weights are
  re-tiled once into the planar layout (quant/planar.py) and stay packed on
  the device; everything else is dequantized to a dense tensor. Scale and
  offset planes stay float32.

``gguf_clip_loader`` is the text-encoder entry: key maps, tokenizer
metadata (``TokenizerSpec``), the early decode of huge token embeddings and,
for a qwen2vl encoder, the merge of its mmproj sidecar (the Qwen2-VL /
Qwen2.5-VL vision tower, ``gguf_mmproj_loader``).
"""

from __future__ import annotations

import dataclasses
import logging
import os
import re

import numpy as np
import torch

from ._device import resolve_device
from .archs import IMG_ARCH_LIST, TXT_ARCH_LIST, VIS_TYPE_LIST, detect_arch
from .gguf.constants import GGML_QUANT_SIZES, GGMLQuantizationType
from .gguf.reader import GGUFReader
from .maps import (CLIP_VISION_SD_MAP, LLAMA_SD_MAP, T5_SD_MAP,
                   sd_map_replace, unpermute_gqa_rows)
from .nn.layers import DEFAULT_CONFIG, QuantConfig
from .quant import codecs
from .quant.planar import planarize

Q = GGMLQuantizationType
log = logging.getLogger(__name__)

_PASSTHROUGH = {Q.F32, Q.F16}


@dataclasses.dataclass
class QTensor:
    """Lazy on-disk tensor: packed payload + logical shape + qtype."""

    name: str
    qtype: GGMLQuantizationType
    shape: tuple[int, ...]  # logical, numpy/torch order
    data: np.ndarray  # mmap view: packed (n_blocks, ts) or typed array
    is_largest_weight: bool = False

    @property
    def is_quantized(self) -> bool:
        return self.qtype not in _PASSTHROUGH

    @property
    def numel(self) -> int:
        n = 1
        for d in self.shape:
            n *= d
        return n

    def dequantize(self, dtype=np.float32) -> np.ndarray:
        """Full host-side decode to the logical shape."""
        out = codecs.dequantize(self.data, self.qtype, self.shape)
        return out.astype(dtype, copy=False)

    def permute_rows(self, n_head: int) -> "QTensor":
        """GQA un-permute on whole rows (every row is whole blocks)."""
        r = self.shape[0]
        flat = np.ascontiguousarray(self.data).reshape(r, -1)
        out = unpermute_gqa_rows(flat, n_head).reshape(self.data.shape)
        return dataclasses.replace(self, data=np.ascontiguousarray(out))


def _squeeze_trailing_ones(shape: tuple[int, ...]) -> tuple[int, ...]:
    shape = list(shape)
    while len(shape) > 2 and shape[-1] == 1:
        shape.pop()
    return tuple(shape)


def gguf_sd_loader(path: str,
                   handle_prefix: str | None = "model.diffusion_model.",
                   return_arch: bool = False, is_text_model: bool = False,
                   reader: GGUFReader | None = None):
    """GGUF file → ``{key: QTensor}`` (reference loader.py:51-141).

    Detects/validates the architecture (sd.cpp / "pig" / "cow" compat files
    by key fingerprints), strips the state-dict prefix, honours
    ``comfy.gguf.orig_shape`` metadata, eagerly decodes 1-D BF16 tensors and
    marks the largest quantized tensor.
    """
    reader = reader or GGUFReader(path)

    has_prefix = False
    if handle_prefix is not None:
        names = {t.name for t in reader.tensors}
        has_prefix = any(n.startswith(handle_prefix) for n in names)
    tensors = []
    for t in reader.tensors:
        sd_key = t.name
        if has_prefix:
            if not sd_key.startswith(handle_prefix):
                continue
            sd_key = sd_key[len(handle_prefix):]
        tensors.append((sd_key, t))

    compat = None
    arch_str = reader.get_str("general.architecture")
    type_str = reader.get_str("general.type")
    if arch_str in (None, "pig", "cow"):
        if is_text_model:
            raise ValueError(
                f"This gguf file is incompatible with llama.cpp "
                f"(no/containers-only architecture metadata): {path}")
        compat = "sd.cpp" if arch_str is None else arch_str
        try:
            arch_str = detect_arch({k for k, _ in tensors}).arch
        except ValueError as e:
            raise ValueError(
                f"This model is not currently supported - ({e})") from None
    elif is_text_model and arch_str not in TXT_ARCH_LIST:
        if type_str not in VIS_TYPE_LIST:
            raise ValueError(
                f"Unexpected text model architecture in GGUF file: "
                f"{arch_str!r}")
    elif not is_text_model and arch_str not in IMG_ARCH_LIST:
        raise ValueError(
            f"Unexpected architecture type in GGUF file: {arch_str!r}")
    if compat:
        log.warning("gguf loaded in compatibility mode %r [arch:%s]",
                    compat, arch_str)

    state_dict: dict[str, QTensor] = {}
    undecodable: list[tuple[str, GGMLQuantizationType]] = []
    for sd_key, t in tensors:
        shape = reader.get_orig_shape(t.name)
        if shape is None:
            shape = t.shape
            # stable-diffusion.cpp SDXL stores proj layers as (N, M, 1, 1)
            if compat == "sd.cpp" and arch_str == "sdxl" and sd_key.endswith(
                    (".proj_in.weight", ".proj_out.weight")):
                shape = _squeeze_trailing_ones(shape)
        qt = QTensor(name=t.name, qtype=t.qtype, shape=tuple(shape),
                     data=t.data)
        # IQ1/IQ2/IQ3 need llama.cpp codebook tables: collected, so ONE
        # load-time error names the full set; with
        # GGUF_TPU_SKIP_UNDECODABLE=1 they are skipped with a warning
        if not codecs.can_decode(qt.qtype):
            undecodable.append((t.name, qt.qtype))
            continue
        # 1-D tensors shouldn't stay quantized — BF16 fix
        if len(shape) <= 1 and t.qtype == Q.BF16:
            qt = QTensor(name=t.name, qtype=Q.F32, shape=tuple(shape),
                         data=qt.dequantize(np.float32))
        state_dict[sd_key] = qt
    if undecodable:
        names = ", ".join(f"{n!r} [{q.name}]" for n, q in undecodable)
        if os.environ.get("GGUF_TPU_SKIP_UNDECODABLE", "") not in ("", "0"):
            log.warning(
                "skipping %d undecodable tensor(s) "
                "(GGUF_TPU_SKIP_UNDECODABLE=1): %s — the model will run "
                "WITHOUT these weights; expect failures unless the arch "
                "tolerates missing keys", len(undecodable), names)
        else:
            codecs.require_decoder(
                undecodable[0][1],
                context=f"{len(undecodable)} tensor(s): {names}; set "
                        "GGUF_TPU_SKIP_UNDECODABLE=1 to load the rest")

    quant_keys = [k for k, v in state_dict.items() if v.is_quantized]
    if quant_keys:
        kmax = max(quant_keys, key=lambda k: state_dict[k].numel)
        state_dict[kmax].is_largest_weight = True

    if return_arch:
        return state_dict, arch_str
    return state_dict


# ---------------------------------------------------------------------------
# tokenizer metadata recovery: structured data for the native tokenizers
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class TokenizerSpec:
    """Tokenizer rebuilt from GGUF ``tokenizer.ggml.*`` metadata."""

    model: str  # "t5" (unigram) | "gpt2" (byte-level BPE)
    tokens: list[str]
    scores: list[float] | None
    token_types: list[int] | None  # llama.cpp: 1=normal 2=unk 3=control 6=byte
    merges: list[str] | None = None
    bos_id: int | None = None
    eos_id: int | None = None
    pad_id: int | None = None
    unk_id: int | None = None
    add_space_prefix: bool = True
    remove_extra_whitespaces: bool = False
    add_bos: bool = False
    add_eos: bool = True


def gguf_tokenizer_spec(reader: GGUFReader) -> TokenizerSpec | None:
    model = reader.get_str("tokenizer.ggml.model")
    tokens = reader.get_list("tokenizer.ggml.tokens")
    if model is None or tokens is None:
        return None
    g = reader
    return TokenizerSpec(
        model=model,
        tokens=list(tokens),
        scores=g.get_list("tokenizer.ggml.scores")
        if g.get_field("tokenizer.ggml.scores") else None,
        token_types=g.get_list("tokenizer.ggml.token_type")
        if g.get_field("tokenizer.ggml.token_type") else None,
        merges=g.get_list("tokenizer.ggml.merges")
        if g.get_field("tokenizer.ggml.merges") else None,
        bos_id=g.get_int("tokenizer.ggml.bos_token_id"),
        eos_id=g.get_int("tokenizer.ggml.eos_token_id"),
        pad_id=g.get_int("tokenizer.ggml.padding_token_id"),
        unk_id=g.get_int("tokenizer.ggml.unknown_token_id"),
        add_space_prefix=bool(
            g.get_bool("tokenizer.ggml.add_space_prefix") in (None, True)
        ),
        remove_extra_whitespaces=bool(
            g.get_bool("tokenizer.ggml.remove_extra_whitespaces") or False
        ),
        # when the converter wrote no add_* keys, default per tokenizer
        # model like llama.cpp: SPM/llama → BOS yes / EOS no; T5 (unigram
        # here is t5-style) → BOS no / EOS yes; BPE → neither
        add_bos=_tok_flag(g, "tokenizer.ggml.add_bos_token",
                          default=(model == "llama")),
        add_eos=_tok_flag(g, "tokenizer.ggml.add_eos_token",
                          default=(model in ("t5", "unigram"))),
    )


def _tok_flag(reader, key: str, default: bool) -> bool:
    v = reader.get_bool(key)
    return default if v is None else bool(v)


_QUANT_SUFFIX_RE = re.compile(
    r"[-_]?(?:ud-)?i?q[0-9]_[a-z0-9_\-]{1,8}$", re.IGNORECASE
)


def strip_quant_suffix(name: str) -> str:
    """Drop a trailing quant tag (``-Q4_K_M`` etc.) from a model filename."""
    m = _QUANT_SUFFIX_RE.search(name)
    return name[: m.start()] if m else name


def find_mmproj(path: str) -> str | None:
    """The mmproj sidecar GGUF next to a text-encoder file: the one ``.gguf``
    in its directory whose name holds "mmproj" and the encoder's file name
    without its quant tag (case-insensitive); the first in sorted order
    where several match, None (logged) where none does."""
    tenc = strip_quant_suffix(
        os.path.splitext(os.path.basename(path))[0].lower())
    root = os.path.dirname(path) or "."
    matches = []
    for fname in sorted(os.listdir(root)):
        name, ext = os.path.splitext(fname)
        if ext.lower() != ".gguf" or "mmproj" not in name.lower():
            continue
        if tenc in name.lower():
            matches.append(fname)
    if not matches:
        log.error("no mmproj sidecar found for %r (matching %r)", path, tenc)
        return None
    if len(matches) > 1:
        log.error("ambiguous mmproj for %r; using first match", path)
    return os.path.join(root, matches[0])


def _f32(name: str, arr: np.ndarray) -> QTensor:
    arr = np.ascontiguousarray(arr, np.float32)
    return QTensor(name=name, qtype=Q.F32, shape=arr.shape, data=arr)


def gguf_mmproj_loader(path: str) -> dict[str, QTensor]:
    """The vision tower of the text encoder at ``path`` from its mmproj
    sidecar (``find_mmproj``), as ``visual.*`` keys: the two 4-D
    ``v.patch_embd.weight`` chunks stacked along axis 2 into the 5-D
    temporal patch kernel, llama.cpp's names mapped by
    ``CLIP_VISION_SD_MAP``, and split q/k/v re-fused into one float32
    ``attn.qkv`` per block. {} where there is no sidecar."""
    target = find_mmproj(path)
    if target is None:
        return {}
    vsd = gguf_sd_loader(target, is_text_model=True)
    if "v.patch_embd.weight.1" in vsd:
        w1 = vsd.pop("v.patch_embd.weight").dequantize()
        w2 = vsd.pop("v.patch_embd.weight.1").dequantize()
        vsd["v.patch_embd.weight"] = _f32("v.patch_embd.weight",
                                          np.stack([w1, w2], axis=2))
    vsd = sd_map_replace(vsd, CLIP_VISION_SD_MAP)
    if "visual.blocks.0.attn_q.weight" in vsd:
        groups: dict[str, dict[str, np.ndarray]] = {}
        for k in list(vsd):
            if any(x in k for x in ("attn_q", "attn_k", "attn_v")):
                prefix, leaf = k.rsplit(".attn_", 1)
                fused = f"{prefix}.attn.qkv.{leaf.split('.')[-1]}"
                groups.setdefault(fused, {})[leaf] = vsd.pop(k).dequantize()
        for fused, parts in groups.items():
            suffix = fused.split(".")[-1]
            vsd[fused] = _f32(fused, np.concatenate(
                [parts[f"{c}.{suffix}"] for c in "qkv"], axis=0))
    return vsd


# ---------------------------------------------------------------------------
# text-encoder entry
# ---------------------------------------------------------------------------

BIG_EMBED_VOCAB = 64 * 1024  # dequant-early threshold


def gguf_clip_loader(path: str):
    """Load a text-encoder GGUF: remap keys, recover tokenizer metadata,
    eagerly decode huge token embeddings, merge a qwen2vl file's mmproj
    sidecar (``gguf_mmproj_loader``).

    Returns ``(state_dict, arch, TokenizerSpec | None)``.
    """
    # ONE metadata parse: big-vocab tokenizer KV decode (32k-256k
    # python-loop string entries) is the expensive part of reading
    reader = GGUFReader(path)
    sd, arch = gguf_sd_loader(path, return_arch=True, is_text_model=True,
                              reader=reader)
    tok = gguf_tokenizer_spec(reader)
    temb_key = "token_embd.weight"

    if arch in ("t5", "t5encoder"):
        if temb_key in sd and sd[temb_key].is_quantized:
            log.warning("dequantizing %s early (big-embed guard)", temb_key)
            sd[temb_key] = _dense(sd[temb_key], np.float16)
        sd = sd_map_replace(sd, T5_SD_MAP)
    elif arch in ("llama", "qwen2vl", "qwen3", "qwen3vl"):
        sd = sd_map_replace(big_embed_guard(sd), LLAMA_SD_MAP)
        if arch == "llama":
            # L3 / Mistral GQA layout
            for k in list(sd.keys()):
                if k.endswith(("q_proj.weight", "q_proj.bias")):
                    sd[k] = sd[k].permute_rows(32)
                elif k.endswith(("k_proj.weight", "k_proj.bias")):
                    sd[k] = sd[k].permute_rows(8)
        if arch == "qwen2vl":
            sd.update(gguf_mmproj_loader(path))
    return sd, arch, tok


def big_embed_guard(sd: dict[str, QTensor]) -> dict[str, QTensor]:
    """A llama-family token embedding of ``BIG_EMBED_VOCAB`` rows or more
    (llama.cpp names) is decoded to f16 here, on the host, as the reference
    loader does; ``to_torch_params`` then places it as a dense table.
    Mutates ``sd`` and returns it."""
    key = "token_embd.weight"
    if key in sd and sd[key].shape[0] >= BIG_EMBED_VOCAB:
        log.warning("dequantizing %s early (big-embed guard)", key)
        sd[key] = _dense(sd[key], np.float16)
    return sd


def _dense(qt: QTensor, dtype) -> QTensor:
    return QTensor(name=qt.name, qtype=Q.F32 if dtype == np.float32 else Q.F16,
                   shape=qt.shape, data=qt.dequantize(dtype))


def _planarizable(qt: QTensor) -> bool:
    if not qt.is_quantized or len(qt.shape) != 2:
        return False
    block, _ = GGML_QUANT_SIZES[qt.qtype]
    k = qt.shape[1]
    if qt.qtype not in codecs.COMPONENT_EXTRACTORS:
        return False
    # planarize pads K to a 512 multiple, so any block-aligned row width
    # re-tiles — but for small K the pad would bloat storage past dense
    # bf16; keep those eager-dequantized
    return k % block == 0 and (k % 512 == 0 or k >= 1024)


def _tensor(arr: np.ndarray, dtype, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(arr)).to(device=device,
                                                          dtype=dtype)


def to_torch_params(sd: dict[str, QTensor],
                    cfg: QuantConfig = DEFAULT_CONFIG,
                    device="cuda") -> dict[str, object]:
    """QTensor dict → device tensors: PlanarQuant for conforming 2-D
    quantized weights, dense tensors for the rest (the reference's
    ``to_jax_params`` policy). Runs on the card unless ``device`` says
    otherwise; raises if CUDA is asked for and absent.

    ``GGUF_TPU_BF16_SCALES=1`` stores the planar scale and offset planes in
    bfloat16 (Q4_K: 0.625 instead of 0.75 bytes a weight); the kernels and
    the plain path widen them to float32 exactly."""
    device = resolve_device(device)
    scale_dtype = (torch.bfloat16
                   if os.environ.get("GGUF_TPU_BF16_SCALES", "")
                   not in ("", "0") else torch.float32)
    params: dict[str, object] = {}
    for key, qt in sd.items():
        if not qt.is_quantized:
            arr = qt.dequantize(np.float32)
            # F32-stored tensors are the converter's high-precision set
            # (modulation tables, pos encodings); keep them f32 unless
            # they're actually large
            keep_f32 = (arr.ndim <= 1
                        or (qt.qtype == Q.F32 and arr.size < (1 << 20)))
            dt = torch.float32 if keep_f32 else cfg.compute_dtype
            params[key] = _tensor(arr, dt, device)
        elif _planarizable(qt):
            params[key] = planarize(qt.data, qt.qtype, qt.shape,
                                    device=device, scale_dtype=scale_dtype)
        else:
            arr = qt.dequantize(np.float32)
            dt = torch.float32 if arr.ndim <= 1 else cfg.dequant_dtype
            params[key] = _tensor(arr, dt, device)
    return params
