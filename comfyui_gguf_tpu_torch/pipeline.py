"""User-facing model loading + generation API (PyTorch port of
comfyui_gguf_tpu/pipeline.py).

* ``load_diffusion_model(path)`` — GGUF → ``DiffusionModel`` with packed
  planar weights on the card; ``apply_lora(path, strength)`` attaches a
  LoRA file (packed weights stay packed: the rank term rides the kernels'
  epilogues), ``requantize_i8()`` converts it to the w8a8 format and
  ``stack()`` restacks the blocks along a depth axis, in that order.
* ``load_text_encoders(paths)`` — text-encoder files, GGUF (T5) or
  safetensors (CLIP), each with its graph and tokenizer.
* ``load_vae(path)`` — the image AutoencoderKL or a video VAE (Wan,
  HunyuanVideo, LTX-Video) from a safetensors file.
* ``FluxPipeline.load(...).generate(prompt)`` — full text-to-image:
  tokenize → T5 + CLIP-L encode → denoise → VAE decode, with img2img,
  inpainting and Kontext references. ``TextEncoder.apply_lora`` attaches a
  LoRA file's text-encoder slice; ``textual_inversion.EmbeddingSet`` adds
  textual-inversion embeddings to an encoder.
* ``SD3Pipeline.load(...).generate(prompt)`` — SD3/SD3.5: CLIP-L ⊕ CLIP-G
  (+ T5) conditioning, CFG over the rectified-flow ODE, img2img and
  inpainting.
* ``SD1Pipeline`` / ``SDXLPipeline`` ``.generate_from_ids(...)`` — the
  eps-prediction UNets sampled in σ space (``sampling.kdiffusion``), with
  CFG, img2img, SDXL inpainting and the SDXL refiner pass.
* ``AuraPipeline(model, t5).generate(prompt)`` — AuraFlow: Pile-T5
  conditioning, CFG over the rectified-flow ODE, latent out.
* ``Lumina2Pipeline(model, text).generate(prompt)`` — Lumina Image 2.0:
  conditioning by a llama-family encoder (``load_text_encoder`` of a
  llama / qwen3 / qwen3vl GGUF), CFG over the rectified-flow ODE, latent
  out. Both build a ``CFGFlowPipeline`` with the reference's defaults.
* ``QwenImagePipeline(model, text).generate(prompt)`` — Qwen-Image:
  Qwen2.5-VL conditioning (``load_text_encoder`` of a qwen2vl GGUF merges
  its mmproj sidecar, the vision tower), CFG over the rectified-flow ODE
  on patchified tokens, latent tokens out; ``generate_edit`` adds
  reference latents (Qwen-Image-Edit), and ``qwen_vl_encode_with_image``
  conditions the encoder on an image through the vision tower.
* ``HiDreamPipeline(...).generate_from_ids(...)`` — HiDream-I1: CLIP-L ⊕
  CLIP-G pooled, T5 and llama states, the MoE DiT guidance-distilled (one
  forward a step), latent out. ``DiffusionModel.requantize_i8(max_bytes=,
  host_stage=)`` converts such a model under a byte budget.
* ``WanPipeline(model, t5, vae_params=...).generate(prompt)`` — Wan 2.1
  t2v: UMT5 states with the padded positions zeroed, CFG over the
  rectified flow on (F, H, W, C) latents, then the causal 3-D video VAE
  (``load_vae`` of a Wan VAE file gives kind "wan"); video out, or the
  latent without a VAE. ``CosmosPipeline(model, t5).generate(prompt)`` —
  Cosmos Predict2: T5 states, CFG over the rectified flow, latent out.
* ``HyVidPipeline(model, text, vae_params=...).generate(prompt)`` —
  HunyuanVideo t2v: llama-family states, guidance-distilled (one forward a
  step), then its causal VAE (``load_vae`` kind "hyvid").
  ``LTXVPipeline(model, t5, vae_params=...).generate(prompt)`` —
  LTX-Video: T5 states over flattened voxels with (t, h, w) positions,
  CFG, then its pixel-shuffle causal VAE (kind "ltxv").
* ``flux_engine`` / ``sd3_engine`` / ``unet_engine`` / ``aura_engine`` /
  ``lumina2_engine`` / ``qwen_image_engine`` / ``hidream_engine`` /
  ``wan_engine`` / ``cosmos_engine`` / ``hyvid_engine`` / ``ltxv_engine``
  — continuous-batching engines
  (serving.ContinuousBatchEngine) over a loaded model: ``submit``
  requests, ``run_until_drained``; each tick advances every pooled request
  by one Euler or per-lane DPM-Solver++(2M) step (the UNet, AuraFlow,
  Lumina 2, Wan, Cosmos and LTX-Video engines with per-request CFG).

Everything runs on the card unless the caller passes ``device="cpu"``.
The engines take a ``dp_mesh`` (data-parallel ticks) and, for flux,
Qwen-Image, Wan, HunyuanVideo and HiDream, a tensor-parallel ``mesh``
(``parallel/``); every rank runs the same engine on the same
submissions.
"""

from __future__ import annotations

import dataclasses
import functools
import logging
import os
import time

import numpy as np
import torch

from . import _safetensors
from . import lora as lora_mod
from . import observability
from ._device import resolve_device
from .loader import gguf_clip_loader, gguf_sd_loader, to_torch_params
from .models import aura as aura_model
from .models import clip as clip_model
from .models import cosmos as cosmos_model
from .models import flux as flux_model
from .models import hidream as hidream_model
from .models import hyvid as hyvid_model
from .models import hyvid_vae as hyvid_vae_model
from .models import llama as llama_model
from .models import ltxv as ltxv_model
from .models import ltxv_vae as ltxv_vae_model
from .models import lumina2 as lumina2_model
from .models import qwen_image as qi_model
from .models import qwen_vl_vision as vision_model
from .models import sd3 as sd3_model
from .models import t5 as t5_model
from .models import unet as unet_model
from .models import vae as vae_model
from .models import wan as wan_model
from .models import wan_vae as wan_vae_model
from .nn.layers import QuantConfig, embedding
from .sampling import (cfg_wrap, euler_sample_inpaint, flux_schedule,
                       linear_schedule, sample_flow, shift_sigmas)
from .sampling import kdiffusion as kd

log = logging.getLogger(__name__)

# arch -> (model module, config class, key of its depth-stacked tree)
_ARCH_TABLE = {
    "flux": (flux_model, flux_model.FluxConfig, "double_blocks"),
    "sd3": (sd3_model, sd3_model.SD3Config, "joint_blocks"),
    "sd1": (unet_model, unet_model.UNetConfig, None),
    "sdxl": (unet_model, unet_model.UNetConfig, None),
    "aura": (aura_model, aura_model.AuraConfig, "double_layers"),
    "lumina2": (lumina2_model, lumina2_model.Lumina2Config, "layers"),
    "qwen_image": (qi_model, qi_model.QwenImageConfig, "transformer_blocks"),
    "hidream": (hidream_model, hidream_model.HiDreamConfig,
                "double_stream_blocks"),
    "wan": (wan_model, wan_model.WanConfig, "blocks"),
    "cosmos": (cosmos_model, cosmos_model.CosmosConfig, "blocks"),
    "hyvid": (hyvid_model, hyvid_model.HyVidConfig, "double_blocks"),
    "ltxv": (ltxv_model, ltxv_model.LTXVConfig, "transformer_blocks"),
}


def _arch_module(arch: str):
    entry = _ARCH_TABLE.get(arch)
    if entry is None:
        raise NotImplementedError(
            f"forward graph for arch {arch!r} is not ported yet")
    return entry[0]


def _patch_dtype(qcfg: QuantConfig):
    return qcfg.effective_patch_dtype or torch.bfloat16


@dataclasses.dataclass
class DiffusionModel:
    """Loaded DiT + config; the reference plugin's GGUFModelPatcher."""

    arch: str
    params: dict
    config: object
    qcfg: QuantConfig
    device: torch.device
    base_params: dict | None = None  # the tree before the first LoRA

    @property
    def is_stacked(self) -> bool:
        entry = _ARCH_TABLE.get(self.arch)
        return (entry is not None and entry[2] is not None
                and entry[2] in self.params)

    def forward(self, *args, **kwargs):
        mod = _arch_module(self.arch)
        fn = mod.forward_stacked if self.is_stacked else mod.forward
        return fn(self.params, self.config, *args, qcfg=self.qcfg, **kwargs)

    def apply_lora(self, path: str, strength: float = 1.0):
        """Attach a LoRA file (kohya, PEFT or LyCORIS keys; every patch type
        of the reference). Packed weights stay packed: rank patches ride the
        fused kernels' epilogues. Attach BEFORE ``stack()``: the key mapping
        targets the flat per-block names, and the patches then stack with
        their blocks. Mutates self and returns it."""
        if self.is_stacked:
            raise ValueError(
                "apply_lora on a depth-stacked tree matches no keys; "
                "attach LoRAs before DiffusionModel.stack()")
        if self.base_params is None:
            self.base_params = self.params
        self.params = lora_mod.load_and_attach(
            self.params, path, strength=strength,
            dtype=_patch_dtype(self.qcfg))
        return self

    def unapply_loras(self):
        """Drop every attached patch (the reference plugin's
        unpatch_model), of a stacked tree too."""
        self.params = lora_mod.detach_patches(self.params)
        self.base_params = None
        return self

    def requantize_i8(self, *, mod_planar: bool = True,
                      free_source: bool = True,
                      max_bytes: int | None = None,
                      host_stage: bool | None = None) -> "DiffusionModel":
        """Convert packed planar weights to the w8a8 format (quant/i8.py).

        mod_planar: keep the adaLN/modulation projections (M=batch rows,
        bandwidth-bound) on the planar path. free_source: drop each planar
        leaf as it converts, so both trees never sit on the card at once
        (the model cannot go back to the planar tree). max_bytes: convert
        only what ``plan_i8_budget`` fits under this total packed-byte
        budget; the rest stays planar. host_stage (default: on when a budget
        is given): stage each leaf through host memory, so that the card's
        peak stays at the converted footprint. Patched leaves convert their
        base and keep their patches. Call AFTER apply_lora. Mutates self and
        returns it.
        """
        from .quant.i8 import convert_tree_i8, is_modulation_key

        pred = (lambda k, v: not is_modulation_key(k)) if mod_planar \
            else None
        if host_stage is None:
            host_stage = max_bytes is not None
        self.params = convert_tree_i8(self.params, free_source=free_source,
                                      pred=pred, max_bytes=max_bytes,
                                      host_stage=host_stage)
        self.base_params = None
        return self

    def stack(self) -> "DiffusionModel":
        """Restack per-block params along a depth axis (copies the block
        weights once); forward then runs forward_stacked. Flux, SD3,
        AuraFlow, Lumina 2, Qwen-Image, HiDream, Wan, Cosmos, HunyuanVideo
        (double and single blocks, as flux) and LTX-Video stack
        (SD3.5-medium's dual-attention blocks as their own prefix group,
        Lumina 2's refiners stay flat, HiDream's experts leaf-stacked as
        (depth, E, …)); an SD3 tree whose dual layers are not a contiguous
        prefix, and the UNets, are returned unchanged."""
        if self.is_stacked:
            return self
        stackers = {"flux": flux_model.stack_flux_params,
                    "aura": aura_model.stack_aura_params,
                    "lumina2": lumina2_model.stack_lumina2_params,
                    "qwen_image": qi_model.stack_qwen_params,
                    "hidream": hidream_model.stack_hidream_params,
                    "wan": wan_model.stack_wan_params,
                    "cosmos": cosmos_model.stack_cosmos_params,
                    "hyvid": hyvid_model.stack_hyvid_params,
                    "ltxv": ltxv_model.stack_ltxv_params}
        if self.arch in stackers:
            return dataclasses.replace(
                self, params=stackers[self.arch](self.params, self.config))
        dual = self.config.dual_attn_layers if self.arch == "sd3" else ()
        if self.arch == "sd3" and dual == tuple(range(len(dual))):
            return dataclasses.replace(
                self, params=sd3_model.stack_sd3_params(self.params,
                                                        self.config))
        return self

    def memory_report(self) -> dict:
        """Packed-vs-dense memory accounting (observability.memory_report)."""
        from .observability import memory_report

        return memory_report(self.params)


_DTYPE_NAMES = {
    "default": None, "target": None,
    "float32": torch.float32, "float16": torch.float16,
    "bfloat16": torch.bfloat16,
}


def _resolve_qcfg(dequant_dtype="default",
                  patch_dtype="default") -> QuantConfig:
    """Map the reference's Advanced-loader string knobs (``"default"``,
    ``"target"``, ``"float32"``, ``"float16"``, ``"bfloat16"``, or a torch
    dtype) onto a QuantConfig, as the reference's ``_resolve_qcfg`` does."""
    def resolve(v):
        if isinstance(v, torch.dtype) or v is None:
            return v
        if v not in _DTYPE_NAMES:
            raise ValueError(f"unknown dtype knob {v!r}: one of "
                             f"{sorted(_DTYPE_NAMES)} or a torch dtype")
        return _DTYPE_NAMES[v]

    return QuantConfig(dequant_dtype=resolve(dequant_dtype) or torch.bfloat16,
                       patch_dtype=resolve(patch_dtype))


def load_diffusion_model(path: str, device="cuda", dequant_dtype="default",
                         patch_dtype="default") -> DiffusionModel:
    """GGUF diffusion model → DiffusionModel on ``device`` (the card unless
    the caller asks for the CPU; raises if CUDA is asked for and absent).

    ``dequant_dtype`` / ``patch_dtype``: the reference's Advanced-loader
    knobs (``_resolve_qcfg``), every value on the card and on the CPU: the
    fused kernels have bfloat16, float16 and float32 instances, and their
    LoRA operands are rounded to the dequant dtype as the reference's
    kernels round them (bfloat16 in the w8a8 kernel).
    ``GGUF_TPU_COMPILE_CACHE`` names a persistent kernel build directory
    (``compile_cache.enable_from_env``); ``GGUF_TPU_TILE_CACHE`` a JSON
    table of tuned wgmma tiles (``ops.autotune``), loaded into
    ``ops.qmatmul.SHAPE_TILES`` here, each entry checked (a bad one raises
    now, not at its first launch)."""
    from .compile_cache import enable_from_env

    device = resolve_device(device)
    qcfg = _resolve_qcfg(dequant_dtype, patch_dtype)
    enable_from_env()
    if os.environ.get("GGUF_TPU_TILE_CACHE"):
        from .ops import autotune

        autotune.load_from_env()
    sd, arch = gguf_sd_loader(path, return_arch=True)
    params = to_torch_params(sd, qcfg, device=device)
    config = None
    if arch in _ARCH_TABLE:
        config = _ARCH_TABLE[arch][1].from_state_dict(params)
    return DiffusionModel(arch=arch, params=params, config=config, qcfg=qcfg,
                          device=device)


@dataclasses.dataclass
class TextEncoder:
    kind: str  # "t5" | "clip_l" | "clip_g" | "llama"
    # a qwen2vl encoder's tree also holds its vision tower (``visual.*``)
    params: dict
    config: object
    tokenizer: object | None
    qcfg: QuantConfig
    device: torch.device

    def encode(self, *args, **kwargs):
        mod = {"t5": t5_model, "clip_l": clip_model, "clip_g": clip_model,
               "llama": llama_model}[self.kind]
        with torch.no_grad():
            return mod.encode(self.params, self.config, *args,
                              qcfg=self.qcfg, **kwargs)

    def apply_lora(self, path: str, strength: float = 1.0):
        """Attach this encoder's slice of a LoRA file (kohya ``lora_te_``
        for SD1's CLIP, ``lora_te1_``/``lora_te2_`` for the SDXL pair,
        ``lora_te3_`` for T5, ``lora_te_``/``lora_llama_`` for a llama
        encoder; the ``lora_unet_`` slice goes to
        DiffusionModel.apply_lora). Mutates self and returns it."""
        prefixes = {"clip_l": ("te1", "te"), "clip_g": ("te2",),
                    "t5": ("te3", "te"), "llama": ("te", "llama")}[self.kind]
        self.params = lora_mod.load_and_attach_te(
            self.params, path, strength=strength,
            dtype=_patch_dtype(self.qcfg), prefixes=prefixes)
        return self

    def unapply_loras(self):
        self.params = lora_mod.detach_patches(self.params)
        return self

    def requantize_i8(self) -> "TextEncoder":
        """w8a8 conversion for the encoder stack (see
        DiffusionModel.requantize_i8); each planar leaf is dropped as it
        converts. Mutates self and returns it."""
        from .quant.i8 import convert_tree_i8

        self.params = convert_tree_i8(self.params, free_source=True)
        return self


def _load_safetensors_sd(path: str) -> dict:
    """safetensors file → numpy state dict, bf16/f16 widened to f32."""
    return _safetensors.load_state_dict(path)


def _to_device(raw: dict, device) -> dict:
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
            for k, v in raw.items()}


def load_vae(path: str, device="cuda"):
    """Load a VAE and detect its family from the keys.

    → (kind, params, config): kind "image" (AutoencoderKL, decoded with
    models.vae), "wan" (models.wan_vae), "ltxv" (models.ltxv_vae) or
    "hyvid" (models.hyvid_vae), the causal 3-D video VAEs. A
    diffusers-format image VAE (``decoder.mid_block.*`` keys with 4-D
    convs) raises ``ValueError``, as in the reference. Strips a leading
    ``vae.`` / ``first_stage_model.`` prefix (checkpoint-bundled VAEs use
    it)."""
    device = resolve_device(device)
    raw = _load_safetensors_sd(path)
    for pfx in ("vae.", "first_stage_model."):
        if any(k.startswith(pfx) for k in raw):
            raw = {k[len(pfx):]: v for k, v in raw.items()
                   if k.startswith(pfx)}
            break
    if any(k.startswith("decoder.middle.") for k in raw):
        params = _to_device(raw, device)
        return "wan", params, wan_vae_model.WanVAEConfig.from_state_dict(
            params)
    if ltxv_vae_model.detect_ltxv_vae(raw):
        params = _to_device(raw, device)
        return ("ltxv", params,
                ltxv_vae_model.LTXVVAEConfig.from_state_dict(params))
    if any(k.startswith("decoder.mid_block.") for k in raw):
        # the generic diffusers prefix: diffusers-format IMAGE VAEs carry it
        # too. HunyuanVideo's causal convs are 5-D (O, I, kt, kh, kw); a 4-D
        # conv means an image VAE in diffusers naming, which the sgm-format
        # decoder cannot read
        w = next((v for k, v in raw.items()
                  if k.startswith("decoder.mid_block.")
                  and k.endswith("conv.weight")
                  or k.startswith("decoder.conv_in")), None)
        if w is not None and np.ndim(w) == 5:
            params = _to_device(raw, device)
            return ("hyvid", params,
                    hyvid_vae_model.HyVidVAEConfig.from_state_dict(params))
        raise ValueError(
            "diffusers-format image VAE (4-D convs under "
            "decoder.mid_block.*) — convert to the sgm key format "
            "(first_stage_model decoder.mid.*) or load the sgm export")
    params = _to_device(raw, device)
    return "image", params, vae_model.VAEConfig.from_state_dict(params)


def load_text_encoder(path: str, device="cuda") -> TextEncoder:
    """One text-encoder file (gguf or safetensors) → TextEncoder: a T5
    GGUF, a llama / qwen2vl / qwen3 / qwen3vl GGUF (the llama graph; a
    qwen2vl file with its mmproj sidecar's vision tower merged), or a CLIP
    or T5 safetensors file.

    The llama graph's config is read with ``LlamaConfig.from_state_dict``'s
    defaults (32 heads, rope theta 5e5), as the reference package reads it;
    a published Qwen2.5-VL-7B has 28 heads and theta 1e6 (ROADMAP queue
    3): build its config with ``from_state_dict(params, n_heads=28,
    rope_theta=1e6)``."""
    device = resolve_device(device)
    qcfg = QuantConfig()
    tokenizer = None
    if path.endswith(".gguf"):
        sd, arch, tok_spec = gguf_clip_loader(path)
        if arch not in ("t5", "t5encoder", "llama", "qwen2vl", "qwen3",
                        "qwen3vl"):
            raise ValueError(f"unsupported text arch {arch!r}")
        params = to_torch_params(sd, qcfg, device=device)
        if tok_spec is not None:
            from .tokenizer import build_tokenizer

            try:
                tokenizer = build_tokenizer(tok_spec)
            except NotImplementedError:
                log.warning("no native tokenizer for %s", tok_spec.model)
        if arch in ("t5", "t5encoder"):
            return TextEncoder("t5", params,
                               t5_model.T5Config.from_state_dict(params),
                               tokenizer, qcfg, device)
        return TextEncoder("llama", params,
                           llama_model.LlamaConfig.from_state_dict(params),
                           tokenizer, qcfg, device)

    raw = _load_safetensors_sd(path)
    if any(k.startswith("transformer.resblocks.") for k in raw):
        raw = clip_model.remap_open_clip(raw)
    if any("scaled_fp8" in k for k in raw):
        raise ValueError("scaled_fp8 text encoders are not supported here")
    if "text_model.embeddings.token_embedding.weight" in raw:
        params = _to_device(raw, device)
        cfg = clip_model.CLIPTextConfig.from_state_dict(params)
        kind = "clip_g" if cfg.hidden >= 1280 else "clip_l"
        # safetensors CLIPs carry no tokenizer; pick up HF-style
        # vocab.json + merges.txt sitting next to the weights
        d = os.path.dirname(os.path.abspath(path))
        vj, mt = os.path.join(d, "vocab.json"), os.path.join(d, "merges.txt")
        if os.path.exists(vj) and os.path.exists(mt):
            from .tokenizer.clip_bpe import CLIPBPETokenizer

            tokenizer = CLIPBPETokenizer.from_files(vj, mt)
        return TextEncoder(kind, params, cfg, tokenizer, qcfg, device)
    if any(k.startswith("encoder.block.") for k in raw):
        params = _to_device(raw, device)
        return TextEncoder("t5", params,
                           t5_model.T5Config.from_state_dict(params), None,
                           qcfg, device)
    raise ValueError(f"unrecognized text encoder format: {path}")


def qwen_vl_encode_with_image(llama_enc: TextEncoder, vision_params: dict,
                              ids, image: np.ndarray,
                              image_pad_token_id: int, mask=None) -> dict:
    """Image-conditioned Qwen-VL encoding: the vision tower's merged
    embeddings of ``image`` ((H, W, 3) float) replace the
    ``<|image_pad|>`` tokens of ``ids`` (B, L) in the token embedding (the
    port's ``embedding`` on the encoder's table), and the llama graph
    encodes that through ``inputs_embeds`` with Qwen-VL's (3, B, L) M-RoPE
    position streams (HF ``get_rope_index``: text tokens advance all three
    streams together; vision tokens carry their (t, h, w) grid positions
    offset by the text position at the image, and the following text
    resumes at that offset + max(grid dims)). The positions and the pad
    indices are computed on the host from ``ids``; the splice is an index
    write on the encoder's device. ``ids`` must hold exactly as many pad
    tokens as the tower emits ((H/14/m)·(W/14/m), merge m), else
    ``ValueError``. → the encoder's output dict."""
    vcfg = vision_model.QwenVLVisionConfig.from_state_dict(vision_params)
    dev = llama_enc.device
    image = np.asarray(image, np.float32)
    pe_shape = tuple(vision_params["visual.patch_embed.proj.weight"].shape)
    patches = vision_model.extract_patches(image, patch=pe_shape[-1],
                                           temporal=pe_shape[2])
    with torch.no_grad():
        vis = vision_model.forward(
            vision_params, vcfg, torch.from_numpy(patches).to(dev),
            qcfg=llama_enc.qcfg).to(torch.float32)  # (n_img_tokens, D)
        ids = np.asarray(ids)
        tok = embedding(_ids(ids, dev),
                        llama_enc.params["model.embed_tokens.weight"],
                        cfg=llama_enc.qcfg).to(torch.float32)
    n = vis.shape[0]
    gh = image.shape[0] // pe_shape[-1] // vcfg.merge_size
    gw = n // max(gh, 1)
    B, L = ids.shape
    pos3 = np.zeros((3, B, L), np.int64)
    for b in range(B):
        pos = np.nonzero(ids[b] == image_pad_token_id)[0]
        if len(pos) != n:
            raise ValueError(
                f"prompt has {len(pos)} image_pad tokens but the vision "
                f"tower produced {n} embeddings")
        tok[b, torch.from_numpy(pos).to(dev)] = vis
        st = i = 0
        while i < L:
            if ids[b, i] == image_pad_token_id:
                grid = np.arange(n)
                pos3[0, b, i: i + n] = st  # t (a single frame)
                pos3[1, b, i: i + n] = st + grid // gw
                pos3[2, b, i: i + n] = st + grid % gw
                st += max(1, gh, gw)
                i += n
            else:
                pos3[:, b, i] = st
                st += 1
                i += 1
    return llama_enc.encode(
        _ids(ids, dev), None if mask is None else _ids(mask, dev),
        inputs_embeds=tok, position_ids=torch.from_numpy(pos3).to(dev))


def load_text_encoders(*paths: str, device="cuda") -> dict[str, TextEncoder]:
    """1-4 encoder files → {kind: TextEncoder}."""
    out = {}
    for p in paths:
        enc = load_text_encoder(p, device=device)
        out[enc.kind] = enc
    return out


# ---------------------------------------------------------------------------
# txt2img pipeline
# ---------------------------------------------------------------------------

def _as_list(v):
    if v is None:
        return []
    return [v] if not isinstance(v, (list, tuple)) else list(v)


class _StageClock:
    """Host-clock seconds of a call's stages; the card is synchronised at
    every mark, so a stage's time includes its device work.

    ``stages`` names the marks the call makes, in order: each stage also
    runs as the span ``pipeline.<name without _s>`` (``tokenize_s`` ->
    ``pipeline.tokenize``), opened at the previous mark and ended by its
    own."""

    def __init__(self, device: torch.device, *stages: str):
        self.device = device
        self.marks = [("start", time.perf_counter())]
        self._stages = list(stages)
        self._span = None
        self._open()

    def _open(self) -> None:
        if self._stages:
            name = self._stages.pop(0).removesuffix("_s")
            self._span = observability.span(f"pipeline.{name}")
            self._span.__enter__()

    def mark(self, name: str) -> None:
        if self._span is None or self._span.name != (
                "pipeline." + name.removesuffix("_s")):
            raise ValueError(f"stage {name!r} is not the clock's next stage")
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self._span.__exit__(None, None, None)
        self.marks.append((name, time.perf_counter()))
        self._span = None
        self._open()

    def timings(self) -> dict:
        out = {name: t - self.marks[i][1]
               for i, (name, t) in enumerate(self.marks[1:])}
        out["total_s"] = self.marks[-1][1] - self.marks[0][1]
        return out


def _on(a, device, dtype) -> torch.Tensor:
    """An array or tensor as a tensor of ``dtype`` on ``device``."""
    t = a if isinstance(a, torch.Tensor) else torch.from_numpy(np.array(a))
    return t.to(device=device, dtype=dtype)


def _decoded(vae_params, vae_config, latent) -> np.ndarray:
    """(1, h, w, C) latent → (H, W, 3) image in [0, 1] through the VAE, or
    the float32 latent itself without one."""
    if vae_params is None:
        return latent[0].to(torch.float32).cpu().numpy()
    img = vae_model.decode_auto(vae_params, vae_config, latent)
    return ((img[0].clamp(-1, 1) + 1) / 2).cpu().numpy()


def _resize_nearest(m: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """(H, W) → (h, w), sampling at pixel centres (the reference's
    ``jax.image.resize(..., "nearest")``)."""
    H, W = m.shape
    ri = ((torch.arange(h, device=m.device) + 0.5) * H / h).floor().long()
    ci = ((torch.arange(w, device=m.device) + 0.5) * W / w).floor().long()
    return m[ri][:, ci]


@dataclasses.dataclass
class FluxPipeline:
    model: DiffusionModel
    t5: TextEncoder
    clip_l: TextEncoder
    vae_params: dict | None = None
    vae_config: object | None = None
    # of the last generate() call: host-clock seconds of its stages, and
    # its final latent (1, H/8, W/8, C) before the VAE, on the device
    last_timings: dict = dataclasses.field(default_factory=dict)
    last_latent: torch.Tensor | None = None

    @staticmethod
    def load(unet_path: str, t5_path: str, clip_l_path: str,
             vae_path: str | None = None, device="cuda") -> "FluxPipeline":
        device = resolve_device(device)
        model = load_diffusion_model(unet_path, device=device)
        encs = load_text_encoders(t5_path, clip_l_path, device=device)
        vp = vc = None
        if vae_path:
            _, vp, vc = load_vae(vae_path, device=device)
        return FluxPipeline(model, encs["t5"], encs["clip_l"], vp, vc)

    def generate(self, prompt: str, width: int = 1024, height: int = 1024,
                 steps: int = 20, guidance: float = 3.5, seed: int = 0,
                 **kw) -> np.ndarray:
        """→ (H, W, 3) float image in [0, 1] (or latent if no VAE given).

        Draws the initial noise (and, for inpainting, each step's noise)
        from ``torch.Generator(device).manual_seed(seed)`` and runs
        ``generate_from_noise``, which documents the other arguments.
        """
        device = self.model.device
        gen = torch.Generator(device=device).manual_seed(seed)
        lat_c = self.model.config.in_channels // 4
        noise = torch.randn((1, height // 8, width // 8, lat_c),
                            generator=gen, device=device,
                            dtype=torch.float32).to(torch.bfloat16)

        def step_noise(i, shape):
            return torch.randn(shape, generator=gen, device=device,
                               dtype=torch.float32)

        return self.generate_from_noise(
            prompt, noise, width=width, height=height, steps=steps,
            guidance=guidance, step_noise=step_noise, **kw)

    @torch.no_grad()
    def generate_from_noise(self, prompt: str, noise, width: int = 1024,
                            height: int = 1024, steps: int = 20,
                            guidance: float = 3.5, max_t5_len: int = 512,
                            shift: bool = True,
                            init_image: np.ndarray | None = None,
                            denoise: float = 1.0,
                            inpaint_mask: np.ndarray | None = None,
                            ref_images=None, ref_latents=None,
                            sampler: str | None = None,
                            step_noise=None) -> np.ndarray:
        """Everything of ``generate`` after the noise draw. ``noise`` is the
        (1, H/8, W/8, C) initial latent noise (array or tensor);
        ``step_noise(i, shape)`` gives inpainting step i's float32 noise.

        img2img: pass ``init_image`` (H, W, 3) in [0, 1] + ``denoise`` < 1 —
        the latent starts from the VAE-encoded image noised to
        σ = sigmas[first_step] and only the remaining steps run.

        inpainting: additionally pass ``inpaint_mask`` (H, W) in [0, 1]
        (1 = regenerate); the kept region is re-projected onto the noised
        source every step (sampling.euler_sample_inpaint).

        Kontext editing: pass ``ref_images`` ((H, W, 3) in [0, 1],
        VAE-encoded here) and/or ``ref_latents`` ((H_lat, W_lat, C) spatial
        latents). References are patchified and appended to the image token
        stream with rope frame index 1, 2, …; the velocity over the
        reference span is discarded each step.
        """
        device = self.model.device
        clock = _StageClock(device, "tokenize_s", "t5_s", "clip_s",
                            "denoise_s", "vae_s")
        mark = clock.mark

        def dev(a, dtype):
            return _on(a, device, dtype)

        ids, mask = self.t5.tokenizer.encode_batch([prompt],
                                                   max_length=max_t5_len)
        if self.clip_l.tokenizer is None:
            raise ValueError("clip_l tokenizer unavailable; pass token ids")
        clip_len = min(77, self.clip_l.config.max_positions)
        cids, _ = self.clip_l.tokenizer.encode_batch([prompt],
                                                     max_length=clip_len)
        mark("tokenize_s")
        txt = self.t5.encode(dev(ids, torch.long), dev(mask, torch.int32))
        mark("t5_s")
        pooled = self.clip_l.encode(dev(cids, torch.long))["pooled"]
        mark("clip_s")

        h_lat, w_lat = height // 8, width // 8
        noise = dev(noise, torch.bfloat16)
        img_tokens = flux_model.patchify(noise)
        sigmas = flux_schedule(steps, img_tokens.shape[1], shift=shift)

        z0_tokens = mask_tokens = None
        if init_image is not None:
            if self.vae_params is None:
                raise ValueError("img2img needs a VAE")
            first = int(round((1.0 - denoise) * steps))
            sigmas = sigmas[first:]
            img01 = dev(init_image, torch.float32)[None] * 2 - 1
            z0 = vae_model.encode_auto(self.vae_params, self.vae_config,
                                       img01)
            s0 = float(sigmas[0])
            x = ((1 - s0) * z0.to(torch.float32)
                 + s0 * noise.to(torch.float32)).to(torch.bfloat16)
            if inpaint_mask is not None:
                m = _resize_nearest(dev(inpaint_mask, torch.float32), h_lat,
                                    w_lat)
                m = m[None, :, :, None].expand(z0.shape)
                z0_tokens = flux_model.patchify(z0.to(torch.bfloat16))
                mask_tokens = flux_model.patchify(m)
        else:
            x = noise
        img_tokens = flux_model.patchify(x)
        img_ids_np = np.array(
            flux_model.make_img_ids(h_lat // 2, w_lat // 2, 1))

        ref_images, ref_latents = _as_list(ref_images), _as_list(ref_latents)
        ref_tok = None
        if ref_images or ref_latents:
            refs = [dev(r, torch.float32) for r in ref_latents]
            for im in ref_images:
                if self.vae_params is None:
                    raise ValueError("ref_images need a VAE; pass "
                                     "ref_latents instead")
                z = vae_model.encode_auto(
                    self.vae_params, self.vae_config,
                    dev(im, torch.float32)[None] * 2 - 1)
                refs.append(z[0])
            toks, rids = [], [img_ids_np]
            for ri, r in enumerate(refs, start=1):
                r = r[None] if r.dim() == 3 else r
                toks.append(flux_model.patchify(r).to(torch.bfloat16))
                rid = np.array(flux_model.make_img_ids(
                    r.shape[1] // 2, r.shape[2] // 2, 1))
                rid[:, :, 0] = ri
                rids.append(rid)
            ref_tok = torch.cat(toks, dim=1)
            img_ids_np = np.concatenate(rids, axis=1)
        img_ids = torch.as_tensor(img_ids_np, device=device)
        L = img_tokens.shape[1]
        txt_ids = torch.zeros((1, txt.shape[1], 3), dtype=torch.int32,
                              device=device)
        g = torch.full((1,), guidance, dtype=torch.float32, device=device)
        model = self.model

        def velocity(xc, sigma):
            tt = sigma.to(torch.float32).expand(xc.shape[0])
            xa = xc if ref_tok is None else torch.cat([xc, ref_tok], dim=1)
            out = model.forward(xa, img_ids, txt, txt_ids, tt, pooled, g)
            return out if ref_tok is None else out[:, :L]

        if mask_tokens is not None:
            if step_noise is None:
                raise ValueError("inpainting needs step_noise")
            out_tokens = euler_sample_inpaint(
                velocity, img_tokens, sigmas, z0_tokens, mask_tokens,
                lambda i: step_noise(i, tuple(z0_tokens.shape)).to(
                    device=device, dtype=torch.float32))
        else:
            out_tokens = sample_flow(velocity, img_tokens, sigmas,
                                     sampler=sampler)
        latent = flux_model.unpatchify(out_tokens, h_lat, w_lat)
        self.last_latent = latent
        mark("denoise_s")
        result = _decoded(self.vae_params, self.vae_config, latent)
        mark("vae_s")
        self.last_timings = clock.timings()
        return result


def _ids(a, device) -> torch.Tensor | None:
    return None if a is None else _on(a, device, torch.long)


def _noise_or_draw(noise, shape, gen, device, dtype):
    """The caller's noise as ``dtype`` on ``device``, else a float32
    standard-normal draw of ``shape`` from ``gen`` rounded to ``dtype``."""
    if noise is None:
        noise = torch.randn(shape, generator=gen, device=device,
                            dtype=torch.float32)
    return _on(noise, device, torch.float32).to(dtype)


def _step_noise_or_draw(step_noise, gen, device):
    """``step_noise(i, shape)`` as a float32 tensor on ``device``; draws
    from ``gen`` where the caller gave none."""
    def fn(i, shape):
        if step_noise is None:
            return torch.randn(shape, generator=gen, device=device,
                               dtype=torch.float32)
        return _on(step_noise(i, shape), device, torch.float32)
    return fn


@dataclasses.dataclass
class SD3Pipeline:
    """SD3/SD3.5 txt2img: CLIP-L + CLIP-G (+ optional T5) conditioning, CFG
    over the rectified-flow ODE (two forwards a step).

    The VAE decodes with the scale and shift its config carries:
    ``VAEConfig.from_state_dict`` gives every 16-channel VAE flux's factors
    (0.3611 / 0.1159), as the reference package does, not SD3's published
    1.5305 / 0.0609 (ROADMAP queue 3)."""

    model: DiffusionModel
    clip_l: TextEncoder
    clip_g: TextEncoder
    t5: TextEncoder | None = None
    vae_params: dict | None = None
    vae_config: object | None = None
    shift: float = 3.0
    # of the last generate_from_ids() call: host-clock seconds of its
    # stages, and its final latent (1, H/8, W/8, C) before the VAE
    last_timings: dict = dataclasses.field(default_factory=dict)
    last_latent: torch.Tensor | None = None

    @staticmethod
    def load(unet_path: str, clip_l_path: str, clip_g_path: str,
             t5_path: str | None = None, vae_path: str | None = None,
             device="cuda") -> "SD3Pipeline":
        device = resolve_device(device)
        model = load_diffusion_model(unet_path, device=device)
        paths = (clip_l_path, clip_g_path) + ((t5_path,) if t5_path else ())
        encs = load_text_encoders(*paths, device=device)
        vp = vc = None
        if vae_path:
            _, vp, vc = load_vae(vae_path, device=device)
        return SD3Pipeline(model, encs["clip_l"], encs["clip_g"],
                           encs.get("t5"), vp, vc)

    def _condition(self, clip_l_ids, clip_g_ids, t5_ids):
        """SD3 conditioning: penultimate CLIP-L ⊕ CLIP-G states zero-padded
        to the model's context width (4096 without a model), then the T5
        states appended; pooled = pooled_l ⊕ pooled_g."""
        l_out = self.clip_l.encode(clip_l_ids)
        g_out = self.clip_g.encode(clip_g_ids)
        clip_ctx = torch.cat([l_out["penultimate"], g_out["penultimate"]],
                             dim=-1)
        ctx_dim = (self.model.config.context_dim
                   if self.model is not None else 4096)
        clip_ctx = torch.nn.functional.pad(
            clip_ctx, (0, ctx_dim - clip_ctx.shape[-1]))
        parts = [clip_ctx]
        if self.t5 is not None and t5_ids is not None:
            parts.append(self.t5.encode(t5_ids).to(clip_ctx.dtype))
        ctx = torch.cat(parts, dim=1)
        pooled = torch.cat([l_out["pooled"], g_out["pooled"]], dim=-1)
        return ctx, pooled

    def generate(self, prompt: str, negative_prompt: str = "",
                 max_t5_len: int = 512, **kw):
        """Prompt-level txt2img (CFG against ``negative_prompt``); needs
        tokenizers on the encoders. The other arguments are
        ``generate_from_ids``'s."""
        def ids_for(enc, text):
            if enc is None:
                return None
            if enc.tokenizer is None:
                raise ValueError(
                    f"{enc.kind} has no tokenizer; use generate_from_ids "
                    "with external token ids")
            L = getattr(enc.config, "max_positions", None)
            ids, _ = enc.tokenizer.encode_batch(
                [text], max_length=min(77, L) if L else max_t5_len)
            return ids

        return self.generate_from_ids(
            ids_for(self.clip_l, prompt), ids_for(self.clip_g, prompt),
            t5_ids=ids_for(self.t5, prompt),
            neg_clip_l_ids=ids_for(self.clip_l, negative_prompt),
            neg_clip_g_ids=ids_for(self.clip_g, negative_prompt),
            neg_t5_ids=ids_for(self.t5, negative_prompt), **kw)

    @torch.no_grad()
    def generate_from_ids(self, clip_l_ids, clip_g_ids, t5_ids=None,
                          neg_clip_l_ids=None, neg_clip_g_ids=None,
                          neg_t5_ids=None, width: int = 1024,
                          height: int = 1024, steps: int = 28,
                          cfg_scale: float = 4.5, seed: int = 0,
                          init_image: np.ndarray | None = None,
                          denoise: float = 1.0,
                          inpaint_mask: np.ndarray | None = None,
                          sampler: str | None = None, noise=None,
                          step_noise=None) -> np.ndarray:
        """txt2img → (H, W, 3) image in [0, 1] (the latent without a VAE).

        CFG runs when ``cfg_scale`` != 1 and negative ids are given: two
        forwards a step. img2img: ``init_image`` (H, W, 3) in [0, 1] +
        ``denoise`` < 1 (VAE-encode, forward-noise to the schedule point,
        sample down); inpainting: also ``inpaint_mask`` (any 2-D, 1 =
        generate). ``noise`` is the (1, H/8, W/8, C) initial noise and
        ``step_noise(i, shape)`` inpainting step i's float32 noise; where
        they are not given they are drawn from
        ``torch.Generator(device).manual_seed(seed)``.
        """
        device = self.model.device
        clock = _StageClock(device, "encode_s", "denoise_s", "vae_s")
        gen = torch.Generator(device=device).manual_seed(seed)
        ctx, pooled = self._condition(_ids(clip_l_ids, device),
                                      _ids(clip_g_ids, device),
                                      _ids(t5_ids, device))
        use_cfg = cfg_scale != 1.0 and neg_clip_l_ids is not None
        if use_cfg:
            nctx, npooled = self._condition(_ids(neg_clip_l_ids, device),
                                            _ids(neg_clip_g_ids, device),
                                            _ids(neg_t5_ids, device))
        clock.mark("encode_s")

        h_lat, w_lat = height // 8, width // 8
        noise = _noise_or_draw(
            noise, (1, h_lat, w_lat, self.model.config.in_channels), gen,
            device, torch.bfloat16)
        sigmas = shift_sigmas(linear_schedule(steps), self.shift)

        x, z0, mask = noise, None, None
        if init_image is not None:
            if self.vae_params is None:
                raise ValueError("img2img needs a VAE")
            first = int(round((1.0 - denoise) * steps))
            sigmas = sigmas[first:]
            img01 = _on(init_image, device, torch.float32)[None] * 2 - 1
            z0 = vae_model.encode_auto(self.vae_params, self.vae_config,
                                       img01)
            s0 = float(sigmas[0])
            x = ((1 - s0) * z0.to(torch.float32)
                 + s0 * noise.to(torch.float32)).to(torch.bfloat16)
            if inpaint_mask is not None:
                m = _resize_nearest(_on(inpaint_mask, device, torch.float32),
                                    h_lat, w_lat)
                mask = m[None, :, :, None].expand(z0.shape)
        elif inpaint_mask is not None:
            raise ValueError("inpaint_mask needs an init_image")
        model = self.model
        velocity = cfg_wrap(
            lambda xc, sigma, c: model.forward(
                xc, *c, sigma.to(torch.float32).expand(xc.shape[0])),
            (ctx, pooled), (nctx, npooled) if use_cfg else None, cfg_scale)

        if mask is not None:
            noise_fn = _step_noise_or_draw(step_noise, gen, device)
            latent = euler_sample_inpaint(
                velocity, x, sigmas, z0.to(torch.bfloat16), mask,
                lambda i: noise_fn(i, tuple(z0.shape)))
        else:
            latent = sample_flow(velocity, x, sigmas, sampler=sampler)
        self.last_latent = latent
        clock.mark("denoise_s")
        result = _decoded(self.vae_params, self.vae_config, latent)
        clock.mark("vae_s")
        self.last_timings = clock.timings()
        return result


def _text_states(enc: TextEncoder, text: str, max_len: int,
                 zero_masked: bool = False):
    """A prompt through an encoder's tokenizer (padded to ``max_len``, with
    its mask) and graph → (1, max_len, width) states; ``zero_masked``
    zeroes the padded positions (Wan's ``zero_out_masked``: the UMT5
    encoder emits nonzero states there, and the DiT's cross-attention has
    no mask)."""
    if enc.tokenizer is None:
        raise ValueError(f"the {enc.kind} encoder has no tokenizer")
    ids, mask = enc.tokenizer.encode_batch([text], max_length=max_len)
    mask = _ids(mask, enc.device)
    out = enc.encode(_ids(ids, enc.device), mask)
    out = out["last_hidden"] if isinstance(out, dict) else out
    return out * mask[..., None].to(out.dtype) if zero_masked else out


@dataclasses.dataclass
class CFGFlowPipeline:
    """txt2img of a single-encoder CFG flow model (AuraFlow, Lumina 2):
    ``encoder``'s final states of the prompt (``max_len`` tokens) as the
    conditioning, CFG at ``cfg_scale`` over the rectified flow at
    ``shift``, latent out: neither model has a VAE wired in the reference.
    ``AuraPipeline`` and ``Lumina2Pipeline`` build it with the reference's
    defaults."""

    model: DiffusionModel
    encoder: TextEncoder
    shift: float
    cfg_scale: float
    # of the last generate() call: host-clock seconds of its stages, and
    # its final latent (1, H/8, W/8, C) on the device
    last_timings: dict = dataclasses.field(default_factory=dict)
    last_latent: torch.Tensor | None = None

    @torch.no_grad()
    def generate(self, prompt: str, width: int = 1024, height: int = 1024,
                 steps: int = 20, cfg_scale: float | None = None,
                 seed: int = 0, negative_prompt: str = "",
                 max_len: int = 256, noise=None) -> np.ndarray:
        """→ the (H/8, W/8, C) float32 latent; ``cfg_scale`` None takes the
        pipeline's. ``noise`` is the (1, H/8, W/8, C) initial noise;
        without it the noise is drawn from
        ``torch.Generator(device).manual_seed(seed)``."""
        cfg_scale = self.cfg_scale if cfg_scale is None else cfg_scale
        model = self.model
        device = model.device
        clock = _StageClock(device, "encode_s", "denoise_s")
        cond = _text_states(self.encoder, prompt, max_len)
        use_cfg = cfg_scale != 1.0
        ncond = (_text_states(self.encoder, negative_prompt, max_len)
                 if use_cfg else None)
        clock.mark("encode_s")
        gen = torch.Generator(device=device).manual_seed(seed)
        x = _noise_or_draw(noise, (1, height // 8, width // 8,
                                   model.config.in_channels),
                           gen, device, torch.bfloat16)
        latent = self._denoise(x, cond, ncond, steps, cfg_scale)
        self.last_latent = latent
        clock.mark("denoise_s")
        self.last_timings = clock.timings()
        return latent[0].to(torch.float32).cpu().numpy()

    def _denoise(self, x, cond, ncond, steps: int, cfg_scale: float,
                 window: int | None = None, fwd=None) -> torch.Tensor:
        """The CFG rectified-flow ODE from noise ``x`` (the reference's
        ``_jit_cfg_denoise``). ``window``: the card is synchronised after
        every that many velocity evaluations (a step of Euler), a host sync
        between windows of queued work that leaves the math as it is;
        ``None`` or 0 never. ``fwd(x, timesteps, cond)``: the model's
        forward over one conditioning (default ``model.forward(x, cond,
        timesteps)``)."""
        model = self.model
        fwd = fwd or (lambda xc, ts, c: model.forward(xc, c, ts))
        guided = cfg_wrap(
            lambda xc, sigma, c: fwd(
                xc, sigma.to(torch.float32).expand(xc.shape[0]), c),
            cond, ncond, cfg_scale)
        done = [0]

        def velocity(xc, sigma):
            v = guided(xc, sigma)
            done[0] += 1
            if window and done[0] % window == 0 and v.is_cuda:
                torch.cuda.synchronize(v.device)
            return v

        return sample_flow(velocity, x,
                           shift_sigmas(linear_schedule(steps), self.shift))


def AuraPipeline(model: DiffusionModel, t5: TextEncoder,
                 shift: float = 1.73) -> CFGFlowPipeline:
    """AuraFlow txt2img: Pile-T5 conditioning, CFG 3.5 at shift 1.73."""
    return CFGFlowPipeline(model, t5, shift, 3.5)


def Lumina2Pipeline(model: DiffusionModel, text: TextEncoder,
                    shift: float = 6.0) -> CFGFlowPipeline:
    """Lumina Image 2.0 txt2img: the llama-graph encoder's final states as
    the caption, CFG 4.0 at shift 6.0. The reference conditions on a llama
    graph at Gemma-2's shapes, not on Gemma-2 itself (ROADMAP queue 3); the
    port matches it."""
    return CFGFlowPipeline(model, text, shift, 4.0)


@dataclasses.dataclass
class VideoFlowPipeline(CFGFlowPipeline):
    """A ``CFGFlowPipeline`` over (1, F, H, W, C) video latents (Wan,
    Cosmos, HunyuanVideo, LTX-Video): the conditioning optionally zeroed at
    padded positions, the denoise optionally synchronised every
    ``dispatch_window`` steps, and an optional VAE decode (``_decode``:
    here the Wan VAE, with per-channel ``latents_mean`` / ``latents_std``
    un-normalizing z first; the subclasses decode through their own)."""

    zero_masked: bool = False
    vae_params: dict | None = None
    latents_mean: np.ndarray | None = None
    latents_std: np.ndarray | None = None

    @torch.no_grad()
    def generate_video(self, prompt: str, negative_prompt: str,
                       latent_frames: int, latent_height: int,
                       latent_width: int, steps: int, cfg_scale: float,
                       seed: int, max_len: int, noise=None,
                       dispatch_window: int | None = None,
                       fwd=None) -> np.ndarray:
        """→ the (T, H, W, 3) video in [0, 1] through the VAE, or the (F,
        H, W, C) float32 latent without one. ``noise`` is the (1, F, H, W,
        C) initial noise; without it the noise is drawn from
        ``torch.Generator(device).manual_seed(seed)``. ``fwd`` as
        ``_denoise`` takes it."""
        model = self.model
        device = model.device
        clock = _StageClock(device, "encode_s", "denoise_s",
                            *(("vae_s",) if self.vae_params is not None
                              else ()))
        cond = _text_states(self.encoder, prompt, max_len, self.zero_masked)
        ncond = (_text_states(self.encoder, negative_prompt, max_len,
                              self.zero_masked)
                 if cfg_scale != 1.0 else None)
        clock.mark("encode_s")
        gen = torch.Generator(device=device).manual_seed(seed)
        x = _noise_or_draw(noise, (1, latent_frames, latent_height,
                                   latent_width, model.config.in_channels),
                           gen, device, torch.bfloat16)
        latent = self._denoise(x, cond, ncond, steps, cfg_scale,
                               window=dispatch_window, fwd=fwd)
        self.last_latent = latent
        clock.mark("denoise_s")
        if self.vae_params is None:
            self.last_timings = clock.timings()
            return latent[0].to(torch.float32).cpu().numpy()
        vid = self._decode(latent.to(torch.float32))
        out = ((vid[0].clamp(-1, 1) + 1) / 2).cpu().numpy()
        clock.mark("vae_s")
        self.last_timings = clock.timings()
        return out

    def _decode(self, z: torch.Tensor) -> torch.Tensor:
        """(1, F, H, W, C) float32 latent → (1, T, H', W', 3) video in
        [-1, 1] through the Wan VAE."""
        if self.latents_mean is not None:
            mean = torch.as_tensor(np.asarray(self.latents_mean, np.float32),
                                   device=z.device)
            std = torch.as_tensor(np.asarray(self.latents_std, np.float32),
                                  device=z.device)
            z = z * std + mean
        vcfg = wan_vae_model.WanVAEConfig.from_state_dict(self.vae_params)
        return wan_vae_model.decode_auto(self.vae_params, vcfg, z,
                                         qcfg=self.model.qcfg)


class WanPipeline(VideoFlowPipeline):
    """Wan 2.1 t2v: UMT5 conditioning with the padded positions zeroed, CFG
    5.0 at shift 5.0 over the rectified flow; with ``vae_params`` (a Wan VAE
    tree, ``load_vae`` kind "wan") ``generate`` returns the decoded video
    (T, H, W, 3) in [0, 1], else the latent video."""

    def __init__(self, model: DiffusionModel, t5: TextEncoder,
                 shift: float = 5.0, vae_params: dict | None = None,
                 latents_mean=None, latents_std=None):
        super().__init__(model, t5, shift, 5.0, zero_masked=True,
                         vae_params=vae_params, latents_mean=latents_mean,
                         latents_std=latents_std)

    @staticmethod
    def load(unet_path: str, t5_path: str, device="cuda",
             **kw) -> "WanPipeline":
        return WanPipeline(load_diffusion_model(unet_path, device=device,
                                                **kw),
                           load_text_encoder(t5_path, device=device))

    def generate(self, prompt: str, negative_prompt: str = "",
                 latent_frames: int = 21, latent_height: int = 60,
                 latent_width: int = 104, steps: int = 30,
                 cfg_scale: float = 5.0, seed: int = 0,
                 max_t5_len: int = 512, dispatch_window: int | None = 4,
                 noise=None) -> np.ndarray:
        """``dispatch_window``: steps between host syncs (None: none, the
        same math)."""
        return self.generate_video(prompt, negative_prompt, latent_frames,
                                   latent_height, latent_width, steps,
                                   cfg_scale, seed, max_t5_len, noise,
                                   dispatch_window)


class CosmosPipeline(VideoFlowPipeline):
    """Cosmos Predict2 t2i/t2v: T5 conditioning, CFG 4.0 at shift 1.0 over
    the rectified flow on (F, H, W, C) latents; latent out (no VAE, as in
    the reference)."""

    def __init__(self, model: DiffusionModel, t5: TextEncoder,
                 shift: float = 1.0):
        super().__init__(model, t5, shift, 4.0)

    def generate(self, prompt: str, latent_frames: int = 1,
                 latent_height: int = 64, latent_width: int = 64,
                 steps: int = 20, cfg_scale: float = 4.0, seed: int = 0,
                 negative_prompt: str = "", max_len: int = 256,
                 noise=None) -> np.ndarray:
        return self.generate_video(prompt, negative_prompt, latent_frames,
                                   latent_height, latent_width, steps,
                                   cfg_scale, seed, max_len, noise)


class HyVidPipeline(VideoFlowPipeline):
    """HunyuanVideo t2v: the llama-family encoder's final states (the
    llava-llama-3 text tower) as the conditioning, guidance-distilled (CFG
    1, one forward a step, the guidance ×1000 embedded in it) over the
    rectified flow at shift 7.0; with ``vae_params`` (a HunyuanVideo VAE
    tree, ``load_vae`` kind "hyvid") ``generate`` returns the decoded video
    (T, H, W, 3) in [0, 1], else the latent video."""

    def __init__(self, model: DiffusionModel, text: TextEncoder,
                 shift: float = 7.0, vae_params: dict | None = None):
        super().__init__(model, text, shift, 1.0, vae_params=vae_params)

    def generate(self, prompt: str, latent_frames: int = 9,
                 latent_height: int = 60, latent_width: int = 104,
                 steps: int = 20, guidance: float = 6.0, seed: int = 0,
                 max_len: int = 256, dispatch_window: int | None = 4,
                 noise=None) -> np.ndarray:
        """``dispatch_window``: steps between host syncs (None: none, the
        same math). ``noise``: the (1, F, H, W, C) initial noise."""
        model = self.model
        g = torch.full((1,), guidance * 1000.0, dtype=torch.float32,
                       device=model.device)

        def fwd(xc, ts, c):
            return model.forward(xc, c, ts, g.expand(xc.shape[0]))

        return self.generate_video(prompt, "", latent_frames, latent_height,
                                   latent_width, steps, 1.0, seed, max_len,
                                   noise, dispatch_window, fwd=fwd)

    def _decode(self, z: torch.Tensor) -> torch.Tensor:
        vcfg = hyvid_vae_model.HyVidVAEConfig.from_state_dict(self.vae_params)
        return hyvid_vae_model.decode_auto(self.vae_params, vcfg, z,
                                           qcfg=self.model.qcfg)


class LTXVPipeline(VideoFlowPipeline):
    """LTX-Video t2v: T5 conditioning over the flattened latent voxels
    with (t, h, w) position ids, CFG 3.0 at shift 3.0 over the rectified
    flow; with ``vae_params`` (an LTX-Video VAE tree, ``load_vae`` kind
    "ltxv") ``generate`` returns the decoded video (T, H, W, 3) in [0, 1],
    else the (F, H, W, C) latent."""

    def __init__(self, model: DiffusionModel, t5: TextEncoder,
                 shift: float = 3.0, vae_params: dict | None = None,
                 vae_config=None):
        super().__init__(model, t5, shift, 3.0, vae_params=vae_params)
        self.vae_config = vae_config  # read from the keys once, then kept

    def generate(self, prompt: str, latent_frames: int = 9,
                 latent_height: int = 32, latent_width: int = 32,
                 steps: int = 20, cfg_scale: float = 3.0, seed: int = 0,
                 negative_prompt: str = "", max_t5_len: int = 256,
                 noise=None) -> np.ndarray:
        """``noise``: the (1, L, C) initial voxel noise (or the same numbers
        as (1, F, H, W, C)); the forward sees the voxels flattened in (t, h,
        w) order, each with its position."""
        model = self.model
        F_, H_, W_ = latent_frames, latent_height, latent_width
        C = model.config.in_channels
        L = F_ * H_ * W_
        tt, hh, ww = torch.meshgrid(torch.arange(F_), torch.arange(H_),
                                    torch.arange(W_), indexing="ij")
        pos = torch.stack([tt, hh, ww], dim=-1).reshape(1, L, 3).to(
            device=model.device, dtype=torch.int32)
        if noise is not None:
            noise = np.asarray(noise, np.float32).reshape(1, F_, H_, W_, C)

        def fwd(xc, ts, c):
            B = xc.shape[0]
            v = model.forward(xc.reshape(B, L, C), pos.expand(B, L, 3), c,
                              ts)
            return v.reshape(xc.shape)

        return self.generate_video(prompt, negative_prompt, F_, H_, W_,
                                   steps, cfg_scale, seed, max_t5_len, noise,
                                   fwd=fwd)

    def _decode(self, z: torch.Tensor) -> torch.Tensor:
        if self.vae_config is None:
            self.vae_config = ltxv_vae_model.LTXVVAEConfig.from_state_dict(
                self.vae_params)
        return ltxv_vae_model.decode_auto(self.vae_params, self.vae_config,
                                          z, qcfg=self.model.qcfg)


@dataclasses.dataclass
class QwenImagePipeline:
    """Qwen-Image txt2img: the Qwen2.5-VL encoder's final states (a
    qwen2vl GGUF through the llama graph) as the conditioning, flux-style
    2×2-patchified latent tokens with 3-axis RoPE ids, CFG over the
    rectified flow; latent tokens out (the reference wires no VAE)."""

    model: DiffusionModel
    text: TextEncoder
    shift: float = 2.2
    # of the last generate/generate_edit call: host-clock seconds of its
    # stages, and its final latent tokens (1, L, in_channels) on the device
    last_timings: dict = dataclasses.field(default_factory=dict)
    last_latent: torch.Tensor | None = None

    @torch.no_grad()
    def generate(self, prompt: str, width: int = 1024, height: int = 1024,
                 steps: int = 20, cfg_scale: float = 4.0, seed: int = 0,
                 negative_prompt: str = " ", max_len: int = 256,
                 noise=None) -> np.ndarray:
        """→ the (H/16 · W/16, in_channels) float32 latent tokens. ``noise``
        is the (1, L, in_channels) initial noise; without it the noise is
        drawn from ``torch.Generator(device).manual_seed(seed)``."""
        return self.generate_edit(prompt, [], width=width, height=height,
                                  steps=steps, cfg_scale=cfg_scale,
                                  seed=seed, negative_prompt=negative_prompt,
                                  max_len=max_len, noise=noise)

    @torch.no_grad()
    def generate_edit(self, prompt: str, ref_latents, width: int = 1024,
                      height: int = 1024, steps: int = 20,
                      cfg_scale: float = 4.0, seed: int = 0,
                      negative_prompt: str = " ", max_len: int = 256,
                      txt_override=None, ntxt_override=None,
                      noise=None) -> np.ndarray:
        """Qwen-Image-Edit: generation conditioned on reference latents.
        Each reference ((H_lat, W_lat, C) spatial latent, e.g. a VAE encode
        of the source image) is 2×2-patchified and appended to the image
        token stream with RoPE frame index 1, 2, … (the generated tokens
        keep frame 0); the velocity over the reference span is dropped each
        step. ``txt_override`` / ``ntxt_override`` take precomputed
        conditioning states, e.g. ``qwen_vl_encode_with_image``'s
        ``last_hidden`` where the prompt embeds the source image. Other
        arguments as ``generate``."""
        model = self.model
        device = model.device
        clock = _StageClock(device, "encode_s", "denoise_s")
        txt = (_on(txt_override, device, torch.bfloat16)
               if txt_override is not None
               else _text_states(self.text, prompt, max_len))
        use_cfg = cfg_scale != 1.0
        ntxt = None
        if use_cfg:
            ntxt = (_on(ntxt_override, device, torch.bfloat16)
                    if ntxt_override is not None
                    else _text_states(self.text, negative_prompt, max_len))
        clock.mark("encode_s")
        h_tok, w_tok = height // 16, width // 16
        L = h_tok * w_tok
        ids = [np.array(flux_model.make_img_ids(h_tok, w_tok, 1))]
        ref_tok = []
        for ri, r in enumerate(_as_list(ref_latents), start=1):
            r = _on(r, device, torch.float32)[None]
            ref_tok.append(flux_model.patchify(r).to(torch.bfloat16))
            rid = np.array(flux_model.make_img_ids(r.shape[1] // 2,
                                                   r.shape[2] // 2, 1))
            rid[:, :, 0] = ri
            ids.append(rid)
        img_ids = torch.as_tensor(np.concatenate(ids, axis=1), device=device)
        ref = torch.cat(ref_tok, dim=1) if ref_tok else None
        gen = torch.Generator(device=device).manual_seed(seed)
        x = _noise_or_draw(noise, (1, L, model.config.in_channels), gen,
                           device, torch.bfloat16)

        def fwd(xc, sigma, c):
            txt_ids = torch.zeros((xc.shape[0], c.shape[1], 3),
                                  dtype=torch.int32, device=device)
            xa = xc if ref is None else torch.cat(
                [xc, ref.expand(xc.shape[0], -1, -1)], dim=1)
            out = model.forward(xa, img_ids.expand(xc.shape[0], -1, -1), c,
                                txt_ids,
                                sigma.to(torch.float32).expand(xc.shape[0]))
            return out[:, :L]

        latent = sample_flow(cfg_wrap(fwd, txt, ntxt, cfg_scale), x,
                             shift_sigmas(linear_schedule(steps),
                                          self.shift))
        self.last_latent = latent
        clock.mark("denoise_s")
        self.last_timings = clock.timings()
        return latent[0].to(torch.float32).cpu().numpy()


@dataclasses.dataclass
class HiDreamPipeline:
    """HiDream-I1 txt2img: CLIP-L ⊕ CLIP-G pooled vectors and the T5 and
    llama final states condition the MoE DiT; guidance-distilled (CFG 1,
    one forward a step) over the rectified flow at shift 3.0; latent out."""

    model: DiffusionModel
    clip_l: TextEncoder
    clip_g: TextEncoder
    t5: TextEncoder
    llama: TextEncoder
    shift: float = 3.0
    # of the last generate_from_ids call: host-clock seconds of its stages,
    # and its final latent (1, H/8, W/8, C) on the device
    last_timings: dict = dataclasses.field(default_factory=dict)
    last_latent: torch.Tensor | None = None

    @torch.no_grad()
    def generate_from_ids(self, clip_l_ids, clip_g_ids, t5_ids, llama_ids,
                          width: int = 1024, height: int = 1024,
                          steps: int = 20, seed: int = 0,
                          noise=None) -> np.ndarray:
        """Token ids of each encoder → the (H/8, W/8, C) float32 latent.
        ``noise`` is the (1, H/8, W/8, C) initial noise; without it the
        noise is drawn from ``torch.Generator(device).manual_seed(seed)``."""
        model = self.model
        device = model.device
        clock = _StageClock(device, "encode_s", "denoise_s")
        pooled = torch.cat(
            [self.clip_l.encode(_ids(clip_l_ids, device))["pooled"],
             self.clip_g.encode(_ids(clip_g_ids, device))["pooled"]],
            dim=-1)

        def states(enc, ids):
            out = enc.encode(_ids(ids, device))
            return out["last_hidden"] if isinstance(out, dict) else out

        cond = (states(self.t5, t5_ids), states(self.llama, llama_ids),
                pooled)
        clock.mark("encode_s")
        gen = torch.Generator(device=device).manual_seed(seed)
        x = _noise_or_draw(noise, (1, height // 8, width // 8,
                                   model.config.in_channels),
                           gen, device, torch.bfloat16)

        def velocity(xc, sigma):
            return model.forward(xc, *cond, sigma.to(torch.float32).expand(
                xc.shape[0]))

        latent = sample_flow(velocity, x,
                             shift_sigmas(linear_schedule(steps), self.shift))
        self.last_latent = latent
        clock.mark("denoise_s")
        self.last_timings = clock.timings()
        return latent[0].to(torch.float32).cpu().numpy()


def _size_embedding(values, like: torch.Tensor) -> torch.Tensor:
    """SDXL's micro-conditioning: each value's 256-wide sinusoidal
    embedding, concatenated → (1, 256·len(values)) in ``like``'s dtype."""
    v = torch.tensor(values, dtype=torch.float32, device=like.device)
    emb = flux_model.timestep_embedding(v, 256, time_factor=1.0)
    return emb.reshape(1, -1).to(like.dtype)


def _unet_denoiser(model: DiffusionModel, cfg_scale: float, conds, nconds):
    """The k-diffusion denoiser of a UNet with CFG: ``conds`` / ``nconds``
    are the forward's (context, y) pairs; ``nconds`` None runs the
    conditional forward alone."""
    eps = cfg_wrap(lambda x_in, t, c: model.forward(x_in, t, *c), conds,
                   nconds, cfg_scale)
    return kd.make_eps_denoiser(eps, kd.ddpm_sigmas())


def _sample_unet(model, cfg_scale, conds, nconds, x, sigmas, sampler, gen,
                 sampler_noise):
    return kd.run_sampler(sampler, _unet_denoiser(model, cfg_scale, conds,
                                                  nconds),
                          x, sigmas, noise=sampler_noise, generator=gen)


def _unet_start(vae_params, vae_config, init_image, denoise, steps, sigmas,
                noise, gen, device, h_lat, w_lat):
    """(x, z0, sigmas) of a UNet request: σ_max-scaled noise for txt2img;
    for img2img the VAE-encoded image noised to the σ at 1 − denoise of the
    schedule, with the schedule cut there."""
    if init_image is None:
        n = _noise_or_draw(noise, (1, h_lat, w_lat, 4), gen, device,
                           torch.bfloat16)
        x = (n.to(torch.float32) * float(sigmas[0])).to(torch.bfloat16)
        return x, None, sigmas
    if vae_params is None:
        raise ValueError("img2img needs a VAE")
    first = min(int(round((1.0 - denoise) * steps)), steps - 1)
    sigmas = sigmas[first:]
    img01 = _on(init_image, device, torch.float32)[None] * 2 - 1
    z0 = vae_model.encode_auto(vae_params, vae_config, img01)
    n = _noise_or_draw(noise, tuple(z0.shape), gen, device, torch.float32)
    x = (z0.to(torch.float32) + n * float(sigmas[0])).to(torch.bfloat16)
    return x, z0, sigmas


@dataclasses.dataclass
class SD1Pipeline:
    """SD1.x txt2img: one CLIP-L conditioning, the eps-prediction UNet
    sampled in σ space (sampling.kdiffusion), CFG as two forwards a step.

    ``noise`` arguments are the standard-normal draws (the initial latent
    noise, of z0's shape for img2img) and ``sampler_noise(shape)`` the
    stochastic samplers' draws; where they are not given they come from
    ``torch.Generator(device).manual_seed(seed)``."""

    model: DiffusionModel
    clip_l: TextEncoder
    vae_params: dict | None = None
    vae_config: object | None = None

    @torch.no_grad()
    def generate_from_ids(self, clip_l_ids, neg_clip_l_ids=None,
                          width: int = 512, height: int = 512,
                          steps: int = 20, cfg_scale: float = 7.0,
                          seed: int = 0, sampler: str = "euler",
                          scheduler: str = "normal",
                          init_image: np.ndarray | None = None,
                          denoise: float = 1.0, noise=None,
                          sampler_noise=None) -> np.ndarray:
        device = self.model.device
        gen = torch.Generator(device=device).manual_seed(seed)
        ctx = self.clip_l.encode(_ids(clip_l_ids, device))["last_hidden"]
        nconds = None
        if cfg_scale != 1.0 and neg_clip_l_ids is not None:
            nconds = (self.clip_l.encode(
                _ids(neg_clip_l_ids, device))["last_hidden"], None)
        sigmas = kd.make_schedule(scheduler, steps, kd.ddpm_sigmas())
        x, _, sigmas = _unet_start(
            self.vae_params, self.vae_config, init_image, denoise, steps,
            sigmas, noise, gen, device, height // 8, width // 8)
        latent = _sample_unet(self.model, cfg_scale, (ctx, None), nconds, x,
                              sigmas, sampler, gen, sampler_noise)
        return _decoded(self.vae_params, self.vae_config, latent)


@dataclasses.dataclass
class SDXLPipeline:
    """SDXL txt2img: CLIP-L ⊕ CLIP-G context and the pooled-G + size
    vector, the eps-prediction UNet sampled in σ space, CFG as two forwards
    a step; the refiner pass in ``refine_from_ids``. Noise arguments as in
    ``SD1Pipeline``; ``step_noise(i, shape)`` is masked sampling step i's
    float32 noise."""

    model: DiffusionModel
    clip_l: TextEncoder
    clip_g: TextEncoder
    vae_params: dict | None = None
    vae_config: object | None = None

    @torch.no_grad()
    def generate_from_ids(self, clip_l_ids, clip_g_ids,
                          neg_clip_l_ids=None, neg_clip_g_ids=None,
                          width: int = 1024, height: int = 1024,
                          steps: int = 20, cfg_scale: float = 7.0,
                          seed: int = 0, sampler: str = "euler",
                          scheduler: str = "normal",
                          init_image: np.ndarray | None = None,
                          denoise: float = 1.0,
                          inpaint_mask: np.ndarray | None = None,
                          noise=None, sampler_noise=None,
                          step_noise=None) -> np.ndarray:
        """txt2img, or img2img when ``init_image`` (H, W, 3) in [0, 1] and
        ``denoise`` < 1 are given; ``inpaint_mask`` (any 2-D, 1 =
        regenerate) with an init_image switches to masked Euler (the
        ``sampler`` argument is not used in that mode)."""
        if inpaint_mask is not None and init_image is None:
            raise ValueError("inpaint_mask needs an init_image")
        device = self.model.device
        gen = torch.Generator(device=device).manual_seed(seed)

        def cond(l_ids, g_ids):
            l_out = self.clip_l.encode(_ids(l_ids, device))
            g_out = self.clip_g.encode(_ids(g_ids, device))
            ctx = torch.cat([l_out["penultimate"], g_out["penultimate"]],
                            dim=-1)
            # the SDXL vector: pooled_g ⊕ size/crop/target embeddings
            y = torch.cat([g_out["pooled"], _size_embedding(
                [height, width, 0, 0, height, width], g_out["pooled"])],
                dim=-1)
            return ctx, y

        conds = cond(clip_l_ids, clip_g_ids)
        nconds = None
        if cfg_scale != 1.0 and neg_clip_l_ids is not None:
            nconds = cond(neg_clip_l_ids, neg_clip_g_ids)
        h_lat, w_lat = height // 8, width // 8
        sigmas = kd.make_schedule(scheduler, steps, kd.ddpm_sigmas())
        x, z0, sigmas = _unet_start(
            self.vae_params, self.vae_config, init_image, denoise, steps,
            sigmas, noise, gen, device, h_lat, w_lat)
        if inpaint_mask is not None:
            m = _resize_nearest(_on(inpaint_mask, device, torch.float32),
                                h_lat, w_lat)
            mask = m[None, :, :, None].expand(z0.shape)
            den = _unet_denoiser(self.model, cfg_scale, conds, nconds)
            noise_fn = _step_noise_or_draw(step_noise, gen, device)
            step = iter(range(len(sigmas)))
            latent = kd.euler_sample_sigma_inpaint(
                den, x, sigmas, z0, mask,
                lambda shape: noise_fn(next(step), tuple(shape)))
        else:
            latent = _sample_unet(self.model, cfg_scale, conds, nconds, x,
                                  sigmas, sampler, gen, sampler_noise)
        return _decoded(self.vae_params, self.vae_config, latent)

    @torch.no_grad()
    def refine_from_ids(self, latent, clip_g_ids, neg_clip_g_ids=None, *,
                        refiner: DiffusionModel, width: int = 1024,
                        height: int = 1024, steps: int = 20,
                        cfg_scale: float = 7.0, denoise: float = 0.25,
                        aesthetic_score: float = 6.0,
                        negative_aesthetic_score: float = 2.5,
                        seed: int = 0, decode: bool = True,
                        sampler: str = "euler", scheduler: str = "normal",
                        noise=None, sampler_noise=None) -> np.ndarray:
        """The SDXL refiner pass (the ensemble-of-experts second stage).

        The refiner UNet conditions on CLIP-G only (1280-wide context) and
        replaces the base model's target-size embeddings with an aesthetic
        score: y = pooled_g ⊕ emb256(h, w, crop_h, crop_w, aesthetic) →
        adm 2560. ``latent`` is the base model's output (h/8, w/8, 4) or
        (1, h/8, w/8, 4); it is re-noised to the σ at 1 − ``denoise`` of
        the schedule (``noise``: that standard-normal draw) and sampled
        down."""
        device = refiner.device
        gen = torch.Generator(device=device).manual_seed(seed)

        def cond(g_ids, score):
            g_out = self.clip_g.encode(_ids(g_ids, device))
            y = torch.cat([g_out["pooled"], _size_embedding(
                [height, width, 0, 0, score], g_out["pooled"])], dim=-1)
            return g_out["penultimate"], y

        conds = cond(clip_g_ids, aesthetic_score)
        nconds = None
        if cfg_scale != 1.0 and neg_clip_g_ids is not None:
            nconds = cond(neg_clip_g_ids, negative_aesthetic_score)
        sigmas = kd.make_schedule(scheduler, steps, kd.ddpm_sigmas())
        first = min(int(round((1.0 - denoise) * steps)), steps - 1)
        sigmas = sigmas[first:]
        lat = _on(latent, device, torch.bfloat16)
        if lat.dim() == 3:
            lat = lat[None]
        n = _noise_or_draw(noise, tuple(lat.shape), gen, device,
                           torch.bfloat16)
        x = (lat.to(torch.float32) + (n.to(torch.float32) * float(
            sigmas[0])).to(torch.bfloat16).to(torch.float32)).to(
                torch.bfloat16)
        out = _sample_unet(refiner, cfg_scale, conds, nconds, x, sigmas,
                           sampler, gen, sampler_noise)
        if not decode:
            return out[0].to(torch.float32).cpu().numpy()
        return _decoded(self.vae_params, self.vae_config, out)


# ---------------------------------------------------------------------------
# continuous-batching engines
# ---------------------------------------------------------------------------

def _mesh_axis_size(mesh, axis: str, what: str) -> int:
    """The size of ``axis`` of an engine's mesh; a mesh without it is
    refused."""
    names = tuple(getattr(mesh, "mesh_dim_names", None) or ())
    if axis not in names:
        raise ValueError(f"{what} needs a mesh with a {axis!r} axis, got "
                         f"axes {names}")
    from .parallel import collectives

    return collectives.axis_size(axis, mesh)


def _dp_step(step, dp_mesh, dp: int):
    """A step over this rank's dp slice of the lanes, then one all-gather
    per output leaf, so every rank's pool stays identical."""
    from .parallel import collectives

    def lanes(t, r, b):
        return t[r * b:(r + 1) * b] if t.ndim else t

    def gather(t):
        if t.dtype == torch.bool:  # not every backend gathers bool
            return gather(t.to(torch.uint8)).to(torch.bool)
        return collectives.all_gather(t, "dp", dim=0, mesh=dp_mesh)

    def fn(*args):
        B = args[0].shape[0]
        r, b = collectives.axis_index("dp", dp_mesh), B // dp

        def cut(a):
            if isinstance(a, dict):
                return {k: cut(v) for k, v in a.items()}
            if isinstance(a, tuple):
                return tuple(cut(v) for v in a)
            return lanes(a, r, b)

        out = step(*(cut(a) for a in args))
        if isinstance(out, tuple):
            x, aux = out
            return gather(x), tuple(gather(a) if a.ndim else a for a in aux)
        return gather(out)

    return fn


def _sig_expand(s: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """(B,) sigma → broadcastable over x's trailing dims."""
    return s.to(torch.float32).reshape((x.shape[0],) + (1,) * (x.ndim - 1))


def _cfg_mix_velocity(fwd, model, ckey: str = "ctx", nkey: str = "nctx",
                      lead=()):
    """Velocity closure for CFG-mixing engines: conditional +
    unconditional forwards, per-request scale mixed in f32. ``lead``: cond
    keys passed to the forward before the conditioning (LTX-Video's
    position ids)."""
    def velocity(params, x, s_cur, cond):
        pre = [cond[k] for k in lead]
        v_c = fwd(params, model.config, x, *pre, cond[ckey], s_cur,
                  qcfg=model.qcfg)
        v_u = fwd(params, model.config, x, *pre, cond[nkey], s_cur,
                  qcfg=model.qcfg)
        return v_u.to(torch.float32) + _sig_expand(
            cond["cfg_scale"], x) * (v_c.to(torch.float32)
                                     - v_u.to(torch.float32))
    return velocity


def make_flow_engine(model: DiffusionModel, velocity, cond_spec: dict, *,
                     max_batch: int = 4, pipeline_depth: int = 1,
                     sampler: str = "euler", dp_mesh=None,
                     params_provider=None):
    """Generic rectified-flow continuous-batching engine on the model's
    device.

    ``velocity(params, x, s_cur, cond) -> v`` — the per-arch forward
    (guidance embeds, rope ids live in the closure); ``cond_spec`` maps
    each stacked cond key to its dtype on the card. Works for any latent
    rank (sigma broadcast follows ``x.ndim``). The latent steps in
    bfloat16.

    ``sampler``: "euler" (1st order) or "dpmpp_2m" — per-LANE 2nd-order
    multistep: each pooled request carries its own denoised history and
    previous sigma in device-resident aux state
    (serving.lane_dpmpp_2m_update), so mixed-progress/mixed-schedule
    batches integrate exactly at the same one-model-call-per-lane cost.

    ``params_provider``: optional zero-arg callable returning the param
    tree to use for THIS tick — the multi-model residency hook
    (serving.ResidentModelServer): an evict/re-place cycle swaps the
    tensors under the same engine.

    ``dp_mesh``: a mesh with a ``"dp"`` axis runs every tick
    data-parallel. Every rank runs the same engine and takes the same
    submissions; each rank steps its dp slice of the pooled lanes and one
    all-gather per tick (latents, and the multistep state) keeps every
    rank's pool identical. Batch buckets are multiples of the dp size and
    ``max_batch`` must divide by it. Exclusive with ``params_provider``.
    """
    from .serving import (ContinuousBatchEngine, flow_multistep_aux_init,
                          lane_dpmpp_2m_update)

    if sampler not in ("euler", "dpmpp_2m"):
        raise ValueError(f"sampler must be euler|dpmpp_2m, got {sampler!r}")
    batch_sizes = None
    if dp_mesh is not None:
        if params_provider is not None:
            raise ValueError("params_provider and dp_mesh are mutually "
                             "exclusive")
        dp = _mesh_axis_size(dp_mesh, "dp", "dp_mesh")
        if max_batch % dp:
            raise ValueError(f"max_batch {max_batch} not divisible by "
                             f"dp={dp}")
        batch_sizes = tuple(sorted(
            {dp * m for m in (1, 2, 4, 8, 16) if dp * m <= max_batch}
            | {max_batch}))
    get_params = params_provider or (lambda: model.params)

    def engine(step, **kw):
        if dp_mesh is not None:
            step = _dp_step(step, dp_mesh, dp)
        return ContinuousBatchEngine(step, max_batch=max_batch,
                                     batch_sizes=batch_sizes,
                                     pipeline_depth=pipeline_depth,
                                     device=model.device, **kw)

    def _cast(cond):
        return {k: cond[k].to(dt) for k, dt in cond_spec.items()}

    if sampler == "euler":
        @torch.no_grad()
        def step_fn(x, s_cur, s_next, cond):
            x = x.to(torch.bfloat16)
            v = velocity(get_params(), x, s_cur, _cast(cond))
            step = _sig_expand(s_next - s_cur, x) * v.to(torch.float32)
            return (x.to(torch.float32) + step).to(x.dtype)

        return engine(step_fn)

    @torch.no_grad()
    def step_fn2m(x, s_cur, s_next, cond, aux):
        x = x.to(torch.bfloat16)
        v = velocity(get_params(), x, s_cur, _cast(cond))
        denoised = (x.to(torch.float32)
                    - _sig_expand(s_cur, x) * v.to(torch.float32))
        return lane_dpmpp_2m_update(x, denoised, s_cur, s_next, aux)

    return engine(step_fn2m, aux_init=flow_multistep_aux_init)


def flux_engine(model: DiffusionModel, h_lat: int, w_lat: int,
                txt_len: int, max_batch: int = 4,
                pipeline_depth: int = 1, mesh=None,
                sampler: str = "euler",
                dp_mesh=None, params_provider=None):
    """Continuous-batching engine for a loaded flux model.

    Requests carry patchified latent tokens (L_img, in_channels) and cond
    {"txt": (txt_len, context_dim), "y": (vec_dim,), "guidance": scalar};
    one engine tick advances the whole in-flight pool by one step
    (serving.ContinuousBatchEngine), each lane at its own sigma. Shapes are
    fixed per engine (one resolution bucket). ``sampler="dpmpp_2m"`` runs
    2nd-order multistep per LANE at the cost of Euler. ``pipeline_depth``
    > 1 lets that many ticks be queued on the card before the engine waits.

    A depth-stacked tree (``DiffusionModel.stack()``) takes
    ``forward_stacked``. ``mesh``: a mesh with a ``"tp"`` axis runs every
    tick tensor-parallel (``parallel.tp_flux``, the per-shard kernels);
    ``model.params`` is then this rank's tree from
    ``tp_flux.place_tp_params``, and every rank runs the engine on the
    same submissions. ``dp_mesh``: data-parallel ticks
    (``make_flow_engine``).
    """
    device = model.device
    img_ids = torch.as_tensor(np.array(flux_model.make_img_ids(
        h_lat // 2, w_lat // 2, 1))[0], device=device)
    txt_ids = torch.zeros((txt_len, 3), dtype=torch.int32, device=device)
    if mesh is not None:
        from .parallel import tp_flux

        _mesh_axis_size(mesh, "tp", "mesh")
        fwd = functools.partial(tp_flux.tp_forward_stacked, mesh=mesh)
    else:
        fwd = (flux_model.forward_stacked if model.is_stacked
               else flux_model.forward)

    def velocity(params, x, s_cur, cond):
        B = x.shape[0]
        ids_i = img_ids[None].expand(B, *img_ids.shape)
        ids_t = txt_ids[None].expand(B, *txt_ids.shape)
        return fwd(params, model.config, x, ids_i, cond["txt"], ids_t,
                   s_cur, cond["y"], cond["guidance"], qcfg=model.qcfg)

    return make_flow_engine(
        model, velocity,
        {"txt": torch.bfloat16, "y": torch.bfloat16,
         "guidance": torch.float32},
        max_batch=max_batch, pipeline_depth=pipeline_depth,
        sampler=sampler, dp_mesh=dp_mesh, params_provider=params_provider)


def _tp_fwd(mesh, plain, tp_name: str):
    """The forward of a tensor-parallel engine (``mesh`` with a "tp" axis:
    ``parallel.tp_spec``'s wrapper on this rank's tree) or ``plain``."""
    if mesh is None:
        return plain
    from .parallel import tp_spec

    _mesh_axis_size(mesh, "tp", "mesh")
    return functools.partial(getattr(tp_spec, tp_name), mesh=mesh)


def sd3_engine(model: DiffusionModel, max_batch: int = 4,
               pipeline_depth: int = 1, sampler: str = "euler",
               dp_mesh=None):
    """Continuous-batching engine for a loaded SD3/SD3.5 model.

    Requests carry spatial latents (h_lat, w_lat, C) + cond {"ctx" (L,
    context_dim), "pooled" (pooled_dim,)}; one tick advances the pool by
    one step (no CFG: one conditional forward a tick, as in the
    reference). A depth-stacked tree (``DiffusionModel.stack()``) takes
    ``forward_stacked``; ``sampler="dpmpp_2m"`` runs per-lane 2nd-order
    multistep (see ``flux_engine``); ``dp_mesh``: data-parallel ticks
    (``make_flow_engine``)."""
    fwd = (sd3_model.forward_stacked if model.is_stacked
           else sd3_model.forward)

    def velocity(params, x, s_cur, cond):
        return fwd(params, model.config, x, cond["ctx"], cond["pooled"],
                   s_cur, qcfg=model.qcfg)

    return make_flow_engine(
        model, velocity, {"ctx": torch.bfloat16, "pooled": torch.bfloat16},
        max_batch=max_batch, pipeline_depth=pipeline_depth,
        sampler=sampler, dp_mesh=dp_mesh)


def _cfg_flow_engine(model: DiffusionModel, mod, ckey: str, nkey: str,
                     max_batch: int, pipeline_depth: int, sampler: str,
                     dp_mesh):
    """A CFG-mixing flow engine over ``mod``'s forward (forward_stacked on a
    stacked tree): cond {ckey, nkey, "cfg_scale"}."""
    fwd = mod.forward_stacked if model.is_stacked else mod.forward
    return make_flow_engine(
        model, _cfg_mix_velocity(fwd, model, ckey=ckey, nkey=nkey),
        {ckey: torch.bfloat16, nkey: torch.bfloat16,
         "cfg_scale": torch.float32},
        max_batch=max_batch, pipeline_depth=pipeline_depth, sampler=sampler,
        dp_mesh=dp_mesh)


def aura_engine(model: DiffusionModel, max_batch: int = 4,
                pipeline_depth: int = 1, sampler: str = "euler",
                dp_mesh=None):
    """Continuous-batching engine for a loaded AuraFlow model: requests
    carry (H, W, C) spatial latents + cond {"ctx", "nctx", "cfg_scale"}
    (Pile-T5 states, padded to one length per engine); each tick runs the
    conditional and the unconditional forward and mixes them at each
    request's own scale. A depth-stacked tree takes ``forward_stacked``;
    ``dp_mesh``: data-parallel ticks (``make_flow_engine``)."""
    return _cfg_flow_engine(model, aura_model, "ctx", "nctx", max_batch,
                            pipeline_depth, sampler, dp_mesh)


def lumina2_engine(model: DiffusionModel, max_batch: int = 4,
                   pipeline_depth: int = 1, sampler: str = "euler",
                   dp_mesh=None):
    """Continuous-batching engine for a loaded Lumina Image 2.0 model:
    requests carry (H, W, C) spatial latents + cond {"cap", "ncap",
    "cfg_scale"} (the llama-graph encoder's states, padded to one length
    per engine); each tick runs the conditional and the unconditional
    forward and mixes them at each request's own scale. A depth-stacked
    tree takes ``forward_stacked``; ``dp_mesh``: data-parallel ticks
    (``make_flow_engine``)."""
    return _cfg_flow_engine(model, lumina2_model, "cap", "ncap", max_batch,
                            pipeline_depth, sampler, dp_mesh)


def wan_engine(model: DiffusionModel, max_batch: int = 2,
               pipeline_depth: int = 1, sampler: str = "euler",
               dp_mesh=None, mesh=None):
    """Continuous-batching engine for a loaded Wan 2.1 t2v model (video
    serving): requests carry (F, H, W, C) latent video + cond {"ctx",
    "nctx", "cfg_scale"}; each tick runs the conditional and the
    unconditional forward and mixes them at each request's own scale. A
    depth-stacked tree takes ``forward_stacked``. ``mesh`` (a "tp" axis):
    tensor-parallel ticks on this rank's ``tp_spec`` tree; ``dp_mesh``:
    data-parallel ticks (``make_flow_engine``)."""
    fwd = _tp_fwd(mesh, wan_model.forward_stacked if model.is_stacked
                  else wan_model.forward, "tp_wan_forward")
    return make_flow_engine(
        model, _cfg_mix_velocity(fwd, model),
        {"ctx": torch.bfloat16, "nctx": torch.bfloat16,
         "cfg_scale": torch.float32},
        max_batch=max_batch, pipeline_depth=pipeline_depth, sampler=sampler,
        dp_mesh=dp_mesh)


def cosmos_engine(model: DiffusionModel, max_batch: int = 2,
                  pipeline_depth: int = 1, sampler: str = "euler",
                  dp_mesh=None):
    """Continuous-batching engine for a loaded Cosmos Predict2 model:
    requests carry (F, H, W, C) latents + cond {"ctx", "nctx",
    "cfg_scale"} (T5 states); each tick runs the conditional and the
    unconditional forward and mixes them at each request's own scale. A
    depth-stacked tree takes ``forward_stacked``; ``dp_mesh``:
    data-parallel ticks (``make_flow_engine``)."""
    return _cfg_flow_engine(model, cosmos_model, "ctx", "nctx", max_batch,
                            pipeline_depth, sampler, dp_mesh)


def qwen_image_engine(model: DiffusionModel, h_tok: int, w_tok: int,
                      txt_len: int, max_batch: int = 4,
                      pipeline_depth: int = 1, sampler: str = "euler",
                      dp_mesh=None, mesh=None):
    """Continuous-batching engine for a loaded Qwen-Image model.

    Requests carry patchified latent tokens (h_tok·w_tok, in_channels) and
    cond {"txt": (txt_len, context_dim)}; the flux-style RoPE ids are fixed
    per engine (one resolution bucket). One conditional forward a tick, as
    in the reference. A depth-stacked tree takes ``forward_stacked``;
    ``sampler="dpmpp_2m"`` runs per-lane 2nd-order multistep. ``mesh`` (a
    "tp" axis): tensor-parallel ticks on this rank's ``tp_spec`` tree;
    ``dp_mesh``: data-parallel ticks (``make_flow_engine``)."""
    device = model.device
    img_ids = torch.as_tensor(np.array(flux_model.make_img_ids(
        h_tok, w_tok, 1))[0], device=device)
    txt_ids = torch.zeros((txt_len, 3), dtype=torch.int32, device=device)
    fwd = _tp_fwd(mesh, qi_model.forward_stacked if model.is_stacked
                  else qi_model.forward, "tp_qwen_image_forward")

    def velocity(params, x, s_cur, cond):
        B = x.shape[0]
        return fwd(params, model.config, x,
                   img_ids[None].expand(B, *img_ids.shape), cond["txt"],
                   txt_ids[None].expand(B, *txt_ids.shape), s_cur,
                   qcfg=model.qcfg)

    return make_flow_engine(model, velocity, {"txt": torch.bfloat16},
                            max_batch=max_batch,
                            pipeline_depth=pipeline_depth, sampler=sampler,
                            dp_mesh=dp_mesh)


def hidream_engine(model: DiffusionModel, max_batch: int = 2,
                   pipeline_depth: int = 1, sampler: str = "euler",
                   dp_mesh=None, mesh=None):
    """Continuous-batching engine for a loaded HiDream-I1 model: requests
    carry (H, W, C) spatial latents and cond {"t5", "llama", "pooled"}
    (guidance-distilled: one forward a tick); the MoE FFNs run in the
    process's ``hidream.MOE_DISPATCH`` mode. A depth-stacked tree takes
    ``forward_stacked``. ``mesh`` (a "tp" axis): tensor-parallel ticks on
    this rank's ``tp_spec`` tree; ``dp_mesh``: data-parallel ticks
    (``make_flow_engine``). Passing both raises ``ValueError`` (the
    reference takes both and fails when it traces)."""
    if dp_mesh is not None and mesh is not None:
        raise ValueError("hidream_engine takes dp_mesh or mesh, not both")
    fwd = _tp_fwd(mesh, hidream_model.forward_stacked if model.is_stacked
                  else hidream_model.forward, "tp_hidream_forward")

    def velocity(params, x, s_cur, cond):
        return fwd(params, model.config, x, cond["t5"], cond["llama"],
                   cond["pooled"], s_cur, qcfg=model.qcfg)

    return make_flow_engine(
        model, velocity, {"t5": torch.bfloat16, "llama": torch.bfloat16,
                          "pooled": torch.bfloat16},
        max_batch=max_batch, pipeline_depth=pipeline_depth, sampler=sampler,
        dp_mesh=dp_mesh)


def hyvid_engine(model: DiffusionModel, max_batch: int = 2,
                 pipeline_depth: int = 1, sampler: str = "euler",
                 dp_mesh=None, mesh=None):
    """Continuous-batching engine for a loaded HunyuanVideo model
    (guidance-distilled video serving): requests carry (F, H, W, C) latent
    video and cond {"txt", "guidance"}; one conditional forward a tick, at
    each request's own embedded guidance (in units of 1.0, embedded ×1000
    as in ``HyVidPipeline``). A depth-stacked tree takes
    ``forward_stacked``. ``mesh`` (a "tp" axis): tensor-parallel ticks on
    this rank's ``tp_spec`` tree; ``dp_mesh``: data-parallel ticks
    (``make_flow_engine``)."""
    fwd = _tp_fwd(mesh, hyvid_model.forward_stacked if model.is_stacked
                  else hyvid_model.forward, "tp_hyvid_forward")

    def velocity(params, x, s_cur, cond):
        return fwd(params, model.config, x, cond["txt"], s_cur,
                   cond["guidance"] * 1000.0, qcfg=model.qcfg)

    return make_flow_engine(
        model, velocity, {"txt": torch.bfloat16, "guidance": torch.float32},
        max_batch=max_batch, pipeline_depth=pipeline_depth, sampler=sampler,
        dp_mesh=dp_mesh)


def ltxv_engine(model: DiffusionModel, max_batch: int = 2,
                pipeline_depth: int = 1, sampler: str = "euler",
                dp_mesh=None):
    """Continuous-batching engine for a loaded LTX-Video model (token
    video serving): requests carry (L, in_channels) latent voxels and cond
    {"ids" (L, 3) voxel positions, "ctx", "nctx", "cfg_scale"}; each tick
    runs the conditional and the unconditional forward and mixes them at
    each request's own scale (1.0 gives the conditional velocity). A
    depth-stacked tree takes ``forward_stacked``; ``dp_mesh``:
    data-parallel ticks (``make_flow_engine``)."""
    fwd = ltxv_model.forward_stacked if model.is_stacked \
        else ltxv_model.forward
    return make_flow_engine(
        model, _cfg_mix_velocity(fwd, model, lead=("ids",)),
        {"ids": torch.int32, "ctx": torch.bfloat16, "nctx": torch.bfloat16,
         "cfg_scale": torch.float32},
        max_batch=max_batch, pipeline_depth=pipeline_depth, sampler=sampler,
        dp_mesh=dp_mesh)


def unet_engine(model: DiffusionModel, max_batch: int = 4,
                pipeline_depth: int = 1, sampler: str = "euler"):
    """Continuous-batching engine for a loaded SD1/SDXL eps-prediction UNet.

    Requests carry (H, W, C) σ-scaled latents (noise × sigmas[0]) + cond
    {"ctx", "nctx", "cfg_scale"} (+ "adm", the pooled/size vector, for
    SDXL) and a k-diffusion σ schedule (``kdiffusion.make_schedule``). Each
    tick runs one per-request-σ step in the k-diffusion parameterization
    (denoised = x − σ·eps(x·c_in, t(σ)), t from ``sigma_to_t`` on
    ``ddpm_sigmas``) with per-request CFG mixing: two forwards a tick.
    ``sampler="dpmpp_2m"`` runs per-lane 2nd-order multistep on the
    denoised prediction. Mixed-progress batches are exact because σ and
    the multistep history are per lane."""
    from .serving import (ContinuousBatchEngine, flow_multistep_aux_init,
                          lane_dpmpp_2m_update)

    if sampler not in ("euler", "dpmpp_2m"):
        raise ValueError(f"sampler must be euler|dpmpp_2m, got {sampler!r}")
    table = kd.ddpm_sigmas()
    needs_adm = model.config.adm_in_channels is not None

    def eps_cfg(x, s_cur, cond):
        x = x.to(torch.bfloat16)
        c_in = 1.0 / torch.sqrt(1.0 + _sig_expand(s_cur, x) ** 2)
        t = kd.sigma_to_t(s_cur.to(torch.float32), table)
        xs = (x.to(torch.float32) * c_in).to(x.dtype)
        y = cond["adm"].to(torch.bfloat16) if needs_adm else None
        e_c, e_u = (unet_model.forward(
            model.params, model.config, xs, t, cond[k].to(torch.bfloat16),
            y, qcfg=model.qcfg).to(torch.float32) for k in ("ctx", "nctx"))
        return e_u + _sig_expand(cond["cfg_scale"], x) * (e_c - e_u)

    if sampler == "euler":
        @torch.no_grad()
        def step_fn(x, s_cur, s_next, cond):
            # denoised = x − σ·eps, so d = (x − denoised) / σ = eps
            eps = eps_cfg(x, s_cur, cond)
            x = x.to(torch.bfloat16)
            return (x.to(torch.float32)
                    + _sig_expand(s_next - s_cur, x) * eps).to(x.dtype)

        return ContinuousBatchEngine(step_fn, max_batch=max_batch,
                                     pipeline_depth=pipeline_depth,
                                     device=model.device)

    @torch.no_grad()
    def step_fn2m(x, s_cur, s_next, cond, aux):
        eps = eps_cfg(x, s_cur, cond)
        x = x.to(torch.bfloat16)
        denoised = x.to(torch.float32) - _sig_expand(s_cur, x) * eps
        return lane_dpmpp_2m_update(x, denoised, s_cur, s_next, aux)

    return ContinuousBatchEngine(step_fn2m, max_batch=max_batch,
                                 pipeline_depth=pipeline_depth,
                                 aux_init=flow_multistep_aux_init,
                                 device=model.device)
