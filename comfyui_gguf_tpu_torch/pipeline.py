"""User-facing model loading + generation API (PyTorch port of
comfyui_gguf_tpu/pipeline.py).

* ``load_diffusion_model(path)`` — GGUF → ``DiffusionModel`` with packed
  planar weights on the card; ``apply_lora(path, strength)`` attaches a
  LoRA file (packed weights stay packed: the rank term rides the kernels'
  epilogues), ``requantize_i8()`` converts it to the w8a8 format and
  ``stack()`` restacks the blocks along a depth axis, in that order.
* ``load_text_encoders(paths)`` — text-encoder files, GGUF (T5) or
  safetensors (CLIP), each with its graph and tokenizer.
* ``load_vae(path)`` — the image AutoencoderKL from a safetensors file.
* ``FluxPipeline.load(...).generate(prompt)`` — full text-to-image:
  tokenize → T5 + CLIP-L encode → denoise → VAE decode, with img2img,
  inpainting and Kontext references. ``TextEncoder.apply_lora`` attaches a
  LoRA file's text-encoder slice; ``textual_inversion.EmbeddingSet`` adds
  textual-inversion embeddings to an encoder.

Everything runs on the card unless the caller passes ``device="cpu"``.
The llama text encoders, the video VAEs and the other architectures are
not ported yet and raise ``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import time

import numpy as np
import torch

from . import _safetensors
from . import lora as lora_mod
from ._device import resolve_device
from .loader import gguf_clip_loader, gguf_sd_loader, to_torch_params
from .models import clip as clip_model
from .models import flux as flux_model
from .models import t5 as t5_model
from .models import vae as vae_model
from .nn.layers import QuantConfig
from .sampling import euler_sample_inpaint, flux_schedule, sample_flow

log = logging.getLogger(__name__)

# arch -> (model module, config class); flux only in this slice
_ARCH_TABLE = {"flux": (flux_model, flux_model.FluxConfig)}


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
        return self.arch == "flux" and "double_blocks" in self.params

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

    def requantize_i8(self, *, mod_planar: bool = True) -> "DiffusionModel":
        """Convert packed planar weights to the w8a8 format (quant/i8.py).

        mod_planar: keep the adaLN/modulation projections (M=batch rows,
        bandwidth-bound) on the planar path. Each planar leaf is dropped as
        it converts, so both trees never sit on the card at once, and the
        model cannot go back to the planar tree. Patched leaves convert
        their base and keep their patches. Call AFTER apply_lora. Mutates
        self and returns it.
        """
        from .quant.i8 import convert_tree_i8, is_modulation_key

        pred = (lambda k, v: not is_modulation_key(k)) if mod_planar \
            else None
        self.params = convert_tree_i8(self.params, free_source=True,
                                      pred=pred)
        self.base_params = None
        return self

    def stack(self) -> "DiffusionModel":
        """Restack per-block params along a depth axis (copies the block
        weights once); forward then runs forward_stacked."""
        if self.arch == "flux" and not self.is_stacked:
            return dataclasses.replace(
                self, params=flux_model.stack_flux_params(self.params,
                                                          self.config))
        return self


def load_diffusion_model(path: str, device="cuda") -> DiffusionModel:
    """GGUF diffusion model → DiffusionModel on ``device`` (the card unless
    the caller asks for the CPU; raises if CUDA is asked for and absent)."""
    device = resolve_device(device)
    qcfg = QuantConfig()
    sd, arch = gguf_sd_loader(path, return_arch=True)
    params = to_torch_params(sd, qcfg, device=device)
    config = None
    if arch in _ARCH_TABLE:
        config = _ARCH_TABLE[arch][1].from_state_dict(params)
    return DiffusionModel(arch=arch, params=params, config=config, qcfg=qcfg,
                          device=device)


@dataclasses.dataclass
class TextEncoder:
    kind: str  # "t5" | "clip_l" | "clip_g"
    params: dict
    config: object
    tokenizer: object | None
    qcfg: QuantConfig
    device: torch.device

    def encode(self, *args, **kwargs):
        mod = {"t5": t5_model, "clip_l": clip_model,
               "clip_g": clip_model}[self.kind]
        with torch.no_grad():
            return mod.encode(self.params, self.config, *args,
                              qcfg=self.qcfg, **kwargs)

    def apply_lora(self, path: str, strength: float = 1.0):
        """Attach this encoder's slice of a LoRA file (kohya ``lora_te_``
        for SD1's CLIP, ``lora_te1_``/``lora_te2_`` for the SDXL pair,
        ``lora_te3_`` for T5; the ``lora_unet_`` slice goes to
        DiffusionModel.apply_lora). Mutates self and returns it."""
        prefixes = {"clip_l": ("te1", "te"), "clip_g": ("te2",),
                    "t5": ("te3", "te")}[self.kind]
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

    → (kind, params, config). Only the "image" family (AutoencoderKL,
    decoded with models.vae) is ported; the video families raise. Strips a
    leading ``vae.`` / ``first_stage_model.`` prefix (checkpoint-bundled
    VAEs use it)."""
    device = resolve_device(device)
    raw = _load_safetensors_sd(path)
    for pfx in ("vae.", "first_stage_model."):
        if any(k.startswith(pfx) for k in raw):
            raw = {k[len(pfx):]: v for k, v in raw.items()
                   if k.startswith(pfx)}
            break
    if (any(k.startswith(("decoder.middle.", "decoder.mid_block."))
            for k in raw)
            or any(".res_blocks." in k or "per_channel_statistics" in k
                   for k in raw)):
        raise NotImplementedError(
            "video VAEs (wan, hyvid, ltxv) and diffusers-format image VAEs "
            "are not ported yet (ROADMAP queue 1, the video VAE item)")
    params = _to_device(raw, device)
    return "image", params, vae_model.VAEConfig.from_state_dict(params)


def load_text_encoder(path: str, device="cuda") -> TextEncoder:
    """One text-encoder file (gguf or safetensors) → TextEncoder."""
    device = resolve_device(device)
    qcfg = QuantConfig()
    tokenizer = None
    if path.endswith(".gguf"):
        sd, arch, tok_spec = gguf_clip_loader(path)
        if arch not in ("t5", "t5encoder"):
            if arch in ("llama", "qwen2vl", "qwen3", "qwen3vl"):
                raise NotImplementedError(
                    f"the {arch} text encoder is not ported yet (ROADMAP "
                    f"queue 1, the llama item)")
            raise ValueError(f"unsupported text arch {arch!r}")
        params = to_torch_params(sd, qcfg, device=device)
        if tok_spec is not None:
            from .tokenizer import build_tokenizer

            try:
                tokenizer = build_tokenizer(tok_spec)
            except NotImplementedError:
                log.warning("no native tokenizer for %s", tok_spec.model)
        return TextEncoder("t5", params,
                           t5_model.T5Config.from_state_dict(params),
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
        cuda = device.type == "cuda"
        marks = [("start", time.perf_counter())]

        def mark(name):
            if cuda:
                torch.cuda.synchronize(device)
            marks.append((name, time.perf_counter()))

        def dev(a, dtype):
            return torch.as_tensor(np.asarray(a) if not isinstance(
                a, torch.Tensor) else a).to(device=device, dtype=dtype)

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
        if self.vae_params is None:
            result = latent[0].to(torch.float32).cpu().numpy()
        else:
            img = vae_model.decode_auto(self.vae_params, self.vae_config,
                                        latent)
            result = ((img[0].clamp(-1, 1) + 1) / 2).cpu().numpy()
        mark("vae_s")
        self.last_timings = {
            name: t - marks[i][1] for i, (name, t) in enumerate(marks[1:])}
        self.last_timings["total_s"] = marks[-1][1] - marks[0][1]
        return result
