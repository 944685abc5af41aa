"""Synthetic builders for tests, smoke runs and benches (PyTorch port of the
flux, T5, CLIP and VAE parts of comfyui_gguf_tpu/models/testing.py): flux
trees and files, T5 / CLIP-L / AutoencoderKL parameter trees at tiny and at
published widths, and synthetic vocabularies for the native tokenizers.

Random packed weights are generated directly on the device from a seed
(``torch.Generator``) at the real planar layout, so a full-width tree is
never built on the host. Contents are noise, which is all a throughput run
needs. The helpers run on the card unless the caller asks for the CPU.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .._device import resolve_device
from ..gguf.constants import GGMLQuantizationType as Q
from ..quant import codecs
from ..quant.planar import LANE, PlanarQuant, _NIB4_TYPES
from .flux import FluxConfig, make_img_ids, patchify


@dataclasses.dataclass(frozen=True)
class TinyFluxDims:
    hidden: int = 128
    heads: int = 4
    ctx: int = 64
    vec: int = 32
    in_ch: int = 16
    depth_double: int = 2
    depth_single: int = 2
    axes_dim: tuple[int, ...] = (8, 12, 12)

    @property
    def mlp(self) -> int:
        return 4 * self.hidden

    def config(self) -> FluxConfig:
        return FluxConfig(
            in_channels=self.in_ch, hidden=self.hidden, n_heads=self.heads,
            depth_double=self.depth_double, depth_single=self.depth_single,
            axes_dim=self.axes_dim, context_dim=self.ctx, vec_dim=self.vec,
            guidance_embed=True,
        )


# flux1-dev/schnell real dims (12B params)
FLUX_DEV_DIMS = TinyFluxDims(
    hidden=3072, heads=24, ctx=4096, vec=768, in_ch=64,
    depth_double=19, depth_single=38, axes_dim=(16, 56, 56),
)


def _format_of(qtype):
    """(group_size, has_offsets, zero_point) of a planarizable format."""
    probe = np.linspace(-1.0, 1.0, 512, dtype=np.float32)
    comp = codecs.COMPONENT_EXTRACTORS[qtype](codecs.quantize(probe, qtype))
    return comp.group_size, comp.offsets is not None, comp.zero_point


def random_planar(qtype, shape: tuple[int, int], gen: torch.Generator,
                  device="cuda", stack: int | None = None,
                  scale: float = 0.01) -> PlanarQuant:
    """Random PlanarQuant with the exact layout of a real weight, made on
    ``device`` from ``gen``. ``stack=n`` prepends a depth axis of n (the
    stack_flux_params layout) without building per-block copies. ``scale``
    is the standard deviation of the scale and offset planes."""
    device = resolve_device(device)
    R, K = shape
    kp = -(-K // 512) * 512  # planarize pads K to a 512 multiple
    rp = -(-R // LANE) * LANE
    gs, has_offsets, zp = _format_of(qtype)
    lead = () if stack is None else (stack,)
    nib4 = qtype in _NIB4_TYPES
    if nib4:
        qs = torch.randint(0, 256, (*lead, kp // 2, rp), generator=gen,
                           device=device, dtype=torch.uint8)
    else:
        qs = torch.randint(-127, 128, (*lead, kp, rp), generator=gen,
                           device=device, dtype=torch.int8)
        zp = 0

    def plane():
        return torch.randn((*lead, kp // gs, rp), generator=gen,
                           device=device, dtype=torch.float32) * scale

    scales = plane()
    offsets = plane() if has_offsets else None
    return PlanarQuant(qs=qs, scales=scales, offsets=offsets,
                       qtype=int(qtype), layout="nib4" if nib4 else "int8",
                       group_size=gs, zero_point=zp, shape=(R, K))


def _dense_maker(gen: torch.Generator, device):
    def dense(*shape):
        dt = torch.float32 if len(shape) <= 1 else torch.bfloat16
        t = torch.randn(shape, generator=gen, device=device,
                        dtype=torch.float32) * 0.02
        return t.to(dt)
    return dense


def _nonblock_params(dims: TinyFluxDims, dense) -> dict:
    HID, CTX, VEC, INCH = dims.hidden, dims.ctx, dims.vec, dims.in_ch
    return {
        "img_in.weight": dense(HID, INCH), "img_in.bias": dense(HID),
        "txt_in.weight": dense(HID, CTX), "txt_in.bias": dense(HID),
        "time_in.in_layer.weight": dense(HID, 256),
        "time_in.in_layer.bias": dense(HID),
        "time_in.out_layer.weight": dense(HID, HID),
        "time_in.out_layer.bias": dense(HID),
        "vector_in.in_layer.weight": dense(HID, VEC),
        "vector_in.in_layer.bias": dense(HID),
        "vector_in.out_layer.weight": dense(HID, HID),
        "vector_in.out_layer.bias": dense(HID),
        "guidance_in.in_layer.weight": dense(HID, 256),
        "guidance_in.in_layer.bias": dense(HID),
        "guidance_in.out_layer.weight": dense(HID, HID),
        "guidance_in.out_layer.bias": dense(HID),
        "final_layer.linear.weight": dense(INCH, HID),
        "final_layer.linear.bias": dense(INCH),
        "final_layer.adaLN_modulation.1.weight": dense(2 * HID, HID),
        "final_layer.adaLN_modulation.1.bias": dense(2 * HID),
    }


def flux_random_stacked_params(dims: TinyFluxDims, qtype=Q.Q4_K,
                               seed: int = 0, device="cuda") -> dict:
    """Flux params in stack_flux_params layout with random packed block
    weights generated directly stacked on ``device`` (the embedding and
    final layers are dense, as in bench.py's tree)."""
    device = resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    dense = _dense_maker(gen, device)
    HID, MLP = dims.hidden, dims.mlp
    hd = HID // dims.heads
    nd, ns = dims.depth_double, dims.depth_single

    def packed(n, r, k):
        return random_planar(qtype, (r, k), gen, device=device, stack=n)

    params = _nonblock_params(dims, dense)
    double = {}
    for s in ("img", "txt"):
        double[f"{s}_mod.lin.weight"] = packed(nd, 6 * HID, HID)
        double[f"{s}_mod.lin.bias"] = dense(nd, 6 * HID)
        double[f"{s}_attn.qkv.weight"] = packed(nd, 3 * HID, HID)
        double[f"{s}_attn.qkv.bias"] = dense(nd, 3 * HID)
        double[f"{s}_attn.norm.query_norm.scale"] = dense(nd, hd)
        double[f"{s}_attn.norm.key_norm.scale"] = dense(nd, hd)
        double[f"{s}_attn.proj.weight"] = packed(nd, HID, HID)
        double[f"{s}_attn.proj.bias"] = dense(nd, HID)
        double[f"{s}_mlp.0.weight"] = packed(nd, MLP, HID)
        double[f"{s}_mlp.0.bias"] = dense(nd, MLP)
        double[f"{s}_mlp.2.weight"] = packed(nd, HID, MLP)
        double[f"{s}_mlp.2.bias"] = dense(nd, HID)
    params["double_blocks"] = double
    params["single_blocks"] = {
        "linear1.weight": packed(ns, 3 * HID + MLP, HID),
        "linear1.bias": dense(ns, 3 * HID + MLP),
        "linear2.weight": packed(ns, HID, HID + MLP),
        "linear2.bias": dense(ns, HID),
        "modulation.lin.weight": packed(ns, 3 * HID, HID),
        "modulation.lin.bias": dense(ns, 3 * HID),
        "norm.query_norm.scale": dense(ns, hd),
        "norm.key_norm.scale": dense(ns, hd),
    }
    return params


def flux_example_inputs(dims: TinyFluxDims, batch: int = 1, h_lat: int = 8,
                        w_lat: int = 8, txt_len: int = 16, seed: int = 1,
                        dtype=torch.bfloat16, device="cuda"):
    """(img, img_ids, txt, txt_ids, t, y, guidance) matching flux.forward,
    made from a numpy seed (the same numbers as the reference helper)."""
    device = resolve_device(device)
    rng = np.random.default_rng(seed)
    lat_c = dims.in_ch // 4

    def t(a, dt=dtype):
        return torch.as_tensor(np.asarray(a, np.float32)).to(device=device,
                                                             dtype=dt)

    latent = t(rng.standard_normal((batch, h_lat, w_lat, lat_c)))
    img = patchify(latent)
    img_ids = torch.as_tensor(
        np.array(make_img_ids(h_lat // 2, w_lat // 2, batch)), device=device)
    txt = t(rng.standard_normal((batch, txt_len, dims.ctx)))
    txt_ids = torch.zeros((batch, txt_len, 3), dtype=torch.int32,
                          device=device)
    ts = torch.ones((batch,), dtype=torch.float32, device=device)
    y = t(rng.standard_normal((batch, dims.vec)))
    g = torch.full((batch,), 4.0, dtype=torch.float32, device=device)
    return img, img_ids, txt, txt_ids, ts, y, g


def flux_state_dict(dims: TinyFluxDims, seed: int = 0,
                    dtype=np.float32) -> dict[str, np.ndarray]:
    """Random flux state dict (numpy, BFL key naming) — the same numbers
    as the reference package's helper of this name."""
    rng = np.random.default_rng(seed)
    HID, CTX, VEC, INCH, MLP = (dims.hidden, dims.ctx, dims.vec, dims.in_ch,
                                dims.mlp)
    hd = HID // dims.heads

    def t(*shape):
        return (rng.standard_normal(shape) * 0.02).astype(dtype)

    sd = _nonblock_params(dims, t)
    for i in range(dims.depth_double):
        p = f"double_blocks.{i}."
        for s in ("img", "txt"):
            sd[p + f"{s}_mod.lin.weight"] = t(6 * HID, HID)
            sd[p + f"{s}_mod.lin.bias"] = t(6 * HID)
            sd[p + f"{s}_attn.qkv.weight"] = t(3 * HID, HID)
            sd[p + f"{s}_attn.qkv.bias"] = t(3 * HID)
            sd[p + f"{s}_attn.norm.query_norm.scale"] = t(hd) + 1
            sd[p + f"{s}_attn.norm.key_norm.scale"] = t(hd) + 1
            sd[p + f"{s}_attn.proj.weight"] = t(HID, HID)
            sd[p + f"{s}_attn.proj.bias"] = t(HID)
            sd[p + f"{s}_mlp.0.weight"] = t(MLP, HID)
            sd[p + f"{s}_mlp.0.bias"] = t(MLP)
            sd[p + f"{s}_mlp.2.weight"] = t(HID, MLP)
            sd[p + f"{s}_mlp.2.bias"] = t(HID)
    for i in range(dims.depth_single):
        p = f"single_blocks.{i}."
        sd[p + "linear1.weight"] = t(3 * HID + MLP, HID)
        sd[p + "linear1.bias"] = t(3 * HID + MLP)
        sd[p + "linear2.weight"] = t(HID, HID + MLP)
        sd[p + "linear2.bias"] = t(HID)
        sd[p + "modulation.lin.weight"] = t(3 * HID, HID)
        sd[p + "modulation.lin.bias"] = t(3 * HID)
        sd[p + "norm.query_norm.scale"] = t(hd) + 1
        sd[p + "norm.key_norm.scale"] = t(hd) + 1
    return sd


def flux_block_qtype(key: str, arr: np.ndarray, qtype):
    """The quantization policy of a converted flux file: block weights
    quantize, the embedders, norms and final layer stay float (None)."""
    if (arr.ndim == 2 and arr.shape[1] % 256 == 0 and "norm" not in key
            and "_in." not in key
            and not key.startswith(("final_layer.", "img_in", "txt_in"))):
        return qtype
    return None


def write_flux_gguf(sd: dict, path: str, qtype_of) -> None:
    """Write ``sd`` as a flux GGUF with the ``model.diffusion_model.``
    prefix; ``qtype_of(key, array)`` picks each tensor's format (None =
    stored as float)."""
    from ..gguf.writer import GGUFWriter

    w = GGUFWriter("flux")
    pfx = "model.diffusion_model."
    for k, v in sd.items():
        qtype = qtype_of(k, v)
        if qtype is None:
            w.add_tensor(pfx + k, np.ascontiguousarray(v, np.float32))
        else:
            w.add_tensor(pfx + k, codecs.quantize(v, qtype), raw_dtype=qtype,
                         raw_shape=v.shape)
    w.write_to_file(str(path))


# ---------------------------------------------------------------------------
# text encoders and VAE
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class T5Dims:
    d_model: int = 64
    d_kv: int = 16
    n_heads: int = 4
    d_ff: int = 128
    n_layers: int = 2
    vocab: int = 16
    rel_buckets: int = 32


# t5-v1_1-xxl encoder (flux / sd3 conditioning)
T5_XXL_DIMS = T5Dims(d_model=4096, d_kv=64, n_heads=64, d_ff=10240,
                     n_layers=24, vocab=32128, rel_buckets=32)

_T5_REL = "encoder.block.0.layer.0.SelfAttention.relative_attention_bias.weight"


def _t5_linear_shapes(d: T5Dims):
    inner = d.n_heads * d.d_kv
    return {"layer.0.SelfAttention.q": (inner, d.d_model),
            "layer.0.SelfAttention.k": (inner, d.d_model),
            "layer.0.SelfAttention.v": (inner, d.d_model),
            "layer.0.SelfAttention.o": (d.d_model, inner),
            "layer.1.DenseReluDense.wi_0": (d.d_ff, d.d_model),
            "layer.1.DenseReluDense.wi_1": (d.d_ff, d.d_model),
            "layer.1.DenseReluDense.wo": (d.d_model, d.d_ff)}


def t5_state_dict(dims: T5Dims, seed: int = 0,
                  scale: float = 0.05) -> dict[str, np.ndarray]:
    """Random T5 encoder state dict (numpy float32, HF key naming)."""
    rng = np.random.default_rng(seed)

    def t(*s):
        return (rng.standard_normal(s) * scale).astype(np.float32)

    sd = {"shared.weight": t(dims.vocab, dims.d_model),
          "encoder.final_layer_norm.weight": t(dims.d_model) + 1,
          _T5_REL: t(dims.rel_buckets, dims.n_heads)}
    for i in range(dims.n_layers):
        p = f"encoder.block.{i}."
        for name, shape in _t5_linear_shapes(dims).items():
            sd[f"{p}{name}.weight"] = t(*shape)
        sd[p + "layer.0.layer_norm.weight"] = t(dims.d_model) + 1
        sd[p + "layer.1.layer_norm.weight"] = t(dims.d_model) + 1
    return sd


def t5_random_params(dims: T5Dims, qtype=Q.Q8_0, seed: int = 0,
                     device="cuda") -> dict:
    """T5 encoder params with random packed linears made directly on
    ``device`` (a full-width tree is never built on the host). The token
    embedding is dense bf16, as ``gguf_clip_loader`` leaves it; scale planes
    are sized so that each linear keeps unit-variance inputs near unit
    variance."""
    device = resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    dense = _dense_maker(gen, device)
    params = {"shared.weight": dense(dims.vocab, dims.d_model),
              "encoder.final_layer_norm.weight": dense(dims.d_model) + 1,
              _T5_REL: dense(dims.rel_buckets, dims.n_heads).to(
                  torch.float32)}
    for i in range(dims.n_layers):
        p = f"encoder.block.{i}."
        for name, (r, k) in _t5_linear_shapes(dims).items():
            params[f"{p}{name}.weight"] = random_planar(
                qtype, (r, k), gen, device=device,
                scale=1.0 / (73.0 * k ** 0.5))
        params[p + "layer.0.layer_norm.weight"] = dense(dims.d_model) + 1
        params[p + "layer.1.layer_norm.weight"] = dense(dims.d_model) + 1
    return params


_T5_GGUF_NAMES = {
    "shared": "token_embd", "encoder.final_layer_norm": "enc.output_norm",
    "layer.0.SelfAttention.relative_attention_bias": "attn_rel_b",
    "layer.0.SelfAttention.q": "attn_q", "layer.0.SelfAttention.k": "attn_k",
    "layer.0.SelfAttention.v": "attn_v", "layer.0.SelfAttention.o": "attn_o",
    "layer.0.layer_norm": "attn_norm", "layer.1.layer_norm": "ffn_norm",
    "layer.1.DenseReluDense.wi_0": "ffn_gate",
    "layer.1.DenseReluDense.wi_1": "ffn_up",
    "layer.1.DenseReluDense.wo": "ffn_down",
    "encoder.block.": "enc.blk.",
}


def write_t5_gguf(sd: dict, path: str, qtype=Q.Q8_0, tokenizer=None) -> None:
    """Write an HF-named T5 state dict as a llama.cpp-named ``t5`` GGUF:
    2-D weights in ``qtype`` (the relative-bias table and the norms stay
    float32), plus the ``tokenizer.ggml.*`` metadata of ``tokenizer`` (a
    ``loader.TokenizerSpec``) that ``gguf_tokenizer_spec`` reads back."""
    from ..gguf.writer import GGUFWriter

    w = GGUFWriter("t5")
    if tokenizer is not None:
        w.add_string("tokenizer.ggml.model", tokenizer.model)
        w.add_array("tokenizer.ggml.tokens", list(tokenizer.tokens))
        if tokenizer.scores is not None:
            w.add_array("tokenizer.ggml.scores",
                        [float(x) for x in tokenizer.scores])
        if tokenizer.token_types is not None:
            w.add_array("tokenizer.ggml.token_type",
                        [int(x) for x in tokenizer.token_types])
        for key, val in (("eos_token_id", tokenizer.eos_id),
                         ("padding_token_id", tokenizer.pad_id),
                         ("unknown_token_id", tokenizer.unk_id)):
            if val is not None:
                w.add_uint32("tokenizer.ggml." + key, int(val))
        w.add_bool("tokenizer.ggml.add_eos_token", bool(tokenizer.add_eos))
    for k, v in sd.items():
        for hf, gg in _T5_GGUF_NAMES.items():
            k = k.replace(hf, gg)
        quant = (v.ndim == 2 and "attn_rel_b" not in k
                 and v.shape[1] % 32 == 0)
        if quant:
            w.add_tensor(k, codecs.quantize(v, qtype), raw_dtype=qtype,
                         raw_shape=v.shape)
        else:
            w.add_tensor(k, np.ascontiguousarray(v, np.float32))
    w.write_to_file(str(path))


@dataclasses.dataclass(frozen=True)
class CLIPDims:
    hidden: int = 64
    n_layers: int = 2
    n_heads: int = 1  # CLIPTextConfig.from_state_dict infers hidden // 64
    intermediate: int = 96
    vocab: int = 24
    max_positions: int = 16
    proj: int | None = 32  # text_projection out-features (None: absent)


# OpenAI CLIP ViT-L/14 text tower (flux's pooled conditioning)
CLIP_L_DIMS = CLIPDims(hidden=768, n_layers=12, n_heads=12,
                       intermediate=3072, vocab=49408, max_positions=77,
                       proj=768)


def _clip_shapes(d: CLIPDims) -> dict[str, tuple]:
    h = d.hidden
    out = {"text_model.embeddings.token_embedding.weight": (d.vocab, h),
           "text_model.embeddings.position_embedding.weight":
               (d.max_positions, h),
           "text_model.final_layer_norm.weight": (h,),
           "text_model.final_layer_norm.bias": (h,)}
    if d.proj is not None:
        out["text_projection.weight"] = (d.proj, h)
    for i in range(d.n_layers):
        p = f"text_model.encoder.layers.{i}"
        for n in ("q_proj", "k_proj", "v_proj", "out_proj"):
            out[f"{p}.self_attn.{n}.weight"] = (h, h)
            out[f"{p}.self_attn.{n}.bias"] = (h,)
        for n in ("layer_norm1", "layer_norm2"):
            out[f"{p}.{n}.weight"] = (h,)
            out[f"{p}.{n}.bias"] = (h,)
        out[f"{p}.mlp.fc1.weight"] = (d.intermediate, h)
        out[f"{p}.mlp.fc1.bias"] = (d.intermediate,)
        out[f"{p}.mlp.fc2.weight"] = (h, d.intermediate)
        out[f"{p}.mlp.fc2.bias"] = (h,)
    return out


def _is_norm_gain(key: str) -> bool:
    return "norm" in key and key.endswith(".weight")


def clip_state_dict(dims: CLIPDims, seed: int = 0,
                    scale: float = 0.05) -> dict[str, np.ndarray]:
    """Random CLIP text-tower state dict (numpy float32, HF key naming)."""
    rng = np.random.default_rng(seed)
    return {k: ((rng.standard_normal(shape) * scale).astype(np.float32)
                + (1 if _is_norm_gain(k) else 0))
            for k, shape in _clip_shapes(dims).items()}


def clip_random_params(dims: CLIPDims, seed: int = 0, device="cuda") -> dict:
    """Dense float32 CLIP params made on ``device`` from a seed."""
    device = resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    out = {}
    for k, shape in _clip_shapes(dims).items():
        std = 0.02 if len(shape) == 1 else shape[-1] ** -0.5
        t = torch.randn(shape, generator=gen, device=device) * std
        out[k] = t + 1 if _is_norm_gain(k) else t
    return out


@dataclasses.dataclass(frozen=True)
class VAEDims:
    z_channels: int = 4
    base_ch: int = 32
    ch_mult: tuple[int, ...] = (1, 1, 1, 1)
    num_res_blocks: int = 1


# the 16-channel flux AutoencoderKL (ae.safetensors)
FLUX_VAE_DIMS = VAEDims(z_channels=16, base_ch=128, ch_mult=(1, 2, 4, 4),
                        num_res_blocks=2)


def _vae_shapes(d: VAEDims) -> dict[str, tuple]:
    """Every tensor of an sgm-format AutoencoderKL of this geometry."""
    out = {}

    def conv(name, o, i, k=3):
        out[f"{name}.weight"] = (o, i, k, k)
        out[f"{name}.bias"] = (o,)

    def norm(name, c):
        out[f"{name}.weight"] = (c,)
        out[f"{name}.bias"] = (c,)

    def resnet(p, cin, cout):
        norm(f"{p}.norm1", cin)
        conv(f"{p}.conv1", cout, cin)
        norm(f"{p}.norm2", cout)
        conv(f"{p}.conv2", cout, cout)
        if cin != cout:
            conv(f"{p}.nin_shortcut", cout, cin, 1)

    chans = [d.base_ch * m for m in d.ch_mult]
    top, z = chans[-1], d.z_channels
    conv("decoder.conv_in", top, z)
    norm("decoder.norm_out", chans[0])
    conv("decoder.conv_out", 3, chans[0])
    conv("encoder.conv_in", chans[0], 3)
    norm("encoder.norm_out", top)
    conv("encoder.conv_out", 2 * z, top)
    for side in ("decoder.mid", "encoder.mid"):
        resnet(f"{side}.block_1", top, top)
        norm(f"{side}.attn_1.norm", top)
        for n in ("q", "k", "v", "proj_out"):
            conv(f"{side}.attn_1.{n}", top, top, 1)
        resnet(f"{side}.block_2", top, top)
    n_levels = len(d.ch_mult)
    cur = top
    for i in reversed(range(n_levels)):
        for j in range(d.num_res_blocks + 1):
            resnet(f"decoder.up.{i}.block.{j}", cur, chans[i])
            cur = chans[i]
        if i > 0:
            conv(f"decoder.up.{i}.upsample.conv", cur, cur)
    cur = chans[0]
    for i in range(n_levels):
        for j in range(d.num_res_blocks):
            resnet(f"encoder.down.{i}.block.{j}", cur, chans[i])
            cur = chans[i]
        if i < n_levels - 1:
            conv(f"encoder.down.{i}.downsample.conv", cur, cur)
    return out


def vae_state_dict(dims: VAEDims, seed: int = 0,
                   scale: float = 0.05) -> dict[str, np.ndarray]:
    """Random sgm-format AutoencoderKL state dict (numpy float32): conv
    weights N(0, scale²), unit norm gains, zero biases."""
    rng = np.random.default_rng(seed)
    out = {}
    for k, shape in _vae_shapes(dims).items():
        if len(shape) == 4:
            out[k] = (rng.standard_normal(shape) * scale).astype(np.float32)
        else:
            out[k] = (np.ones if _is_norm_gain(k) else np.zeros)(
                shape, np.float32)
    return out


def vae_random_params(dims: VAEDims, seed: int = 0, device="cuda") -> dict:
    """Dense float32 VAE params made on ``device`` from a seed (conv
    weights scaled by fan-in so activations stay bounded at full depth)."""
    device = resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    out = {}
    for k, shape in _vae_shapes(dims).items():
        if len(shape) == 4:
            fan_in = shape[1] * shape[2] * shape[3]
            out[k] = torch.randn(shape, generator=gen,
                                 device=device) * fan_in ** -0.5
        elif _is_norm_gain(k):
            out[k] = torch.ones(shape, device=device)
        else:
            out[k] = torch.zeros(shape, device=device)
    return out


# ---------------------------------------------------------------------------
# synthetic vocabularies
# ---------------------------------------------------------------------------

SMOKE_WORDS = ("a", "photo", "of", "cat", "sitting", "on", "the", "moon",
               "an", "oil", "painting", "lighthouse", "in", "storm", "at",
               "night", "red", "fox", "snow", "city", "street", "rain")


def unigram_spec(vocab_size: int = 64, words=SMOKE_WORDS):
    """A synthetic T5-style ``TokenizerSpec`` of exactly ``vocab_size``
    pieces: <pad>, </s>, <unk>, whole-word pieces for ``words``, the
    printable ASCII characters (so any ASCII prompt segments), then unused
    filler pieces."""
    from ..loader import TokenizerSpec

    tokens = ["<pad>", "</s>", "<unk>"]
    scores = [0.0, 0.0, 0.0]
    types = [3, 3, 2]
    pieces = ["▁"] + ["▁" + w for w in words] \
        + [chr(c) for c in range(33, 127)]
    for rank, piece in enumerate(pieces):
        if len(tokens) == vocab_size:
            break
        tokens.append(piece)
        # whole words beat their spellings; shorter ranks score higher
        scores.append(-1.0 - 0.01 * rank if len(piece) > 1 else -8.0)
        types.append(1)
    while len(tokens) < vocab_size:
        tokens.append(f"<unused_{len(tokens)}>")
        scores.append(0.0)
        types.append(5)
    return TokenizerSpec(model="t5", tokens=tokens, scores=scores,
                         token_types=types, eos_id=1, pad_id=0, unk_id=2)


def clip_vocab(vocab_size: int = 49408, words=SMOKE_WORDS):
    """A synthetic CLIP BPE vocabulary ``(vocab, merges)`` of exactly
    ``vocab_size`` entries in the real file's order: the 256 byte symbols,
    their end-of-word forms, the merge products of ``words``, filler, and
    the two specials last (so <|endoftext|> has the highest id, 49407 at
    the real size). Truncated to the symbols that fit when ``vocab_size``
    is small."""
    from ..tokenizer.bpe import bytes_to_unicode

    syms = list(bytes_to_unicode().values())
    tokens = syms + [s + "</w>" for s in syms]
    merges = []
    for wd in words:
        parts = list(wd[:-1]) + [wd[-1] + "</w>"]
        while len(parts) > 1:
            pair = f"{parts[0]} {parts[1]}"
            merged = parts[0] + parts[1]
            if pair not in merges:
                merges.append(pair)
                tokens.append(merged)
            parts = [merged] + parts[2:]
    room = vocab_size - 2
    if len(tokens) > room:  # a tiny vocabulary keeps ASCII and drops merges
        keep = [t for t in tokens[:512] if t[0].isascii()][:room]
        tokens, merges = keep, []
    tokens = list(dict.fromkeys(tokens))
    while len(tokens) < room:
        tokens.append(f"<filler_{len(tokens)}>")
    tokens += ["<|startoftext|>", "<|endoftext|>"]
    return {t: i for i, t in enumerate(tokens)}, merges


def write_clip_vocab(directory: str, vocab: dict, merges: list) -> None:
    """``vocab.json`` and ``merges.txt`` as HF ships them."""
    import json
    import os

    with open(os.path.join(directory, "vocab.json"), "w",
              encoding="utf-8") as f:
        json.dump(vocab, f, ensure_ascii=False)
    with open(os.path.join(directory, "merges.txt"), "w",
              encoding="utf-8") as f:
        f.write("#version: 0.2\n" + "\n".join(merges) + "\n")
