"""Synthetic builders for tests, smoke runs and benches (PyTorch port of the
flux, SD3, SD1/SDXL UNet, AuraFlow, Lumina 2, Qwen-Image, HiDream, Wan,
Cosmos, HunyuanVideo, LTX-Video, T5, CLIP, llama and VAE parts of
comfyui_gguf_tpu/models/testing.py): flux, SD3, UNet, AuraFlow, Lumina 2,
Qwen-Image, HiDream, Wan 2.1, Cosmos, HunyuanVideo and LTX-Video trees and
files, T5 / UMT5 / CLIP-L / CLIP-G / llama-family / Qwen-VL vision tower /
AutoencoderKL / Wan 2.1, HunyuanVideo and LTX-Video video VAE parameter
trees at tiny and at published widths, an mmproj sidecar writer, and synthetic
vocabularies for the native tokenizers.

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
from ..archs import get_arch_spec
from ..gguf.constants import GGML_QUANT_SIZES
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


def flux_flat_views(sparams: dict) -> dict:
    """The flat (per-block key) tree of a stack_flux_params-layout tree, as
    views of its stacked leaves (no copy): what ``DiffusionModel.apply_lora``
    takes, since LoRA keys name the flat per-block weights."""
    out = {k: v for k, v in sparams.items()
           if k not in ("double_blocks", "single_blocks")}
    for group in ("double_blocks", "single_blocks"):
        for k, v in sparams.get(group, {}).items():
            for i in range(getattr(v, "qs", v).shape[0]):
                out[f"{group}.{i}.{k}"] = v[i]
    return out


def flux_lora_targets(dims: TinyFluxDims) -> list[tuple[str, int, int]]:
    """(weight key, R, K) of every block linear a flux LoRA patches: 10 a
    double block (both streams' modulation, qkv, proj, mlp.0, mlp.2) and 3
    a single block (linear1, linear2, modulation)."""
    HID, MLP = dims.hidden, dims.mlp
    out = []
    for i in range(dims.depth_double):
        for s in ("img", "txt"):
            p = f"double_blocks.{i}.{s}_"
            out += [(p + "mod.lin.weight", 6 * HID, HID),
                    (p + "attn.qkv.weight", 3 * HID, HID),
                    (p + "attn.proj.weight", HID, HID),
                    (p + "mlp.0.weight", MLP, HID),
                    (p + "mlp.2.weight", HID, MLP)]
    for i in range(dims.depth_single):
        p = f"single_blocks.{i}."
        out += [(p + "linear1.weight", 3 * HID + MLP, HID),
                (p + "linear2.weight", HID, HID + MLP),
                (p + "modulation.lin.weight", 3 * HID, HID)]
    return out


def encoder_lora_targets(params: dict) -> list[tuple[str, int, int]]:
    """(weight key, R, K) of every attention and MLP linear of a T5 or CLIP
    encoder tree (dense or packed leaves): what a kohya ``lora_te*_`` slice
    patches."""
    segs = ("SelfAttention.", "DenseReluDense.", "self_attn.", "mlp.")
    out = []
    for k, v in params.items():
        shape = tuple(v.shape)
        if (k.endswith(".weight") and len(shape) == 2
                and any(s in k for s in segs) and "relative_attention" not in k):
            out.append((k, int(shape[0]), int(shape[1])))
    return out


def kohya_lora_state_dict(targets, rank: int = 16, alpha: float = 16.0,
                          seed: int = 0, std: float = 0.03,
                          prefix: str = "lora_unet_",
                          dtype=torch.bfloat16) -> dict[str, torch.Tensor]:
    """A random kohya LoRA over ``targets`` ((weight key, R, K) triples):
    ``{prefix}{key stem with '.' → '_'}.lora_down.weight`` (rank, K),
    ``.lora_up.weight`` (R, rank) and ``.alpha``, factors N(0, std²) from a
    numpy seed, in ``dtype`` (CPU tensors, for ``_safetensors.save_file``).
    """
    rng = np.random.default_rng(seed)
    sd = {}
    for key, R, K in targets:
        base = prefix + key[: -len(".weight")].replace(".", "_")
        for name, shape in (("lora_down", (rank, K)), ("lora_up", (R, rank))):
            a = rng.standard_normal(shape, dtype=np.float32) * std
            sd[f"{base}.{name}.weight"] = torch.from_numpy(a).to(dtype)
        sd[f"{base}.alpha"] = torch.tensor(float(alpha))
    return sd


def flux_mixed_lora_state_dict(dims: TinyFluxDims, rank: int = 4,
                               seed: int = 0) -> dict[str, torch.Tensor]:
    """A random LoRA over every flux block linear mixing the patch types a
    user meets: kohya rank patches everywhere, except a LoCon mid block on
    every double block's ``img_attn.proj``, a LoHa (dense delta: the
    unfused path) on every single block's ``linear2`` and a GLoRA (old
    layout) on every double block's ``txt_mlp.0`` (the same kinds in every
    block, so the patched blocks still stack). float32 CPU tensors."""
    special = {".img_attn.proj.weight": "mid", ".linear2.weight": "loha",
               ".txt_mlp.0.weight": "glora"}

    def kind_of(key):
        return next((v for k, v in special.items() if key.endswith(k)),
                    None)

    targets = flux_lora_targets(dims)
    sd = kohya_lora_state_dict(
        [t for t in targets if kind_of(t[0]) in (None, "mid")],
        rank=rank, alpha=float(rank), seed=seed, dtype=torch.float32)
    rng = np.random.default_rng(seed + 1)

    def t(*shape, std):
        return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)
                                * std)

    for key, R, K in targets:
        base = "lora_unet_" + key[: -len(".weight")].replace(".", "_")
        kind = kind_of(key)
        if kind == "mid":
            sd[f"{base}.lora_mid.weight"] = t(rank, rank, std=0.3)
        elif kind == "loha":
            for w, shape in (("w1_a", (R, rank)), ("w1_b", (rank, K)),
                             ("w2_a", (R, rank)), ("w2_b", (rank, K))):
                sd[f"{base}.hada_{w}"] = t(*shape, std=0.1)
            sd[f"{base}.alpha"] = torch.tensor(float(rank))
        elif kind == "glora":
            for w, shape in (("a1", (rank, K)), ("a2", (K, rank)),
                             ("b1", (rank, K)), ("b2", (R, rank))):
                sd[f"{base}.{w}.weight"] = t(*shape, std=0.03)
            sd[f"{base}.alpha"] = torch.tensor(float(rank))
    return sd


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


def flux_shape_spec(dims: TinyFluxDims, guidance: bool = True):
    """(nonblock, groups) shape spec of ``flux_state_dict``'s keys — the
    expected-key source of the checkpoint validator
    (tools/validate_checkpoint.py). ``guidance=False`` drops the
    guidance_in embedder (flux-schnell)."""
    HID, CTX, VEC, INCH, MLP = (dims.hidden, dims.ctx, dims.vec,
                                dims.in_ch, dims.mlp)
    hd = HID // dims.heads
    nonblock = {
        "img_in.weight": (HID, INCH), "img_in.bias": (HID,),
        "txt_in.weight": (HID, CTX), "txt_in.bias": (HID,),
        "time_in.in_layer.weight": (HID, 256),
        "time_in.in_layer.bias": (HID,),
        "time_in.out_layer.weight": (HID, HID),
        "time_in.out_layer.bias": (HID,),
        "vector_in.in_layer.weight": (HID, VEC),
        "vector_in.in_layer.bias": (HID,),
        "vector_in.out_layer.weight": (HID, HID),
        "vector_in.out_layer.bias": (HID,),
        "final_layer.linear.weight": (INCH, HID),
        "final_layer.linear.bias": (INCH,),
        "final_layer.adaLN_modulation.1.weight": (2 * HID, HID),
        "final_layer.adaLN_modulation.1.bias": (2 * HID,),
    }
    if guidance:
        nonblock.update({
            "guidance_in.in_layer.weight": (HID, 256),
            "guidance_in.in_layer.bias": (HID,),
            "guidance_in.out_layer.weight": (HID, HID),
            "guidance_in.out_layer.bias": (HID,),
        })
    double = {}
    for s in ("img", "txt"):
        double.update({
            f"{s}_mod.lin.weight": (6 * HID, HID),
            f"{s}_mod.lin.bias": (6 * HID,),
            f"{s}_attn.qkv.weight": (3 * HID, HID),
            f"{s}_attn.qkv.bias": (3 * HID,),
            f"{s}_attn.norm.query_norm.scale": (hd,),
            f"{s}_attn.norm.key_norm.scale": (hd,),
            f"{s}_attn.proj.weight": (HID, HID),
            f"{s}_attn.proj.bias": (HID,),
            f"{s}_mlp.0.weight": (MLP, HID),
            f"{s}_mlp.0.bias": (MLP,),
            f"{s}_mlp.2.weight": (HID, MLP),
            f"{s}_mlp.2.bias": (HID,),
        })
    single = {
        "linear1.weight": (3 * HID + MLP, HID),
        "linear1.bias": (3 * HID + MLP,),
        "linear2.weight": (HID, HID + MLP),
        "linear2.bias": (HID,),
        "modulation.lin.weight": (3 * HID, HID),
        "modulation.lin.bias": (3 * HID,),
        "norm.query_norm.scale": (hd,),
        "norm.key_norm.scale": (hd,),
    }
    return nonblock, {"double_blocks": (dims.depth_double, double),
                      "single_blocks": (dims.depth_single, single)}


def flux_block_qtype(key: str, arr: np.ndarray, qtype):
    """The quantization policy of a converted flux file: block weights
    quantize, the embedders, norms and final layer stay float (None)."""
    if (arr.ndim == 2 and arr.shape[1] % 256 == 0 and "norm" not in key
            and "_in." not in key
            and not key.startswith(("final_layer.", "img_in", "txt_in"))):
        return qtype
    return None


def write_flux_gguf(sd: dict, path: str, qtype_of) -> None:
    """Write ``sd`` as a flux GGUF (``write_gguf`` with arch "flux")."""
    write_gguf(sd, path, qtype_of, "flux")


def write_gguf(sd: dict, path: str, qtype_of, arch: str) -> None:
    """Write ``sd`` as a GGUF of architecture ``arch`` with the
    ``model.diffusion_model.`` prefix; ``qtype_of(key, array)`` picks each
    tensor's format (None = stored as float). A float tensor of more than
    four dims (a 3-D conv's kernel) is stored 4-D with its shape in
    ``comfy.gguf.orig_shape`` metadata, as the reference's
    ``fix_5d_tensors`` flow stores it."""
    from ..gguf.constants import GGUFValueType
    from ..gguf.writer import GGUFWriter

    w = GGUFWriter(arch)
    pfx = "model.diffusion_model."
    for k, v in sd.items():
        qtype = qtype_of(k, v)
        if qtype is None and v.ndim > 4:
            w.add_tensor(pfx + k, np.ascontiguousarray(
                v.reshape(-1, *v.shape[-3:]), np.float32))
            w.add_array(f"comfy.gguf.orig_shape.{pfx}{k}",
                        [int(d) for d in v.shape], GGUFValueType.INT32)
        elif qtype is None:
            w.add_tensor(pfx + k, np.ascontiguousarray(v, np.float32))
        else:
            w.add_tensor(pfx + k, codecs.quantize(v, qtype), raw_dtype=qtype,
                         raw_shape=v.shape)
    w.write_to_file(str(path))


# ---------------------------------------------------------------------------
# SD3 / SD3.5 (MMDiT)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class TinySD3Dims:
    hidden: int = 64
    heads: int = 2
    depth: int = 3
    ctx_dim: int = 32
    pooled: int = 16
    in_ch: int = 16
    pos_max: int = 8
    qk_norm: bool = True
    dual_prefix: int = 0  # sd3.5-medium: the first N blocks carry attn2

    def config(self):
        from .sd3 import SD3Config

        return SD3Config(
            hidden=self.hidden, depth=self.depth, n_heads=self.heads,
            in_channels=self.in_ch, context_dim=self.ctx_dim,
            pooled_dim=self.pooled, pos_embed_max=self.pos_max,
            qk_norm=self.qk_norm,
            dual_attn_layers=tuple(range(self.dual_prefix)))


# sd3.5-large published dims (8B params): hidden 2432, 38 heads of 64, 38
# joint blocks
SD35_LARGE_DIMS = TinySD3Dims(
    hidden=2432, heads=38, depth=38, ctx_dim=4096, pooled=2048,
    in_ch=16, pos_max=192, qk_norm=True)

# sd3.5-medium published dims (2.5B, MMDiT-X): hidden 1536, 24 heads of 64,
# 24 blocks with dual x-stream attention in the first 13, pos grid 384
SD35_MEDIUM_DIMS = TinySD3Dims(
    hidden=1536, heads=24, depth=24, ctx_dim=4096, pooled=2048,
    in_ch=16, pos_max=384, qk_norm=True, dual_prefix=13)


def _sd3_nonblock(dims: TinySD3Dims, dense) -> dict:
    """Non-block keys (the reference quantizer excludes all of these, so
    they stay dense)."""
    HID, P, C = dims.hidden, 2, dims.in_ch
    return {
        "x_embedder.proj.weight": dense(HID, C, P, P),
        "x_embedder.proj.bias": dense(HID),
        "pos_embed": dense(1, dims.pos_max * dims.pos_max, HID),
        "t_embedder.mlp.0.weight": dense(HID, 256),
        "t_embedder.mlp.0.bias": dense(HID),
        "t_embedder.mlp.2.weight": dense(HID, HID),
        "t_embedder.mlp.2.bias": dense(HID),
        "y_embedder.mlp.0.weight": dense(HID, dims.pooled),
        "y_embedder.mlp.0.bias": dense(HID),
        "y_embedder.mlp.2.weight": dense(HID, HID),
        "y_embedder.mlp.2.bias": dense(HID),
        "context_embedder.weight": dense(HID, dims.ctx_dim),
        "context_embedder.bias": dense(HID),
        "final_layer.linear.weight": dense(P * P * C, HID),
        "final_layer.linear.bias": dense(P * P * C),
        "final_layer.adaLN_modulation.1.weight": dense(2 * HID, HID),
        "final_layer.adaLN_modulation.1.bias": dense(2 * HID),
    }


def _sd3_block_leaves(dims: TinySD3Dims, packed, dense, pre_only: bool,
                      dual: bool = False) -> dict:
    """One joint block's relative-keyed leaves. ``dual``: an sd3.5-medium
    MMDiT-X x_block with a second self-attention (9-chunk adaLN + attn2
    projections)."""
    HID = dims.hidden
    hd = HID // dims.heads
    w = {}
    for blk in ("context_block", "x_block"):
        po = pre_only and blk == "context_block"
        du = dual and blk == "x_block"
        w[f"{blk}.attn.qkv.weight"] = packed(3 * HID, HID)
        w[f"{blk}.attn.qkv.bias"] = dense(3 * HID)
        if dims.qk_norm:
            w[f"{blk}.attn.ln_q.weight"] = dense(hd)
            w[f"{blk}.attn.ln_k.weight"] = dense(hd)
        n_mod = 2 if po else (9 if du else 6)
        w[f"{blk}.adaLN_modulation.1.weight"] = packed(n_mod * HID, HID)
        w[f"{blk}.adaLN_modulation.1.bias"] = dense(n_mod * HID)
        if du:
            w[f"{blk}.attn2.qkv.weight"] = packed(3 * HID, HID)
            w[f"{blk}.attn2.qkv.bias"] = dense(3 * HID)
            if dims.qk_norm:
                w[f"{blk}.attn2.ln_q.weight"] = dense(hd)
                w[f"{blk}.attn2.ln_k.weight"] = dense(hd)
            w[f"{blk}.attn2.proj.weight"] = packed(HID, HID)
            w[f"{blk}.attn2.proj.bias"] = dense(HID)
        if not po:
            w[f"{blk}.attn.proj.weight"] = packed(HID, HID)
            w[f"{blk}.attn.proj.bias"] = dense(HID)
            w[f"{blk}.mlp.fc1.weight"] = packed(4 * HID, HID)
            w[f"{blk}.mlp.fc1.bias"] = dense(4 * HID)
            w[f"{blk}.mlp.fc2.weight"] = packed(HID, 4 * HID)
            w[f"{blk}.mlp.fc2.bias"] = dense(HID)
    return w


def sd3_flat_state_dict(dims: TinySD3Dims, seed: int = 0) -> dict:
    """Flat float32 numpy sd3 state dict (pre-only final block, real key
    layout) — the same numbers as the reference package's helper of this
    name."""
    rng = np.random.default_rng(seed)

    def dense(*shape):
        return (rng.standard_normal(shape) * 0.02).astype(np.float32)

    sd = dict(_sd3_nonblock(dims, dense))
    for i in range(dims.depth):
        blk = _sd3_block_leaves(dims, packed=dense, dense=dense,
                                pre_only=(i == dims.depth - 1),
                                dual=(i < dims.dual_prefix))
        sd.update({f"joint_blocks.{i}.{k}": v for k, v in blk.items()})
    return sd


def sd3_shape_spec(dims: TinySD3Dims) -> dict:
    """Flat expected {key: shape} for sd3 (the final block is pre-only, so
    the per-block key sets differ — a flat dict instead of the homogeneous
    (nonblock, groups) format). Single-attention blocks only: the
    validator checks an sd3.5-medium (dual-attention) file structurally."""

    def shape_of(*s):
        return tuple(s)

    out = dict(_sd3_nonblock(dims, shape_of))
    for i in range(dims.depth):
        blk = _sd3_block_leaves(dims, packed=shape_of, dense=shape_of,
                                pre_only=(i == dims.depth - 1))
        out.update({f"joint_blocks.{i}.{k}": v for k, v in blk.items()})
    return out


def sd3_block_qtype(key: str, arr: np.ndarray, qtype):
    """The quantization policy of a converted sd3 file: the block linears
    quantize, the embedders, norms, pos_embed and final layer stay float
    (None)."""
    if (arr.ndim == 2 and key.startswith("joint_blocks.")
            and arr.shape[1] % 256 == 0 and ".ln_" not in key):
        return qtype
    return None


def sd3_random_quant_params(dims: TinySD3Dims, qtype=Q.Q4_K, seed: int = 0,
                            device="cuda") -> dict:
    """Flat (``joint_blocks.{i}.``-keyed) sd3 params with random packed
    block weights at the real planar layout, made on ``device``; the final
    block is pre-only like real checkpoints."""
    device = resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    dense = _dense_maker(gen, device)

    def packed(r, k):
        return random_planar(qtype, (r, k), gen, device=device)

    params = _sd3_nonblock(dims, dense)
    for i in range(dims.depth):
        blk = _sd3_block_leaves(dims, packed, dense,
                                pre_only=(i == dims.depth - 1),
                                dual=(i < dims.dual_prefix))
        params.update({f"joint_blocks.{i}.{k}": v for k, v in blk.items()})
    return params


def sd3_random_stacked_params(dims: TinySD3Dims, qtype=Q.Q4_K,
                              seed: int = 0, device="cuda") -> dict:
    """Full-depth sd3 params in stack_sd3_params layout, the packed weights
    generated directly stacked on ``device`` (no per-block copies)."""
    device = resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    dense = _dense_maker(gen, device)
    n_dual = dims.dual_prefix
    n = dims.depth - 1 - n_dual

    def stacked(depth):
        return dict(
            packed=lambda r, k: random_planar(qtype, (r, k), gen,
                                              device=device, stack=depth),
            dense=lambda *s: dense(depth, *s))

    params = _sd3_nonblock(dims, dense)
    if n_dual:  # sd3.5-medium MMDiT-X prefix group
        params["joint_blocks_dual"] = _sd3_block_leaves(
            dims, **stacked(n_dual), pre_only=False, dual=True)
    params["joint_blocks"] = _sd3_block_leaves(dims, **stacked(n),
                                               pre_only=False)
    params["joint_blocks_last"] = _sd3_block_leaves(
        dims, packed=lambda r, k: random_planar(qtype, (r, k), gen,
                                                device=device),
        dense=dense, pre_only=True)
    return params


def sd3_example_inputs(dims: TinySD3Dims, batch: int = 1, h_lat: int = 16,
                       w_lat: int = 16, ctx_len: int = 16, seed: int = 1,
                       dtype=torch.bfloat16, device="cuda"):
    """(latent, context, pooled, t) matching sd3.forward, made from a numpy
    seed (the same numbers as the reference helper)."""
    device = resolve_device(device)
    rng = np.random.default_rng(seed)

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float32)).to(device=device,
                                                             dtype=dtype)

    latent = t(rng.standard_normal((batch, h_lat, w_lat, dims.in_ch)))
    context = t(rng.standard_normal((batch, ctx_len, dims.ctx_dim)))
    pooled = t(rng.standard_normal((batch, dims.pooled)))
    ts = torch.full((batch,), 0.7, dtype=torch.float32, device=device)
    return latent, context, pooled, ts


# ---------------------------------------------------------------------------
# SD1 / SDXL sgm UNet (models/unet.py key schema)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class SDXLDims:
    """sgm UNet geometry (models/unet.py). Published SDXL: mc 320,
    channel_mult (1, 2, 4), 2 res blocks, transformer depth (0, 2, 10),
    ctx 2048, adm 2816 — about 2.6B params."""

    model_channels: int = 32
    channel_mult: tuple[int, ...] = (1, 2, 4)
    num_res_blocks: int = 2
    depths: tuple[int, ...] = (0, 1, 1)  # transformer depth per level
    ctx: int = 64
    adm: int | None = 64  # None = SD1 (no label_emb, fixed 8 heads)
    in_ch: int = 4


SDXL_DIMS = SDXLDims(model_channels=320, depths=(0, 2, 10), ctx=2048,
                     adm=2816)
# SD1.x: 860M, attention (depth 1) at every level but the last, CLIP-L ctx
# 768, no pooled vector; 8 heads, so head dims 40, 80 and 160
SD1_DIMS = SDXLDims(model_channels=320, channel_mult=(1, 2, 4, 4),
                    depths=(1, 1, 1, 0), ctx=768, adm=None)


def _unet_shapes(d: SDXLDims) -> dict[str, tuple]:
    """Every tensor of an sgm UNet of this geometry, in the reference
    builder's order: linears (R, K), convs (O, I, k, k), norms and biases
    (C,)."""
    mc, emb = d.model_channels, 4 * d.model_channels
    out: dict[str, tuple] = {}

    def conv(name, o, i, k=3):
        out[f"{name}.weight"] = (o, i, k, k)
        out[f"{name}.bias"] = (o,)

    def lin(name, o, i, bias=True):
        out[f"{name}.weight"] = (o, i)
        if bias:
            out[f"{name}.bias"] = (o,)

    def norm(name, c):
        out[f"{name}.weight"] = (c,)
        out[f"{name}.bias"] = (c,)

    def resblock(p, cin, cout):
        norm(f"{p}.in_layers.0", cin)
        conv(f"{p}.in_layers.2", cout, cin)
        lin(f"{p}.emb_layers.1", cout, emb)
        norm(f"{p}.out_layers.0", cout)
        conv(f"{p}.out_layers.3", cout, cout)
        if cin != cout:
            conv(f"{p}.skip_connection", cout, cin, k=1)

    def transformer(p, c, depth):
        norm(f"{p}.norm", c)
        # SD1 stores proj_in/out as 1x1 convs, SDXL as linears
        if d.adm is None:
            conv(f"{p}.proj_in", c, c, k=1)
        else:
            lin(f"{p}.proj_in", c, c)
        for i in range(depth):
            b = f"{p}.transformer_blocks.{i}"
            for n in ("norm1", "norm2", "norm3"):
                norm(f"{b}.{n}", c)
            lin(f"{b}.attn1.to_q", c, c, bias=False)
            lin(f"{b}.attn1.to_k", c, c, bias=False)
            lin(f"{b}.attn1.to_v", c, c, bias=False)
            lin(f"{b}.attn1.to_out.0", c, c)
            lin(f"{b}.attn2.to_q", c, c, bias=False)
            lin(f"{b}.attn2.to_k", c, d.ctx, bias=False)
            lin(f"{b}.attn2.to_v", c, d.ctx, bias=False)
            lin(f"{b}.attn2.to_out.0", c, c)
            lin(f"{b}.ff.net.0.proj", 8 * c, c)
            lin(f"{b}.ff.net.2", c, 4 * c)
        if d.adm is None:
            conv(f"{p}.proj_out", c, c, k=1)
        else:
            lin(f"{p}.proj_out", c, c)

    lin("time_embed.0", emb, mc)
    lin("time_embed.2", emb, emb)
    if d.adm is not None:
        lin("label_emb.0.0", emb, d.adm)
        lin("label_emb.0.2", emb, emb)

    chans = [mc * m for m in d.channel_mult]
    conv("input_blocks.0.0", mc, d.in_ch)
    skips = [mc]
    ch = mc
    bi = 1
    for lvl, c in enumerate(chans):
        for _ in range(d.num_res_blocks):
            resblock(f"input_blocks.{bi}.0", ch, c)
            ch = c
            if d.depths[lvl]:
                transformer(f"input_blocks.{bi}.1", c, d.depths[lvl])
            skips.append(ch)
            bi += 1
        if lvl < len(chans) - 1:
            conv(f"input_blocks.{bi}.0.op", ch, ch)
            skips.append(ch)
            bi += 1

    resblock("middle_block.0", ch, ch)
    transformer("middle_block.1", ch, d.depths[-1] or 1)
    resblock("middle_block.2", ch, ch)

    bo = 0
    for lvl in reversed(range(len(chans))):
        c = chans[lvl]
        for j in range(d.num_res_blocks + 1):
            resblock(f"output_blocks.{bo}.0", ch + skips.pop(), c)
            ch = c
            k = 1
            if d.depths[lvl]:
                transformer(f"output_blocks.{bo}.{k}", c, d.depths[lvl])
                k += 1
            if lvl > 0 and j == d.num_res_blocks:
                conv(f"output_blocks.{bo}.{k}.conv", c, c)
            bo += 1

    norm("out.0", mc)
    conv("out.2", d.in_ch, mc)
    return out


def _unet_embedder(key: str) -> bool:
    return key.startswith(("time_embed.", "label_emb."))


def _unet_norm_gain(key: str) -> bool:
    """A GroupNorm or LayerNorm gain: the transformers' ``norm*``, the
    ResBlocks' ``in_layers.0`` / ``out_layers.0`` and the output ``out.0``."""
    return key.endswith(".weight") and (
        "norm" in key or key == "out.0.weight"
        or key.endswith(("in_layers.0.weight", "out_layers.0.weight")))


def unet_state_dict(dims: SDXLDims, seed: int = 0) -> dict[str, np.ndarray]:
    """Random sgm UNet state dict (numpy float32): weights N(0, 1/fan-in)
    (as ``sdxl_random_params`` scales its convs, so activations stay
    bounded at any width), unit norm gains, zero biases."""
    rng = np.random.default_rng(seed)
    out = {}
    for k, shape in _unet_shapes(dims).items():
        if len(shape) > 1:
            fan_in = int(np.prod(shape[1:]))
            out[k] = (rng.standard_normal(shape) * fan_in ** -0.5).astype(
                np.float32)
        elif _unet_norm_gain(k):
            out[k] = np.ones(shape, np.float32)
        else:
            out[k] = np.zeros(shape, np.float32)
    return out


def unet_block_qtype(key: str, arr: np.ndarray, qtype):
    """The quantization policy of a converted UNet file (the reference
    quantizer's 2-D-only rule): the linears quantize where the format's
    block divides K (Q8_0 where ``qtype``'s 256-element block does not), the
    embedders, convs and norms stay float (None)."""
    if arr.ndim != 2 or _unet_embedder(key):
        return None
    if arr.shape[1] % 256 == 0:
        return qtype
    return Q.Q8_0 if arr.shape[1] % 32 == 0 else None


def sdxl_random_params(d: SDXLDims = SDXL_DIMS, qtype=Q.Q4_K, seed: int = 0,
                       device="cuda") -> dict:
    """Random UNet params at ``d``'s geometry, made on ``device``: the 2-D
    weights packed planar (the quantizer's 2-D-only rule), the embedders,
    convs and norms dense (bf16 weights, f32 norms and biases) — the mix a
    real quantized SDXL or SD1 GGUF loads into. Conv and linear weights are
    scaled by fan-in so activations stay bounded at full depth."""
    device = resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    out = {}
    for k, shape in _unet_shapes(d).items():
        if len(shape) == 2 and not _unet_embedder(k):
            out[k] = random_planar(qtype, shape, gen, device=device,
                                   scale=0.02 * shape[1] ** -0.5)
        elif len(shape) > 1:
            fan_in = int(np.prod(shape[1:]))
            out[k] = (torch.randn(shape, generator=gen, device=device)
                      * fan_in ** -0.5).to(torch.bfloat16)
        elif _unet_norm_gain(k):
            out[k] = torch.ones(shape, device=device)
        else:
            out[k] = torch.zeros(shape, device=device)
    return out


# ---------------------------------------------------------------------------
# spec-driven trees: AuraFlow and Lumina 2
# ---------------------------------------------------------------------------

def published_qtype(arch: str, key: str, shape, qtype):
    """The format ``key`` has in a published ``arch`` GGUF quantized to
    ``qtype``: None (stored as float) for the arch's no-quant and
    high-precision keys (``archs.py``), for norms, for anything that is not
    a 2-D weight and for rows the format's blocks do not tile; ``qtype``
    otherwise."""
    spec = get_arch_spec(arch)
    if (len(shape) != 2 or not key.endswith(".weight") or "norm" in key
            or shape[1] % GGML_QUANT_SIZES[qtype][0]):
        return None
    if spec is not None and (
            any(k in key for k in spec.keys_noquant + spec.keys_hiprec)
            or key in spec.keys_noquant_exact):
        return None
    return qtype


def random_flat_sd_from_spec(nonblock: dict, groups: dict,
                             seed: int = 0) -> dict:
    """Flat float32 numpy state dict from a shape spec: the nonblock keys
    plus ``{out_key}.{i}.{suffix}`` for each group. Norm gains ("norm" in
    the key, 1-D) center at 1. The same numbers as the reference package's
    helper of this name."""
    rng = np.random.default_rng(seed)

    def t(shape, key):
        w = (rng.standard_normal(shape) * 0.02).astype(np.float32)
        if "norm" in key and len(shape) == 1:
            w = w + 1.0
        return w

    sd = {k: t(tuple(s), k) for k, s in nonblock.items()}
    for out_key, (depth, suffixes) in groups.items():
        for i in range(depth):
            for suf, s in suffixes.items():
                sd[f"{out_key}.{i}.{suf}"] = t(tuple(s), suf)
    return sd


def random_stacked_from_spec(nonblock: dict, groups: dict, arch: str,
                             qtype=Q.Q4_K, seed: int = 0,
                             device="cuda") -> dict:
    """A full-depth stacked tree (``flux.stack_block_groups`` layout) made
    on ``device`` from a seed. A 2-D weight that a published ``arch`` GGUF
    quantizes (``published_qtype``) and whose dims are both >= 256 is a
    random PlanarQuant of ``qtype`` at ``random_planar``'s scale (the
    reference package's helper of this name's: a Q4_K weight of standard
    deviation ~0.087, as every other seed-made tree here), a group's
    generated directly at depth (no per-block copies); everything else is
    dense: the arch's no-quant keys (positional tables, register tokens,
    embedders, final layers, refiners) as in a published file. Norm gains
    center at 1."""
    device = resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    dense = _dense_maker(gen, device)

    def leaf(key, shape, depth=None):
        lead = () if depth is None else (depth,)
        if (published_qtype(arch, key, shape, qtype) is not None
                and min(shape) >= 256):
            return random_planar(qtype, shape, gen, device=device,
                                 stack=depth)
        w = dense(*lead, *shape)
        return w + 1 if "norm" in key and len(shape) == 1 else w

    params = {k: leaf(k, tuple(s)) for k, s in nonblock.items()}
    for out_key, (depth, suffixes) in groups.items():
        params[out_key] = {suf: leaf(f"{out_key}.0.{suf}", tuple(s), depth)
                           for suf, s in suffixes.items()}
    return params


def write_spec_gguf(sd: dict, path: str, arch: str, qtype) -> None:
    """Write a flat ``arch`` state dict as a GGUF quantized the way a
    published file of ``qtype`` is (``published_qtype``)."""
    write_gguf(sd, path, lambda k, v: published_qtype(arch, k, v.shape,
                                                      qtype), arch)


@dataclasses.dataclass(frozen=True)
class AuraDims:
    """AuraFlow dims (models/aura.py AuraConfig fields)."""
    hidden: int = 256
    depth_double: int = 2
    depth_single: int = 2
    mlp: int = 512
    in_ch: int = 4
    cond_dim: int = 64
    n_register_tokens: int = 3
    max_tokens: int = 64  # positional_encoding length

    def config(self):
        from .aura import AuraConfig

        return AuraConfig(hidden=self.hidden, n_heads=self.hidden // 256,
                          depth_double=self.depth_double,
                          depth_single=self.depth_single,
                          in_channels=self.in_ch, cond_dim=self.cond_dim,
                          n_register_tokens=self.n_register_tokens)


# AuraFlow v0.3 (6.8B): hidden 3072, 12 heads of 256, 4 double + 32 single
# layers, gated mlp 8192, Pile-T5-XL cond states (2048), 4-channel latents,
# 8 register tokens, a positional table of 9216 tokens (1536² images)
AURA_V03_DIMS = AuraDims(hidden=3072, depth_double=4, depth_single=32,
                         mlp=8192, in_ch=4, cond_dim=2048,
                         n_register_tokens=8, max_tokens=9216)


def aura_shape_spec(d: AuraDims):
    """(nonblock, groups) shape spec of models/aura.py's keys."""
    H, M, C = d.hidden, d.mlp, d.in_ch
    nonblock = {
        "init_x_linear.weight": (H, C * 4),
        "init_x_linear.bias": (H,),
        "positional_encoding": (1, d.max_tokens, H),
        "register_tokens": (1, d.n_register_tokens, H),
        "cond_seq_linear.weight": (H, d.cond_dim),
        "t_embedder.mlp.0.weight": (H, 256),
        "t_embedder.mlp.0.bias": (H,),
        "t_embedder.mlp.2.weight": (H, H),
        "t_embedder.mlp.2.bias": (H,),
        "modF.1.weight": (2 * H, H),
        "modF.1.bias": (2 * H,),
        "final_linear.weight": (C * 4, H),
    }

    def mlp(prefix):
        return {f"{prefix}.c_fc1.weight": (M, H),
                f"{prefix}.c_fc2.weight": (M, H),
                f"{prefix}.c_proj.weight": (H, M)}

    double = {"modC.1.weight": (6 * H, H), "modX.1.weight": (6 * H, H)}
    for w in ("w1q", "w1k", "w1v", "w1o", "w2q", "w2k", "w2v", "w2o"):
        double[f"attn.{w}.weight"] = (H, H)
    double.update(mlp("mlpC"))
    double.update(mlp("mlpX"))
    single = {"modCX.1.weight": (6 * H, H)}
    for w in ("w1q", "w1k", "w1v", "w1o"):
        single[f"attn.{w}.weight"] = (H, H)
    single.update(mlp("mlp"))
    return nonblock, {"double_layers": (d.depth_double, double),
                      "single_layers": (d.depth_single, single)}


def aura_random_stacked_params(d: AuraDims, qtype=Q.Q4_K, seed: int = 0,
                               device="cuda") -> dict:
    return random_stacked_from_spec(*aura_shape_spec(d), "aura",
                                    qtype=qtype, seed=seed, device=device)


@dataclasses.dataclass(frozen=True)
class Lumina2Dims:
    """Lumina Image 2.0 NextDiT dims (models/lumina2.py fields)."""
    dim: int = 120
    n_heads: int = 2
    n_layers: int = 2
    n_refiner: int = 1
    n_context_refiner: int = 1
    ffn: int = 240
    in_ch: int = 4
    cap_dim: int = 64

    def config(self):
        from .lumina2 import Lumina2Config

        hd = self.dim // self.n_heads
        third = 2 * (hd // 6)
        return Lumina2Config(dim=self.dim, n_layers=self.n_layers,
                             n_refiner=self.n_refiner, n_heads=self.n_heads,
                             in_channels=self.in_ch, cap_dim=self.cap_dim,
                             axes_dim=(hd - 2 * third, third, third))


# Lumina-Image-2.0 (2.6B NextDiT): dim 2304, 24 heads of 96, 26 layers + 2
# noise-refiner + 2 context-refiner blocks, SwiGLU ffn 6144, Gemma-2-2b
# caption states (2304), 16-channel latents
LUMINA2_DIMS = Lumina2Dims(dim=2304, n_heads=24, n_layers=26, n_refiner=2,
                           n_context_refiner=2, ffn=6144, in_ch=16,
                           cap_dim=2304)


def _lumina2_block_spec(d: Lumina2Dims, adaln: bool) -> dict:
    D, F = d.dim, d.ffn
    hd = d.dim // d.n_heads
    s = {
        "attention.qkv.weight": (3 * D, D),
        "attention.out.weight": (D, D),
        "attention.q_norm.weight": (hd,),
        "attention.k_norm.weight": (hd,),
        "attention_norm1.weight": (D,),
        "attention_norm2.weight": (D,),
        "ffn_norm1.weight": (D,),
        "ffn_norm2.weight": (D,),
        "feed_forward.w1.weight": (F, D),
        "feed_forward.w2.weight": (D, F),
        "feed_forward.w3.weight": (F, D),
    }
    if adaln:
        s["adaLN_modulation.1.weight"] = (4 * D, D)
        s["adaLN_modulation.1.bias"] = (4 * D,)
    return s


def lumina2_shape_spec(d: Lumina2Dims):
    """(nonblock, groups) shape spec of models/lumina2.py's keys; the
    noise and context refiners are nonblock keys (flat, and on the arch's
    no-quant list)."""
    D, C = d.dim, d.in_ch
    nonblock = {
        "x_embedder.weight": (D, C * 4),
        "x_embedder.bias": (D,),
        "cap_embedder.0.weight": (d.cap_dim,),
        "cap_embedder.1.weight": (D, d.cap_dim),
        "cap_embedder.1.bias": (D,),
        "t_embedder.mlp.0.weight": (D, 256),
        "t_embedder.mlp.0.bias": (D,),
        "t_embedder.mlp.2.weight": (D, D),
        "t_embedder.mlp.2.bias": (D,),
        "norm_final.weight": (D,),
        "final_layer.linear.weight": (C * 4, D),
        "final_layer.linear.bias": (C * 4,),
        "final_layer.adaLN_modulation.1.weight": (2 * D, D),
        "final_layer.adaLN_modulation.1.bias": (2 * D,),
    }
    for i in range(d.n_refiner):
        for suf, s in _lumina2_block_spec(d, adaln=True).items():
            nonblock[f"noise_refiner.{i}.{suf}"] = s
    for i in range(d.n_context_refiner):
        for suf, s in _lumina2_block_spec(d, adaln=False).items():
            nonblock[f"context_refiner.{i}.{suf}"] = s
    return nonblock, {"layers": (d.n_layers,
                                 _lumina2_block_spec(d, adaln=True))}


def lumina2_random_stacked_params(d: Lumina2Dims, qtype=Q.Q4_K,
                                  seed: int = 0, device="cuda") -> dict:
    return random_stacked_from_spec(*lumina2_shape_spec(d), "lumina2",
                                    qtype=qtype, seed=seed, device=device)


@dataclasses.dataclass(frozen=True)
class QwenImageDims:
    """Qwen-Image dims (models/qwen_image.py QwenImageConfig fields)."""
    hidden: int = 128
    n_heads: int = 2
    n_layers: int = 2
    in_ch: int = 32
    context_dim: int = 96

    def config(self):
        from .qwen_image import QwenImageConfig

        hd = self.hidden // self.n_heads
        third = 2 * ((hd - hd // 8) // 4)
        return QwenImageConfig(hidden=self.hidden, n_layers=self.n_layers,
                               n_heads=self.n_heads, in_channels=self.in_ch,
                               context_dim=self.context_dim,
                               axes_dim=(hd - 2 * third, third, third))


# Qwen-Image (20B MMDiT): hidden 3072, 24 heads of 128, 60 joint blocks,
# Qwen2.5-VL-7B text states (3584), 64 input features (16-channel latents,
# 2×2 patches)
QWEN_IMAGE_20B_DIMS = QwenImageDims(hidden=3072, n_heads=24, n_layers=60,
                                    in_ch=64, context_dim=3584)


def qwen_image_shape_spec(d: QwenImageDims):
    """(nonblock, groups) shape spec of models/qwen_image.py's keys."""
    H, T, I = d.hidden, d.context_dim, d.in_ch
    hd = H // d.n_heads
    nonblock = {
        "img_in.weight": (H, I), "img_in.bias": (H,),
        "txt_in.weight": (H, T), "txt_in.bias": (H,),
        "txt_norm.weight": (T,),
        "time_text_embed.timestep_embedder.linear_1.weight": (H, 256),
        "time_text_embed.timestep_embedder.linear_1.bias": (H,),
        "time_text_embed.timestep_embedder.linear_2.weight": (H, H),
        "time_text_embed.timestep_embedder.linear_2.bias": (H,),
        "norm_out.linear.weight": (2 * H, H),
        "norm_out.linear.bias": (2 * H,),
        "proj_out.weight": (I, H), "proj_out.bias": (I,),
    }
    block = {
        "img_mod.1.weight": (6 * H, H), "img_mod.1.bias": (6 * H,),
        "txt_mod.1.weight": (6 * H, H), "txt_mod.1.bias": (6 * H,),
        "attn.to_out.0.weight": (H, H), "attn.to_out.0.bias": (H,),
        "attn.to_add_out.weight": (H, H), "attn.to_add_out.bias": (H,),
    }
    for n in ("to_q", "to_k", "to_v", "add_q_proj", "add_k_proj",
              "add_v_proj"):
        block[f"attn.{n}.weight"] = (H, H)
        block[f"attn.{n}.bias"] = (H,)
    for n in ("norm_q", "norm_k", "norm_added_q", "norm_added_k"):
        block[f"attn.{n}.weight"] = (hd,)
    for st in ("img", "txt"):
        block[f"{st}_mlp.net.0.proj.weight"] = (4 * H, H)
        block[f"{st}_mlp.net.0.proj.bias"] = (4 * H,)
        block[f"{st}_mlp.net.2.weight"] = (H, 4 * H)
        block[f"{st}_mlp.net.2.bias"] = (H,)
    return nonblock, {"transformer_blocks": (d.n_layers, block)}


def qwen_image_random_stacked_params(d: QwenImageDims, qtype=Q.Q4_K,
                                     seed: int = 0, device="cuda") -> dict:
    return random_stacked_from_spec(*qwen_image_shape_spec(d), "qwen_image",
                                    qtype=qtype, seed=seed, device=device)


@dataclasses.dataclass(frozen=True)
class TinyHiDreamDims:
    """HiDream-I1 dims (models/hidream.py HiDreamConfig fields)."""
    hidden: int = 128
    heads: int = 2
    depth_double: int = 2
    depth_single: int = 2
    ffn: int = 256
    n_experts: int = 2
    top_k: int = 1
    t5_dim: int = 64
    llama_dim: int = 96
    pooled: int = 48
    in_ch: int = 16
    patch: int = 2

    def config(self):
        from .hidream import HiDreamConfig

        hd = self.hidden // self.heads
        return HiDreamConfig(
            hidden=self.hidden, n_heads=self.heads,
            depth_double=self.depth_double, depth_single=self.depth_single,
            in_channels=self.in_ch, patch_size=self.patch,
            n_experts=self.n_experts, top_k=self.top_k,
            axes_dim=(hd // 2, hd // 4, hd // 4))


# HiDream-I1 (17B): hidden 2560, 20 heads of 128, 16 double + 32 single
# blocks, SwiGLU FFN 6912, 4 routed experts (top-2) + the shared one, T5-xxl
# and Llama-3.1-8B states (4096), CLIP-L ⊕ CLIP-G pooled (2048)
HIDREAM_I1_DIMS = TinyHiDreamDims(
    hidden=2560, heads=20, depth_double=16, depth_single=32, ffn=6912,
    n_experts=4, top_k=2, t5_dim=4096, llama_dim=4096, pooled=2048)


def hidream_shape_spec(d: TinyHiDreamDims, experts: bool = True):
    """(nonblock, groups) shape spec of models/hidream.py's flat keys (the
    experts per expert, ``{p}.experts.{e}.w*``); ``experts=False`` leaves
    the routed experts out."""
    H, F, E = d.hidden, d.ffn, d.n_experts
    hd = H // d.heads
    C4 = d.in_ch * d.patch ** 2
    nonblock = {
        "x_embedder.proj.weight": (H, C4), "x_embedder.proj.bias": (H,),
        "t_embedder.mlp.0.weight": (H, 256), "t_embedder.mlp.0.bias": (H,),
        "t_embedder.mlp.2.weight": (H, H), "t_embedder.mlp.2.bias": (H,),
        "p_embedder.mlp.0.weight": (H, d.pooled),
        "p_embedder.mlp.0.bias": (H,),
        "p_embedder.mlp.2.weight": (H, H), "p_embedder.mlp.2.bias": (H,),
        # the published order: 0..N-2 take the llama states, the last T5
        "caption_projection.0.linear.weight": (H, d.llama_dim),
        "caption_projection.1.linear.weight": (H, d.t5_dim),
        "final_layer.linear.weight": (C4, H),
        "final_layer.linear.bias": (C4,),
        "final_layer.adaLN_modulation.1.weight": (2 * H, H),
        "final_layer.adaLN_modulation.1.bias": (2 * H,),
    }

    def swiglu(prefix):
        return {f"{prefix}.w1.weight": (F, H), f"{prefix}.w2.weight": (H, F),
                f"{prefix}.w3.weight": (F, H)}

    def moe(prefix):
        s = {f"{prefix}.gate.weight": (E, H)}
        s.update(swiglu(f"{prefix}.shared_experts"))
        for e in range(E if experts else 0):
            s.update(swiglu(f"{prefix}.experts.{e}"))
        return s

    double = {"block.adaLN_modulation.1.weight": (12 * H, H),
              "block.adaLN_modulation.1.bias": (12 * H,)}
    for t in ("", "_t"):
        for n in ("to_q", "to_k", "to_v", "to_out"):
            double[f"block.attn1.{n}{t}.weight"] = (H, H)
        double[f"block.attn1.q_rms_norm{t}.weight"] = (hd,)
        double[f"block.attn1.k_rms_norm{t}.weight"] = (hd,)
    double.update(moe("block.ff_i"))
    double.update(swiglu("block.ff_t"))
    single = {"block.adaLN_modulation.1.weight": (6 * H, H),
              "block.adaLN_modulation.1.bias": (6 * H,)}
    for n in ("to_q", "to_k", "to_v", "to_out"):
        single[f"block.attn1.{n}.weight"] = (H, H)
    single["block.attn1.q_rms_norm.weight"] = (hd,)
    single["block.attn1.k_rms_norm.weight"] = (hd,)
    single.update(moe("block.ff_i"))
    return nonblock, {"double_stream_blocks": (d.depth_double, double),
                      "single_stream_blocks": (d.depth_single, single)}


def hidream_random_stacked_params(d: TinyHiDreamDims, qtype=Q.Q4_K,
                                  seed: int = 0, device="cuda") -> dict:
    """A full-depth HiDream tree in ``stack_hidream_params``'s layout made on
    ``device`` from a seed (``random_stacked_from_spec``), the routed
    experts of each group generated as one (depth·E)-stack and viewed as
    the (depth, E, …) ``experts_stacked`` leaves."""
    device = resolve_device(device)
    params = random_stacked_from_spec(*hidream_shape_spec(d, experts=False),
                                      "hidream", qtype=qtype, seed=seed,
                                      device=device)
    gen = torch.Generator(device=device).manual_seed(seed + 1)
    H, F, E = d.hidden, d.ffn, d.n_experts

    def experts(n, r, k):
        leaf = random_planar(qtype, (r, k), gen, device=device, stack=n * E)
        return dataclasses.replace(
            leaf, **{f: getattr(leaf, f).reshape(n, E, *getattr(
                leaf, f).shape[1:]) for f in ("qs", "scales", "offsets")
                if getattr(leaf, f) is not None})

    for group, n in (("double_stream_blocks", d.depth_double),
                     ("single_stream_blocks", d.depth_single)):
        params[group]["block.ff_i.experts_stacked"] = {
            "w1": experts(n, F, H), "w2": experts(n, H, F),
            "w3": experts(n, F, H)}
    return params


@dataclasses.dataclass(frozen=True)
class WanDims:
    """Wan 2.1 t2v dims (models/wan.py WanConfig fields)."""
    dim: int = 128
    ffn_dim: int = 256
    n_heads: int = 2
    n_layers: int = 2
    in_ch: int = 16
    text_dim: int = 64

    def config(self):
        from .wan import WanConfig

        return WanConfig(dim=self.dim, ffn_dim=self.ffn_dim,
                         n_heads=self.n_heads, n_layers=self.n_layers,
                         in_channels=self.in_ch, out_channels=self.in_ch,
                         text_dim=self.text_dim)


# Wan2.1-T2V-14B: dim 5120, ffn 13824, 40 heads of 128, 40 blocks, UMT5-xxl
# text states (4096), 16-channel VAE latents, (1,2,2) patches
WAN_14B_DIMS = WanDims(dim=5120, ffn_dim=13824, n_heads=40, n_layers=40,
                       in_ch=16, text_dim=4096)


def wan_shape_spec(d: WanDims):
    """(nonblock, groups) shape spec of models/wan.py's keys (the
    reference's ``wan_shape_spec``)."""
    D, T, F, C = d.dim, d.text_dim, d.ffn_dim, d.in_ch
    nonblock = {
        "patch_embedding.weight": (D, C, 1, 2, 2),
        "patch_embedding.bias": (D,),
        "text_embedding.0.weight": (D, T), "text_embedding.0.bias": (D,),
        "text_embedding.2.weight": (D, D), "text_embedding.2.bias": (D,),
        "time_embedding.0.weight": (D, 256), "time_embedding.0.bias": (D,),
        "time_embedding.2.weight": (D, D), "time_embedding.2.bias": (D,),
        "time_projection.1.weight": (6 * D, D),
        "time_projection.1.bias": (6 * D,),
        "head.modulation": (1, 2, D),
        "head.head.weight": (C * 4, D), "head.head.bias": (C * 4,),
    }
    block = {"modulation": (1, 6, D)}
    for a in ("self_attn", "cross_attn"):
        for n in ("q", "k", "v", "o"):
            block[f"{a}.{n}.weight"] = (D, D)
            block[f"{a}.{n}.bias"] = (D,)
        block[f"{a}.norm_q.weight"] = (D,)
        block[f"{a}.norm_k.weight"] = (D,)
    block["norm3.weight"] = (D,)
    block["norm3.bias"] = (D,)
    block["ffn.0.weight"] = (F, D)
    block["ffn.0.bias"] = (F,)
    block["ffn.2.weight"] = (D, F)
    block["ffn.2.bias"] = (D,)
    return nonblock, {"blocks": (d.n_layers, block)}


def wan_random_stacked_params(d: WanDims, qtype=Q.Q4_K, seed: int = 0,
                              device="cuda") -> dict:
    return random_stacked_from_spec(*wan_shape_spec(d), "wan", qtype=qtype,
                                    seed=seed, device=device)


@dataclasses.dataclass(frozen=True)
class CosmosDims:
    """Cosmos Predict2 DiT dims (models/cosmos.py CosmosConfig fields)."""
    dim: int = 128
    n_heads: int = 2
    n_layers: int = 2
    in_ch: int = 16
    text_dim: int = 64

    def config(self):
        from .cosmos import CosmosConfig

        return CosmosConfig(dim=self.dim, n_layers=self.n_layers,
                            n_heads=self.n_heads, in_channels=self.in_ch,
                            text_dim=self.text_dim)


# the reference's Cosmos 7B geometry: dim 4096, 32 heads of 128, 28 blocks,
# MLP 16384, T5 text states (1024), 16-channel latents, (1,2,2) patches
COSMOS_7B_DIMS = CosmosDims(dim=4096, n_heads=32, n_layers=28, in_ch=16,
                            text_dim=1024)


def cosmos_shape_spec(d: CosmosDims):
    """(nonblock, groups) shape spec of models/cosmos.py's keys (the
    reference's ``cosmos_shape_spec``)."""
    D, T, C = d.dim, d.text_dim, d.in_ch
    hd = D // d.n_heads
    nonblock = {
        "x_embedder.proj.1.weight": (D, C * 4),
        "x_embedder.proj.1.bias": (D,),
        "t_embedder.1.linear_1.weight": (D, 256),
        "t_embedder.1.linear_1.bias": (D,),
        "t_embedder.1.linear_2.weight": (D, D),
        "t_embedder.1.linear_2.bias": (D,),
        "t_embedding_norm.weight": (D,),
        "final_layer.linear.weight": (C * 4, D),
        "final_layer.linear.bias": (C * 4,),
        "final_layer.adaln_modulation.1.weight": (2 * D, D),
        "final_layer.adaln_modulation.1.bias": (2 * D,),
    }
    block = {}
    for m in ("self_attn", "cross_attn", "mlp"):
        block[f"adaln_modulation_{m}.1.weight"] = (3 * D, D)
        block[f"adaln_modulation_{m}.1.bias"] = (3 * D,)
    for a, kdim in (("self_attn", D), ("cross_attn", T)):
        block[f"{a}.q_proj.weight"] = (D, D)
        block[f"{a}.k_proj.weight"] = (D, kdim)
        block[f"{a}.v_proj.weight"] = (D, kdim)
        block[f"{a}.output_proj.weight"] = (D, D)
        block[f"{a}.q_norm.weight"] = (hd,)
        block[f"{a}.k_norm.weight"] = (hd,)
    block["mlp.layer1.weight"] = (4 * D, D)
    block["mlp.layer2.weight"] = (D, 4 * D)
    return nonblock, {"blocks": (d.n_layers, block)}


def cosmos_random_stacked_params(d: CosmosDims, qtype=Q.Q4_K, seed: int = 0,
                                 device="cuda") -> dict:
    return random_stacked_from_spec(*cosmos_shape_spec(d), "cosmos",
                                    qtype=qtype, seed=seed, device=device)



@dataclasses.dataclass(frozen=True)
class HyVidDims:
    """HunyuanVideo DiT dims (models/hyvid.py HyVidConfig fields, and the
    token refiner's block count)."""
    hidden: int = 128
    n_heads: int = 2
    depth_double: int = 2
    depth_single: int = 2
    refiner_depth: int = 1
    in_ch: int = 16
    text_dim: int = 64

    @property
    def mlp(self) -> int:
        return 4 * self.hidden

    def config(self):
        from .hyvid import HyVidConfig

        return HyVidConfig(hidden=self.hidden, n_heads=self.n_heads,
                           depth_double=self.depth_double,
                           depth_single=self.depth_single,
                           in_channels=self.in_ch, text_dim=self.text_dim)


# HunyuanVideo 13B: hidden 3072, 24 heads of 128, 20 double + 40 single
# blocks, mlp ratio 4, 2 token-refiner blocks, llava-llama-3 text states
# (4096), 16-channel latents, (1,2,2) patches
HYVID_13B_DIMS = HyVidDims(hidden=3072, n_heads=24, depth_double=20,
                           depth_single=40, refiner_depth=2, in_ch=16,
                           text_dim=4096)


def hyvid_shape_spec(d: HyVidDims):
    """(nonblock, groups) shape spec of models/hyvid.py's keys (the
    reference's ``hyvid_shape_spec``)."""
    H, T, C, M = d.hidden, d.text_dim, d.in_ch, d.mlp
    hd = H // d.n_heads
    nonblock = {"img_in.proj.weight": (H, C, 1, 2, 2),
                "img_in.proj.bias": (H,)}

    def lin(name, o, i):
        nonblock[f"{name}.weight"] = (o, i)
        nonblock[f"{name}.bias"] = (o,)

    for e in ("time_in", "guidance_in"):
        lin(f"{e}.in_layer", H, 256)
        lin(f"{e}.out_layer", H, H)
    lin("txt_in.input_embedder", H, T)
    lin("txt_in.t_embedder.mlp.0", H, 256)
    lin("txt_in.t_embedder.mlp.2", H, H)
    lin("txt_in.c_embedder.linear_1", H, H)
    lin("txt_in.c_embedder.linear_2", H, H)
    lin("final_layer.linear", C * 4, H)
    lin("final_layer.adaLN_modulation.1", 2 * H, H)
    for i in range(d.refiner_depth):
        rb = f"txt_in.individual_token_refiner.blocks.{i}"
        lin(f"{rb}.self_attn_qkv", 3 * H, H)
        lin(f"{rb}.self_attn_proj", H, H)
        for n in ("norm1", "norm2"):
            nonblock[f"{rb}.{n}.weight"] = (H,)
            nonblock[f"{rb}.{n}.bias"] = (H,)
        lin(f"{rb}.mlp.fc1", M, H)
        lin(f"{rb}.mlp.fc2", H, M)
        lin(f"{rb}.adaLN_modulation.1", 2 * H, H)
    double = {}
    for s in ("img", "txt"):
        for name, o, i in ((f"{s}_mod.linear", 6 * H, H),
                           (f"{s}_attn_qkv", 3 * H, H),
                           (f"{s}_attn_proj", H, H),
                           (f"{s}_mlp.fc1", M, H), (f"{s}_mlp.fc2", H, M)):
            double[f"{name}.weight"] = (o, i)
            double[f"{name}.bias"] = (o,)
        double[f"{s}_attn_q_norm.weight"] = (hd,)
        double[f"{s}_attn_k_norm.weight"] = (hd,)
    single = {"linear1.weight": (3 * H + M, H), "linear1.bias": (3 * H + M,),
              "linear2.weight": (H, H + M), "linear2.bias": (H,),
              "modulation.linear.weight": (3 * H, H),
              "modulation.linear.bias": (3 * H,),
              "q_norm.weight": (hd,), "k_norm.weight": (hd,)}
    return nonblock, {"double_blocks": (d.depth_double, double),
                      "single_blocks": (d.depth_single, single)}


def hyvid_random_stacked_params(d: HyVidDims, qtype=Q.Q4_K, seed: int = 0,
                                device="cuda") -> dict:
    return random_stacked_from_spec(*hyvid_shape_spec(d), "hyvid",
                                    qtype=qtype, seed=seed, device=device)


@dataclasses.dataclass(frozen=True)
class LTXVDims:
    """LTX-Video DiT dims (models/ltxv.py LTXVConfig fields; heads of
    64)."""
    dim: int = 128
    n_layers: int = 2
    in_ch: int = 32
    caption_dim: int = 64

    def config(self):
        from .ltxv import LTXVConfig

        return LTXVConfig(dim=self.dim, n_layers=self.n_layers,
                          n_heads=self.dim // 64, in_channels=self.in_ch,
                          caption_dim=self.caption_dim)


# LTX-Video 2B: dim 2048, 32 heads of 64, 28 blocks, ffn 8192, 128-channel
# latent voxels (the 32x spatial / 8x temporal VAE, no patching), T5-xxl
# caption states (4096)
LTXV_2B_DIMS = LTXVDims(dim=2048, n_layers=28, in_ch=128, caption_dim=4096)


def ltxv_shape_spec(d: LTXVDims):
    """(nonblock, groups) shape spec of models/ltxv.py's keys (the
    reference's ``ltxv_shape_spec``: per-head qk-norm weights)."""
    D, I, P = d.dim, d.in_ch, d.caption_dim
    nonblock = {}

    def lin(out, name, o, i):
        out[f"{name}.weight"] = (o, i)
        out[f"{name}.bias"] = (o,)

    lin(nonblock, "patchify_proj", D, I)
    lin(nonblock, "adaln_single.emb.timestep_embedder.linear_1", D, 256)
    lin(nonblock, "adaln_single.emb.timestep_embedder.linear_2", D, D)
    lin(nonblock, "adaln_single.linear", 6 * D, D)
    lin(nonblock, "caption_projection.linear_1", D, P)
    lin(nonblock, "caption_projection.linear_2", D, D)
    nonblock["scale_shift_table"] = (2, D)
    lin(nonblock, "proj_out", I, D)
    block = {"scale_shift_table": (6, D)}
    for a in ("attn1", "attn2"):
        for n in ("to_q", "to_k", "to_v", "to_out.0"):
            lin(block, f"{a}.{n}", D, D)
        block[f"{a}.q_norm.weight"] = (64,)
        block[f"{a}.k_norm.weight"] = (64,)
    lin(block, "ff.net.0.proj", 4 * D, D)
    lin(block, "ff.net.2", D, 4 * D)
    return nonblock, {"transformer_blocks": (d.n_layers, block)}


def ltxv_random_stacked_params(d: LTXVDims, qtype=Q.Q4_K, seed: int = 0,
                               device="cuda") -> dict:
    return random_stacked_from_spec(*ltxv_shape_spec(d), "ltxv", qtype=qtype,
                                    seed=seed, device=device)

def dit_example_inputs(latent_shape, cond_shape, ts=0.7, seed: int = 1,
                       dtype=torch.bfloat16, device="cuda"):
    """(latent, cond, t) for an AuraFlow or Lumina 2 forward, made from a
    numpy seed."""
    device = resolve_device(device)
    rng = np.random.default_rng(seed)

    def t(shape):
        return torch.as_tensor(rng.standard_normal(shape).astype(
            np.float32)).to(device=device, dtype=dtype)

    lat, cond = t(latent_shape), t(cond_shape)
    return lat, cond, torch.full((lat.shape[0],), ts, dtype=torch.float32,
                                 device=device)


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
    # UMT5: every layer carries its own relative-bias table
    per_layer_bias: bool = False


# t5-v1_1-xxl encoder (flux / sd3 conditioning)
T5_XXL_DIMS = T5Dims(d_model=4096, d_kv=64, n_heads=64, d_ff=10240,
                     n_layers=24, vocab=32128, rel_buckets=32)
# Pile-T5-XL encoder (AuraFlow conditioning)
PILE_T5_XL_DIMS = T5Dims(d_model=2048, d_kv=64, n_heads=32, d_ff=5120,
                         n_layers=24, vocab=32128, rel_buckets=32)
# umt5-xxl encoder (Wan 2.1 conditioning): T5-xxl's widths with a
# relative-bias table in every layer and a 256384-token vocabulary
UMT5_XXL_DIMS = T5Dims(d_model=4096, d_kv=64, n_heads=64, d_ff=10240,
                       n_layers=24, vocab=256384, rel_buckets=32,
                       per_layer_bias=True)
# t5-v1_1-large encoder: 1024-wide states, as Cosmos's DiT reads them
T5_V11_LARGE_DIMS = T5Dims(d_model=1024, d_kv=64, n_heads=16, d_ff=2816,
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
        if dims.per_layer_bias and i:
            sd[_T5_REL.replace("block.0.", f"block.{i}.")] = t(
                dims.rel_buckets, dims.n_heads)
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
        if dims.per_layer_bias and i:
            params[_T5_REL.replace("block.0.", f"block.{i}.")] = dense(
                dims.rel_buckets, dims.n_heads).to(torch.float32)
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
        _add_tokenizer(w, tokenizer)
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


def _add_tokenizer(w, spec) -> None:
    """The ``tokenizer.ggml.*`` metadata of a ``loader.TokenizerSpec`` that
    ``gguf_tokenizer_spec`` reads back."""
    w.add_string("tokenizer.ggml.model", spec.model)
    w.add_array("tokenizer.ggml.tokens", list(spec.tokens))
    if spec.scores is not None:
        w.add_array("tokenizer.ggml.scores", [float(x) for x in spec.scores])
    if spec.token_types is not None:
        w.add_array("tokenizer.ggml.token_type",
                    [int(x) for x in spec.token_types])
    if spec.merges:
        w.add_array("tokenizer.ggml.merges", list(spec.merges))
    for key, val in (("bos_token_id", spec.bos_id),
                     ("eos_token_id", spec.eos_id),
                     ("padding_token_id", spec.pad_id),
                     ("unknown_token_id", spec.unk_id)):
        if val is not None:
            w.add_uint32("tokenizer.ggml." + key, int(val))
    w.add_bool("tokenizer.ggml.add_bos_token", bool(spec.add_bos))
    w.add_bool("tokenizer.ggml.add_eos_token", bool(spec.add_eos))


@dataclasses.dataclass(frozen=True)
class LlamaDims:
    """A llama-family text encoder (models/llama.py LlamaConfig fields)."""
    hidden: int = 128
    n_layers: int = 2
    n_heads: int = 32
    n_kv_heads: int = 8
    head_dim: int = 4
    intermediate: int = 256
    vocab: int = 120
    qk_norm: bool = False  # qwen3
    qkv_bias: bool = False  # qwen2 / qwen2.5

    def config(self):
        from .llama import LlamaConfig

        return LlamaConfig(hidden=self.hidden, n_layers=self.n_layers,
                           n_heads=self.n_heads, n_kv_heads=self.n_kv_heads,
                           intermediate=self.intermediate,
                           vocab_size=self.vocab, head_dim=self.head_dim,
                           qk_norm=self.qk_norm)


# Gemma-2-2b's published shapes (Lumina 2's caption encoder) as the llama
# graph reads them: hidden 2304, 26 layers, q 2048 and k/v 1024 rows,
# intermediate 9216, vocab 256000. The graph takes the default 32 heads
# (of 64) and so 16 kv heads; Gemma-2's own 8 heads of 256 are not in the
# shapes (ROADMAP queue 3)
GEMMA2_2B_LLAMA_DIMS = LlamaDims(hidden=2304, n_layers=26, n_heads=32,
                                 n_kv_heads=16, head_dim=64,
                                 intermediate=9216, vocab=256000)


# Qwen2.5-VL-7B's text model (Qwen-Image's encoder): hidden 3584, 28
# layers, 28 heads of 128 and 4 kv heads, intermediate 18944, q/k/v biases,
# vocab 152064. The llama graph's default 32 heads misread this shape: its
# config is built with n_heads=28 (ROADMAP queue 3)
QWEN25_VL_7B_LLAMA_DIMS = LlamaDims(hidden=3584, n_layers=28, n_heads=28,
                                    n_kv_heads=4, head_dim=128,
                                    intermediate=18944, vocab=152064,
                                    qkv_bias=True)
# Llama-3.1-8B (HiDream-I1's fourth encoder): hidden 4096, 32 layers, 32
# heads of 128 and 8 kv heads, intermediate 14336, vocab 128256
LLAMA31_8B_DIMS = LlamaDims(hidden=4096, n_layers=32, n_heads=32,
                            n_kv_heads=8, head_dim=128, intermediate=14336,
                            vocab=128256)


def _llama_bias_shapes(d: LlamaDims) -> dict[str, tuple[int]]:
    if not d.qkv_bias:
        return {}
    q, kv = d.n_heads * d.head_dim, d.n_kv_heads * d.head_dim
    return {"self_attn.q_proj": (q,), "self_attn.k_proj": (kv,),
            "self_attn.v_proj": (kv,)}


def _llama_linear_shapes(d: LlamaDims) -> dict[str, tuple[int, int]]:
    q, kv = d.n_heads * d.head_dim, d.n_kv_heads * d.head_dim
    return {"self_attn.q_proj": (q, d.hidden),
            "self_attn.k_proj": (kv, d.hidden),
            "self_attn.v_proj": (kv, d.hidden),
            "self_attn.o_proj": (d.hidden, q),
            "mlp.gate_proj": (d.intermediate, d.hidden),
            "mlp.up_proj": (d.intermediate, d.hidden),
            "mlp.down_proj": (d.hidden, d.intermediate)}


def _llama_norm_shapes(d: LlamaDims) -> dict[str, tuple[int]]:
    out = {"input_layernorm": (d.hidden,),
           "post_attention_layernorm": (d.hidden,)}
    if d.qk_norm:
        out["self_attn.q_norm"] = (d.head_dim,)
        out["self_attn.k_norm"] = (d.head_dim,)
    return out


def llama_state_dict(dims: LlamaDims, seed: int = 0,
                     scale: float = 0.05) -> dict[str, np.ndarray]:
    """Random llama-family encoder state dict (numpy float32, the HF key
    names the loader maps llama.cpp's to)."""
    rng = np.random.default_rng(seed)

    def t(*s):
        return (rng.standard_normal(s) * scale).astype(np.float32)

    sd = {"model.embed_tokens.weight": t(dims.vocab, dims.hidden),
          "model.norm.weight": t(dims.hidden) + 1}
    for i in range(dims.n_layers):
        p = f"model.layers.{i}."
        for name, shape in _llama_linear_shapes(dims).items():
            sd[f"{p}{name}.weight"] = t(*shape)
        for name, shape in _llama_bias_shapes(dims).items():
            sd[f"{p}{name}.bias"] = t(*shape)
        for name, shape in _llama_norm_shapes(dims).items():
            sd[f"{p}{name}.weight"] = t(*shape) + 1
    return sd


def llama_random_params(dims: LlamaDims, qtype=Q.Q8_0, seed: int = 0,
                        device="cuda") -> dict:
    """A llama-family encoder's params with random packed linears made on
    ``device`` (a full-width tree is never built on the host); scale planes
    sized so that each linear keeps unit-variance inputs near unit
    variance. The token embedding is the dense bf16 table the loader's
    big-embed guard leaves a large vocabulary as."""
    device = resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    dense = _dense_maker(gen, device)
    params = {"model.embed_tokens.weight": dense(dims.vocab, dims.hidden),
              "model.norm.weight": dense(dims.hidden) + 1}
    for i in range(dims.n_layers):
        p = f"model.layers.{i}."
        for name, (r, k) in _llama_linear_shapes(dims).items():
            params[f"{p}{name}.weight"] = random_planar(
                qtype, (r, k), gen, device=device,
                scale=1.0 / (73.0 * k ** 0.5))
        for name, shape in _llama_bias_shapes(dims).items():
            params[f"{p}{name}.bias"] = dense(*shape)
        for name, shape in _llama_norm_shapes(dims).items():
            params[f"{p}{name}.weight"] = dense(*shape) + 1
    return params


def llamacpp_permute(w: np.ndarray, n_head: int) -> np.ndarray:
    """The row permutation llama.cpp's converter applies to q/k (the
    inverse of ``maps.unpermute_gqa_rows``)."""
    r = w.shape[0]
    return (w.reshape(n_head, 2, r // n_head // 2, *w.shape[1:])
            .swapaxes(1, 2).reshape(w.shape))


def write_llama_gguf(sd: dict, path: str, qtype=Q.Q8_0, tokenizer=None,
                     arch: str = "llama") -> None:
    """Write an HF-named llama-family state dict as a GGUF with llama.cpp's
    names: for arch "llama" the q and k rows permuted as llama.cpp's
    converter does (32 and 8 heads, the loader's un-permute), 2-D weights
    in ``qtype`` where the format's blocks tile their rows (norms stay
    float32), plus ``tokenizer``'s metadata (a ``loader.TokenizerSpec``)."""
    from ..gguf.writer import GGUFWriter
    from ..maps import LLAMA_SD_MAP

    inv = sorted(((dst, src) for src, dst in LLAMA_SD_MAP.items()),
                 key=lambda p: -len(p[0]))
    block = GGML_QUANT_SIZES[qtype][0]
    w = GGUFWriter(arch)
    if tokenizer is not None:
        _add_tokenizer(w, tokenizer)
    for k, v in sd.items():
        if arch == "llama" and k.endswith("q_proj.weight"):
            v = llamacpp_permute(v, 32)
        elif arch == "llama" and k.endswith("k_proj.weight"):
            v = llamacpp_permute(v, 8)
        for dst, src in inv:
            k = k.replace(dst, src)
        if v.ndim == 2 and v.shape[1] % block == 0 and "norm" not in k:
            w.add_tensor(k, codecs.quantize(v, qtype), raw_dtype=qtype,
                         raw_shape=v.shape)
        else:
            w.add_tensor(k, np.ascontiguousarray(v, np.float32))
    w.write_to_file(str(path))


@dataclasses.dataclass(frozen=True)
class QwenVLVisionDims:
    """A Qwen-VL vision tower (models/qwen_vl_vision.py): ``dim`` wide
    (heads of 80 at published widths), SwiGLU (2.5) or fc + quick-GELU
    (2.0) MLPs of ``intermediate``, a 2×2 merger to ``out_dim``."""
    dim: int = 160
    n_layers: int = 2
    out_dim: int = 96
    intermediate: int = 320
    patch: int = 4
    temporal: int = 2
    v25: bool = True


# Qwen2.5-VL-7B's vision tower: 1280 wide, 32 blocks of 16 heads × 80,
# SwiGLU 3420, patches of 14 over 2 frames, windowed with full attention in
# blocks 7/15/23/31, merged to the 3584-wide text model
QWEN25_VL_7B_VISION_DIMS = QwenVLVisionDims(dim=1280, n_layers=32,
                                            out_dim=3584, intermediate=3420,
                                            patch=14)


def _vision_shapes(d: QwenVLVisionDims) -> dict[str, tuple]:
    D, M = d.dim, d.intermediate
    s = {"visual.patch_embed.proj.weight": (D, 3, d.temporal, d.patch,
                                            d.patch),
         "visual.merger.ln_q.weight": (D,),
         "visual.merger.mlp.0.weight": (4 * D, 4 * D),
         "visual.merger.mlp.0.bias": (4 * D,),
         "visual.merger.mlp.2.weight": (d.out_dim, 4 * D),
         "visual.merger.mlp.2.bias": (d.out_dim,)}
    if not d.v25:
        s["visual.patch_embed.proj.bias"] = (D,)
        s["visual.merger.ln_q.bias"] = (D,)
    for i in range(d.n_layers):
        p = f"visual.blocks.{i}."
        s.update({p + "attn.qkv.weight": (3 * D, D),
                  p + "attn.qkv.bias": (3 * D,),
                  p + "attn.proj.weight": (D, D), p + "attn.proj.bias": (D,),
                  p + "norm1.weight": (D,), p + "norm2.weight": (D,),
                  p + "mlp.up_proj.weight": (M, D),
                  p + "mlp.up_proj.bias": (M,),
                  p + "mlp.down_proj.weight": (D, M),
                  p + "mlp.down_proj.bias": (D,)})
        if d.v25:
            s[p + "mlp.gate_proj.weight"] = (M, D)
            s[p + "mlp.gate_proj.bias"] = (M,)
        else:
            s[p + "norm1.bias"] = (D,)
            s[p + "norm2.bias"] = (D,)
    return s


def qwen_vl_vision_state_dict(d: QwenVLVisionDims, seed: int = 0,
                              scale: float = 0.02) -> dict[str, np.ndarray]:
    """A random vision tower as numpy float32 ``visual.*`` keys (the names
    ``loader.gguf_mmproj_loader`` gives); norm gains center at 1."""
    rng = np.random.default_rng(seed)
    sd = {}
    for k, shape in _vision_shapes(d).items():
        w = (rng.standard_normal(shape) * scale).astype(np.float32)
        sd[k] = w + 1 if ".norm" in k or "ln_q.weight" in k else w
    return sd


def qwen_vl_vision_random_params(d: QwenVLVisionDims, seed: int = 0,
                                 device="cuda") -> dict:
    """The vision tower as the loader places a published mmproj (F16
    linears and patch kernel → dense bf16, norms and biases float32), made
    on ``device`` from a seed."""
    device = resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    dense = _dense_maker(gen, device)
    out = {}
    for k, shape in _vision_shapes(d).items():
        w = dense(*shape)
        out[k] = w + 1 if ".norm" in k or "ln_q.weight" in k else w
    return out


def _mmproj_name(key: str) -> str:
    """llama.cpp's mmproj name of a ``visual.*`` key (the inverse of
    ``maps.CLIP_VISION_SD_MAP``)."""
    for hf, cpp in (("visual.merger.mlp.", "mm."),
                    ("visual.merger.ln_q.", "v.post_ln."),
                    ("visual.patch_embed.proj", "v.patch_embd"),
                    ("visual.blocks.", "v.blk."), ("mlp.up_proj", "ffn_up"),
                    ("mlp.down_proj", "ffn_down"),
                    ("mlp.gate_proj", "ffn_gate"),
                    ("attn.proj.", "attn_out."), ("norm1.", "ln1."),
                    ("norm2.", "ln2.")):
        key = key.replace(hf, cpp)
    return key


def write_mmproj_gguf(sd: dict, path: str) -> None:
    """Write a ``visual.*`` state dict as a llama.cpp mmproj GGUF
    (architecture "clip", type "mmproj"): the fused qkv split into
    ``attn_q/k/v``, the 5-D patch kernel split into its two 4-D temporal
    chunks (``v.patch_embd.weight`` and ``.weight.1``), 2-D weights F16 and
    the rest F32."""
    from ..gguf.writer import GGUFWriter

    w = GGUFWriter("clip")
    w.add_string("general.type", "mmproj")

    def put(name, arr):
        dt = np.float16 if arr.ndim >= 2 else np.float32
        w.add_tensor(name, np.ascontiguousarray(arr, dt))

    for k, v in sd.items():
        name = _mmproj_name(k)
        if k == "visual.patch_embed.proj.weight":
            put(name, v[:, :, 0])
            put(name + ".1", v[:, :, 1])
        elif ".attn.qkv." in k:
            for c, part in zip("qkv", np.split(v, 3, axis=0)):
                put(name.replace("attn.qkv.", f"attn_{c}."), part)
        else:
            put(name, v)
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
# open_clip ViT-bigG/14 text tower (SDXL's and SD3's second encoder): plain
# GELU, a text projection, penultimate and pooled outputs
CLIP_G_DIMS = CLIPDims(hidden=1280, n_layers=32, n_heads=20,
                       intermediate=5120, vocab=49408, max_positions=77,
                       proj=1280)


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


@dataclasses.dataclass(frozen=True)
class WanVAEDims:
    """Wan 2.1 video VAE geometry (Wan-Video's WanVAE_ arguments): base
    width, latent channels, width multipliers per level, residual blocks a
    level, and which of the encoder's level transitions also halve time
    (the decoder doubles time at the mirrored ones)."""
    base: int = 16
    z: int = 4
    mult: tuple[int, ...] = (1, 2, 4)
    num_res: int = 1
    temporal_down: tuple[bool, ...] = (True, False)


# the published Wan 2.1 VAE: base 96, z 16, mult (1, 2, 4, 4), 2 residual
# blocks a level, time halved at the 2nd and 3rd transitions, attention in
# the middle (its width 384 is K7's D = 384)
WAN21_VAE_DIMS = WanVAEDims(base=96, z=16, mult=(1, 2, 4, 4), num_res=2,
                            temporal_down=(False, True, True))


def wan_vae_shapes(d: WanVAEDims) -> dict[str, tuple]:
    """Every tensor of a Wan-Video VAE of this geometry, in the keys
    models/wan_vae.py walks (``_walk`` / ``_block_kind``) and the shapes a
    published file has (video RMS gains (C, 1, 1, 1), the attention's
    (C, 1, 1))."""
    out = {}

    def conv3(name, o, i, kt=3, kh=3, kw=3):
        out[f"{name}.weight"] = (o, i, kt, kh, kw)
        out[f"{name}.bias"] = (o,)

    def conv2(name, o, i, k=3):
        out[f"{name}.weight"] = (o, i, k, k)
        out[f"{name}.bias"] = (o,)

    def res(p, cin, cout):
        out[f"{p}.residual.0.gamma"] = (cin, 1, 1, 1)
        conv3(f"{p}.residual.2", cout, cin)
        out[f"{p}.residual.3.gamma"] = (cout, 1, 1, 1)
        conv3(f"{p}.residual.6", cout, cout)
        if cin != cout:
            conv3(f"{p}.shortcut", cout, cin, 1, 1, 1)

    def attn(p, c):
        out[f"{p}.norm.gamma"] = (c, 1, 1)
        conv2(f"{p}.to_qkv", 3 * c, c, 1)
        conv2(f"{p}.proj", c, c, 1)

    def middle(side, c):
        res(f"{side}.middle.0", c, c)
        attn(f"{side}.middle.1", c)
        res(f"{side}.middle.2", c, c)

    z, n = d.z, len(d.mult)
    # decoder: widths top-down; each upsample halves the channels
    dims = [d.base * u for u in (d.mult[-1],) + d.mult[::-1]]
    conv3("conv2", z, z, 1, 1, 1)
    conv3("decoder.conv1", dims[0], z)
    middle("decoder", dims[0])
    idx = 0
    for i, (cin, cout) in enumerate(zip(dims[:-1], dims[1:])):
        if i:
            cin //= 2
        for _ in range(d.num_res + 1):
            res(f"decoder.upsamples.{idx}", cin, cout)
            idx, cin = idx + 1, cout
        if i != n - 1:
            p = f"decoder.upsamples.{idx}"
            conv2(f"{p}.resample.1", cout // 2, cout)
            if d.temporal_down[::-1][i]:
                conv3(f"{p}.time_conv", 2 * cout, cout, 3, 1, 1)
            idx += 1
    out["decoder.head.0.gamma"] = (dims[-1], 1, 1, 1)
    conv3("decoder.head.2", 3, dims[-1])
    # encoder: widths bottom-up
    dims = [d.base * u for u in (1,) + d.mult]
    conv3("encoder.conv1", dims[0], 3)
    idx = 0
    for i, (cin, cout) in enumerate(zip(dims[:-1], dims[1:])):
        for _ in range(d.num_res):
            res(f"encoder.downsamples.{idx}", cin, cout)
            idx, cin = idx + 1, cout
        if i != n - 1:
            p = f"encoder.downsamples.{idx}"
            conv2(f"{p}.resample.1", cout, cout)
            if d.temporal_down[i]:
                conv3(f"{p}.time_conv", cout, cout, 3, 1, 1)
            idx += 1
    middle("encoder", dims[-1])
    out["encoder.head.0.gamma"] = (dims[-1], 1, 1, 1)
    conv3("encoder.head.2", 2 * z, dims[-1])
    conv3("conv1", 2 * z, 2 * z, 1, 1, 1)
    return out


def wan_vae_state_dict(dims: WanVAEDims, seed: int = 0) -> dict:
    return _vae_state_dict(wan_vae_shapes(dims), seed)


def wan_vae_random_params(dims: WanVAEDims, seed: int = 0,
                          device="cuda") -> dict:
    return _vae_random_params(wan_vae_shapes(dims), seed, device)

def _is_gain(key: str, shape) -> bool:
    """A norm's gain: Wan's ``gamma`` planes, a 1-D ``norm`` weight."""
    return key.endswith("gamma") or (len(shape) == 1 and "norm" in key
                                     and key.endswith("weight"))


def _vae_state_dict(shapes: dict, seed: int) -> dict:
    """Random video-VAE state dict (numpy float32) over ``shapes``: conv
    and linear weights scaled by their fan-in, unit norm gains, small
    biases."""
    rng = np.random.default_rng(seed)
    out = {}
    for k, shape in shapes.items():
        if _is_gain(k, shape):
            out[k] = np.ones(shape, np.float32)
        elif len(shape) == 1:
            out[k] = (rng.standard_normal(shape) * 0.02).astype(np.float32)
        else:
            fan_in = int(np.prod(shape[1:]))
            out[k] = (rng.standard_normal(shape)
                      * fan_in ** -0.5).astype(np.float32)
    return out


def _vae_random_params(shapes: dict, seed: int, device) -> dict:
    """The same kind of params as ``_vae_state_dict`` made on ``device``
    from a seed (a full-width tree is never built on the host)."""
    device = resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    out = {}
    for k, shape in shapes.items():
        if _is_gain(k, shape):
            out[k] = torch.ones(shape, device=device)
        elif len(shape) == 1:
            out[k] = torch.randn(shape, generator=gen, device=device) * 0.02
        else:
            fan_in = int(np.prod(shape[1:]))
            out[k] = torch.randn(shape, generator=gen,
                                 device=device) * fan_in ** -0.5
    return out


@dataclasses.dataclass(frozen=True)
class HyVidVAEDims:
    """HunyuanVideo VAE geometry (diffusers ``AutoencoderKLHunyuanVideo``
    arguments): block widths (shallow → deep), latent channels, resnets a
    level in the encoder (the decoder has one more), GroupNorm groups of
    32 (every width a multiple of 32)."""
    widths: tuple[int, ...] = (32, 64, 64)
    z: int = 16
    layers: int = 1


# the published HunyuanVideo VAE (diffusers AutoencoderKLHunyuanVideo's
# config): block_out_channels (128, 256, 512, 512), latent_channels 16,
# layers_per_block 2 (3 resnets a decoder level), norm_num_groups 32, a
# single-head mid-block attention over the 512-wide mid block (K7's
# D = 512), 8x spatial and 4x temporal compression
HYVID_VAE_DIMS = HyVidVAEDims(widths=(128, 256, 512, 512), z=16, layers=2)


def hyvid_vae_shapes(d: HyVidVAEDims) -> dict[str, tuple]:
    """Every tensor of a HunyuanVideo VAE of this geometry, in the keys
    models/hyvid_vae.py walks (the diffusers names: causal convs as
    ``*.conv.conv.weight``, 1x1x1 ``quant_conv`` / ``post_quant_conv``)."""
    out = {}

    def conv(name, o, i, k=3):
        out[f"{name}.weight"] = (o, i, k, k, k)
        out[f"{name}.bias"] = (o,)

    def norm(name, c):
        out[f"{name}.weight"] = (c,)
        out[f"{name}.bias"] = (c,)

    def resnet(p, cin, cout):
        norm(f"{p}.norm1", cin)
        conv(f"{p}.conv1.conv", cout, cin)
        norm(f"{p}.norm2", cout)
        conv(f"{p}.conv2.conv", cout, cout)
        if cin != cout:
            conv(f"{p}.conv_shortcut.conv", cout, cin, 1)

    def mid(side, c):
        resnet(f"{side}.mid_block.resnets.0", c, c)
        a = f"{side}.mid_block.attentions.0"
        norm(f"{a}.group_norm", c)
        for n in ("to_q", "to_k", "to_v", "to_out.0"):
            out[f"{a}.{n}.weight"] = (c, c)
            out[f"{a}.{n}.bias"] = (c,)
        resnet(f"{side}.mid_block.resnets.1", c, c)

    w, n = d.widths, len(d.widths)
    conv("encoder.conv_in.conv", w[0], 3)
    cin = w[0]
    for i, c in enumerate(w):
        for j in range(d.layers):
            resnet(f"encoder.down_blocks.{i}.resnets.{j}", cin, c)
            cin = c
        if i < n - 1:
            conv(f"encoder.down_blocks.{i}.downsamplers.0.conv.conv", c, c)
    mid("encoder", w[-1])
    norm("encoder.conv_norm_out", w[-1])
    conv("encoder.conv_out.conv", 2 * d.z, w[-1])
    conv("quant_conv", 2 * d.z, 2 * d.z, 1)
    conv("post_quant_conv", d.z, d.z, 1)
    conv("decoder.conv_in.conv", w[-1], d.z)
    mid("decoder", w[-1])
    cin = w[-1]
    for i, c in enumerate(w[::-1]):
        for j in range(d.layers + 1):
            resnet(f"decoder.up_blocks.{i}.resnets.{j}", cin, c)
            cin = c
        if i < n - 1:
            conv(f"decoder.up_blocks.{i}.upsamplers.0.conv.conv", c, c)
    norm("decoder.conv_norm_out", w[0])
    conv("decoder.conv_out.conv", 3, w[0])
    return out


def hyvid_vae_state_dict(dims: HyVidVAEDims, seed: int = 0) -> dict:
    return _vae_state_dict(hyvid_vae_shapes(dims), seed)


def hyvid_vae_random_params(dims: HyVidVAEDims, seed: int = 0,
                            device="cuda") -> dict:
    return _vae_random_params(hyvid_vae_shapes(dims), seed, device)


@dataclasses.dataclass(frozen=True)
class LTXVVAEDims:
    """LTX-Video VAE geometry as models/ltxv_vae.py reads it: block widths
    a level (shallow → deep), latent channels, the pixel-shuffle patch,
    residual blocks a level (one count for every level), and per level
    whether it strides time too (the last level strides nothing)."""
    widths: tuple[int, ...] = (8, 12, 12, 16)
    latent: int = 6
    patch: int = 4
    res_blocks: int = 2


# the published LTX-Video 0.9 VAE (diffusers AutoencoderKLLTXVideo): block
# widths (128, 256, 512, 512), 128 latent channels, patch 4,
# spatio_temporal_scaling (True, True, True, False): 32x spatial and 8x
# temporal compression. The reference module reads one residual-block
# count for every level (``res_blocks_per_level``, 2 by default), which is
# what this builds; the published decoder's (4, 3, 3, 3, 4) blocks a level
# are a layout the reference does not read
LTXV_VAE_DIMS = LTXVVAEDims(widths=(128, 256, 512, 512), latent=128, patch=4,
                            res_blocks=2)


def ltxv_vae_shapes(d: LTXVVAEDims) -> dict[str, tuple]:
    """Every tensor of an LTX-Video VAE of this geometry, in the keys
    models/ltxv_vae.py reads (the reference's tests' layout: the
    downsampler of level i widens to level i + 1's width, the upsampler of
    decoder block i emits level lvl = n − 1 − i's width times 8 for the
    depth-to-spacetime shuffle)."""
    out = {}
    w, n, p = d.widths, len(d.widths), d.patch

    def conv(name, o, i, k=3):
        out[f"{name}.conv.weight"] = (o, i, k, k, k)
        out[f"{name}.conv.bias"] = (o,)

    def res(prefix, c):
        conv(f"{prefix}.conv1", c, c)
        conv(f"{prefix}.conv2", c, c)

    conv("encoder.conv_in", w[0], 3 * p * p)
    for i in range(n):
        for j in range(d.res_blocks):
            res(f"encoder.down_blocks.{i}.res_blocks.{j}", w[i])
        if i < n - 1:
            conv(f"encoder.down_blocks.{i}.downsamplers.0", w[i + 1], w[i])
    for j in range(d.res_blocks):
        res(f"encoder.mid_block.res_blocks.{j}", w[-1])
    conv("encoder.conv_out", 2 * d.latent, w[-1])
    conv("decoder.conv_in", w[-1], d.latent)
    for j in range(d.res_blocks):
        res(f"decoder.mid_block.res_blocks.{j}", w[-1])
    for i in range(n):
        lvl = n - 1 - i
        if lvl < n - 1:  # time strides at every level but the last
            conv(f"decoder.up_blocks.{i}.upsamplers.0", w[lvl] * 8,
                 w[lvl + 1])
        for j in range(d.res_blocks):
            res(f"decoder.up_blocks.{i}.res_blocks.{j}", w[lvl])
    conv("decoder.conv_out", 3 * p * p, w[0])
    out["per_channel_statistics.mean-of-means"] = (d.latent,)
    out["per_channel_statistics.std-of-means"] = (d.latent,)
    return out


def _ltxv_statistics(sd: dict, latent: int, rng) -> None:
    """Per-channel latent statistics near (0, 1), in place."""
    sd["per_channel_statistics.mean-of-means"] = (
        rng.standard_normal(latent) * 0.1).astype(np.float32)
    sd["per_channel_statistics.std-of-means"] = (
        1.0 + rng.random(latent) * 0.1).astype(np.float32)


def ltxv_vae_state_dict(dims: LTXVVAEDims, seed: int = 0) -> dict:
    sd = _vae_state_dict(ltxv_vae_shapes(dims), seed)
    _ltxv_statistics(sd, dims.latent, np.random.default_rng(seed + 1))
    return sd


def ltxv_vae_random_params(dims: LTXVVAEDims, seed: int = 0,
                           device="cuda") -> dict:
    params = _vae_random_params(ltxv_vae_shapes(dims), seed, device)
    stats = {}
    _ltxv_statistics(stats, dims.latent, np.random.default_rng(seed + 1))
    params.update({k: torch.from_numpy(v).to(resolve_device(device))
                   for k, v in stats.items()})
    return params

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


def bpe_spec(vocab_size: int = 300, words=SMOKE_WORDS):
    """A synthetic byte-level BPE ("gpt2") ``TokenizerSpec`` of exactly
    ``vocab_size`` entries: the 256 byte symbols, the merge products of
    ``words`` with and without the leading-space symbol, filler, and the
    pad and end-of-text specials last (control tokens)."""
    from ..loader import TokenizerSpec
    from ..tokenizer.bpe import bytes_to_unicode

    tokens = list(bytes_to_unicode().values())
    merges = []
    space = bytes_to_unicode()[ord(" ")]
    for wd in words:
        for parts in (list(wd), [space] + list(wd)):
            while len(parts) > 1:
                pair = f"{parts[0]} {parts[1]}"
                merged = parts[0] + parts[1]
                if pair not in merges:
                    merges.append(pair)
                    tokens.append(merged)
                parts = [merged] + parts[2:]
    tokens = list(dict.fromkeys(tokens))[: vocab_size - 2]
    keep = set(tokens)
    merges = [m for m in merges if m.replace(" ", "") in keep]
    while len(tokens) < vocab_size - 2:
        tokens.append(f"<filler_{len(tokens)}>")
    tokens += ["<pad>", "<|endoftext|>"]
    types = [1] * (vocab_size - 2) + [3, 3]
    return TokenizerSpec(model="gpt2", tokens=tokens, scores=None,
                         token_types=types, merges=merges,
                         eos_id=vocab_size - 1, pad_id=vocab_size - 2,
                         add_bos=False, add_eos=True)


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
