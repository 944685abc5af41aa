"""Synthetic flux builders for tests, smoke runs and benches (PyTorch port
of the flux part of comfyui_gguf_tpu/models/testing.py).

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
                  device="cuda", stack: int | None = None) -> PlanarQuant:
    """Random PlanarQuant with the exact layout of a real weight, made on
    ``device`` from ``gen``. ``stack=n`` prepends a depth axis of n (the
    stack_flux_params layout) without building per-block copies."""
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
                           device=device, dtype=torch.float32) * 0.01

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
