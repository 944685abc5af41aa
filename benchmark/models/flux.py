"""FLUX.1 in the benchmark: its tensors and their stored formats, its
requests, its work per step, and how the program's engine is built for it.
The plain reference is ``flux_ref.py`` beside this file."""

from __future__ import annotations

import math

import numpy as np
import torch

from weights import Group
from work import attention_work, linear_work

# the program's forward that the engine binds, and the module whose
# layer calls the check samples
FORWARD = ("models.flux", "forward_stacked")
OP_MODULE = "models.flux"


def dims(cfg: dict) -> dict:
    c = dict(cfg["config"])
    c["hidden"] = c["num_attention_heads"] * c["attention_head_dim"]
    c["mlp"] = int(c["hidden"] * c.get("mlp_ratio", 4.0))
    return c


def groups(cfg: dict) -> list[Group]:
    """Every tensor of the transformer as ``cfg["formats"]`` stores it:
    the blocks' 2-D weights in ``block``, the embedders and the final
    layer (kept unquantized in published files) in ``dense``, vectors in
    F32."""
    c = dims(cfg)
    H, M, hd = c["hidden"], c["mlp"], c["attention_head_dim"]
    ctx, vec, inch = (c["joint_attention_dim"], c["pooled_projection_dim"],
                      c["in_channels"])
    blk, dense = cfg["formats"]["block"], cfg["formats"]["dense"]
    out = []

    def lin(key, r, k, fmt, depth=None):
        out.append(Group(key + ".weight", (r, k), fmt, "matrix", depth))
        out.append(Group(key + ".bias", (r,), "F32", "bias", depth))

    lin("img_in", H, inch, dense)
    lin("txt_in", H, ctx, dense)
    for e, k in (("time_in", 256), ("guidance_in", 256), ("vector_in", vec)):
        lin(f"{e}.in_layer", H, k, dense)
        lin(f"{e}.out_layer", H, H, dense)
    nd, ns = c["num_layers"], c["num_single_layers"]
    for s in ("img", "txt"):
        p = "double_blocks.{i}." + s
        lin(p + "_mod.lin", 6 * H, H, blk, nd)
        lin(p + "_attn.qkv", 3 * H, H, blk, nd)
        lin(p + "_attn.proj", H, H, blk, nd)
        lin(p + "_mlp.0", M, H, blk, nd)
        lin(p + "_mlp.2", H, M, blk, nd)
        for n in ("query_norm", "key_norm"):
            out.append(Group(f"{p}_attn.norm.{n}.scale", (hd,), "F32",
                             "qk_gain", nd))
    p = "single_blocks.{i}."
    lin(p + "linear1", 3 * H + M, H, blk, ns)
    lin(p + "linear2", H, H + M, blk, ns)
    lin(p + "modulation.lin", 3 * H, H, blk, ns)
    for n in ("query_norm", "key_norm"):
        out.append(Group(f"{p}norm.{n}.scale", (hd,), "F32", "qk_gain",
                         ns))
    lin("final_layer.adaLN_modulation.1", 2 * H, H, dense)
    lin("final_layer.linear", inch, H, dense)
    return out


def build(params: dict, cfg: dict, device):
    """The program's model over its loaded tree, depth-stacked as the
    serving example builds it (``stack`` in ``cfg["tree"]``)."""
    from comfyui_gguf_tpu_torch.models.flux import FluxConfig
    from comfyui_gguf_tpu_torch.pipeline import DiffusionModel
    from comfyui_gguf_tpu_torch.nn.layers import QuantConfig

    model = DiffusionModel(arch="flux", params=params,
                           config=FluxConfig.from_state_dict(params),
                           qcfg=QuantConfig(), device=torch.device(device))
    return model.stack() if cfg["tree"].get("stacked") else model


def lat_hw(traffic: dict) -> tuple[int, int]:
    return traffic["height"] // 8, traffic["width"] // 8


def n_tokens(traffic: dict) -> int:
    h, w = lat_hw(traffic)
    return (h // 2) * (w // 2)


def make_engine(model, cfg: dict, traffic: dict):
    from comfyui_gguf_tpu_torch.pipeline import flux_engine

    h, w = lat_hw(traffic)
    return flux_engine(model, h, w, traffic["text_tokens"],
                       max_batch=traffic["max_batch"])


def sigmas(cfg: dict, traffic: dict) -> np.ndarray:
    """FLUX.1-dev's schedule: linear in σ, time-shifted by μ interpolated
    in the image length through (256, 0.5) and (4096, 1.15)."""
    n = traffic["steps"]
    s = np.linspace(1.0, 0.0, n + 1, dtype=np.float64)
    m = (1.15 - 0.5) / (4096 - 256)
    mu = m * n_tokens(traffic) + (0.5 - m * 256)
    e = math.exp(mu)
    return (e * s / (1.0 + (e - 1.0) * s)).astype(np.float32)


def request(gen: torch.Generator, cfg: dict, traffic: dict, device) -> dict:
    """One request's inputs from ``gen``: the noise, already in patch-token
    layout (L, C·4), the T5 states (text_tokens, context) and pooled CLIP
    vector, rounded to bf16 as the engine takes them."""
    c = dims(cfg)

    def draw(*shape):
        return torch.randn(shape, generator=gen, device=device,
                           dtype=torch.float32).to(torch.bfloat16)

    noise = draw(n_tokens(traffic), c["in_channels"])
    txt = draw(traffic["text_tokens"], c["joint_attention_dim"])
    y = draw(c["pooled_projection_dim"])
    g = torch.tensor(float(traffic["guidance"]), dtype=torch.float32,
                     device=device)
    return {"latent": noise, "cond": {"txt": txt, "y": y, "guidance": g},
            "sigmas": sigmas(cfg, traffic)}


def reference(W, cfg: dict, traffic: dict, reqs: list, x, s_cur):
    """The reference's forward outputs for lanes ``reqs`` (request input
    dicts) at latents ``x`` (B, L, C·4) and sigmas ``s_cur`` (B,): ([v],
    v), float32."""
    import flux_ref

    h, w = lat_hw(traffic)
    hh, ww = torch.meshgrid(torch.arange(h // 2), torch.arange(w // 2),
                            indexing="ij")
    ids = torch.stack([torch.zeros_like(hh), hh, ww], -1).reshape(-1, 3)
    f32 = torch.float32
    v = flux_ref.velocity(
        W, dims(cfg), x.to(f32), ids.to(x.device),
        torch.stack([r["cond"]["txt"] for r in reqs]).to(f32),
        s_cur.to(f32), torch.stack([r["cond"]["y"] for r in reqs]).to(f32),
        torch.stack([r["cond"]["guidance"] for r in reqs]).to(f32))
    return [v], v


def mix(outs: list, reqs: list):
    """The velocity the engine steps with, from the step's forward outputs,
    in float64, and a bound on the magnitudes its float32 sum adds."""
    v = outs[0].double()
    return v, v.abs()


def work(cfg: dict, traffic: dict, lanes: int) -> dict:
    """The work of one engine step over ``lanes`` requests, as the
    architecture needs it at these shapes: {"linear": [...], "attention":
    [...]}, one ``work.py`` entry per kernel call."""
    c = dims(cfg)
    H, M, hd, nh = (c["hidden"], c["mlp"], c["attention_head_dim"],
                    c["num_attention_heads"])
    L, Lt = n_tokens(traffic), traffic["text_tokens"]
    blk, dense = cfg["formats"]["block"], cfg["formats"]["dense"]
    lin, att = [], []

    def mm(tokens, k, r, fmt):
        lin.append(linear_work(lanes * tokens, k, r, fmt))

    mm(L, c["in_channels"], H, dense)
    mm(Lt, c["joint_attention_dim"], H, dense)
    for k in (256, 256, c["pooled_projection_dim"]):
        mm(1, k, H, dense)
        mm(1, H, H, dense)
    Lj = L + Lt
    for _ in range(c["num_layers"]):
        for tok in (L, Lt):
            mm(1, H, 6 * H, blk)
            mm(tok, H, 3 * H, blk)
            mm(tok, H, H, blk)
            mm(tok, H, M, blk)
            mm(tok, M, H, blk)
        att.append(attention_work(lanes, nh, Lj, Lj, hd))
    for _ in range(c["num_single_layers"]):
        mm(1, H, 3 * H, blk)
        mm(Lj, H, 3 * H + M, blk)
        mm(Lj, H + M, H, blk)
        att.append(attention_work(lanes, nh, Lj, Lj, hd))
    mm(1, H, 2 * H, dense)
    mm(L, H, c["in_channels"], dense)
    return {"linear": lin, "attention": att}
