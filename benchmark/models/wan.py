"""Wan 2.1 text-to-video in the benchmark: its tensors and their stored
formats, its requests (seed-made UMT5 states: the text encoder is not in
the cell), its work per step, and how the program's engine is built for
it. The plain reference is ``wan_ref.py`` beside this file."""

from __future__ import annotations

import numpy as np
import torch

from weights import Group
from work import attention_work, linear_work

FORWARD = ("models.wan", "forward_stacked")
OP_MODULE = "models.wan"


def dims(cfg: dict) -> dict:
    return dict(cfg["config"])


def groups(cfg: dict) -> list[Group]:
    """Every tensor as ``cfg["formats"]`` stores it: the blocks' 2-D
    weights in ``block``; the embedders, time projection and head (kept
    unquantized in published files) in ``dense``; the modulation tables
    and vectors in F32."""
    c = dims(cfg)
    D, Fd, T, C = c["dim"], c["ffn_dim"], c["text_dim"], c["in_dim"]
    pt, ph, pw = c["patch_size"]
    blk, dense = cfg["formats"]["block"], cfg["formats"]["dense"]
    n = c["num_layers"]
    out = [Group("patch_embedding.weight", (D, C, pt, ph, pw), dense,
                 "matrix"),
           Group("patch_embedding.bias", (D,), "F32", "bias")]

    def lin(key, r, k, fmt, depth=None):
        out.append(Group(key + ".weight", (r, k), fmt, "matrix", depth))
        out.append(Group(key + ".bias", (r,), "F32", "bias", depth))

    lin("text_embedding.0", D, T, dense)
    lin("text_embedding.2", D, D, dense)
    lin("time_embedding.0", D, c["freq_dim"], dense)
    lin("time_embedding.2", D, D, dense)
    lin("time_projection.1", 6 * D, D, dense)
    p = "blocks.{i}."
    out.append(Group(p + "modulation", (1, 6, D), "F32", "table", n))
    for a in ("self_attn", "cross_attn"):
        for m in ("q", "k", "v", "o"):
            lin(f"{p}{a}.{m}", D, D, blk, n)
        for m in ("norm_q", "norm_k"):
            out.append(Group(f"{p}{a}.{m}.weight", (D,), "F32", "qk_gain",
                             n))
    out.append(Group(p + "norm3.weight", (D,), "F32", "gain", n))
    out.append(Group(p + "norm3.bias", (D,), "F32", "bias", n))
    lin(p + "ffn.0", Fd, D, blk, n)
    lin(p + "ffn.2", D, Fd, blk, n)
    out.append(Group("head.modulation", (1, 2, D), "F32", "table"))
    lin("head.head", C * pt * ph * pw, D, dense)
    return out


def build(params: dict, cfg: dict, device):
    from comfyui_gguf_tpu_torch.models.wan import WanConfig
    from comfyui_gguf_tpu_torch.nn.layers import QuantConfig
    from comfyui_gguf_tpu_torch.pipeline import DiffusionModel

    model = DiffusionModel(arch="wan", params=params,
                           config=WanConfig.from_state_dict(params),
                           qcfg=QuantConfig(), device=torch.device(device))
    return model.stack() if cfg["tree"].get("stacked") else model


def latent_shape(cfg: dict, traffic: dict) -> tuple[int, int, int, int]:
    """(F, H, W, C): the VAE's 4× time and 8× space compression."""
    return ((traffic["frames"] - 1) // 4 + 1, traffic["height"] // 8,
            traffic["width"] // 8, dims(cfg)["in_dim"])


def n_tokens(cfg: dict, traffic: dict) -> int:
    F, H, W, _ = latent_shape(cfg, traffic)
    pt, ph, pw = dims(cfg)["patch_size"]
    return (F // pt) * (H // ph) * (W // pw)


def make_engine(model, cfg: dict, traffic: dict):
    from comfyui_gguf_tpu_torch.pipeline import wan_engine

    return wan_engine(model, max_batch=traffic["max_batch"])


def sigmas(cfg: dict, traffic: dict) -> np.ndarray:
    """Linear in σ over ``steps``, time-shifted by ``shift``."""
    s = np.linspace(1.0, 0.0, traffic["steps"] + 1, dtype=np.float64)
    k = float(traffic["shift"])
    return (k * s / (1.0 + (k - 1.0) * s)).astype(np.float32)


def request(gen: torch.Generator, cfg: dict, traffic: dict, device) -> dict:
    """The noise video, and text states for the prompt and the negative
    prompt: N(0, 1) over each prompt's own length (drawn for the prompt,
    fixed for the negative), zero past it, as the UMT5 states with padded
    positions zeroed that the Wan pipeline hands the model."""
    c = dims(cfg)
    Lt, T = traffic["text_tokens"], c["text_dim"]

    def states(n):
        s = torch.randn((Lt, T), generator=gen, device=device,
                        dtype=torch.float32)
        s[n:] = 0
        return s.to(torch.bfloat16)

    lo, hi = traffic["prompt_tokens"]
    n = int(torch.randint(lo, hi + 1, (1,), generator=gen,
                          device=device).item())
    noise = torch.randn(latent_shape(cfg, traffic), generator=gen,
                        device=device, dtype=torch.float32).to(torch.bfloat16)
    cond = {"ctx": states(n), "nctx": states(traffic["negative_tokens"]),
            "cfg_scale": torch.tensor(float(traffic["cfg_scale"]),
                                      dtype=torch.float32, device=device)}
    return {"latent": noise, "cond": cond, "sigmas": sigmas(cfg, traffic)}


def reference(W, cfg: dict, traffic: dict, reqs: list, x, s_cur):
    """([v_cond, v_uncond], the CFG mix) of the reference, float32."""
    import wan_ref

    f32 = torch.float32
    c = dims(cfg)
    x = x.to(f32)
    vc = wan_ref.velocity(W, c, x, torch.stack(
        [r["cond"]["ctx"] for r in reqs]).to(f32), s_cur.to(f32))
    vu = wan_ref.velocity(W, c, x, torch.stack(
        [r["cond"]["nctx"] for r in reqs]).to(f32), s_cur.to(f32))
    g = torch.stack([r["cond"]["cfg_scale"] for r in reqs]).to(f32)
    g = g.reshape(-1, *([1] * (x.ndim - 1)))
    return [vc, vu], vu + g * (vc - vu)


def mix(outs: list, reqs: list):
    """The CFG velocity the engine steps with (conditional and
    unconditional forward outputs, each request's scale), in float64, and
    a bound on the magnitudes its float32 arithmetic adds."""
    vc, vu = outs[0].double(), outs[1].double()
    g = torch.stack([r["cond"]["cfg_scale"] for r in reqs]).double()
    g = g.reshape(-1, *([1] * (vc.ndim - 1)))
    return vu + g * (vc - vu), vu.abs() + g.abs() * (vc.abs() + vu.abs())


def work(cfg: dict, traffic: dict, lanes: int) -> dict:
    """The work of one engine step (the conditional and the unconditional
    forward) over ``lanes`` requests; see models/flux.py ``work``. The
    patch embedding is a convolution, not counted among the linears."""
    c = dims(cfg)
    D, Fd, T, nh = c["dim"], c["ffn_dim"], c["text_dim"], c["num_heads"]
    hd = D // nh
    L, Lt = n_tokens(cfg, traffic), traffic["text_tokens"]
    blk, dense = cfg["formats"]["block"], cfg["formats"]["dense"]
    out_ch = c["in_dim"] * int(np.prod(c["patch_size"]))
    lin, att = [], []

    def mm(tokens, k, r, fmt):
        lin.append(linear_work(lanes * tokens, k, r, fmt))

    for _ in range(2):  # CFG: the conditional and unconditional forward
        mm(Lt, T, D, dense)
        mm(Lt, D, D, dense)
        mm(1, c["freq_dim"], D, dense)
        mm(1, D, D, dense)
        mm(1, D, 6 * D, dense)
        for _ in range(c["num_layers"]):
            for _ in range(4):
                mm(L, D, D, blk)  # self q, k, v, o
            mm(L, D, D, blk)  # cross q
            mm(Lt, D, D, blk)  # cross k
            mm(Lt, D, D, blk)  # cross v
            mm(L, D, D, blk)  # cross o
            mm(L, D, Fd, blk)
            mm(L, Fd, D, blk)
            att.append(attention_work(lanes, nh, L, L, hd))
            att.append(attention_work(lanes, nh, L, Lt, hd))
        mm(L, D, out_ch, dense)
    return {"linear": lin, "attention": att}
