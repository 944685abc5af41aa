"""Tensor-parallel flux forward: the hand-sharded layout.

Every rank runs the stacked flux forward on its own packed shards (the
fused kernels per shard, no dequantized weight anywhere) and calls the
collectives itself. ``flux_engine(mesh=...)`` serves it.

Layout (Megatron-style):

* fused qkv / linear1: column-parallel with head-uniform groups
  (``planarize_shards(..., axis="r", groups=[h, h, h(, mlp)])``): each
  rank owns heads_local = H/tp whole heads of q, k and v, so the joint
  attention runs locally.
* attention proj / linear2 / mlp-down: row-parallel (axis "k"); the
  local attention and activation outputs ARE the matching K chunks, and
  one all-reduce a matmul gives the replicated residual delta.
* modulation: column-parallel and one small all-gather (the (B, 6·h)
  vector modulates the whole hidden stream).
* norm scales, biases after an all-reduce, embedders and the final layer:
  replicated.

Collectives a double block: 4 all-reduces and 2 all-gathers; a single
block: 1 and 1. A shard's K chunk needs only quant-group alignment (32),
not superblock alignment (``planarize_shards``).
"""

from __future__ import annotations

import torch

from ..models.flux import (FluxConfig, _attention, _final, _prelude,
                           _qknorm, _silu, block_view)
from ..nn.layers import (DEFAULT_CONFIG, QuantConfig, layer_norm, linear,
                         linear_gelu)
from . import collectives, tp_spec

AXIS = "tp"
BLOCK_KEYS = ("double_blocks", "single_blocks")


def shard_flux_params(sd: dict, cfg: FluxConfig, tp: int, qtype) -> dict:
    """Flat BFL-keyed f32 state dict → stacked TP-sharded tree (CPU).

    Block leaves lead with (tp, depth, ...): the packed shards bare
    (``planarize_shards``), the biases of column weights split, the rest
    replicated; non-block leaves dense."""
    return tp_spec.shard_stacked_params(
        sd, block_groups=[("double_blocks", cfg.depth_double),
                          ("single_blocks", cfg.depth_single)],
        rules=tp_spec.flux_rules(cfg.hidden, cfg.mlp_ratio), tp=tp,
        qtype=qtype, axis=AXIS, wrap=False)


def shard_packed_flux(sparams: dict, cfg: FluxConfig, tp: int,
                      index: int) -> dict:
    """Shard ``index`` of an already packed ``stack_flux_params`` tree in
    this layout, on the tree's device."""
    return tp_spec.shard_packed_params(
        sparams, block_keys=BLOCK_KEYS,
        rules=tp_spec.flux_rules(cfg.hidden, cfg.mlp_ratio), tp=tp,
        index=index, axis=AXIS, wrap=False)


def place_tp_params(params: dict, mesh, device="cuda") -> dict:
    """This rank's tree on ``device``: its shard of the block subtrees,
    the rest whole."""
    return tp_spec.place_tp_params(params, mesh, BLOCK_KEYS, AXIS, device)


def _gathered_modulation(p, prefix, vec, n, qcfg, mesh):
    local = linear(_silu(vec), p[f"{prefix}.lin.weight"],
                   p.get(f"{prefix}.lin.bias"), cfg=qcfg)
    full = collectives.all_gather(local, AXIS, dim=-1, mesh=mesh)
    return torch.chunk(full[:, None, :], n, dim=-1)


def _psum_linear(x, weight, bias, qcfg, mesh):
    out = collectives.psum(linear(x, weight, cfg=qcfg), AXIS, mesh)
    if bias is not None:
        out = out + bias.to(out.dtype)
    return out


def _split_heads_local(x, n_heads_local):
    B, L, _ = x.shape
    qkv = x.reshape(B, L, 3, n_heads_local, -1)
    return tuple(qkv[:, :, i].transpose(1, 2) for i in range(3))


def _tp_double_block(p, img, txt, vec, pe, cfg: FluxConfig, qcfg, tp: int,
                     mesh):
    Hl = cfg.n_heads // tp
    i_sh1, i_sc1, i_g1, i_sh2, i_sc2, i_g2 = _gathered_modulation(
        p, "img_mod", vec, 6, qcfg, mesh)
    t_sh1, t_sc1, t_g1, t_sh2, t_sc2, t_g2 = _gathered_modulation(
        p, "txt_mod", vec, 6, qcfg, mesh)

    img_mod = layer_norm(img, eps=1e-6) * (1 + i_sc1) + i_sh1
    txt_mod = layer_norm(txt, eps=1e-6) * (1 + t_sc1) + t_sh1

    iq, ik, iv = _split_heads_local(
        linear(img_mod, p["img_attn.qkv.weight"],
               p.get("img_attn.qkv.bias"), cfg=qcfg), Hl)
    tq, tk, tv = _split_heads_local(
        linear(txt_mod, p["txt_attn.qkv.weight"],
               p.get("txt_attn.qkv.bias"), cfg=qcfg), Hl)
    iq, ik = _qknorm(p, "img_attn.norm", iq, ik)
    tq, tk = _qknorm(p, "txt_attn.norm", tq, tk)

    q = torch.cat([tq, iq], dim=2)
    k = torch.cat([tk, ik], dim=2)
    v = torch.cat([tv, iv], dim=2)
    attn = _attention(q, k, v, pe)  # (B, L, Hl·d): the local heads
    L_txt = txt.shape[1]
    txt_attn, img_attn = attn[:, :L_txt], attn[:, L_txt:]

    img = img + i_g1 * _psum_linear(img_attn, p["img_attn.proj.weight"],
                                    p.get("img_attn.proj.bias"), qcfg, mesh)
    h = layer_norm(img, eps=1e-6) * (1 + i_sc2) + i_sh2
    # bias and GELU in the shard's kernel epilogue (elementwise, so exact
    # per shard)
    h = linear_gelu(h, p["img_mlp.0.weight"], p.get("img_mlp.0.bias"),
                    cfg=qcfg)
    img = img + i_g2 * _psum_linear(h, p["img_mlp.2.weight"],
                                    p.get("img_mlp.2.bias"), qcfg, mesh)

    txt = txt + t_g1 * _psum_linear(txt_attn, p["txt_attn.proj.weight"],
                                    p.get("txt_attn.proj.bias"), qcfg, mesh)
    h = layer_norm(txt, eps=1e-6) * (1 + t_sc2) + t_sh2
    h = linear_gelu(h, p["txt_mlp.0.weight"], p.get("txt_mlp.0.bias"),
                    cfg=qcfg)
    txt = txt + t_g2 * _psum_linear(h, p["txt_mlp.2.weight"],
                                    p.get("txt_mlp.2.bias"), qcfg, mesh)
    return img, txt


def _tp_single_block(p, x, vec, pe, cfg: FluxConfig, qcfg, tp: int, mesh):
    Hl = cfg.n_heads // tp
    h_loc = cfg.hidden // tp
    shift, scale, gate = _gathered_modulation(p, "modulation", vec, 3, qcfg,
                                              mesh)
    x_mod = layer_norm(x, eps=1e-6) * (1 + scale) + shift
    # GELU in the kernel epilogue from the local mlp tail
    hid = linear_gelu(x_mod, p["linear1.weight"], p.get("linear1.bias"),
                      tail_from=3 * h_loc, cfg=qcfg)
    qkv, act = hid[..., : 3 * h_loc], hid[..., 3 * h_loc:]
    q, k, v = _split_heads_local(qkv, Hl)
    q, k = _qknorm(p, "norm", q, k)
    attn = _attention(q, k, v, pe)
    out = _psum_linear(torch.cat([attn, act], dim=-1), p["linear2.weight"],
                       p.get("linear2.bias"), qcfg, mesh)
    return x + gate * out


def tp_forward_stacked(params: dict, cfg: FluxConfig, img, img_ids, txt,
                       txt_ids, timesteps, y, guidance=None, mesh=None,
                       qcfg: QuantConfig = DEFAULT_CONFIG) -> torch.Tensor:
    """``forward_stacked`` on this rank's shards (``place_tp_params``):
    one loop over depth, per-shard fused kernels, all-reduces and
    all-gathers over the tp axis. Inputs and output replicated."""
    tp = collectives.axis_size(AXIS, mesh)
    img, txt, vec, pe = _prelude(params, cfg, img, img_ids, txt, txt_ids,
                                 timesteps, y, guidance, qcfg)
    for i in range(cfg.depth_double):
        img, txt = _tp_double_block(block_view(params["double_blocks"], i),
                                    img, txt, vec, pe, cfg, qcfg, tp, mesh)
    x = torch.cat([txt, img], dim=1)
    for i in range(cfg.depth_single):
        x = _tp_single_block(block_view(params["single_blocks"], i), x, vec,
                             pe, cfg, qcfg, tp, mesh)
    img = x[:, txt.shape[1]:]
    return _final(params, img, vec, qcfg)
