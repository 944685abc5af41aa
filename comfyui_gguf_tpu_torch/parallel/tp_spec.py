"""Spec-driven tensor parallelism: one sharding table per architecture.

A per-arch table maps each block weight to a shard mode; the generic
sharder pre-splits the packed planar weights accordingly
(``quant.planar.planarize_shards``), and the model's own, unmodified
``forward_stacked`` runs on each rank's shard inside
``collectives.active(mesh)``: ``nn.layers.linear`` runs the collectives
off the marker leaves (``quant.planar.TPShard`` / ``TPNormShard``).

* ``"col"``: out-features split, the output stays local (qkv, mlp-up).
* ``"row"``: in-features split, one all-reduce replicates the output
  (attention out, mlp-down); the bias is added after it.
* ``"gather"``: a column split and a tiled all-gather (modulation
  projections that modulate the whole hidden stream).
* ``"normshard"``: a full-width norm scale over a column-split activation
  (Wan's q/k RMS norms before the head split): the scale splits and the
  statistics reduce over the axis.

Everything the table does not name is replicated; a bias follows its
weight (split for col/gather, replicated for row). The collectives: one
all-reduce per attention, one per MLP, one small all-gather per
modulation.

The w8a8 path composes: ``quant.i8.convert_tree_i8`` sees through
``TPShard`` and requantizes each shard on its own (its own column
scales), so the same table serves the int8 tree. ``i8_plan_report`` gives
the per-shard bytes of a full conversion without building the model.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from ..lifecycle import to_device
from ..quant import codecs
from ..quant.planar import (PlanarQuant, TPNormShard, TPShard, _stack_shards,
                            planarize, planarize_shards, shard_planar,
                            shard_view)
from . import collectives

AXIS = "tp"


@dataclasses.dataclass(frozen=True)
class ShardRule:
    """How one block weight shards: a mode and, for fused weights, the
    segment groups (a fused qkv splits head-uniformly with groups (h, h,
    h), so each shard owns whole heads of q, k and v)."""

    mode: str  # "col" | "row" | "gather" | "normshard"
    groups: tuple[int, ...] | None = None


def _as_f32(w) -> np.ndarray:
    """Dense f32 numpy view of a leaf: a ``loader.QTensor``, a tensor or
    an array."""
    if hasattr(w, "is_quantized"):  # loader.QTensor
        return w.dequantize(np.float32)
    if isinstance(w, torch.Tensor):
        return w.detach().to(torch.float32).cpu().numpy()
    return np.asarray(w, np.float32)


def _split_dense(w, tp: int, groups=None) -> np.ndarray:
    """(R, ...) dense → (tp, R/tp, ...), honouring segment groups on R."""
    w = _as_f32(w)
    if groups is None:
        return np.stack(np.split(w, tp, axis=0))
    parts, base = [], 0
    for g in groups:
        parts.append(np.split(w[base: base + g], tp, axis=0))
        base += g
    return np.stack([np.concatenate([p[s] for p in parts], axis=0)
                     for s in range(tp)])


def _pack_shards(w, qtype, tp: int, mode: str, groups) -> PlanarQuant:
    """Shard-planarize one weight. A quantized ``loader.QTensor`` shards
    its own packed blocks (no decode and re-encode: a real checkpoint's
    codec values); f32 arrays and float QTensors encode with ``qtype``
    first."""
    axis = "k" if mode == "row" else "r"
    glist = None if groups is None else list(groups)
    if hasattr(w, "is_quantized") and w.is_quantized:
        return planarize_shards(w.data, w.qtype, w.shape, tp, axis=axis,
                                groups=glist)
    w = _as_f32(w)
    return planarize_shards(codecs.quantize(w, qtype), qtype, w.shape, tp,
                            axis=axis, groups=glist)


def _bias_rule(rules: dict, suffix: str):
    if suffix.endswith(".bias"):
        return rules.get(suffix[: -len(".bias")] + ".weight")
    return None


def shard_stacked_params(sd: dict, *, block_groups, rules: dict, tp: int,
                         qtype, axis: str = AXIS, wrap: bool = True) -> dict:
    """Flat f32 state dict → TP-sharded stacked param tree (CPU tensors).

    ``block_groups``: [(out_key, depth), ...]: blocks live under
    ``{out_key}.{i}.``. ``rules``: {block suffix → ShardRule}; a matching
    ``.bias`` splits or replicates with its weight. Block leaves lead with
    (tp, depth, ...), non-block keys stay dense f32 (replicated): the
    layout of ``stack_block_groups`` plus a leading shard axis, so a
    rank's ``shard_view`` feeds the model's own ``forward_stacked``.
    ``wrap=False`` leaves the packed shards bare (``tp_flux``'s layout,
    whose blocks call the collectives themselves).
    """
    prefixes = tuple(f"{g[0]}." for g in block_groups)
    params = {k: torch.from_numpy(_as_f32(v).copy())
              for k, v in sd.items() if not k.startswith(prefixes)}
    for out_key, depth in block_groups:
        suffixes = sorted({k[len(f"{out_key}.0."):]
                           for k in sd if k.startswith(f"{out_key}.0.")})
        sub = {}
        for suffix in suffixes:
            per = [sd[f"{out_key}.{i}.{suffix}"] for i in range(depth)]
            rule, wrule = rules.get(suffix), _bias_rule(rules, suffix)
            if (rule is not None and rule.mode == "normshard") or (
                    wrule is not None and wrule.mode == "normshard"):
                # a full-width sharded norm's scale, or its bias sibling
                st = np.stack([_split_dense(w, tp) for w in per], axis=1)
                sub[suffix] = TPNormShard(
                    weight=torch.from_numpy(st), axis=axis,
                    full_dim=int(_as_f32(per[0]).shape[0]))
            elif rule is not None:
                stacked = _stack_shards([_pack_shards(
                    w, qtype, tp, rule.mode, rule.groups) for w in per], 1)
                sub[suffix] = (TPShard(inner=stacked, mode=rule.mode,
                                       axis=axis) if wrap else stacked)
            elif wrule is not None and wrule.mode in ("col", "gather"):
                st = np.stack([_split_dense(w, tp, wrule.groups)
                               for w in per], axis=1)  # (tp, depth, R/tp)
                sub[suffix] = torch.from_numpy(st)
            else:  # replicated, biases of row weights among them
                st = torch.from_numpy(np.stack([_as_f32(w) for w in per]))
                sub[suffix] = st[None].expand(tp, *st.shape)
        params[out_key] = sub
    return params


def shard_flat_block(sub: dict, rules: dict, tp: int, qtype,
                     axis: str = AXIS) -> dict:
    """Shard ONE unstacked block subtree (suffix-keyed): leaves lead with
    (tp, ...) and no depth axis, for blocks outside the stacked walk
    (sd3's pre-only last block, lumina2's refiners)."""
    out = {}
    for suffix, v in sub.items():
        rule, wrule = rules.get(suffix), _bias_rule(rules, suffix)
        if (rule is not None and rule.mode == "normshard") or (
                wrule is not None and wrule.mode == "normshard"):
            w = _as_f32(v)
            out[suffix] = TPNormShard(
                weight=torch.from_numpy(_split_dense(w, tp)), axis=axis,
                full_dim=int(w.shape[0]))
        elif rule is not None:
            out[suffix] = TPShard(
                inner=_pack_shards(v, qtype, tp, rule.mode, rule.groups),
                mode=rule.mode, axis=axis)
        elif wrule is not None and wrule.mode in ("col", "gather"):
            out[suffix] = torch.from_numpy(_split_dense(v, tp, wrule.groups))
        else:
            w = torch.from_numpy(_as_f32(v).copy())
            out[suffix] = w[None].expand(tp, *w.shape)
    return out


def _split_last(t: torch.Tensor, tp: int, groups, index: int):
    """Shard ``index`` of a dense (..., R) leaf split on its last axis,
    honouring segment groups (``_split_dense`` on the last axis)."""
    R = t.shape[-1]
    groups = [R] if groups is None else list(groups)
    parts, base = [], 0
    for g in groups:
        per = g // tp
        parts.append(t[..., base + index * per: base + (index + 1) * per])
        base += g
    return parts[0] if len(parts) == 1 else torch.cat(parts, dim=-1)


def shard_packed_params(sparams: dict, *, block_keys, rules: dict, tp: int,
                        index: int, axis: str = AXIS,
                        wrap: bool = True) -> dict:
    """Shard ``index`` of an already packed stacked tree (the
    ``stack_block_groups`` layout, e.g. a loaded model's or a seed-made
    one), on the tree's own device: the packed leaves the rules name split
    with ``shard_planar`` (the bytes ``planarize_shards`` gives from the
    same blocks), their biases and the normshard scales split, the rest
    kept whole. The result feeds ``tp_run`` (or, ``wrap=False``,
    ``tp_flux``) on the rank that owns shard ``index``."""
    out = {k: v for k, v in sparams.items() if k not in block_keys}
    for key in block_keys:
        sub = {}
        for suffix, v in sparams[key].items():
            rule, wrule = rules.get(suffix), _bias_rule(rules, suffix)
            if (rule is not None and rule.mode == "normshard") or (
                    wrule is not None and wrule.mode == "normshard"):
                sub[suffix] = TPNormShard(
                    weight=_split_last(v, tp, None, index), axis=axis,
                    full_dim=int(v.shape[-1]))
            elif rule is not None:
                pq = shard_planar(v, tp, "k" if rule.mode == "row" else "r",
                                  rule.groups, index=index)
                sub[suffix] = (TPShard(inner=pq, mode=rule.mode, axis=axis)
                               if wrap else pq)
            elif wrule is not None and wrule.mode in ("col", "gather"):
                sub[suffix] = _split_last(v, tp, wrule.groups, index)
            else:
                sub[suffix] = v
        out[key] = sub
    return out


def quantize_unsharded(sd: dict, *, block_groups, rules: dict, qtype,
                       flat_block_prefixes=()) -> dict:
    """The unsharded twin of ``shard_stacked_params``: the rule-named
    weights of the same f32 state dict quantized to the same codec blocks
    (a flat tree), so a TP forward can be held to the plain forward.
    ``flat_block_prefixes``: block families outside the stacked groups
    (lumina2's refiners)."""
    prefixes = (tuple(f"{g[0]}." for g in block_groups)
                + tuple(flat_block_prefixes))
    out = {}
    for k, v in sd.items():
        suffix = None
        for p in prefixes:
            if k.startswith(p):
                suffix = k.split(".", 2)[2]
        rule = rules.get(suffix) if suffix else None
        w = _as_f32(v)
        if rule is not None and rule.mode != "normshard":
            out[k] = planarize(codecs.quantize(w, qtype), qtype, w.shape)
        else:
            out[k] = torch.from_numpy(w.copy())
    return out


def place_tp_params(params: dict, mesh, block_keys, axis: str = AXIS,
                    device="cuda") -> dict:
    """This rank's tree on ``device``: each block subtree's shard (views
    of the leading axis, then one copy to the device), everything else
    whole."""
    r = collectives.axis_index(axis, mesh)

    def local(tree):
        if isinstance(tree, dict):
            return {k: local(v) for k, v in tree.items()}
        return shard_view(tree, r)

    return to_device({k: local(v) if k in block_keys else v
                      for k, v in params.items()}, device)


def tp_run(forward_stacked, params: dict, cfg, inputs: tuple, *, mesh,
           block_keys=(), qcfg, axis: str = AXIS):
    """A model's unmodified ``forward_stacked`` on this rank's shard.

    ``cfg`` must be the shard-local config (heads divided by tp; see the
    per-arch wrappers) and ``params`` this rank's tree
    (``place_tp_params``); the marker leaves run the collectives. Inputs
    and output are replicated."""
    with collectives.active(mesh):
        return forward_stacked(params, cfg, *inputs, qcfg=qcfg)


def _local_cfg(cfg, mesh, **extra):
    tp = collectives.axis_size(AXIS, mesh)
    return dataclasses.replace(cfg, n_heads=cfg.n_heads // tp, **extra)


# ---------------------------------------------------------------------------
# architecture tables
# ---------------------------------------------------------------------------

def qwen_image_rules() -> dict:
    """Qwen-Image MMDiT: separate q/k/v per stream (contiguous column
    splits keep whole heads local), row out-projections and mlp-downs,
    gathered 6-chunk modulations. The per-head RMS norms (hd,) replicate."""
    r = {}
    for n in ("to_q", "to_k", "to_v", "add_q_proj", "add_k_proj",
              "add_v_proj"):
        r[f"attn.{n}.weight"] = ShardRule("col")
    r["attn.to_out.0.weight"] = ShardRule("row")
    r["attn.to_add_out.weight"] = ShardRule("row")
    for s in ("img", "txt"):
        r[f"{s}_mod.1.weight"] = ShardRule("gather")
        r[f"{s}_mlp.net.0.proj.weight"] = ShardRule("col")
        r[f"{s}_mlp.net.2.weight"] = ShardRule("row")
    return r


def shard_qwen_image_params(sd: dict, cfg, tp: int, qtype) -> dict:
    return shard_stacked_params(
        sd, block_groups=[("transformer_blocks", cfg.n_layers)],
        rules=qwen_image_rules(), tp=tp, qtype=qtype)


def tp_qwen_image_forward(params: dict, cfg, img, img_ids, txt, txt_ids,
                          timesteps, *, mesh, qcfg):
    from ..models import qwen_image

    return tp_run(qwen_image.forward_stacked, params, _local_cfg(cfg, mesh),
                  (img, img_ids, txt, txt_ids, timesteps), mesh=mesh,
                  qcfg=qcfg)


def wan_rules() -> dict:
    """Wan 2.1: q/k/v column, o row for self and cross attention, ffn
    col → row. Wan's full-width q/k RMS norms come before the head split,
    so their scales shard as ``normshard``. The modulation table and norm3
    act on the replicated stream and replicate."""
    r = {}
    for a in ("self_attn", "cross_attn"):
        for n in ("q", "k", "v"):
            r[f"{a}.{n}.weight"] = ShardRule("col")
        r[f"{a}.o.weight"] = ShardRule("row")
        r[f"{a}.norm_q.weight"] = ShardRule("normshard")
        r[f"{a}.norm_k.weight"] = ShardRule("normshard")
    r["ffn.0.weight"] = ShardRule("col")
    r["ffn.2.weight"] = ShardRule("row")
    return r


def shard_wan_params(sd: dict, cfg, tp: int, qtype) -> dict:
    return shard_stacked_params(
        sd, block_groups=[("blocks", cfg.n_layers)], rules=wan_rules(),
        tp=tp, qtype=qtype)


def tp_wan_forward(params: dict, cfg, latent, context, timesteps, *, mesh,
                   qcfg):
    from ..models import wan

    return tp_run(wan.forward_stacked, params,
                  _local_cfg(cfg, mesh, head_dim_override=cfg.head_dim),
                  (latent, context, timesteps), mesh=mesh, qcfg=qcfg)


def aura_rules() -> dict:
    """AuraFlow: per-stream q/k/v column, o row, gathered modulations,
    the gated MLP's c_fc1/c_fc2 column with the same split (the local gate
    product aligns) and c_proj row. The per-head q/k layer norms have no
    affine."""
    r = {}
    for mod in ("modC.1.weight", "modX.1.weight", "modCX.1.weight",
                "modF.1.weight"):
        r[mod] = ShardRule("gather")
    for w in ("w1q", "w1k", "w1v", "w2q", "w2k", "w2v"):
        r[f"attn.{w}.weight"] = ShardRule("col")
    r["attn.w1o.weight"] = ShardRule("row")
    r["attn.w2o.weight"] = ShardRule("row")
    for m in ("mlpC", "mlpX", "mlp"):
        r[f"{m}.c_fc1.weight"] = ShardRule("col")
        r[f"{m}.c_fc2.weight"] = ShardRule("col")
        r[f"{m}.c_proj.weight"] = ShardRule("row")
    return r


def shard_aura_params(sd: dict, cfg, tp: int, qtype) -> dict:
    return shard_stacked_params(
        sd, block_groups=[("double_layers", cfg.depth_double),
                          ("single_layers", cfg.depth_single)],
        rules=aura_rules(), tp=tp, qtype=qtype)


def tp_aura_forward(params: dict, cfg, latent, cond, timesteps, *, mesh,
                    qcfg):
    from ..models import aura

    return tp_run(aura.forward_stacked, params, _local_cfg(cfg, mesh),
                  (latent, cond, timesteps), mesh=mesh, qcfg=qcfg)


def cosmos_rules() -> dict:
    """Cosmos: q/k/v column (the cross k/v read the replicated text),
    output row, mlp col → row, gathered 3-chunk adaLN modulations; the
    per-head RMS q/k norms (hd,) replicate."""
    r = {}
    for m in ("self_attn", "cross_attn", "mlp"):
        r[f"adaln_modulation_{m}.1.weight"] = ShardRule("gather")
    for a in ("self_attn", "cross_attn"):
        for n in ("q_proj", "k_proj", "v_proj"):
            r[f"{a}.{n}.weight"] = ShardRule("col")
        r[f"{a}.output_proj.weight"] = ShardRule("row")
    r["mlp.layer1.weight"] = ShardRule("col")
    r["mlp.layer2.weight"] = ShardRule("row")
    return r


def shard_cosmos_params(sd: dict, cfg, tp: int, qtype) -> dict:
    return shard_stacked_params(
        sd, block_groups=[("blocks", cfg.n_layers)], rules=cosmos_rules(),
        tp=tp, qtype=qtype)


def tp_cosmos_forward(params: dict, cfg, latent, context, timesteps, *,
                      mesh, qcfg):
    from ..models import cosmos

    return tp_run(cosmos.forward_stacked, params,
                  _local_cfg(cfg, mesh, head_dim_override=cfg.head_dim),
                  (latent, context, timesteps), mesh=mesh, qcfg=qcfg)


def flux_rules(hidden: int, mlp_ratio: float = 4.0) -> dict:
    """Flux through the generic table (``tp_flux`` is the hand layout):
    fused qkv head groups on the double blocks, the single blocks' fused
    [q|k|v|mlp] with a shape-derived local boundary, gathered
    modulations."""
    h, m = hidden, int(hidden * mlp_ratio)
    r = {}
    for s in ("img", "txt"):
        r[f"{s}_mod.lin.weight"] = ShardRule("gather")
        r[f"{s}_attn.qkv.weight"] = ShardRule("col", (h, h, h))
        r[f"{s}_attn.proj.weight"] = ShardRule("row")
        r[f"{s}_mlp.0.weight"] = ShardRule("col")
        r[f"{s}_mlp.2.weight"] = ShardRule("row")
    r["modulation.lin.weight"] = ShardRule("gather")
    r["linear1.weight"] = ShardRule("col", (h, h, h, m))
    r["linear2.weight"] = ShardRule("row", (h, m))
    return r


def shard_flux_params(sd: dict, cfg, tp: int, qtype) -> dict:
    return shard_stacked_params(
        sd, block_groups=[("double_blocks", cfg.depth_double),
                          ("single_blocks", cfg.depth_single)],
        rules=flux_rules(cfg.hidden, cfg.mlp_ratio), tp=tp, qtype=qtype)


def tp_flux_forward(params: dict, cfg, img, img_ids, txt, txt_ids,
                    timesteps, y, guidance=None, *, mesh, qcfg):
    from ..models import flux

    return tp_run(flux.forward_stacked, params, _local_cfg(cfg, mesh),
                  (img, img_ids, txt, txt_ids, timesteps, y)
                  + ((guidance,) if guidance is not None else ()),
                  mesh=mesh, qcfg=qcfg)


def hyvid_rules(hidden: int, mlp_ratio: float = 4.0) -> dict:
    """HunyuanVideo: flux-lineage double blocks (fused qkv head groups,
    row proj/mlp-down, gathered modulations) and single blocks whose
    linear1 fuses [q|k|v|mlp] (the model derives the local boundary from
    the shard's width) and linear2 contracts [attn|mlp] with matching row
    groups. The token refiner (txt_in.*) is non-block and replicated."""
    h, m = hidden, int(hidden * mlp_ratio)
    r = {}
    for s in ("img", "txt"):
        r[f"{s}_mod.linear.weight"] = ShardRule("gather")
        r[f"{s}_attn_qkv.weight"] = ShardRule("col", (h, h, h))
        r[f"{s}_attn_proj.weight"] = ShardRule("row")
        r[f"{s}_mlp.fc1.weight"] = ShardRule("col")
        r[f"{s}_mlp.fc2.weight"] = ShardRule("row")
    r["modulation.linear.weight"] = ShardRule("gather")
    r["linear1.weight"] = ShardRule("col", (h, h, h, m))
    r["linear2.weight"] = ShardRule("row", (h, m))
    return r


def shard_hyvid_params(sd: dict, cfg, tp: int, qtype) -> dict:
    return shard_stacked_params(
        sd, block_groups=[("double_blocks", cfg.depth_double),
                          ("single_blocks", cfg.depth_single)],
        rules=hyvid_rules(cfg.hidden, cfg.mlp_ratio), tp=tp, qtype=qtype)


def tp_hyvid_forward(params: dict, cfg, latent, txt, timesteps, guidance, *,
                     mesh, qcfg):
    from ..models import hyvid

    return tp_run(hyvid.forward_stacked, params,
                  _local_cfg(cfg, mesh, head_dim_override=cfg.head_dim),
                  (latent, txt, timesteps, guidance), mesh=mesh, qcfg=qcfg)


def lumina2_rules(dim: int) -> dict:
    """Lumina Image 2.0: fused qkv head-uniform, SwiGLU w1/w3 column (the
    local gate aligns) and w2 row, gathered 4-chunk adaLN. The per-head
    RMS q/k norms and the stream-wide norms replicate."""
    return {
        "attention.qkv.weight": ShardRule("col", (dim, dim, dim)),
        "attention.out.weight": ShardRule("row"),
        "feed_forward.w1.weight": ShardRule("col"),
        "feed_forward.w3.weight": ShardRule("col"),
        "feed_forward.w2.weight": ShardRule("row"),
        "adaLN_modulation.1.weight": ShardRule("gather"),
    }


def lumina2_tp_block_keys(params: dict) -> tuple:
    """The sharded top-level keys of a lumina2 tree: the stacked main
    layers and every (flat-keyed) refiner-block leaf."""
    return tuple(k for k in params
                 if k == "layers"
                 or k.startswith(("noise_refiner.", "context_refiner.")))


def shard_lumina2_params(sd: dict, cfg, tp: int, qtype) -> dict:
    """The main layers stack; the refiner blocks run unrolled in the
    prelude under their flat keys, so they shard through
    ``shard_flat_block`` keeping those keys."""
    rules = lumina2_rules(cfg.dim)
    is_ref = lambda k: k.startswith(("noise_refiner.",  # noqa: E731
                                     "context_refiner."))
    params = shard_stacked_params(
        {k: v for k, v in sd.items() if not is_ref(k)},
        block_groups=[("layers", cfg.n_layers)], rules=rules, tp=tp,
        qtype=qtype)
    prefixes = sorted({".".join(k.split(".")[:2]) + "."
                       for k in sd if is_ref(k)})
    for pre in prefixes:
        sub = shard_flat_block(
            {k[len(pre):]: v for k, v in sd.items() if k.startswith(pre)},
            rules, tp, qtype)
        for s, v in sub.items():
            params[pre + s] = v
    return params


def tp_lumina2_forward(params: dict, cfg, latent, cap, timesteps, *, mesh,
                       qcfg):
    from ..models import lumina2

    return tp_run(lumina2.forward_stacked, params,
                  _local_cfg(cfg, mesh, head_dim_override=cfg.head_dim),
                  (latent, cap, timesteps), mesh=mesh, qcfg=qcfg)


def sd3_rules(hidden: int) -> dict:
    """SD3/SD3.5 MMDiT: fused qkv head-uniform, proj/mlp-down row, the
    per-block adaLN modulations gathered; the per-head RMS q/k norm scales
    replicate. The pre-only last block shards too and runs outside the
    stacked walk."""
    h = hidden
    r = {}
    for s in ("x_block", "context_block"):
        r[f"{s}.attn.qkv.weight"] = ShardRule("col", (h, h, h))
        r[f"{s}.attn.proj.weight"] = ShardRule("row")
        r[f"{s}.attn2.qkv.weight"] = ShardRule("col", (h, h, h))
        r[f"{s}.attn2.proj.weight"] = ShardRule("row")
        r[f"{s}.mlp.fc1.weight"] = ShardRule("col")
        r[f"{s}.mlp.fc2.weight"] = ShardRule("row")
        r[f"{s}.adaLN_modulation.1.weight"] = ShardRule("gather")
    return r


def shard_sd3_params(sd: dict, cfg, tp: int, qtype) -> dict:
    """sd3's stacked layout: the homogeneous prefix of depth − 1 blocks,
    and the pre-only last block flat under "joint_blocks_last"."""
    rules = sd3_rules(cfg.hidden)
    last_pre = f"joint_blocks.{cfg.depth - 1}."
    params = shard_stacked_params(
        {k: v for k, v in sd.items() if not k.startswith(last_pre)},
        block_groups=[("joint_blocks", cfg.depth - 1)], rules=rules, tp=tp,
        qtype=qtype)
    params["joint_blocks_last"] = shard_flat_block(
        {k[len(last_pre):]: v for k, v in sd.items()
         if k.startswith(last_pre)}, rules, tp, qtype)
    return params


def tp_sd3_forward(params: dict, cfg, latent, context, pooled, timesteps, *,
                   mesh, qcfg):
    from ..models import sd3

    return tp_run(sd3.forward_stacked, params, _local_cfg(cfg, mesh),
                  (latent, context, pooled, timesteps), mesh=mesh,
                  qcfg=qcfg)


def hidream_rules(n_experts: int) -> dict:
    """HiDream-I1 MoE MMDiT: per-stream q/k/v (and their ``_t`` twins)
    column, out-projections row, the adaLN gathered; every SwiGLU (the
    shared expert, each routed expert and the text ff_t) splits w1/w3
    column and w2 row. The router gate and the per-head q/k norms
    replicate. The MoE runs the dense dispatch over flat per-expert keys,
    each expert's w2 with its own all-reduce (exact: masked probabilities
    are zero off the top k)."""
    r = {"block.adaLN_modulation.1.weight": ShardRule("gather")}
    for t in ("", "_t"):
        for n in ("to_q", "to_k", "to_v"):
            r[f"block.attn1.{n}{t}.weight"] = ShardRule("col")
        r[f"block.attn1.to_out{t}.weight"] = ShardRule("row")
    for pre in (["block.ff_i.shared_experts", "block.ff_t"]
                + [f"block.ff_i.experts.{e}" for e in range(n_experts)]):
        r[f"{pre}.w1.weight"] = ShardRule("col")
        r[f"{pre}.w3.weight"] = ShardRule("col")
        r[f"{pre}.w2.weight"] = ShardRule("row")
    return r


def shard_hidream_params(sd: dict, cfg, tp: int, qtype) -> dict:
    # HiDream-I1 has 20 heads: refuse a tp they do not divide before the
    # shard build
    if cfg.n_heads % tp:
        raise ValueError(
            f"hidream TP requires n_heads % tp == 0 (heads "
            f"{cfg.n_heads}, tp {tp}); HiDream-I1's 20 heads allow "
            "tp in {1, 2, 4, 5, 10, 20}")
    return shard_stacked_params(
        sd, block_groups=[("double_stream_blocks", cfg.depth_double),
                          ("single_stream_blocks", cfg.depth_single)],
        rules=hidream_rules(cfg.n_experts), tp=tp, qtype=qtype)


def tp_hidream_forward(params: dict, cfg, latent, t5_states, llama_states,
                       pooled, timesteps, *, mesh, qcfg):
    from ..models import hidream

    tp = collectives.axis_size(AXIS, mesh)
    if cfg.n_heads % tp:
        raise ValueError(f"hidream TP requires n_heads % tp == 0 "
                         f"(heads {cfg.n_heads}, tp {tp})")
    return tp_run(hidream.forward_stacked, params, _local_cfg(cfg, mesh),
                  (latent, t5_states, llama_states, pooled, timesteps),
                  mesh=mesh, qcfg=qcfg)


# ---------------------------------------------------------------------------
# the per-shard bytes of a w8a8 conversion
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _components_of(qtype):
    """(group size, has offsets, zero point) of a planarizable format."""
    probe = np.linspace(-1.0, 1.0, 512, dtype=np.float32)
    comp = codecs.COMPONENT_EXTRACTORS[qtype](codecs.quantize(probe, qtype))
    return comp.group_size, comp.offsets is not None, comp.zero_point


def _meta_planar(qtype, R: int, K: int) -> PlanarQuant:
    """A ``PlanarQuant`` of shape (R, K) on the meta device: the padding
    and byte layout of a real one, no storage."""
    from ..quant.planar import _NIB4_TYPES, padded_in_dim, padded_out_dim

    gs, has_offsets, zero_point = _components_of(qtype)
    kp, rp = padded_in_dim(K, qtype, gs), padded_out_dim(R)
    nib4 = qtype in _NIB4_TYPES
    plane = torch.empty((kp // gs, rp), dtype=torch.float32, device="meta")
    return PlanarQuant(
        qs=torch.empty((kp // 2 if nib4 else kp, rp),
                       dtype=torch.uint8 if nib4 else torch.int8,
                       device="meta"),
        scales=plane, offsets=plane if has_offsets else None,
        qtype=int(qtype), layout="nib4" if nib4 else "int8", group_size=gs,
        zero_point=zero_point, shape=(R, K))


def i8_plan_report(shape_spec_groups: dict, rules: dict, tp: int,
                   qtype) -> dict:
    """The per-shard bytes of a full w8a8 conversion of the rule-named
    weights at a given tp, without building the model: each shard's planar
    padding (``quant.planar``) and int8 footprint (``quant.i8._leaf_bytes``)
    from the shape spec alone.

    shape_spec_groups: {out_key: (depth, {suffix: shape})} (the
    ``models.testing`` *_shape_spec format). Returns bytes:
    {"planar_per_shard", "i8_per_shard", "planar_total", "i8_total",
    "n_weights", "tp"}.
    """
    from ..quant.i8 import _leaf_bytes

    qtype = codecs.GGMLQuantizationType(qtype)
    tot_p = tot_i = n = 0
    for _, (depth, suffixes) in shape_spec_groups.items():
        for suffix, shape in suffixes.items():
            rule = rules.get(suffix)
            if rule is None or rule.mode == "normshard":
                continue
            R, K = int(shape[0]), int(shape[1])
            if rule.mode in ("col", "gather"):
                R //= tp
            else:
                K //= tp
            pb, ib = _leaf_bytes(_meta_planar(qtype, R, K))
            tot_p += depth * pb
            tot_i += depth * ib
            n += depth
    return {"planar_per_shard": tot_p, "i8_per_shard": tot_i,
            "planar_total": tot_p * tp, "i8_total": tot_i * tp,
            "n_weights": n, "tp": tp}
