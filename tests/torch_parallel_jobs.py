"""Jobs the port's parallel tests run on gloo ranks (``parallel.launch``).

Under ``spawn`` each rank imports this module to find a job, so it
imports the port and torch only: never JAX, never a test module (they
pull in ``conftest.py``). Every job builds its mesh, takes its rank's
share of the inputs, runs the port and returns numpy arrays.
"""

from __future__ import annotations

import numpy as np
import torch

from comfyui_gguf_tpu_torch.parallel import collectives
from comfyui_gguf_tpu_torch.parallel import mesh as pmesh


def _np(t):
    return t.detach().to(torch.float32).cpu().numpy()


def _mesh(tp=None):
    collectives.reset_stats()
    return pmesh.make_mesh(tp=tp)


def rank_info(tp=None):
    m = _mesh(tp)
    return (collectives.axis_index("dp", m), collectives.axis_index("tp", m),
            collectives.axis_size("dp", m), collectives.axis_size("tp", m),
            collectives.backend("tp", m))


def collective_ops(x):
    """psum, all_gather and a ring shift of each rank's x · (rank + 1)."""
    m = _mesh()
    r = collectives.axis_index("tp", m)
    mine = x * (r + 1)
    return (_np(collectives.psum(mine, "tp", m)),
            _np(collectives.all_gather(mine, "tp", dim=-1, mesh=m)),
            _np(collectives.ppermute(mine, "tp", 1, m)))


def tp_linear(kind, stacked, x, bias, cfg, gelu_tail=None):
    """``layers.linear`` / ``linear_gelu`` on this rank's shard of a
    shard-stacked weight wrapped as ``TPShard(kind)``; a row weight takes
    this rank's K chunk of x."""
    from comfyui_gguf_tpu_torch.nn import layers
    from comfyui_gguf_tpu_torch.quant.planar import TPShard, shard_view

    m = _mesh()
    r, n = collectives.axis_index("tp", m), collectives.axis_size("tp", m)
    w = TPShard(shard_view(stacked, r), kind, "tp")
    if kind == "row":
        k = x.shape[-1] // n
        x = x[..., r * k:(r + 1) * k]
    elif bias is not None:
        b = bias.shape[-1] // n
        bias = bias[..., r * b:(r + 1) * b]
    with collectives.active(m):
        if gelu_tail is None:
            out = layers.linear(x, w, bias, cfg=cfg)
        else:
            out = layers.linear_gelu(x, w, bias, tail_from=gelu_tail,
                                     cfg=cfg)
    return _np(out)


def tp_norms(x, scale, bias):
    """layer_norm and rms_norm over a feature-sharded x with
    ``TPNormShard`` scales."""
    from comfyui_gguf_tpu_torch.nn import layers
    from comfyui_gguf_tpu_torch.quant.planar import TPNormShard

    m = _mesh()
    r, n = collectives.axis_index("tp", m), collectives.axis_size("tp", m)
    d = x.shape[-1] // n
    part = slice(r * d, (r + 1) * d)
    w = TPNormShard(scale[part], "tp", x.shape[-1])
    b = TPNormShard(bias[part], "tp", x.shape[-1])
    with collectives.active(m):
        ln = layers.layer_norm(x[..., part], w, b, eps=1e-6)
        rms = layers.rms_norm(x[..., part], w, eps=1e-6)
    return _np(collectives.all_gather(ln, "tp", -1, m)), _np(
        collectives.all_gather(rms, "tp", -1, m))


def tp_primitives(up, down, col, row, x, cfg):
    """parallel/tp.py: column_linear, row_linear and tp_mlp on this rank's
    shards; column outputs all-gathered for the comparison."""
    from comfyui_gguf_tpu_torch.parallel import tp

    m = _mesh()
    r, n = collectives.axis_index("tp", m), collectives.axis_size("tp", m)
    place = lambda s: tp.place_stacked(s, m, device="cpu")  # noqa: E731
    c = tp.column_linear(x, place(col), m, cfg=cfg)
    k = x.shape[-1] // n
    rw = tp.row_linear(x[..., r * k:(r + 1) * k], place(row), m, cfg=cfg)
    mlp = tp.tp_mlp(x, place(up), place(down), m, cfg=cfg)
    return _np(collectives.all_gather(c, "tp", -1, m)), _np(rw), _np(mlp)


def tp_forward(fn_name, params, cfg, inputs, block_keys, qcfg,
               convert_i8=False, module="tp_spec"):
    """A tensor-parallel forward on this rank's tree: ``tp_spec``'s
    wrapper ``fn_name`` (or ``tp_flux.tp_forward_stacked``), optionally
    after a per-shard w8a8 conversion. Returns the output and the
    collective counts."""
    from comfyui_gguf_tpu_torch.parallel import tp_flux, tp_spec
    from comfyui_gguf_tpu_torch.quant.i8 import convert_tree_i8

    m = _mesh()
    local = tp_spec.place_tp_params(params, m, block_keys, device="cpu")
    if convert_i8:
        local = convert_tree_i8(local)
    if module == "tp_flux":
        out = tp_flux.tp_forward_stacked(local, cfg, *inputs, mesh=m,
                                         qcfg=qcfg)
    else:
        out = getattr(tp_spec, fn_name)(local, cfg, *inputs, mesh=m,
                                        qcfg=qcfg)
    return _np(out), dict(collectives.STATS)


def gather_quant_forward(fn_module, params, cfg, inputs, qcfg):
    """``mesh.shard_quant_params`` (lane-split packed leaves as gather
    shards) then the model's own forward under the active mesh."""
    import importlib

    m = _mesh()
    local = pmesh.shard_quant_params(params, m, device="cpu")
    mod = importlib.import_module(fn_module)
    with collectives.active(m):
        out = mod.forward(local, cfg, *inputs, qcfg=qcfg)
    return _np(out)


def ring(q, k, v, scale=None):
    """ring_attention over an ("sp",) mesh of every rank."""
    from comfyui_gguf_tpu_torch.parallel.ring import ring_attention

    m = pmesh.make_axis_mesh("sp")
    return _np(ring_attention(q, k, v, m, "sp", scale))


def sp_block(params, cfg, x, e0, ctx, pe, qcfg):
    """One Wan block under ``sequence_parallel``: this rank's L chunk of x
    and the RoPE table; the output chunks all-gathered."""
    from comfyui_gguf_tpu_torch.models import wan
    from comfyui_gguf_tpu_torch.nn.attention import sequence_parallel

    m = pmesh.make_axis_mesh("sp")
    r = collectives.axis_index("sp", m)
    c = x.shape[1] // collectives.axis_size("sp", m)
    with collectives.active(m), sequence_parallel("sp"):
        out = wan._block(params, x[:, r * c:(r + 1) * c], e0, ctx,
                         pe[r * c:(r + 1) * c], cfg, qcfg)
    return _np(collectives.all_gather(out, "sp", dim=1, mesh=m))


def pp(kind, stacked, payload, cfg, qcfg, n_micro=None):
    """The flux single trunk or the Qwen-Image trunk over a ("pp",) mesh."""
    from comfyui_gguf_tpu_torch.parallel import pp as ppm

    m = pmesh.make_axis_mesh("pp")
    if kind == "flux":
        return _np(ppm.pp_flux_single_trunk(stacked, *payload, cfg, qcfg, m,
                                            n_micro=n_micro))
    im, tx = ppm.pp_qwen_image_trunk(stacked, *payload, cfg, qcfg, m,
                                     n_micro=n_micro)
    return _np(im), _np(tx)


def pp_toy(weights, x, n_micro):
    """pp_trunk over a toy stage (x ← x + tanh(x @ W_s))."""
    from comfyui_gguf_tpu_torch.parallel.pp import pp_trunk

    m = pmesh.make_axis_mesh("pp")
    return _np(pp_trunk(_toy_stage, weights, (x,), m, n_micro=n_micro)[0])


def _toy_stage(w, payload):
    return (payload[0] + torch.tanh(payload[0] @ w),)


def ep_toy(w, x, probs):
    """ep_moe over an ("ep",) mesh with expert_e(x) = tanh(x @ W_e)."""
    from comfyui_gguf_tpu_torch.parallel.ep import ep_moe

    m = pmesh.make_axis_mesh("ep")
    return _np(ep_moe(_toy_expert, {"w": w}, x, probs, m, "ep"))


def _toy_expert(p, x):
    return torch.tanh(x @ p["w"])


def hidream_ep(params, cfg, inputs, qcfg):
    """A HiDream forward with ``MOE_DISPATCH = "ep"`` over an ("ep",)
    mesh of every rank."""
    from comfyui_gguf_tpu_torch.models import hidream

    m = pmesh.make_axis_mesh("ep")
    old = hidream.MOE_DISPATCH, hidream.EP_MESH
    hidream.MOE_DISPATCH, hidream.EP_MESH = "ep", m
    try:
        return _np(hidream.forward_stacked(params, cfg, *inputs, qcfg=qcfg))
    finally:
        hidream.MOE_DISPATCH, hidream.EP_MESH = old


def multihost(ranks_per_host):
    """The (host, dp, tp) mesh's coordinates and the batch slice of this
    rank, and a tp all-reduce that stays inside a host."""
    m = pmesh.make_multihost_mesh()
    coords = tuple(collectives.axis_index(a, m) for a in
                   ("host", "dp", "tp"))
    sizes = tuple(collectives.axis_size(a, m) for a in ("host", "dp", "tp"))
    s = collectives.psum(torch.tensor([float(torch.distributed.get_rank())]),
                         "tp", m)
    return coords, sizes, pmesh.batch_spec(m), pmesh.batch_index(m), _np(s)


def engine(kind, model, reqs, engine_kw, tp_params=None, block_keys=None):
    """An engine of ``pipeline`` on every rank with the same submissions;
    ``mesh`` ("tp") or ``dp_mesh`` ("dp") from ``engine_kw``'s flags."""
    from comfyui_gguf_tpu_torch import pipeline
    from comfyui_gguf_tpu_torch.parallel import tp_spec

    kw = dict(engine_kw)
    factory = getattr(pipeline, kind)
    if kw.pop("tp", False):
        m = _mesh()
        model.params = tp_spec.place_tp_params(tp_params, m, block_keys,
                                               device="cpu")
        kw["mesh"] = m
    if kw.pop("dp", False):
        kw["dp_mesh"] = _mesh(tp=1)
    args = kw.pop("args", ())
    eng = factory(model, *args, **kw)
    rs = [eng.submit(x, c, s) for x, c, s in reqs]
    eng.run_until_drained()
    bad = [r.error for r in rs if r.error is not None]
    if bad:
        raise RuntimeError(f"engine requests failed: {bad}")
    return [np.asarray(r.result, np.float32) for r in rs]


def sp_attention(q, k, v):
    """``dot_product_attention`` under ``sequence_parallel``: this rank's
    L chunk of (B, H, L, D) q/k/v, the chunks all-gathered."""
    from comfyui_gguf_tpu_torch.nn.attention import (dot_product_attention,
                                                     sequence_parallel)

    m = pmesh.make_axis_mesh("sp")
    r, n = collectives.axis_index("sp", m), collectives.axis_size("sp", m)
    c = q.shape[2] // n
    part = slice(r * c, (r + 1) * c)
    with collectives.active(m), sequence_parallel("sp"):
        out = dot_product_attention(q[:, :, part], k[:, :, part],
                                    v[:, :, part])
    return _np(collectives.all_gather(out, "sp", dim=2, mesh=m))


def multihost_flux(params, cfg, inputs, qcfg):
    """A flux forward over a (host, dp, tp) mesh: this rank's slice of the
    batch (split host-major over (host, dp)), the packed weights column-
    split over tp (``shard_quant_params``); the slices all-gathered back."""
    from comfyui_gguf_tpu_torch.models import flux

    m = pmesh.make_multihost_mesh(tp=2)
    idx, n = pmesh.batch_index(m)
    b = inputs[0].shape[0] // n
    local = pmesh.shard_quant_params(params, m, device="cpu")
    xs = [t[idx * b:(idx + 1) * b] for t in inputs]
    with collectives.active(m):
        out = flux.forward(local, cfg, *xs, qcfg=qcfg)
    for axis in ("dp", "host"):  # innermost first: host-major order back
        out = collectives.all_gather(out, axis, dim=0, mesh=m)
    return _np(out)
