"""Tensor-parallel primitives over sharded packed weights.

Megatron-style layers built from the per-shard fused matmul: each rank
runs the kernel on its own packed shard, so tensor parallelism and the
packed path compose.

* ``column_linear``: W split on out-features (``planarize_shards`` axis
  "r"); x replicated in, the output stays split (no collective). For qkv
  and mlp-up, so heads and activation blocks stay local.
* ``row_linear``: W split on in-features (axis "k"); x arrives split, each
  rank contracts its K chunk and one all-reduce gives every rank the
  whole output. For attention out and mlp-down.
* ``tp_mlp``: column, a local activation, row: one all-reduce in all.

The weights a rank passes are its own shard (``place_stacked``). A bias of
a column weight is passed whole; each rank adds its slice.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..lifecycle import to_device
from ..nn.layers import DEFAULT_CONFIG, QuantConfig, linear
from ..quant.planar import PlanarQuant, shard_view
from . import collectives


def place_stacked(pq: PlanarQuant, mesh, axis: str = "tp",
                  device="cuda") -> PlanarQuant:
    """This rank's shard of a shard-stacked (tp, ...) weight, on
    ``device``."""
    return to_device(shard_view(pq, collectives.axis_index(axis, mesh)),
                     device)


def _local_slice(bias, axis, mesh):
    n = collectives.axis_size(axis, mesh)
    r = collectives.axis_index(axis, mesh)
    w = bias.shape[-1] // n
    return bias[..., r * w:(r + 1) * w]


def column_linear(x, pq: PlanarQuant, mesh, *, axis: str = "tp",
                  cfg: QuantConfig = DEFAULT_CONFIG, bias=None):
    """x (…, K) replicated → this rank's (…, R/tp) columns."""
    out = linear(x, pq, cfg=cfg)
    if bias is not None:
        out = out + _local_slice(bias, axis, mesh).to(out.dtype)
    return out


def row_linear(x, pq: PlanarQuant, mesh, *, axis: str = "tp",
               cfg: QuantConfig = DEFAULT_CONFIG, bias=None):
    """x: this rank's (…, K/tp) chunk → (…, R) on every rank, through one
    all-reduce in x's dtype; the bias is added once, after it."""
    out = collectives.psum(linear(x, pq, cfg=cfg), axis, mesh)
    if bias is not None:
        out = out + bias.to(out.dtype)
    return out


def _gelu(h):
    return F.gelu(h, approximate="tanh")


def tp_mlp(x, w_up: PlanarQuant, w_down: PlanarQuant, mesh, *,
           axis: str = "tp", cfg: QuantConfig = DEFAULT_CONFIG, act=_gelu,
           bias_up=None, bias_down=None):
    """Column up-projection → the local activation (in f32, rounded back)
    → row down-projection: one all-reduce, and the intermediate
    activation never exists whole on any rank."""
    h = linear(x, w_up, cfg=cfg)
    if bias_up is not None:
        h = h + _local_slice(bias_up, axis, mesh).to(h.dtype)
    h = act(h.to(torch.float32)).to(h.dtype)
    out = collectives.psum(linear(h, w_down, cfg=cfg), axis, mesh)
    if bias_down is not None:
        out = out + bias_down.to(out.dtype)
    return out
