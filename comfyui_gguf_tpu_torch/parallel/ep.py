"""Expert parallelism: MoE experts split over a mesh axis.

Each rank owns E/n experts' FFN weights (the leading axis of the stacked
expert tree) and computes every one of them over the whole token set;
the probability-weighted outputs reduce with one all-reduce. That is the
dense mask-weighted dispatch (``models/hidream.py`` ``moe_ffn``) with the
expert FLOPs divided by n and no routing drop. It suits small expert
counts (HiDream: E = 4).
"""

from __future__ import annotations

from ..lifecycle import tree_leaves
from . import collectives


def _expert_view(tree, j):
    if isinstance(tree, dict):
        return {k: _expert_view(v, j) for k, v in tree.items()}
    return tree[j]


def _n_experts(tree) -> int:
    return tree_leaves(tree)[0].shape[0]


def ep_moe_local(expert_fn, expert_params, x, probs, axis_name: str,
                 mesh=None):
    """expert_params: this rank's (E/n, ...) slice of the stacked expert
    tree; probs: (..., E) routing weights and x: (..., D) tokens, both
    replicated. Every local expert runs (not only the first), and one
    all-reduce gives Σ_e probs_e · expert_e(x)."""
    local_e = _n_experts(expert_params)
    base = collectives.axis_index(axis_name, mesh) * local_e
    y = None
    for j in range(local_e):
        yj = expert_fn(_expert_view(expert_params, j), x)
        yj = yj * probs[..., base + j: base + j + 1].to(yj.dtype)
        y = yj if y is None else y + yj
    return collectives.psum(y, axis_name, mesh)


def _local_experts(expert_params, mesh, axis):
    E = _n_experts(expert_params)
    n = collectives.axis_size(axis, mesh)
    if E % n:
        raise ValueError(f"{E} experts not divisible by {axis} axis size "
                         f"{n}")
    r = collectives.axis_index(axis, mesh)
    per = E // n

    def cut(tree):
        if isinstance(tree, dict):
            return {k: cut(v) for k, v in tree.items()}
        return tree[r * per:(r + 1) * per]

    return cut(expert_params)


def ep_moe_inline(expert_fn, expert_params, x, probs, mesh,
                  axis: str = "ep"):
    """Inside a model forward (HiDream's ``MOE_DISPATCH = "ep"``): the
    stacked (E, ...) expert tree as the model holds it; this rank runs
    its E/n experts on views of it. E must divide by the axis size."""
    return ep_moe_local(expert_fn, _local_experts(expert_params, mesh, axis),
                        x, probs, axis, mesh)


def ep_moe(expert_fn, expert_params, x, probs, mesh, axis: str = "ep"):
    """Top level: stacked (E, ...) expert params, tokens and routing probs
    replicated; the result replicated. Each rank keeps only its experts'
    slice of the tree."""
    return ep_moe_inline(expert_fn, expert_params, x, probs, mesh, axis)
