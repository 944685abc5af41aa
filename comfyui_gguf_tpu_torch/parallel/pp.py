"""Inference pipeline parallelism: depth split over a mesh axis.

A GPipe-style one-direction pipeline for the repeated-block trunk of a
DiT (flux's single blocks, Qwen-Image's MMDiT blocks): each rank owns
depth/n contiguous blocks, and microbatches hop one ring neighbour a step
(``collectives.ppermute``), n_micro + n_stages − 1 steps in all. Pipeline
parallelism divides weight residency, which is what runs out first for a
deep model.

Stage weights are stacked on a leading axis (n_stages, ...); a rank views
its own stage. The block function keeps the activation's shape.
"""

from __future__ import annotations

from ..lifecycle import tree_leaves, tree_map
from ..models.flux import block_view
from . import collectives


def _tmap(fn, *trees):
    t0 = trees[0]
    if isinstance(t0, (tuple, list)):
        return type(t0)(_tmap(fn, *xs) for xs in zip(*trees))
    if isinstance(t0, dict):
        return {k: _tmap(fn, *(t[k] for t in trees)) for k in t0}
    return fn(*trees)


def _index(tree, i):
    """View ``i`` of every leaf's leading axis (a dict tree or one leaf)."""
    if isinstance(tree, dict):
        return {k: _index(v, i) for k, v in tree.items()}
    return tree[i]


def pp_trunk_local(block_fn, stage_params, x_micro, axis_name: str,
                   mesh=None):
    """Stream microbatches through the stage ring.

    block_fn(stage_params, payload) -> payload: this rank's blocks (a
    whole stage). stage_params: this rank's stage. x_micro: a tree (tuple,
    list or dict) of (n_micro, mb, ...) tensors, the same on every rank
    (only stage 0 reads it); a tree lets per-sample conditioning (the
    modulation vector, the RoPE table) ride the ring beside the
    activation, and block_fn passes the leaves it does not update. Returns
    the tree of finished microbatches on every rank (the last stage's,
    made replicated by one all-reduce in which the others add zeros).
    """
    n_stages = collectives.axis_size(axis_name, mesh)
    idx = collectives.axis_index(axis_name, mesh)
    n_micro = tree_leaves(x_micro)[0].shape[0]
    buf = _tmap(lambda a: a[0].clone(), x_micro)
    out = _tmap(lambda a: a.new_zeros(a.shape), x_micro)
    for t in range(n_micro + n_stages - 1):
        mb = t - idx  # the microbatch this stage sees at step t
        if 0 <= mb < n_micro:
            x_in = _tmap(lambda a: a[mb], x_micro) if idx == 0 else buf
            y = block_fn(stage_params, x_in)
            if idx == n_stages - 1:
                def put(o, yy, mb=mb):
                    o[mb] = yy
                _tmap(put, out, y)
        else:
            y = buf
        buf = _tmap(lambda yy: collectives.ppermute(yy, axis_name, 1, mesh),
                    y)
    return _tmap(lambda o: collectives.psum(o, axis_name, mesh), out)


def pp_trunk(block_fn, stage_params, x, mesh, axis: str = "pp",
             n_micro: int | None = None):
    """stage_params: stacked (n_stages, ...) tree (this rank runs the view
    of its stage); x: a tree of (B, ...) tensors; n_micro (default
    min(B, 2·n_stages)) must divide B."""
    n_stages = collectives.axis_size(axis, mesh)
    B = tree_leaves(x)[0].shape[0]
    if n_micro is None:
        n_micro = max(1, min(B, 2 * n_stages))
    if B % n_micro:
        raise ValueError(f"batch {B} not divisible by n_micro={n_micro}")
    mb = B // n_micro
    x_micro = _tmap(lambda a: a.reshape(n_micro, mb, *a.shape[1:]), x)
    local = _index(stage_params, collectives.axis_index(axis, mesh))
    out = pp_trunk_local(block_fn, local, x_micro, axis, mesh)
    return _tmap(lambda a: a.reshape(B, *a.shape[2:]), out)


def _staged(stacked: dict, n_stages: int) -> tuple[dict, int]:
    depth = tree_leaves(stacked)[0].shape[0]
    if depth % n_stages:
        raise ValueError(f"depth {depth} not divisible by {n_stages} stages")
    per = depth // n_stages
    return tree_map(lambda a: a.reshape(n_stages, per, *a.shape[1:]),
                    stacked), per


def pp_flux_single_trunk(single_stacked: dict, x, vec, pe, cfg, qcfg,
                         mesh, axis: str = "pp",
                         n_micro: int | None = None):
    """The flux single-block stack (``stack_flux_params`` layout, leaves
    (depth, ...)) over pp stages of depth/n blocks; (x, vec, pe)
    microbatches ride the ring. x: (B, L, hidden), the joint txt|img
    stream; vec (B, hidden); pe the RoPE table (B, ...)."""
    from ..models.flux import _single_block

    staged, per = _staged(single_stacked, collectives.axis_size(axis, mesh))

    def stage_fn(stage, payload):
        xm, vecm, pem = payload
        for i in range(per):
            xm = _single_block(block_view(stage, i), xm, vecm, pem, cfg,
                               qcfg)
        return (xm, vecm, pem)

    out, _, _ = pp_trunk(stage_fn, staged, (x, vec, pe), mesh, axis=axis,
                         n_micro=n_micro)
    return out


def pp_qwen_image_trunk(blocks_stacked: dict, img, txt, vec, pe, cfg, qcfg,
                        mesh, axis: str = "pp",
                        n_micro: int | None = None):
    """The Qwen-Image transformer_blocks stack over pp stages; the
    dual-stream (img, txt) state and (vec, pe) ride the ring."""
    from ..models.qwen_image import _block

    staged, per = _staged(blocks_stacked, collectives.axis_size(axis, mesh))

    def stage_fn(stage, payload):
        im, tx, vecm, pem = payload
        for i in range(per):
            im, tx = _block(block_view(stage, i), im, tx, vecm, pem, cfg,
                            qcfg)
        return (im, tx, vecm, pem)

    im, tx, _, _ = pp_trunk(stage_fn, staged, (img, txt, vec, pe), mesh,
                            axis=axis, n_micro=n_micro)
    return im, tx
