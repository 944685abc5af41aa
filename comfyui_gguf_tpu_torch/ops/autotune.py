"""Profile-driven tile autotuner for the fused dequant-matmul's wgmma body
(PyTorch port of comfyui_gguf_tpu/ops/autotune.py).

``wgmma_split_plan`` picks the body's (token sub-tiles, K split) from a
cost model fitted to a few shapes; this module times every legal candidate
at a weight's real shape on the card (CUDA events around a CUDA graph of
launches, over enough copies of the weight to exceed the L2 cache, as a
model's layers do) and records the fastest in ``qmatmul.SHAPE_TILES``,
which ``qmm_cuda`` consults before the plan. Results persist to JSON so a
fleet pays the search once per card.

Usage (on the card):

    from comfyui_gguf_tpu_torch.ops import autotune
    autotune.tune_for_params(model.params, m=4608)  # all PlanarQuant leaves
    autotune.save(path)                             # → JSON
    # on boot: autotune.load(path)  (or set $GGUF_TPU_TILE_CACHE)

A per-kernel win is a candidate, not a default: confirm it with a whole
forward before persisting it. Nothing loads a table unless the user sets
``GGUF_TPU_TILE_CACHE`` (read when this module is imported and again by
``pipeline.load_diffusion_model``) or calls ``load``; with the table empty
every launch keeps the plan's pick. The tuner times the bf16 instance
without a LoRA; an entry drives every wgmma instance of its shape.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os

import torch

from . import qmatmul
from ..quant.planar import PlanarQuant

log = logging.getLogger(__name__)

# every (token sub-tiles, K split) the wgmma body has an instance for
CANDIDATES = tuple((nt, split) for nt in (1, 2)
                   for split in qmatmul.WGMMA_SPLITS)

# bytes of weight copies one timing cycles through (the H100's L2 is 50 MB)
_COPY_BYTES = 64 << 20
_MAX_COPIES = 16


def _slice2d(pq: PlanarQuant) -> PlanarQuant:
    """Block 0 of a depth-stacked (or expert-stacked) weight; a 2-D weight
    as it is."""
    while pq.qs.dim() > 2:
        pq = pq[0]
    return pq


def _key(pq: PlanarQuant, m: int) -> tuple:
    return qmatmul.shape_key(m, pq.padded_in, pq.padded_out, pq.layout)


def _legal(pq: PlanarQuant, m: int, tiles) -> bool:
    """Whether the wgmma body takes ``tiles`` for this weight at m rows:
    the shape goes to that body, ``wgmma_split_ok`` holds, and a 256-token
    tile needs more than 128 tokens."""
    nt, split = tiles
    kp = pq.padded_in
    return (qmatmul.qmm_route(m, kp, pq.out_features, pq.layout == "nib4")
            == "wgmma" and nt in (1, 2)
            and qmatmul.wgmma_split_ok(kp, nt, split)
            and (nt == 1 or m > qmatmul.WGMMA_TILE[0]))


def _copies(pq: PlanarQuant) -> list[PlanarQuant]:
    n = min(_MAX_COPIES, max(1, -(-_COPY_BYTES // pq.nbytes_packed)))
    return [pq] + [dataclasses.replace(
        pq, qs=pq.qs.clone(), scales=pq.scales.clone(),
        offsets=None if pq.offsets is None else pq.offsets.clone())
        for _ in range(n - 1)]


def _on_card(pq: PlanarQuant) -> PlanarQuant:
    """Block 0 of ``pq`` (``_slice2d``), which must lie on a card: a tuner
    that timed CPU matmuls would tune nothing, so this raises otherwise."""
    pq = _slice2d(pq)
    if not (torch.cuda.is_available() and pq.qs.is_cuda):
        raise RuntimeError("autotune times the CUDA kernel: it needs a card "
                           "and a weight on it")
    return pq


def _profile_ms(pq: PlanarQuant, m: int, tiles=None, reps: int = 10,
                weights=None) -> float:
    """Device time of one ``qmm_cuda`` launch of an (m, K) bf16 x against
    ``pq`` at ``tiles`` (default: the table's or the plan's pick): CUDA
    events around a CUDA graph of ``reps`` rounds over ``weights`` (copies
    of ``pq``). Raises without a card."""
    from .._timing import graph_ms

    pq = _on_card(pq)
    weights = weights or [pq]
    gen = torch.Generator(device=pq.qs.device).manual_seed(0)
    x = torch.randn((m, pq.in_features), generator=gen,
                    device=pq.qs.device).to(torch.bfloat16)
    return graph_ms([lambda w=w: qmatmul.qmm_cuda(x, w, tiles=tiles)
                     for w in weights], reps=reps)


def tune_shape(pq: PlanarQuant, m: int, candidates=CANDIDATES,
               times: dict | None = None) -> tuple | None:
    """Time each legal candidate for one weight at m rows; record and
    return the fastest. A candidate that fails to launch is logged as a
    warning and skipped (``times`` then lacks it); if none runs, the shape
    gets no entry. ``times``, if given, receives {tiles: ms} of every
    candidate that ran. Raises without a card."""
    pq = _on_card(pq)
    key = _key(pq, m)
    qmatmul.SHAPE_TILES.pop(key, None)
    weights = _copies(pq)
    best, best_ms = None, float("inf")
    for tiles in candidates:
        tiles = tuple(tiles)
        if not _legal(pq, m, tiles):
            continue
        try:
            ms = _profile_ms(pq, m, tiles, weights=weights)
        except (RuntimeError, ValueError) as e:
            log.warning("tiles %s failed for %s: %s", tiles, key,
                        str(e)[:80])
            continue
        log.info("shape %s tiles %s: %.4f ms", key, tiles, ms)
        if times is not None:
            times[tiles] = ms
        if ms < best_ms:
            best, best_ms = tiles, ms
    if best is not None:
        qmatmul.SHAPE_TILES[key] = best
    return best


def _planar_leaves(tree):
    if isinstance(tree, PlanarQuant):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _planar_leaves(v)


def tune_for_params(params: dict, m: int, candidates=CANDIDATES,
                    times: dict | None = None) -> dict:
    """Tune every distinct ``shape_key`` among the PlanarQuant leaves of a
    flat or depth-stacked tree, each once: {key: winner or None}.
    ``times``, if given, receives {key: {tiles: ms}}."""
    seen = {}
    for leaf in _planar_leaves(params):
        leaf = _slice2d(leaf)
        key = _key(leaf, m)
        if key in seen:
            continue
        t = {} if times is not None else None
        seen[key] = tune_shape(leaf, m, candidates, times=t)
        if times is not None:
            times[key] = t
    return seen


def save(path: str) -> None:
    data = {json.dumps(list(k)): list(v)
            for k, v in qmatmul.SHAPE_TILES.items()}
    with open(path, "w") as f:
        json.dump(data, f, indent=1)


def load(path: str) -> int:
    """Add the table saved at ``path`` to ``SHAPE_TILES``; the number of
    entries. Each entry is checked first, as the wgmma body would check it
    at launch: a malformed key or a (nt, split) the body cannot take
    raises ``ValueError`` and adds nothing."""
    with open(path) as f:
        data = json.load(f)
    table = {}
    for k, v in data.items():
        key, tiles = json.loads(k), v
        if not (isinstance(key, list) and len(key) == 4
                and all(isinstance(d, int) and d > 0 for d in key[:3])
                and key[3] in ("nib4", "int8")
                and isinstance(tiles, list) and len(tiles) == 2
                and all(isinstance(d, int) for d in tiles)):
            raise ValueError(f"{path}: malformed tile entry {k}: {v}")
        m, kp, rp, layout = key
        try:
            qmatmul.wgmma_tiles(m, kp, rp, rp, layout, tuple(tiles))
        except ValueError as e:
            raise ValueError(f"{path}: {e}") from None
        table[tuple(key)] = tuple(tiles)
    qmatmul.SHAPE_TILES.update(table)
    return len(table)


def load_from_env() -> int:
    """``load`` the table named by $GGUF_TPU_TILE_CACHE; 0 if the variable
    is unset or names no file (a cache not yet written)."""
    path = os.environ.get("GGUF_TPU_TILE_CACHE")
    if not (path and os.path.exists(path)):
        return 0
    n = load(path)
    log.info("loaded %d tuned tile entries from %s", n, path)
    return n


try:
    load_from_env()
except (OSError, ValueError):
    log.exception("failed to load tile cache %s",
                  os.environ.get("GGUF_TPU_TILE_CACHE"))
