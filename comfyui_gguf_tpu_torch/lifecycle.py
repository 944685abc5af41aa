"""Model lifecycle: a device-memory-budget residency manager (host↔device
offload); PyTorch port of comfyui_gguf_tpu/lifecycle.py.

The unit of offload is the MODEL: params trees move between host RAM (CPU
tensors) and the card wholesale. The packed planar and int8 weights are
4-8× smaller than fp16, so whole-model residency is the common case.

Typical use — encoders + DiT + VAE sharing one card:

    reg = ResidencyManager(hbm_budget=40 << 30)
    reg.register("t5", t5_params); reg.register("flux", flux_params)
    with reg.acquire("t5") as p:   # evicts LRU models if over budget
        ctx = t5.encode(p, ...)

Trees are dicts, lists and tuples whose leaves are tensors, numpy arrays,
``PlanarQuant``, ``I8Planar`` or LoRA-patched (``PatchedWeight``) leaves.
"""

from __future__ import annotations

import contextlib
import dataclasses
import logging
from collections import OrderedDict

import numpy as np
import torch

from ._device import resolve_device
from .lora import LoRAPatch, PatchedWeight
from .quant.i8 import I8Planar
from .quant.planar import PlanarQuant, TPNormShard, TPShard

log = logging.getLogger(__name__)

# the tensor fields of each packed leaf type (the others are metadata)
_TENSOR_FIELDS = {PlanarQuant: ("qs", "scales", "offsets"),
                  I8Planar: ("qs", "scales"),
                  LoRAPatch: ("up", "down", "mid", "diff", "a1", "a2"),
                  TPShard: ("inner",), TPNormShard: ("weight",)}


def tree_map(fn, tree):
    """``fn`` on every array leaf of a param tree (tensors and numpy
    arrays, inside packed and patched leaves too); the structure and the
    metadata are kept, None and other leaves pass through."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    if isinstance(tree, PatchedWeight):
        return PatchedWeight(tree_map(fn, tree.base),
                             tuple(tree_map(fn, p) for p in tree.patches))
    fields = _TENSOR_FIELDS.get(type(tree))
    if fields is not None:
        return dataclasses.replace(tree, **{
            f: tree_map(fn, getattr(tree, f)) for f in fields})
    if isinstance(tree, (torch.Tensor, np.ndarray)):
        return fn(tree)
    return tree


def tree_leaves(tree) -> list:
    """The array leaves of ``tree``, in ``tree_map`` order."""
    out = []

    def grab(a):
        out.append(a)
        return a

    tree_map(grab, tree)
    return out


def _leaf_bytes(leaf) -> int:
    if isinstance(leaf, torch.Tensor):
        return leaf.numel() * leaf.element_size()
    return int(leaf.nbytes)


def tree_bytes(params) -> int:
    """Bytes of every array leaf (packed codes, scales, offsets and LoRA
    factors included)."""
    return sum(_leaf_bytes(x) for x in tree_leaves(params))


def to_host(params):
    """A host copy of the tree: CPU tensors (never sharing storage with
    the source, so freeing the source leaves the copy intact)."""
    return tree_map(lambda x: torch.as_tensor(x).detach().to(
        "cpu", copy=True), params)


def to_device(params, device="cuda"):
    """A copy of the tree on ``device`` (the card unless the caller asks
    for the CPU)."""
    dev = resolve_device(device)
    return tree_map(lambda x: torch.as_tensor(x).to(dev, copy=True), params)


def free_tree(params) -> None:
    """Release the storage of every tensor leaf in ``params``.

    Dropping a reference frees nothing while the caller (or an engine
    closure) still holds the tree; this frees the memory whoever holds it.
    Each leaf tensor is emptied in place (``set_()``: zero elements, so a
    later use of the tree fails on its shapes) and its storage is resized
    to zero bytes, so ``torch.cuda.memory_allocated`` drops at once even
    where another view of the storage survives. Such a view, made before
    the call, must not be used again: it points at freed memory. Numpy
    leaves are left alone. Use after registering a model with a
    ResidencyManager (whose host copy is the durable source) or after a
    converted copy supersedes the original tree."""
    for leaf in tree_leaves(params):
        if not isinstance(leaf, torch.Tensor):
            continue
        storage = leaf.untyped_storage()
        leaf.set_()
        if storage.resizable():  # not memory that a numpy array owns
            storage.resize_(0)


@dataclasses.dataclass
class _Entry:
    host: object  # host-resident tree (CPU tensors), the durable copy
    device: object | None  # device tree or None when evicted
    nbytes: int
    pins: int = 0


class ResidencyManager:
    """LRU residency manager for whole-model param trees.

    ``acquire`` returns a context manager yielding the device-resident
    tree; while pinned, the model cannot be evicted. When placing a model
    would exceed ``hbm_budget`` bytes, least-recently-used unpinned models
    are evicted: their device copy is freed (``free_tree``), the host copy
    persists. ``device``: the card unless the caller asks for the CPU.
    """

    def __init__(self, hbm_budget: int | None = None, device="cuda"):
        self.hbm_budget = hbm_budget
        self.device = resolve_device(device)
        self._models: OrderedDict[str, _Entry] = OrderedDict()

    def register(self, name: str, params, keep_device: bool = False,
                 free_source: bool = False) -> None:
        """Add a model. ``params`` may be host- or device-resident; a host
        copy is kept as the durable source. keep_device=True places it
        immediately (counting against the budget).

        free_source=True releases the storage of the CALLER'S tree after
        the host copy is made. Without it, a device-resident source that
        stays referenced (engine closures, the caller's local) keeps its
        memory and the budget is not actually enforced — LRU eviction only
        frees the manager's own copies."""
        if name in self._models:
            raise ValueError(f"model {name!r} already registered")
        host = to_host(params)
        if free_source:
            log.info("register(%r): freeing the caller's tensors "
                     "(free_source=True) — further use of the source tree "
                     "will raise; read through the manager", name)
            free_tree(params)
        entry = _Entry(host=host, device=None, nbytes=tree_bytes(host))
        self._models[name] = entry
        if keep_device:
            self._ensure_resident(name)

    def unregister(self, name: str) -> None:
        e = self._models[name]
        if e.pins:
            raise RuntimeError(f"model {name!r} is pinned")
        self._drop(e)
        del self._models[name]

    def device_bytes(self) -> int:
        return sum(e.nbytes for e in self._models.values()
                   if e.device is not None)

    @staticmethod
    def _drop(e: _Entry) -> None:
        if e.device is not None:
            free_tree(e.device)
            e.device = None

    def _evict_until(self, needed: int) -> None:
        if self.hbm_budget is None:
            return
        for name in list(self._models):  # oldest first
            if self.device_bytes() + needed <= self.hbm_budget:
                return
            e = self._models[name]
            if e.device is not None and not e.pins:
                log.info("evicting %s (%.1f MB) to host", name,
                         e.nbytes / 2**20)
                self._drop(e)
        if self.device_bytes() + needed > self.hbm_budget:
            if needed > self.hbm_budget:
                raise MemoryError(
                    f"model needs {needed} bytes but hbm_budget is only "
                    f"{self.hbm_budget} — raise the budget")
            pinned = [n for n, e in self._models.items()
                      if e.device is not None and e.pins]
            raise MemoryError(
                f"cannot free {needed} bytes: pinned resident models "
                f"{pinned or 'none'} hold "
                f"{self.device_bytes()} of {self.hbm_budget}")

    def _ensure_resident(self, name: str):
        e = self._models[name]
        self._models.move_to_end(name)  # most-recently-used
        if e.device is None:
            self._evict_until(e.nbytes)
            e.device = to_device(e.host, self.device)
        return e

    def resident_params(self, name: str):
        """Device tree for ``name``, loading (and LRU-evicting other
        unpinned models) as needed — the unpinned read used by per-tick
        params providers (serving.ResidentModelServer)."""
        return self._ensure_resident(name).device

    @contextlib.contextmanager
    def acquire(self, name: str):
        e = self._ensure_resident(name)
        e.pins += 1
        try:
            yield e.device
        finally:
            e.pins -= 1

    def evict(self, name: str) -> None:
        e = self._models[name]
        if e.pins:
            raise RuntimeError(f"model {name!r} is pinned")
        self._drop(e)

    def stats(self) -> dict:
        return {
            name: {"bytes": e.nbytes,
                   "resident": e.device is not None,
                   "pinned": bool(e.pins)}
            for name, e in self._models.items()
        }
