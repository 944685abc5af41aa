"""The benchmark's one bridge to the program under test (the PyTorch and
CUDA package): stored weights handed to its loader, and a hook that keeps
the outputs of the timed path's own forward calls for the check.
Nothing here is read by the references."""

from __future__ import annotations

import importlib

PACKAGE = "comfyui_gguf_tpu_torch"


def load_params(raw: dict, device):
    """``{key: (fmt, shape, array)}`` -> the program's parameter tree, by
    the call ``load_diffusion_model`` makes after reading a file
    (``loader.to_torch_params``)."""
    from comfyui_gguf_tpu_torch.gguf.constants import \
        GGMLQuantizationType as Q
    from comfyui_gguf_tpu_torch.loader import QTensor, to_torch_params

    sd = {k: QTensor(name=k, qtype=Q[fmt], shape=tuple(shape), data=data)
          for k, (fmt, shape, data) in raw.items()}
    return to_torch_params(sd, device=device)


def enable_build_cache(path: str) -> None:
    """Build and look for the kernel library in ``path``."""
    from comfyui_gguf_tpu_torch import compile_cache

    compile_cache.enable(path)


class ForwardTap:
    """Wraps ``module.attr`` (a forward the engines bind when they are
    built, or the pipeline calls by name) so that, while ``on`` is set,
    each call's output (with ``with_args``, its (args, output)) is
    appended to ``calls``. Install before the engine is made; ``undo``
    restores it."""

    def __init__(self, module: str, attr: str, with_args: bool = False):
        self.mod = importlib.import_module(f"{PACKAGE}.{module}")
        self.attr = attr
        self.orig = getattr(self.mod, attr)
        self.on = False
        self.calls: list = []

        def tapped(*args, **kw):
            out = self.orig(*args, **kw)
            if self.on:
                self.calls.append((args, out) if with_args else out)
            return out

        setattr(self.mod, attr, tapped)

    def take(self) -> list:
        out, self.calls = self.calls, []
        return out

    def undo(self) -> None:
        setattr(self.mod, self.attr, self.orig)


class OpTap:
    """Wraps the layer functions a model module calls by name (``linear``,
    ``linear_gelu``, ``dot_product_attention``, ``conv2d`` as bound in
    ``module``).
    While ``on`` is set, calls are counted per kind, and those that
    ``want(kind, index)`` selects go to ``keep(kind, args, kw, out)``,
    whose result is recorded as (kind, index, kept)."""

    NAMES = ("linear", "linear_gelu", "dot_product_attention", "conv2d")
    KIND = {"dot_product_attention": "attention", "conv2d": "conv"}

    def __init__(self, module: str, want, keep):
        self.mod = importlib.import_module(f"{PACKAGE}.{module}")
        self.orig = {n: getattr(self.mod, n) for n in self.NAMES
                     if hasattr(self.mod, n)}
        self.on = False
        self.want, self.keep = want, keep
        self.records: list = []
        self.count: dict = {}
        for n in self.orig:
            setattr(self.mod, n, self._wrap(n))

    def _wrap(self, name):
        fn = self.orig[name]
        kind = self.KIND.get(name, "linear")

        def tapped(*args, **kw):
            out = fn(*args, **kw)
            if self.on:
                i = self.count.get(kind, 0)
                self.count[kind] = i + 1
                if self.want(kind, i):
                    self.records.append(
                        (kind, i, self.keep(name, args, kw, out)))
            return out

        return tapped

    def take(self) -> list:
        out, self.records, self.count = self.records, [], {}
        return out

    def undo(self) -> None:
        for n, fn in self.orig.items():
            setattr(self.mod, n, fn)


def weight_keys(params: dict) -> dict:
    """{data pointer of a weight as the forward passes it: its key} over
    a loaded tree, flat or depth-stacked (block i of a stacked leaf is
    ``leaf[i]``, as the stacked forward takes it)."""
    def ptr(w):
        return (w.qs if hasattr(w, "qs") else w).data_ptr()

    out = {}
    for k, v in params.items():
        if isinstance(v, dict):
            for suf, leaf in v.items():
                if suf.endswith("weight") and not isinstance(leaf, dict):
                    base = leaf.qs if hasattr(leaf, "qs") else leaf
                    for i in range(base.shape[0]):
                        out[base[i].data_ptr()] = f"{k}.{i}.{suf}"
        elif k.endswith("weight"):
            out[ptr(v)] = k
    return out
