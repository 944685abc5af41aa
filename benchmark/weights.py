"""Seed-made weights at the GGUF formats' own byte layout.

A configuration's tensors are listed as groups (``Group``): one key
pattern over a depth of blocks, a shape, a stored format and how its
values are drawn. ``make_raw`` draws each group on the device from one
``torch.Generator`` in a few large calls (a whole group at a time, cut
only where a call would pass ``CALL_ELEMS`` values), encodes the
quantized ones to their blocks there, and brings the stored bytes to the
host once: ``{key: (format, shape, array)}``, the in-memory form of a
GGUF file. The program loads it as it loads a file; the references decode
it themselves.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

import ggml

CALL_ELEMS = 1 << 29  # values drawn in one call at most (2 GiB of f32)
# The gain of the RMS norms on attention's queries and keys. At 1 the
# scores of unit-RMS queries and keys spread by about 1, and attention
# over thousands of random keys is all but uniform: the output would not
# depend on where a token sits, and no check could see RoPE. At 2 they
# spread by about 4, and each query attends to a few keys, as a trained
# model's do.
QK_GAIN = 2.0


@dataclasses.dataclass(frozen=True)
class Group:
    key: str  # with "{i}" for the block index where depth is set
    shape: tuple
    fmt: str  # "Q4_K", "Q8_0", "F16" or "F32"
    init: str  # "matrix": N(0, 1/fan_in); "bias" / "table": N(0, 0.02);
    #            "gain": 1 + N(0, 0.02); "qk_gain": QK_GAIN + N(0, 0.02)
    depth: int | None = None
    scale: float = 1.0  # a factor on a matrix's std

    @property
    def keys(self) -> list[str]:
        if self.depth is None:
            return [self.key]
        return [self.key.format(i=i) for i in range(self.depth)]


def _std(g: Group) -> float:
    if g.init == "matrix":
        fan_in = int(np.prod(g.shape[1:]))
        return g.scale / float(np.sqrt(fan_in))
    return 0.02


def _store(g: Group, vals: torch.Tensor) -> np.ndarray:
    """(n, *shape) float32 on the device -> (n, ...) stored host array."""
    n = vals.shape[0]
    if g.fmt in ggml.ENCODE:
        blocks = ggml.ENCODE[g.fmt](vals)
        return blocks.reshape(n, -1, blocks.shape[-1]).cpu().numpy()
    dt = {"F32": torch.float32, "F16": torch.float16}[g.fmt]
    return vals.to(dt).cpu().numpy()


def make_raw(groups: list[Group], seed: int, device) -> dict:
    """{key: (fmt, shape, host array)} for every key of ``groups``, drawn
    from ``seed`` on ``device``."""
    gen = torch.Generator(device=device).manual_seed(seed)
    raw = {}
    for g in groups:
        keys = g.keys
        per = int(np.prod(g.shape))
        step = max(1, CALL_ELEMS // per)
        for s in range(0, len(keys), step):
            n = min(step, len(keys) - s)
            vals = torch.randn((n, *g.shape), generator=gen, device=device,
                               dtype=torch.float32) * _std(g)
            if g.init in ("gain", "qk_gain"):
                vals += QK_GAIN if g.init == "qk_gain" else 1.0
            host = _store(g, vals)
            del vals
            for j in range(n):
                raw[keys[s + j]] = (g.fmt, tuple(g.shape), host[j])
    return raw


def stored_bytes(raw: dict) -> int:
    return sum(a.nbytes for _, _, a in raw.values())
