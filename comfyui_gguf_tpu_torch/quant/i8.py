"""w8a8 weight format: per-column int8 requantization (PyTorch port).

Port of ``comfyui_gguf_tpu/quant/i8.py``. Already-loaded planar weights are
converted once into

    w[k, r] ~= ws[r] * wq[r, k]        wq int8, ws float32 per OUT column

The codes and scales are the reference's, bit for bit; only the storage is
transposed: ``wq`` is out-feature-major (K contiguous), the layout that
Hopper's s8 ``wgmma`` and cuBLASLt's int8 path both read directly.

and activations are quantized per token row at matmul time
(x[m, :] ~= xs[m] * xq[m, :]), so the contraction runs in s8 with an exact
s32 accumulator (K·127² < 2³¹ up to K ≈ 133k) and ONE float32 rescale in
the kernel epilogue (ops/i8mm.py).

A model whose int8 tree does not fit converts under a byte budget: the
greedy planner ``plan_i8_budget`` picks the leaves (largest byte delta
first) and ``requantize_i8_host`` stages each one through host memory, so
that the card never holds a leaf's planar and int8 forms at once.
"""

from __future__ import annotations

import dataclasses
import logging

import numpy as np
import torch

from .planar import PlanarQuant, TPShard, dequantize_padded

log = logging.getLogger(__name__)

# floor for dynamic scales: keeps all-zero rows/columns finite (quantized
# values are exactly 0 there)
_SCALE_FLOOR = 1e-30

# float32 reciprocal of 127. The reference package's conversion runs under
# jit, where XLA rewrites ``/ 127.0`` as a multiply by this constant;
# multiplying here keeps both packages' codes identical.
_INV127 = torch.tensor(1.0 / 127.0, dtype=torch.float32)


@dataclasses.dataclass(frozen=True)
class I8Planar:
    """Per-column-int8 out-feature-major weight for the w8a8 path.

    Fields may carry a leading depth axis (a depth-stacked group):
      qs: (Rp, Kp) int8 or (depth, Rp, Kp) — K contiguous
      scales: (1, Rp) float32 or (depth, 1, Rp) — per out-column
    ``shape`` is the LOGICAL torch-order (out=R, in=K); Kp/Rp keep the
    source PlanarQuant's padding (pad rows/columns requantize to 0).
    ``qtype`` records the source GGML format.
    """

    qs: torch.Tensor
    scales: torch.Tensor
    qtype: int
    shape: tuple[int, int]

    @property
    def out_features(self) -> int:
        return self.shape[0]

    @property
    def in_features(self) -> int:
        return self.shape[1]

    @property
    def padded_out(self) -> int:
        return self.qs.shape[-2]

    @property
    def padded_in(self) -> int:
        return self.qs.shape[-1]

    @property
    def nbytes_packed(self) -> int:
        return (self.qs.numel() * self.qs.element_size()
                + self.scales.numel() * self.scales.element_size())

    def __getitem__(self, i: int) -> "I8Planar":
        """Depth slice i of a stacked weight: views, no copy."""
        return dataclasses.replace(self, qs=self.qs[i],
                                   scales=self.scales[i])


def _req_slice(p: PlanarQuant, wq_out: torch.Tensor) -> torch.Tensor:
    """One 2-D planar weight: writes its int8 codes, transposed, into
    ``wq_out`` (Rp, Kp) and returns the scales (1, Rp) float32."""
    w = dequantize_padded(p)  # (Kp, Rp)
    ws = torch.clamp(w.abs().amax(dim=0, keepdim=True),
                     min=_SCALE_FLOOR) * _INV127.to(w.device)
    wq_out.copy_(torch.round(w / ws).t())
    return ws


def requantize_i8(pq: PlanarQuant) -> I8Planar:
    """PlanarQuant -> I8Planar (2-D, or with leading axes: depth, or depth
    and experts), on the device the planar leaf is on.

    Each 2-D slice converts into preallocated int8 storage, so the dense
    float32 transient is one slice's worth.
    """
    kp, rp = pq.padded_in, pq.padded_out
    lead = tuple(pq.qs.shape[:-2])
    dev = pq.qs.device
    wq = torch.empty((*lead, rp, kp), dtype=torch.int8, device=dev)
    if not lead:
        ws = _req_slice(pq, wq)
    else:
        ws = torch.empty((*lead, 1, rp), dtype=torch.float32, device=dev)
        for idx in np.ndindex(*lead):
            ws[idx] = _req_slice(pq[idx], wq[idx])
    return I8Planar(qs=wq, scales=ws, qtype=pq.qtype, shape=pq.shape)


def requantize_i8_host(pq: PlanarQuant, *, free_source: bool = False,
                       device=None) -> I8Planar:
    """PlanarQuant -> I8Planar staged through host memory.

    The planar components are copied to the host first and, with
    ``free_source``, their device storage is released (``free_tree``)
    before anything else is placed; the conversion then runs on the CPU
    (``requantize_i8`` on the host copy: the same float32 arithmetic, one
    2-D slice at a time) and only the final int8 leaf is placed on
    ``device`` (the source's by default). The device peak of a leaf is
    thus the tree less its planar form plus its int8 form, never both.

    Both of the port's paths run the dequantization as two roundings
    (``s·q``, then ``+ o``). The reference package's device path fuses
    ``s·q + o`` into one FMA for the offset formats (Q4_1/Q4_K/Q5_K), so
    against it a code may land one step off on a rounding boundary and a
    scale one ulp off; offset-free formats agree bit for bit.
    """
    from ..lifecycle import free_tree, to_host

    device = pq.qs.device if device is None else torch.device(device)
    host = to_host(pq)
    if free_source:
        free_tree(pq)
    ip = requantize_i8(host)
    return dataclasses.replace(ip, qs=ip.qs.to(device),
                               scales=ip.scales.to(device))


def dequantize_i8(ip: I8Planar, dtype=torch.float32) -> torch.Tensor:
    """Dense logical torch-order (out=R, in=K) weight."""
    w = ip.qs.to(torch.float32) * ip.scales.to(torch.float32).transpose(-1,
                                                                         -2)
    return w[..., : ip.out_features, : ip.in_features].to(dtype)


def dequantize_kmajor_i8(ip: I8Planar, dtype=torch.float32) -> torch.Tensor:
    """Dense (K, R) logical-domain weight."""
    return dequantize_i8(ip, dtype).transpose(-1, -2)


def quantize_rows(x2: torch.Tensor):
    """Dynamic per-token activation quantization.

    x2: (m, K) any float -> (xq (m, K) int8, xs (m, 1) float32) with
    x2 ~= xs * xq: round half to even, the scale floor, and a true division
    by 127 — the reference package's eager arithmetic. The kernel and the
    plain path both consume these IDENTICAL integer operands.
    """
    # the row max is exact in x2's own dtype, and x2 / xs promotes to
    # float32, so no float32 copy of x2 is needed
    xs = torch.clamp(x2.abs().amax(dim=-1, keepdim=True).to(torch.float32),
                     min=_SCALE_FLOOR) / 127.0
    xq = torch.round(x2 / xs).to(torch.int8)
    return xq, xs


def is_modulation_key(key: str) -> bool:
    """True for adaLN/modulation projection keys (flux img_mod/txt_mod/
    modulation, sd3/hidream adaLN_modulation, cosmos adaln, wan
    .modulation, UNet emb_layers). These weights only see M=batch rows —
    bandwidth-bound, where int8's ~8 bpw loses to 4.5-bpw nib4 — so w8a8
    conversion keeps them planar by default."""
    return any(seg == "modulation" or seg.endswith("mod")
               or seg == "emb_layers" or "adaln" in seg.lower()
               for seg in key.split("."))


def _leaf_bytes(b: PlanarQuant) -> tuple[int, int]:
    """(planar bytes, int8 bytes) of one packed leaf (any leading axes):
    s8 codes and float32 per-column scales at the source's padding."""
    lead = 1
    for d in b.qs.shape[:-2]:
        lead *= d
    kp, rp = b.padded_in, b.padded_out
    return b.nbytes_packed, lead * (kp * rp + 4 * rp)


def plan_i8_budget(params: dict, *, max_bytes: int, pred=None) -> set:
    """The leaves to convert under a budget on the TOTAL packed-weight
    bytes (planar leaves kept + int8 leaves converted <= ``max_bytes``):
    greedy, by descending byte delta, so that the fewest leaves fill the
    budget. ``pred(path, leaf)`` limits the candidates. → the set of dotted
    key paths (``convert_tree_i8``'s) to convert. A budget that converts
    nothing is logged as a warning: the model stays planar."""
    from ..lora import PatchedWeight

    cands, total = [], 0

    def scan(node, path):
        nonlocal total
        if isinstance(node, dict):
            for k, v in node.items():
                scan(v, f"{path}.{k}" if path else str(k))
            return
        b = node.base if isinstance(node, PatchedWeight) else node
        if isinstance(b, TPShard):
            b = b.inner
        if isinstance(b, PlanarQuant):
            pb, ib = _leaf_bytes(b)
            total += pb
            if pred is None or pred(path, b):
                cands.append((path, pb, ib))

    scan(params, "")
    cands.sort(key=lambda c: -(c[2] - c[1]))
    planar_total, chosen = total, set()
    for path, pb, ib in cands:
        if total + (ib - pb) <= max_bytes:
            chosen.add(path)
            total += ib - pb
    log.info("plan_i8_budget: %d/%d leaves chosen, packed %.2f -> %.2f GB "
             "(budget %.2f GB)", len(chosen), len(cands), planar_total / 1e9,
             total / 1e9, max_bytes / 1e9)
    if cands and not chosen:
        log.warning("plan_i8_budget: budget %.2f GB <= planar footprint "
                    "%.2f GB — NOTHING will be converted; the model stays "
                    "fully planar", max_bytes / 1e9, planar_total / 1e9)
    return chosen


def convert_tree_i8(params: dict, *, free_source: bool = False,
                    pred=None, max_bytes: int | None = None,
                    host_stage: bool = False) -> dict:
    """Replace PlanarQuant leaves of a (nested dict) param tree with their
    I8Planar requantization — the w8a8 model-conversion entry point.

    pred(path, leaf) -> bool converts only matching leaves; paths are the
    dotted keys (``double_blocks.img_attn.qkv.weight`` in a stacked tree).
    Keep modulation projections planar with
    ``pred=lambda k, v: not is_modulation_key(k)``.

    free_source: drop each source leaf from ``params`` as soon as its int8
    copy exists, so a full-depth model never holds both trees.

    max_bytes: convert only the leaves ``plan_i8_budget`` picks under this
    total packed-byte budget (within ``pred``'s); the rest stay planar.

    host_stage: convert each leaf through ``requantize_i8_host``, so that
    the card's peak stays at the converted tree's footprint (with
    ``free_source``).

    A LoRA-patched leaf (``lora.PatchedWeight``) converts its packed base
    and keeps its patches, which then ride the w8a8 kernel's epilogue. A
    tensor-parallel leaf (``TPShard``) converts its packed shards, each on
    its own: a shard's column scales are its own columns' (the (tp,
    depth) lead axes of a sharded tree, or a rank's depth axis).
    """
    if max_bytes is not None:
        chosen = plan_i8_budget(params, max_bytes=max_bytes, pred=pred)
        pred = lambda path, b: path in chosen  # noqa: E731
    return _walk(params, "", free_source, pred, host_stage)


def _walk(node: dict, path: str, free_source: bool, pred,
          host_stage: bool = False) -> dict:
    from ..lora import PatchedWeight

    out = {}
    for k in list(node):
        v = node[k]
        kp = f"{path}.{k}" if path else str(k)
        b = v.base if isinstance(v, PatchedWeight) else v
        if isinstance(b, TPShard):
            b = b.inner
        if isinstance(v, dict):
            out[k] = _walk(v, kp, free_source, pred, host_stage)
        elif isinstance(b, PlanarQuant) and (pred is None or pred(kp, b)):
            ip = (requantize_i8_host(b, free_source=free_source)
                  if host_stage else requantize_i8(b))
            if isinstance(v, TPShard):
                out[k] = dataclasses.replace(v, inner=ip)
            else:
                out[k] = ip if b is v else PatchedWeight(ip, v.patches)
            if free_source:
                node[k] = None
        else:
            out[k] = v
    return out
