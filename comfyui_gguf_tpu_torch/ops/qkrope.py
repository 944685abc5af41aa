"""The q/k RMS norms, RoPE and the joint concat before an attention call.

One attention call's inputs come from one or more parts of a joint
sequence (flux's double block: the text stream, then the image stream),
each with its own q, k and v projection views of shape (B, L_i, H·D) and
its own q and k norm gains. Per part, q and k are RMS-normalized over the
gain's length G (a head, D: flux; the whole row, H·D: Wan), the parts are
joined along the sequence, and q and k are rotated by the RoPE table of the
joint sequence (flux (B, L, D/2, 2), Wan (L, D/2, 2)); without a table they
are normalized only (Wan's cross-attention).

* ``qk_norm_rope_cuda`` — wrapper of the hand-written CUDA kernel K9
  (``csrc/qk_norm_rope.cu``): one launch an attention call, in which q and
  k of every part (and v, where there are several parts) are descriptors.
  It reads the views in place and writes q and k (and the joined v) to
  fresh (B, L, H, D) storage; it returns (B, H, L, D) views. bf16, f16 and
  f32 activations, head dims ``QK_ROPE_HEAD_DIMS``; anything else raises.
* ``plain_qk_norm_rope`` — the plain version, literally ``rms_norm``, then
  ``apply_rope``, then ``torch.cat``: the models' composition before K9,
  bit for bit. It also takes a ``TPNormShard`` gain (statistics over a
  mesh axis), which the kernel does not: the caller that holds one
  (``models/wan.py`` under ``parallel/tp_spec.py``) calls it directly.
* ``qk_norm_rope`` — what the models call: the kernel for CUDA tensors,
  the plain version for CPU tensors.
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build
from ..nn.attention import apply_rope, split_heads
from ..nn.layers import materialize, rms_norm
from ..quant.planar import TPNormShard

# activation dtype -> the kernel's type code
QK_ROPE_DTYPES = {torch.bfloat16: 0, torch.float16: 1, torch.float32: 2}
# head dims with an instance: a head's columns lie in one warp's 256
QK_ROPE_HEAD_DIMS = (16, 32, 64, 128, 256)
# descriptors a launch takes (csrc/qk_norm_rope.cu MAX_DESC)
MAX_DESC = 8


def _per_head(gain, head_dim: int) -> bool:
    """Whether the norm's gain spans a head (else the whole row; a
    ``TPNormShard`` is a full-width norm over a sharded row)."""
    if isinstance(gain, TPNormShard):
        return False
    base = getattr(gain, "base", gain)  # a LoRA-patched gain's own shape
    return int(base.shape[-1]) == head_dim


def plain_qk_norm_rope(parts, n_heads: int, pe=None, *, eps: float = 1e-6):
    """The composition: each part's q and k through ``rms_norm`` (split
    into heads first for a per-head gain, after it for a full-width one),
    the parts joined along the sequence (``torch.cat``), then
    ``apply_rope`` on q and k where ``pe`` is given. Returns (q, k, v), each
    (B, H, L, D)."""
    def norm(x, gain):
        if _per_head(gain, x.shape[-1] // n_heads):
            return rms_norm(split_heads(x, n_heads), gain, eps=eps)
        return split_heads(rms_norm(x, gain, eps=eps), n_heads)

    qs = [norm(q, gq) for q, _, _, gq, _ in parts]
    ks = [norm(k, gk) for _, k, _, _, gk in parts]
    vs = [split_heads(v, n_heads) for _, _, v, _, _ in parts]
    q, k, v = (ts[0] if len(ts) == 1 else torch.cat(ts, dim=2)
               for ts in (qs, ks, vs))
    if pe is not None:
        pe = pe if pe.dim() == 4 else pe[None]
        q, k = apply_rope(q, pe), apply_rope(k, pe)
    return q, k, v


def _check_view(name: str, t: torch.Tensor, dtype, B: int, W: int):
    if not t.is_cuda or t.dtype != dtype or t.dim() != 3:
        raise ValueError(f"{name}: a 3-d CUDA {dtype} (B, L, H·D) view, "
                         f"got {t.dtype} {tuple(t.shape)} on {t.device}")
    if t.shape[0] != B or t.shape[2] != W:
        raise ValueError(f"{name} shape {tuple(t.shape)}: expected "
                         f"({B}, L, {W})")
    if not _build.is_row_aligned(t):
        raise ValueError(f"{name} (strides {t.stride()}) is a view the "
                         f"kernel cannot read: it needs unit stride along "
                         f"H·D and a base and strides that are multiples "
                         f"of 16 bytes")


def _gain(name: str, g, head_dim: int, W: int, device) -> tuple:
    """(f32 gain on the card, per-head) for a descriptor."""
    if isinstance(g, TPNormShard):
        raise NotImplementedError(f"{name}: a TPNormShard gain reduces over "
                                  f"a mesh axis (plain_qk_norm_rope)")
    t = materialize(g, torch.float32).to(device).reshape(-1)
    if t.numel() not in (head_dim, W):
        raise ValueError(f"{name}: gain of {t.numel()} values, expected "
                         f"{head_dim} (a head) or {W} (the row)")
    if t.data_ptr() % 16:
        t = t.clone()
    return t, t.numel() == head_dim


def qk_norm_rope_cuda(parts, n_heads: int, pe=None, *, eps: float = 1e-6):
    """Launch K9 once for one attention call.

    parts: [(q, k, v, q_gain, k_gain), ...] in sequence order; q, k, v
    (B, L_i, H·D) CUDA views of one dtype with unit stride along H·D and
    16-byte-aligned rows (k and v may have other lengths than q: cross-
    attention); the gains of a head's length or the row's, any leaf
    ``materialize`` takes. pe: the joint sequence's table, (B or 1, L,
    D/2, 2) or (L, D/2, 2), or None. Returns q, k, v as (B, H, L, D) views
    of (B, L, H, D) storage; a single part's v is returned as a view of its
    input, several parts' v joined by the same launch.
    """
    q0 = parts[0][0]
    dtype, (B, _, W) = q0.dtype, q0.shape
    if dtype not in QK_ROPE_DTYPES:
        names = ", ".join(str(d).replace("torch.", "")
                          for d in QK_ROPE_DTYPES)
        raise NotImplementedError(
            f"{dtype}: K9 has instances for {names} activations (CPU "
            f"tensors take plain_qk_norm_rope)")
    if W % n_heads or W // n_heads not in QK_ROPE_HEAD_DIMS:
        raise NotImplementedError(
            f"{W} columns over {n_heads} heads: K9 has head dims "
            f"{', '.join(map(str, QK_ROPE_HEAD_DIMS))}")
    D = W // n_heads
    joined = len(parts) > 1
    if 2 * len(parts) + (len(parts) if joined else 0) > MAX_DESC:
        raise NotImplementedError(f"{len(parts)} parts: K9 takes "
                                  f"{MAX_DESC} descriptors a launch")
    for j, (q, k, v, _, _) in enumerate(parts):
        for name, t in (("q", q), ("k", k), ("v", v)):
            _check_view(f"part {j} {name}", t, dtype, B, W)
    Lq = sum(p[0].shape[1] for p in parts)
    Lk = sum(p[1].shape[1] for p in parts)
    Lv = sum(p[2].shape[1] for p in parts)
    dev = q0.device
    table, tb, tl = None, 0, 0
    if pe is not None:
        pe = pe if pe.dim() == 4 else pe[None]
        if (pe.shape[0] not in (1, B) or pe.shape[1:] != (Lq, D // 2, 2)
                or Lk != Lq):
            raise ValueError(f"RoPE table {tuple(pe.shape)} does not fit "
                             f"q ({B}, {Lq}) / k ({B}, {Lk}) at D = {D}")
        table = pe.to(device=dev, dtype=torch.float32)
        if (table.stride(-1) != 1 or table.stride(-2) != 2
                or table.stride(1) % 4 or table.data_ptr() % 16):
            table = table.contiguous()
        tb = table.stride(0) if table.shape[0] > 1 else 0
        tl = table.stride(1)
    out_q = torch.empty((B, Lq, n_heads, D), dtype=dtype, device=dev)
    out_k = torch.empty((B, Lk, n_heads, D), dtype=dtype, device=dev)
    out_v = (torch.empty((B, Lv, n_heads, D), dtype=dtype, device=dev)
             if joined else None)
    es = q0.element_size()
    gains, desc = [], []

    def add(x, out, off, L_out, gain, rope):
        if x.shape[1] == 0:
            return
        g, per_head = gain if gain is not None else (None, False)
        desc.extend((x.data_ptr(), x.stride(0), x.stride(1),
                     out.data_ptr() + off * W * es, L_out * W, W,
                     g.data_ptr() if g is not None else 0, int(per_head),
                     table.data_ptr() + off * tl * 4 if rope else 0, tb, tl,
                     x.shape[1]))

    for col, out, L_out in ((0, out_q, Lq), (1, out_k, Lk)):
        off = 0
        for j, part in enumerate(parts):
            x = part[col]
            g = _gain(f"part {j} {'qk'[col]} gain", part[3 + col], D, W, dev)
            gains.append(g[0])
            add(x, out, off, L_out, g, table is not None)
            off += x.shape[1]
    if joined:
        off = 0
        for part in parts:
            add(part[2], out_v, off, Lv, None, False)
            off += part[2].shape[1]
    n = len(desc) // 12
    if n:
        arr = (ctypes.c_longlong * len(desc))(*desc)
        rc = _build.lib().qk_norm_rope_launch(
            arr, n, B, W, D, QK_ROPE_DTYPES[dtype], float(eps),
            ctypes.c_void_p(_build.stream_handle(dev)))
        _build.check(rc, "qk_norm_rope_launch")
        _build.count("qk_norm_rope")
    v = (out_v.permute(0, 2, 1, 3) if joined
         else split_heads(parts[0][2], n_heads))
    return out_q.permute(0, 2, 1, 3), out_k.permute(0, 2, 1, 3), v


def qk_norm_rope(parts, n_heads: int, pe=None, *, eps: float = 1e-6):
    """K9 (``qk_norm_rope_cuda``, which raises on what it has no instance
    for) on CUDA tensors, the plain version on CPU tensors; see
    ``qk_norm_rope_cuda`` for ``parts`` and ``pe``."""
    if parts[0][0].is_cuda:
        return qk_norm_rope_cuda(parts, n_heads, pe, eps=eps)
    return plain_qk_norm_rope(parts, n_heads, pe, eps=eps)
