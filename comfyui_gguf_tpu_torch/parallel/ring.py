"""Ring attention: exact attention over a sequence split across ranks.

Video archs (Wan, HunyuanVideo, LTX-Video, Cosmos) attend over tens of
thousands of tokens. Sequence parallelism splits L over the ranks of an
axis; at each of n steps every rank attends its local queries against the
K/V chunk it holds, then passes that chunk to its ring neighbour
(``collectives.ppermute``). The softmax is the streaming (flash) form,
with a running max and denominator, so the result is exact.

The reference's per-chunk update is plain einsums in float32
(``parallel/ring.py``), not a kernel; this is its PyTorch form. A step
holds the (B, H, Lq/n, Lk/n) float32 scores.

Layout: (B, L, H, D) activations, L split over the axis.
"""

from __future__ import annotations

import torch

from . import collectives


def _chunk_attn(q, k, v, scale, m, l, acc):
    """One streaming-softmax update of q against one K/V chunk.

    q: (B, Lq, H, D), k/v: (B, Lc, H, D); m, l: (B, H, Lq) and acc
    (B, Lq, H, D), all float32."""
    s = torch.einsum("bqhd,bkhd->bhqk", q.to(torch.float32),
                     k.to(torch.float32)) * scale
    m_new = torch.maximum(m, s.amax(dim=-1))
    corr = torch.exp(m - m_new)
    p = torch.exp(s - m_new[..., None])
    l = l * corr + p.sum(dim=-1)
    pv = torch.einsum("bhqk,bkhd->bqhd", p, v.to(torch.float32))
    acc = acc * corr.transpose(1, 2)[..., None] + pv
    return m_new, l, acc


def ring_attention_local(q, k, v, axis_name: str, scale: float | None = None,
                         mesh=None):
    """This rank's (B, L/n, H, D) output from its q/k/v shards; L split
    over ``axis_name``. Returns q's dtype."""
    n = collectives.axis_size(axis_name, mesh)
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    B, Lq, H, D = q.shape
    m = torch.full((B, H, Lq), -torch.inf, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((B, H, Lq), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, Lq, H, D), dtype=torch.float32, device=q.device)
    for step in range(n):
        m, l, acc = _chunk_attn(q, k, v, scale, m, l, acc)
        if step + 1 < n:
            # one hop around the ring (the last hop would only bring the
            # rank's own chunk back)
            k = collectives.ppermute(k, axis_name, 1, mesh)
            v = collectives.ppermute(v, axis_name, 1, mesh)
    return (acc / l.transpose(1, 2)[..., None]).to(q.dtype)


def ring_attention(q, k, v, mesh, axis: str = "sp",
                   scale: float | None = None):
    """Whole (B, L, H, D) q/k/v on every rank → the whole output on every
    rank: each rank takes its L chunk, runs the ring, and one all-gather
    puts the chunks together. L must divide by the axis size."""
    L = q.shape[1]
    n = collectives.axis_size(axis, mesh)
    if L % n:
        raise ValueError(f"sequence {L} not divisible by {axis}={n}")
    r = collectives.axis_index(axis, mesh)
    c = L // n
    q, k, v = (t[:, r * c:(r + 1) * c] for t in (q, k, v))
    out = ring_attention_local(q, k, v, axis, scale, mesh)
    return collectives.all_gather(out, axis, dim=1, mesh=mesh)
