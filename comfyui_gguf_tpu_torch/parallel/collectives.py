"""The port's collectives: one rank per process, ``torch.distributed``.

The reference runs a single controller: one process drives every device
under ``shard_map`` and names collectives by mesh axis (``jax.lax.psum``,
``all_gather(tiled=True)``, ``ppermute``, ``axis_index``). Here every rank
runs the same program on its own shard, and these functions are those
collectives over the process group of one axis of a
``torch.distributed.device_mesh.DeviceMesh``. All port code calls them and
never ``torch.distributed`` directly.

The mesh is passed explicitly or taken from the enclosing ``active(mesh)``
scope (the counterpart of being inside ``shard_map``): ``nn.layers`` routes
``TPShard`` weights and ``TPNormShard`` norms through the active mesh, so
an unmodified model forward runs tensor-parallel inside the scope.

Backends. NCCL where each rank owns its own CUDA device; gloo where ranks
share one card or run on the CPU (NCCL refuses two ranks on one device).
Under gloo a CUDA tensor goes through a pinned host buffer: every
collective of a gloo group on a CUDA tensor is staged, by that rule alone
(never on an exception), and ``STATS["staged_bytes"]`` counts the bytes
moved each way. ``STATS["seconds"]`` is the wall time inside the
collectives (staging included; the card's queue is drained first so that
earlier work is not counted).
"""

from __future__ import annotations

import contextlib
import contextvars
import time

import torch
import torch.distributed as dist

STATS = {"calls": 0, "seconds": 0.0, "staged_bytes": 0}

_ACTIVE: contextvars.ContextVar = contextvars.ContextVar(
    "gguf_torch_mesh", default=None)

# pinned host buffers by (role, dtype), grown on demand
_PINNED: dict = {}


def reset_stats() -> None:
    STATS.update(calls=0, seconds=0.0, staged_bytes=0)


@contextlib.contextmanager
def active(mesh):
    """Make ``mesh`` the mesh of the enclosed collectives (the scope a
    model forward runs tensor-, sequence- or expert-parallel in)."""
    tok = _ACTIVE.set(mesh)
    try:
        yield mesh
    finally:
        _ACTIVE.reset(tok)


def current_mesh(mesh=None):
    mesh = mesh if mesh is not None else _ACTIVE.get()
    if mesh is None:
        raise RuntimeError("no mesh: pass mesh= or run inside "
                           "collectives.active(mesh)")
    return mesh


def group(axis: str, mesh=None):
    return current_mesh(mesh).get_group(axis)


def axis_size(axis: str, mesh=None) -> int:
    return current_mesh(mesh).size(current_mesh(mesh).mesh_dim_names.index(
        axis))


def axis_index(axis: str, mesh=None) -> int:
    """This rank's coordinate along ``axis``."""
    return current_mesh(mesh).get_local_rank(axis)


def backend(axis: str, mesh=None) -> str:
    return str(dist.get_backend(group(axis, mesh)))


def _staged(x: torch.Tensor, g) -> bool:
    """Whether a collective on ``x`` over group ``g`` goes through the
    host: a CUDA tensor under gloo."""
    return x.is_cuda and str(dist.get_backend(g)) == "gloo"


def _pinned(role: str, shape, dtype) -> torch.Tensor:
    n = 1
    for d in shape:
        n *= d
    buf = _PINNED.get((role, dtype))
    if buf is None or buf.numel() < n:
        buf = torch.empty(max(n, 1), dtype=dtype, pin_memory=True)
        _PINNED[(role, dtype)] = buf
    return buf[:n].view(shape)


def _to_host(x: torch.Tensor) -> torch.Tensor:
    h = _pinned("in", tuple(x.shape), x.dtype)
    h.copy_(x)
    STATS["staged_bytes"] += x.numel() * x.element_size()
    return h


def _from_host(h: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    out = torch.empty(h.shape, dtype=h.dtype, device=like.device)
    out.copy_(h)
    STATS["staged_bytes"] += h.numel() * h.element_size()
    return out


@contextlib.contextmanager
def _timed(x: torch.Tensor):
    if x.is_cuda:
        torch.cuda.current_stream(x.device).synchronize()
    t0 = time.perf_counter()
    try:
        yield
    finally:
        STATS["calls"] += 1
        STATS["seconds"] += time.perf_counter() - t0


def psum(x: torch.Tensor, axis: str, mesh=None) -> torch.Tensor:
    """Sum of ``x`` over ``axis``, in x's dtype, replicated on every rank
    of the axis (``jax.lax.psum``)."""
    g = group(axis, mesh)
    if dist.get_world_size(g) == 1:
        return x
    with _timed(x):
        if _staged(x, g):
            h = _to_host(x)
            dist.all_reduce(h, group=g)
            return _from_host(h, x)
        y = x.contiguous().clone()
        dist.all_reduce(y, group=g)
        return y


def all_gather(x: torch.Tensor, axis: str, dim: int = -1,
               mesh=None) -> torch.Tensor:
    """The ranks' ``x`` concatenated along ``dim`` in axis order
    (``jax.lax.all_gather(..., tiled=True)``)."""
    g = group(axis, mesh)
    n = dist.get_world_size(g)
    if n == 1:
        return x
    with _timed(x):
        src = x.contiguous()
        if _staged(x, g):
            src = _to_host(src)
            buf = _pinned("out", (n, *x.shape), x.dtype)
        else:
            buf = torch.empty((n, *x.shape), dtype=x.dtype, device=x.device)
        dist.all_gather(list(buf.unbind(0)), src, group=g)
        if _staged(x, g):
            buf = _from_host(buf, x)
        return torch.cat(buf.unbind(0), dim=dim)


def ppermute(x: torch.Tensor, axis: str, shift: int = 1,
             mesh=None) -> torch.Tensor:
    """Ring shift over ``axis``: rank i sends ``x`` to rank (i + shift) % n
    and returns what rank (i - shift) % n sent (``jax.lax.ppermute`` with
    the ring permutation)."""
    g = group(axis, mesh)
    n = dist.get_world_size(g)
    if n == 1:
        return x
    i = dist.get_group_rank(g, dist.get_rank())
    dst = dist.get_global_rank(g, (i + shift) % n)
    src = dist.get_global_rank(g, (i - shift) % n)
    with _timed(x):
        send = x.contiguous()
        staged = _staged(x, g)
        if staged:
            send = _to_host(send)
            recv = _pinned("out", tuple(x.shape), x.dtype)
        else:
            recv = torch.empty_like(send)
        ops = [dist.P2POp(dist.isend, send, dst, g),
               dist.P2POp(dist.irecv, recv, src, g)]
        for w in dist.batch_isend_irecv(ops):
            w.wait()
        return _from_host(recv, x) if staged else recv
