"""Spans, profiling and memory reporting for the PyTorch port.

``span(name, nbytes=0)`` times a named region of the program. Always, it
adds the region's host seconds, one to its count and ``nbytes`` to a
process-wide registry keyed by the name (``totals()``): two clock reads
and no card call. While a ``torch.profiler`` records, it also opens a
``record_function`` of the name, so the region sits in the profiler's
trace on the same clock as the device work, and, once CUDA is in use,
records a pair of CUDA events around it on the current stream, whose
device seconds join the registry once they have completed (``resolve``:
at the engine's sync point before it waits, while the card still has the
step queued, and whenever ``PENDING_CAP`` pairs wait; ``totals`` waits
for what is left). Events on one stream complete in the order they were
recorded, which ``resolve`` relies on: the program runs on one stream.

Names are dotted and start with their layer (``loader.copy``,
``engine.tick``, ``forward.norm_mod``); nested spans keep their own
totals. A span's host seconds include any time the host spent blocked in
a full launch queue: they are wall time on the host, not the host's own
cost.

``trace`` captures a ``torch.profiler`` trace (CPU and, with a card, CUDA
activity) into a Chrome trace file; ``memory_report`` counts packed
against would-be-dense bytes of a parameter tree.
"""

from __future__ import annotations

import collections
import contextlib
import os
import threading
import time

import torch


_profiler_enabled = torch.autograd._profiler_enabled
_now_ns = time.perf_counter_ns


class _Registry:
    """Per-name totals of every span in the process: each thread adds to
    its own ``{name: [host ns, count, nbytes]}`` (no lock on the hot path),
    ``totals`` sums them; device seconds of traced spans under the lock;
    the CUDA event pairs not yet read in a deque (appends are atomic)."""

    def __init__(self):
        self.lock = threading.Lock()
        self.local = threading.local()
        self.per_thread: list[dict] = []
        self.device: dict[str, list] = {}  # name -> [seconds, readings]
        # (name, start event, end event), in the order the spans ended
        self.pending: collections.deque = collections.deque()
        self.resolving = threading.Lock()  # one resolve at a time

    def new_acc(self) -> dict:
        acc = self.local.acc = {}
        with self.lock:
            self.per_thread.append(acc)
        return acc


_REGISTRY = _Registry()
# pairs left unread before a traced span's exit reads the completed ones:
# bounds the events alive in a long profiled run without reading any in
# a traced image's denoise loop (one flux-dev image: ~8,400 pairs)
PENDING_CAP = 50_000
# raw CUDA stream handle -> its torch.cuda.Stream: torch.cuda.current_stream()
# costs several microseconds a call, the raw handle a fraction of one
_STREAMS: dict = {}


def _current_stream():
    raw = torch._C._cuda_getCurrentRawStream(torch._C._cuda_getDevice())
    s = _STREAMS.get(raw)
    if s is None:
        s = _STREAMS[raw] = torch.cuda.current_stream()
    return s


# the ops torch.profiler.record_function runs, without its wrapper's checks
_RF_ENTER = torch.ops.profiler._record_function_enter_new
_RF_EXIT = torch.ops.profiler._record_function_exit._RecordFunction


class span:
    """``with span(name, nbytes=0) as s:`` — one timed region (see the
    module's doc). ``s.nbytes`` may be raised inside the block, where the
    bytes are known only there; after the block ``s.seconds`` holds its
    host seconds."""

    __slots__ = ("name", "nbytes", "_t0", "_dt", "_tr")

    def __init__(self, name: str, nbytes: int = 0):
        self.name = name
        self.nbytes = nbytes

    @property
    def seconds(self) -> float:
        return self._dt * 1e-9

    def __enter__(self) -> "span":
        self._t0 = _now_ns()
        self._tr = None
        if _profiler_enabled():
            self._enter_traced()
        return self

    def __exit__(self, *exc) -> bool:
        tr = self._tr
        if tr is not None and tr[1] is not None:
            tr[2].record(tr[3])  # first: the interval ends at the last launch
        dt = self._dt = _now_ns() - self._t0
        if tr is not None:
            self._exit_traced(tr)
        reg = _REGISTRY
        try:
            acc = reg.local.acc
        except AttributeError:
            acc = reg.new_acc()
        rec = acc.get(self.name)
        if rec is None:
            rec = acc[self.name] = [0, 0, 0]
        rec[0] += dt
        rec[1] += 1
        rec[2] += self.nbytes
        return False

    def _enter_traced(self) -> None:
        handle = _RF_ENTER(self.name, None)
        start = end = stream = None
        if torch.cuda.is_initialized():
            stream = _current_stream()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record(stream)  # last: the interval starts at the next launch
        self._tr = (handle, start, end, stream)

    def _exit_traced(self, tr) -> None:
        handle, start, end, _ = tr
        if start is not None:
            reg = _REGISTRY
            reg.pending.append((self.name, start, end))  # atomic
            if len(reg.pending) >= PENDING_CAP:
                resolve()
        _RF_EXIT(handle)


def _completed(batch: list) -> int:
    """How many of the pending pairs, oldest first, have completed: the
    first incomplete end event found by bisection (stream order)."""
    lo, hi = 0, len(batch)
    while lo < hi:
        mid = (lo + hi) // 2
        if batch[mid][2].query():
            lo = mid + 1
        else:
            hi = mid
    return lo


def resolve(wait: bool = False) -> None:
    """Add the device seconds of traced spans whose events have completed
    to the registry; with ``wait``, wait for every pending one first.
    Without ``wait`` it never blocks, and skips while another thread
    resolves."""
    reg = _REGISTRY
    if not reg.resolving.acquire(blocking=wait):
        return
    try:
        with reg.lock:
            batch = list(reg.pending)
        if not batch:
            return
        if wait:
            batch[-1][2].synchronize()
        n = len(batch) if wait else _completed(batch)
        got: dict = {}
        for name, start, end in batch[:n]:
            r = got.setdefault(name, [0.0, 0])
            r[0] += start.elapsed_time(end) * 1e-3
            r[1] += 1
        with reg.lock:
            for _ in range(n):
                reg.pending.popleft()
            for name, (s, c) in got.items():
                d = reg.device.setdefault(name, [0.0, 0])
                d[0] += s
                d[1] += c
    finally:
        reg.resolving.release()


def totals() -> dict:
    """``{name: {"count", "host_s", "nbytes", "device_s", "device_count"}}``
    of every span so far, summed over threads, a copy; waits for the
    pending device readings first (``device_count`` is 0 where the span
    never ran under a profiler with CUDA in use)."""
    resolve(wait=True)
    reg = _REGISTRY
    out: dict = {}
    with reg.lock:
        accs = list(reg.per_thread)
        device = {k: tuple(v) for k, v in reg.device.items()}
    for acc in accs:
        for name, (ns, n, nb) in list(acc.items()):
            t = out.setdefault(name, {"count": 0, "host_s": 0.0,
                                      "nbytes": 0})
            t["count"] += n
            t["host_s"] += ns * 1e-9
            t["nbytes"] += nb
    for name, t in out.items():
        t["device_s"], t["device_count"] = device.get(name, (0.0, 0))
    return out


def reset() -> None:
    """Start an empty registry (pending device readings are dropped)."""
    global _REGISTRY
    _REGISTRY = _Registry()


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a torch.profiler trace; writes ``log_dir/trace.json``
    (Chrome trace format) on exit and yields the profiler, whose
    ``key_averages()`` sums the device time by kernel."""
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(log_dir, exist_ok=True)
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    prof = profile(activities=acts)
    prof.start()
    try:
        yield prof
    finally:
        prof.stop()
        prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


# ---------------------------------------------------------------------------
# memory accounting
# ---------------------------------------------------------------------------

def _flat_items(params: dict, prefix: str = ""):
    """(key, leaf) pairs; a nested dict (a depth-stacked group) contributes
    its leaves under ``group.key``."""
    for k, v in params.items():
        if isinstance(v, dict):
            yield from _flat_items(v, f"{prefix}{k}.")
        else:
            yield prefix + k, v


def memory_report(params: dict) -> dict:
    """Packed vs would-be-dense bytes of a param tree + its largest
    tensor. LoRA-patched leaves count their base weight."""
    # imported here: the loader and the kernel builds import this module
    from .lora import PatchedWeight
    from .quant.i8 import I8Planar
    from .quant.planar import PlanarQuant

    packed = dense16 = 0
    largest_key, largest_bytes = None, -1
    n_packed = n_dense = 0
    for k, v in _flat_items(params):
        if isinstance(v, PatchedWeight):
            v = v.base
        if isinstance(v, (PlanarQuant, I8Planar)):
            b = v.nbytes_packed
            depth = v.qs.numel() // (v.qs.shape[-1] * v.qs.shape[-2])
            packed += b
            dense16 += 2 * v.shape[0] * v.shape[1] * depth
            n_packed += 1
        else:
            b = (v.numel() * v.element_size() if isinstance(v, torch.Tensor)
                 else int(getattr(v, "nbytes", 0)))
            packed += b
            dense16 += b
            n_dense += 1
        if b > largest_bytes:
            largest_key, largest_bytes = k, b
    return {
        "packed_bytes": packed,
        "dense_bf16_bytes": dense16,
        "compression": round(dense16 / packed, 3) if packed else None,
        "largest_tensor": largest_key,
        "largest_tensor_bytes": largest_bytes,
        "n_packed": n_packed,
        "n_dense": n_dense,
    }
