"""Device timing shared by the measurement scripts (``chip_smoke.py``,
``tools_i8_microbench_cuda.py``). CUDA only: a time comes from CUDA events on
the card, never from a host clock around an unsynchronised launch."""

from __future__ import annotations

import torch


def rel_l2(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.double(), b.double()
    return float((a - b).norm() / (b.norm() + 1e-30))


def graph_ms(fns, reps: int = 10) -> float:
    """Mean device time of one call, from CUDA events around a CUDA graph
    that replays ``reps`` rounds of ``fns`` (a list cycled through, e.g.
    copies of a weight that together exceed the L2 cache)."""
    s = torch.cuda.Stream()
    s.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(s):
        for f in fns:  # warm up (and build) outside the capture
            f()
    torch.cuda.current_stream().wait_stream(s)
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(reps):
            for f in fns:
                f()
    g.replay()
    torch.cuda.synchronize()
    t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    t0.record()
    g.replay()
    t1.record()
    t1.synchronize()
    return t0.elapsed_time(t1) / (reps * len(fns))


def event_ms(fn, reps: int = 3) -> float:
    """Mean device time of ``fn`` over ``reps`` eager calls after one
    warm-up call."""
    fn()
    torch.cuda.synchronize()
    t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    t1.synchronize()
    return t0.elapsed_time(t1) / reps
