"""The traced run's device timeline: torch.profiler over a few engine
steps of the window, reduced to what the per-layer metrics read.

The traced window runs from the start of the first profiled step to the
end of the last (each step ends with the engine waiting for the card, so
the step's device work lies inside it). Busy time is the union of the
intervals in which a kernel, copy or memset ran: overlapping work counts
once, and the gaps between launches count as idle. Each idle gap is
named by what the host was doing in its middle: the innermost traced
host event there (an ATen op, a CUDA runtime call, or one of the
benchmark's own ``bench.*`` regions around its calls into the program).
"""

from __future__ import annotations

import collections
import json
import os
import tempfile

import numpy as np

import families

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver",
             "python_function")
LABEL_MIN_US = 20.0  # shorter gaps are counted together, unnamed


def profiler(skip: int, active: int):
    """A profiler over CPU and CUDA activity that records ``active`` steps
    after skipping ``skip`` (and one warm-up step)."""
    from torch.profiler import ProfilerActivity, profile, schedule

    return profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                   schedule=schedule(wait=skip, warmup=1, active=active,
                                     repeat=1))


def _events(prof) -> list[dict]:
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            data = json.load(f)
    finally:
        os.unlink(path)
    evs = data["traceEvents"] if isinstance(data, dict) else data
    return [e for e in evs if e.get("ph") == "X" and "dur" in e]


class Timeline:
    """Device work of the traced window: ``window_s``, ``busy_s``,
    ``steps`` (profiled engine steps), seconds by family (``fam_s``) and
    by class (``class_s``), and the idle gaps by host activity."""

    def __init__(self, evs: list[dict]):
        step_spans = [e for e in evs
                      if str(e.get("name", "")).startswith("ProfilerStep#")]
        if not step_spans:
            raise RuntimeError("the trace holds no profiled step")
        self.t0 = min(float(e["ts"]) for e in step_spans)
        self.t1 = max(float(e["ts"]) + float(e["dur"]) for e in step_spans)
        self.steps = len({e["name"] for e in step_spans})
        self.window_s = (self.t1 - self.t0) / 1e6
        dev, fam_s, cls_s = [], collections.Counter(), collections.Counter()
        for e in evs:
            cat = e.get("cat", "")
            if cat not in DEVICE_CATS:
                continue
            a = max(float(e["ts"]), self.t0)
            b = min(float(e["ts"]) + float(e["dur"]), self.t1)
            if b <= a:
                continue
            fam = families.family(str(e.get("name", "")), cat)
            fam_s[fam] += (b - a) / 1e6
            cls_s[families.klass(fam)] += (b - a) / 1e6
            dev.append((a, b))
        self.fam_s, self.class_s = dict(fam_s), dict(cls_s)
        dev.sort()
        merged = []
        for a, b in dev:
            if merged and a <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], b)
            else:
                merged.append([a, b])
        self.busy_s = sum(b - a for a, b in merged) / 1e6
        gaps, cur = [], self.t0
        for a, b in merged:
            if a > cur:
                gaps.append((cur, a))
            cur = max(cur, b)
        if self.t1 > cur:
            gaps.append((cur, self.t1))
        host = [e for e in evs if e.get("cat", "") in HOST_CATS
                and not str(e.get("name", "")).startswith("ProfilerStep#")]
        self._names = [str(e.get("name", "?")) for e in host]
        self._ts = np.array([float(e["ts"]) for e in host])
        self._dur = np.array([float(e["dur"]) for e in host])
        self._bench = np.array([n.startswith("bench.") for n in self._names],
                               dtype=bool)
        self.idle = collections.Counter()
        for a, b in gaps:
            lab = (self._label((a + b) / 2) if b - a >= LABEL_MIN_US
                   else f"gaps under {LABEL_MIN_US:g} us between launches")
            self.idle[lab] += (b - a) / 1e6

    def _label(self, t: float) -> str:
        """The innermost ``bench.*`` region and the innermost other host
        event that cover time ``t``."""
        on = (self._ts <= t) & (self._ts + self._dur >= t)
        parts = []
        for want in (on & self._bench, on & ~self._bench):
            idx = np.flatnonzero(want)
            if idx.size:
                parts.append(self._names[idx[np.argmin(self._dur[idx])]])
        return " / ".join(parts) if parts else "no traced host activity"

    def breakdown(self, top: int = 10) -> dict:
        ops = sorted(self.fam_s.items(), key=lambda kv: -kv[1])[:top]
        idle = sorted(self.idle.items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[k, v] for k, v in ops],
                "idle_gaps": [[k, v] for k, v in idle]}


def read(prof) -> Timeline:
    return Timeline(_events(prof))
